"""Bit-exact counter-based RNG matching the reference renderer.

The reference seeds a linear-congruential generator with a 4-round
Tiny-Encryption-Algorithm mix of two 32-bit values and then draws
24-bit uniforms (ref: common/dvr_course-common-both.h:41-88, LCG<4>).
Reproducing the exact bit sequence is what lets our images match the
CUDA reference sample-for-sample, so everything here is uint32 math
with wrap-around semantics.

All functions work element-wise on arrays: a "state" is a uint32 array
of any shape (one independent stream per ray/pixel lane).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_TEA_DELTA = 0x9E3779B9
_TEA_K0, _TEA_K1 = 0xA341316C, 0xC8013EA4
_TEA_K2, _TEA_K3 = 0xAD90777D, 0x7E95761E
_LCG_A = 1664525
_LCG_C = 1013904223
_MASK24 = 0x00FFFFFF
_INV_2_24 = 1.0 / float(0x01000000)


def lcg_init(val0, val1, rounds: int = 4):
    """TEA-mix two uint32 seeds into an initial LCG state (uint32 array)."""
    u32 = jnp.uint32
    v0 = jnp.asarray(val0).astype(u32)
    v1 = jnp.asarray(val1).astype(u32)
    s0 = np.uint32(0)
    for _ in range(rounds):
        s0 = np.uint32((int(s0) + _TEA_DELTA) & 0xFFFFFFFF)
        v0 = v0 + (((v1 << u32(4)) + u32(_TEA_K0)) ^ (v1 + u32(s0)) ^ ((v1 >> u32(5)) + u32(_TEA_K1)))
        v1 = v1 + (((v0 << u32(4)) + u32(_TEA_K2)) ^ (v0 + u32(s0)) ^ ((v0 >> u32(5)) + u32(_TEA_K3)))
    return v0


def lcg_next(state):
    """Advance the LCG; returns (new_state, uniform float32 in [0, 1)).

    The 24-bit value is cast via int32 (bit-identical, always < 2^24),
    a cast every backend lowers.
    """
    u32 = jnp.uint32
    state = u32(_LCG_A) * state + u32(_LCG_C)
    value = ((state & u32(_MASK24)).astype(jnp.int32).astype(jnp.float32)
             * jnp.float32(_INV_2_24))
    return state, value


# ---------------------------------------------------------------------------
# NumPy twin (host-side oracle / tooling; identical bit behavior)
# ---------------------------------------------------------------------------

def np_lcg_init(val0, val1, rounds: int = 4):
    with np.errstate(over="ignore"):
        v0 = np.asarray(val0, dtype=np.uint32)
        v1 = np.asarray(val1, dtype=np.uint32)
        s0 = np.uint32(0)
        for _ in range(rounds):
            s0 = np.uint32((int(s0) + _TEA_DELTA) & 0xFFFFFFFF)
            v0 = v0 + (((v1 << np.uint32(4)) + np.uint32(_TEA_K0))
                       ^ (v1 + s0)
                       ^ ((v1 >> np.uint32(5)) + np.uint32(_TEA_K1)))
            v1 = v1 + (((v0 << np.uint32(4)) + np.uint32(_TEA_K2))
                       ^ (v0 + s0)
                       ^ ((v0 >> np.uint32(5)) + np.uint32(_TEA_K3)))
        return v0


def np_lcg_next(state):
    with np.errstate(over="ignore"):
        state = np.uint32(_LCG_A) * state + np.uint32(_LCG_C)
    value = np.float32(state & np.uint32(_MASK24)) * np.float32(_INV_2_24)
    return state, value
