"""Bit-exactness of the LCG RNG against golden values generated from the
reference's LCG<4> (common/dvr_course-common-both.h:41-88) compiled host-side."""
import jax.numpy as jnp
import numpy as np

from icon_dvr.utils.lcg import lcg_init, lcg_next, np_lcg_init, np_lcg_next

# (seed0, seed1, state_after_init, first 6 draws, state after 6 draws)
GOLDEN = [
    (0, 0, 0x5DF5F2BF,
     [0.294449925, 0.695515215, 0.897309542, 0.59830302, 0.76776731, 0.315316021],
     0xC650B88D),
    (1, 2, 0x7F75A0A1,
     [0.129906416, 0.910392463, 0.448221087, 0.63899833, 0.128044128, 0.0862559676],
     0x9B1614DF),
    (123456789, 987654321, 0xB3A57FB2,
     [0.0990510583, 0.396205187, 0.872032344, 0.0713657141, 0.44861871, 0.491732121],
     0x3E7DE228),
    (4294967295, 17, 0x0604795C,
     [0.999100387, 0.00523269176, 0.379660904, 0.500309944, 0.843192041, 0.66531384],
     0xC1AA5202),
    (196649, 99, 0xFCD71453,
     [0.558801055, 0.759399235, 0.445453167, 0.366137922, 0.157702088, 0.502021849],
     0xA3808481),
]


def test_lcg_jax_matches_reference():
    for s0, s1, state0, draws, state6 in GOLDEN:
        st = lcg_init(jnp.uint32(s0), jnp.uint32(s1))
        assert int(st) == state0, (s0, s1)
        for expected in draws:
            st, v = lcg_next(st)
            assert float(v) == np.float32(expected)
        assert int(st) == state6


def test_lcg_numpy_twin_matches_jax():
    for s0, s1, *_ in GOLDEN:
        st_np = np_lcg_init(np.uint32(s0), np.uint32(s1))
        st_jx = lcg_init(jnp.uint32(s0), jnp.uint32(s1))
        assert int(st_np) == int(st_jx)
        for _ in range(10):
            st_np, v_np = np_lcg_next(st_np)
            st_jx, v_jx = lcg_next(st_jx)
            assert int(st_np) == int(st_jx)
            assert np.float32(v_np) == np.float32(v_jx)


def test_lcg_batched():
    s0 = jnp.arange(64, dtype=jnp.uint32)
    s1 = jnp.full(64, 7, jnp.uint32)
    st = lcg_init(s0, s1)
    # lane 0 must equal the scalar stream
    st0 = lcg_init(jnp.uint32(0), jnp.uint32(7))
    assert int(st[0]) == int(st0)
    st, v = lcg_next(st)
    st0, v0 = lcg_next(st0)
    assert int(st[0]) == int(st0)
    assert float(v[0]) == float(v0)
    assert v.shape == (64,)
    assert jnp.all((v >= 0) & (v < 1))
