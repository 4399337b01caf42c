"""Radial-shell majorant bands — the gather-free empty-space accel of the
fast path.

Rationale: the reference's spatially-varying majorants live in 1M-16M
-bin grids addressed by per-ray cell indices (ref: icon_rt/ShellAccel.h,
hostCode.cu:652-682) — per-step random gathers, which cost far more than
a lane of arithmetic on wide vector hardware (the H100 ratio is not yet
measured, ROADMAP D2).
ICON scalar fields vary most strongly with HEIGHT, so a majorant that
depends only on radius captures most of the empty-space structure while
being fully arithmetic:

  * band edges are B+1 radii spanning [r_bot, r_top];
  * a ray's crossings with every band edge are closed-form sphere
    intersections (2 flops per edge from precomputed o.o / o.d);
  * the per-band majorant is selected by a one-hot sum over B lanes —
    no memory indirection anywhere in the traversal.

Per-band value ranges use the EXACT per-layer range (the layer value is
piecewise constant), so majorants here are tighter than the reference's
unsorted-range quirk; this accel backs our own fast raygen, not the
reference-parity modes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..data.icfile import ICDataset
from .accel import compute_max_opacities

F = np.float32


class RadialBands(NamedTuple):
    edges: jnp.ndarray          # (B+1,) f32 radii, ascending
    value_ranges: jnp.ndarray   # (B, 2) f32
    max_opacities: jnp.ndarray  # (B,) f32

    @property
    def num_bands(self) -> int:
        return self.value_ranges.shape[0]


def build_radial_bands(ds: ICDataset, num_bands: int = 64) -> RadialBands:
    idx = np.arange(ds.num_cells)
    r_lo = float(ds.height[:, 0].min()) if ds.num_cells else 0.0
    r_hi = float(ds.height[idx, ds.num_layers].max()) if ds.num_cells else 1.0
    edges = np.linspace(r_lo, r_hi, num_bands + 1).astype(F)
    vr_lo = np.full(num_bands, np.finfo(F).max, F)
    vr_hi = np.full(num_bands, -np.finfo(F).max, F)
    max_l = int(ds.num_layers.max()) if ds.num_cells else 0
    span = max(r_hi - r_lo, 1e-30)
    from .accel import _rasterize   # native scatter-min/max, 1-D grid
    for L in range(max_l):
        sel = ds.num_layers > L
        if sel.all():   # uniform layer count: skip the (slow) fancy index
            h0 = ds.height[:, L]
            h1 = ds.height[:, L + 1]
            v = ds.value[:, L].astype(F)
        else:
            h0 = ds.height[sel, L]
            h1 = ds.height[sel, L + 1]
            v = ds.value[sel, L].astype(F)
        b0 = np.clip(((h0 - r_lo) / span * num_bands).astype(np.int64), 0, num_bands - 1)
        b1 = np.clip(((h1 - r_lo) / span * num_bands).astype(np.int64), 0, num_bands - 1)
        n = b0.shape[0]
        lo_idx = np.zeros((n, 3), np.int64)
        up_idx = np.zeros((n, 3), np.int64)
        lo_idx[:, 0] = b0
        up_idx[:, 0] = b1
        _rasterize(vr_lo, vr_hi, lo_idx, up_idx, v, v,
                   np.array([num_bands, 1, 1], np.int64))
    return RadialBands(
        edges=jnp.asarray(edges),
        value_ranges=jnp.asarray(np.stack([vr_lo, vr_hi], axis=1)),
        max_opacities=jnp.zeros(num_bands, jnp.float32),
    )


def build_radial_bands_wedge(ds: ICDataset, num_bands: int = 64
                             ) -> RadialBands:
    """Radial bands for the FAST WEDGE tier (ops/fast sampler='wedge').

    Differences from build_radial_bands: per-layer values are the
    reference's per-wedge constants bv (models/wedges.bv_all,
    ref: hostCode.cu:574,583-586 — the '#if 1' branch assigns the bottom
    scalar to all six vertices), and each wedge's radial attribution is
    inflated downward by the column's flat-face sagitta (a flat face at
    height h spans radii [h*mn, h]), including the global band range."""
    from .wedges import bv_all, column_min_norm

    mn = column_min_norm(ds.lat, ds.lon)
    bv = bv_all(ds.value, ds.num_layers)
    idx = np.arange(ds.num_cells)
    r_lo = float((ds.height[:, 0] * mn).min()) if ds.num_cells else 0.0
    r_hi = float(ds.height[idx, ds.num_layers].max()) if ds.num_cells else 1.0
    edges = np.linspace(r_lo, r_hi, num_bands + 1).astype(F)
    vr_lo = np.full(num_bands, np.finfo(F).max, F)
    vr_hi = np.full(num_bands, -np.finfo(F).max, F)
    max_l = int(ds.num_layers.max()) if ds.num_cells else 0
    span = max(r_hi - r_lo, 1e-30)
    from .accel import _rasterize
    for L in range(max_l):
        sel = ds.num_layers > L
        h0 = ds.height[sel, L] * mn[sel]
        h1 = ds.height[sel, L + 1]
        v = bv[sel, L].astype(F)
        b0 = np.clip(((h0 - r_lo) / span * num_bands).astype(np.int64),
                     0, num_bands - 1)
        b1 = np.clip(((h1 - r_lo) / span * num_bands).astype(np.int64),
                     0, num_bands - 1)
        n = b0.shape[0]
        lo_idx = np.zeros((n, 3), np.int64)
        up_idx = np.zeros((n, 3), np.int64)
        lo_idx[:, 0] = b0
        up_idx[:, 0] = b1
        _rasterize(vr_lo, vr_hi, lo_idx, up_idx, v, v,
                   np.array([num_bands, 1, 1], np.int64))
    return RadialBands(
        edges=jnp.asarray(edges),
        value_ranges=jnp.asarray(np.stack([vr_lo, vr_hi], axis=1)),
        max_opacities=jnp.zeros(num_bands, jnp.float32),
    )


def update_band_majorants(bands: RadialBands, lut, tf_value_range) -> RadialBands:
    """TF-edit handler for the radial bands (same LUT range-max as the
    reference's computeMaxOpacities, ref: hostCode.cu:362-434)."""
    mo = compute_max_opacities(bands.value_ranges, lut, tf_value_range)
    return bands._replace(max_opacities=mo)
