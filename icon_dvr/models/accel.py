"""Empty-space-skipping acceleration grids and majorant computation.

Two majorant grids, as in the reference:
  * GridAccel  — uniform Cartesian grid over the volume AABB
                 (ref: icon_rt/Params.h:44-49, hostCode.cu:245-297,668-682)
  * ShellAccel — (r, lat, lon) spherical-shell grid
                 (ref: icon_rt/ShellAccel.h:22-27, hostCode.cu:299-336,652-666)

Each bin stores the value range of all cell layers touching it; a transfer-
function edit maps value ranges through the LUT's alpha to per-bin majorants
(computeMaxOpacities, ref: hostCode.cu:362-434).

Design choices:
  * Builds run on the host in vectorized numpy at dataset-load time —
    scatter-min/max replaces the reference's CAS atomicMin/Max loops
    (ref: hostCode.cu:36-56), so that hazard class disappears.
  * The per-TF-edit majorant pass is a jitted O(bins) kernel using a
    sparse-table range-max over the LUT (O(1) per bin) instead of the
    reference's per-bin LUT scan, so live TF edits stay cheap at 16.7M bins.

Reference quirks kept for image parity (documented, not "fixed"):
  * the per-layer value range is (value[L-1], value[L]) unsorted
    (getValue at the layer's bottom/top heights, ref: hostCode.cu:291-293);
  * ShellAccel's loMC uses only bottom corners and upMC only top corners
    (ref: hostCode.cu:311-319);
  * projectToSphericalGrid scales by (dims-1) and is unclamped
    (ref: ShellAccel.h:57-68); projectOnGrid clamps (ref: DDA.h:24-31).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data.icfile import ICDataset
from .cells import layer_bounds

F = np.float32
FLT_MAX = np.float32(np.finfo(np.float32).max)


class GridAccel(NamedTuple):
    dims: jnp.ndarray            # (3,) i32
    world_lo: jnp.ndarray        # (3,) f32
    world_hi: jnp.ndarray        # (3,) f32
    value_ranges: jnp.ndarray    # (M, 2) f32
    max_opacities: jnp.ndarray   # (M,) f32


class ShellAccel(NamedTuple):
    dims: jnp.ndarray            # (3,) i32
    sph_lo: jnp.ndarray          # (3,) f32 (r, lat, lon)
    sph_hi: jnp.ndarray          # (3,) f32
    value_ranges: jnp.ndarray    # (M, 2) f32
    max_opacities: jnp.ndarray   # (M,) f32


# ---------------------------------------------------------------------------
# Host-side builds (numpy scatter-min/max)
# ---------------------------------------------------------------------------

def _np_project_on_grid(v, dims, lo, hi):
    """Clamped Cartesian projection (ref: DDA.h:24-31); trunc toward zero."""
    v01 = ((v - lo) / (hi - lo)).astype(F)
    vs = (v01 * dims.astype(F)).astype(F)
    return np.clip(vs.astype(np.int64), 0, dims - 1)


def _np_project_spherical(sph, dims, slo, shi):
    """Unclamped spherical projection scaled by dims-1 (ref: ShellAccel.h:57-68)."""
    scaled = ((sph - slo) / (shi - slo) * (dims - 1).astype(F)).astype(F)
    return scaled.astype(np.int64)


def _layer_values(ds: ICDataset, L: int):
    """(value at layer bottom height, value at layer top height): the
    reference evaluates getValue(h[L]) / getValue(h[L+1]), which resolve to
    value[max(L-1, 0)] and value[L] (ref: hostCode.cu:291-293)."""
    return ds.value[:, max(L - 1, 0)], ds.value[:, L]


def _rasterize(vr_lo, vr_hi, lo_idx, up_idx, val_lo, val_hi, dims):
    """Scatter (val_lo, val_hi) min/max into every bin of [lo_idx, up_idx]
    boxes.  Prefers the C++ host module; numpy fallback uses a vectorized
    offset loop for small footprints and a per-item python loop for the
    rare huge ones (e.g. dateline-spanning cells)."""
    from ..utils.native import native_rasterize
    if native_rasterize(np.ascontiguousarray(lo_idx),
                        np.ascontiguousarray(up_idx),
                        val_lo, val_hi, dims, vr_lo, vr_hi):
        return
    ext = up_idx - lo_idx + 1
    small = np.all(ext <= 8, axis=1)
    sx, sy, sz = dims[0], dims[1], dims[2]

    def flat(ix, iy, iz):
        return iz * sx * sy + iy * sx + ix

    li, ui = lo_idx[small], up_idx[small]
    vl, vh = val_lo[small], val_hi[small]
    if li.shape[0]:
        me = ui - li + 1
        for dz in range(int(me[:, 2].max())):
            for dy in range(int(me[:, 1].max())):
                for dx in range(int(me[:, 0].max())):
                    m = (dx < me[:, 0]) & (dy < me[:, 1]) & (dz < me[:, 2])
                    ids = flat(li[m, 0] + dx, li[m, 1] + dy, li[m, 2] + dz)
                    np.minimum.at(vr_lo, ids, vl[m])
                    np.maximum.at(vr_hi, ids, vh[m])
    for j in np.nonzero(~small)[0]:
        zz, yy, xx = np.meshgrid(
            np.arange(lo_idx[j, 2], up_idx[j, 2] + 1),
            np.arange(lo_idx[j, 1], up_idx[j, 1] + 1),
            np.arange(lo_idx[j, 0], up_idx[j, 0] + 1), indexing="ij")
        ids = flat(xx.ravel(), yy.ravel(), zz.ravel())
        np.minimum.at(vr_lo, ids, val_lo[j])
        np.maximum.at(vr_hi, ids, val_hi[j])


def build_grid_accel(ds: ICDataset, world_lo, world_hi, dims=(256, 256, 256)) -> GridAccel:
    """Cartesian majorant grid (ref: hostCode.cu:245-297 buildGrid_ICON)."""
    dims = np.asarray(dims, np.int64)
    world_lo = np.asarray(world_lo, F)
    world_hi = np.asarray(world_hi, F)
    m = int(np.prod(dims))
    vr_lo = np.full(m, FLT_MAX, F)
    vr_hi = np.full(m, -FLT_MAX, F)
    max_l = int(ds.num_layers.max()) if ds.num_cells else 0
    for L in range(max_l):
        sel = ds.num_layers > L
        sub = ICDataset(ds.lat[sel], ds.lon[sel], ds.num_layers[sel],
                        ds.height[sel], ds.value[sel])
        blo, bhi = layer_bounds(sub, sub.height[:, L], sub.height[:, L + 1])
        lo_idx = _np_project_on_grid(blo, dims, world_lo, world_hi)
        up_idx = _np_project_on_grid(bhi, dims, world_lo, world_hi)
        vlo, vhi = _layer_values(sub, L)
        _rasterize(vr_lo, vr_hi, lo_idx, up_idx, vlo, vhi, dims)
    ranges = np.stack([vr_lo, vr_hi], axis=1)
    return GridAccel(jnp.asarray(dims, jnp.int32), jnp.asarray(world_lo),
                     jnp.asarray(world_hi), jnp.asarray(ranges),
                     jnp.zeros(m, jnp.float32))


def build_shell_accel(ds: ICDataset, sph_lo, sph_hi, dims=(1, 1024, 1024)) -> ShellAccel:
    """Spherical-shell majorant grid (ref: hostCode.cu:299-336 buildShell_ICON)."""
    dims = np.asarray(dims, np.int64)
    sph_lo = np.asarray(sph_lo, F)
    sph_hi = np.asarray(sph_hi, F)
    m = int(np.prod(dims))
    vr_lo = np.full(m, FLT_MAX, F)
    vr_hi = np.full(m, -FLT_MAX, F)
    max_l = int(ds.num_layers.max()) if ds.num_cells else 0
    for L in range(max_l):
        sel = ds.num_layers > L
        sub = ICDataset(ds.lat[sel], ds.lon[sel], ds.num_layers[sel],
                        ds.height[sel], ds.value[sel])
        n = sub.num_cells
        # bottom corners -> loMC; top corners -> upMC (faithful quirk)
        sph_b = np.stack([np.broadcast_to(sub.height[:, L][:, None], (n, 3)),
                          sub.lat, sub.lon], axis=-1).astype(F)
        sph_t = np.stack([np.broadcast_to(sub.height[:, L + 1][:, None], (n, 3)),
                          sub.lat, sub.lon], axis=-1).astype(F)
        cb = _np_project_spherical(sph_b, dims, sph_lo, sph_hi)  # (n, 3, 3)
        ct = _np_project_spherical(sph_t, dims, sph_lo, sph_hi)
        lo_idx = cb.min(axis=1)
        up_idx = ct.max(axis=1)
        # shell bins are periodic in the traversal (normalizeGridCoord);
        # the build writes raw indices, so clamp into the allocated array
        # exactly as CUDA's OOB write would be UB — clamp is the safe analog
        lo_idx = np.clip(lo_idx, 0, dims - 1)
        up_idx = np.clip(up_idx, 0, dims - 1)
        vlo, vhi = _layer_values(sub, L)
        _rasterize(vr_lo, vr_hi, lo_idx, up_idx, vlo, vhi, dims)
    ranges = np.stack([vr_lo, vr_hi], axis=1)
    return ShellAccel(jnp.asarray(dims, jnp.int32), jnp.asarray(sph_lo),
                      jnp.asarray(sph_hi), jnp.asarray(ranges),
                      jnp.zeros(m, jnp.float32))


# ---------------------------------------------------------------------------
# Majorants from the transfer function (device, re-run on every TF edit)
# ---------------------------------------------------------------------------

def _lut_sparse_table(alpha):
    """Sparse table for O(1) range-max over the LUT alpha channel.
    levels[k][i] = max(alpha[i : i + 2^k])."""
    s = alpha.shape[0]
    levels = [alpha]
    k = 1
    while (1 << k) <= s:
        prev = levels[-1]
        half = 1 << (k - 1)
        shifted = jnp.concatenate([prev[half:], prev[-1:].repeat(half)])
        levels.append(jnp.maximum(prev, shifted))
        k += 1
    return levels


def compute_max_opacities(value_ranges, lut, tf_value_range):
    """Map per-bin value ranges to majorants (ref: hostCode.cu:362-434).

    value_ranges: (M, 2); lut: (S, 4); tf_value_range: (2,).
    Empty bins (upper < lower) get majorant 0.
    """
    size = lut.shape[0]
    span = tf_value_range[1] - tf_value_range[0]
    lo_n = (value_ranges[:, 0] - tf_value_range[0]) / span
    hi_n = (value_ranges[:, 1] - tf_value_range[0]) / span
    ilo = jnp.clip((lo_n * (size - 1)).astype(jnp.int32), 0, size - 1)
    ihi = jnp.clip((hi_n * (size - 1)).astype(jnp.int32) + 1, 0, size - 1)

    alpha = lut[:, 3]
    levels = _lut_sparse_table(alpha)
    length = ihi - ilo + 1  # >= 1
    # exact integer floor(log2(length)) via comparisons (static unroll)
    k = jnp.zeros_like(length)
    for j in range(1, len(levels)):
        k = jnp.where(length >= (1 << j), j, k)
    table = jnp.stack(levels)  # (K, S)
    pow2k = jnp.left_shift(jnp.int32(1), k)
    a = table[k, ilo]
    b = table[k, jnp.maximum(ihi - pow2k + 1, 0)]
    mo = jnp.maximum(a, b)
    empty = value_ranges[:, 1] < value_ranges[:, 0]
    return jnp.where(empty, 0.0, mo).astype(jnp.float32)


def update_majorants(accel, lut, tf_value_range):
    """Functional TF-edit handler (ref: hostCode.cu:878-909)."""
    mo = compute_max_opacities(accel.value_ranges, lut, tf_value_range)
    return accel._replace(max_opacities=mo)


update_majorants_jit = jax.jit(update_majorants)
