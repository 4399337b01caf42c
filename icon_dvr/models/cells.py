"""Device-resident ICON cell columns, structure-of-arrays.

The reference's core data element is one triangular prism column of the
icosahedral grid with up to 32 stacked layers (ref: icon_rt/ICONGrid.h:59-77).
The CUDA renderer keeps an array-of-structs and recomputes side planes on
every point query (ref: icon_rt/ICONGrid.h:181-208); we keep SoA
arrays and precompute the three side planes per cell at load time so a point
query is a handful of dense vector ops:

    inside = (h_bot <= r <= h_top) AND (dot(pos, n_k) - w_k <= 0 for k=1..3)

Layer lookup (findHeight, ref: icon_rt/ICONGrid.h:117-145) becomes a masked
popcount over the fixed-size (32,) height vector — branch-free and fully
vectorizable, returning the same index as the reference binary search.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..data.icfile import ICDataset, MAX_LAYERS
from ..utils.vecmath import np_to_cartesian


class Cells(NamedTuple):
    """Pytree of per-cell arrays (all leading dim N)."""
    lat: jnp.ndarray           # (N, 3) f32 radians
    lon: jnp.ndarray           # (N, 3) f32 radians
    num_layers: jnp.ndarray    # (N,)   i32
    height: jnp.ndarray        # (N, 32) f32 radii
    value: jnp.ndarray         # (N, 32) f32 scalars
    planes: jnp.ndarray        # (N, 3, 4) f32 precomputed side planes
    h_bot: jnp.ndarray         # (N,) f32 = height[:, 0]
    h_top: jnp.ndarray         # (N,) f32 = height[num_layers]

    @property
    def num_cells(self) -> int:
        return self.lat.shape[0]


class CellStats(NamedTuple):
    """Host-side aggregates computed at load time (ref: hostCode.cu:760-808)."""
    world_bounds_lo: np.ndarray    # (3,) f32 Cartesian AABB
    world_bounds_hi: np.ndarray    # (3,) f32
    spherical_bounds_lo: np.ndarray  # (3,) f32 (r, lat, lon)
    spherical_bounds_hi: np.ndarray  # (3,) f32
    data_range: np.ndarray         # (2,) f32 (min, max scalar)


def _corner_xyz(ds: ICDataset, radii: np.ndarray) -> np.ndarray:
    """(N,) radii + per-corner lat/lon -> (N, 3, 3) Cartesian corners."""
    sph = np.stack([np.broadcast_to(radii[:, None], ds.lat.shape),
                    ds.lat, ds.lon], axis=-1)
    return np_to_cartesian(sph)


def _np_plane(a, b, c):
    n = np.cross(b - a, c - a).astype(np.float32)
    w = np.sum(a * n, axis=-1, dtype=np.float32)
    return np.concatenate([n, w[..., None]], axis=-1)


def build_cells(ds: ICDataset) -> Cells:
    n = ds.num_cells
    idx = np.arange(n)
    h_bot = ds.height[:, 0].astype(np.float32)
    h_top = ds.height[idx, ds.num_layers].astype(np.float32)

    bv = _corner_xyz(ds, h_bot)   # (N, 3, 3) bottom corners
    tv = _corner_xyz(ds, h_top)   # (N, 3, 3) top corners

    # Side planes through (bv_i, bv_j, tv_j), CCW (ref: ICONGrid.h:197-199)
    p1 = _np_plane(bv[:, 0], bv[:, 1], tv[:, 1])
    p2 = _np_plane(bv[:, 1], bv[:, 2], tv[:, 2])
    p3 = _np_plane(bv[:, 2], bv[:, 0], tv[:, 0])
    planes = np.stack([p1, p2, p3], axis=1)

    return Cells(
        lat=jnp.asarray(ds.lat), lon=jnp.asarray(ds.lon),
        num_layers=jnp.asarray(ds.num_layers),
        height=jnp.asarray(ds.height), value=jnp.asarray(ds.value),
        planes=jnp.asarray(planes),
        h_bot=jnp.asarray(h_bot), h_top=jnp.asarray(h_top),
    )


def cell_bounds(ds: ICDataset) -> tuple[np.ndarray, np.ndarray]:
    """Per-cell Cartesian AABBs with the outward bulge correction for the
    curved top face (ref: icon_rt/ICONGrid.h:78-115)."""
    idx = np.arange(ds.num_cells)
    h_bot = ds.height[:, 0].astype(np.float32)
    h_top = ds.height[idx, ds.num_layers].astype(np.float32)
    bv = _corner_xyz(ds, h_bot)
    tv = _corner_xyz(ds, h_top)
    bary = tv.mean(axis=1, dtype=np.float32).astype(np.float32)
    r = h_top
    d = r - np.sqrt(np.sum(bary * bary, axis=-1, dtype=np.float32))
    off = (d / r).astype(np.float32)
    tv = tv + tv * off[:, None, None]
    pts = np.concatenate([bv, tv], axis=1)  # (N, 6, 3)
    return pts.min(axis=1), pts.max(axis=1)


def layer_bounds(ds: ICDataset, layer_lo: np.ndarray, layer_hi: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Cartesian AABBs of one layer slab per cell, with bulge correction on
    the top face (ref: icon_rt/hostCode.cu:256-290). layer_lo/hi are (N,)
    radii of the slab's bottom/top."""
    bv = _corner_xyz(ds, layer_lo.astype(np.float32))
    tv = _corner_xyz(ds, layer_hi.astype(np.float32))
    bary = tv.mean(axis=1, dtype=np.float32).astype(np.float32)
    r = layer_hi.astype(np.float32)
    d = r - np.sqrt(np.sum(bary * bary, axis=-1, dtype=np.float32))
    off = (d / r).astype(np.float32)
    tv = tv + tv * off[:, None, None]
    pts = np.concatenate([bv, tv], axis=1)
    return pts.min(axis=1), pts.max(axis=1)


def compute_stats(ds: ICDataset) -> CellStats:
    lo, hi = cell_bounds(ds)
    idx = np.arange(ds.num_cells)
    h_top = ds.height[idx, ds.num_layers]
    layer_mask = np.arange(MAX_LAYERS)[None, :] < ds.num_layers[:, None]
    vals = ds.value[layer_mask]
    return CellStats(
        world_bounds_lo=lo.min(axis=0).astype(np.float32),
        world_bounds_hi=hi.max(axis=0).astype(np.float32),
        spherical_bounds_lo=np.array([ds.height[:, 0].min(), ds.lat.min(), ds.lon.min()], np.float32),
        spherical_bounds_hi=np.array([h_top.max(), ds.lat.max(), ds.lon.max()], np.float32),
        data_range=np.array([vals.min(), vals.max()], np.float32) if vals.size
        else np.array([np.inf, -np.inf], np.float32),
    )


# ---------------------------------------------------------------------------
# Device-side point sampling
# ---------------------------------------------------------------------------

def find_layer(height_row, num_layers, hpos):
    """Index i of the layer containing radius hpos: smallest i with
    hpos <= height[i+1].  Matches the reference's branchless binary search
    (ref: icon_rt/ICONGrid.h:117-145) as a masked popcount."""
    k = jnp.arange(1, MAX_LAYERS)
    mask = (k <= num_layers) & (height_row[1:] < hpos)
    return jnp.sum(mask.astype(jnp.int32))


def _eval_planes(planes, pos):
    """planes (..., 3, 4), pos (..., 3) -> (..., 3) plane evaluations."""
    return jnp.sum(planes[..., :3] * pos[..., None, :], axis=-1) - planes[..., 3]


def sample_one_cell(cells: Cells, cell_idx, pos, r):
    """Point-in-prism test + layer value for a single cell index.

    pos is the Cartesian sample point, r its precomputed radius.
    Returns (inside: bool, value: f32).  ref: icon_rt/ICONGrid.h:181-208.
    """
    inside_r = (r >= cells.h_bot[cell_idx]) & (r <= cells.h_top[cell_idx])
    ev = _eval_planes(cells.planes[cell_idx], pos)
    inside = inside_r & jnp.all(ev <= 0.0, axis=-1)
    layer = find_layer(cells.height[cell_idx], cells.num_layers[cell_idx], r)
    val = cells.value[cell_idx, layer]
    return inside, jnp.where(inside, val, 0.0)


def sample_brute_force(cells: Cells, pos):
    """Linear scan over all cells; the reference's no-RT fallback
    (ref: icon_rt/deviceCode.cu:116-123).  First (lowest-index) hit wins;
    columns tile space, so at most one cell contains the point.

    pos: (3,) -> (hit: bool, value: f32)
    """
    r = jnp.sqrt(jnp.sum(pos * pos))
    inside_r = (r >= cells.h_bot) & (r <= cells.h_top)        # (N,)
    ev = _eval_planes(cells.planes, pos)                      # (N, 3)
    inside = inside_r & jnp.all(ev <= 0.0, axis=-1)           # (N,)
    hit = jnp.any(inside)
    idx = jnp.argmax(inside)  # first True
    layer = find_layer(cells.height[idx], cells.num_layers[idx], r)
    value = jnp.where(hit, cells.value[idx, layer], 0.0)
    return hit, value
