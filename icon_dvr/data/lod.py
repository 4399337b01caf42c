"""Level-of-detail mip tiers for icosphere scenes.

The reference renders the full-resolution field regardless of framing
(ref: icon_rt/deviceCode.cu:281-341 — one fixed cell set).  At R2B9 on a
1080p frame the cells are SUBPIXEL (~3.4 km edge vs ~5 km pixel footprint
at the closeup framing), so the full-resolution walk pays locator traffic
for detail the image cannot resolve — and aliases it as extra Monte-Carlo
variance.  A value-space mip chain fixes both: render the level whose
cell size matches the pixel footprint.

Index rule.  Cell i of a subdivision-s icosphere decomposes as
`base = i % 20`, child path = base-4 digits of i // 20 with the LSB the
FIRST subdivision (data/device_scene.py).  The digit added by the LAST
subdivision is therefore the most significant, with place value
20 * 4^(s-1) = n/4, so

    parent(i)   = i mod (n / 4)
    children(p) = { p + d * (n / 4) : d in 0..3 }
    descendants of p after l more levels = { p + m * n_coarse : m < 4^l }

Geometry of mip level l IS the subdivision-(s-l) icosphere (triangle
midpoint subdivision partitions each parent triangle exactly), so only
the FIELD is derived: per-layer 4:1 mean pooling per level, in VALUE
space — classification stays at sample time, preserving the reference's
sampling order (ref: icon_rt/deviceCode.cu:127-135).  The estimator on a mip
tier is the standard unbiased delta tracker for THAT tier's field.
`device_scene.synth_quantized_device(s-l, ..., field_lod=l)` builds the tier
on-device; its locator and fine map are plain subdivision-(s-l) artifacts
(geometry-only), shared with any other scene of that subdivision via the npz
caches.
"""
from __future__ import annotations

import numpy as np

#: central angle of an icosahedron edge: arccos(1/sqrt(5)) ~ 63.435deg
_ICO_EDGE_RAD = float(np.arccos(1.0 / np.sqrt(5.0)))


def parent_index(i, n: int):
    """Level-(s-1) parent of cell i in a subdivision-s icosphere of n
    cells (array-friendly)."""
    return i % (n // 4)


def children_indices(p, n_coarse: int) -> list:
    """The 4 subdivision-(s+1) children of coarse cell p (n_coarse =
    coarse-level cell count; children live at index p + d * n_coarse of
    the 4 * n_coarse fine cells)."""
    return [p + d * n_coarse for d in range(4)]


def cell_edge_m(subdivisions: int, radius: float) -> float:
    """Arc length of a cell edge at the given subdivision (meters).
    Midpoint subdivision halves edge angles per level (up to the slight
    non-uniformity of the projected midpoints)."""
    return radius * _ICO_EDGE_RAD / (2.0 ** subdivisions)


def equivalent_subdiv(n_cells: int) -> int:
    """Icosphere-subdivision equivalent of an arbitrary N-column grid
    (20 * 4^s = N): the resolution input select_lod needs for
    file-loaded datasets whose cell count is not exactly icosahedral."""
    return max(0, int(round(np.log(max(n_cells, 20) / 20.0) / np.log(4.0))))


def build_lod_dataset(ds, level: int, num_layers: int | None = None):
    """GEOMETRIC mip tier for ARBITRARY datasets.

    The index-arithmetic parent rule above is valid only for the
    procedural icosphere's cell ordering; a `.ic` file from
    tools/convert_icon has no such structure.  This derives the coarse
    tier from geometry alone:

      * coarse GEOMETRY = a plain icosphere at subdivision
        equivalent_subdiv(N) - level (ICON grids are icosahedral, so the
        coarse triangulation is the natural parent mesh even when it is
        not index-aligned with the data);
      * every fine column is assigned to the coarse column whose side
        planes CONTAIN its centroid direction (coarse locator bins ->
        candidate plane tests — the same machinery the renderer uses);
      * per coarse column: radial span = [min member h_bot, max member
        h_top], uniform layers, and each layer's value = mean over
        members of the member's value at the layer midpoint radius
        (clamped into the member's span — boundary extension, the
        standard conservative pooling for terrain columns).

    Returns a standard ICDataset: every normal builder (build_cells,
    locators, quantize_cells, radial bands, finemap) applies unchanged,
    so the tier plugs into the existing render paths and npz caches.
    The estimator on the tier is the unbiased tracker for the POOLED
    field (same contract as the procedural mip tiers above)."""
    from .icfile import ICDataset, MAX_LAYERS
    from .synthetic import _orient_ccw
    from ..utils.vecmath import np_to_cartesian

    n = ds.num_cells
    s_c = max(0, equivalent_subdiv(n) - max(level, 0))
    idx = np.arange(n)
    h_bot_f = ds.height[:, 0].astype(np.float64)
    h_top_f = ds.height[idx, ds.num_layers].astype(np.float64)
    r_lo, r_hi = float(h_bot_f.min()), float(h_top_f.max())

    # provisional coarse geometry spanning the full radial range
    from .synthetic import icosphere
    coarse = icosphere(subdivisions=s_c, num_layers=1, radius=r_lo,
                       thickness=max(r_hi - r_lo, 1.0))
    nc = coarse.num_cells

    # fine centroid directions (cartesian mean of corners — robust at the
    # poles and across the lon wrap, unlike averaging lat/lon)
    sph = np.stack([np.ones_like(ds.lat), ds.lat, ds.lon], axis=-1)
    u = np_to_cartesian(sph).mean(axis=1)
    u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-30)
    r_mid = 0.5 * (r_lo + r_hi)
    pts = (u * r_mid).astype(np.float64)
    clat = np.arcsin(np.clip(u[:, 2], -1.0, 1.0))
    clon = np.arctan2(u[:, 1], u[:, 0])

    # coarse side planes (build_cells plane construction, host numpy)
    from ..models.cells import build_cells
    planes = np.asarray(build_cells(coarse).planes, np.float64)  # (Nc,3,4)

    # locator-binned candidate assignment: O(N * k_cap) not O(N * Nc)
    from ..models.locator import build_locator_csr
    csr, k_cap = build_locator_csr(coarse)
    starts = np.asarray(csr.starts)
    counts = np.asarray(csr.counts)
    items = np.asarray(csr.items)
    n_lat, n_lon = int(csr.dims[0]), int(csr.dims[1])
    bl = np.clip(((clat - float(csr.lat_lo))
                  / (float(csr.lat_hi) - float(csr.lat_lo)) * n_lat
                  ).astype(np.int64), 0, n_lat - 1)
    bo = np.clip(((clon - float(csr.lon_lo))
                  / (float(csr.lon_hi) - float(csr.lon_lo)) * n_lon
                  ).astype(np.int64), 0, n_lon - 1)
    bid = bl * n_lon + bo
    assign = np.full(n, -1, np.int64)
    for kslot in range(k_cap):
        rows = starts[bid] + kslot
        ok = (kslot < counts[bid]) & (assign < 0)
        cand = np.where(ok, items[np.minimum(rows, len(items) - 1)], 0)
        ev = np.einsum("nkj,nj->nk", planes[cand, :, :3], pts) \
            - planes[cand, :, 3]
        inside = ok & (ev <= 1e-6 * r_mid).all(axis=1)
        assign = np.where(inside & (assign < 0), cand, assign)
    # rare orphans (centroid exactly on a shared plane): nearest coarse
    # centroid fallback keeps the partition total
    if (assign < 0).any():
        cu = np_to_cartesian(np.stack([np.ones_like(coarse.lat),
                                       coarse.lat, coarse.lon],
                                      axis=-1)).mean(axis=1)
        cu /= np.maximum(np.linalg.norm(cu, axis=1, keepdims=True), 1e-30)
        orphans = np.where(assign < 0)[0]
        assign[orphans] = np.argmax(u[orphans] @ cu.T, axis=1)

    # pooled radial spans
    members = np.bincount(assign, minlength=nc)
    hb = np.full(nc, np.inf)
    ht = np.full(nc, -np.inf)
    np.minimum.at(hb, assign, h_bot_f)
    np.maximum.at(ht, assign, h_top_f)
    keep = members > 0      # regional datasets leave empty coarse cells
    lc = int(num_layers if num_layers is not None
             else min(MAX_LAYERS - 1, int(ds.num_layers.max())))

    height_c = np.zeros((nc, MAX_LAYERS), np.float32)
    value_c = np.zeros((nc, MAX_LAYERS), np.float32)
    hb_s = np.where(keep, hb, r_lo)
    ht_s = np.where(keep, ht, r_hi)
    for j in range(lc + 1):
        height_c[:, j] = hb_s + (ht_s - hb_s) * (j / lc)
    ceil_f = ds.height[:, 1:MAX_LAYERS]          # fine layer ceilings
    for k in range(lc):
        mid = 0.5 * (height_c[:, k] + height_c[:, k + 1])    # (Nc,)
        mid_f = mid[assign]
        lay = (mid_f[:, None] > ceil_f).sum(axis=1)
        lay = np.minimum(lay, np.maximum(ds.num_layers - 1, 0))
        vf = ds.value[idx, lay]
        acc = np.zeros(nc)
        np.add.at(acc, assign, vf)
        value_c[:, k] = np.where(keep, acc / np.maximum(members, 1),
                                 0.0).astype(np.float32)

    out = ICDataset(
        lat=coarse.lat[keep], lon=coarse.lon[keep],
        num_layers=np.full(int(keep.sum()), lc, np.int32),
        height=height_c[keep], value=value_c[keep])
    # re-index the assignment into the kept rows (every assigned coarse
    # cell has members, so it is always kept)
    remap = np.cumsum(keep) - 1
    return out, remap[assign]


def select_lod(cam_org, r_out: float, fovy: float, height: int,
               subdivisions: int, max_lod: int = 4) -> int:
    """Nearest-mip level for a whole frame: lambda = log2(pixel footprint
    at the globe's near point / cell edge), rounded — the standard
    nearest-level mip rule (level 0 when cells are at or above pixel
    size).  Per-frame (not per-ray) selection is exact enough for a
    globe: the camera-to-surface distance varies by < 2x across the
    visible disc, well inside one mip level's 2x bucket."""
    d = float(np.linalg.norm(np.asarray(cam_org, np.float64)))
    d_near = max(d - r_out, 1e-6 * r_out)
    pixel_rad = fovy / height
    footprint = pixel_rad * d_near
    lam = np.log2(max(footprint, 1e-30)
                  / cell_edge_m(subdivisions, r_out))
    return int(np.clip(np.round(lam), 0, max_lod))
