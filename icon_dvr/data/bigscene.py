"""Direct-to-quantized synthetic scene builder for north-star scales.

The general path (synthetic.icosphere -> ICDataset -> quantize_cells) is exact
but materializes ~25 GB of f32/f64 host intermediates at R2B9 and takes about
20 min of single-threaded numpy.  This builder produces the SAME kind of scene
(subdivided icosahedron, banded-wave field, uniform layer spacing) straight
into the quantized representation:

  * f32 triangle-soup subdivision (unit vectors; normalization absorbs the
    midpoint scale so no divides in the loop),
  * per-layer field evaluated at column centroids and quantized to u8
    without ever holding an (N, 32) f64 array,
  * uniform layer spacing -> h_frac is ONE broadcast row,
  * radial-band value ranges computed per layer with plain min/max
    (uniform spacing means a layer covers a contiguous scalar band range).

Results are cached under <checkout>/.cache/scenes (a repeat benchmark
run loads in seconds).  Small-scale equivalence with the exact path is
asserted in tests/test_bigscene.py.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np

from .synthetic import EARTH_RADIUS, _default_field
from ..models.cells import CellStats

F = np.float32

_ICO_T = (1.0 + np.sqrt(5.0)) / 2.0
_ICO_VERTS = np.array([
    [-1, _ICO_T, 0], [1, _ICO_T, 0], [-1, -_ICO_T, 0], [1, -_ICO_T, 0],
    [0, -1, _ICO_T], [0, 1, _ICO_T], [0, -1, -_ICO_T], [0, 1, -_ICO_T],
    [_ICO_T, 0, -1], [_ICO_T, 0, 1], [-_ICO_T, 0, -1], [-_ICO_T, 0, 1],
], np.float64)
_ICO_FACES = np.array([
    [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
    [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
    [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
    [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
], np.int64)


def _subdivide_f32(subdivisions: int) -> np.ndarray:
    """(20 * 4^s, 3, 3) f32 unit-vector triangle soup, block face order
    (same order as synthetic.icosphere, computed in f32)."""
    verts = _ICO_VERTS / np.linalg.norm(_ICO_VERTS, axis=1, keepdims=True)
    tri = verts[_ICO_FACES].astype(F)
    for _ in range(subdivisions):
        f = tri.shape[0]
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = a + b, b + c, c + a   # normalization absorbs the 1/2
        out = np.empty((4 * f, 3, 3), F)
        out[:f, 0], out[:f, 1], out[:f, 2] = a, ab, ca
        out[f:2 * f, 0], out[f:2 * f, 1], out[f:2 * f, 2] = ab, b, bc
        out[2 * f:3 * f, 0], out[2 * f:3 * f, 1], out[2 * f:3 * f, 2] = ca, bc, c
        out[3 * f:, 0], out[3 * f:, 1], out[3 * f:, 2] = ab, bc, ca
        out /= np.sqrt(np.einsum("fij,fij->fi", out, out))[:, :, None]
        tri = out
    return tri


class QuantScene(NamedTuple):
    """Host-side arrays of a quantized scene (upload with to_device)."""
    test12: np.ndarray       # (N, 12) f32
    h_frac: np.ndarray       # (N, Lm) u16
    value_q: np.ndarray      # (N, Lm) u8
    value_lo: float
    value_hi: float
    lat: np.ndarray          # (N, 3) f32 corner latitudes (locator build)
    lon: np.ndarray          # (N, 3) f32
    band_edges: np.ndarray   # (B+1,) f32
    band_ranges: np.ndarray  # (B, 2) f32
    stats: CellStats

    @property
    def num_cells(self) -> int:
        return self.test12.shape[0]


def synth_quantized(subdivisions: int, num_layers: int,
                    radius: float = float(EARTH_RADIUS),
                    thickness: float = 3.0e4,
                    num_bands: int = 64,
                    field_fn=_default_field) -> QuantScene:
    t0 = time.time()
    tri = _subdivide_f32(subdivisions)             # (N, 3, 3) unit vectors
    n = tri.shape[0]
    lat = np.arcsin(np.clip(tri[..., 2], -1.0, 1.0)).astype(F)
    lon = np.arctan2(tri[..., 1], tri[..., 0]).astype(F)
    # CCW orientation seen from outside (swap corners 1<->2 where clockwise;
    # same predicate as synthetic._orient_ccw, reusing the unit vectors)
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    cw = np.einsum("fi,fi->f", nrm, tri.mean(axis=1)) < 0.0
    tri[cw, 1], tri[cw, 2] = tri[cw, 2], tri[cw, 1].copy()
    lat[cw, 1], lat[cw, 2] = lat[cw, 2], lat[cw, 1].copy()
    lon[cw, 1], lon[cw, 2] = lon[cw, 2], lon[cw, 1].copy()

    h_bot = F(radius)
    h_top = F(radius + thickness)
    lm = max(8, -(-num_layers // 8) * 8)

    # side planes through (bv_i, bv_j, tv_j) = (c_i h_bot, c_j h_bot,
    # c_j h_top) (ref: icon_rt/ICONGrid.h:197-199); w == 0 (radial edges)
    test12 = np.empty((n, 12), F)
    for k, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
        a = tri[:, i] * h_bot
        b = tri[:, j] * h_bot
        c = tri[:, j] * h_top
        test12[:, 3 * k:3 * k + 3] = np.cross(b - a, c - a)
    test12[:, 9] = h_bot
    test12[:, 10] = h_top
    test12[:, 11] = F(num_layers)

    # uniform layer spacing -> one broadcast h_frac row
    k1 = np.arange(1, lm + 1)
    row = np.where(k1 <= num_layers,
                   np.clip(np.rint(k1 / num_layers * 65535.0), 0, 65535),
                   65535).astype(np.uint16)
    h_frac = np.broadcast_to(row, (n, lm))

    # field at column centroids, per layer (matches synthetic._fill_layers)
    clat = lat.mean(axis=1)
    clon = np.arctan2(np.sin(lon).mean(axis=1), np.cos(lon).mean(axis=1))
    layer_vals = [field_fn(clat, clon, F((j + 0.5) / num_layers))
                  for j in range(num_layers)]
    lo = float(min(v.min() for v in layer_vals))
    hi = float(max(v.max() for v in layer_vals))
    if not hi > lo:
        hi = lo + 1.0
    value_q = np.zeros((n, lm), np.uint8)
    scale = F(255.0) / F(hi - lo)
    band_ranges_lo = np.full(num_bands, np.finfo(F).max, F)
    band_ranges_hi = np.full(num_bands, -np.finfo(F).max, F)
    edges = np.linspace(h_bot, h_top, num_bands + 1).astype(F)
    layer_h = thickness / num_layers
    for j, v in enumerate(layer_vals):
        q = np.clip(np.rint((v - F(lo)) * scale), 0, 255).astype(np.uint8)
        value_q[:, j] = q
        # dequantized layer range -> the radial bands this layer overlaps
        v_lo = lo + float(q.min()) * (hi - lo) / 255.0
        v_hi = lo + float(q.max()) * (hi - lo) / 255.0
        b0 = min(int((j * layer_h) / thickness * num_bands), num_bands - 1)
        b1 = min(int(((j + 1) * layer_h) / thickness * num_bands), num_bands - 1)
        band_ranges_lo[b0:b1 + 1] = np.minimum(band_ranges_lo[b0:b1 + 1], v_lo)
        band_ranges_hi[b0:b1 + 1] = np.maximum(band_ranges_hi[b0:b1 + 1], v_hi)

    # world bounds: sphere AABB inflated by the reference's outward bulge
    # correction (ref: icon_rt/ICONGrid.h:78-115 scales top vertices by
    # 1 + (r - |barycenter|)/r, i.e. by (2 - |mean corner unit vector|))
    m_min = float(np.sqrt(np.einsum(
        "fi,fi->f", tri.mean(axis=1), tri.mean(axis=1))).min())
    r_box = h_top * (2.0 - m_min)
    stats = CellStats(
        world_bounds_lo=np.array([-r_box, -r_box, -r_box], F),
        world_bounds_hi=np.array([r_box, r_box, r_box], F),
        spherical_bounds_lo=np.array([h_bot, lat.min(), lon.min()], F),
        spherical_bounds_hi=np.array([h_top, lat.max(), lon.max()], F),
        data_range=np.array([lo + 0.0, lo + (hi - lo)], F),
    )
    print(f"# bigscene: {n} cells built in {time.time() - t0:.1f}s",
          flush=True)
    return QuantScene(test12=test12, h_frac=np.ascontiguousarray(h_frac),
                      value_q=value_q, value_lo=lo, value_hi=hi,
                      lat=lat, lon=lon, band_edges=edges,
                      band_ranges=np.stack([band_ranges_lo, band_ranges_hi],
                                           axis=1), stats=stats)


_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".cache", "scenes")


def synth_quantized_cached(subdivisions: int, num_layers: int,
                           **kw) -> QuantScene:
    """Disk-cached synth_quantized (the R2B9 build is minutes of host work;
    repeat benchmark runs load the npz in seconds)."""
    path = os.path.join(_CACHE_DIR, f"qscene_s{subdivisions}_l{num_layers}.npz")
    if os.path.exists(path) and not kw:
        z = np.load(path)
        stats = CellStats(z["wb_lo"], z["wb_hi"], z["sb_lo"], z["sb_hi"],
                          z["dr"])
        return QuantScene(z["test12"], z["h_frac"], z["value_q"],
                          float(z["value_lo"]), float(z["value_hi"]),
                          z["lat"], z["lon"], z["band_edges"],
                          z["band_ranges"], stats)
    sc = synth_quantized(subdivisions, num_layers, **kw)
    if not kw:
        try:
            os.makedirs(_CACHE_DIR, exist_ok=True)
            np.savez(path, test12=sc.test12, h_frac=sc.h_frac,
                     value_q=sc.value_q, value_lo=sc.value_lo,
                     value_hi=sc.value_hi, lat=sc.lat, lon=sc.lon,
                     band_edges=sc.band_edges, band_ranges=sc.band_ranges,
                     wb_lo=sc.stats.world_bounds_lo,
                     wb_hi=sc.stats.world_bounds_hi,
                     sb_lo=sc.stats.spherical_bounds_lo,
                     sb_hi=sc.stats.spherical_bounds_hi,
                     dr=sc.stats.data_range)
        except OSError:
            pass
    return sc


def to_device(sc: QuantScene):
    """(QuantizedCells, RadialBands) on the default device."""
    import jax.numpy as jnp
    from ..models.qcells import QuantizedCells
    from ..models.shells import RadialBands
    # PACK everything (utils/layout.pack_table; test12 12 -> 16-lane
    # slots, see QuantizedCells)
    import jax

    from ..utils.layout import pack_table
    hf = sc.h_frac
    if hf.shape[0] and bool((hf == hf[0]).all()):
        hf = hf[:1]   # uniform layer spacing: one shared row
    n_cells, lm = sc.value_q.shape
    flm = max(1, 128 // lm)
    q = QuantizedCells(
        test12=jax.device_put(pack_table(
            np.ascontiguousarray(sc.test12[:, :12]))),
        h_frac=jax.device_put(np.ascontiguousarray(hf)),
        value_q=jax.device_put(pack_table(sc.value_q)),
        # alpha starts all-zero: allocate ON device instead of uploading
        # a zeros table
        alpha_q=jnp.zeros((-(-n_cells // flm), flm * lm), jnp.uint8),
        value_lo=jnp.float32(sc.value_lo), value_hi=jnp.float32(sc.value_hi),
        alpha_max=jnp.float32(1.0),
    )
    bands = RadialBands(edges=jnp.asarray(sc.band_edges),
                        value_ranges=jnp.asarray(sc.band_ranges),
                        max_opacities=jnp.zeros(sc.band_ranges.shape[0],
                                                jnp.float32))
    return q, bands


def locator_cache_path(cache_key: str, dims_scale: float = 1.0) -> str:
    """npz cache location of the densified locator bins."""
    suffix = "" if dims_scale == 1.0 else f"_x{dims_scale:g}"
    return os.path.join(_CACHE_DIR, f"qloc2_{cache_key}{suffix}.npz")


def finemap_cache_path(cache_key: str, dims_scale: float,
                       factor: int) -> str:
    suffix = "" if dims_scale == 1.0 else f"_x{dims_scale:g}"
    return os.path.join(_CACHE_DIR, f"fmap_{cache_key}{suffix}_f{factor}.npz")


def build_finemap_cached(loc, test12, k_cap: int, factor: int,
                         cache_key: str | None = None,
                         dims_scale: float = 1.0):
    """npz-cached models/finemap.build_finemap: the device-side build at
    R2B9 is paid per PROCESS (bench rows run in subprocesses), while the
    u8 map is only 0.67 GB to load on later runs.
    Valid to key by (scene, locator scale, factor): the map's slot
    encoding is relative to the locator rows, which the same key caches."""
    import jax
    import jax.numpy as jnp

    from ..models.finemap import FineMap, build_finemap

    path = (finemap_cache_path(cache_key, dims_scale, factor)
            if cache_key else None)
    if path and os.path.exists(path):
        z = np.load(path)
        return FineMap(pairs=jax.device_put(z["pairs"]),
                       lat_lo=jnp.float32(z["lat_lo"]),
                       lat_hi=jnp.float32(z["lat_hi"]),
                       lon_lo=jnp.float32(z["lon_lo"]),
                       lon_hi=jnp.float32(z["lon_hi"]),
                       dims=jnp.asarray(z["dims"]))
    fm = build_finemap(loc, test12, k_cap, factor=factor)
    if path:
        try:
            os.makedirs(_CACHE_DIR, exist_ok=True)
            np.savez(path, pairs=np.asarray(fm.pairs),
                     lat_lo=float(fm.lat_lo), lat_hi=float(fm.lat_hi),
                     lon_lo=float(fm.lon_lo), lon_hi=float(fm.lon_hi),
                     dims=np.asarray(fm.dims))
        except OSError:
            pass
    return fm


def build_locator_csr_from_scene(sc: QuantScene, dims=None,
                                 cache_key: str | None = None,
                                 dims_scale: float = 1.0):
    """Dense locator for a QuantScene (only corner lat/lon are needed);
    returns (Locator, k).  Built via the CSR binning pass then densified
    (see models/locator.densify_csr).

    cache_key: npz-caches the dense bins under the scene cache dir (the
    R2B9 binning pass is minutes of host work per bench run).

    dims_scale: multiplies the default sqrt(N/2) grid side.  0.5 quarters
    the bin count; max occupancy (k_cap) roughly doubles (measured 18 ->
    38 at subdiv 8), so the dense table shrinks ~2x — 3.0 GB -> ~1.6 GB
    at R2B9, for devices whose memory the full grid does not fit.  Wider
    candidate rows only cost on the full-locate tail, which the fine-map
    primary keeps at ~6% of locates."""
    import jax
    import jax.numpy as jnp
    from ..models.locator import Locator, build_locator_csr, densify_csr
    from ..utils.layout import pack_table

    path = (locator_cache_path(cache_key, dims_scale)
            if cache_key and dims is None else None)
    if path and os.path.exists(path):
        z = np.load(path)
        loc = Locator(bins=jax.device_put(pack_table(z["bins"], pad_value=-1,
                                                     align=False)),
                      lat_lo=jnp.float32(z["lat_lo"]),
                      lat_hi=jnp.float32(z["lat_hi"]),
                      lon_lo=jnp.float32(z["lon_lo"]),
                      lon_hi=jnp.float32(z["lon_hi"]),
                      dims=jnp.asarray(z["dims"]))
        return loc, int(z["k_cap"])

    class _LatLon:
        pass

    ds = _LatLon()
    ds.lat = sc.lat
    ds.lon = sc.lon
    ds.num_cells = sc.num_cells
    if dims is None and dims_scale != 1.0:
        side = max(1, int(np.sqrt(max(sc.num_cells, 1) / 2) * dims_scale))
        dims = (side, side)
    csr, k_cap = build_locator_csr(ds, dims=dims)
    loc = densify_csr(csr, k_cap)
    if path:
        try:
            os.makedirs(_CACHE_DIR, exist_ok=True)
            np.savez(path, bins=np.asarray(loc.bins), k_cap=k_cap,
                     lat_lo=float(loc.lat_lo), lat_hi=float(loc.lat_hi),
                     lon_lo=float(loc.lon_lo), lon_hi=float(loc.lon_hi),
                     dims=np.asarray(loc.dims))
        except OSError:
            pass
    return loc, k_cap
