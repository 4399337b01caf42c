"""Grid-of-lists cell locator — the lane-parallel replacement for BVH
point queries.

The reference locates the column containing a sample point with OptiX
user-geometry BVH queries or cuBQL traversal (ref: icon_rt/deviceCode.cu:
58-125, hostCode.cu:489-525).  BVH traversal is hostile to SIMD lanes; the
lane-parallel design is a dense 2-D (lat, lon) binning: ICON columns span
the full radial extent, so a 2-D footprint grid suffices.  Each bin holds a
fixed-width, -1-padded candidate list; a point query is

    bin = floor((lat, lon) normalized * dims)      # 2 flops
    ids = bins[bin]                                # one (K,) gather
    inside = radial check + 3 plane tests over K   # dense vector math
    first hit (lowest cell id) wins                # == brute-force order

Candidate lists are built conservatively from corner bounding boxes
(dateline-crossing cells are inserted as two wrapped lon ranges), so a
query returns exactly the brute-force result: the lowest-indexed cell
containing the point.  K is the max bin occupancy, a build-time constant —
static shapes, fully vectorizable, no divergence.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..data.icfile import ICDataset
from .cells import Cells, find_layer

F = np.float32


class Locator(NamedTuple):
    bins: jnp.ndarray      # (n_lat * n_lon, K) i32 cell ids, -1 padded.
                           # densify_csr emits the PACK-8 row layout
                           # ((n_bins/f, f*K), utils/layout.pack_table) —
                           # quantized-tier consumers gather via
                           # packed_gather(bins, bid, k_cap)
    lat_lo: jnp.ndarray    # () f32
    lat_hi: jnp.ndarray    # () f32
    lon_lo: jnp.ndarray    # () f32
    lon_hi: jnp.ndarray    # () f32
    dims: jnp.ndarray      # (2,) i32 (n_lat, n_lon)

    @property
    def k(self) -> int:
        return self.bins.shape[1]


class LocatorCSR(NamedTuple):
    """Memory-proportional locator for very large grids (R2B9: a dense
    (n_bins, K_max) table pays K_max for every bin; CSR pays only the true
    occupancy).  Entries of one bin are contiguous in `items`; a query
    gathers `k_cap` consecutive ids from `starts[bin]` and masks by
    `counts[bin]`.  k_cap == max occupancy, so queries see every candidate."""
    starts: jnp.ndarray    # (n_lat * n_lon,) i32 offset into items
    counts: jnp.ndarray    # (n_lat * n_lon,) i32
    items: jnp.ndarray     # (M,) i32 cell ids, bin-major, ascending per bin
    lat_lo: jnp.ndarray
    lat_hi: jnp.ndarray
    lon_lo: jnp.ndarray
    lon_hi: jnp.ndarray
    dims: jnp.ndarray      # (2,) i32 (n_lat, n_lon)


def _edge_extrema(lat: np.ndarray, lon: np.ndarray,
                  chunk: int = 1 << 22, use_native: bool = True):
    """Per-cell (lat_min, lat_max, extra_lons, pole) accounting for
    great-circle EDGE BULGE: the latitude extremum of a minor arc can lie
    strictly between its endpoints (the arc's closest approach to a
    pole), and the cell's longitude hull widens at exactly that point.
    A vertex-bbox rasterization misses those slivers, so the locator
    returned "no candidate" for points a brute-force containment test
    puts INSIDE a cell (at subdiv 1 one camera ray hit 531 such points).

    Returns (lat_min (N,), lat_max (N,), lon_ext (N, 3) extremum lons —
    copies of lon[:, 0] where no interior extremum — and pole (N,) i8:
    +1 north pole inside, -1 south, 0 neither).

    The numpy body below is the ORACLE; the native C++ mirror
    (ih_edge_extrema, same f64 formula order, tested element-equal in
    tests/test_native.py) runs by default because the numpy temporaries
    cost ~5 us/cell-chunk — ~7 min at R2B9's 84M cells vs seconds."""
    if use_native:
        from ..utils.native import native_edge_extrema
        res = native_edge_extrema(lat, lon)
        if res is not None:
            return res
    n = lat.shape[0]
    lat_min = lat.min(axis=1).astype(np.float64)
    lat_max = lat.max(axis=1).astype(np.float64)
    lon_ext = np.tile(lon[:, :1].astype(np.float64), (1, 3))
    pole = np.zeros(n, np.int8)
    for s0 in range(0, n, chunk):
        s = slice(s0, min(s0 + chunk, n))
        la = lat[s].astype(np.float64)
        lo = lon[s].astype(np.float64)
        cl = np.cos(la)
        u = np.stack([cl * np.cos(lo), cl * np.sin(lo), np.sin(la)],
                     axis=-1)                        # (m, 3 verts, 3)
        # pole containment: all three side planes (through the origin,
        # CCW vertex order) contain +-z
        mm = np.cross(u, u[:, [1, 2, 0]])            # (m, 3 edges, 3)
        zin = mm[..., 2]
        pole[s] = np.where((zin <= 0).all(axis=1), 1,
                           np.where((zin >= 0).all(axis=1), -1, 0))
        for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
            m3 = mm[:, e]                            # cross(u_i, u_j)
            nrm = np.linalg.norm(m3, axis=1)
            mz = m3[:, 2] / np.maximum(nrm, 1e-300)
            # z-extremum point of the great circle: projection of z-hat
            # onto the circle plane (two antipodes; a minor arc holds
            # at most one)
            zml = np.sqrt(np.maximum(1.0 - mz * mz, 0.0))
            ex = -mz * m3[:, 0] / np.maximum(nrm, 1e-300)
            ey = -mz * m3[:, 1] / np.maximum(nrm, 1e-300)
            ez = zml * zml       # = 1 - mz^2, the unnormalized z comp
            den = np.maximum(zml, 1e-300)
            for sign in (1.0, -1.0):
                px, py, pz = sign * ex / den, sign * ey / den, \
                    sign * ez / den
                p = np.stack([px, py, pz], axis=1)
                # interior test: e strictly between u_i and u_j along
                # the minor arc <=> cross(u_i, p) and cross(p, u_j)
                # both align with the arc plane normal
                c1 = np.einsum('ij,ij->i', np.cross(u[:, i], p), m3)
                c2 = np.einsum('ij,ij->i', np.cross(p, u[:, j]), m3)
                interior = (c1 > 0) & (c2 > 0) & (zml > 1e-12)
                if not interior.any():
                    continue
                plat = np.arcsin(np.clip(pz, -1.0, 1.0))
                plon = np.arctan2(py, px)
                lat_min[s] = np.where(interior,
                                      np.minimum(lat_min[s], plat),
                                      lat_min[s])
                lat_max[s] = np.where(interior,
                                      np.maximum(lat_max[s], plat),
                                      lat_max[s])
                lon_ext[s.start:s.stop, e] = np.where(
                    interior, plon, lon_ext[s.start:s.stop, e])
    return lat_min, lat_max, lon_ext, pole


def _range_records(ds: ICDataset, n_lat: int, n_lon: int,
                   lat_lo, lat_hi, lon_lo, lon_hi) -> np.ndarray:
    """(R, 5) i64 records (cell_id, la0, la1, lb0, lb1) — each cell's bin
    rectangle(s), sorted by cell id.  THE single source of binning truth:
    both the numpy expansion (_bbox_entries) and the native C++ scatter
    (utils.native.native_locator_bins) consume these records, so the
    edge-bulge geometry below cannot diverge between the two paths.

    Cell extents are the spherical hull of vertices AND edge-bulge
    extrema (_edge_extrema); pole-containing cells span the full
    longitude circle; dateline straddlers contribute two wrapped lon
    ranges."""
    n = ds.num_cells

    def lat_bin(v):
        return np.clip(((v - lat_lo) / (lat_hi - lat_lo) * n_lat).astype(np.int64),
                       0, n_lat - 1)

    def lon_bin(v):
        return np.clip(((v - lon_lo) / (lon_hi - lon_lo) * n_lon).astype(np.int64),
                       0, n_lon - 1)

    elat_min, elat_max, elon, pole = _edge_extrema(ds.lat, ds.lon)
    lat_all = np.concatenate([ds.lat, elat_min[:, None], elat_max[:, None]],
                             axis=1)
    lon_all = np.concatenate([ds.lon, elon], axis=1)   # (N, 6)
    lat_all[pole > 0, -1] = lat_hi                     # pole rows reach the
    lat_all[pole < 0, -2] = lat_lo                     # window's lat edge
    la0 = lat_bin(lat_all.min(axis=1))
    la1 = lat_bin(lat_all.max(axis=1))
    lo_min = np.where(pole != 0, lon_lo, lon_all.min(axis=1))
    lo_max = np.where(pole != 0, lon_hi, lon_all.max(axis=1))
    # pole cells legitimately span the whole circle — keep them one
    # full-range record; the two-range split is only for dateline
    # STRADDLERS whose naive [min, max] hull would cover ~every lon bin
    crossing = ((lo_max - lo_min) > np.pi) & (pole == 0)

    ids = np.arange(n, dtype=np.int64)
    reg = ~crossing
    # range records: (cell, la0, la1, lb0, lb1); dateline-crossing cells
    # (lon span > pi) contribute two wrapped lon ranges
    recs = [np.stack([ids[reg], la0[reg], la1[reg],
                      lon_bin(lo_min[reg]), lon_bin(lo_max[reg])], axis=1)]
    if crossing.any():
        c = crossing
        nc = int(c.sum())
        pos_min = np.where(lon_all[c] > 0, lon_all[c], np.inf).min(axis=1)
        neg_max = np.where(lon_all[c] < 0, lon_all[c], -np.inf).max(axis=1)
        recs.append(np.stack([ids[c], la0[c], la1[c], lon_bin(pos_min),
                              np.full(nc, n_lon - 1, np.int64)], axis=1))
        recs.append(np.stack([ids[c], la0[c], la1[c],
                              np.zeros(nc, np.int64), lon_bin(neg_max)], axis=1))
    rec = np.concatenate(recs, axis=0)
    if len(rec):
        rec = rec[np.argsort(rec[:, 0], kind="stable")]
    return rec


def _bbox_entries(ds: ICDataset, n_lat: int, n_lon: int,
                  lat_lo, lat_hi, lon_lo, lon_hi) -> np.ndarray:
    """(M, 2) i64 (bin_id, cell_id) pairs sorted by (bin, cell id) — the
    shared core of the dense and CSR builders.

    Fully vectorized (repeat-based rectangle expansion + one packed-key
    sort): a per-offset masking loop would be O(max_span * N) and
    polar cells span THOUSANDS of lon bins at R2B9."""
    n = ds.num_cells
    rec = _range_records(ds, n_lat, n_lon, lat_lo, lat_hi, lon_lo, lon_hi)
    if not len(rec):
        return np.zeros((0, 2), np.int64)

    wla = rec[:, 2] - rec[:, 1] + 1
    wlo = rec[:, 4] - rec[:, 3] + 1
    cnt = wla * wlo
    m = int(cnt.sum())
    starts = np.zeros(len(rec), np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    r = np.repeat(np.arange(len(rec), dtype=np.int64), cnt)
    o = np.arange(m, dtype=np.int64) - starts[r]
    wlo_r = wlo[r]
    dla = o // wlo_r
    dlo = o - dla * wlo_r
    b = (rec[r, 1] + dla) * n_lon + (rec[r, 3] + dlo)
    cell = rec[r, 0]
    # one packed-key sort gives (bin, cell) lexicographic order
    key = b * np.int64(n + 1) + cell
    key.sort(kind="stable")
    b = key // np.int64(n + 1)
    cell = key - b * np.int64(n + 1)
    return np.stack([b, cell], axis=1)


def build_locator_csr(ds: ICDataset, dims: tuple[int, int] | None = None,
                      pad: float = 1e-4) -> tuple[LocatorCSR, int]:
    """CSR locator; returns (locator, k_cap) where k_cap is the true max
    bin occupancy (static — one compile per scene).  Default resolution is
    sqrt(N/2) per axis (mean occupancy ~4-8): at R2B9 the dense table would
    cost n_bins * K_max words, CSR costs n_bins + M."""
    n = ds.num_cells
    if dims is None:
        side = max(1, int(np.sqrt(max(n, 1) / 2)))
        dims = (side, side)
    n_lat, n_lon = dims
    lat_lo = float(ds.lat.min()) - pad if n else -np.pi / 2
    lat_hi = float(ds.lat.max()) + pad if n else np.pi / 2
    lon_lo = float(ds.lon.min()) - pad if n else -np.pi
    lon_hi = float(ds.lon.max()) + pad if n else np.pi

    all_e = _bbox_entries(ds, n_lat, n_lon, lat_lo, lat_hi, lon_lo, lon_hi)
    n_bins = n_lat * n_lon
    counts = np.bincount(all_e[:, 0], minlength=n_bins).astype(np.int64)
    starts = np.zeros(n_bins, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    k_cap = int(counts.max()) if len(all_e) else 1
    loc = LocatorCSR(
        starts=jnp.asarray(starts.astype(np.int32)),
        counts=jnp.asarray(counts.astype(np.int32)),
        items=jnp.asarray(all_e[:, 1].astype(np.int32)) if len(all_e)
        else jnp.zeros((1,), jnp.int32),
        lat_lo=jnp.float32(lat_lo), lat_hi=jnp.float32(lat_hi),
        lon_lo=jnp.float32(lon_lo), lon_hi=jnp.float32(lon_hi),
        dims=jnp.asarray([n_lat, n_lon], jnp.int32),
    )
    return loc, k_cap


def densify_csr(loc: LocatorCSR, k_cap: int) -> Locator:
    """CSR -> dense (n_bins, k_cap) Locator.

    The CSR candidate fetch is a 1-D gather of L*k_cap single elements
    from `items`; a dense table turns it into L contiguous ROW gathers
    (on the earlier accelerator 1-D gathers lowered to scalar loads and
    made up about half the quantized tier's frame time; not yet measured
    on the H100, ROADMAP D2).  Memory cost is n_bins * k_cap words
    (2.7 GB at R2B9 with the CSR's default dims and the scale-invariant
    k_cap = 16)."""
    starts = np.asarray(loc.starts).astype(np.int64)
    counts = np.asarray(loc.counts).astype(np.int64)
    items = np.asarray(loc.items)
    n_bins = starts.shape[0]
    bins = np.full((n_bins, k_cap), -1, np.int32)
    m = items.shape[0]
    if m and counts.sum() > 0:
        pos = np.repeat(starts, counts)
        binid = np.repeat(np.arange(n_bins, dtype=np.int64), counts)
        slot = np.arange(pos.shape[0], dtype=np.int64) - pos
        ok = slot < k_cap
        bins[binid[ok], slot[ok]] = items[:pos.shape[0]][ok]
    import jax

    from ..utils.layout import pack_table
    # align=False: an aligned slot would pad k_cap 18 -> 32 (+78% of a
    # ~3 GB table at R2B9); the bins row gather is one per locate, not
    # the 4-per-locate candidate-test path the alignment rule targets
    return Locator(bins=jax.device_put(pack_table(bins, pad_value=-1,
                                                  align=False)),
                   lat_lo=loc.lat_lo, lat_hi=loc.lat_hi,
                   lon_lo=loc.lon_lo, lon_hi=loc.lon_hi, dims=loc.dims)


def build_locator(ds: ICDataset, dims: tuple[int, int] | None = None,
                  pad: float = 1e-4, use_native: bool = True) -> Locator:
    """Bin cells by their (lat, lon) corner bounding boxes.

    dims defaults to roughly sqrt(2 N) per axis so mean occupancy stays a
    few cells per bin independent of the R2B level.  Bin rectangles are
    always computed by _range_records (one source of truth, incl. the
    edge-bulge extrema); with use_native the two-pass rectangle scatter
    runs in the C++ host module (native/icon_host.cpp) — identical
    output, load-time speed at R2B9 scale.
    """
    n = ds.num_cells
    if dims is None:
        side = max(1, int(np.sqrt(max(n, 1) * 2)))
        dims = (side, side)
    n_lat, n_lon = dims

    lat_lo = float(ds.lat.min()) - pad if n else -np.pi / 2
    lat_hi = float(ds.lat.max()) + pad if n else np.pi / 2
    lon_lo = float(ds.lon.min()) - pad if n else -np.pi
    lon_hi = float(ds.lon.max()) + pad if n else np.pi

    if use_native and n:
        from ..utils.native import native_locator_bins
        rec = _range_records(ds, n_lat, n_lon, lat_lo, lat_hi,
                             lon_lo, lon_hi)
        res = native_locator_bins(rec, n_lat, n_lon)
        if res is not None:
            bins, _ = res
            return Locator(
                bins=jnp.asarray(bins),
                lat_lo=jnp.float32(lat_lo), lat_hi=jnp.float32(lat_hi),
                lon_lo=jnp.float32(lon_lo), lon_hi=jnp.float32(lon_hi),
                dims=jnp.asarray([n_lat, n_lon], jnp.int32),
            )

    all_e = _bbox_entries(ds, n_lat, n_lon, lat_lo, lat_hi, lon_lo, lon_hi)
    if len(all_e):
        bin_ids, counts = np.unique(all_e[:, 0], return_counts=True)
        k = int(counts.max())
        bins = np.full((n_lat * n_lon, k), -1, np.int32)
        # position of each entry within its bin
        starts = np.zeros(len(all_e), np.int64)
        first = np.r_[True, all_e[1:, 0] != all_e[:-1, 0]]
        idx_in_bin = np.arange(len(all_e)) - np.maximum.accumulate(
            np.where(first, np.arange(len(all_e)), 0))
        bins[all_e[:, 0], idx_in_bin] = all_e[:, 1]
    else:
        bins = np.full((n_lat * n_lon, 1), -1, np.int32)

    return Locator(
        bins=jnp.asarray(bins),
        lat_lo=jnp.float32(lat_lo), lat_hi=jnp.float32(lat_hi),
        lon_lo=jnp.float32(lon_lo), lon_hi=jnp.float32(lon_hi),
        dims=jnp.asarray([n_lat, n_lon], jnp.int32),
    )


def sample_locator(cells: Cells, loc: Locator, pos):
    """Point query through the locator: (hit, value), one position.

    Matches sample_brute_force exactly (lowest-id containing cell) at
    O(K) instead of O(N) per query (ref fallback: deviceCode.cu:116-123).
    """
    r = jnp.sqrt(jnp.sum(pos * pos))
    lat = jnp.arcsin(pos[2] / r)
    lon = jnp.arctan2(pos[1], pos[0])
    n_lat = loc.dims[0]
    n_lon = loc.dims[1]
    bl = jnp.clip(((lat - loc.lat_lo) / (loc.lat_hi - loc.lat_lo)
                   * n_lat.astype(jnp.float32)).astype(jnp.int32), 0, n_lat - 1)
    bo = jnp.clip(((lon - loc.lon_lo) / (loc.lon_hi - loc.lon_lo)
                   * n_lon.astype(jnp.float32)).astype(jnp.int32), 0, n_lon - 1)
    cand = loc.bins[bl * n_lon + bo]                      # (K,)
    valid = cand >= 0
    safe = jnp.maximum(cand, 0)
    inside_r = (r >= cells.h_bot[safe]) & (r <= cells.h_top[safe])
    planes = cells.planes[safe]                           # (K, 3, 4)
    ev = jnp.sum(planes[..., :3] * pos, axis=-1) - planes[..., 3]
    inside = valid & inside_r & jnp.all(ev <= 0.0, axis=-1)
    hit = jnp.any(inside)
    slot = jnp.argmax(inside)        # lowest-id candidate (bins sorted by id)
    idx = safe[slot]
    layer = find_layer(cells.height[idx], cells.num_layers[idx], r)
    value = jnp.where(hit, cells.value[idx, layer], 0.0)
    return hit, value
