"""Fine primary-candidate map: the two-stage locate's first stage.

At R2B9 the per-pending-lane locate is mostly candidate test-row
gathers: the coarse lat/lon locator averages 8+ candidates per bin
(k_cap = 16 rows fetched).  This module trades those 16 row gathers for
ONE map row + 4 test rows:

  * a lat/lon grid `factor`x finer per axis than the locator stores, per
    fine bin, FOUR candidate columns: the first 4 distinct of
    {containers of the bin's 4 sub-quadrant centers} ∪ {their nearest
    differing neighbors}.  Cells are TRIANGLES, so a fine bin near a
    mesh vertex overlaps 3+ cells — a 2-candidate (center, neighbor)
    map hit only 58-68% of queries in prototypes, the 4-distinct-of-8
    pool 95%;
  * the render-side primary locate (ops/fastq._locate_q_fine) gathers
    the 4-candidate row + 4 test rows instead of bins row + 16 test
    rows;
  * query points in none of the 4 KEEP their pending flag and are
    resolved by the full coarse-locator query on a compacted second
    stage (ops/fast._make_refresh with primary_locate) — the two-stage
    locate is therefore EXACT: stage 1 only ever short-cuts to the same
    containing column the full query returns (up to f32 boundary ties).

Build runs on the device in latitude SLABS (bounded gather intermediates
AND bounded image temporaries — the full sub-center image alone is
2.7 GB at R2B9, next to a 10.7 GB scene): per slab,
sub-center containment (side planes pass through the origin — column
edges are radial — so containment of a UNIT-SPHERE point is exact for
every radius), a neighbor pass with a one-row halo, 2x2 aggregation,
and a vectorized first-4-distinct select, written into a single
preallocated packed buffer.

Reference analog: cuBQL BVH point queries (ref: icon_rt/hostCode.cu
cell-locator usage); the reference pays per-query tree traversal where
this design pays one precomputed row.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

__all__ = ["FineMap", "build_finemap", "normals_table", "K_CAND",
           "slots_to_cells", "unpack_candidates"]

#: candidates per fine bin (packed row width; 128 // 4 = 32 bins/row)
K_CAND = 4


class FineMap(NamedTuple):
    """Candidates are stored as u8 SLOT INDICES into the owning coarse
    bin's locator candidate row (255 = empty), not absolute cell ids:
    4 bytes per fine bin instead of 16 (2.68 GB -> 0.67 GB at R2B9's
    default fine grid).  Lossless: any candidate that can contain a
    point of the fine bin overlaps the fine bin, hence its lat/lon rect
    overlaps the enclosing coarse bin, hence conservative binning listed
    it in that coarse row; only never-matching neighbor imports fall off.
    Decode = one locator-row gather + a 4xK one-hot select
    (slots_to_cells), shared by both render tiers."""
    pairs: object          # packed (ceil(F/32), 128) u8, 4 slots per bin
    lat_lo: object         # () f32 — same angular window as the Locator
    lat_hi: object
    lon_lo: object
    lon_hi: object
    dims: object           # (2,) i32 (F_lat, F_lon)


def normals_table(planes):
    """f32-tier build input: (N, 3, 4)-or-(N, 12) side planes -> packed
    12-wide normals-only table for build_finemap (cols 0..8 read; same
    layout as QuantizedCells.test12).  Offsets are dropped: candidate
    selection tests UNIT-SPHERE points against radial planes, and a
    non-zero offset could only lower the primary hit rate, never
    correctness (the render-side containment test is the full plane
    equation; misses fall to the full locate)."""
    import jax.numpy as jnp

    from ..utils.layout import pack_table

    p = np.asarray(planes, np.float32)
    p = p.reshape(p.shape[0], 3, 4)
    out = np.zeros((p.shape[0], 12), np.float32)
    out[:, :9] = p[:, :, :3].reshape(-1, 9)
    return jnp.asarray(pack_table(out))


def _centers_c0(loc, test12, k_cap: int, s_lat: int, s_lon: int,
                bids, factor_sub: int):
    """Containing cell of each sub-bin center in `bids` on the
    (s_lat, s_lon) sub-grid (lateral test against the coarse bin's
    candidates; -1 where no candidate passes, which only happens on f32
    ties along cell edges)."""
    import jax.numpy as jnp

    from ..utils.layout import packed_gather

    F32 = jnp.float32
    fl = bids // s_lon
    fo = bids % s_lon
    lat = loc.lat_lo + (fl.astype(F32) + 0.5) \
        * ((loc.lat_hi - loc.lat_lo) / F32(s_lat))
    lon = loc.lon_lo + (fo.astype(F32) + 0.5) \
        * ((loc.lon_hi - loc.lon_lo) / F32(s_lon))
    cl = jnp.cos(lat)
    px = cl * jnp.cos(lon)
    py = cl * jnp.sin(lon)
    pz = jnp.sin(lat)
    # the sub grid is an exact factor_sub refinement: integer-divide back
    n_lon = loc.dims[1]
    bid = (fl // factor_sub) * n_lon + (fo // factor_sub)
    cand = packed_gather(loc.bins, bid, k_cap)       # (M, K)
    valid = cand >= 0
    safe = jnp.maximum(cand, 0)
    trows = packed_gather(test12, safe, 12)          # (M, K, 12)
    ev1 = (trows[..., 0] * px[:, None] + trows[..., 1] * py[:, None]
           + trows[..., 2] * pz[:, None])
    ev2 = (trows[..., 3] * px[:, None] + trows[..., 4] * py[:, None]
           + trows[..., 5] * pz[:, None])
    ev3 = (trows[..., 6] * px[:, None] + trows[..., 7] * py[:, None]
           + trows[..., 8] * pz[:, None])
    inside = valid & (ev1 <= 0.0) & (ev2 <= 0.0) & (ev3 <= 0.0)
    hit = jnp.any(inside, axis=1)
    slot = jnp.argmax(inside, axis=1)
    k_oh = (jnp.arange(cand.shape[1])[None, :] == slot[:, None])
    cid = jnp.sum(jnp.where(k_oh, safe, 0), axis=1)
    return jnp.where(hit, cid, -1)


def _second_candidates(c0_img):
    """c1 per sub-bin: the first neighboring bin (E, W, S, N, then
    diagonals) whose c0 differs — map-space arithmetic only.  Longitude
    wraps (the grid spans the full circle); latitude clamps at the edge
    rows (the pole rows of the full image; interior slab edges are
    covered by the caller's one-row halo)."""
    import jax.numpy as jnp

    def shift_lat(img, d):
        if d == 0:
            return img
        if d > 0:
            return jnp.concatenate([img[d:], img[-1:].repeat(d, 0)], 0)
        return jnp.concatenate([img[:1].repeat(-d, 0), img[:d]], 0)

    c1 = jnp.full_like(c0_img, -1)
    for dl, do in ((0, 1), (0, -1), (1, 0), (-1, 0),
                   (1, 1), (1, -1), (-1, 1), (-1, -1)):
        nb = shift_lat(jnp.roll(c0_img, -do, axis=1) if do else c0_img, dl)
        take = (c1 < 0) & (nb != c0_img) & (nb >= 0)
        c1 = jnp.where(take, nb, c1)
    return c1


def _first_distinct4(pool):
    """(..., 8) candidate pool -> (..., 4): the first 4 distinct non-
    negative entries, -1 padding.  Static 8x4 compare network."""
    import jax.numpy as jnp

    out = [jnp.full(pool.shape[:-1], -1, jnp.int32) for _ in range(K_CAND)]
    cnt = jnp.zeros(pool.shape[:-1], jnp.int32)
    for j in range(pool.shape[-1]):
        v = pool[..., j]
        dup = jnp.zeros(pool.shape[:-1], bool)
        for k in range(K_CAND):
            dup = dup | (out[k] == v)
        take = (~dup) & (v >= 0) & (cnt < K_CAND)
        for k in range(K_CAND):
            out[k] = jnp.where(take & (cnt == k), v, out[k])
        cnt = cnt + take.astype(jnp.int32)
    return jnp.stack(out, axis=-1)


def build_finemap(loc, test12, k_cap: int, factor: int = 2,
                  max_call_lanes: int = 1 << 21,
                  gather_budget: int = 96 << 20) -> FineMap:
    """Build the fine map on the device.

    loc: models/locator.Locator (PACK-8 bins).  test12: the quantized
    tier's packed (N, 16) side-plane table (QuantizedCells.test12; only
    columns 0..8 are read).  Work proceeds in latitude slabs of whole
    fine-map rows (~max_call_lanes sub-centers per dispatch, bounding the
    image temporaries — the full R2B9 sub-center image is 2.7 GB, which
    must never exist whole next to the ~10.7 GB scene); WITHIN a slab the
    containment pass runs as a lax.map over chunks sized so the candidate
    test-row gather intermediate stays under gather_budget bytes.  That
    gather is M x k_cap PHYSICAL 128-lane rows (packed_gather fetches the
    whole 128-wide row before the subrow select) = M*k_cap*512 bytes — an
    unchunked R2B9 slab would fuse a 19 GB intermediate; the default
    budget keeps the build's live set within ~200 MB of scene + output."""
    import jax
    import jax.numpy as jnp

    from ..utils.layout import packed_gather

    f_lat = int(loc.dims[0]) * factor
    f_lon = int(loc.dims[1]) * factor
    s_lat, s_lon = 2 * f_lat, 2 * f_lon
    factor_sub = 2 * factor
    n_fine = f_lat * f_lon
    n_pad = -(-n_fine // 32) * 32

    # slab size: R map rows = 2R sub rows (+2 halo) within the budget
    R = min(max(1, (max_call_lanes // s_lon - 2) // 2), f_lat)
    # chunk: sub-centers per lax.map step (k_cap 128-lane test rows each)
    chunk = max(1024, min((2 * R + 2) * s_lon,
                          (gather_budget // (k_cap * 512)) & ~1023))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def slab(buf, r0, loc_, t12):
        """One slab: sub rows [2 r0 - 1, 2 (r0 + R) + 1) with edge clamp,
        c1 within the slab (interior rows exact thanks to the halo),
        2x2 aggregate -> 8 pool -> first-4-distinct, flat-write into buf
        at bin offset r0 * f_lon * 4."""
        lo = 2 * r0 - 1
        rows = 2 * R + 2
        lanes = rows * s_lon
        rr = lo + jnp.arange(lanes) // s_lon
        rr = jnp.clip(rr, 0, s_lat - 1)              # lat edge clamp
        cc = jnp.arange(lanes) % s_lon
        bids = rr * s_lon + cc
        n_ch = -(-lanes // chunk)
        pad = n_ch * chunk - lanes
        if pad:
            bids = jnp.concatenate([bids, jnp.zeros((pad,), bids.dtype)])
        c0 = jax.lax.map(
            lambda b: _centers_c0(loc_, t12, k_cap, s_lat, s_lon,
                                  b, factor_sub),
            bids.reshape(n_ch, chunk))
        c0 = c0.reshape(-1)[:lanes].reshape(rows, s_lon)
        c1 = _second_candidates(c0)
        # interior: sub rows 1 .. 1+2R of the slab == global 2r0 .. 2r0+2R
        c0 = c0[1:1 + 2 * R]
        c1 = c1[1:1 + 2 * R]

        def agg(img):
            return img.reshape(R, 2, f_lon, 2).transpose(0, 2, 1, 3) \
                      .reshape(R, f_lon, 4)

        pool = jnp.concatenate([agg(c0), agg(c1)], axis=-1)   # (R,F,8)
        sel = _first_distinct4(pool)                          # (R, F, 4)
        # cell ids -> u8 slot indices into the owning coarse bin's
        # candidate row (the storage layout — see FineMap).  A selected
        # id absent from the row (a neighbor import from across a coarse
        # border whose cell does not overlap this bin) can never contain
        # a point of this fine bin, so dropping it to 255 is lossless.
        g = r0 + jnp.arange(R, dtype=jnp.int32)               # fine rows
        bid = (g // factor)[:, None] * loc_.dims[1] \
            + (jnp.arange(f_lon, dtype=jnp.int32) // factor)[None, :]
        rows = packed_gather(loc_.bins, bid, k_cap)           # (R, F, K)
        eq = rows[:, :, None, :] == sel[:, :, :, None]        # (R,F,4,K)
        found = jnp.any(eq, axis=-1) & (sel >= 0)
        slot = jnp.argmax(eq, axis=-1).astype(jnp.uint8)
        sel8 = jnp.where(found, slot, jnp.uint8(255)).reshape(-1)
        return jax.lax.dynamic_update_slice(buf, sel8,
                                            (r0 * f_lon * K_CAND,))

    if k_cap >= 255:
        raise ValueError(f"k_cap {k_cap} overflows u8 slot encoding")
    buf = jnp.full((n_pad * K_CAND,), 255, jnp.uint8)
    for r0 in range(0, f_lat, R):
        if r0 + R > f_lat:
            r0 = f_lat - R      # final slab overlaps; writes are idempotent
        buf = slab(buf, jnp.int32(r0), loc, test12)
        buf.block_until_ready()  # keep ONE (M, K, 16) gather live at a time
    pairs = buf.reshape(-1, 128)                     # pack_table layout
    return FineMap(pairs=pairs,
                   lat_lo=loc.lat_lo, lat_hi=loc.lat_hi,
                   lon_lo=loc.lon_lo, lon_hi=loc.lon_hi,
                   dims=jnp.asarray([f_lat, f_lon], jnp.int32))


def slots_to_cells(fm: FineMap, loc, k_cap: int, fbid, slots):
    """Decode (M, K_CAND) u8 slots of fine bins `fbid` into absolute cell
    ids (-1 empty): one coarse locator-row gather + a one-hot select.
    The coarse bin is the integer-divide parent of the fine bin — the
    exact mapping the build used, so no f32 re-derivation can disagree
    near bin edges."""
    import jax.numpy as jnp

    from ..utils.layout import packed_gather

    f_lon = fm.dims[1]
    factor = fm.dims[0] // loc.dims[0]
    bid = (fbid // f_lon // factor) * loc.dims[1] + (fbid % f_lon) // factor
    rows = packed_gather(loc.bins, bid, k_cap)             # (M, K)
    s32 = slots.astype(jnp.int32)
    oh = s32[..., None] == jnp.arange(k_cap, dtype=jnp.int32)
    cid = jnp.sum(jnp.where(oh, rows[:, None, :], 0), axis=-1)
    return jnp.where(s32 == 255, -1, cid)


def unpack_candidates(fm: FineMap, loc, k_cap: int) -> np.ndarray:
    """Host-side decode of the whole map to (n_fine, K_CAND) i32 cell ids
    (-1 empty) — test/debug utility (small scenes; materializes the
    decoded map)."""
    from ..utils.layout import unpack_table

    f_lat, f_lon = (int(v) for v in np.asarray(fm.dims))
    n_fine = f_lat * f_lon
    slots = unpack_table(np.asarray(fm.pairs), K_CAND,
                         n_fine).astype(np.int32)
    n_lat, n_lon = (int(v) for v in np.asarray(loc.dims))
    factor = f_lat // n_lat
    bins = unpack_table(np.asarray(loc.bins), k_cap)[:n_lat * n_lon]
    fl = np.arange(n_fine) // f_lon
    fo = np.arange(n_fine) % f_lon
    rows = bins[(fl // factor) * n_lon + fo // factor]     # (n_fine, K)
    out = np.take_along_axis(rows, np.minimum(slots, k_cap - 1), axis=1)
    return np.where(slots == 255, -1, out).astype(np.int32)
