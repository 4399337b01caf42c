"""Fine primary-candidate map (models/finemap.py): the two-stage locate.

The fine map is a pure shortcut: stage 1 serves a pending lane only when
the query point provably lies in one of the bin's 4 mapped candidates,
so the rendered output must be BIT-IDENTICAL to the single-stage full
locate (the authoritative second stage serves the misses).  Tests assert
(a) every fine bin's slots cover the containers of its 4 sub-quadrant
centers, (b) slots are distinct, (c) the primary hit rate on random
sphere points clears the level the design was chosen for, and (d)
quantized-tier renders with and without the map agree bit-for-bit.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from icon_dvr.data import synthetic
from icon_dvr.models.cells import compute_stats
from icon_dvr.models.finemap import K_CAND, build_finemap, \
    unpack_candidates
from icon_dvr.models.locator import build_locator_csr, densify_csr
from icon_dvr.models.qcells import bake_alpha_q, quantize_cells, \
    quantize_dataset_values
from icon_dvr.models.shells import build_radial_bands, \
    update_band_majorants
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.fastq import render_frame_fast_q
from icon_dvr.ops.render import alloc_frame, make_launch_params
from icon_dvr.utils.layout import unpack_table


@pytest.fixture(scope="module")
def scene():
    ds = synthetic.icosphere(subdivisions=2, num_layers=5)
    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    q = bake_alpha_q(quantize_cells(ds_q), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    bands = update_band_majorants(build_radial_bands(ds_q, 16),
                                  tf.values, tf.value_range)
    fm = build_finemap(loc, q.test12, k_cap, factor=2)
    return ds_q, stats, tf, q, loc, k_cap, bands, fm


def _lateral_inside(t12_planes, p):
    """(N, 3, 3) plane normals x (3,) unit point -> (N,) containment."""
    ev = np.einsum('nwk,k->nw', t12_planes, p)
    return (ev <= 0.0).all(axis=1)


def test_slots_cover_subcenters(scene):
    """The container of each of a fine bin's 4 sub-quadrant centers must
    appear among the bin's slots (the map may only ever shortcut to the
    true containing column, and these are the columns it promises)."""
    ds_q, stats, tf, q, loc, k_cap, bands, fm = scene
    f_lat, f_lon = (int(v) for v in np.asarray(fm.dims))
    n = ds_q.num_cells
    slots = unpack_candidates(fm, loc, k_cap)
    t12 = unpack_table(q.test12, 12, n)[:, :9].astype(np.float64)
    planes = t12.reshape(n, 3, 3)

    lat_lo, lat_hi = float(loc.lat_lo), float(loc.lat_hi)
    lon_lo, lon_hi = float(loc.lon_lo), float(loc.lon_hi)
    s_lat, s_lon = 2 * f_lat, 2 * f_lon
    rng = np.random.default_rng(7)
    bids = rng.choice(f_lat * f_lon, size=256, replace=False)
    for b in bids:
        fl, fo = divmod(int(b), f_lon)
        row = set(int(c) for c in slots[b] if c >= 0)
        for dl in (0, 1):
            for do in (0, 1):
                sl, so = 2 * fl + dl, 2 * fo + do
                lat = lat_lo + (sl + 0.5) * (lat_hi - lat_lo) / s_lat
                lon = lon_lo + (so + 0.5) * (lon_hi - lon_lo) / s_lon
                p = np.array([np.cos(lat) * np.cos(lon),
                              np.cos(lat) * np.sin(lon), np.sin(lat)])
                winners = np.nonzero(_lateral_inside(planes, p))[0]
                if winners.size:
                    assert row & set(winners.tolist()), (b, winners, row)


def test_slots_distinct(scene):
    ds_q, stats, tf, q, loc, k_cap, bands, fm = scene
    f_lat, f_lon = (int(v) for v in np.asarray(fm.dims))
    slots = unpack_candidates(fm, loc, k_cap)
    filled = slots >= 0
    assert filled[:, 0].mean() > 0.99        # sub-center 0 nearly always found
    for a in range(K_CAND):
        for b in range(a + 1, K_CAND):
            both = filled[:, a] & filled[:, b]
            assert (slots[both, a] != slots[both, b]).all()


def test_primary_hit_rate(scene):
    """Random unit-sphere points: the 4-candidate map must resolve the
    large majority laterally (the design was chosen at ~0.95 measured;
    regression floor 0.85)."""
    ds_q, stats, tf, q, loc, k_cap, bands, fm = scene
    f_lat, f_lon = (int(v) for v in np.asarray(fm.dims))
    n = ds_q.num_cells
    slots = unpack_candidates(fm, loc, k_cap)
    t12 = unpack_table(q.test12, 12, n)[:, :9].astype(np.float64)
    planes = t12.reshape(n, 3, 3)
    lat_lo, lat_hi = float(loc.lat_lo), float(loc.lat_hi)
    lon_lo, lon_hi = float(loc.lon_lo), float(loc.lon_hi)

    rng = np.random.default_rng(3)
    M = 4000
    lat = np.arcsin(rng.uniform(-1, 1, M))
    lon = rng.uniform(-np.pi, np.pi, M)
    pts = np.stack([np.cos(lat) * np.cos(lon),
                    np.cos(lat) * np.sin(lon), np.sin(lat)], axis=1)
    fl = np.clip(((lat - lat_lo) / (lat_hi - lat_lo) * f_lat).astype(int),
                 0, f_lat - 1)
    fo = np.clip(((lon - lon_lo) / (lon_hi - lon_lo) * f_lon).astype(int),
                 0, f_lon - 1)
    hits = 0
    for i in range(M):
        cand = slots[fl[i] * f_lon + fo[i]]
        cand = cand[cand >= 0]
        hits += bool(cand.size) and bool(
            _lateral_inside(planes[cand], pts[i]).any())
    assert hits / M >= 0.85, hits / M


def test_finemap_render_bit_identical(scene):
    """Quantized-tier render with the fine-map primary == without, bit
    for bit (same refresh cadence; stage-1 hits fill the same column)."""
    ds_q, stats, tf, q, loc, k_cap, bands, fm = scene
    W = H = 24
    cam = Camera()
    cam.set_aspect(W / H)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    for samples in (1, 3):
        a1, f1 = render_frame_fast_q(q, loc, k_cap, bands, tf, lp,
                                     *alloc_frame(W, H), width=W, height=H,
                                     samples=samples, chunk=128)
        a2, f2 = render_frame_fast_q(q, loc, k_cap, bands, tf, lp,
                                     *alloc_frame(W, H), width=W, height=H,
                                     samples=samples, chunk=128,
                                     finemap=fm)
        np.testing.assert_array_equal(np.asarray(f2), np.asarray(f1))
        np.testing.assert_array_equal(np.asarray(a2), np.asarray(a1))
        assert (np.asarray(f1) != 0).any()
    # and composed with an explicit compact capacity
    ac, fc = render_frame_fast_q(q, loc, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), width=W, height=H,
                                 samples=3, chunk=128, finemap=fm,
                                 refresh_compact=32)
    np.testing.assert_array_equal(np.asarray(fc), np.asarray(f1))


def test_two_stage_tail_overflow(scene):
    """_two_stage_locate with a tail smaller than the miss count: exactly
    tail_cap lanes are served (with the full locate's results), the rest
    stay unserved so _compact_service keeps them pending for the next
    phase — the overflow mode the fixed-tier refresh relies on."""
    import jax.numpy as jnp
    from icon_dvr.ops.fast import _two_stage_locate
    from icon_dvr.ops.fastq import _locate_q, _locate_q_fine

    ds_q, stats, tf, q, loc, k_cap, bands, fm = scene
    rng = np.random.default_rng(5)
    P, tail = 64, 8
    lat = np.arcsin(rng.uniform(-0.9, 0.9, P))
    lon = rng.uniform(-np.pi, np.pi, P)
    r = np.full(P, 0.5 * (float(stats.spherical_bounds_lo[0])
                          + float(stats.spherical_bounds_hi[0])), np.float32)
    px = jnp.asarray(r * np.cos(lat) * np.cos(lon), jnp.float32)
    py = jnp.asarray(r * np.cos(lat) * np.sin(lon), jnp.float32)
    pz = jnp.asarray(r * np.sin(lat), jnp.float32)
    r = jnp.asarray(r)
    ones = jnp.ones(P, bool)

    def prim_all_miss(px, py, pz, r, ok):
        t, p, c, h = _locate_q_fine(fm, loc, k_cap, q, px, py, pz, r, ok)
        return t, p, c, jnp.zeros_like(h)

    two = _two_stage_locate(
        prim_all_miss,
        lambda px, py, pz, r, ok: _locate_q(loc, q, k_cap, px, py, pz,
                                            r, ok), tail)
    t2, p2, c2, h2, served = two(px, py, pz, r, ones)
    served = np.asarray(served)
    assert served.sum() == tail          # tail capacity, no more, no less
    tf_, pf_, cf_, hf_ = _locate_q(loc, q, k_cap, px, py, pz, r, ones)
    np.testing.assert_array_equal(np.asarray(h2)[served],
                                  np.asarray(hf_)[served])
    srv_hit = served & np.asarray(h2)
    assert srv_hit.any()                 # mid-volume points do land in cells
    np.testing.assert_array_equal(np.asarray(c2)[srv_hit],
                                  np.asarray(cf_)[srv_hit])
    np.testing.assert_array_equal(np.asarray(t2)[srv_hit],
                                  np.asarray(tf_)[srv_hit])
    np.testing.assert_array_equal(np.asarray(p2)[srv_hit],
                                  np.asarray(pf_)[srv_hit])


def test_finemap_render_bit_identical_f32(scene):
    """The f32 tier's two-stage locate (normals_table + _locate_fine):
    same exactness contract as the quantized tier."""
    from icon_dvr.models.cells import build_cells
    from icon_dvr.models.finemap import normals_table
    from icon_dvr.models.locator import build_locator
    from icon_dvr.ops.fast import pack_cells, render_frame_fast

    ds_q, stats, tf, q, loc_q, k_cap, bands, _ = scene
    cells = build_cells(ds_q)
    loc = build_locator(ds_q)
    packed = pack_cells(cells, tf)
    fm = build_finemap(loc, normals_table(cells.planes),
                       int(loc.bins.shape[1]), factor=2)
    W = H = 24
    cam = Camera()
    cam.set_aspect(W / H)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    for samples in (1, 3):
        a1, f1 = render_frame_fast(cells, packed, loc, bands, lp,
                                   *alloc_frame(W, H), width=W, height=H,
                                   samples=samples, chunk=128)
        a2, f2 = render_frame_fast(cells, packed, loc, bands, lp,
                                   *alloc_frame(W, H), width=W, height=H,
                                   samples=samples, chunk=128, finemap=fm)
        np.testing.assert_array_equal(np.asarray(f2), np.asarray(f1))
        np.testing.assert_array_equal(np.asarray(a2), np.asarray(a1))
        assert (np.asarray(f1) != 0).any()


def test_finemap_cache_roundtrip(scene, tmp_path, monkeypatch):
    """build_finemap_cached: the npz round trip restores the map
    bit-exactly (pairs, window, dims), and a cache hit never calls the
    builder (the device build is ~10-17 min at R2B9 per bench-row
    subprocess; the cache exists to pay it once)."""
    from icon_dvr.data import bigscene

    ds_q, stats, tf, q, loc, k_cap, bands, fm = scene
    monkeypatch.setattr(bigscene, "_CACHE_DIR", str(tmp_path))
    fm1 = bigscene.build_finemap_cached(loc, q.test12, k_cap, factor=2,
                                        cache_key="t_l5")
    np.testing.assert_array_equal(np.asarray(fm1.pairs),
                                  np.asarray(fm.pairs))

    def boom(*a, **k):
        raise AssertionError("cache miss: builder called on second load")

    monkeypatch.setattr(bigscene, "build_finemap", boom, raising=False)
    import icon_dvr.models.finemap as fmod
    monkeypatch.setattr(fmod, "build_finemap", boom)
    fm2 = bigscene.build_finemap_cached(loc, q.test12, k_cap, factor=2,
                                        cache_key="t_l5")
    np.testing.assert_array_equal(np.asarray(fm2.pairs),
                                  np.asarray(fm.pairs))
    for a in ("lat_lo", "lat_hi", "lon_lo", "lon_hi"):
        assert float(getattr(fm2, a)) == float(getattr(fm, a))
    np.testing.assert_array_equal(np.asarray(fm2.dims), np.asarray(fm.dims))
