"""Quantized fast raygen (the R2B9 tier): correctness vs the f32 fast path.

The quantized tier renders the value/height-quantized field; tests assert
(a) quantization round-trips within one level, (b) the alpha bake matches
the exact postClassify alpha from below (floor), (c) the CSR locator
returns the dense locator's candidate sets, and (d) converged images match
the f32 fast path within quantization-level tolerance.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from icon_dvr.data import synthetic
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.locator import (build_locator, build_locator_csr,
                                     densify_csr,
                                     sample_locator)
from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                    quantize_dataset_values)
from icon_dvr.models.shells import build_radial_bands, update_band_majorants
from icon_dvr.models.transfunc import make_transfunc, post_classify
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.fast import pack_cells, render_frame_fast
from icon_dvr.ops.fastq import render_frame_fast_q
from icon_dvr.ops.render import alloc_frame, make_launch_params


@pytest.fixture(scope="module")
def scene():
    ds = synthetic.icosphere(subdivisions=2, num_layers=5)
    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    q = bake_alpha_q(quantize_cells(ds_q), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc_csr = densify_csr(csr, k_cap)
    bands = update_band_majorants(build_radial_bands(ds_q, 16),
                                  tf.values, tf.value_range)
    return ds_q, stats, tf, q, loc_csr, k_cap, bands


def test_quantize_roundtrip():
    ds = synthetic.icosphere(subdivisions=1, num_layers=4)
    ds_q, lo, hi = quantize_dataset_values(ds)
    mask = np.arange(ds.value.shape[1])[None, :] < ds.num_layers[:, None]
    step = (hi - lo) / 255.0
    assert np.abs(ds_q.value - ds.value)[mask].max() <= 0.5 * step + 1e-6
    # idempotent up to fp rounding of the re-normalization
    ds_q2, lo2, hi2 = quantize_dataset_values(ds_q)
    assert lo2 == pytest.approx(lo) and hi2 == pytest.approx(hi)
    np.testing.assert_allclose(ds_q2.value, ds_q.value, atol=1e-6)


def test_height_quantization_error():
    ds = synthetic.icosphere(subdivisions=1, num_layers=4)
    q = quantize_cells(ds)
    n = ds.num_cells
    idx = np.arange(n)
    h_bot = ds.height[:, 0]
    h_top = ds.height[idx, ds.num_layers]
    span = h_top - h_bot
    hf = np.asarray(q.h_frac).astype(np.float64)
    deq = h_bot[:, None] + hf / 65535.0 * span[:, None]
    lm = q.lm
    k = np.arange(1, lm + 1)
    valid = k[None, :] <= ds.num_layers[:, None]
    err = np.abs(deq - ds.height[:, 1:lm + 1])[valid]
    assert err.max() <= span.max() / 65535.0 + 1e-3


def test_alpha_bake_floor_conservative(scene):
    ds_q, stats, tf, q, *_ = scene
    # exact classified alpha of each stored value must be >= the baked one
    lm = q.lm
    vq = np.asarray(q.value_q).astype(np.float32)
    v = float(q.value_lo) + vq / 255.0 * float(q.value_hi - q.value_lo)
    exact = np.asarray(post_classify(tf, jnp.asarray(v.reshape(-1))))[:, 3]
    baked = (np.asarray(q.alpha_q).astype(np.float32).reshape(-1)
             / 255.0 * float(q.alpha_max))
    assert (baked <= exact + 1e-6).all()
    assert np.abs(baked - exact).max() <= float(q.alpha_max) / 255.0 + 1e-6


def test_csr_locator_matches_dense(scene):
    ds_q, *_ = scene
    loc_csr, k_cap = build_locator_csr(ds_q)
    loc = build_locator(ds_q, dims=(int(loc_csr.dims[0]), int(loc_csr.dims[1])))
    starts = np.asarray(loc_csr.starts)
    counts = np.asarray(loc_csr.counts)
    items = np.asarray(loc_csr.items)
    bins = np.asarray(loc.bins)
    assert k_cap == bins.shape[1]
    for b in range(0, starts.shape[0], max(1, starts.shape[0] // 97)):
        dense = bins[b][bins[b] >= 0]
        csr = items[starts[b]:starts[b] + counts[b]]
        np.testing.assert_array_equal(np.sort(dense), np.sort(csr))


def test_quantized_render_matches_fast(scene):
    ds_q, stats, tf, q, loc_csr, k_cap, bands = scene
    W = H = 48
    cells = build_cells(ds_q)
    from icon_dvr.models.locator import build_locator as bl
    loc = bl(ds_q)
    packed = pack_cells(cells, tf)
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)

    n_samp = 24
    a1, f1 = alloc_frame(W, H)
    a2, f2 = alloc_frame(W, H)
    for s in range(n_samp):
        lps = lp._replace(accum_id=jnp.int32(s))
        a1, f1 = render_frame_fast(cells, packed, loc, bands, lps, a1, f1,
                                   width=W, height=H)
        a2, f2 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf, lps,
                                     a2, f2, width=W, height=H)
    a1 = np.asarray(a1)
    a2 = np.asarray(a2)
    # identical coverage footprint (geometry quantization is sub-meter)
    cov1 = a1[:, 3] > 0
    cov2 = a2[:, 3] > 0
    assert (cov1 == cov2).mean() > 0.99
    both = cov1 & cov2
    # converged radiance matches within MC noise + one quantization level
    diff = np.abs(a1[both] - a2[both]).mean()
    assert diff < 0.12, diff


def test_quantized_rng_stream_is_fast_path(scene):
    """Same seeds, same cadence: with an OPAQUE TF both tiers accept on the
    first in-volume sample, and the per-pixel binary alpha must agree."""
    ds_q, stats, tf, q, loc_csr, k_cap, bands = scene
    W = H = 32
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    cells = build_cells(ds_q)
    from icon_dvr.models.locator import build_locator as bl
    loc = bl(ds_q)
    packed = pack_cells(cells, tf)
    a1, f1 = render_frame_fast(cells, packed, loc, bands, lp,
                               *alloc_frame(W, H), width=W, height=H)
    a2, f2 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), width=W, height=H)
    assert (np.asarray(a1)[:, 3] == np.asarray(a2)[:, 3]).mean() > 0.995


def test_batched_samples_bit_identical_q(scene):
    """samples=S on the quantized tier equals S sequential calls: the
    packed framebuffer bit-for-bit, the accumulator to 1 ulp (XLA fuses
    the shade lerp differently across the two programs on this tier)."""
    ds_q, stats, tf, q, loc_csr, k_cap, bands = scene
    W = H = 32
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    a1, f1 = alloc_frame(W, H)
    for s in range(4):
        a1, f1 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf,
                                     lp._replace(accum_id=jnp.int32(s)),
                                     a1, f1, width=W, height=H, chunk=512)
    a2, f2 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf,
                                 lp._replace(accum_id=jnp.int32(0)),
                                 *alloc_frame(W, H), width=W, height=H,
                                 chunk=512, samples=4,
                                 preserve_cache=False)
    np.testing.assert_array_equal(np.asarray(f2), np.asarray(f1))
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1), rtol=0,
                               atol=2.5e-7)


def test_bake_alpha_q_unchanged_table_skips_rewrite(scene):
    """Round-3 TF-edit fast path: when an edit leaves the NORMALIZED
    256-entry table unchanged (color-only LUT edits, no-op strokes),
    bake_alpha_q skips the (N, Lm) rewrite entirely.

    (A pure opacity-scale edit does NOT qualify: the reference's
    asymmetric postClassify — opacityScale multiplies only the second
    lerp term, ref deviceCode.cu:134 — makes alpha affine, not linear,
    in the scale, so the normalized table genuinely changes.)"""
    ds_q, stats, tf, q, *_ = scene
    # color-only edit: swap R and B channels, alpha untouched
    lut = np.asarray(tf.values).copy()
    lut[:, [0, 2]] = lut[:, [2, 0]]
    q2 = bake_alpha_q(q, tf._replace(values=jnp.asarray(lut)))
    assert q2.alpha_q is q.alpha_q          # no rewrite, same buffer
    np.testing.assert_array_equal(q2.alpha_tab, q.alpha_tab)
    assert float(q2.alpha_max) == float(q.alpha_max)


def test_bake_alpha_q_incremental_patch(scene):
    """A NARROW alpha edit (<= 32 changed levels of the 256-entry
    normalized table) takes the incremental patch path and must equal
    the from-scratch bake bit-for-bit."""
    ds_q, stats, tf, q, *_ = scene
    base = bake_alpha_q(q._replace(alpha_tab=None), tf)
    # push a narrow value band: scale a couple of LUT entries' alpha
    lut = np.asarray(tf.values).copy()
    lut[3, 3] *= 0.5
    tf2 = tf._replace(values=jnp.asarray(lut))
    # confirm the edit is actually narrow at the 256-level granularity
    from icon_dvr.models.qcells import _classify_alpha_table
    t1 = np.asarray(_classify_alpha_table(tf, q.value_lo, q.value_hi))
    t2 = np.asarray(_classify_alpha_table(tf2, q.value_lo, q.value_hi))
    n1 = np.floor(t1 / max(t1.max(), 1e-8) * 255).astype(np.uint8)
    n2 = np.floor(t2 / max(t2.max(), 1e-8) * 255).astype(np.uint8)
    assert 0 < (n1 != n2).sum() <= 32, (n1 != n2).sum()

    patched = bake_alpha_q(base, tf2)
    fresh = bake_alpha_q(q._replace(alpha_tab=None), tf2)
    np.testing.assert_array_equal(np.asarray(patched.alpha_q),
                                  np.asarray(fresh.alpha_q))
    np.testing.assert_array_equal(patched.alpha_tab, fresh.alpha_tab)
    assert float(patched.alpha_max) == float(fresh.alpha_max)


def test_bake_alpha_q_curve_edit_rebakes(scene):
    """A non-uniform LUT alpha edit changes the normalized table and must
    rebake; the result matches a from-scratch bake."""
    ds_q, stats, tf, q, *_ = scene
    lut = np.asarray(tf.values).copy()
    lut[: lut.shape[0] // 2, 3] = 0.0       # kill the lower half
    tf2 = tf._replace(values=jnp.asarray(lut))
    q2 = bake_alpha_q(q, tf2)
    fresh = bake_alpha_q(q._replace(alpha_tab=None), tf2)
    np.testing.assert_array_equal(np.asarray(q2.alpha_q),
                                  np.asarray(fresh.alpha_q))
    assert not np.array_equal(np.asarray(q2.alpha_q), np.asarray(q.alpha_q))


def test_outer_unroll_bit_identical_q(scene):
    """Quantized-tier outer_unroll: same bit-exactness as the f32 path."""
    from icon_dvr.ops.camera import Camera
    W = H = 24
    ds_q, stats, tf, q, loc, k_cap, bands = scene
    cam = Camera()
    cam.set_aspect(W / H)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    a1, f1 = render_frame_fast_q(q, loc, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), width=W, height=H,
                                 samples=3, chunk=128)
    a4, f4 = render_frame_fast_q(q, loc, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), width=W, height=H,
                                 samples=3, chunk=128, outer_unroll=4)
    np.testing.assert_array_equal(np.asarray(f4), np.asarray(f1))
    np.testing.assert_array_equal(np.asarray(a4), np.asarray(a1))


def test_refresh_compact_bit_identical_q(scene):
    """Quantized-tier peer of test_fast.test_refresh_compact_bit_identical
    (shared _compact_service machinery, tier-specific _locate_q)."""
    W = H = 24
    ds_q, stats, tf, q, loc, k_cap, bands = scene
    cam = Camera()
    cam.set_aspect(W / H)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    for samples in (1, 3):
        a1, f1 = render_frame_fast_q(q, loc, k_cap, bands, tf, lp,
                                     *alloc_frame(W, H), width=W, height=H,
                                     samples=samples, chunk=128)
        ac, fc = render_frame_fast_q(q, loc, k_cap, bands, tf, lp,
                                     *alloc_frame(W, H), width=W, height=H,
                                     samples=samples, chunk=128,
                                     refresh_compact=32)
        np.testing.assert_array_equal(np.asarray(fc), np.asarray(f1))
        np.testing.assert_array_equal(np.asarray(ac), np.asarray(a1))
        assert (np.asarray(f1) != 0).any()


def test_flat_service_matches_cond_ladder(scene):
    """Round-3 flat loop (packed carry + unconditional fixed-capacity
    service, ops/fast.batch_loop service_cap>0) must reproduce the legacy
    cond-ladder loop bit-for-bit: packing is pure layout and service
    cadence never touches a waiting lane's RNG stream."""
    ds_q, stats, tf, q, loc_csr, k_cap, bands = scene
    W = H = 32
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    kw = dict(width=W, height=H, chunk=512, samples=4,
              refresh_compact=128)
    a1, f1 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), service_cap=0, **kw)
    a2, f2 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), service_cap=256, **kw)
    np.testing.assert_array_equal(np.asarray(f2), np.asarray(f1))
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1), rtol=0,
                               atol=2.5e-7)


def test_flat_service_tiny_capacity_overflow(scene):
    """A service capacity far below the pending load (128 of 512 lanes)
    forces systematic overflow: lanes wait multiple phases for service.
    Outputs must still be bit-identical (waiting lanes draw nothing)."""
    ds_q, stats, tf, q, loc_csr, k_cap, bands = scene
    W = H = 32
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    kw = dict(width=W, height=H, chunk=512, samples=4)
    a1, f1 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), service_cap=512, **kw)
    a2, f2 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), service_cap=128, **kw)
    np.testing.assert_array_equal(np.asarray(f2), np.asarray(f1))
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1), rtol=0,
                               atol=2.5e-7)


def test_flat_service_with_finemap(scene):
    """Flat service composed with the fine-map two-stage locate renders
    identically to the flat full locate (the map only short-cuts to the
    same column)."""
    from icon_dvr.models.finemap import build_finemap
    ds_q, stats, tf, q, loc_csr, k_cap, bands = scene
    fm = build_finemap(loc_csr, q.test12, k_cap, factor=2)
    W = H = 32
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    kw = dict(width=W, height=H, chunk=512, samples=4)
    a1, f1 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), **kw)
    a2, f2 = render_frame_fast_q(q, loc_csr, k_cap, bands, tf, lp,
                                 *alloc_frame(W, H), finemap=fm, **kw)
    np.testing.assert_array_equal(np.asarray(f2), np.asarray(f1))
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1), rtol=0,
                               atol=2.5e-7)


def test_service_cap_auto_gate():
    """-1 auto picks the flat loop only at giant tables (the ladder won
    at r2b8-class scales on the earlier accelerator)."""
    from icon_dvr.ops.fast import (FLAT_AUTO_MIN_CELLS,
                                   _resolve_service_cap)
    assert _resolve_service_cap(-1, 1_310_720, 8192) == 0
    assert _resolve_service_cap(-1, FLAT_AUTO_MIN_CELLS, 8192) == 4096
    assert _resolve_service_cap(-1, 84_000_000, 100) == 128  # floor
    assert _resolve_service_cap(0, 84_000_000, 8192) == 0    # explicit
    assert _resolve_service_cap(256, 1_000, 8192) == 256     # explicit


def test_bake_alpha_q_propagates_device_failure(scene, monkeypatch):
    """A failing device bake raises; it is not redone on the host."""
    from icon_dvr.models import qcells
    ds_q, stats, tf, q, loc_csr, k_cap, bands = scene

    def fail(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
    monkeypatch.setattr(qcells, "_bake_lookup", fail)
    monkeypatch.setattr(qcells, "_bake_patch", fail)
    n = tf.values.shape[0]
    tf2 = tf._replace(values=tf.values.at[:n // 2, 3].multiply(0.3))
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        qcells.bake_alpha_q(q._replace(alpha_tab=None), tf2)
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        qcells.bake_alpha_q(q, tf2)
