"""Deterministic transmittance march (ops/march.py) correctness.

The march is a zero-variance estimator of the same integral the Woodcock
fast tier estimates (the fast path's documented license: statistically
equivalent, not bit-equal).  Tests assert:
  (a) the closed-form column-crossing integral matches brute-force
      quadrature of the piecewise-constant field on arbitrary rays;
  (b) a single march frame matches the MEAN of many Woodcock progressive
      samples within Monte-Carlo tolerance (the estimator-equivalence
      contract of tests/test_fast.py, but against expectation instead of
      between two estimators);
  (c) the march is deterministic and its alpha is a transmittance
      (monotone bounds, early-termination bias <= ET_EPS).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icon_dvr.data import synthetic
from icon_dvr.models.cells import compute_stats
from icon_dvr.models.locator import build_locator_csr, densify_csr
from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                    quantize_dataset_values)
from icon_dvr.models.shells import (build_radial_bands,
                                    update_band_majorants)
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.march import (ET_EPS, _integrate_column,
                                render_frame_march_q)
from icon_dvr.ops.fastq import render_frame_fast_q
from icon_dvr.ops.render import alloc_frame, make_launch_params

W = H = 48


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
    cam = Camera()
    cam.set_aspect(W / H)
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    r = stats.spherical_bounds_hi[0]
    cam.set_orientation(center + np.array([2.2 * r, 0.4 * r, 0.9 * r],
                                          np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    return q, loc, k_cap, bands, tf, lp


def _quadrature(h_edges, alphas, colors, t0, t1, od, oo, ud, n=40000):
    """Brute-force emission-absorption integral of the layered profile
    along r(t) = sqrt(oo + 2 t od + t^2) over [t0, t1] (float64)."""
    t = np.linspace(t0, t1, n + 1)
    tm = 0.5 * (t[:-1] + t[1:])
    dt = np.diff(t)
    r = np.sqrt(np.maximum(oo + 2 * tm * od + tm * tm, 0.0))
    layer = np.searchsorted(h_edges[1:], r, side="left")  # 0..lm
    inside = layer < len(alphas)
    sig = np.where(inside & (r >= h_edges[0]), alphas[np.minimum(
        layer, len(alphas) - 1)], 0.0) / ud
    od_seg = sig * dt
    tau_pre = np.concatenate([[0.0], np.cumsum(od_seg)[:-1]])
    w = np.exp(-tau_pre) * (1.0 - np.exp(-od_seg))
    c = colors[np.minimum(layer, len(alphas) - 1)]
    c = np.where((inside & (r >= h_edges[0]))[:, None], c, 0.0)
    rgb = (w[:, None] * c).sum(axis=0)
    return rgb, np.exp(-od_seg.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_integrate_column_vs_quadrature(seed):
    rng = np.random.default_rng(seed)
    lm = 6
    L = 8
    h_bot = 1.0
    edges = np.sort(rng.uniform(1.0, 2.0, lm - 1))
    h_edges = np.concatenate([[h_bot], edges, [2.0]])   # lm ceilings
    alphas = rng.uniform(0.0, 2.0, lm)
    colors = rng.uniform(0.0, 1.0, (lm, 3))
    ud = 0.37

    heights = np.tile(h_edges[1:], (L, 1)).astype(np.float32)
    prof = np.concatenate(
        [heights, np.tile(alphas, (L, 1)),
         np.zeros((L, lm))], axis=1).astype(np.float32)

    # random rays: origin outside r=2, passing at varying depths
    oo_v, od_v, t0_v, t1_v = [], [], [], []
    for i in range(L):
        b = rng.uniform(0.0, 2.2)       # impact parameter
        d0 = rng.uniform(2.5, 4.0)      # distance along ray to apex
        oo = b * b + d0 * d0
        od = -d0                        # apex at t = d0
        # crossing interval of the [h_bot, 2] annulus (outer entry/exit)
        disc_t = od * od - oo + 4.0
        if disc_t <= 0:
            t0, t1 = d0 - 0.1, d0 + 0.1   # outside: zero-contribution
        else:
            t0 = -od - np.sqrt(disc_t)
            disc_b = od * od - oo + h_bot * h_bot
            if disc_b > 0:
                t1 = -od - np.sqrt(disc_b)    # clipped at bottom sphere
            else:
                t1 = -od + np.sqrt(disc_t) if rng.random() < 0.5 \
                    else -od + 0.3 * np.sqrt(disc_t)
        oo_v.append(oo)
        od_v.append(od)
        t0_v.append(t0)
        t1_v.append(t1)

    oo_a = np.asarray(oo_v, np.float32)
    od_a = np.asarray(od_v, np.float32)
    t0_a = np.asarray(t0_v, np.float32)
    t1_a = np.asarray(t1_v, np.float32)

    # _integrate_column takes scalar oo (shared camera origin); run lanes
    # one at a time to allow per-lane origins
    for i in range(L):
        tmul, cr, cg, cb = _integrate_column(
            jnp.asarray(prof[i:i + 1]), lm,
            jnp.asarray([h_bot], jnp.float32),
            jnp.asarray([lm], jnp.int32),
            jnp.asarray(t0_a[i:i + 1]), jnp.asarray(t1_a[i:i + 1]),
            jnp.asarray(od_a[i:i + 1]), jnp.float32(oo_a[i]),
            jnp.float32(ud),
            (jnp.tile(jnp.asarray(colors[:, 0], jnp.float32), (1, 1)),
             jnp.tile(jnp.asarray(colors[:, 1], jnp.float32), (1, 1)),
             jnp.tile(jnp.asarray(colors[:, 2], jnp.float32), (1, 1))))
        rgb_ref, trans_ref = _quadrature(h_edges, alphas, colors,
                                         float(t0_a[i]), float(t1_a[i]),
                                         float(od_a[i]), float(oo_a[i]), ud)
        got = np.array([float(cr[0]), float(cg[0]), float(cb[0])])
        assert np.allclose(got, rgb_ref, atol=2e-3), (i, got, rgb_ref)
        assert abs(float(tmul[0]) - trans_ref) < 2e-3, (i, float(tmul[0]),
                                                        trans_ref)


def test_march_matches_oracle():
    """EXACTNESS: the march must reproduce a brute-force dense-scan
    quadrature of the full ray through the actual scene (containment over
    every cell, per-layer alpha/value, 1e5-point Riemann transmittance)
    to f32 tolerance — this is the per-ray ground truth the Woodcock
    estimator only approaches statistically."""
    from march_oracle import MarchOracle

    from icon_dvr.ops.march import march_rays_q

    ds = synthetic.icosphere(subdivisions=1, num_layers=4)
    ds_q, _, _ = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    q = bake_alpha_q(quantize_cells(ds_q), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    bands = update_band_majorants(build_radial_bands(ds_q, 8),
                                  tf.values, tf.value_range)
    cam = Camera()
    cam.set_aspect(1.0)
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    r = stats.spherical_bounds_hi[0]
    cam.set_orientation(center + np.array([2.2 * r, 0.4 * r, 0.9 * r],
                                          np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    oracle = MarchOracle(q, bands, tf, lp, W, H, ud=1e4)

    # a mix of central, oblique, and silhouette-adjacent pixels
    for px_id in (W * H // 2 + W // 2, 17 * W + 23, 31 * W + 14,
                  12 * W + 21):
        xs = jnp.asarray([px_id % W], jnp.int32)
        ys = jnp.asarray([px_id // W], jnp.int32)
        wrote, ca = march_rays_q(q, loc, k_cap, bands, tf,
                                 lp._replace(accum_id=jnp.int32(0)),
                                 xs, ys, W, H)
        got = np.asarray(ca)[0]
        want = oracle.pixel(px_id % W, px_id // W)
        assert np.abs(got - want).max() < 3e-3, (px_id, got, want)


def test_march_matches_woodcock_mean(scene):
    """STATISTICAL equivalence on the full frame: the march is the
    expectation of the Woodcock estimator, so the Woodcock average must
    scatter around it at MC rates.  Per-pixel Woodcock color variance is
    LARGE (each sample takes one whole layer's classified color), so the
    bounds are set at ~3x the S=128 noise floor; the exactness bar lives
    in test_march_matches_oracle."""
    q, loc, k_cap, bands, tf, lp = scene
    accum_m, fb_m = render_frame_march_q(
        q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H)
    am = np.asarray(accum_m)

    S = 128
    accum, fb = alloc_frame(W, H)
    accum, fb = render_frame_fast_q(
        q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(0)),
        accum, fb, width=W, height=H, chunk=W * H, samples=S)
    aw = np.asarray(accum)

    # interior pixels: every jitter hits (silhouette pixels legitimately
    # differ by the jitter coverage of the march's single pass)
    interior = (am[:, 3] > 0) & (aw[:, 3] > 0.999)
    assert interior.sum() > 50
    d = np.abs(am - aw)[interior]
    assert d[:, :3].mean() < 0.08, d[:, :3].mean()
    assert d[:, 3].mean() < 0.01, d[:, 3].mean()
    # image-mean color agreement (noise averages out over pixels)
    assert np.abs(am[interior, :3].mean(0)
                  - aw[interior, :3].mean(0)).max() < 0.02


def test_march_f32_tier_and_quantization_rmse(scene):
    """The f32-tier march (colors from the baked PackedCells.rgb rows)
    must statistically match the f32 Woodcock tier; and because BOTH
    marches are deterministic, march_q vs march_f32 on the same
    (value-quantized) dataset measures the PURE quantization error of
    the u8/u16 tier — no MC noise in the comparison (the bench's
    rmse_q)."""
    from icon_dvr.models.cells import build_cells
    from icon_dvr.models.locator import build_locator
    from icon_dvr.ops.fast import pack_cells, render_frame_fast
    from icon_dvr.ops.march import render_frame_march

    q, loc_q, k_cap, bands, tf, lp = scene
    ds = synthetic.icosphere(subdivisions=2, num_layers=5)
    ds_q, _, _ = quantize_dataset_values(ds)
    cells = build_cells(ds_q)
    locator = build_locator(ds_q)
    packed = pack_cells(cells, tf)

    accum_m, _ = render_frame_march(
        cells, packed, locator, bands, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H)
    am = np.asarray(accum_m)

    S = 96
    accum, fb = alloc_frame(W, H)
    accum, fb = render_frame_fast(
        cells, packed, locator, bands, lp._replace(accum_id=jnp.int32(0)),
        accum, fb, width=W, height=H, chunk=W * H, samples=S)
    aw = np.asarray(accum)
    interior = (am[:, 3] > 0) & (aw[:, 3] > 0.999)
    assert interior.sum() > 50
    d = np.abs(am - aw)[interior]
    assert d[:, :3].mean() < 0.09, d[:, :3].mean()
    assert d[:, 3].mean() < 0.01, d[:, 3].mean()

    # cross-tier deterministic comparison: pure quantization error
    accum_q, _ = render_frame_march_q(
        q, loc_q, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H)
    aq = np.asarray(accum_q)
    both = (am[:, 3] > 0) & (aq[:, 3] > 0)
    rmse = float(np.sqrt(np.mean((am[both] - aq[both]) ** 2)))
    assert rmse < 0.05, rmse


def test_march_deterministic(scene):
    q, loc, k_cap, bands, tf, lp = scene
    out1 = render_frame_march_q(
        q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(3)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H)
    out2 = render_frame_march_q(
        q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(3)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H)
    np.testing.assert_array_equal(np.asarray(out1[0]), np.asarray(out2[0]))
    np.testing.assert_array_equal(np.asarray(out1[1]), np.asarray(out2[1]))


def test_march_alpha_bounds(scene):
    q, loc, k_cap, bands, tf, lp = scene
    accum, fb = render_frame_march_q(
        q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H)
    a = np.asarray(accum)
    assert (a[:, 3] >= 0.0).all() and (a[:, 3] <= 1.0 + 1e-6).all()
    # early termination leaves at most ET_EPS of transmittance unresolved
    assert np.isfinite(a).all()
    assert ET_EPS <= 1e-2


def test_march_finemap_two_stage_matches(scene):
    """The finemap two-stage march service (dense primary + compacted
    full tail) must produce the same image as the dense full locate:
    the march has no RNG, so service cadence cannot change values —
    only f32 boundary-tie column choices may differ."""
    from icon_dvr.models.finemap import build_finemap

    q, loc, k_cap, bands, tf, lp = scene
    fm = build_finemap(loc, q.test12, k_cap)
    a0, _ = render_frame_march_q(
        q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H)
    a1, _ = render_frame_march_q(
        q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H, finemap=fm)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a0), atol=1e-4)


def test_march_generational_compaction_bit_equal(scene):
    """Generational compaction (halving-width stages as lanes finish) is
    pure scheduling: per-lane math is untouched, so outputs must be
    BIT-identical to the single-stage loop."""
    q, loc, k_cap, bands, tf, lp = scene
    out1 = render_frame_march_q(
        q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H, generations=1)
    out3 = render_frame_march_q(
        q, loc, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(W, H), width=W, height=H, chunk=W * H, generations=3)
    np.testing.assert_array_equal(np.asarray(out1[0]), np.asarray(out3[0]))
    np.testing.assert_array_equal(np.asarray(out1[1]), np.asarray(out3[1]))
