"""Fast raygen (radial bands + column cache): statistical equivalence with
the reference-parity brute-force estimator, plus invariants."""
import numpy as np
import jax.numpy as jnp

from icon_dvr.data import synthetic
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.locator import build_locator
from icon_dvr.models.shells import build_radial_bands, update_band_majorants
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.fast import pack_cells, pack_profile_rows, render_frame_fast
from icon_dvr.ops.render import alloc_frame, make_launch_params, render_frame_ae


def _scene():
    ds = synthetic.latlon_section(n_lat=2, n_lon=2, lat_range=(-30, 30),
                                  lon_range=(-30, 30), num_layers=3,
                                  radius=100.0, thickness=30.0)
    stats = compute_stats(ds)
    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    diag = np.linalg.norm(stats.world_bounds_hi - stats.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    return ds, stats, cam


def test_band_majorants_conservative():
    """Radial-band majorant must bound every classified layer alpha whose
    layer intersects the band."""
    ds, stats, _ = _scene()
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 16),
                                  tf.values, tf.value_range)
    cells = build_cells(ds)
    prof = np.asarray(pack_profile_rows(cells, tf)[0])
    edges = np.asarray(bands.edges)
    mo = np.asarray(bands.max_opacities)
    heights = np.asarray(cells.height)
    nl = np.asarray(cells.num_layers)
    alpha_planar = prof[:, 32:64]   # planar packing: (h | A) hot row
    for i in range(cells.num_cells):
        for L in range(int(nl[i])):
            a = alpha_planar[i, L]
            b0 = np.clip(np.searchsorted(edges, heights[i, L], "right") - 1,
                         0, len(mo) - 1)
            b1 = np.clip(np.searchsorted(edges, heights[i, L + 1], "left"),
                         0, len(mo) - 1)
            band_max = mo[min(b0, b1):max(b0, b1) + 1].max()
            assert band_max >= a - 1e-5, (i, L, a, band_max)


def test_fast_matches_brute_statistically():
    W = H = 16
    ds, stats, cam = _scene()
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 16),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    lp0 = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                             stats.world_bounds_hi, unit_distance=5.0)
    n_samples = 64

    a_f, f_f = alloc_frame(W, H)
    a_b, f_b = alloc_frame(W, H)
    for s in range(n_samples):
        lp = lp0._replace(accum_id=jnp.int32(s))
        a_f, f_f = render_frame_fast(cells, packed, loc, bands, lp, a_f, f_f,
                                     width=W, height=H)
        a_b, f_b = render_frame_ae(cells, tf, lp, a_b, f_b, width=W, height=H)

    a_f = np.asarray(a_f)
    a_b = np.asarray(a_b)
    # the fast mode's wrote-mask is the shell, the brute mode's is the AABB;
    # compare where either saw the volume
    cover_f = a_f[:, 3] > 0
    cover_b = a_b[:, 3] > 0
    assert (cover_f == cover_b).mean() > 0.9
    both = cover_f & cover_b
    assert both.sum() > 10
    diff = np.abs(a_f[both] - a_b[both])
    # MC std at 64 spp of a [0,1] binary-ish estimator ~ 0.06; allow 3 sigma
    assert diff.mean() < 0.08, diff.mean()
    assert np.isfinite(a_f).all()


def test_fast_deterministic():
    W = H = 12
    ds, stats, cam = _scene()
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=16)
    bands = update_band_majorants(build_radial_bands(ds, 8),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=5.0)
    a1, f1 = render_frame_fast(cells, packed, loc, bands, lp,
                               *alloc_frame(W, H), width=W, height=H)
    a2, f2 = render_frame_fast(cells, packed, loc, bands, lp,
                               *alloc_frame(W, H), width=W, height=H)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))


def test_adaptive_reorder_bit_identical():
    """Measured-cost reordering (order.refine_order) between samples must
    not change the unpermuted image: the RNG stream is per-pixel, so lane
    placement is free to change."""
    from icon_dvr.ops.order import (inverse_order, pixel_order,
                                    refine_order, repermute)

    ds = synthetic.icosphere(subdivisions=2, num_layers=5)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 16),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    W = H = 32
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], W, H)

    def run(reorder: bool):
        p = perm
        a, f = alloc_frame(W, H)
        for s in range(3):
            out = render_frame_fast(cells, packed, loc, bands,
                                    lp._replace(accum_id=jnp.int32(s)),
                                    a, f, width=W, height=H, chunk=256,
                                    pixel_perm=jnp.asarray(p),
                                    n_active=n_active, return_cost=True)
            a, f, cost = out
            if reorder:
                p2 = refine_order(p, n_active, np.asarray(cost))
                a = jnp.asarray(repermute(np.asarray(a), p, p2))
                f = jnp.asarray(repermute(np.asarray(f), p, p2))
                p = p2
        inv = inverse_order(np.asarray(p))
        return np.asarray(f)[inv], np.asarray(a)[inv]

    f_static, a_static = run(False)
    f_adapt, a_adapt = run(True)
    np.testing.assert_array_equal(f_adapt, f_static)
    np.testing.assert_array_equal(a_adapt, a_static)
    assert (f_static != 0).any()


def test_batched_samples_bit_identical():
    """samples=S with preserve_cache=False must equal S sequential
    samples=1 calls bit-for-bit (same per-sample RNG seeds, same
    accumulate() lerp order).  The default preserve_cache=True may differ
    on f32 boundary ties between adjacent columns (batch_loop docstring)
    — asserted tie-rare below."""
    from icon_dvr.ops.order import pixel_order

    ds = synthetic.icosphere(subdivisions=2, num_layers=5)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 16),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    W = H = 32
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], W, H)
    permj = jnp.asarray(perm)

    # sequential: 1 warm sample then 4 more one at a time
    a1, f1 = alloc_frame(W, H)
    for s in range(5):
        a1, f1 = render_frame_fast(cells, packed, loc, bands,
                                   lp._replace(accum_id=jnp.int32(s)),
                                   a1, f1, width=W, height=H, chunk=256,
                                   pixel_perm=permj, n_active=n_active)
    # batched: 1 + one samples=4 call (batch resumes mid-accumulation)
    a2, f2 = alloc_frame(W, H)
    a2, f2 = render_frame_fast(cells, packed, loc, bands,
                               lp._replace(accum_id=jnp.int32(0)),
                               a2, f2, width=W, height=H, chunk=256,
                               pixel_perm=permj, n_active=n_active)
    a2, f2 = render_frame_fast(cells, packed, loc, bands,
                               lp._replace(accum_id=jnp.int32(1)),
                               a2, f2, width=W, height=H, chunk=256,
                               pixel_perm=permj, n_active=n_active,
                               samples=4, preserve_cache=False)
    np.testing.assert_array_equal(np.asarray(f2), np.asarray(f1))
    np.testing.assert_array_equal(np.asarray(a2), np.asarray(a1))
    assert (np.asarray(f1) != 0).any()

    # default (cache-preserving) batch: identical except boundary ties
    a3, f3 = alloc_frame(W, H)
    a3, f3 = render_frame_fast(cells, packed, loc, bands,
                               lp._replace(accum_id=jnp.int32(0)),
                               a3, f3, width=W, height=H, chunk=256,
                               pixel_perm=permj, n_active=n_active)
    a3, f3 = render_frame_fast(cells, packed, loc, bands,
                               lp._replace(accum_id=jnp.int32(1)),
                               a3, f3, width=W, height=H, chunk=256,
                               pixel_perm=permj, n_active=n_active,
                               samples=4)
    diff = (np.asarray(f3) != np.asarray(f1)).mean()
    assert diff <= 0.02, diff


def test_outer_unroll_bit_identical():
    """outer_unroll=u repeats the refresh+steps phase u times per while
    iteration — identical per-lane cadence, so accum/fb must be
    bit-identical at every samples setting."""
    from icon_dvr.ops.render import alloc_frame, make_launch_params

    W = H = 24
    ds, stats, cam = _scene()
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 16),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    cam.set_aspect(W / H)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=5.0)
    for samples in (1, 3):
        a1, f1 = render_frame_fast(cells, packed, loc, bands, lp,
                                   *alloc_frame(W, H), width=W, height=H,
                                   samples=samples, chunk=128)
        a4, f4 = render_frame_fast(cells, packed, loc, bands, lp,
                                   *alloc_frame(W, H), width=W, height=H,
                                   samples=samples, chunk=128,
                                   outer_unroll=4)
        np.testing.assert_array_equal(np.asarray(f4), np.asarray(f1))
        np.testing.assert_array_equal(np.asarray(a4), np.asarray(a1))


def test_refresh_compact_bit_identical():
    """refresh_compact=P serves pending lanes with narrow gathers + row
    scatters (dense fallback when count > P).  _locate arithmetic is
    shared with the dense refresh and every pending lane is served at
    each service point, so accum/fb must be bit-identical."""
    from icon_dvr.ops.render import alloc_frame, make_launch_params

    W = H = 24
    ds, stats, cam = _scene()
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 16),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    cam.set_aspect(W / H)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=5.0)
    for samples in (1, 3):
        a1, f1 = render_frame_fast(cells, packed, loc, bands, lp,
                                   *alloc_frame(W, H), width=W, height=H,
                                   samples=samples, chunk=128)
        ac, fc = render_frame_fast(cells, packed, loc, bands, lp,
                                   *alloc_frame(W, H), width=W, height=H,
                                   samples=samples, chunk=128,
                                   refresh_compact=32)
        np.testing.assert_array_equal(np.asarray(fc), np.asarray(f1))
        np.testing.assert_array_equal(np.asarray(ac), np.asarray(a1))
        assert (np.asarray(f1) != 0).any()


def test_opacity_scale_affine_parts_exact():
    """apply_opacity_scale(parts) must reproduce a full re-bake exactly:
    the baked alpha a1*frac + a2*(1-frac)*scale is affine in the scale
    (ref postClassify, deviceCode.cu:127-135), so the A/B decomposition
    used by the production scale-edit fast path (apps/icon_rt.py
    on_tf_update scale_only; bench.py tf_edit) is not an approximation."""
    from icon_dvr.ops.fast import (apply_opacity_scale,
                                   pack_alpha_scale_parts)

    ds = synthetic.icosphere(subdivisions=2, num_layers=7)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range))
    packed = pack_cells(cells, tf)
    parts = pack_alpha_scale_parts(cells, tf)

    for scale in (0.8, 0.25, 1.0, 1.7):
        ref = pack_cells(cells, tf._replace(
            opacity_scale=jnp.float32(scale)))
        got = apply_opacity_scale(packed, parts, scale)
        # heights + rgb halves untouched by a scale edit
        np.testing.assert_array_equal(np.asarray(got.rgb),
                                      np.asarray(ref.rgb))
        np.testing.assert_array_equal(np.asarray(got.prof[:, :32]),
                                      np.asarray(ref.prof[:, :32]))
        a_got = np.asarray(got.prof[:, 32:])
        a_ref = np.asarray(ref.prof[:, 32:])
        np.testing.assert_allclose(a_got, a_ref, rtol=0, atol=1e-6)
        # chaining scale edits must not drift: derive from an already
        # scale-edited packed
        got2 = apply_opacity_scale(got, parts, scale)
        np.testing.assert_array_equal(np.asarray(got2.prof),
                                      np.asarray(got.prof))
