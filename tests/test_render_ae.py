"""End-to-end: brute-force Woodcock renderer vs the scalar numpy oracle."""
import numpy as np
import jax.numpy as jnp

import refimpl
from icon_dvr.data import synthetic
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.transfunc import make_transfunc, post_classify
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.render import (alloc_frame, fb_to_image, make_launch_params,
                                 render_frame_ae)


def _scene(num_layers=3):
    ds = synthetic.latlon_section(n_lat=2, n_lon=2, lat_range=(-30, 30),
                                  lon_range=(-30, 30), num_layers=num_layers,
                                  radius=100.0, thickness=30.0)
    stats = compute_stats(ds)
    cam = Camera()
    # the patch is centered at lat/lon (0,0) = the +x axis; view it head-on
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    diag = np.linalg.norm(stats.world_bounds_hi - stats.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    return ds, stats, cam


def test_post_classify_matches_oracle():
    tf = make_transfunc(size=16)
    lut = np.asarray(tf.values)
    for v in [0.0, 0.1, 0.5, 0.93, 1.0, -0.2, 1.4]:
        got = np.asarray(post_classify(tf, jnp.float32(v)))
        want = refimpl.post_classify(lut, (0.0, 1.0), np.float32(1.0), np.float32(v))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_post_classify_packed_bit_identical():
    # the hot-loop variant (aligned packed-LUT row gathers) must equal
    # post_classify bit-for-bit, including out-of-range clamps
    from icon_dvr.models.transfunc import pack_lut, post_classify_packed
    tf = make_transfunc(value_range=(0.1, 0.8))._replace(
        opacity_scale=jnp.float32(0.6))
    v = jnp.asarray(np.random.default_rng(1)
                    .uniform(-0.2, 1.2, 4096).astype(np.float32))
    a = np.asarray(post_classify(tf, v))
    b = np.asarray(post_classify_packed(tf, pack_lut(tf), v))
    np.testing.assert_array_equal(a, b)


def test_render_ae_matches_oracle():
    W = H = 16
    ds, stats, cam = _scene()
    cells = build_cells(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    unit_distance = 5.0

    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=unit_distance,
                            accum_id=0)
    accum, fb = alloc_frame(W, H)
    accum, fb = render_frame_ae(cells, tf, lp, accum, fb, width=W, height=H)
    # second progressive sample
    lp1 = lp._replace(accum_id=jnp.int32(1))
    accum, fb = render_frame_ae(cells, tf, lp1, accum, fb, width=W, height=H)

    accum_ref, fb_ref = refimpl.render_ae(
        ds, np.asarray(tf.values), np.asarray(tf.value_range),
        np.float32(1.0), cam.basis(W, H), W, H,
        stats.world_bounds_lo, stats.world_bounds_hi,
        unit_distance=unit_distance, num_samples=2)

    accum = np.asarray(accum)
    fb = np.asarray(fb)
    # float math is identical up to libm ULPs; allow a tiny fraction of
    # pixels to differ (acceptance-test boundary flips)
    close = np.all(np.abs(accum - accum_ref) <= 2e-3, axis=-1)
    assert close.mean() > 0.98, f"only {close.mean():.3f} of accum pixels match"
    same_px = fb == fb_ref
    assert same_px.mean() > 0.97, f"only {same_px.mean():.3f} of packed pixels match"
    # the image must not be trivially empty
    assert (fb_ref != 0).mean() > 0.1
    img = fb_to_image(fb, W, H)
    assert img.shape == (H, W, 4)


def test_render_ae_deterministic():
    W = H = 16
    ds, stats, cam = _scene(num_layers=2)
    cells = build_cells(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=16)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=5.0)
    a1, f1 = render_frame_ae(cells, tf, lp, *alloc_frame(W, H), width=W, height=H)
    a2, f2 = render_frame_ae(cells, tf, lp, *alloc_frame(W, H), width=W, height=H)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
