"""Majorant grids + accelerated traversals vs the scalar numpy oracle."""
import numpy as np
import jax.numpy as jnp

import refimpl
from icon_dvr.data import synthetic
from icon_dvr.models.accel import (build_grid_accel, build_shell_accel,
                                   compute_max_opacities, update_majorants)
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.render import (alloc_frame, make_launch_params,
                                 render_frame_accel)


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


def test_grid_build_matches_oracle():
    ds, stats, _ = _scene()
    dims = (8, 8, 8)
    ga = build_grid_accel(ds, stats.world_bounds_lo, stats.world_bounds_hi, dims)
    vr_lo, vr_hi = refimpl.build_grid_icon(ds, dims, stats.world_bounds_lo,
                                           stats.world_bounds_hi)
    got = np.asarray(ga.value_ranges)
    np.testing.assert_allclose(got[:, 0], vr_lo, rtol=1e-6)
    np.testing.assert_allclose(got[:, 1], vr_hi, rtol=1e-6)


def test_shell_build_matches_oracle():
    ds, stats, _ = _scene()
    dims = (1, 16, 16)
    sa = build_shell_accel(ds, stats.spherical_bounds_lo,
                           stats.spherical_bounds_hi, dims)
    vr_lo, vr_hi = refimpl.build_shell_icon(ds, dims, stats.spherical_bounds_lo,
                                            stats.spherical_bounds_hi)
    got = np.asarray(sa.value_ranges)
    np.testing.assert_allclose(got[:, 0], vr_lo, rtol=1e-6)
    np.testing.assert_allclose(got[:, 1], vr_hi, rtol=1e-6)


def test_max_opacities_matches_oracle():
    ds, stats, _ = _scene()
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    ga = build_grid_accel(ds, stats.world_bounds_lo, stats.world_bounds_hi, (8, 8, 8))
    got = np.asarray(compute_max_opacities(ga.value_ranges, tf.values, tf.value_range))
    want = refimpl.compute_max_opacities(
        np.asarray(ga.value_ranges)[:, 0], np.asarray(ga.value_ranges)[:, 1],
        np.asarray(tf.values), np.asarray(tf.value_range))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_max_opacities_random_ranges():
    """Sparse-table range-max must equal the oracle's LUT scan for random
    value ranges and LUT sizes (incl. non-power-of-two)."""
    rs = np.random.RandomState(3)
    for size in (7, 16, 300):
        lut = rs.rand(size, 4).astype(np.float32)
        vr = np.sort(rs.rand(64, 2).astype(np.float32) * 1.4 - 0.2, axis=1)
        vr[::9] = vr[::9, ::-1]  # some empty (hi < lo) bins
        got = np.asarray(compute_max_opacities(
            jnp.asarray(vr), jnp.asarray(lut), jnp.asarray([0.0, 1.0])))
        want = refimpl.compute_max_opacities(
            vr[:, 0], vr[:, 1], lut, np.array([0.0, 1.0], np.float32))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _render_both(ds, stats, cam, accel_mode, dims, W=16, H=16, samples=2):
    cells = build_cells(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    if accel_mode == "sphere":
        accel = build_shell_accel(ds, stats.spherical_bounds_lo,
                                  stats.spherical_bounds_hi, dims)
        ref_accel = {"mode": "sphere", "dims": np.asarray(dims),
                     "slo": stats.spherical_bounds_lo, "shi": stats.spherical_bounds_hi}
    else:
        accel = build_grid_accel(ds, stats.world_bounds_lo, stats.world_bounds_hi, dims)
        ref_accel = {"mode": "grid", "dims": np.asarray(dims),
                     "blo": stats.world_bounds_lo, "bhi": stats.world_bounds_hi}
    accel = update_majorants(accel, tf.values, tf.value_range)
    ref_accel["max_opacities"] = np.asarray(accel.max_opacities)

    unit_distance = 5.0
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=unit_distance)
    accum, fb = alloc_frame(W, H)
    for s in range(samples):
        accum, fb = render_frame_accel(cells, tf, accel,
                                       lp._replace(accum_id=jnp.int32(s)),
                                       accum, fb, width=W, height=H,
                                       accel_mode=accel_mode)
    accum_ref, fb_ref = refimpl.render_accel(
        ds, np.asarray(tf.values), np.asarray(tf.value_range), np.float32(1.0),
        cam.basis(W, H), W, H, stats.world_bounds_lo, stats.world_bounds_hi,
        ref_accel, unit_distance=unit_distance, num_samples=samples)
    return np.asarray(accum), np.asarray(fb), accum_ref, fb_ref


def test_render_grid_accel_matches_oracle():
    ds, stats, cam = _scene()
    accum, fb, accum_ref, fb_ref = _render_both(ds, stats, cam, "grid", (8, 8, 8))
    close = np.all(np.abs(accum - accum_ref) <= 2e-3, axis=-1)
    assert close.mean() > 0.97, f"only {close.mean():.3f} of accum pixels match"
    assert (fb == fb_ref).mean() > 0.95
    assert (fb_ref != 0).mean() > 0.05  # non-trivial image


def test_render_sphere_accel_matches_oracle():
    ds, stats, cam = _scene()
    accum, fb, accum_ref, fb_ref = _render_both(ds, stats, cam, "sphere", (1, 16, 16))
    close = np.all(np.abs(accum - accum_ref) <= 2e-3, axis=-1)
    assert close.mean() > 0.97, f"only {close.mean():.3f} of accum pixels match"
    assert (fb == fb_ref).mean() > 0.95
    assert (fb_ref != 0).mean() > 0.05
