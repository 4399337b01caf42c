"""Robustness: degenerate camera placements and transfer functions must
terminate and stay finite on every render path."""
import numpy as np
import jax.numpy as jnp

from icon_dvr.data import synthetic
from icon_dvr.models.accel import (build_grid_accel, build_shell_accel,
                                   update_majorants)
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.locator import build_locator
from icon_dvr.models.shells import build_radial_bands, update_band_majorants
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.fast import pack_cells, render_frame_fast
from icon_dvr.ops.render import (alloc_frame, make_launch_params,
                                 render_frame_accel, render_frame_ae)


def _scene():
    ds = synthetic.latlon_section(n_lat=2, n_lon=2, lat_range=(-30, 30),
                                  lon_range=(-30, 30), num_layers=3,
                                  radius=100.0, thickness=30.0)
    return ds, compute_stats(ds)


def _cam_at(pos, stats):
    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    cam.set_orientation(np.asarray(pos, np.float32), center,
                        np.array([0, 0, 1], np.float32), cam.fovy)
    return cam


def _assert_ok(accum):
    a = np.asarray(accum)
    assert np.isfinite(a).all()


def test_camera_inside_shell_all_paths():
    W = H = 8
    ds, stats = _scene()
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=16)
    sa = update_majorants(
        build_shell_accel(ds, stats.spherical_bounds_lo,
                          stats.spherical_bounds_hi, (1, 8, 8)),
        tf.values, tf.value_range)
    ga = update_majorants(
        build_grid_accel(ds, stats.world_bounds_lo, stats.world_bounds_hi,
                         (8, 8, 8)),
        tf.values, tf.value_range)
    bands = update_band_majorants(build_radial_bands(ds, 8),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)

    # inside the shell (mid radius of the patch), inside the inner sphere,
    # and exactly at a cell corner direction
    positions = [(110.0, 0.0, 0.0), (50.0, 0.0, 0.0), (0.1, 0.1, 0.1)]
    for pos in positions:
        cam = _cam_at(pos, stats)
        lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                                stats.world_bounds_hi, unit_distance=5.0)
        a, f = render_frame_ae(cells, tf, lp, *alloc_frame(W, H),
                               width=W, height=H)
        _assert_ok(a)
        a, f = render_frame_accel(cells, tf, sa, lp, *alloc_frame(W, H),
                                  width=W, height=H, accel_mode="sphere")
        _assert_ok(a)
        a, f = render_frame_accel(cells, tf, ga, lp, *alloc_frame(W, H),
                                  width=W, height=H, accel_mode="grid")
        _assert_ok(a)
        a, f = render_frame_fast(cells, packed, loc, bands, lp,
                                 *alloc_frame(W, H), width=W, height=H)
        _assert_ok(a)


def test_fully_transparent_tf_terminates():
    """alpha == 0 everywhere: majorants go to 0 and rays must pass through
    without collisions (and without spinning forever)."""
    W = H = 8
    ds, stats = _scene()
    cells = build_cells(ds)
    loc = build_locator(ds)
    clear = np.zeros((16, 4), np.float32)
    clear[:, 0] = 1.0
    tf = make_transfunc(clear, value_range=tuple(stats.data_range), size=16)
    bands = update_band_majorants(build_radial_bands(ds, 8),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    cam = _cam_at((170.0, 0.0, 0.0), stats)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=5.0)
    a, f = render_frame_fast(cells, packed, loc, bands, lp,
                             *alloc_frame(W, H), width=W, height=H)
    a = np.asarray(a)
    assert np.isfinite(a).all()
    assert (a[:, 3] == 0).all()  # nothing collides
