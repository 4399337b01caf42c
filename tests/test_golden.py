"""Pinned-golden regression: exact packed framebuffer for a tiny fixed
scene on the parity (AE brute-force) raygen, 2 progressive samples, CPU.

This pins the full semantic chain (LCG stream, ray jitter, point-in-prism,
postClassify, accumulation, sRGB, RGBA8 packing).  If it breaks without an
intentional semantics change, a quirk was 'fixed' by accident.  It may
legitimately shift with a jax/XLA upgrade (libm ULPs) — regenerate with
the snippet in the docstring of _regen below in that case.
"""
import numpy as np
import jax.numpy as jnp

from icon_dvr.data import synthetic
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.render import alloc_frame, make_launch_params, render_frame_ae

GOLDEN_FB = np.array([
    0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 2158449762, 0, 0, 0, 0,
    0, 0, 4293428880, 4293839562, 2159062958, 0, 0, 0,
    0, 0, 4293962147, 4293651697, 2157552569, 0, 0, 0,
    0, 0, 4293563287, 4294303960, 4293651439, 0, 0, 0,
    0, 0, 4292826233, 4294364096, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0,
], np.uint32)


def _render():
    W = H = 8
    ds = synthetic.latlon_section(n_lat=2, n_lon=2, lat_range=(-30, 30),
                                  lon_range=(-30, 30), num_layers=3,
                                  radius=100.0, thickness=30.0)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    diag = np.linalg.norm(stats.world_bounds_hi - stats.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=5.0)
    a, fb = render_frame_ae(cells, tf, lp, *alloc_frame(W, H), width=W, height=H)
    a, fb = render_frame_ae(cells, tf, lp._replace(accum_id=jnp.int32(1)),
                            a, fb, width=W, height=H)
    return np.asarray(fb)


def test_golden_framebuffer():
    fb = _render()
    mismatches = int((fb != GOLDEN_FB).sum())
    # allow a couple of acceptance-boundary pixels to flip on libm ULP
    # differences across jax versions; structural changes flip many more
    assert mismatches <= 2, f"{mismatches} pixels differ from golden"
