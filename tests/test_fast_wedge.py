"""Fast wedge sampler (sampler='wedge' on the fast raygen): statistical
equivalence with the parity Newton wedge path, majorant conservativeness
with sagitta inflation, and sample batching."""
import numpy as np
import jax.numpy as jnp

from icon_dvr.data import synthetic
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.locator import build_locator
from icon_dvr.models.shells import (build_radial_bands_wedge,
                                    update_band_majorants)
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.models.wedges import build_wedges, bv_all, column_min_norm
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.fast import pack_cells_wedge, render_frame_fast
from icon_dvr.ops.render import (alloc_frame, make_launch_params,
                                 render_frame_ae)


def _scene():
    # tiny 4-column section: the parity Newton sampler is ~1000x slower
    # than the fast tier, so statistical comparison needs a small scene
    ds = synthetic.latlon_section(n_lat=2, n_lon=2, lat_range=(-30, 30),
                                  lon_range=(-30, 30), num_layers=3,
                                  radius=100.0, thickness=30.0)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    return ds, stats, cells, loc, tf


def test_wedge_bands_conservative():
    """Band majorants must bound every wedge's classified bv alpha over its
    sagitta-inflated radial extent."""
    ds, stats, cells, loc, tf = _scene()
    bands = update_band_majorants(build_radial_bands_wedge(ds, 16),
                                  tf.values, tf.value_range)
    from icon_dvr.models.transfunc import post_classify
    bv = bv_all(ds.value, ds.num_layers)
    mn = column_min_norm(ds.lat, ds.lon)
    edges = np.asarray(bands.edges)
    mo = np.asarray(bands.max_opacities)
    alpha = np.asarray(post_classify(tf, jnp.asarray(bv.reshape(-1)))
                       )[:, 3].reshape(bv.shape)
    for i in range(ds.num_cells):
        for L in range(int(ds.num_layers[i])):
            a = alpha[i, L]
            lo = ds.height[i, L] * mn[i]
            hi = ds.height[i, L + 1]
            b0 = np.clip(np.searchsorted(edges, lo, "right") - 1,
                         0, len(mo) - 1)
            b1 = np.clip(np.searchsorted(edges, hi, "left"), 0, len(mo) - 1)
            assert mo[min(b0, b1):max(b0, b1) + 1].max() >= a - 1e-5, (i, L)


def test_fast_wedge_matches_parity_statistically():
    """Converged fast-wedge accum ~= converged parity (Newton) wedge accum.
    Both sample the same per-wedge-constant bv field; geometry differs only
    by Newton tolerances at faces."""
    ds, stats, cells, loc, tf = _scene()
    wedges = build_wedges(ds)
    bands = update_band_majorants(build_radial_bands_wedge(ds, 16),
                                  tf.values, tf.value_range)
    packed = pack_cells_wedge(cells, tf)
    W = H = 16
    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    diag = np.linalg.norm(stats.world_bounds_hi - stats.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    lp0 = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                             stats.world_bounds_hi, unit_distance=5.0)
    n_samples = 32
    a_f, f_f = alloc_frame(W, H)
    a_p, f_p = alloc_frame(W, H)
    a_f, f_f = render_frame_fast(cells, packed, loc, bands,
                                 lp0._replace(accum_id=jnp.int32(0)),
                                 a_f, f_f, width=W, height=H,
                                 sampler="wedge", samples=n_samples)
    for s in range(n_samples):
        a_p, f_p = render_frame_ae(cells, tf,
                                   lp0._replace(accum_id=jnp.int32(s)),
                                   a_p, f_p, width=W, height=H,
                                   sampler="wedge", locator=loc,
                                   wedges=wedges)
    a_f = np.asarray(a_f)
    a_p = np.asarray(a_p)
    cover_f = a_f[:, 3] > 0
    cover_p = a_p[:, 3] > 0
    # fast wrote-mask is the shell, parity is the AABB: compare the overlap
    assert (cover_f == cover_p).mean() > 0.85
    both = cover_f & cover_p
    assert both.sum() > 10
    diff = np.abs(a_f[both] - a_p[both])
    assert diff.mean() < 0.11, diff.mean()
    assert np.isfinite(a_f).all()


def test_fast_wedge_deterministic_and_batched():
    ds, stats, cells, loc, tf = _scene()
    bands = update_band_majorants(build_radial_bands_wedge(ds, 16),
                                  tf.values, tf.value_range)
    packed = pack_cells_wedge(cells, tf)
    W = H = 24
    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    diag = np.linalg.norm(stats.world_bounds_hi - stats.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=5.0)
    a1, f1 = alloc_frame(W, H)
    for s in range(3):
        a1, f1 = render_frame_fast(cells, packed, loc, bands,
                                   lp._replace(accum_id=jnp.int32(s)),
                                   a1, f1, width=W, height=H,
                                   sampler="wedge", chunk=256)
    a2, f2 = render_frame_fast(cells, packed, loc, bands,
                               lp._replace(accum_id=jnp.int32(0)),
                               *alloc_frame(W, H), width=W, height=H,
                               sampler="wedge", samples=3, chunk=256)
    np.testing.assert_array_equal(np.asarray(f2), np.asarray(f1))
    assert (np.asarray(f1) != 0).any()
