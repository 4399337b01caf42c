"""Ray ordering: permuted rendering must be a permutation of the unsorted
render (identical per-pixel results — the RNG is seeded by pixel id)."""
import numpy as np
import jax.numpy as jnp

from icon_dvr.data import synthetic
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.locator import build_locator
from icon_dvr.models.shells import build_radial_bands, update_band_majorants
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.fast import pack_cells, render_frame_fast
from icon_dvr.ops.order import inverse_order, pixel_order
from icon_dvr.ops.render import alloc_frame, make_launch_params


def test_permuted_render_matches_unsorted():
    W = H = 16
    ds = synthetic.latlon_section(n_lat=2, n_lon=2, num_layers=3,
                                  radius=100.0, thickness=30.0)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 8),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    diag = np.linalg.norm(stats.world_bounds_hi - stats.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=5.0)

    perm, n_cov = pixel_order(lp, stats.spherical_bounds_lo[0],
                              stats.spherical_bounds_hi[0], W, H)
    inv = inverse_order(perm)
    assert sorted(perm.tolist()) == list(range(W * H))
    assert 0 < n_cov <= W * H

    a0, f0 = render_frame_fast(cells, packed, loc, bands, lp,
                               *alloc_frame(W, H), width=W, height=H)
    a1, f1 = render_frame_fast(cells, packed, loc, bands, lp,
                               *alloc_frame(W, H), width=W, height=H,
                               pixel_perm=jnp.asarray(perm))
    np.testing.assert_array_equal(np.asarray(f1)[inv], np.asarray(f0))
    np.testing.assert_array_equal(np.asarray(a1)[inv], np.asarray(a0))

    # active-prefix truncation must be EXACT (conservative coverage)
    a2, f2 = render_frame_fast(cells, packed, loc, bands, lp,
                               *alloc_frame(W, H), width=W, height=H,
                               pixel_perm=jnp.asarray(perm), n_active=n_cov)
    np.testing.assert_array_equal(np.asarray(f2)[inv], np.asarray(f0))
    np.testing.assert_array_equal(np.asarray(a2)[inv], np.asarray(a0))


def test_bucket_active():
    from icon_dvr.ops.order import bucket_active
    assert bucket_active(1, 4096, 100 * 4096) == 4096
    assert bucket_active(5000, 4096, 100 * 4096) == 2 * 4096
    assert bucket_active(9000, 4096, 100 * 4096) == 4 * 4096
    assert bucket_active(10 ** 9, 4096, 100 * 4096) == 100 * 4096
