"""Grid-of-lists locator must agree exactly with the brute-force scan."""
import numpy as np
import jax
import jax.numpy as jnp

from icon_dvr.data import synthetic
from icon_dvr.models.cells import build_cells, compute_stats, sample_brute_force
from icon_dvr.models.locator import build_locator, sample_locator
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.render import alloc_frame, make_launch_params, render_frame_ae


def _random_points(stats, n, seed=0):
    """Random points concentrated around the (thin) shell radii, plus some
    clearly inside/outside, so both hit and miss paths are exercised."""
    rs = np.random.RandomState(seed)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r_lo, r_hi = stats.spherical_bounds_lo[0], stats.spherical_bounds_hi[0]
    span = r_hi - r_lo
    r = (r_lo - 0.5 * span) + rs.rand(n).astype(np.float32) * 2.0 * span
    return (d * r[:, None]).astype(np.float32)


def test_locator_matches_brute_force():
    for ds in (synthetic.icosphere(subdivisions=2, num_layers=4),
               synthetic.latlon_section(n_lat=5, n_lon=7, num_layers=3)):
        stats = compute_stats(ds)
        cells = build_cells(ds)
        loc = build_locator(ds)
        pts = _random_points(stats, 2000)
        hit_b, val_b = jax.vmap(lambda p: sample_brute_force(cells, p))(jnp.asarray(pts))
        hit_l, val_l = jax.vmap(lambda p: sample_locator(cells, loc, p))(jnp.asarray(pts))
        np.testing.assert_array_equal(np.asarray(hit_b), np.asarray(hit_l))
        np.testing.assert_array_equal(np.asarray(val_b), np.asarray(val_l))
        assert float(jnp.mean(hit_b)) > 0.05  # some points actually inside


def test_locator_edge_bulge():
    """Great-circle cell edges BULGE in latitude past their endpoints (an
    arc's closest approach to a pole lies between its vertices), so the
    vertex-bbox binning missed sliver regions — the locator returned no-hit for
    points brute-force containment puts inside a cell (531 such points on one
    camera ray at subdiv 1).  Coarse cells make the slivers fat: at subdiv 1
    this test fails the old binning on ~1% of points."""
    ds = synthetic.icosphere(subdivisions=1, num_layers=3)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    pts = _random_points(stats, 20000, seed=11)
    hit_b, val_b = jax.vmap(lambda p: sample_brute_force(cells, p))(
        jnp.asarray(pts))
    hit_l, val_l = jax.vmap(lambda p: sample_locator(cells, loc, p))(
        jnp.asarray(pts))
    np.testing.assert_array_equal(np.asarray(hit_b), np.asarray(hit_l))
    np.testing.assert_array_equal(np.asarray(val_b), np.asarray(val_l))


def test_locator_dateline_cells():
    """Cells straddling lon = +-pi must be findable from both sides."""
    ds = synthetic.icosphere(subdivisions=2, num_layers=2)
    lo_min, lo_max = ds.lon.min(axis=1), ds.lon.max(axis=1)
    assert ((lo_max - lo_min) > np.pi).any(), "icosphere should have dateline cells"
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    # sample points near the dateline at mid radius
    r = 0.5 * (stats.spherical_bounds_lo[0] + stats.spherical_bounds_hi[0])
    lats = np.linspace(-1.2, 1.2, 40)
    pts = []
    for lon in (np.pi - 1e-3, -np.pi + 1e-3):
        for lat in lats:
            pts.append([r * np.cos(lat) * np.cos(lon), r * np.cos(lat) * np.sin(lon),
                        r * np.sin(lat)])
    pts = np.asarray(pts, np.float32)
    hit_b, val_b = jax.vmap(lambda p: sample_brute_force(cells, p))(jnp.asarray(pts))
    hit_l, val_l = jax.vmap(lambda p: sample_locator(cells, loc, p))(jnp.asarray(pts))
    np.testing.assert_array_equal(np.asarray(hit_b), np.asarray(hit_l))
    np.testing.assert_array_equal(np.asarray(val_b), np.asarray(val_l))
    assert np.asarray(hit_b).mean() > 0.9


def test_render_with_locator_matches_brute():
    ds = synthetic.icosphere(subdivisions=2, num_layers=4)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    W = H = 24
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    a1, f1 = render_frame_ae(cells, tf, lp, *alloc_frame(W, H), width=W, height=H,
                             sampler="brute")
    a2, f2 = render_frame_ae(cells, tf, lp, *alloc_frame(W, H), width=W, height=H,
                             sampler="locator", locator=loc)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
