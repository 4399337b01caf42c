"""Native C++ host module vs pure-numpy equivalence."""
import numpy as np
import pytest

from icon_dvr.data import synthetic
from icon_dvr.models.locator import build_locator
from icon_dvr.utils.native import get_lib, native_crop_mask


needs_native = pytest.mark.skipif(get_lib() is None,
                                  reason="native module unavailable")


@needs_native
def test_native_lib_loads():
    assert get_lib().ih_version() == 1


@needs_native
def test_native_locator_matches_numpy():
    for ds in (synthetic.icosphere(subdivisions=2, num_layers=2),
               synthetic.latlon_section(n_lat=4, n_lon=6, num_layers=2)):
        nat = build_locator(ds, use_native=True)
        ref = build_locator(ds, use_native=False)
        assert nat.bins.shape == ref.bins.shape, (nat.bins.shape, ref.bins.shape)
        np.testing.assert_array_equal(np.asarray(nat.bins), np.asarray(ref.bins))
        assert float(nat.lat_lo) == float(ref.lat_lo)


@needs_native
def test_native_rasterize_matches_numpy():
    import icon_dvr.utils.native as native_mod
    from icon_dvr.models import accel as accel_mod
    from icon_dvr.models.cells import compute_stats

    ds = synthetic.icosphere(subdivisions=2, num_layers=3)
    stats = compute_stats(ds)
    ga_nat = accel_mod.build_grid_accel(ds, stats.world_bounds_lo,
                                        stats.world_bounds_hi, (12, 12, 12))
    # force the numpy fallback by monkeypatching
    orig = native_mod.native_rasterize
    try:
        native_mod.native_rasterize = lambda *a, **k: False
        ga_np = accel_mod.build_grid_accel(ds, stats.world_bounds_lo,
                                           stats.world_bounds_hi, (12, 12, 12))
    finally:
        native_mod.native_rasterize = orig
    np.testing.assert_array_equal(np.asarray(ga_nat.value_ranges),
                                  np.asarray(ga_np.value_ranges))


@needs_native
def test_native_crop_mask():
    ds = synthetic.latlon_section(n_lat=4, n_lon=4, lat_range=(-40, 40),
                                  lon_range=(-40, 40))
    lo, hi = np.deg2rad(-20), np.deg2rad(20)
    keep = native_crop_mask(ds.lat, ds.lon, (lo, hi), (-np.pi, np.pi))
    ref = np.all(ds.lat >= lo, axis=1) & np.all(ds.lat <= hi, axis=1)
    np.testing.assert_array_equal(keep, ref)


@needs_native
def test_native_edge_extrema_matches_numpy():
    """The C++ mirror of _edge_extrema vs the numpy oracle.  Algebraic
    results (pole flags, which edges hold an interior extremum) must be
    identical; the asin/atan2 of the extremum point may differ by 1 ulp
    (numpy routes f64 transcendentals through SVML, libm differs in the
    last bit) — harmless, since the analytic boundary itself is only
    ~1e-16 accurate and bin rectangles are derived from these values by
    wide binning."""
    from icon_dvr.models.locator import _edge_extrema

    # real mesh triangles (includes the pole-containing icosphere caps)
    ds = synthetic.icosphere(subdivisions=3, num_layers=1)
    for lat, lon in [
        (ds.lat, ds.lon),
        # random skinny triangles straddling the dateline and equator
        tuple(np.stack(a, axis=1).astype(np.float32) for a in (
            (lambda r: ((r.uniform(-1.5, 1.5, 4096),
                         r.uniform(-1.5, 1.5, 4096),
                         r.uniform(-1.5, 1.5, 4096)),
                        (r.uniform(-np.pi, np.pi, 4096),
                         r.uniform(-np.pi, np.pi, 4096),
                         r.uniform(-np.pi, np.pi, 4096))))(
                np.random.default_rng(7)))),
    ]:
        nat = _edge_extrema(lat, lon, use_native=True)
        ref = _edge_extrema(lat, lon, use_native=False)
        np.testing.assert_allclose(nat[0], ref[0], rtol=0, atol=5e-15)
        np.testing.assert_allclose(nat[1], ref[1], rtol=0, atol=5e-15)
        # lon extrema: compare as angles (atan2 at exactly +-pi may flip
        # sign between implementations)
        d = np.abs(np.asarray(nat[2]) - np.asarray(ref[2]))
        d = np.minimum(d, 2 * np.pi - d)
        assert float(d.max()) < 5e-15, float(d.max())
        np.testing.assert_array_equal(nat[3], ref[3])
