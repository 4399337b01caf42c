import numpy as np

from icon_dvr.data import icfile, synthetic
from icon_dvr.models.cells import build_cells, compute_stats, sample_one_cell

import jax.numpy as jnp


def test_ic_record_layout():
    assert icfile.IC_DTYPE.itemsize == 284  # ref struct ICONCell size


def test_ic_roundtrip(tmp_path):
    ds = synthetic.latlon_section(n_lat=2, n_lon=3, num_layers=3)
    p = str(tmp_path / "t.ic")
    icfile.write_ic(p, ds)
    ds2 = icfile.read_ic(p)
    assert ds2.num_cells == ds.num_cells
    np.testing.assert_array_equal(ds2.lat, ds.lat)
    np.testing.assert_array_equal(ds2.height, ds.height)
    np.testing.assert_array_equal(ds2.num_layers, ds.num_layers)
    # partial read (--num-cells)
    ds3 = icfile.read_ic(p, max_num_cells=4)
    assert ds3.num_cells == 4


def test_crop():
    ds = synthetic.latlon_section(n_lat=4, n_lon=4, lat_range=(-40, 40), lon_range=(-40, 40))
    n_all = ds.num_cells
    dsc = ds.crop(lat_range=(-20, 20))
    assert 0 < dsc.num_cells < n_all
    assert np.all(dsc.lat >= np.deg2rad(-20) - 1e-6)
    assert np.all(dsc.lat <= np.deg2rad(20) + 1e-6)


def test_single_cell_matches_reference_values():
    ds = synthetic.single_cell()
    assert ds.num_layers[0] == 2
    assert ds.height[0, 2] == np.float32(120.0)
    assert ds.value[0, 1] == np.float32(1.0)


def test_icosphere_counts():
    ds = synthetic.icosphere(subdivisions=1, num_layers=2)
    assert ds.num_cells == 80


def test_synthetic_cells_sample_inside():
    """Prism centroids must sample inside their own cell with the CCW plane
    convention, for both generators."""
    for ds in (synthetic.latlon_section(n_lat=3, n_lon=4, num_layers=3),
               synthetic.icosphere(subdivisions=1, num_layers=2),
               synthetic.single_cell()):
        cells = build_cells(ds)
        n = ds.num_cells
        from icon_dvr.utils.vecmath import np_to_cartesian
        mid_r = 0.5 * (ds.height[:, 0] + ds.height[np.arange(n), ds.num_layers])
        # centroid of the triangle at mid height
        sphs = np.stack([np.repeat(mid_r[:, None], 3, 1), ds.lat, ds.lon], axis=-1)
        pts = np_to_cartesian(sphs).mean(axis=1)
        # pull centroid onto the mid radius (flat triangle sits below the arc)
        pr = np.sqrt(np.sum(pts * pts, axis=-1))
        pts = pts * (mid_r / pr)[:, None]
        inside = []
        for i in range(n):
            pos = jnp.asarray(pts[i], jnp.float32)
            r = jnp.sqrt(jnp.sum(pos * pos))
            ok, val = sample_one_cell(cells, jnp.int32(i), pos, r)
            inside.append(bool(ok))
        assert np.mean(inside) > 0.95, f"{np.mean(inside)} of centroids inside"


def test_stats():
    ds = synthetic.single_cell()
    st = compute_stats(ds)
    assert st.spherical_bounds_lo[0] == np.float32(100.0)
    assert st.spherical_bounds_hi[0] == np.float32(120.0)
    assert st.data_range.tolist() == [np.float32(0.1), np.float32(1.0)]
    assert np.all(st.world_bounds_lo < st.world_bounds_hi)
