"""UElems Newton intersectors: unit geometry + oracle agreement +
wedge-mode sampler behavior."""
import numpy as np
import jax
import jax.numpy as jnp

import refimpl
from icon_dvr.data import synthetic
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.locator import build_locator
from icon_dvr.models.wedges import build_wedges, sample_wedges
from icon_dvr.ops.uelems import intersect_hex, intersect_pyramid, intersect_wedge


def _unit_wedge():
    # wedge parametrization: v0..v2 bottom (t=0), v3..v5 top (t=1)
    V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                  [0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    S = np.array([0, 1, 2, 3, 4, 5], np.float32)
    return V, S


def test_wedge_unit_element():
    V, S = _unit_wedge()
    inside, val = intersect_wedge(jnp.asarray([0.25, 0.25, 0.5]),
                                  jnp.asarray(V), jnp.asarray(S))
    assert bool(inside)
    # linear field: value = r*1 + s*2 + t*3 at (r,s,t)=(.25,.25,.5)
    assert abs(float(val) - (0.25 * 1 + 0.25 * 2 + 0.5 * 3)) < 1e-3
    outside, _ = intersect_wedge(jnp.asarray([0.9, 0.9, 0.5]),
                                 jnp.asarray(V), jnp.asarray(S))
    assert not bool(outside)  # r+s > 1
    outside2, _ = intersect_wedge(jnp.asarray([0.25, 0.25, 1.5]),
                                  jnp.asarray(V), jnp.asarray(S))
    assert not bool(outside2)


def test_pyramid_and_hex_unit_elements():
    Vh = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                   [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    Sh = Vh[:, 0] + 2 * Vh[:, 1] + 4 * Vh[:, 2]
    inside, val = intersect_hex(jnp.asarray([0.3, 0.6, 0.2]),
                                jnp.asarray(Vh), jnp.asarray(Sh))
    assert bool(inside)
    assert abs(float(val) - (0.3 + 2 * 0.6 + 4 * 0.2)) < 1e-3
    out, _ = intersect_hex(jnp.asarray([1.2, 0.5, 0.5]), jnp.asarray(Vh), jnp.asarray(Sh))
    assert not bool(out)

    Vp = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                   [0.5, 0.5, 1]], np.float32)
    Sp = np.array([0, 0, 0, 0, 10], np.float32)
    inside, val = intersect_pyramid(jnp.asarray([0.5, 0.5, 0.4]),
                                    jnp.asarray(Vp), jnp.asarray(Sp))
    assert bool(inside)
    assert abs(float(val) - 4.0) < 2e-2
    out, _ = intersect_pyramid(jnp.asarray([0.05, 0.05, 0.9]),
                               jnp.asarray(Vp), jnp.asarray(Sp))
    assert not bool(out)


def test_wedge_matches_oracle_random():
    rs = np.random.RandomState(7)
    agree = 0
    total = 0
    for _ in range(60):
        # random non-degenerate wedge: jittered unit wedge
        V, _ = _unit_wedge()
        V = (V + rs.randn(6, 3).astype(np.float32) * 0.15).astype(np.float32)
        S = rs.rand(6).astype(np.float32)
        P = rs.randn(3).astype(np.float32) * 0.8 + 0.3
        got_h, got_v = intersect_wedge(jnp.asarray(P), jnp.asarray(V), jnp.asarray(S))
        ref_h, ref_v = refimpl.intersect_wedge_ref(P, V, S)
        total += 1
        if bool(got_h) == ref_h:
            agree += 1
            if ref_h:
                np.testing.assert_allclose(float(got_v), ref_v, rtol=1e-3, atol=1e-4)
    assert agree / total > 0.95, f"{agree}/{total}"


def test_wedge_sampler_on_synthetic():
    ds = synthetic.latlon_section(n_lat=3, n_lon=4, num_layers=4,
                                  radius=100.0, thickness=30.0)
    cells = build_cells(ds)
    loc = build_locator(ds)
    wedges = build_wedges(ds)
    assert wedges.verts.shape[0] == int(ds.num_layers.sum())

    # points at layer mid-heights of column centroids must hit and return
    # the layer's bv scalar
    from icon_dvr.utils.vecmath import np_to_cartesian
    n = ds.num_cells
    hits = 0
    checked = 0
    for i in range(0, n, 3):
        for L in range(int(ds.num_layers[i])):
            mid_r = 0.5 * (ds.height[i, L] + ds.height[i, L + 1])
            sph = np.stack([np.full(3, mid_r, np.float32), ds.lat[i], ds.lon[i]], -1)
            p = np_to_cartesian(sph).mean(axis=0)
            # project toward the flat faces' radius range
            hit, val = sample_wedges(cells, wedges, loc, jnp.asarray(p))
            checked += 1
            if bool(hit):
                hits += 1
                expect = np.asarray(wedges.scalars)[int(np.asarray(wedges.cell_offset)[i]) + L, 0]
                assert abs(float(val) - expect) < 1e-5
    assert hits / checked > 0.9, f"{hits}/{checked}"
