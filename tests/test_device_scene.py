"""Device-side scene generation vs the host builder (data/device_scene.py).

The device generator must reproduce bigscene.synth_quantized's tables up
to floating-point transcendental differences (geometry ~1 ulp -> u8
levels occasionally +-1), and its derived aggregates must be
self-consistent with its own tables (majorant conservativeness)."""
import numpy as np
import pytest

from icon_dvr.data.bigscene import synth_quantized
from icon_dvr.data.device_scene import synth_quantized_device
from icon_dvr.utils.layout import unpack_table

SUBDIV, LAYERS = 3, 6
N = 20 * 4 ** SUBDIV


@pytest.fixture(scope="module")
def pair():
    sc = synth_quantized(SUBDIV, LAYERS)
    dsc = synth_quantized_device(SUBDIV, LAYERS, chunk_cells=512)
    return sc, dsc


def test_geometry_matches(pair):
    sc, dsc = pair
    t_dev = unpack_table(dsc.cells.test12, 12, N)
    # plane normals: same construction, f32 transcendental slack
    np.testing.assert_allclose(t_dev[:, :9], sc.test12[:, :9],
                               rtol=2e-5, atol=2e-2 * np.abs(
                                   sc.test12[:, :9]).max())
    # h_bot / h_top / num_layers exact
    np.testing.assert_array_equal(t_dev[:, 9:12], sc.test12[:, 9:12])
    assert (t_dev[:, 12:] == 0).all()


def test_values_match_within_one_level(pair):
    sc, dsc = pair
    lm = sc.h_frac.shape[1]
    v_dev = unpack_table(dsc.cells.value_q, lm, N)
    dv = np.abs(v_dev.astype(int) - sc.value_q.astype(int))
    assert dv.max() <= 1
    assert (dv > 0).mean() < 0.05
    assert float(dsc.cells.value_lo) == pytest.approx(sc.value_lo, rel=1e-5)
    assert float(dsc.cells.value_hi) == pytest.approx(sc.value_hi, rel=1e-5)


def test_h_frac_and_stats(pair):
    sc, dsc = pair
    np.testing.assert_array_equal(np.asarray(dsc.cells.h_frac),
                                  sc.h_frac[:1])
    np.testing.assert_allclose(dsc.stats.world_bounds_hi,
                               sc.stats.world_bounds_hi, rtol=1e-5)
    np.testing.assert_allclose(dsc.stats.spherical_bounds_lo,
                               sc.stats.spherical_bounds_lo, rtol=1e-5)
    np.testing.assert_allclose(dsc.stats.data_range, sc.stats.data_range,
                               rtol=1e-5)


def test_band_ranges_conservative_for_device_tables(pair):
    """Every cell layer's dequantized value must fall inside the band
    range of every radial band the layer overlaps — the invariant the
    Woodcock majorants depend on."""
    sc, dsc = pair
    lm = sc.h_frac.shape[1]
    v_dev = unpack_table(dsc.cells.value_q, lm, N).astype(np.float64)
    lo = float(dsc.cells.value_lo)
    hi = float(dsc.cells.value_hi)
    vals = lo + v_dev[:, :LAYERS] * (hi - lo) / 255.0
    edges = np.asarray(dsc.bands.edges)
    vr = np.asarray(dsc.bands.value_ranges)
    h_bot = float(sc.stats.spherical_bounds_lo[0])
    h_top = float(sc.stats.spherical_bounds_hi[0])
    layer_h = (h_top - h_bot) / LAYERS
    for j in range(LAYERS):
        r0 = h_bot + j * layer_h
        r1 = h_bot + (j + 1) * layer_h
        b0 = np.searchsorted(edges, r0, side="right") - 1
        b1 = np.searchsorted(edges, r1, side="left") - 1
        b0 = np.clip(b0, 0, vr.shape[0] - 1)
        b1 = np.clip(b1, 0, vr.shape[0] - 1)
        lo_j = vals[:, j].min()
        hi_j = vals[:, j].max()
        for b in range(b0, b1 + 1):
            assert vr[b, 0] <= lo_j + 1e-6
            assert vr[b, 1] >= hi_j - 1e-6


def test_band_ranges_match_host(pair):
    sc, dsc = pair
    lvl = (float(dsc.cells.value_hi) - float(dsc.cells.value_lo)) / 255.0
    np.testing.assert_allclose(np.asarray(dsc.bands.edges), sc.band_edges,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(dsc.bands.value_ranges),
                               sc.band_ranges, atol=1.5 * lvl)


def test_pad_rows_zero():
    """A 20-cell scene (subdiv 0) pads up to the pack granularity with
    all-zero rows."""
    dsc = synth_quantized_device(0, 4)
    lm = dsc.cells.h_frac.shape[1]
    t = unpack_table(dsc.cells.test12, 12)
    v = unpack_table(dsc.cells.value_q, lm)
    assert t.shape[0] >= 20 and (t[20:] == 0).all()
    assert (v[20:] == 0).all()
    assert (t[:20, 9] != 0).all()          # real rows carry h_bot


def test_renders_like_host_scene(pair):
    """End-to-end: the quantized fast path renders the device-built scene
    to (nearly) the same image as the host-built one."""
    import jax.numpy as jnp

    from icon_dvr.data.bigscene import (build_locator_csr_from_scene,
                                        to_device)
    from icon_dvr.models.qcells import bake_alpha_q
    from icon_dvr.models.shells import update_band_majorants
    from icon_dvr.models.transfunc import make_transfunc
    from icon_dvr.ops.camera import Camera
    from icon_dvr.ops.fastq import render_frame_fast_q
    from icon_dvr.ops.render import alloc_frame, make_launch_params

    sc, dsc = pair
    W = H = 32
    tf = make_transfunc(value_range=tuple(sc.stats.data_range))
    loc, k_cap = build_locator_csr_from_scene(sc)
    cam = Camera()
    cam.set_aspect(W / H)
    stats = sc.stats
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    r = float(stats.spherical_bounds_hi[0])
    cam.set_orientation(center + np.array([2.2, 0.4, 0.9], np.float32)
                        * r, center, np.array([0, 0, 1], np.float32),
                        cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)

    imgs = []
    for scene_q, scene_bands in (
            to_device(sc) + (),
            (dsc.cells, dsc.bands)):
        q = bake_alpha_q(scene_q, tf)
        bands = update_band_majorants(scene_bands, tf.values,
                                      tf.value_range)
        accum, fb = alloc_frame(W, H)
        for s in range(4):
            accum, fb = render_frame_fast_q(
                q, loc, k_cap, bands, tf,
                lp._replace(accum_id=jnp.int32(s)), accum, fb,
                width=W, height=H)
        imgs.append(np.asarray(accum).reshape(H, W, 4))
    a, b = imgs
    cov_a = a[..., 3] > 0
    cov_b = b[..., 3] > 0
    assert cov_a.any()
    assert (cov_a == cov_b).mean() > 0.98
    both = cov_a & cov_b
    assert np.abs(a[both] - b[both]).mean() < 0.05
