"""Direct-to-quantized scene builder vs the exact path, at small scale."""
import numpy as np
import pytest
import jax.numpy as jnp

from icon_dvr.data import synthetic
from icon_dvr.data.bigscene import (build_locator_csr_from_scene,
                                    synth_quantized, to_device)
from icon_dvr.models.cells import compute_stats
from icon_dvr.models.locator import build_locator_csr, densify_csr
from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                    quantize_dataset_values)
from icon_dvr.models.shells import build_radial_bands, update_band_majorants
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.fastq import render_frame_fast_q
from icon_dvr.ops.render import alloc_frame, make_launch_params

SUBDIV, LAYERS = 2, 5


def _exact():
    ds = synthetic.icosphere(subdivisions=SUBDIV, num_layers=LAYERS)
    ds_q, lo, hi = quantize_dataset_values(ds)
    return ds, ds_q, quantize_cells(ds_q, value_range=(lo, hi))


def test_matches_exact_quantization():
    from icon_dvr.utils.layout import unpack_table

    ds, ds_q, q_exact = _exact()
    sc = synth_quantized(SUBDIV, LAYERS)
    assert sc.num_cells == ds.num_cells
    # geometry: f32 vs f64 subdivision -> tiny relative differences
    # (device tables are pack-8 rows — unpack for comparison)
    t_a = unpack_table(q_exact.test12, 12, ds.num_cells)
    t_b = sc.test12
    # q_exact.test12 is tile-padded to 16 wide; compare the 12 real columns
    np.testing.assert_allclose(t_b[:, 9:12], t_a[:, 9:12], rtol=1e-6)
    # plane normals: compare normalized directions
    for k in range(3):
        na = t_a[:, 3 * k:3 * k + 3]
        nb = t_b[:, 3 * k:3 * k + 3]
        na = na / np.linalg.norm(na, axis=1, keepdims=True)
        nb = nb / np.linalg.norm(nb, axis=1, keepdims=True)
        assert np.abs(na - nb).max() < 1e-4
    # heights: uniform spacing rows must be identical
    # q_exact.h_frac may be the deduplicated (1, Lm) shared row
    np.testing.assert_array_equal(
        sc.h_frac, np.broadcast_to(np.asarray(q_exact.h_frac),
                                   sc.h_frac.shape))
    # values: within one quantization level (f32 field eval differences)
    dv = np.abs(sc.value_q.astype(int)
                - unpack_table(q_exact.value_q, sc.h_frac.shape[1],
                               ds.num_cells).astype(int))
    assert dv.max() <= 1
    assert (dv > 0).mean() < 0.05
    assert sc.value_lo == pytest.approx(float(q_exact.value_lo), rel=1e-5)
    assert sc.value_hi == pytest.approx(float(q_exact.value_hi), rel=1e-5)


def test_band_ranges_match_exact_builder():
    ds, ds_q, _ = _exact()
    sc = synth_quantized(SUBDIV, LAYERS)
    ref = build_radial_bands(ds_q, 64)
    np.testing.assert_allclose(sc.band_edges, np.asarray(ref.edges), rtol=1e-6)
    vr_ref = np.asarray(ref.value_ranges)
    # uniform layer spacing: per-band ranges equal the per-layer global
    # ranges unioned over overlapping layers (within a quantization level)
    lvl = (sc.value_hi - sc.value_lo) / 255.0
    occupied = vr_ref[:, 0] <= vr_ref[:, 1]
    assert np.abs(sc.band_ranges[occupied] - vr_ref[occupied]).max() < lvl + 1e-6


def test_stats_cover_exact_stats():
    ds, ds_q, _ = _exact()
    sc = synth_quantized(SUBDIV, LAYERS)
    st = compute_stats(ds_q)
    np.testing.assert_allclose(sc.stats.spherical_bounds_lo[0],
                               st.spherical_bounds_lo[0], rtol=1e-6)
    np.testing.assert_allclose(sc.stats.data_range, st.data_range, atol=1e-6)
    # world bounds: sphere AABB is a superset of the exact AABB
    assert (sc.stats.world_bounds_lo <= st.world_bounds_lo + 1.0).all()
    assert (sc.stats.world_bounds_hi >= st.world_bounds_hi - 1.0).all()


def test_end_to_end_render_matches_exact_tier():
    ds, ds_q, q_exact = _exact()
    tf = make_transfunc(value_range=(float(q_exact.value_lo),
                                     float(q_exact.value_hi)), size=32)
    q_exact = bake_alpha_q(q_exact, tf)
    csr_e, k_e = build_locator_csr(ds_q)
    loc_e = densify_csr(csr_e, k_e)
    bands_e = update_band_majorants(build_radial_bands(ds_q, 16),
                                    tf.values, tf.value_range)

    sc = synth_quantized(SUBDIV, LAYERS, num_bands=16)
    q_s, bands_s = to_device(sc)
    q_s = bake_alpha_q(q_s, tf)
    bands_s = update_band_majorants(bands_s, tf.values, tf.value_range)
    loc_s, k_s = build_locator_csr_from_scene(sc)

    W = H = 40
    cam = Camera()
    cam.view_all(sc.stats.world_bounds_lo, sc.stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), sc.stats.world_bounds_lo,
                            sc.stats.world_bounds_hi, unit_distance=1e4)
    a1, f1 = alloc_frame(W, H)
    a2, f2 = alloc_frame(W, H)
    for s in range(12):
        lps = lp._replace(accum_id=jnp.int32(s))
        a1, f1 = render_frame_fast_q(q_exact, loc_e, k_e, bands_e, tf, lps,
                                     a1, f1, width=W, height=H)
        a2, f2 = render_frame_fast_q(q_s, loc_s, k_s, bands_s, tf, lps,
                                     a2, f2, width=W, height=H)
    a1, a2 = np.asarray(a1), np.asarray(a2)
    cov1, cov2 = a1[:, 3] > 0, a2[:, 3] > 0
    assert (cov1 == cov2).mean() > 0.99
    both = cov1 & cov2
    assert np.abs(a1[both] - a2[both]).mean() < 0.1
