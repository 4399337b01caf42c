"""The lane chunk is scheduling only: the fast, quantized and march
renderers give the same bits at any chunk, for a fixed accum_id, on the
app's path (cost-sorted pixels, bucketed covered prefix, compact refresh
at chunk/4)."""
import jax.numpy as jnp
import numpy as np
import pytest

from icon_dvr.data import synthetic
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.locator import (build_locator, build_locator_csr,
                                     densify_csr)
from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                    quantize_dataset_values)
from icon_dvr.models.shells import build_radial_bands, update_band_majorants
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.fast import pack_cells, render_frame_fast
from icon_dvr.ops.fastq import render_frame_fast_q
from icon_dvr.ops.march import render_frame_march_q
from icon_dvr.ops.order import bucket_active, pixel_order
from icon_dvr.ops.render import alloc_frame, make_launch_params

W, H = 48, 32


@pytest.fixture(scope="module")
def scene():
    ds = synthetic.icosphere(subdivisions=2, num_layers=5)
    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds_q, 16),
                                  tf.values, tf.value_range)
    cells = build_cells(ds_q)
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi)), tf)
    csr, k_cap = build_locator_csr(ds_q)
    cam = Camera()
    cam.set_aspect(W / H)
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    r = float(stats.spherical_bounds_hi[0])
    cam.set_orientation(center + np.array([2.0 * r, 0.4 * r, 0.9 * r],
                                          np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4,
                            accum_id=3)
    perm, n_cov = pixel_order(lp, stats.spherical_bounds_lo[0],
                              stats.spherical_bounds_hi[0], W, H)
    return dict(cells=cells, packed=pack_cells(cells, tf),
                loc=build_locator(ds_q), q=q, loc_q=densify_csr(csr, k_cap),
                k_cap=k_cap, bands=bands, tf=tf, lp=lp,
                perm=jnp.asarray(perm), n_cov=n_cov)


def _render(s, tier, chunk):
    """One launch as apps/icon_rt.py issues it; chunk 0 = one chunk over
    the bucketed covered prefix."""
    n_act = bucket_active(s["n_cov"], chunk or 64, W * H)
    chunk = chunk or n_act
    kw = dict(width=W, height=H, pixel_perm=s["perm"], n_active=n_act,
              chunk=chunk)
    frame = alloc_frame(W, H)
    if tier == "fast":
        return render_frame_fast(s["cells"], s["packed"], s["loc"],
                                 s["bands"], s["lp"], *frame, samples=4,
                                 refresh_compact=chunk // 4, **kw)
    if tier == "fastq":
        return render_frame_fast_q(s["q"], s["loc_q"], s["k_cap"],
                                   s["bands"], s["tf"], s["lp"], *frame,
                                   samples=4, refresh_compact=chunk // 4,
                                   **kw)
    return render_frame_march_q(s["q"], s["loc_q"], s["k_cap"], s["bands"],
                                s["tf"], s["lp"], *frame, **kw)


@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("tier", ["fast", "fastq", "march"])
def test_output_independent_of_chunk(scene, tier, chunk):
    acc_ref, fb_ref = _render(scene, tier, 0)
    acc, fb = _render(scene, tier, chunk)
    n = scene["n_cov"]
    assert (np.asarray(fb_ref)[:n] != 0).any()
    # the covered prefix is bit-equal; past it no ray can write
    np.testing.assert_array_equal(np.asarray(acc)[:n],
                                  np.asarray(acc_ref)[:n])
    np.testing.assert_array_equal(np.asarray(fb), np.asarray(fb_ref))
