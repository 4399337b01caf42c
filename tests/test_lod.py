"""LOD mip tiers (data/lod.py + device_scene field_lod).

Locks: (1) the parent-index rule matches the actual icosphere geometry
(every fine cell's centroid lies inside its claimed parent's spherical
triangle); (2) a field_lod tier's values are the 4:1 mean pool of the
fine tier's (in dequantized space); (3) the nearest-mip selection math;
(4) a mip tier renders end-to-end and stays statistically close to the
full-resolution render (the field is smooth, so one level of value
pooling must not move the image much)."""
import numpy as np
import pytest

from icon_dvr.data import synthetic
from icon_dvr.data.lod import (cell_edge_m, children_indices,
                               parent_index, select_lod)
from icon_dvr.utils.vecmath import np_to_cartesian


def _unit_corners(ds):
    """(N, 3, 3) unit corner vectors of an ICDataset's triangles."""
    p = np_to_cartesian(np.stack(
        [np.ones_like(ds.lat), ds.lat, ds.lon], axis=-1))
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def test_parent_rule_matches_geometry():
    fine = synthetic.icosphere(subdivisions=3, num_layers=1)
    coarse = synthetic.icosphere(subdivisions=2, num_layers=1)
    n, nc = fine.num_cells, coarse.num_cells
    assert n == 4 * nc
    fc = _unit_corners(fine)
    cc = _unit_corners(coarse)
    centroid = fc.mean(axis=1)
    centroid /= np.linalg.norm(centroid, axis=-1, keepdims=True)
    par = parent_index(np.arange(n), n)
    tri = cc[par]                                    # (N, 3, 3)
    # CCW from outside: inside iff on the inner side of all three edge
    # great circles (small tolerance: midpoint projection is not exactly
    # the spherical triangle's edge, but centroids sit well inside)
    eps = -1e-6
    for a, b in ((0, 1), (1, 2), (2, 0)):
        nrm = np.cross(tri[:, a], tri[:, b])
        assert (np.einsum("ij,ij->i", nrm, centroid) > eps).all()


def test_children_partition_parent_counts():
    n = 20 * 4 ** 3
    nc = n // 4
    seen = np.zeros(n, bool)
    for p in range(nc):
        for c in children_indices(p, nc):
            assert parent_index(c, n) == p
            seen[c] = True
    assert seen.all()


def test_field_lod_is_mean_pool_of_fine():
    from icon_dvr.data.device_scene import synth_quantized_device
    from icon_dvr.utils.layout import unpack_table

    layers = 4
    fine = synth_quantized_device(3, layers)
    mip = synth_quantized_device(2, layers, field_lod=1)
    n = 20 * 4 ** 3
    nc = n // 4

    def deq(sc, count):
        q = unpack_table(np.asarray(sc.cells.value_q), 8, count)
        lo = float(sc.cells.value_lo)
        hi = float(sc.cells.value_hi)
        return lo + q[:, :layers].astype(np.float64) * (hi - lo) / 255.0

    vf = deq(fine, n)
    vm = deq(mip, nc)
    pooled = vf.reshape(4, nc, layers).mean(axis=0)
    # two quantization grids (fine's and the mip's own) -> at most ~one
    # step of each
    step = (float(fine.cells.value_hi) - float(fine.cells.value_lo)) / 255.0
    assert np.abs(vm - pooled).max() <= 1.5 * step


def test_select_lod():
    r = 6.371229e6
    fovy = np.deg2rad(60.0)
    # closeup R2B9-ish: ~5 km footprint vs 3.4 km cells -> level 1
    org = np.array([1.16e7, 0.0, 0.0])
    assert select_lod(org, r, fovy, 1080, 11) == 1
    # same camera, R2B8 cells (6.9 km) are near footprint -> level 0
    assert select_lod(org, r, fovy, 1080, 8) == 0
    # far viewall framing at R2B9 -> multiple levels down
    far = np.array([2.6e7, 0.0, 0.0])
    assert select_lod(far, r, fovy, 1080, 11) >= 2
    # max_lod clamps
    assert select_lod(far * 100, r, fovy, 1080, 11, max_lod=3) == 3
    assert cell_edge_m(11, r) == pytest.approx(3443.0, rel=0.01)


def test_mip_tier_renders_close_to_full_res():
    """End-to-end: render subdiv-3 full-res vs its level-1 mip tier at a
    small frame; the smooth default field pools to nearly the same image."""
    import jax.numpy as jnp

    from icon_dvr.data.bigscene import (build_locator_csr_from_scene,
                                        synth_quantized)
    from icon_dvr.data.device_scene import synth_quantized_device
    from icon_dvr.models.qcells import bake_alpha_q
    from icon_dvr.models.shells import update_band_majorants
    from icon_dvr.models.transfunc import make_transfunc
    from icon_dvr.ops.camera import Camera
    from icon_dvr.ops.fastq import render_frame_fast_q
    from icon_dvr.ops.order import inverse_order, pixel_order
    from icon_dvr.ops.render import alloc_frame, make_launch_params

    W = H = 48
    spp = 8

    def render(subdiv, lod):
        dsc = synth_quantized_device(subdiv - lod, 4, field_lod=lod)
        stats = dsc.stats
        tf = make_transfunc(value_range=tuple(stats.data_range))
        q = bake_alpha_q(dsc.cells, tf)
        bands = update_band_majorants(dsc.bands, tf.values, tf.value_range)
        host = synth_quantized(subdiv - lod, 4)
        loc, k_cap = build_locator_csr_from_scene(host)
        cam = Camera()
        cam.set_aspect(1.0)
        cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
        ud = 10.0 ** (np.floor(
            np.log10(stats.spherical_bounds_lo[0])) - 3)
        lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                                stats.world_bounds_hi, unit_distance=ud)
        accum, fb = alloc_frame(W, H)
        perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                     stats.spherical_bounds_hi[0], W, H)
        inv = inverse_order(perm)
        accum, fb = render_frame_fast_q(
            q, loc, k_cap, bands, tf, lp, accum, fb, width=W, height=H,
            pixel_perm=jnp.asarray(perm), n_active=n_active,
            chunk=W * H, samples=spp)
        return np.asarray(accum)[inv].reshape(H, W, 4)

    full = render(3, 0)
    mip = render(3, 1)
    cov_f = full[..., 3] > 0
    cov_m = mip[..., 3] > 0
    # same silhouette (geometry differs only by the midpoint bulge)
    assert (cov_f == cov_m).mean() > 0.97
    both = cov_f & cov_m
    rmse = float(np.sqrt(np.mean(
        (full[both][:, :3] - mip[both][:, :3]) ** 2)))
    # subdiv 3 is the WORST case for pooling (9-degree cells, far above
    # pixel size — production selection would never pick a mip here);
    # the bound just locks that the tier renders the same scene, not
    # garbage.  The delta shrinks with cell size at the scales where
    # select_lod actually engages (subpixel cells).
    assert rmse < 0.12


def test_build_lod_dataset_general_terrain():
    """GEOMETRIC mip for file-loaded datasets: the
    builder must work on a grid WITHOUT the procedural index structure —
    simulated here by per-column terrain offsets (varying h_bot/h_top),
    which the index-arithmetic parent rule knows nothing about."""
    import dataclasses

    from icon_dvr.data.lod import build_lod_dataset, equivalent_subdiv

    ds0 = synthetic.icosphere(subdivisions=3, num_layers=6)
    rng = np.random.default_rng(7)
    shift = rng.uniform(0.0, 5e3, ds0.num_cells).astype(np.float32)
    ds = dataclasses.replace(ds0, height=ds0.height + shift[:, None])

    coarse, assign = build_lod_dataset(ds, 1)
    n = ds.num_cells
    assert equivalent_subdiv(n) == 3
    assert coarse.num_cells == 20 * 4 ** 2        # one level coarser
    # PARTITION: every fine column lands in exactly one coarse column
    assert assign.shape == (n,) and (assign >= 0).all()
    assert (assign < 20 * 4 ** 2).all()

    # CONTAINMENT: each coarse column's radial span covers its members
    idx = np.arange(n)
    h_bot_f = ds.height[:, 0]
    h_top_f = ds.height[idx, ds.num_layers]
    hb_c = coarse.height[:, 0]
    nc_idx = np.arange(coarse.num_cells)
    ht_c = coarse.height[nc_idx, coarse.num_layers]
    # assign indexes the UNFILTERED coarse grid; full sphere -> no drops
    assert (hb_c[assign] <= h_bot_f + 1e-3).all()
    assert (ht_c[assign] >= h_top_f - 1e-3).all()

    # POOLING: every coarse layer value lies within the min/max of its
    # members' values (means of member samples)
    vmin = np.full(coarse.num_cells, np.inf)
    vmax = np.full(coarse.num_cells, -np.inf)
    mask = np.arange(ds.value.shape[1])[None, :] < ds.num_layers[:, None]
    vrow_min = np.where(mask, ds.value, np.inf).min(axis=1)
    vrow_max = np.where(mask, ds.value, -np.inf).max(axis=1)
    np.minimum.at(vmin, assign, vrow_min)
    np.maximum.at(vmax, assign, vrow_max)
    lc = int(coarse.num_layers[0])
    for k in range(lc):
        v = coarse.value[:, k]
        assert (v >= vmin - 1e-5).all() and (v <= vmax + 1e-5).all()

    # RENDER smoke: the tier is a standard ICDataset — the normal
    # builders and the quantized render path apply unchanged
    from icon_dvr.models.cells import compute_stats
    from icon_dvr.models.locator import build_locator_csr, densify_csr
    from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                        quantize_dataset_values)
    from icon_dvr.models.shells import (build_radial_bands,
                                        update_band_majorants)
    from icon_dvr.models.transfunc import make_transfunc
    from icon_dvr.ops.camera import Camera
    from icon_dvr.ops.fastq import render_frame_fast_q
    from icon_dvr.ops.render import alloc_frame, make_launch_params

    ds_q, _, _ = quantize_dataset_values(coarse)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    q = bake_alpha_q(quantize_cells(ds_q), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    bands = update_band_majorants(build_radial_bands(ds_q, 8),
                                  tf.values, tf.value_range)
    Wt = Ht = 32
    cam = Camera()
    cam.set_aspect(1.0)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(Wt, Ht), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    accum, fb = render_frame_fast_q(
        q, loc, k_cap, bands, tf, lp, *alloc_frame(Wt, Ht),
        width=Wt, height=Ht, chunk=Wt * Ht)
    assert (np.asarray(fb) != 0).any()


def test_build_lod_dataset_regional():
    """Regional (non-global) datasets: empty coarse cells are dropped and
    the kept cells still partition the fine columns."""
    from icon_dvr.data.lod import build_lod_dataset

    ds = synthetic.latlon_section(n_lat=6, n_lon=10, num_layers=3)
    coarse, assign = build_lod_dataset(ds, 1)
    assert (assign >= 0).all()
    # 120 regional columns -> subdiv-0 coarse grid (20 cells), of which
    # only the cells over the patch survive the empty-cell drop
    assert 0 < coarse.num_cells < 20
