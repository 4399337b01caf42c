"""Multi-device (8 virtual CPU) sharded rendering."""
import numpy as np
import jax
import jax.numpy as jnp

from icon_dvr.data import synthetic
from icon_dvr.models.accel import build_grid_accel, update_majorants
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.locator import build_locator
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.render import alloc_frame, make_launch_params, render_frame_accel
from icon_dvr.parallel.sharded import (gather_frame, jit_render_frame_sharded,
                                       make_mesh, shard_frame)


def _setup(W, H):
    ds = synthetic.icosphere(subdivisions=2, num_layers=4)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    ga = build_grid_accel(ds, stats.world_bounds_lo, stats.world_bounds_hi, (16, 16, 16))
    ga = update_majorants(ga, tf.values, tf.value_range)
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    return cells, loc, tf, ga, lp


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


def test_tile_sharded_matches_single_device():
    W = H = 16
    cells, loc, tf, ga, lp = _setup(W, H)

    a_ref, f_ref = render_frame_accel(cells, tf, ga, lp, *alloc_frame(W, H),
                                      width=W, height=H, accel_mode="grid",
                                      sampler="locator", locator=loc)

    mesh = make_mesh(tiles=8, samples=1)
    step = jit_render_frame_sharded(mesh, width=W, height=H, accel_mode="grid",
                                    sampler="locator", donate=False)
    accum, fb = shard_frame(mesh, *alloc_frame(W, H))
    accum, fb = step(cells, tf, ga, lp, accum, fb, loc)

    np.testing.assert_array_equal(gather_frame(fb), np.asarray(f_ref))
    np.testing.assert_array_equal(np.asarray(jax.device_get(accum)), np.asarray(a_ref))


def test_sample_sharded_composites():
    W = H = 16
    cells, loc, tf, ga, lp = _setup(W, H)

    mesh = make_mesh(tiles=2, samples=4)
    step = jit_render_frame_sharded(mesh, width=W, height=H, accel_mode="grid",
                                    sampler="locator", donate=False)
    accum, fb = shard_frame(mesh, *alloc_frame(W, H))
    accum, fb = step(cells, tf, ga, lp, accum, fb, loc)
    img = gather_frame(fb)
    assert img.shape == (W * H,)
    assert (img != 0).mean() > 0.02

    # batch of 4 samples should roughly equal 4 sequential samples
    a_seq, f_seq = alloc_frame(W, H)
    for s in range(4):
        a_seq, f_seq = render_frame_accel(cells, tf, ga,
                                          lp._replace(accum_id=jnp.int32(s)),
                                          a_seq, f_seq, width=W, height=H,
                                          accel_mode="grid", sampler="locator",
                                          locator=loc)
    a_batch = np.asarray(jax.device_get(accum))
    a_seq = np.asarray(a_seq)
    # same pixels covered; values agree within MC-batch reordering noise
    cover_b = a_batch[:, 3] > 0
    cover_s = a_seq[:, 3] > 0
    assert (cover_b == cover_s).mean() > 0.95
    both = cover_b & cover_s
    if both.sum():
        assert np.abs(a_batch[both] - a_seq[both]).mean() < 0.35


def test_fast_raygen_sharded():
    """The flagship fast raygen through the (tiles, samples) mesh."""
    from icon_dvr.models.shells import build_radial_bands, update_band_majorants
    from icon_dvr.ops.fast import pack_cells, render_frame_fast
    from icon_dvr.data import synthetic as syn

    W = H = 16
    ds = syn.icosphere(subdivisions=2, num_layers=4)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 8),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)

    a_ref, f_ref = render_frame_fast(cells, packed, loc, bands, lp,
                                     *alloc_frame(W, H), width=W, height=H)

    mesh = make_mesh(tiles=8, samples=1)
    step = jit_render_frame_sharded(mesh, width=W, height=H, raygen="fast",
                                    donate=False)
    accum, fb = shard_frame(mesh, *alloc_frame(W, H))
    accum, fb = step(cells, tf, None, lp, accum, fb, loc, packed, bands)
    np.testing.assert_array_equal(gather_frame(fb), np.asarray(f_ref))


def test_fast_sharded_cost_dealt():
    """Round-2 scheduling: the cost-sorted covered prefix is dealt
    round-robin across tiles — per-device covered counts are equal (+-1),
    per-device expected cost is near-uniform, and the image equals the
    single-device fast render exactly (per-pixel results depend only on
    pixel id + accum_id)."""
    from icon_dvr.models.shells import build_radial_bands, update_band_majorants
    from icon_dvr.ops.fast import pack_cells, render_frame_fast
    from icon_dvr.ops.order import pixel_order
    from icon_dvr.ops.render import fb_to_image
    from icon_dvr.parallel.sharded import (alloc_fast_sharded_frame,
                                           jit_render_frame_fast_sharded,
                                           plan_fast_sharding,
                                           scatter_fast_frame,
                                           shard_local_pix)
    from icon_dvr.data import synthetic as syn

    W, H = 32, 24
    ds = syn.icosphere(subdivisions=2, num_layers=4)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 8),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    cam = Camera()
    cam.set_aspect(W / H)
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    R = float(stats.spherical_bounds_hi[0])
    cam.set_orientation(center + np.array([1.8 * R, 0.3 * R, 0.7 * R], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)

    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], W, H)
    assert 0 < n_active < W * H

    T, chunk = 8, 16
    local = plan_fast_sharding(perm, n_active, T, chunk)
    assert local.shape[0] == T and local.shape[1] % chunk == 0

    # balance: covered counts equal +-1; expected chord cost near-uniform
    covered = (local >= 0).sum(axis=1)
    assert covered.max() - covered.min() <= 1
    from icon_dvr.ops.order import _chord_keys
    ys, xs = np.divmod(np.arange(W * H, dtype=np.int32), W)
    keys = np.asarray(_chord_keys(lp.cam_org, lp.cam_dir00, lp.cam_du,
                                  lp.cam_dv, jnp.float32(stats.spherical_bounds_lo[0]),
                                  jnp.float32(stats.spherical_bounds_hi[0]),
                                  jnp.asarray(xs), jnp.asarray(ys)))
    cost = np.where(local >= 0, np.where(np.isfinite(keys), keys, 0.0)
                    [np.maximum(local, 0)], 0.0).sum(axis=1)
    assert cost.min() > 0.8 * cost.max()

    mesh = make_mesh(tiles=T, samples=1)
    step = jit_render_frame_fast_sharded(mesh, width=W, height=H,
                                         chunk=chunk, donate=False)
    accum, fb = alloc_fast_sharded_frame(mesh, local)
    pix_dev = shard_local_pix(mesh, local)
    accum, fb = step(cells, packed, loc, bands, lp, accum, fb, pix_dev)
    img = scatter_fast_frame(gather_frame(fb), local, W, H)

    a_ref, f_ref = render_frame_fast(cells, packed, loc, bands, lp,
                                     *alloc_frame(W, H), width=W, height=H)
    np.testing.assert_array_equal(img, np.asarray(f_ref))


def test_fast_sharded_inlane_samples():
    """samples=S on the sharded fast path equals S sequential sharded
    steps bit-for-bit (in-lane batching under shard_map)."""
    from icon_dvr.models.shells import build_radial_bands, update_band_majorants
    from icon_dvr.ops.fast import pack_cells
    from icon_dvr.ops.order import pixel_order
    from icon_dvr.parallel.sharded import (alloc_fast_sharded_frame,
                                           jit_render_frame_fast_sharded,
                                           plan_fast_sharding,
                                           scatter_fast_frame,
                                           shard_local_pix)
    from icon_dvr.data import synthetic as syn

    W, H = 32, 24
    ds = syn.icosphere(subdivisions=2, num_layers=4)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    loc = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    bands = update_band_majorants(build_radial_bands(ds, 8),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], W, H)

    T, chunk = 8, 16
    local = plan_fast_sharding(perm, n_active, T, chunk)
    mesh = make_mesh(tiles=T, samples=1)
    pix_dev = shard_local_pix(mesh, local)

    step1 = jit_render_frame_fast_sharded(mesh, width=W, height=H,
                                          chunk=chunk, donate=False)
    a1, f1 = alloc_fast_sharded_frame(mesh, local)
    for s in range(3):
        a1, f1 = step1(cells, packed, loc, bands,
                       lp._replace(accum_id=jnp.int32(s)), a1, f1, pix_dev)

    stepS = jit_render_frame_fast_sharded(mesh, width=W, height=H,
                                          chunk=chunk, samples=3,
                                          donate=False)
    a3, f3 = alloc_fast_sharded_frame(mesh, local)
    a3, f3 = stepS(cells, packed, loc, bands,
                   lp._replace(accum_id=jnp.int32(0)), a3, f3, pix_dev)

    np.testing.assert_array_equal(
        scatter_fast_frame(gather_frame(f3), local, W, H),
        scatter_fast_frame(gather_frame(f1), local, W, H))


def _qscene(subdivisions=2, num_layers=5):
    from icon_dvr.models.locator import build_locator_csr, densify_csr
    from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                        quantize_dataset_values)
    from icon_dvr.models.shells import (build_radial_bands,
                                        update_band_majorants)
    from icon_dvr.data import synthetic as syn

    ds = syn.icosphere(subdivisions=subdivisions, num_layers=num_layers)
    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    q = bake_alpha_q(quantize_cells(ds_q), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    bands = update_band_majorants(build_radial_bands(ds_q, 16),
                                  tf.values, tf.value_range)
    return ds_q, stats, tf, q, loc, k_cap, bands


def test_fastq_sharded_matches_single_device():
    """The north-star composition: the QUANTIZED
    tier under shard_map equals the single-device quantized render
    bit-for-bit (per-pixel results depend only on pixel id + accum_id)."""
    from icon_dvr.ops.fastq import render_frame_fast_q
    from icon_dvr.ops.order import pixel_order
    from icon_dvr.parallel.sharded import (alloc_fast_sharded_frame,
                                           jit_render_frame_fastq_sharded,
                                           plan_fast_sharding,
                                           scatter_fast_frame,
                                           shard_local_pix)

    W, H = 32, 24
    ds_q, stats, tf, q, loc, k_cap, bands = _qscene()
    cam = Camera()
    cam.set_aspect(W / H)
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    R = float(stats.spherical_bounds_hi[0])
    cam.set_orientation(center + np.array([1.8 * R, 0.3 * R, 0.7 * R],
                                          np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], W, H)

    T, chunk = 8, 16
    local = plan_fast_sharding(perm, n_active, T, chunk)
    mesh = make_mesh(tiles=T, samples=1)
    from icon_dvr.parallel.sharded import replicate_tables
    q_r, loc_r = replicate_tables(mesh, (q, loc))
    step = jit_render_frame_fastq_sharded(mesh, width=W, height=H,
                                          chunk=chunk, k_cap=k_cap,
                                          donate=False)
    accum, fb = alloc_fast_sharded_frame(mesh, local)
    pix_dev = shard_local_pix(mesh, local)
    accum, fb = step(q_r, loc_r, bands, tf, lp, accum, fb, pix_dev)
    img = scatter_fast_frame(gather_frame(fb), local, W, H)

    a_ref, f_ref = render_frame_fast_q(q, loc, k_cap, bands, tf, lp,
                                       *alloc_frame(W, H), width=W, height=H)
    assert (img != 0).any()
    np.testing.assert_array_equal(img, np.asarray(f_ref))

    # ... and with the fine-map primary locate (still bit-identical)
    from icon_dvr.models.finemap import build_finemap
    fm = replicate_tables(mesh, build_finemap(loc, q.test12, k_cap))
    accum, fb = alloc_fast_sharded_frame(mesh, local)
    accum, fb = step(q_r, loc_r, bands, tf, lp, accum, fb, pix_dev,
                     finemap=fm)
    img_fm = scatter_fast_frame(gather_frame(fb), local, W, H)
    np.testing.assert_array_equal(img_fm, np.asarray(f_ref))


def test_fastq_sharded_inlane_samples():
    """Quantized tier + in-lane sample batching + shard_map: equals
    sequential sharded quantized steps bit-for-bit."""
    from icon_dvr.ops.order import pixel_order
    from icon_dvr.parallel.sharded import (alloc_fast_sharded_frame,
                                           jit_render_frame_fastq_sharded,
                                           plan_fast_sharding,
                                           scatter_fast_frame,
                                           shard_local_pix)

    W, H = 32, 24
    ds_q, stats, tf, q, loc, k_cap, bands = _qscene()
    cam = Camera()
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    cam.set_aspect(W / H)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=1e4)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], W, H)
    T, chunk = 8, 16
    local = plan_fast_sharding(perm, n_active, T, chunk)
    mesh = make_mesh(tiles=T, samples=1)
    pix_dev = shard_local_pix(mesh, local)
    from icon_dvr.parallel.sharded import replicate_tables
    q, loc = replicate_tables(mesh, (q, loc))

    step1 = jit_render_frame_fastq_sharded(mesh, width=W, height=H,
                                           chunk=chunk, k_cap=k_cap,
                                           donate=False)
    a1, f1 = alloc_fast_sharded_frame(mesh, local)
    for s in range(3):
        a1, f1 = step1(q, loc, bands, tf,
                       lp._replace(accum_id=jnp.int32(s)), a1, f1, pix_dev)

    stepS = jit_render_frame_fastq_sharded(mesh, width=W, height=H,
                                           chunk=chunk, k_cap=k_cap,
                                           samples=3, donate=False)
    a3, f3 = alloc_fast_sharded_frame(mesh, local)
    a3, f3 = stepS(q, loc, bands, tf, lp._replace(accum_id=jnp.int32(0)),
                   a3, f3, pix_dev)
    img3 = scatter_fast_frame(gather_frame(f3), local, W, H)
    img1 = scatter_fast_frame(gather_frame(f1), local, W, H)
    diff = (np.asarray(img3) != np.asarray(img1)).mean()
    assert diff <= 0.02, diff


def test_sample_axis_composite_image_rmse():
    """The samples-axis psum composite accumulates
    sample MEANS where the reference accumulates samples sequentially —
    the orders differ at silhouette pixels whose per-sample alpha
    composite is order-sensitive.  Bound how visible that actually is AT
    IMAGE LEVEL: RMSE of the presented 8-bit image (sharded 2x4 mesh,
    4-sample psum composite vs the same 4 samples sequentially on one
    device) must stay under 2/255 per channel, with identical coverage."""
    from icon_dvr.ops.render import fb_to_image

    W = H = 32
    cells, loc, tf, ga, lp = _setup(W, H)
    mesh = make_mesh(tiles=2, samples=4)
    step = jit_render_frame_sharded(mesh, width=W, height=H,
                                    accel_mode="grid", sampler="locator",
                                    donate=False)
    accum, fb = shard_frame(mesh, *alloc_frame(W, H))
    accum, fb = step(cells, tf, ga, lp, accum, fb, loc)
    img_mesh = fb_to_image(gather_frame(fb), W, H)

    a_seq, f_seq = alloc_frame(W, H)
    for s in range(4):
        a_seq, f_seq = render_frame_accel(cells, tf, ga,
                                          lp._replace(accum_id=jnp.int32(s)),
                                          a_seq, f_seq, width=W, height=H,
                                          accel_mode="grid",
                                          sampler="locator", locator=loc)
    img_seq = fb_to_image(np.asarray(f_seq), W, H)

    cover_m = img_mesh[..., 3] > 0
    cover_s = img_seq[..., 3] > 0
    np.testing.assert_array_equal(cover_m, cover_s)
    d = img_mesh.astype(np.float64) - img_seq.astype(np.float64)
    rmse = float(np.sqrt((d * d).mean()))
    assert rmse < 2.0, rmse
