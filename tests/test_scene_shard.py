"""Scene-sharded rendering (parallel/scene_shard.py): the tables exist
ONLY sharded (each device holds one latitude slab) and the min-t
composite must statistically match the replicated-scene render.

The per-device streams are salted (independent segment trackers), so the
comparison is statistical: identical coverage (same jittered rays), and
converged-image RMSE within Monte-Carlo noise of the single-device
reference."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from icon_dvr.data import synthetic
from icon_dvr.models.cells import compute_stats
from icon_dvr.models.locator import build_locator_csr, densify_csr
from icon_dvr.models.qcells import bake_alpha_q, quantize_cells
from icon_dvr.models.shells import (build_radial_bands,
                                    update_band_majorants)
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.fastq import render_fast_q
from icon_dvr.ops.render import _finalize, alloc_frame, make_launch_params
from icon_dvr.parallel.scene_shard import (build_sharded_scene,
                                           jit_render_frame_scene_sharded,
                                           partition_dataset,
                                           shard_scene)

W = H = 24
SPP = 24


def _setup():
    ds = synthetic.icosphere(subdivisions=2, num_layers=4)
    stats = compute_stats(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range))
    cam = Camera()
    cam.set_aspect(1.0)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
    lp = make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=ud)
    return ds, stats, tf, lp


def test_partition_is_exact():
    ds = synthetic.icosphere(subdivisions=2, num_layers=2)
    parts = partition_dataset(ds, 8)
    allidx = np.sort(np.concatenate(parts))
    assert (allidx == np.arange(ds.num_cells)).all()
    assert max(len(p) for p in parts) - min(len(p) for p in parts) <= 1


def test_scene_sharded_render_matches_reference():
    ds, stats, tf, lp = _setup()
    pix = jnp.arange(W * H, dtype=jnp.int32)
    ys, xs = jnp.divmod(pix, W)
    mesh = Mesh(np.asarray(jax.devices()).reshape(-1), ("slabs",))
    assert mesh.shape["slabs"] == 8

    scene, k_cap, ds_q = build_sharded_scene(ds, tf, mesh.shape["slabs"])
    scene = shard_scene(mesh, scene)
    # the tables exist only sharded: one slab shard per device
    for leaf in (scene.test12, scene.bins, scene.value_q):
        assert len(leaf.sharding.device_set) == 8
        shard0 = next(iter(leaf.addressable_shards))
        assert shard0.data.shape[0] == 1      # one slab, not eight

    bands = update_band_majorants(build_radial_bands(ds_q, 16),
                                  tf.values, tf.value_range)

    # single-device reference: the same quantized field, replicated
    q_full = bake_alpha_q(quantize_cells(ds_q, value_range=(
        float(scene.value_lo), float(scene.value_hi))), tf)
    csr, k_full = build_locator_csr(ds_q)
    loc_full = densify_csr(csr, k_full)

    step = jit_render_frame_scene_sharded(mesh, k_cap, width=W, height=H,
                                          chunk=W * H, donate=False)

    @jax.jit
    def ref(q_, loc_, bands_, tf_, lp_s, accum, fb):
        return _finalize(*render_fast_q(q_, loc_, k_full, bands_, tf_,
                                        lp_s, xs, ys, W, H),
                         accum, fb, lp_s.accum_id)

    accum_s, fb_s = alloc_frame(W, H)
    accum_r, fb_r = alloc_frame(W, H)
    for s in range(SPP):
        lp_s = lp._replace(accum_id=jnp.int32(s))
        accum_s, fb_s = step(scene, bands, tf, lp_s, accum_s, fb_s)
        accum_r, fb_r = ref(q_full, loc_full, bands, tf, lp_s,
                            accum_r, fb_r)

    a_s = np.asarray(accum_s).reshape(H, W, 4)
    a_r = np.asarray(accum_r).reshape(H, W, 4)
    # identical rays -> identical coverage
    assert ((a_s[..., 3] > 0) == (a_r[..., 3] > 0)).all()
    cov = a_r[..., 3] > 0
    rmse = float(np.sqrt(np.mean((a_s[cov] - a_r[cov]) ** 2)))
    # independent tracking streams: converged images agree to MC noise
    assert rmse < 0.55 / np.sqrt(SPP), rmse


def test_scene_sharded_tiles_matches_slabs_only():
    """The production slabs x tiles mesh: the
    framebuffer row-sharded over 'tiles' with the argmin-select composite
    reducing over 'slabs' only must produce the SAME image as the same
    slab partition on a tiles=1 mesh — tiling is pure scheduling."""
    ds, stats, tf, lp = _setup()
    n_slabs = 2
    devs = np.asarray(jax.devices())
    mesh_t = Mesh(devs.reshape(n_slabs, 4), ("slabs", "tiles"))
    mesh_1 = Mesh(devs[:n_slabs].reshape(n_slabs, 1), ("slabs", "tiles"))

    scene, k_cap, ds_q = build_sharded_scene(ds, tf, n_slabs)
    bands = update_band_majorants(build_radial_bands(ds_q, 16),
                                  tf.values, tf.value_range)

    outs = []
    for mesh in (mesh_t, mesh_1):
        sc = shard_scene(mesh, scene)
        n_tiles = mesh.shape["tiles"]
        step = jit_render_frame_scene_sharded(
            mesh, k_cap, width=W, height=H, chunk=W * H // n_tiles,
            donate=False)
        from jax.sharding import NamedSharding, PartitionSpec as P
        accum, fb = alloc_frame(W, H)
        accum = jax.device_put(accum, NamedSharding(mesh, P("tiles", None)))
        fb = jax.device_put(fb, NamedSharding(mesh, P("tiles")))
        for s in range(3):
            accum, fb = step(sc, bands, tf,
                             lp._replace(accum_id=jnp.int32(s)), accum, fb)
        outs.append((np.asarray(accum), np.asarray(fb)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-6)
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_scene_sharded_salt_decorrelates():
    """Distinct slabs must draw distinct tracking streams (a shared
    stream would bias the min-t composite): check the salted init
    produces different RNG states per salt."""
    from icon_dvr.ops.fast import _init_lanes

    ds, stats, tf, lp = _setup()
    edges = jnp.linspace(stats.spherical_bounds_lo[0],
                         stats.spherical_bounds_hi[0], 5)
    majors = jnp.ones(4, jnp.float32)
    xs = jnp.arange(16, dtype=jnp.int32)
    ys = jnp.zeros(16, jnp.int32)
    oo = float(np.dot(np.asarray(lp.cam_org), np.asarray(lp.cam_org)))
    s1, c1, _ = _init_lanes(lp, xs, ys, W, H, edges, majors, oo, 4,
                            rng_salt=1)
    s2, c2, _ = _init_lanes(lp, xs, ys, W, H, edges, majors, oo, 4,
                            rng_salt=2)
    s0, c0, _ = _init_lanes(lp, xs, ys, W, H, edges, majors, oo, 4)
    assert (np.asarray(s1.rng) != np.asarray(s2.rng)).any()
    assert (np.asarray(s1.rng) != np.asarray(s0.rng)).any()
    # the geometric ray (jitter) is salt-independent
    np.testing.assert_array_equal(np.asarray(c1.dx), np.asarray(c2.dx))
    np.testing.assert_array_equal(np.asarray(c1.dx), np.asarray(c0.dx))
