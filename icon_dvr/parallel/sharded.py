"""Multi-chip rendering over a `jax.sharding.Mesh`.

The reference is a single-process, single-GPU renderer
(owlContextCreate(nullptr, 1), ref: common/pipeline.cu:314); scaling out is
a first-class axis of this rebuild.  Two orthogonal mesh axes:

  * "tiles"   — the framebuffer is sharded by pixel rows; each device
                renders its own tile; no communication until display
                gather.  This is the reference's one-thread-per-pixel data
                parallelism (ref: common/pipeline.cu:1064-1072) spread over
                chips.
  * "samples" — each device renders the SAME pixels at a different
                accumulation sample id; a `psum` mean composites
                the batch into the progressive average.  Semantics: for
                pixels whose rays all hit (or all miss) the volume AABB
                this equals sequential accumulation; at silhouette pixels
                the batch average weights written samples uniformly where
                the reference's running average would weight by arrival
                order — an intentional, documented difference of the
                batch-parallel mode.

The scene (cells, LUT, accel, locator) is replicated; only framebuffer
state is sharded.  All collectives go through `shard_map`; nothing else
is needed — the reference has no communication backend to port (SURVEY
§2.4).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.cells import Cells
from ..models.locator import Locator
from ..models.transfunc import Transfunc
from ..ops.fast import CHUNK
from ..ops.render import (LaunchParams, _finalize, frame_pixels_accel,
                          frame_pixels_ae)


def make_mesh(devices=None, tiles: int | None = None, samples: int = 1,
              axis_names=("tiles", "samples")) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if tiles is None:
        tiles = n // samples
    assert tiles * samples == n, f"{tiles}x{samples} != {n} devices"
    dev = np.asarray(devices).reshape(tiles, samples)
    return Mesh(dev, axis_names)


def replicate_tables(mesh: Mesh, tree):
    """Replicate a scene pytree over the mesh: every leaf is re-placed
    with NamedSharding(mesh, P()), so tables committed to one device can
    enter a mesh-jitted step."""
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, rep), tree)


def shard_frame(mesh: Mesh, accum, fb):
    """Place framebuffer state row-sharded over the 'tiles' axis."""
    sh_accum = NamedSharding(mesh, P("tiles", None))
    sh_fb = NamedSharding(mesh, P("tiles"))
    return jax.device_put(accum, sh_accum), jax.device_put(fb, sh_fb)


def render_frame_sharded(mesh: Mesh, cells: Cells, tf: Transfunc, accel,
                         lp: LaunchParams, accum, fb, *,
                         width: int, height: int,
                         accel_mode: str = "grid", sampler: str = "locator",
                         locator: Locator | None = None,
                         raygen: str = "accel",
                         packed=None, bands=None):
    """One progressive render step, framebuffer tile-sharded over 'tiles'
    and sample-sharded over 'samples' (psum composite).

    With a (T, S) mesh this performs S accumulation samples per call:
    device (t, s) renders rows-tile t at accum_id = lp.accum_id * S + s.
    raygen: 'accel' | 'ae' | 'fast' (fast needs packed + bands + locator).
    Returns (accum, fb) with the same shardings as the inputs.
    """
    n_tiles = mesh.shape["tiles"]
    n_samples = mesh.shape["samples"]
    total = width * height
    assert total % n_tiles == 0, "pixel count must divide the tiles axis"
    p_local = total // n_tiles

    def body(cells_, tf_, accel_, locator_, packed_, bands_, lp_,
             accum_local, fb_local):
        t = jax.lax.axis_index("tiles")
        s = jax.lax.axis_index("samples")
        accum_id = lp_.accum_id * n_samples + s
        lp_s = lp_._replace(accum_id=accum_id)
        pix = t * p_local + jnp.arange(p_local, dtype=jnp.int32)
        ys, xs = jnp.divmod(pix, width)
        if raygen == "fast":
            from ..ops.fast import render_fast
            wrote, ca = render_fast(cells_, packed_, locator_, bands_, lp_s,
                                    xs, ys, width, height)
        elif raygen == "ae" or accel_ is None:
            wrote, ca = frame_pixels_ae(cells_, tf_, lp_s, xs, ys,
                                        width, height, sampler, locator_)
        else:
            wrote, ca = frame_pixels_accel(cells_, tf_, accel_, lp_s, xs, ys,
                                           width, height, accel_mode,
                                           sampler, locator_)
        if n_samples > 1:
            # batch composite: average written samples
            n_wrote = jax.lax.psum(wrote.astype(jnp.float32), "samples")
            ca_sum = jax.lax.psum(jnp.where(wrote[:, None], ca, 0.0), "samples")
            wrote = n_wrote > 0.0
            ca = ca_sum / jnp.maximum(n_wrote, 1.0)[:, None]
        return _finalize(wrote, ca, accum_local, fb_local, lp_.accum_id)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(),
                  P("tiles", None), P("tiles")),
        out_specs=(P("tiles", None), P("tiles")),
        check_vma=False)
    return fn(cells, tf, accel, locator, packed, bands, lp, accum, fb)


def jit_render_frame_sharded(mesh, *, width, height, accel_mode="grid",
                             sampler="locator", raygen="accel", donate=True):
    """Jitted closure over the static configuration."""
    def step(cells, tf, accel, lp, accum, fb, locator=None,
             packed=None, bands=None):
        return render_frame_sharded(mesh, cells, tf, accel, lp, accum, fb,
                                    width=width, height=height,
                                    accel_mode=accel_mode, sampler=sampler,
                                    locator=locator, raygen=raygen,
                                    packed=packed, bands=bands)
    kw = dict(donate_argnums=(4, 5)) if donate else {}
    return jax.jit(step, **kw)


def gather_frame(fb) -> np.ndarray:
    """Collect the sharded framebuffer to the host for display
    (the one DEVICE->HOST boundary, as in ref: common/pipeline.cu:1084-1086)."""
    return np.asarray(jax.device_get(fb))


# ===========================================================================
# Fast raygen, sharded with its single-device wins intact (the naive
# row-tile sharding above gives edge devices all-background rows
# and center devices all the work).  The cost-sorted pixel permutation
# (ops/order.pixel_order) is dealt ROUND-ROBIN across the tiles axis, so
#   * every device receives the same expected-cost mix (positions t, T+t,
#     2T+t, ... of the sorted order differ by < one sort quantum), and
#   * the covered-prefix skip survives sharding — uncovered pixels are not
#     dealt at all (their rays can never write, ref: deviceCode.cu:294).
# ===========================================================================

def plan_fast_sharding(perm: np.ndarray, n_active: int, n_tiles: int,
                       chunk: int = CHUNK) -> np.ndarray:
    """Deal the covered prefix of a cost-sorted pixel permutation across
    `n_tiles` devices.  Returns (n_tiles, p_local) i32 pixel ids, -1 for
    padding lanes; p_local is a multiple of `chunk` (one compile per
    power-of-two bucket when combined with order.bucket_active)."""
    n_active = max(int(n_active), 1)
    n_proc = -(-n_active // (n_tiles * chunk)) * n_tiles * chunk
    padded = np.full(n_proc, -1, np.int32)
    padded[:n_active] = perm[:n_active]
    return np.ascontiguousarray(padded.reshape(-1, n_tiles).T)


def _fast_sharded_generic(mesh: Mesh, scene, lp: LaunchParams, accum, fb,
                          local_pix, make_runners, *, width: int,
                          chunk: int, samples: int):
    """Shared driver of the sharded fast-raygen paths (f32 AND quantized;
    render_frame_sharded only dispatches accel|ae|fast).

    scene: an arbitrary pytree of replicated device arrays.
    make_runners(scene, lp_s) -> (run_one, run_batch) where
      run_one(xs, ys) -> (wrote, color_alpha) renders one sample and
      run_batch(xs, ys, accum0, fb0) -> (accum, fb) renders `samples`
      in-lane-batched samples (may be None when samples == 1).
    """
    n_samples = mesh.shape["samples"]
    assert samples == 1 or n_samples == 1, \
        "in-lane samples need a tiles-only mesh"
    p_local = local_pix.shape[-1] if local_pix.ndim == 2 \
        else local_pix.shape[0] // mesh.shape["tiles"]

    def body(scene_, lp_, pix, accum_l, fb_l):
        s = jax.lax.axis_index("samples")
        lp_s = lp_._replace(accum_id=lp_.accum_id * n_samples + s)
        run_one, run_batch = make_runners(scene_, lp_s)

        if samples > 1:
            def run_b(pix_c, a0, f0):
                safe = jnp.maximum(pix_c, 0)
                ys, xs = jnp.divmod(safe, width)
                # padding lanes (pix < 0) render pixel 0 into their own
                # dealt slot, which scatter_fast_frame never reads
                return run_batch(xs, ys, a0, f0)

            if p_local <= chunk:
                return run_b(pix, accum_l, fb_l)
            n = p_local // chunk
            a, f = jax.lax.map(
                lambda c: run_b(c[0], c[1], c[2]),
                (pix.reshape(n, chunk), accum_l.reshape(n, chunk, 4),
                 fb_l.reshape(n, chunk)))
            return a.reshape(-1, 4), f.reshape(-1)

        def run(pix_c):
            safe = jnp.maximum(pix_c, 0)
            ys, xs = jnp.divmod(safe, width)
            wrote, ca = run_one(xs, ys)
            return wrote & (pix_c >= 0), ca

        if p_local <= chunk:
            wrote, ca = run(pix)
        else:
            n = p_local // chunk
            wrote, ca = jax.lax.map(run, pix.reshape(n, chunk))
            wrote = wrote.reshape(-1)
            ca = ca.reshape(-1, 4)
        if n_samples > 1:
            n_wrote = jax.lax.psum(wrote.astype(jnp.float32), "samples")
            ca_sum = jax.lax.psum(jnp.where(wrote[:, None], ca, 0.0),
                                  "samples")
            wrote = n_wrote > 0.0
            ca = ca_sum / jnp.maximum(n_wrote, 1.0)[:, None]
        return _finalize(wrote, ca, accum_l, fb_l, lp_.accum_id)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("tiles"), P("tiles", None), P("tiles")),
        out_specs=(P("tiles", None), P("tiles")),
        check_vma=False)
    return fn(scene, lp, jnp.asarray(local_pix).reshape(-1), accum, fb)


def render_frame_fast_sharded(mesh: Mesh, cells: Cells, packed, locator,
                              bands, lp: LaunchParams, accum, fb,
                              local_pix, *, width: int, height: int,
                              chunk: int = CHUNK, steps_per_refresh: int = 8,
                              samples: int = 1):
    """One progressive fast-raygen step over the mesh.

    local_pix: (n_tiles * p_local,) i32 flattened plan_fast_sharding output,
    sharded P('tiles').  accum (n_tiles*p_local, 4) / fb (n_tiles*p_local,)
    are in DEALT order — scatter_fast_frame restores natural pixel order on
    the host.  With a 'samples' axis of size S, device (t, s) renders its
    tile at accum_id = lp.accum_id * S + s and a psum averages the batch.

    samples > 1 traces that many sequential progressive samples per call
    via in-lane batching (ops/fast.batch_loop) on each device — same
    bit-identical-to-sequential semantics as the single-device path.
    Requires a tiles-only mesh (combining in-lane batching with the psum
    sample axis would mix two accumulation orders).
    """
    from ..ops.fast import render_fast, render_fast_batch

    def make_runners(scene_, lp_s):
        cells_, packed_, locator_, bands_ = scene_

        def run_one(xs, ys):
            return render_fast(cells_, packed_, locator_, bands_, lp_s,
                               xs, ys, width, height, steps_per_refresh)

        def run_batch(xs, ys, a0, f0):
            return render_fast_batch(cells_, packed_, locator_, bands_,
                                     lp_s, xs, ys, width, height,
                                     a0, f0, samples, steps_per_refresh)

        return run_one, run_batch

    return _fast_sharded_generic(mesh, (cells, packed, locator, bands), lp,
                                 accum, fb, local_pix, make_runners,
                                 width=width, chunk=chunk, samples=samples)


def render_frame_fastq_sharded(mesh: Mesh, q, loc, k_cap: int, bands, tf,
                               lp: LaunchParams, accum, fb, local_pix, *,
                               width: int, height: int, chunk: int = CHUNK,
                               steps_per_refresh: int = 8, samples: int = 1,
                               refresh_compact: int = 0, finemap=None):
    """One progressive QUANTIZED-tier step over the mesh — the north-star
    composition (BASELINE configs[4]: R2B9/R2B10-scale scenes, which only
    fit via the quantized tier, framebuffer tile-sharded with collective
    composite).  Same dealt-pixel contract as render_frame_fast_sharded;
    the scene (quantized tables, dense locator, radial bands, live TF, and
    optional fine map) is replicated, only framebuffer state is sharded."""
    from ..ops.fastq import render_fast_q, render_fast_q_batch

    def make_runners(scene_, lp_s):
        q_, loc_, bands_, tf_, fm_ = scene_

        def run_one(xs, ys):
            return render_fast_q(q_, loc_, k_cap, bands_, tf_, lp_s,
                                 xs, ys, width, height, steps_per_refresh,
                                 refresh_compact=refresh_compact,
                                 finemap=fm_)

        def run_batch(xs, ys, a0, f0):
            return render_fast_q_batch(q_, loc_, k_cap, bands_, tf_, lp_s,
                                       xs, ys, width, height, a0, f0,
                                       samples, steps_per_refresh,
                                       refresh_compact=refresh_compact,
                                       finemap=fm_)

        return run_one, run_batch

    return _fast_sharded_generic(mesh, (q, loc, bands, tf, finemap), lp,
                                 accum, fb, local_pix, make_runners,
                                 width=width, chunk=chunk, samples=samples)


def jit_render_frame_fastq_sharded(mesh, *, width, height, chunk=CHUNK,
                                   k_cap=16, steps_per_refresh=8, samples=1,
                                   refresh_compact=0, donate=True):
    """Jitted closure over the static configuration (quantized tier)."""
    def step(q, loc, bands, tf, lp, accum, fb, local_pix, finemap=None):
        return render_frame_fastq_sharded(
            mesh, q, loc, k_cap, bands, tf, lp, accum, fb, local_pix,
            width=width, height=height, chunk=chunk,
            steps_per_refresh=steps_per_refresh, samples=samples,
            refresh_compact=refresh_compact, finemap=finemap)
    kw = dict(donate_argnums=(5, 6)) if donate else {}
    return jax.jit(step, **kw)


def jit_render_frame_fast_sharded(mesh, *, width, height, chunk=CHUNK,
                                  steps_per_refresh=8, samples=1,
                                  donate=True):
    """Jitted closure over the static configuration."""
    def step(cells, packed, locator, bands, lp, accum, fb, local_pix):
        return render_frame_fast_sharded(
            mesh, cells, packed, locator, bands, lp, accum, fb, local_pix,
            width=width, height=height, chunk=chunk,
            steps_per_refresh=steps_per_refresh, samples=samples)
    kw = dict(donate_argnums=(5, 6)) if donate else {}
    return jax.jit(step, **kw)


def alloc_fast_sharded_frame(mesh: Mesh, local_pix):
    """Dealt-order accum/fb, tile-sharded."""
    n = int(np.prod(local_pix.shape))
    accum = jnp.zeros((n, 4), jnp.float32)
    fb = jnp.zeros((n,), jnp.uint32)
    return shard_frame(mesh, accum, fb)


def shard_local_pix(mesh: Mesh, local_pix) -> jax.Array:
    sh = NamedSharding(mesh, P("tiles"))
    return jax.device_put(jnp.asarray(local_pix).reshape(-1), sh)


def scatter_fast_frame(fb_dealt: np.ndarray, local_pix: np.ndarray,
                       width: int, height: int) -> np.ndarray:
    """Host-side: dealt-order framebuffer -> natural pixel order (background
    zero for pixels that were never dealt)."""
    out = np.zeros(width * height, fb_dealt.dtype)
    flat = np.asarray(local_pix).reshape(-1)
    m = flat >= 0
    out[flat[m]] = np.asarray(fb_dealt).reshape(-1)[m]
    return out
