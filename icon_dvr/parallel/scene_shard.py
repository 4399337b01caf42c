"""SCENE-sharded rendering: scale past one card's memory (BASELINE
configs[4] R2B10).

`parallel/sharded.py` replicates the scene and shards only framebuffer state —
at R2B9-quantized the scene is already ~11 GB, and R2B10 is ~4x that.  This
module shards the SCENE: cells are partitioned into latitude slabs (each cell
on exactly ONE device, assigned by centroid latitude at equal-count quantiles)
and every device holds only its slab's quantized tables, locator, and fine
bins.

Why the composite is exact.  Delta tracking is memoryless: tracking a
ray's disjoint sub-segments with independent streams and taking the
FIRST accepted collision is distribution-identical to tracking the whole
ray (the exponential free-flight restarts at every null collision, so
nothing carries across a segment boundary).  Device d runs the normal
wavefront tracker over the whole shell with its slab tables — points in
cells it does not own simply locate to "no cell" (a null collision,
exactly the tracker's empty-space case) — and reports its first accepted
collision parameter t_d (+inf if none).  The frame composite selects the
MINIMUM t over devices and takes that device's shaded color: the first
collision of the whole ray.  Two requirements make this unbiased:

  * cells are PARTITIONED, never duplicated (a duplicated cell would
    double its collision rate in the overlap);
  * per-device tracking streams are INDEPENDENT (ops/fast._init_lanes
    rng_salt) while the pixel-jitter stream stays shared, so every
    device traces the same geometric ray.  Correlated streams would
    bias the minimum of the per-slab collision draws.

Majorants stay global (each band's max over ALL slabs, reduced at build
time), so every device's acceptance test is conservative everywhere it
tracks.

Cost model: a device pays null-collision steps outside its slab but no
gathers (the whole design's costs are gathers); at D slabs the extra
arithmetic is bounded by the walk length, while every table shrinks ~D-
fold.  Production layout composes this axis with the framebuffer-tile
axis of parallel/sharded.py ("slabs" x "tiles" mesh).  For synthetic
giant scenes each device can SYNTHESIZE its slab in place
(data/device_scene.py is procedural), so no host ever materializes the
full R2B10 tables.

Reference analog: none — the reference is single-GPU by construction
(owlContextCreate(nullptr, 1), ref: common/pipeline.cu:314); this is the
multi-device scale-out the blueprint demands (SURVEY §2.4).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data.icfile import ICDataset
from ..models.locator import Locator, build_locator_csr, densify_csr
from ..models.qcells import QuantizedCells, bake_alpha_q, quantize_cells
from ..models.transfunc import Transfunc
from ..ops.fast import CHUNK
from ..ops.render import _finalize

F = np.float32


class ShardedScene(NamedTuple):
    """Per-slab tables stacked on a leading 'slabs' axis and padded to a
    common shape (zero cell rows never pass containment; -1 bin slots are
    the locator's empty marker).  Place with `shard_scene`."""
    test12: jnp.ndarray     # (D, R12, 128) f32 packed
    h_frac: jnp.ndarray     # (D, Rh, lm) u16
    value_q: jnp.ndarray    # (D, Rlm, 128) u8 packed
    alpha_q: jnp.ndarray    # (D, Rlm, 128) u8 packed
    value_lo: jnp.ndarray   # () f32 (global range, shared)
    value_hi: jnp.ndarray   # () f32
    alpha_max: jnp.ndarray  # (D,) f32 per-slab dequant scale
    bins: jnp.ndarray       # (D, RB, k_pack) i32 packed locator rows
    lat_lo: jnp.ndarray     # (D,) f32 per-slab locator window
    lat_hi: jnp.ndarray
    lon_lo: jnp.ndarray
    lon_hi: jnp.ndarray
    dims: jnp.ndarray       # (D, 2) i32


def partition_dataset(ds: ICDataset, n_slabs: int) -> list[np.ndarray]:
    """Equal-count latitude-quantile partition; returns per-slab cell
    index arrays (every cell in exactly one slab)."""
    clat = ds.lat.mean(axis=1)
    order = np.argsort(clat, kind="stable")
    return [np.sort(part) for part in np.array_split(order, n_slabs)]


def build_sharded_scene(ds: ICDataset, tf: Transfunc, n_slabs: int
                        ) -> tuple[ShardedScene, int, ICDataset]:
    """Host-side slab build for the CPU-mesh proof of concept (a real
    R2B10 deployment synthesizes each slab on its own device instead —
    see the module docstring).  Returns (scene, k_cap, ds_quantized);
    build the GLOBAL radial bands from ds_quantized so the majorants
    bound exactly the field the slab trackers sample."""
    import dataclasses

    from ..models.qcells import quantize_dataset_values

    ds_q, lo, hi = quantize_dataset_values(ds)
    parts = partition_dataset(ds_q, n_slabs)

    cells_l, locs_l, k_caps = [], [], []
    for idx in parts:
        sub = dataclasses.replace(
            ds_q, lat=ds_q.lat[idx], lon=ds_q.lon[idx],
            num_layers=ds_q.num_layers[idx], height=ds_q.height[idx],
            value=ds_q.value[idx])
        q = bake_alpha_q(quantize_cells(sub, value_range=(lo, hi)), tf)
        csr, k = build_locator_csr(sub)
        cells_l.append(q)
        locs_l.append(csr)
        k_caps.append(k)
    k_cap = max(k_caps)
    dense = [densify_csr(c, k_cap) for c in locs_l]

    def stack_pad(arrs, pad_value=0):
        r = max(a.shape[0] for a in arrs)
        out = []
        for a in arrs:
            a = np.asarray(a)
            if a.shape[0] < r:
                pad = np.full((r - a.shape[0],) + a.shape[1:], pad_value,
                              a.dtype)
                a = np.concatenate([a, pad], axis=0)
            out.append(a)
        return jnp.asarray(np.stack(out))

    scene = ShardedScene(
        test12=stack_pad([q.test12 for q in cells_l]),
        h_frac=stack_pad([q.h_frac for q in cells_l]),
        value_q=stack_pad([q.value_q for q in cells_l]),
        alpha_q=stack_pad([q.alpha_q for q in cells_l]),
        value_lo=jnp.float32(lo), value_hi=jnp.float32(hi),
        alpha_max=jnp.asarray([float(q.alpha_max) for q in cells_l], F),
        bins=stack_pad([l.bins for l in dense], pad_value=-1),
        lat_lo=jnp.asarray([float(l.lat_lo) for l in dense], F),
        lat_hi=jnp.asarray([float(l.lat_hi) for l in dense], F),
        lon_lo=jnp.asarray([float(l.lon_lo) for l in dense], F),
        lon_hi=jnp.asarray([float(l.lon_hi) for l in dense], F),
        dims=jnp.asarray(np.stack([np.asarray(l.dims) for l in dense])),
    )
    return scene, k_cap, ds_q


def shard_scene(mesh: Mesh, scene: ShardedScene,
                axis: str = "slabs") -> ShardedScene:
    """Distribute the stacked tables: each device holds ONLY its slab
    (leading-axis sharding; scalars replicate)."""
    def put(x):
        x = jnp.asarray(x)
        spec = P(axis) if x.ndim >= 1 and x.shape[0] == mesh.shape[axis] \
            else P()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return ShardedScene(*(put(x) for x in scene))


def _argmin_select(t, ca, axis: str):
    """First-collision composite over the slabs axis WITHOUT materializing
    a (D, L, 5) gather on every device (at the 4K configs[4] target an
    all_gather would move ~1.3 GB to every device per sample).  Three
    O(L) collectives instead:
      * pmin of the collision parameter -> the winning t everywhere,
      * pmin of (winner? device_index : D) -> the unique winner on f32
        ties (two slabs CAN report an identical +inf, and a shared-plane
        boundary can produce equal finite t),
      * psum of the winner's masked payload -> its rgba on every device.
    Value-identical to the gather+argmin composite (argmin also breaks
    ties toward the lowest index)."""
    D = jax.lax.axis_size(axis)
    t_min = jax.lax.pmin(t, axis)
    idx = jax.lax.axis_index(axis)
    cand = t == t_min
    win = jax.lax.pmin(jnp.where(cand, idx, D).astype(jnp.int32), axis)
    mine = cand & (idx == win)
    ca_out = jax.lax.psum(jnp.where(mine[:, None], ca, 0.0), axis)
    got = jnp.isfinite(t_min)
    return jnp.where(got[:, None], ca_out, jnp.zeros_like(ca_out))


def render_frame_scene_sharded(mesh: Mesh, scene: ShardedScene, k_cap: int,
                               bands, tf: Transfunc, lp, accum, fb, *,
                               width: int, height: int,
                               steps_per_refresh: int = 8,
                               chunk: int = CHUNK,
                               axis: str = "slabs",
                               tiles_axis: str | None = None):
    """One progressive sample over the scene-sharded mesh.

    Slabs-only mesh (tiles_axis None): accum (W*H, 4) / fb (W*H,) are
    replicated; every device renders the full frame against its slab and
    the argmin-select composite (three O(L) collectives, see
    _argmin_select) resolves the first collision.

    Production mesh (tiles_axis given, e.g. Mesh((slabs, tiles))): the
    framebuffer is ADDITIONALLY row-sharded over 'tiles' — device (s, t)
    renders only tile t against slab s, the composite reduces over
    'slabs' only, and accum/fb stay sharded P(tiles) (the promised
    "slabs x tiles" composition; total pixels must divide the tiles
    axis).  bands: GLOBAL radial bands (majorants reduced over all
    slabs).  Returns (accum, fb) with the input shardings."""
    from ..ops.fastq import render_fast_q

    total = width * height
    n_tiles = mesh.shape[tiles_axis] if tiles_axis else 1
    assert total % n_tiles == 0, "pixel count must divide the tiles axis"
    p_local = total // n_tiles

    def body(scene_, bands_, tf_, lp_, accum_, fb_):
        s = jax.lax.axis_index(axis)
        q = QuantizedCells(
            test12=scene_.test12[0], h_frac=scene_.h_frac[0],
            value_q=scene_.value_q[0], alpha_q=scene_.alpha_q[0],
            value_lo=scene_.value_lo, value_hi=scene_.value_hi,
            alpha_max=scene_.alpha_max[0], alpha_tab=None)
        loc = Locator(bins=scene_.bins[0], lat_lo=scene_.lat_lo[0],
                      lat_hi=scene_.lat_hi[0], lon_lo=scene_.lon_lo[0],
                      lon_hi=scene_.lon_hi[0], dims=scene_.dims[0])

        def run(pix):
            ys, xs = jnp.divmod(pix, width)
            return render_fast_q(q, loc, k_cap, bands_, tf_, lp_, xs, ys,
                                 width, height, steps_per_refresh,
                                 return_t=True, rng_salt=s + 1)

        base = (jax.lax.axis_index(tiles_axis) * p_local if tiles_axis
                else 0)
        pix = base + jnp.arange(p_local, dtype=jnp.int32)
        if p_local <= chunk:
            wrote, ca, t = run(pix)
        else:
            n = -(-p_local // chunk)
            pad = n * chunk - p_local
            if pad:
                pix = jnp.concatenate([pix, jnp.zeros(pad, jnp.int32)])
            wrote, ca, t = jax.lax.map(run, pix.reshape(n, chunk))
            wrote = wrote.reshape(-1)[:p_local]
            ca = ca.reshape(-1, 4)[:p_local]
            t = t.reshape(-1)[:p_local]

        ca_out = _argmin_select(t, ca, axis)
        # `wrote` (ray hit the shell) is slab-independent — same ray
        return _finalize(wrote, ca_out, accum_, fb_, lp_.accum_id)

    fb_spec = P(tiles_axis) if tiles_axis else P()
    accum_spec = P(tiles_axis, None) if tiles_axis else P()
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(ShardedScene(*(
            P(axis) if name not in ("value_lo", "value_hi") else P()
            for name in ShardedScene._fields)),
            P(), P(), P(), accum_spec, fb_spec),
        out_specs=(accum_spec, fb_spec),
        check_vma=False)
    return fn(scene, bands, tf, lp, accum, fb)


def jit_render_frame_scene_sharded(mesh, k_cap: int, *, width: int,
                                   height: int, steps_per_refresh: int = 8,
                                   chunk: int = CHUNK, donate: bool = True):
    """Jitted closure over the static configuration (one compile for a
    whole progressive accumulation run)."""
    import functools

    def step(scene, bands, tf, lp, accum, fb):
        return render_frame_scene_sharded(
            mesh, scene, k_cap, bands, tf, lp, accum, fb,
            width=width, height=height,
            steps_per_refresh=steps_per_refresh, chunk=chunk,
            tiles_axis="tiles" if "tiles" in mesh.shape else None)
    kw = dict(donate_argnums=(4, 5)) if donate else {}
    return jax.jit(step, **kw)
