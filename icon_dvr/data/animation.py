"""Multi-timestep animation: a time series of scalar fields on a shared
ICON grid.

The reference renders a single static field; time-animated sequences are a
target of this rebuild (BASELINE config 4: R2B9/R2B10 multi-timestep at
4K, framebuffer tile-sharded).  Design: geometry (corners, heights, planes,
locator, bands) is loaded once; each timestep only swaps the per-layer
value array, so advancing time re-bakes the packed profile rows on device
(a jitted elementwise pass) without recompiling or rebuilding any
acceleration structure.  Host->device upload of the next timestep's values
overlaps rendering via dispatch asynchrony.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .icfile import ICDataset, read_ic


class Animation:
    """values[t] on a fixed grid; construct from datasets or .ic paths."""

    def __init__(self, datasets: Sequence[ICDataset]):
        if not datasets:
            raise ValueError("empty animation")
        base = datasets[0]
        for d in datasets[1:]:
            if d.num_cells != base.num_cells \
                    or not np.array_equal(d.lat, base.lat) \
                    or not np.array_equal(d.height, base.height):
                raise ValueError("animation timesteps must share the grid")
        self.geometry = base
        self.values = np.stack([d.value for d in datasets])  # (T, N, 32)

    @classmethod
    def from_files(cls, paths: Sequence[str]) -> "Animation":
        return cls([read_ic(p) for p in paths])

    @property
    def num_timesteps(self) -> int:
        return self.values.shape[0]

    def dataset_at(self, t: int) -> ICDataset:
        g = self.geometry
        return ICDataset(g.lat, g.lon, g.num_layers, g.height, self.values[t])


def animate_fast_sharded(anim: Animation, cells, locator, bands, tf,
                         lp_for_frame, mesh, width: int, height: int,
                         samples_per_frame: int = 4, chunk: int = 4096
                         ) -> Iterator[np.ndarray]:
    """Render the time series over a device mesh (BASELINE configs[4]:
    multi-timestep sequence, framebuffer tile-sharded, collective
    composite).  Per timestep: swap the value plane, re-bake the packed
    profile rows (replicated), re-deal the covered pixel prefix for the
    timestep's camera, render samples_per_frame progressive samples on
    every tile device, gather + scatter to natural pixel order.  Yields
    one (H*W,) uint32 framebuffer per timestep."""
    import jax
    from ..models.cells import compute_stats
    from ..ops.fast import PackedCells, pack_test_rows, pack_profile_rows
    from ..ops.order import pixel_order
    from ..parallel.sharded import (alloc_fast_sharded_frame,
                                    jit_render_frame_fast_sharded,
                                    plan_fast_sharding, scatter_fast_frame,
                                    shard_local_pix)

    stats = compute_stats(anim.geometry)
    n_tiles = mesh.shape["tiles"]
    step = jit_render_frame_fast_sharded(mesh, width=width, height=height,
                                         chunk=chunk, donate=False)
    test_rows = pack_test_rows(cells)
    next_vals = jnp.asarray(anim.values[0])
    for t in range(anim.num_timesteps):
        cells_t = cells._replace(value=next_vals)
        prof_t, rgb_t = pack_profile_rows(cells_t, tf)
        packed = PackedCells(test=test_rows, prof=prof_t, rgb=rgb_t)
        if t + 1 < anim.num_timesteps:
            next_vals = jnp.asarray(anim.values[t + 1])  # overlap upload
        lp0 = lp_for_frame(t, 0)
        perm, n_active = pixel_order(lp0, stats.spherical_bounds_lo[0],
                                     stats.spherical_bounds_hi[0],
                                     width, height)
        local = plan_fast_sharding(perm, n_active, n_tiles, chunk=chunk)
        local_dev = shard_local_pix(mesh, local)
        accum, fb = alloc_fast_sharded_frame(mesh, local)
        for s in range(samples_per_frame):
            accum, fb = step(cells_t, packed, locator, bands,
                             lp_for_frame(t, s), accum, fb, local_dev)
        yield scatter_fast_frame(np.asarray(jax.device_get(fb)), local,
                                 width, height)


def animate_fastq_sharded(geometry_q, value_q_steps, loc, k_cap: int,
                          bands, tf, lp_for_frame, mesh, stats,
                          width: int, height: int,
                          samples_per_frame: int = 4, chunk: int = 4096,
                          finemap=None) -> Iterator[np.ndarray]:
    """QUANTIZED time series over a device mesh — the full north-star
    composition (BASELINE configs[4]: R2B9/R2B10-scale scenes only fit the
    chip through the quantized tier; time-animated; tile-sharded fb;
    collective composite; ref analog: the accel the renderer uses is built
    where it runs, hostCode.cu:639-645).

    geometry_q: models/qcells.QuantizedCells whose value_q/alpha_q planes
    are re-baked per timestep.  value_q_steps: (T, N, Lm) u8 host array (or
    sequence of (N, Lm) u8).  Geometry, locator and radial bands are
    timestep-invariant (ICON grids are static; only the field animates)."""
    import jax
    from ..models.qcells import bake_alpha_q
    from ..ops.order import pixel_order
    from ..parallel.sharded import (alloc_fast_sharded_frame,
                                    jit_render_frame_fastq_sharded,
                                    plan_fast_sharding, replicate_tables,
                                    scatter_fast_frame, shard_local_pix)
    from ..utils.layout import pack_table

    n_tiles = mesh.shape["tiles"]
    loc_r, bands_r, tf_r = replicate_tables(mesh, (loc, bands, tf))
    # the fine map is geometry-only (candidate COLUMN ids), so one build
    # serves every timestep of the value animation
    fm_r = None if finemap is None else replicate_tables(mesh, finemap)
    step = jit_render_frame_fastq_sharded(mesh, width=width, height=height,
                                          chunk=chunk, k_cap=k_cap,
                                          donate=False)
    for t in range(len(value_q_steps)):
        vq_host = np.asarray(value_q_steps[t])
        # alpha_tab=None: the values changed, so bake_alpha_q's
        # unchanged-table fast path must not reuse the stale alpha_q
        q_t = geometry_q._replace(value_q=jax.device_put(pack_table(vq_host)),
                                  alpha_tab=None)
        # bake on the single-device tf, then replicate the result
        q_t = replicate_tables(mesh, bake_alpha_q(q_t, tf))
        lp0 = lp_for_frame(t, 0)
        perm, n_active = pixel_order(lp0, stats.spherical_bounds_lo[0],
                                     stats.spherical_bounds_hi[0],
                                     width, height)
        local = plan_fast_sharding(perm, n_active, n_tiles, chunk=chunk)
        local_dev = shard_local_pix(mesh, local)
        accum, fb = alloc_fast_sharded_frame(mesh, local)
        for s in range(samples_per_frame):
            accum, fb = step(q_t, loc_r, bands_r, tf_r, lp_for_frame(t, s),
                             accum, fb, local_dev, finemap=fm_r)
        yield scatter_fast_frame(np.asarray(jax.device_get(fb)), local,
                                 width, height)


def animate_fast(anim: Animation, cells, locator, bands, tf, lp_for_frame,
                 width: int, height: int, samples_per_frame: int = 4
                 ) -> Iterator[np.ndarray]:
    """Render the time series on the fast path; yields one packed (H*W,)
    uint32 framebuffer per timestep.

    cells/locator/bands are built from anim.geometry; tf is the device
    transfer function; lp_for_frame(t, s) returns LaunchParams for
    timestep t, sample s (the camera may move per timestep).
    """
    from ..ops.fast import PackedCells, pack_test_rows, pack_profile_rows, \
        render_frame_fast
    from ..ops.render import alloc_frame

    test_rows = pack_test_rows(cells)
    next_vals = jnp.asarray(anim.values[0])
    for t in range(anim.num_timesteps):
        cells_t = cells._replace(value=next_vals)
        prof_t, rgb_t = pack_profile_rows(cells_t, tf)
        packed = PackedCells(test=test_rows, prof=prof_t, rgb=rgb_t)
        if t + 1 < anim.num_timesteps:
            # start the next upload while this timestep renders
            next_vals = jnp.asarray(anim.values[t + 1])
        accum, fb = alloc_frame(width, height)
        for s in range(samples_per_frame):
            accum, fb = render_frame_fast(cells_t, packed, locator, bands,
                                          lp_for_frame(t, s), accum, fb,
                                          width=width, height=height)
        yield np.asarray(fb)
