#!/usr/bin/env python
"""Benchmark harness: sustained ray throughput of the flagship render path.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mray/s", "vs_baseline": N}

The reference publishes no numbers (BASELINE.md); vs_baseline is measured
against BASELINE.json's north star of 1 Gray/s per chip (= 1000 Mray/s).

Framing rules: the headline row uses a
CLOSEUP camera whose globe covers >= 0.5 of the 1920x1080 frame, at the
largest scale that fits the chip, and the metric string carries one row
per scale (R2B4/R2B7/R2B8/...) plus a reference-default `view_all` framing
row (ref: hostCode.cu:819-821 -- note view_all at 16:9 covers only ~4% of
the frame, which is why it is not the headline).  Both FULL-FRAME Mray/s
(all W*H pixels / wall time, the north-star denomination) and TRACED
Mray/s (rays actually entering the tracking loop after the covered-prefix
skip) are reported.

Every timed window ends with a host read of the framebuffer, so a window
covers the device work it launched.

Each group of rows runs in a child process (`bench.py --row NAMES`) that
requires a GPU and prints the device it ran on with every row; the parent
never initializes a JAX backend, so one process holds the card at a time.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from icon_dvr.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from icon_dvr.data import synthetic  # noqa: E402
from icon_dvr.models.cells import build_cells, compute_stats  # noqa: E402
from icon_dvr.models.locator import build_locator  # noqa: E402
from icon_dvr.models.shells import (build_radial_bands,  # noqa: E402
                                    update_band_majorants)
from icon_dvr.models.transfunc import make_transfunc  # noqa: E402
from icon_dvr.ops.camera import Camera  # noqa: E402
from icon_dvr.ops.fast import (CHUNK, pack_cells,  # noqa: E402
                               render_frame_fast)
from icon_dvr.ops.order import inverse_order, pixel_order  # noqa: E402
from icon_dvr.ops.render import alloc_frame, make_launch_params  # noqa: E402

WIDTH, HEIGHT = 1920, 1080

#: filled row by row; the watchdog prints whatever completed before dying
RESULTS: dict = {}


def _emit(note: str = ""):
    head = RESULTS.get(HEADLINE) or (list(RESULTS.values())[-1]
                                     if RESULTS else None)
    def _row(name, r):
        # low-coverage rows (e.g. viewall at ~4%) lead with TRACED so the
        # flattering full-frame denominator can't be quoted alone
        full = f"{r['mray_full']} full"
        traced = f"{r['mray_traced']} traced"
        rate = (f"{traced} / {full}" if r["coverage"] < 0.25
                else f"{full} / {traced}")
        stroke = (f" (stroke {r['tf_stroke_s']}s)"
                  if "tf_stroke_s" in r else "")
        if "tf_preview_s" in r:
            stroke += f" (preview {r['tf_preview_s']}s)"
        if "rmse_q" in r:
            stroke += f" (rmse_q {r['rmse_q']})"
        fps1 = (f", {r['fps1']} frames/s@1spp" if "fps1" in r else "")
        return (f"{name}[{r['cells']}c,{r['framing']},cov={r['coverage']}]: "
                f"{rate} Mray/s (spread {r.get('spread', -1)}), "
                f"{r['fps']} samples/s{fps1}, tf-edit {r['tf_edit_s']}s"
                f"{stroke}")
    desc = "; ".join(_row(name, r) for name, r in RESULTS.items())
    if note:
        desc = f"{note}; {desc}"
    print(json.dumps({
        "metric": f"Mray/s full-frame, {WIDTH}x{HEIGHT} fast raygen "
                  f"(radial-band Woodcock + column cache), headline="
                  f"{HEADLINE}; {desc}",
        "value": head["mray_full"] if head else 0.0,
        "unit": "Mray/s",
        "vs_baseline": round((head["mray_full"] if head else 0.0) / 1000.0, 4),
    }), flush=True)


def _install_watchdog(budget_s: int):
    """On the budget alarm or a SIGTERM from the caller's time limit, emit
    the rows that DID complete instead of dying silently."""
    import signal

    def on_alarm(signum, frame):
        _emit(note="BENCH WATCHDOG fired mid-run (a row overran)")
        os._exit(2 if not RESULTS else 0)

    def on_term(signum, frame):
        _emit(note="BENCH interrupted by SIGTERM; rows below completed "
                   "before it")
        os._exit(2 if not RESULTS else 0)

    signal.signal(signal.SIGALRM, on_alarm)
    signal.signal(signal.SIGTERM, on_term)
    signal.alarm(budget_s)


def _median_windows(step, accum, fb, iters: int, spp: int, inv,
                    windows: int = 3):
    """Timed measurement as `windows` independent windows of `iters` calls;
    returns (median seconds per window, relative spread, coverage, accum,
    fb).  The median with a reported spread makes run-to-run deltas
    readable.  Each window ends with a host read of the framebuffer
    (np.asarray), so it covers the device work it launched."""
    times = []
    cov = 0.0
    k = 1  # sample id 0 was the warmup call
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            accum, fb = step(k * spp, accum, fb)
            k += 1
        cov = float((np.asarray(fb)[inv] != 0).mean())  # validate + sync
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    spread = float((max(times) - min(times)) / max(med, 1e-9))
    return med, spread, cov, accum, fb


def _build_scene(subdiv: int, num_layers: int):
    ds = synthetic.icosphere(subdivisions=subdiv, num_layers=num_layers)
    stats = compute_stats(ds)
    cells = build_cells(ds)
    locator = build_locator(ds)
    tf = make_transfunc(value_range=tuple(stats.data_range))
    bands = update_band_majorants(build_radial_bands(ds, 64),
                                  tf.values, tf.value_range)
    packed = pack_cells(cells, tf)
    return ds, stats, cells, locator, tf, bands, packed


def _auto_lod(subdiv: int, framing: str) -> int:
    """Nearest-mip level for a bench framing (data/lod.py), computed from
    the ANALYTIC synthetic-scene bounds so the tier is known before any
    table is built.  The closeup framing is pixel-matched at every scale
    (cells >= pixel footprint -> 0); viewall at R2B9 selects level 3."""
    from icon_dvr.data.lod import select_lod
    r_out = float(synthetic.EARTH_RADIUS) + 3.0e4
    rb = r_out * 1.02

    class _St:
        world_bounds_lo = np.array([-rb] * 3, np.float32)
        world_bounds_hi = np.array([rb] * 3, np.float32)
        spherical_bounds_lo = np.array([r_out - 3.0e4, 0, 0], np.float32)
        spherical_bounds_hi = np.array([r_out, 0, 0], np.float32)
    cam = _camera(_St, framing)
    return select_lod(cam.position, r_out, float(cam.fovy), HEIGHT, subdiv)


def _camera(stats, framing: str) -> Camera:
    cam = Camera()
    cam.set_aspect(WIDTH / HEIGHT)
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    r_out = float(stats.spherical_bounds_hi[0])
    if framing == "viewall":
        # the reference's default framing (ref: hostCode.cu:819-821)
        cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    else:
        # closeup: globe slightly overfills the frame vertically ->
        # ~0.55 pixel coverage at 16:9 (the honest headline framing)
        theta = np.arctan(1.15 * np.tan(0.5 * cam.fovy))
        d = r_out / np.sin(theta)
        direction = np.array([2.2, 0.4, 0.9], np.float32)
        direction /= np.linalg.norm(direction)
        cam.set_orientation(center + direction * d, center,
                            np.array([0, 0, 1], np.float32), cam.fovy)
    return cam


def bench_row(subdiv: int, num_layers: int, iters: int, framing: str,
              chunk: int, spr: int, spp: int) -> dict:
    ds, stats, cells, locator, tf, bands, packed = _build_scene(
        subdiv, num_layers)
    cam = _camera(stats, framing)
    unit_distance = 10.0 ** (np.floor(
        np.log10(stats.spherical_bounds_lo[0])) - 3)
    lp = make_launch_params(cam.basis(WIDTH, HEIGHT), stats.world_bounds_lo,
                            stats.world_bounds_hi,
                            unit_distance=unit_distance)
    accum, fb = alloc_frame(WIDTH, HEIGHT)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], WIDTH, HEIGHT)
    inv = inverse_order(perm)
    perm = jnp.asarray(perm)
    total = WIDTH * HEIGHT
    n_traced = min(total, -(-max(n_active, 1) // chunk) * chunk)

    compact = int(os.environ.get("BENCH_COMPACT", "2048"))
    scap = int(os.environ.get("BENCH_SERVICE_CAP", "-1"))  # -1 auto flat
    fm = None
    fm_factor = int(os.environ.get("BENCH_FINEMAP_F32", "0"))
    if fm_factor > 0:
        from icon_dvr.models.finemap import build_finemap, normals_table
        fm = build_finemap(locator, normals_table(cells.planes),
                           int(locator.bins.shape[1]), factor=fm_factor)

    def step1(s, accum, fb):
        return render_frame_fast(cells, packed, locator, bands,
                                 lp._replace(accum_id=jnp.int32(s)),
                                 accum, fb, width=WIDTH, height=HEIGHT,
                                 pixel_perm=perm, n_active=n_active,
                                 chunk=chunk, steps_per_refresh=spr,
                                 samples=1, refresh_compact=compact,
                                 finemap=fm, service_cap=scap)

    def step(s, accum, fb):
        # spp progressive samples per call via in-lane batching — the
        # default cache-preserving batch differs from spp sequential
        # samples=1 calls only on f32 boundary ties (tested tie-rare), so
        # the per-SAMPLE throughput below is the honest progressive rate
        return render_frame_fast(cells, packed, locator, bands,
                                 lp._replace(accum_id=jnp.int32(s)),
                                 accum, fb, width=WIDTH, height=HEIGHT,
                                 pixel_perm=perm, n_active=n_active,
                                 chunk=chunk, steps_per_refresh=spr,
                                 samples=spp, refresh_compact=compact,
                                 finemap=fm, service_cap=scap)

    accum, fb = step(0, accum, fb)
    float((np.asarray(fb)[inv] != 0).mean())  # warm + sync

    dt, spread, cov, accum, fb = _median_windows(step, accum, fb, iters,
                                                 spp, inv)
    iters = iters * spp   # samples rendered per timed window

    # One PRESENTED frame at samples=1 — what BASELINE configs[3]'s
    # ">=30 fps" denominates: the wall of one full-frame progressive step
    # that adds ONE sample per pixel, the unit an interactive session
    # presents (ref pipeline.cu:1038-1077 launches exactly one
    # accumulation step per present).
    accum, fb = step1(9000, accum, fb)
    np.asarray(fb)  # warm the samples=1 executable
    t1s = []
    for j in range(3):
        t0 = time.perf_counter()
        accum, fb = step1(9001 + j, accum, fb)
        np.asarray(fb)
        t1s.append(time.perf_counter() - t0)
    fps1 = 1.0 / float(np.median(t1s))

    # TF-edit latency (BASELINE configs[3] is fps UNDER live TF edits):
    # edit -> majorant update -> alpha re-derive -> FIRST PRESENTED
    # progressive sample (a samples=1 frame — what a real session shows
    # right after an edit).
    # A pure opacity-scale drag rides the production affine fast path
    # (apps/icon_rt.py on_tf_update scale_only): the baked alpha is
    # affine in the scale, so the edit is one FMA over (N, 32) instead
    # of a full classify re-bake — the same cost profile as the
    # reference, whose scale is a postClassify uniform.
    from icon_dvr.ops.fast import (apply_opacity_scale,
                                   pack_alpha_scale_parts)
    parts = jax.block_until_ready(pack_alpha_scale_parts(cells, tf))

    def tf_edit(scale):
        tf2 = tf._replace(opacity_scale=jnp.float32(scale))
        bands2 = update_band_majorants(bands, tf2.values, tf2.value_range)
        packed2 = apply_opacity_scale(packed, parts, scale)
        a2, f2 = render_frame_fast(cells, packed2, locator, bands2,
                                   lp._replace(accum_id=jnp.int32(0)),
                                   *alloc_frame(WIDTH, HEIGHT),
                                   width=WIDTH, height=HEIGHT,
                                   pixel_perm=perm, n_active=n_active,
                                   chunk=chunk, steps_per_refresh=spr,
                                   samples=1, refresh_compact=compact,
                                   finemap=fm, service_cap=scap)
        np.asarray(f2)  # materialize: edit-to-PRESENTED-frame

    tf_edit(0.9)  # warm the edit path's compiled artifacts
    t0 = time.perf_counter()
    tf_edit(0.8)
    dt_edit = time.perf_counter() - t0

    return {
        "cells": int(ds.num_cells),
        "framing": framing,
        "coverage": round(cov, 3),
        "mray_full": round(total * iters / dt / 1e6, 2),
        "mray_traced": round(n_traced * iters / dt / 1e6, 2),
        "fps": round(iters / dt, 2),
        "fps1": round(fps1, 3),
        "spread": round(spread, 3),
        "tf_edit_s": round(dt_edit, 3),
    }


def bench_row_q(subdiv: int, num_layers: int, iters: int, framing: str,
                chunk: int, spr: int, spp: int) -> dict:
    """Quantized-tier row (the single-chip north-star scale: R2B9 @1080p).
    Same camera/metrics contract as bench_row.

    The scene is generated ON the device (data/device_scene.py) and
    alpha is baked on device; only the locator table is uploaded
    (npz-cached binning)."""
    q, loc, k_cap, bands, tf, stats, fm, lod, eff = _build_q_scene(
        subdiv, num_layers, framing)
    row = _measure_row_q(
        q, loc, k_cap, bands, tf, stats, fm,
        n_cells=20 * 4 ** subdiv,
        tag="/quantized" + (f"+lod{lod}" if lod else ""),
        framing=framing, iters=iters, chunk=chunk, spr=spr, spp=spp)
    if eff == 8 and lod == 0 and os.environ.get("BENCH_RMSE", "1") == "1":
        # quantized-tier error budget in the artifact: deterministic
        # march-vs-march RMSE at the largest scale where both tiers fit
        t0 = time.perf_counter()
        row["rmse_q"] = round(_rmse_q_vs_f32(eff, num_layers), 4)
        print(f"# rmse_q {row['rmse_q']} "
              f"({time.perf_counter() - t0:.0f}s)",
              file=sys.stderr, flush=True)
    return row


def _build_q_scene(subdiv: int, num_layers: int, framing: str):
    """Device-synthesized quantized scene + locator + finemap, shared by
    the Woodcock (bench_row_q) and march (bench_row_m) rows.  Returns
    (q, loc, k_cap, bands, tf, stats, fm, lod, eff)."""
    import os as _os

    from icon_dvr.data.bigscene import (build_locator_csr_from_scene,
                                        locator_cache_path,
                                        synth_quantized_cached)
    from icon_dvr.data.device_scene import synth_quantized_device
    from icon_dvr.models.qcells import bake_alpha_q

    # mip-tier selection (data/lod.py): BENCH_LOD =
    # auto (default; nearest-mip from the framing's pixel footprint) or an
    # explicit level.  The closeup headline is pixel-matched -> level 0;
    # viewall at R2B9 renders its level-3 mip (value-space 4^3:1 pooled
    # field on subdiv-8 geometry) — the row's framing tag records it.
    lod_env = os.environ.get("BENCH_LOD", "auto")
    lod = _auto_lod(subdiv, framing) if lod_env == "auto" else int(lod_env)
    lod = min(lod, subdiv - 1)
    eff = subdiv - lod

    dsc = synth_quantized_device(eff, num_layers, field_lod=lod)
    stats = dsc.stats
    tf = make_transfunc(value_range=tuple(stats.data_range))
    q = bake_alpha_q(dsc.cells, tf)
    bands = update_band_majorants(dsc.bands, tf.values, tf.value_range)
    del dsc   # frees the pre-bake zeros alpha_q
    cache_key = f"s{eff}_l{num_layers}"  # locator/finemap are geometry-
    # only, so a mip tier shares the plain subdiv-(s-lod) artifacts
    # FULL locator grid by default; BENCH_LOC_SCALE < 1 coarsens it
    loc_scale = float(os.environ.get("BENCH_LOC_SCALE", "1"))
    sc = None
    if not _os.path.exists(locator_cache_path(cache_key, loc_scale)):
        sc = synth_quantized_cached(eff, num_layers)  # binning needs lat/lon
    loc, k_cap = build_locator_csr_from_scene(sc, cache_key=cache_key,
                                              dims_scale=loc_scale)
    del sc
    fm = None
    fm_factor = int(os.environ.get("BENCH_FINEMAP",
                                   str(int(round(2 / loc_scale)))))
    if fm_factor > 0:
        from icon_dvr.data.bigscene import build_finemap_cached
        t0 = time.perf_counter()
        fm = build_finemap_cached(loc, q.test12, k_cap, factor=fm_factor,
                                  cache_key=cache_key, dims_scale=loc_scale)
        np.asarray(fm.dims)
        print(f"# finemap x{fm_factor} built in "
              f"{time.perf_counter() - t0:.0f}s", file=sys.stderr,
              flush=True)
    return q, loc, k_cap, bands, tf, stats, fm, lod, eff


def bench_row_m(subdiv: int, num_layers: int, iters: int, framing: str,
                chunk: int, spr: int, spp: int) -> dict:
    """Deterministic-MARCH row (ops/march.py): the flagship converged-
    image metric.  One pass computes the expectation the Woodcock rows
    estimate, so mray_full here is CONVERGED rays/s (one noise-free
    frame per pass; only pixel-jitter antialiasing remains), and
    tf_edit_s is edit -> first CONVERGED frame.  Chunks run one per
    execution with a host read of each chunk's coverage between."""
    q, loc, k_cap, bands, tf, stats, fm, lod, eff = _build_q_scene(
        subdiv, num_layers, framing)
    return _measure_row_m(q, loc, k_cap, bands, tf, stats, fm,
                          n_cells=20 * 4 ** subdiv,
                          tag="/march" + (f"+lod{lod}" if lod else ""),
                          framing=framing, chunk=chunk)


def bench_row_icm(subdiv: int, num_layers: int, iters: int, framing: str,
                  chunk: int, spr: int, spp: int) -> dict:
    """MARCH on the reference-format `.ic` terrain scene — the scene
    class where Woodcock is slowest per ray (terrain gaps force locate
    misses on every null collision).  The march visits each gap ONCE
    with the exact skip."""
    q, loc, k_cap, bands, tf, stats, fm, lod, n_cells = _build_ic_scene(
        subdiv, num_layers, framing)
    return _measure_row_m(q, loc, k_cap, bands, tf, stats, fm,
                          n_cells=n_cells,
                          tag="/ic-march" + (f"+lod{lod}" if lod else ""),
                          framing=framing, chunk=chunk)


def _measure_row_m(q, loc, k_cap, bands, tf, stats, fm, *, n_cells, tag,
                   framing, chunk) -> dict:
    import functools

    import jax

    from icon_dvr.models.qcells import bake_alpha_q
    from icon_dvr.ops.march import march_rays_q

    cam = _camera(stats, framing)
    unit_distance = 10.0 ** (np.floor(
        np.log10(stats.spherical_bounds_lo[0])) - 3)
    lp = make_launch_params(cam.basis(WIDTH, HEIGHT), stats.world_bounds_lo,
                            stats.world_bounds_hi,
                            unit_distance=unit_distance)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], WIDTH, HEIGHT)
    total = WIDTH * HEIGHT
    n_proc = min(total, -(-max(n_active, 1) // chunk) * chunk)
    pix = np.asarray(perm[:n_proc])
    n = n_proc // chunk
    ys_all, xs_all = np.divmod(pix.reshape(n, chunk), WIDTH)
    xs_d = [jnp.asarray(x) for x in xs_all]
    ys_d = [jnp.asarray(y) for y in ys_all]

    @functools.partial(jax.jit, static_argnames=("k_cap_",))
    def march_chunk(xs, ys, tf_, bands_, q_, loc_, fm_, p, k_cap_):
        # every table an explicit argument: closure-captured device
        # arrays are hoisted as lowering CONSTANTS, which bloats lowering
        # and risks duplication — arguments stay by-reference
        return march_rays_q(q_, loc_, k_cap_, bands_, tf_,
                            lp._replace(accum_id=p), xs, ys,
                            WIDTH, HEIGHT, finemap=fm_)

    def sweep(tf_, bands_, q_, p):
        """One converged pass over the covered prefix; returns the alpha
        coverage (also the host materialization that validates every
        execution)."""
        covered = 0
        for i in range(n):
            w, ca = march_chunk(xs_d[i], ys_d[i], tf_, bands_, q_,
                                loc, fm, jnp.int32(p), k_cap_=k_cap)
            covered += int((np.asarray(ca)[:, 3] > 0).sum())
        return covered / total

    cov = sweep(tf, bands, q, 0)       # warm (compile) + coverage
    times = []
    for w in range(3):
        t0 = time.perf_counter()
        sweep(tf, bands, q, w + 1)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    spread = float((max(times) - min(times)) / max(dt, 1e-9))

    # TF edit -> first CONVERGED frame (the march's interactivity story)
    def tf_edit(tf2):
        q2 = bake_alpha_q(q, tf2)
        bands2 = update_band_majorants(bands, tf2.values, tf2.value_range)
        sweep(tf2, bands2, q2, 0)

    def gain_edit(gain, scale):
        return tf._replace(values=tf.values * jnp.float32(gain),
                           opacity_scale=jnp.float32(scale))

    tf_edit(gain_edit(0.95, 0.9))
    t0 = time.perf_counter()
    tf_edit(gain_edit(0.9, 0.8))
    dt_edit = time.perf_counter() - t0

    return {
        "cells": n_cells,
        "framing": framing + tag,
        "coverage": round(cov, 3),
        "mray_full": round(total / dt / 1e6, 2),
        "mray_traced": round(n_proc / dt / 1e6, 2),
        "fps": round(1.0 / dt, 3),      # CONVERGED frames/s
        "fps1": round(1.0 / dt, 3),
        "spread": round(spread, 3),
        "tf_edit_s": round(dt_edit, 3),
    }


def _measure_row_q(q, loc, k_cap, bands, tf, stats, fm, *, n_cells,
                   tag, framing, iters, chunk, spr, spp):
    """Quantized-tier measurement core, shared by the synthetic rows
    (bench_row_q) and the reference-format `.ic` rows (bench_row_ic):
    throughput windows, fps1, TF-edit/stroke latency, preview latency."""
    from icon_dvr.models.qcells import bake_alpha_q
    from icon_dvr.ops.fastq import render_frame_fast_q

    cam = _camera(stats, framing)
    unit_distance = 10.0 ** (np.floor(
        np.log10(stats.spherical_bounds_lo[0])) - 3)
    lp = make_launch_params(cam.basis(WIDTH, HEIGHT), stats.world_bounds_lo,
                            stats.world_bounds_hi,
                            unit_distance=unit_distance)
    accum, fb = alloc_frame(WIDTH, HEIGHT)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], WIDTH, HEIGHT)
    inv = inverse_order(perm)
    perm = jnp.asarray(perm)
    total = WIDTH * HEIGHT
    n_traced = min(total, -(-max(n_active, 1) // chunk) * chunk)

    compact = int(os.environ.get("BENCH_COMPACT", "2048"))
    scap = int(os.environ.get("BENCH_SERVICE_CAP", "-1"))  # -1 auto flat

    def step1(s, accum, fb):
        return render_frame_fast_q(q, loc, k_cap, bands, tf,
                                   lp._replace(accum_id=jnp.int32(s)),
                                   accum, fb, width=WIDTH, height=HEIGHT,
                                   pixel_perm=perm, n_active=n_active,
                                   chunk=chunk, steps_per_refresh=spr,
                                   samples=1, refresh_compact=compact,
                                   finemap=fm, service_cap=scap)

    def step(s, accum, fb):
        return render_frame_fast_q(q, loc, k_cap, bands, tf,
                                   lp._replace(accum_id=jnp.int32(s)),
                                   accum, fb, width=WIDTH, height=HEIGHT,
                                   pixel_perm=perm, n_active=n_active,
                                   chunk=chunk, steps_per_refresh=spr,
                                   samples=spp, refresh_compact=compact,
                                   finemap=fm, service_cap=scap)

    accum, fb = step(0, accum, fb)
    float((np.asarray(fb)[inv] != 0).mean())  # warm + sync

    dt, spread, cov, accum, fb = _median_windows(step, accum, fb, iters,
                                                 spp, inv)
    iters = iters * spp   # samples rendered per timed window

    # One PRESENTED frame at samples=1 (see the f32 tier's note): the
    # configs[3] interactivity unit.
    accum, fb = step1(9000, accum, fb)
    np.asarray(fb)  # warm the samples=1 executable
    t1s = []
    for j in range(3):
        t0 = time.perf_counter()
        accum, fb = step1(9001 + j, accum, fb)
        np.asarray(fb)
        t1s.append(time.perf_counter() - t0)
    fps1 = 1.0 / float(np.median(t1s))

    # TF edit on the quantized tier: 256-entry table bake + DEVICE u8
    # select-reduce rewrite over (N, Lm) + band majorants + the FIRST
    # PRESENTED samples=1 frame.
    # The LUT values change between edits (not just opacity_scale) so the
    # unchanged-table fast path cannot hide the rewrite cost.
    def tf_edit(tf2):
        q2 = bake_alpha_q(q, tf2)
        bands2 = update_band_majorants(bands, tf2.values, tf2.value_range)
        a2, f2 = render_frame_fast_q(q2, loc, k_cap, bands2, tf2,
                                     lp._replace(accum_id=jnp.int32(0)),
                                     *alloc_frame(WIDTH, HEIGHT),
                                     width=WIDTH, height=HEIGHT,
                                     pixel_perm=perm, n_active=n_active,
                                     chunk=chunk, steps_per_refresh=spr,
                                     samples=1, refresh_compact=compact,
                                     finemap=fm, service_cap=scap)
        np.asarray(f2)

    def gain_edit(gain, scale):   # worst case: every classify level moves
        return tf._replace(values=tf.values * jnp.float32(gain),
                           opacity_scale=jnp.float32(scale))

    def stroke_edit(gain):
        # realistic TFE gesture: a freehand stroke over a narrow value
        # band (ref alpha_editor.cpp:263-320) — only a few of the 256
        # normalized levels change, so the incremental bake path serves it
        vals = np.asarray(tf.values).copy()
        n = vals.shape[0]
        vals[(n * 2) // 5:(n * 2) // 5 + max(n // 16, 1), 3] *= gain
        return tf._replace(values=jnp.asarray(vals))

    tf_edit(gain_edit(0.95, 0.9))
    t0 = time.perf_counter()
    tf_edit(gain_edit(0.9, 0.8))
    dt_edit = time.perf_counter() - t0
    tf_edit(stroke_edit(0.7))
    t0 = time.perf_counter()
    tf_edit(stroke_edit(0.5))
    dt_stroke = time.perf_counter() - t0

    # PREVIEW latency: edit -> first PRESENTED
    # preview frame — the quarter-res samples=1 frame the interactive
    # viewer actually shows right after an edit (apps/icon_rt.py preview
    # branch); the honest full-res tf_edit_s above is unchanged.
    Wp, Hp = WIDTH // 4, HEIGHT // 4
    lp_p = make_launch_params(cam.basis(Wp, Hp), stats.world_bounds_lo,
                              stats.world_bounds_hi,
                              unit_distance=unit_distance)
    perm_p, n_active_p = pixel_order(lp_p, stats.spherical_bounds_lo[0],
                                     stats.spherical_bounds_hi[0], Wp, Hp)
    perm_p = jnp.asarray(perm_p)

    def tf_edit_preview(tf2):
        q2 = bake_alpha_q(q, tf2)
        bands2 = update_band_majorants(bands, tf2.values, tf2.value_range)
        a2, f2 = render_frame_fast_q(q2, loc, k_cap, bands2, tf2,
                                     lp_p._replace(accum_id=jnp.int32(0)),
                                     *alloc_frame(Wp, Hp),
                                     width=Wp, height=Hp,
                                     pixel_perm=perm_p,
                                     n_active=n_active_p,
                                     chunk=chunk, steps_per_refresh=spr,
                                     samples=1, refresh_compact=compact,
                                     finemap=fm, service_cap=scap)
        np.asarray(f2)

    tf_edit_preview(gain_edit(0.97, 0.95))
    t0 = time.perf_counter()
    tf_edit_preview(gain_edit(0.93, 0.85))
    dt_preview = time.perf_counter() - t0

    return {
        "cells": n_cells,
        "framing": framing + tag,
        "coverage": round(cov, 3),
        "mray_full": round(total * iters / dt / 1e6, 2),
        "mray_traced": round(n_traced * iters / dt / 1e6, 2),
        "fps": round(iters / dt, 2),
        "fps1": round(fps1, 3),
        "spread": round(spread, 3),
        "tf_edit_s": round(dt_edit, 3),
        "tf_stroke_s": round(dt_stroke, 3),
        "tf_preview_s": round(dt_preview, 3),
    }


def _rmse_q_vs_f32(subdiv: int, num_layers: int, Wr: int = 480,
                   Hr: int = 270) -> float:
    """Quantized-tier image error vs the f32 tier at the same scale (BASELINE's
    metric names 'image RMSE vs reference'), measured with the DETERMINISTIC
    march on both tiers — the same integral evaluated in closed form, so the
    number is pure u8/u16 quantization error with zero Monte-Carlo noise.  Runs
    at a reduced frame (the error is a field property, not a resolution
    property); both scenes are the host-built icosphere with value-quantized
    fields, per tests/test_march.py's cross-tier lock."""
    from icon_dvr.data import synthetic as synth
    from icon_dvr.models.locator import (build_locator_csr, densify_csr)
    from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                        quantize_dataset_values)
    from icon_dvr.ops.march import (render_frame_march,
                                    render_frame_march_q)

    ds = synth.icosphere(subdivisions=subdiv, num_layers=num_layers)
    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range))
    bands = update_band_majorants(build_radial_bands(ds_q, 64),
                                  tf.values, tf.value_range)
    cam = _camera(stats, "closeup")
    ud = 10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0])) - 3)
    lp = make_launch_params(cam.basis(Wr, Hr), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=ud)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], Wr, Hr)
    perm = jnp.asarray(perm)

    cells = build_cells(ds_q)
    loc_f = build_locator(ds_q)   # top-level import (bench_row's builder)
    packed = pack_cells(cells, tf)
    accum_f, _ = render_frame_march(
        cells, packed, loc_f, bands, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(Wr, Hr), width=Wr, height=Hr, pixel_perm=perm,
        n_active=n_active, chunk=8192)
    af = np.asarray(accum_f)
    del cells, packed, loc_f

    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi)), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc_q = densify_csr(csr, k_cap)
    accum_q, _ = render_frame_march_q(
        q, loc_q, k_cap, bands, tf, lp._replace(accum_id=jnp.int32(0)),
        *alloc_frame(Wr, Hr), width=Wr, height=Hr, pixel_perm=perm,
        n_active=n_active, chunk=8192)
    aq = np.asarray(accum_q)
    both = (af[:, 3] > 0) & (aq[:, 3] > 0)
    if not both.any():
        return float("nan")
    return float(np.sqrt(np.mean((af[both] - aq[both]) ** 2)))


IC_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            ".cache", "ic")


def _ic_file_cached(subdiv: int, levels: int) -> str:
    """NetCDF -> tools/convert_icon -> `.ic`, cached on disk: the bench's
    reference-format rows run the reference's ACTUAL data product,
    re-reading the cached .ic through read_ic every
    run (only the NetCDF synthesis + conversion are cached)."""
    path = os.path.join(IC_CACHE_DIR, f"ic_s{subdiv}_l{levels}.ic")
    if os.path.exists(path):
        return path
    import tempfile

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts"))
    from e2e_netcdf import make_netcdf_inputs

    from icon_dvr.tools import convert_icon as ci

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tempfile.TemporaryDirectory() as wd:
        hgrid, hsurf, hhl, data = make_netcdf_inputs(wd, subdiv, levels)
        out = os.path.join(wd, "scene")
        rc = ci.main(["-hgrid", hgrid, "-hsurf", hsurf, "-hhl", *hhl,
                      "-data", *data, "-o", out])
        assert rc == 0
        os.replace(out + ".ic", path)
    return path


def bench_row_ic(subdiv: int, num_layers: int, iters: int, framing: str,
                 chunk: int, spr: int, spp: int) -> dict:
    """Reference-format row: a `.ic` file from tools/convert_icon
    (synthetic-DWD NetCDF terrain scene, the e2e pipeline's product),
    rendered on the quantized tier WITH finemap and compacted refresh.

    TF sanity for non-synthetic distributions: value_range is the
    2nd-98th percentile of the field (standard DVR windowing) instead of
    the raw min/max — real fields (e.g. pressure) concentrate mass away
    from their extremes, and the raw-range default made the terrain
    scene near-opaque.

    The viewall framing engages the GEOMETRIC mip chain
    (data/lod.build_lod_dataset): file-loaded
    datasets have no procedural index structure, so the tier is derived
    from geometry and runs through the identical builders."""
    q, loc, k_cap, bands, tf, stats, fm, lod, n_cells = _build_ic_scene(
        subdiv, num_layers, framing)
    return _measure_row_q(
        q, loc, k_cap, bands, tf, stats, fm, n_cells=n_cells,
        tag="/ic-quantized" + (f"+lod{lod}" if lod else ""),
        framing=framing, iters=iters, chunk=chunk, spr=spr, spp=spp)


def _build_ic_scene(subdiv: int, num_layers: int, framing: str):
    """Reference-format scene build (see bench_row_ic): .ic read, auto
    geometric LOD, percentile-windowed TF, quantized tables + locator +
    finemap.  Returns (q, loc, k_cap, bands, tf, stats, fm, lod,
    n_cells_fine)."""
    import gc

    from icon_dvr.data.icfile import read_ic
    from icon_dvr.data.lod import (build_lod_dataset, equivalent_subdiv,
                                   select_lod)
    from icon_dvr.models.cells import compute_stats
    from icon_dvr.models.finemap import build_finemap
    from icon_dvr.models.locator import build_locator_csr, densify_csr
    from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                        quantize_dataset_values)

    ds = read_ic(_ic_file_cached(subdiv, num_layers))
    n_cells = ds.num_cells
    stats_f = compute_stats(ds)
    cam = _camera(stats_f, framing)
    if os.environ.get("BENCH_LOD", "auto") == "auto":
        lod = select_lod(cam.position, float(stats_f.spherical_bounds_hi[0]),
                         float(cam.fovy), HEIGHT, equivalent_subdiv(n_cells))
    else:
        lod = int(os.environ["BENCH_LOD"])
    if lod > 0:
        ds, _ = build_lod_dataset(ds, lod)
        gc.collect()

    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    mask = np.arange(ds_q.value.shape[1])[None, :] \
        < ds_q.num_layers[:, None]
    vals = ds_q.value[mask]
    vr = (float(np.percentile(vals, 2)), float(np.percentile(vals, 98)))
    if not vr[1] > vr[0]:
        vr = tuple(stats.data_range)
    tf = make_transfunc(value_range=vr)
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi)), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    fm = build_finemap(loc, q.test12, k_cap,
                       factor=int(os.environ.get("BENCH_FINEMAP_IC", "2")))
    bands = update_band_majorants(build_radial_bands(ds_q, 64),
                                  tf.values, tf.value_range)
    return q, loc, k_cap, bands, tf, stats, fm, lod, n_cells


# (name, icosphere subdiv, layers, timed iters, framing, tier, spp): spp
# is the cell's fixed samples per launch, so every commit renders the same
# workload.  Rows run in importance order, headline first.
ALL_ROWS = [
    ("r2b9q_closeup", 11, 16, 2, "closeup", "q", 64),   # 83,886,080 cells
    # deterministic march (ops/march.py): CONVERGED frames/s at the
    # headline scale — one pass computes what the Woodcock row needs
    # ~64 samples to approximate
    ("r2b9m_closeup", 11, 16, 2, "closeup", "m", 1),
    ("r2b4_closeup", 5, 16, 2, "closeup", "f32", 64),   # 20,480 cells
    # reference-format data: .ic terrain scene from tools/convert_icon,
    # finemap + compact on
    ("ic_r2b7m_closeup", 7, 16, 2, "closeup", "icm", 1),
    ("ic_r2b7_closeup", 7, 16, 2, "closeup", "ic", 32),
    # the reference's DEFAULT framing at the north-star scale: auto-LOD
    # renders the level-3 value-space mip (data/lod.py) on subdiv-8
    # geometry — the framing field records the selected level
    ("r2b9q_viewall", 11, 16, 2, "viewall", "q", 64),
    ("r2b8q_closeup", 8, 16, 2, "closeup", "q", 16),    # quantized overhead
    ("r2b8m_closeup", 8, 16, 2, "closeup", "m", 1),     # march, mid scale
    # file-loaded LOD: the geometric mip chain on the .ic scene at the
    # reference-default framing
    ("ic_r2b7_viewall", 7, 16, 2, "viewall", "ic", 64),
    ("r2b4_viewall", 5, 16, 2, "viewall", "f32", 64),   # ref-default framing
    ("r2b7_closeup", 7, 16, 2, "closeup", "f32", 32),   # 327,680 cells
    ("r2b8_closeup", 8, 16, 2, "closeup", "f32", 16),   # 1,310,720 cells
]
HEADLINE = os.environ.get("BENCH_HEADLINE", "r2b9q_closeup")

# Row GROUPS, each one child process: rows whose tables fit device memory
# together share a process (and its compiles); the r2b9-scale rows run
# solo so each starts with the card's memory free.
ROW_GROUPS = [
    ["r2b9q_closeup"],
    ["r2b9m_closeup"],
    ["ic_r2b7m_closeup", "ic_r2b7_closeup", "ic_r2b7_viewall"],
    ["r2b4_closeup", "r2b4_viewall", "r2b7_closeup", "r2b8_closeup"],
    ["r2b8q_closeup", "r2b8m_closeup"],
    ["r2b9q_viewall"],
]


def _parse_row_output(stdout_bytes: bytes) -> dict:
    """Collect the child's `BENCHROW <name> {json}` lines (legacy
    nameless lines parse with name None); a line cut short by a killed
    child is skipped."""
    out = {}
    for ln in stdout_bytes.decode("utf-8", "replace").splitlines():
        if not ln.startswith("BENCHROW "):
            continue
        rest = ln[len("BENCHROW "):]
        name, payload = ((None, rest) if rest.lstrip().startswith("{")
                         else (rest.split(" ", 1) + [""])[:2])
        try:
            out[name] = json.loads(payload)
        except json.JSONDecodeError:
            continue
    return out


def device_info(platform: str = "gpu") -> dict:
    """platform / device_kind / count of JAX's devices; raises unless
    the first device is on `platform` (no CPU fallback for timings)."""
    d = jax.devices()
    if d[0].platform != platform:
        raise RuntimeError(f"bench rows need a {platform} device; JAX "
                           f"found {d[0].platform} ({d[0].device_kind})")
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _run_row(names_csv: str, platform: str = "gpu") -> None:
    """Child mode (`bench.py --row NAME[,NAME...]`): check the device,
    then run the listed rows sequentially in this process, printing
    `BENCHROW <name> {json}` per completed row, each carrying the device
    (the parent captures whatever completed even if a later row in the
    group fails)."""
    import gc

    device = device_info(platform)
    for name in names_csv.split(","):
        spec = {r[0]: r for r in ALL_ROWS}[name]
        _, subdiv, layers, iters, framing, tier, spp = spec
        chunk = int(os.environ.get("BENCH_CHUNK", str(CHUNK)))
        # spr 10 only where the FLAT service engages (giant quantized
        # rows; ops/fast.FLAT_AUTO_MIN_CELLS); chosen on the earlier
        # accelerator, not yet measured on the H100 (ROADMAP D2)
        from icon_dvr.ops.fast import FLAT_AUTO_MIN_CELLS
        eff_cells = 20 * 4 ** (subdiv - (_auto_lod(subdiv, framing)
                               if os.environ.get("BENCH_LOD", "auto")
                               == "auto" else int(os.environ["BENCH_LOD"])))
        flat_row = tier == "q" and eff_cells >= FLAT_AUTO_MIN_CELLS
        spr = int(os.environ.get("BENCH_SPR", "10" if flat_row else "8"))
        fn = {"q": bench_row_q, "ic": bench_row_ic, "m": bench_row_m,
              "icm": bench_row_icm, "f32": bench_row}[tier]
        row = dict(fn(subdiv, layers, iters, framing, chunk, spr, spp),
                   device=device)
        print(f"BENCHROW {name} " + json.dumps(row), flush=True)
        gc.collect()    # drop the row's device buffers before the next


def main():
    """Parent: one SUBPROCESS per row group (each starts with the card's
    memory free), with a per-group timeout so one overrunning group
    cannot eat the others.  The parent never initializes a JAX backend:
    one process holds the card at a time."""
    import subprocess

    budget = int(os.environ.get("BENCH_WATCHDOG_S", "3300"))
    _install_watchdog(budget + 60)  # backstop behind the per-row timeouts
    deadline = time.time() + budget
    row_cap = int(os.environ.get("BENCH_ROW_TIMEOUT", "2700"))
    only = os.environ.get("BENCH_ROWS")  # comma-separated row names
    wanted = set(only.split(",")) if only else None
    known = {r[0] for r in ALL_ROWS}
    groups = [[n for n in g if (wanted is None or n in wanted)
               and n in known] for g in ROW_GROUPS]
    grouped = {n for g in groups for n in g}
    # rows not in any group (newly added) each get their own child
    groups += [[r[0]] for r in ALL_ROWS
               if r[0] not in grouped and (wanted is None
                                           or r[0] in wanted)]
    groups = [g for g in groups if g]

    failures = []
    for names in groups:
        timeout = min(row_cap * max(1, (len(names) + 1) // 2),
                      deadline - time.time())
        if timeout < 60:
            failures.extend(f"{n}: skipped (global budget exhausted)"
                            for n in names)
            continue
        err = ""
        try:
            # on timeout the child is killed, so no process outlives its
            # group on the card
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--row",
                 ",".join(names)],
                stdout=subprocess.PIPE, timeout=timeout)
            out = proc.stdout
            if proc.returncode:
                err = f"exit code {proc.returncode}"
        except subprocess.TimeoutExpired as e:
            out = e.stdout or b""
            err = f"timed out after {timeout:.0f}s (killed)"
        got = _parse_row_output(out)
        if len(got) == 1 and None in got and len(names) == 1:
            got = {names[0]: got[None]}   # legacy nameless line
        for n in names:
            if n in got:
                RESULTS[n] = got[n]
                print(f"# {n}: {got[n]}", file=sys.stderr, flush=True)
            else:
                failures.append(f"{n}: {err or 'no BENCHROW line'}")
                print(f"# {n} FAILED: {err or 'no BENCHROW line'}",
                      file=sys.stderr, flush=True)

    _emit(note="; ".join(failures) if failures else "")


if __name__ == "__main__":
    if "--row" in sys.argv:
        _run_row(sys.argv[sys.argv.index("--row") + 1])
    else:
        main()
