#!/usr/bin/env python
"""On-card smoke test: the renderer's main path on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py                # one card: phases a-d + comparisons
    python chip_smoke.py --sweep        # the same, then the lane-chunk sweep
    python chip_smoke.py --four-cards   # only the multi-card paths (4 cards)

One card, in order:

  0. rebuild native/libicon_host.so from native/icon_host.cpp, then run the
     card-only tests in a child (`JAX_PLATFORMS=cuda pytest -m gpu`)
     before this process initializes JAX, so one process holds the card
     at a time;
  1. through apps/icon_rt.build(), at R2B8 (`--synthetic 8:16`,
     1,310,720 columns x 16 layers), 1920x1080, closeup camera:
       a. fast Woodcock, f32 tier (--sample-limit 16 --samples 8)
       b. --march, two launches
       c. --quantized Woodcock (fine map on) --sample-limit 16
       d. a transfer-function stroke through the pipeline's TF handler on
          pipeline c, re-render, revert, re-render
     each reporting set-up, first-call and steady seconds, full-frame
     Mray/s and peak device memory;
  2. the comparisons with the plain references: march vs the dense-scan
     quadrature oracle, Woodcock mean vs march, quantized vs f32 march
     RMSE, and the `ae` parity raygen vs tests/refimpl.py.

The last line of stdout is {"ok": true, "device": {...}}, printed only
when every phase ran and every comparison passed.  There is no CPU path:
without a GPU the script exits non-zero and prints no such line.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "apps"))

WIDTH, HEIGHT = 1920, 1080
SUBDIV, LAYERS = 8, 16           # R2B8
CHUNKS = (4096, 32768, 131072, 0)   # --sweep; 0 = whole covered prefix


class NoAccelerator(RuntimeError):
    """JAX found no GPU."""


class Check(NamedTuple):
    name: str
    ok: bool
    detail: str


class Phase(NamedTuple):
    name: str
    setup_s: float       # build(): host scene, tables, upload
    first_s: float       # first batch: lazy structures + compile + render
    steady_s: float      # median seconds per launch, second batch
    launches: int
    samples: int         # progressive samples per batch
    mray_full: float     # width*height*samples / steady batch seconds
    peak_bytes: int      # device peak_bytes_in_use since process start


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`name, power.limit` of the cards, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def check_device(devices, count: int | None = None) -> dict:
    """platform / kind / count of JAX's devices; raises NoAccelerator
    unless they are GPUs (and, when given, exactly `count` of them)."""
    d = devices[0]
    if d.platform != "gpu":
        raise NoAccelerator(f"JAX found no GPU (first device: {d.platform}, "
                            f"{d.device_kind})")
    if count is not None and len(devices) != count:
        raise NoAccelerator(f"need {count} GPUs, JAX found {len(devices)}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def result_line(device: dict) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": int(device["count"])}})


def peak_bytes() -> int:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


# ---------------------------------------------------------------------------
# Set-up steps that run before JAX starts
# ---------------------------------------------------------------------------

def build_native() -> float:
    """Rebuild native/libicon_host.so from the tracked source; seconds."""
    from icon_dvr.utils import native
    t0 = time.perf_counter()
    native.build()
    return time.perf_counter() - t0


def run_gpu_tests() -> float:
    """The card-only tests in a child process; raises if any fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "tests"],
        cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cuda,cpu"),
        capture_output=True, text=True, timeout=900)
    sys.stderr.write(proc.stdout[-12000:] + proc.stderr[-4000:])
    lines = proc.stdout.strip().splitlines()
    log(f"gpu tests: {lines[-1] if lines else 'no output'} "
        f"(exit code {proc.returncode}, {time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0:
        raise RuntimeError("card-only tests failed (output on stderr)")
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phases through the app's entry point
# ---------------------------------------------------------------------------

def closeup_camera_args(subdiv: int, width: int, height: int) -> list:
    """`--camera ... -fovy ...` of the closeup camera for the synthetic
    scene (analytic bounds: radius EARTH_RADIUS + 30 km)."""
    from icon_dvr.data.synthetic import EARTH_RADIUS

    r_out = float(EARTH_RADIUS) + 3.0e4
    rb = r_out * 1.02

    class Bounds:
        world_bounds_lo = np.array([-rb] * 3, np.float32)
        world_bounds_hi = np.array([rb] * 3, np.float32)
        spherical_bounds_lo = np.array([r_out - 3.0e4, 0, 0], np.float32)
        spherical_bounds_hi = np.array([r_out, 0, 0], np.float32)

    return closeup_camera(Bounds, width, height).to_cli_string().split()


def closeup_camera(stats, width: int, height: int):
    """bench._camera(stats, "closeup") at a width:height aspect (the
    closeup pose does not depend on the aspect)."""
    import bench
    cam = bench._camera(stats, "closeup")
    cam.set_aspect(width / height)
    return cam


def app_argv(extra: list, *, subdiv: int, layers: int, width: int,
             height: int, out: str) -> list:
    return (["--synthetic", f"{subdiv}:{layers}",
             "--size", str(width), str(height),
             *closeup_camera_args(subdiv, width, height), "-o", out]
            + list(extra))


def render_pass(pl) -> list:
    """One batch of the pipeline from frame 0 to --sample-limit, each
    launch timed up to a host read of its framebuffer.  Returns
    [(seconds, samples)] per launch."""
    pl.reset_accumulation()
    out = []
    while True:
        t0 = time.perf_counter()
        pl.launch()
        np.asarray(pl.last_fb)
        out.append((time.perf_counter() - t0, int(pl.samples_per_launch)))
        if not pl.is_running():
            return out


def run_phase(name: str, argv: list):
    """build() + two batches; returns (pipeline, Phase)."""
    import icon_rt

    t0 = time.perf_counter()
    pl = icon_rt.build(argv)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    render_pass(pl)
    first = time.perf_counter() - t0
    steady = render_pass(pl)
    secs = [s for s, _ in steady]
    samples = sum(n for _, n in steady)
    return pl, Phase(name, setup, first, float(np.median(secs)),
                     len(steady), samples,
                     pl.width * pl.height * samples / sum(secs) / 1e6,
                     peak_bytes())


def phase_line(p: Phase) -> str:
    return (f"phase {p.name}: set-up {p.setup_s:.3f} s, first call "
            f"{p.first_s:.3f} s, steady {p.steady_s:.4f} s/launch "
            f"({p.launches} launches, {p.samples} samples/pixel), "
            f"{p.mray_full:.3f} Mray/s full-frame, peak_bytes_in_use "
            f"{p.peak_bytes}")


def tf_edit_roundtrip(pl):
    """Phase d on a built pipeline: a TFE stroke harvested by the frame
    loop (the TF handler rebakes), re-render, then the original LUT
    restored through the same handler and re-rendered.  The stroke must
    change the image and the revert must restore it bit for bit (the
    rebake is exact both ways).  Returns (timings dict, Check)."""
    base = render_pass(pl)
    before = np.asarray(pl.last_fb).copy()
    lut0 = pl.transfunc.lut.copy()
    pl.tfe.draw_stroke([(90, 20), (150, 140), (210, 60)])
    t0 = time.perf_counter()
    pl.is_running()                     # harvest -> on_tf_update
    edit_s = time.perf_counter() - t0
    edited = render_pass(pl)
    after = np.asarray(pl.last_fb).copy()
    pl.transfunc.set_lut(lut0)
    pl.transfunc_update_handler(pl.transfunc, pl.tf_index)
    render_pass(pl)
    back = np.asarray(pl.last_fb)
    changed = float((after != before).mean())
    same = bool((back == before).all())
    timings = {"edit_s": edit_s, "first_frame_s": edited[0][0],
               "batch_s": sum(s for s, _ in edited),
               "before_batch_s": sum(s for s, _ in base)}
    return timings, Check(
        "tf-edit round trip", changed > 0 and same,
        f"{changed:.4f} of pixels changed by the stroke; revert "
        f"{'bit-equal' if same else 'DIFFERS'}")


# ---------------------------------------------------------------------------
# Comparisons with the plain references
# ---------------------------------------------------------------------------

def compare_woodcock_march(acc_w, acc_m) -> Check:
    """tests/test_march.py::test_march_matches_woodcock_mean bounds on the
    interior pixels of a Woodcock mean (S samples) vs the march."""
    interior = (acc_m[:, 3] > 0) & (acc_w[:, 3] > 0.999)
    d = np.abs(acc_m - acc_w)[interior]
    n = int(interior.sum())
    if n <= 50:
        return Check("woodcock mean vs march", False,
                     f"only {n} interior pixels")
    col = float(d[:, :3].mean())
    alp = float(d[:, 3].mean())
    img = float(np.abs(acc_m[interior, :3].mean(0)
                       - acc_w[interior, :3].mean(0)).max())
    ok = col < 0.08 and alp < 0.01 and img < 0.02
    return Check("woodcock mean vs march", ok,
                 f"{n} interior pixels; color mean |d| {col:.5f} < 0.08, "
                 f"alpha mean |d| {alp:.6f} < 0.01, image-mean |d| "
                 f"{img:.5f} < 0.02")


class Scene(NamedTuple):
    ds: object           # the host dataset (unquantized field)
    stats: object        # of the quantized field
    q: object            # QuantizedCells, alpha baked
    loc: object          # dense locator
    k_cap: int
    bands: object        # radial bands, majorants baked
    tf: object
    lp: object           # closeup launch params
    ud: float            # unit distance


def quantized_scene(subdiv: int, layers: int, width: int,
                    height: int) -> Scene:
    """The synthetic icosphere on the quantized tier, default TF over its
    data range, closeup launch params: the scene of the comparisons."""
    from icon_dvr.data import synthetic
    from icon_dvr.models.cells import compute_stats
    from icon_dvr.models.locator import build_locator_csr, densify_csr
    from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                        quantize_dataset_values)
    from icon_dvr.models.shells import (build_radial_bands,
                                        update_band_majorants)
    from icon_dvr.models.transfunc import make_transfunc
    from icon_dvr.ops.render import make_launch_params

    ds = synthetic.icosphere(subdivisions=subdiv, num_layers=layers)
    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range))
    q = bake_alpha_q(quantize_cells(ds_q, value_range=(lo, hi)), tf)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    bands = update_band_majorants(build_radial_bands(ds_q, 64),
                                  tf.values, tf.value_range)
    cam = closeup_camera(stats, width, height)
    ud = float(10.0 ** (np.floor(np.log10(stats.spherical_bounds_lo[0]))
                        - 3))
    lp = make_launch_params(cam.basis(width, height), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=ud)
    return Scene(ds, stats, q, loc, k_cap, bands, tf, lp, ud)


def pick_pixels(alpha: np.ndarray, width: int, height: int,
                n: int = 16) -> list:
    """Central, oblique and silhouette pixels of a covered-alpha image
    (H*W,): a third each near the globe's centre, near its limb, and on
    the coverage boundary, spread by angle."""
    cov = alpha.reshape(height, width) > 0
    ys, xs = np.nonzero(cov)
    cy, cx = ys.mean(), xs.mean()
    rad = np.hypot(ys - cy, xs - cx)
    ang = np.arctan2(ys - cy, xs - cx)
    inner = np.zeros_like(cov)
    inner[1:-1, 1:-1] = (cov[1:-1, 1:-1] & cov[:-2, 1:-1] & cov[2:, 1:-1]
                         & cov[1:-1, :-2] & cov[1:-1, 2:])
    edge = cov[ys, xs] & ~inner[ys, xs]
    n_c, n_o = n // 3, n // 3
    groups = [(rad <= 0.3 * rad.max(), n_c),
              ((rad >= 0.8 * rad.max()) & ~edge, n_o),
              (edge, n - n_c - n_o)]
    picked = []
    for mask, k in groups:
        idx = np.nonzero(mask)[0]
        if idx.size == 0:
            continue
        order = idx[np.argsort(ang[idx])]
        for j in np.linspace(0, order.size - 1, k).astype(int):
            picked.append(int(ys[order[j]] * width + xs[order[j]]))
    return picked


def compare_march_oracle(subdiv: int, layers: int, width: int, height: int,
                         n_pixels: int = 16, n: int = 100000) -> Check:
    """March vs the float64 dense-scan quadrature oracle
    (tests/march_oracle.py) on central, oblique and silhouette pixels;
    bound: max |d| < 3e-3 per RGBA channel."""
    import jax
    import jax.numpy as jnp
    from march_oracle import MarchOracle

    from icon_dvr.ops.march import march_rays_q, render_frame_march_q
    from icon_dvr.ops.render import alloc_frame

    ds, _, q, loc, k_cap, bands, tf, lp, ud = quantized_scene(
        subdiv, layers, width, height)
    lp0 = lp._replace(accum_id=jnp.int32(0))
    acc, _ = render_frame_march_q(q, loc, k_cap, bands, tf, lp0,
                                  *alloc_frame(width, height), width=width,
                                  height=height, chunk=width * height)
    pix = pick_pixels(np.asarray(acc)[:, 3], width, height, n_pixels)
    oracle = MarchOracle(q, bands, tf, lp, width, height, ud=ud, n=n)
    xs = jnp.asarray([p % width for p in pix], jnp.int32)
    ys = jnp.asarray([p // width for p in pix], jnp.int32)
    _, ca = march_rays_q(q, loc, k_cap, bands, tf, lp0, xs, ys, width,
                         height)
    got = np.asarray(ca)
    want = np.stack([oracle.pixel(p % width, p // width) for p in pix])
    d = np.abs(got - want).max(1)
    err = float(d.max())
    detail = (f"{20 * 4 ** subdiv} cells x {layers} layers, {len(pix)} "
              f"pixels of {width}x{height}, max |d| {err:.2e} < 3e-3 "
              f"(worst pixel {pix[int(d.argmax())]})")
    bad = np.nonzero(d >= 3e-3)[0]
    if bad.size:
        # the same rays through JAX's CPU backend, where one is present
        cpu = _cpu_devices()
        got_cpu = None
        if cpu:
            with jax.default_device(cpu[0]):
                args = jax.device_put((q, loc, bands, tf, lp0, xs, ys),
                                      cpu[0])
                _, ca_c = march_rays_q(args[0], args[1], k_cap, *args[2:],
                                       width, height)
                got_cpu = np.asarray(ca_c)
        for i in bad[:6]:
            detail += (f"; px {pix[i]} device {np.round(got[i], 5)} oracle "
                       f"{np.round(want[i], 5)}")
            if got_cpu is not None:
                detail += (f" jax-cpu {np.round(got_cpu[i], 5)} (|d| "
                           f"{np.abs(got_cpu[i] - want[i]).max():.2e})")
    return Check("march vs dense-scan oracle", err < 3e-3, detail)


def _cpu_devices() -> list:
    """JAX's CPU devices, or [] when the CPU backend is not enabled."""
    import jax
    try:
        return jax.devices("cpu")
    except RuntimeError:
        return []


def compare_rmse_q(subdiv: int, layers: int, width: int = 480,
                   height: int = 270) -> Check:
    """Quantized vs f32 march RMSE (bench._rmse_q_vs_f32) < 0.06."""
    import bench
    r = bench._rmse_q_vs_f32(subdiv, layers, Wr=width, Hr=height)
    return Check("quantized vs f32 march rmse", bool(np.isfinite(r))
                 and r < 0.06, f"rmse_q {r:.6f} < 0.06 at {width}x{height}")


def compare_parity_ae(width: int = 16, height: int = 16) -> Check:
    """The `ae` parity raygen vs tests/refimpl.py (the scene and samples of
    tests/test_render_ae.py::test_render_ae_matches_oracle).  Reports the
    share of accum values within rtol 1e-6 / atol 1e-7, the pixels outside
    it and the same render on JAX's CPU backend; passes on the CPU test's
    own bounds (>= 0.98 of pixels within 2e-3, >= 0.97 of packed pixels
    equal)."""
    import jax
    import jax.numpy as jnp
    import refimpl
    from test_render_ae import _scene

    from icon_dvr.models.cells import build_cells
    from icon_dvr.models.transfunc import make_transfunc
    from icon_dvr.ops.render import (alloc_frame, make_launch_params,
                                     render_frame_ae)

    ds, stats, cam = _scene()
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    ud = 5.0
    lp = make_launch_params(cam.basis(width, height), stats.world_bounds_lo,
                            stats.world_bounds_hi, unit_distance=ud,
                            accum_id=0)

    def render(device):
        with jax.default_device(device):
            cells = jax.device_put(build_cells(ds), device)
            tf_d = jax.device_put(tf, device)
            acc, fb = alloc_frame(width, height)
            for s in range(2):
                acc, fb = render_frame_ae(
                    cells, tf_d, lp._replace(accum_id=jnp.int32(s)), acc, fb,
                    width=width, height=height)
            return np.asarray(acc), np.asarray(fb)

    acc, fb = render(jax.devices()[0])
    acc_ref, fb_ref = refimpl.render_ae(
        ds, np.asarray(tf.values), np.asarray(tf.value_range),
        np.float32(1.0), cam.basis(width, height), width, height,
        stats.world_bounds_lo, stats.world_bounds_hi, unit_distance=ud,
        num_samples=2)
    tight = np.abs(acc - acc_ref) <= 1e-7 + 1e-6 * np.abs(acc_ref)
    bad = np.nonzero(~tight.all(1))[0]
    close = np.all(np.abs(acc - acc_ref) <= 2e-3, axis=-1).mean()
    same = (fb == fb_ref).mean()
    cpu = _cpu_devices()
    vs_cpu = (np.nonzero(~(acc == render(cpu[0])[0]).all(1))[0] if cpu
              else None)
    detail = (f"{tight.mean():.4f} of accum values within rtol 1e-6/atol "
              f"1e-7; {bad.size} pixels outside "
              f"{[int(p) for p in bad[:8]]}"
              f"{' max |d| %.3e' % float(np.abs(acc - acc_ref).max())}; "
              f"{close:.4f} of pixels within 2e-3 (>= 0.98), {same:.4f} "
              f"packed equal (>= 0.97); vs JAX on CPU: "
              + ("backend not enabled" if vs_cpu is None else
                 f"{vs_cpu.size} pixels differ "
                 f"{[int(p) for p in vs_cpu[:8]]}"))
    return Check("ae parity vs refimpl",
                 bool(close >= 0.98 and same >= 0.97),
                 detail)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def smoke(*, subdiv: int, layers: int, width: int, height: int, out: str,
          oracle_subdiv: int = 5,
          oracle_n: int = 100000, woodcock_spp: int = 128,
          rmse_size: tuple = (480, 270), parity: bool = True) -> tuple:
    """Phases a-d and the comparisons; returns (phases, checks)."""
    os.makedirs(out, exist_ok=True)
    kw = dict(subdiv=subdiv, layers=layers, width=width, height=height)
    phases, checks = [], []

    pl_a, p = run_phase("a fast Woodcock f32", app_argv(
        ["--sample-limit", "16", "--samples", "8"], out=f"{out}/a", **kw))
    phases.append(p)
    log(phase_line(p))
    pl_b, p = run_phase("b march", app_argv(
        ["--march", "--sample-limit", "2"], out=f"{out}/b", **kw))
    phases.append(p)
    log(phase_line(p))
    pl_c, p = run_phase("c quantized Woodcock", app_argv(
        ["--quantized", "--sample-limit", "16"], out=f"{out}/c", **kw))
    phases.append(p)
    log(phase_line(p))

    t, c = tf_edit_roundtrip(pl_c)
    log(f"phase d TF edit (pipeline c): handler {t['edit_s']:.4f} s, first "
        f"frame after edit {t['first_frame_s']:.4f} s, re-render batch "
        f"{t['batch_s']:.4f} s (before the edit {t['before_batch_s']:.4f} "
        f"s), peak_bytes_in_use {peak_bytes()}")
    checks.append(c)
    for pl in (pl_a, pl_b, pl_c):
        pl.present()

    # Woodcock mean (S samples, pipeline a) vs the march (pipeline b)
    pl_a.sample_limit = woodcock_spp
    render_pass(pl_a)
    checks.append(compare_woodcock_march(pl_a.accum_natural(),
                                         pl_b.accum_natural()))
    checks.append(compare_rmse_q(subdiv, layers, *rmse_size))
    checks.append(compare_march_oracle(oracle_subdiv, layers, width, height,
                                       n=oracle_n))
    if parity:
        checks.append(compare_parity_ae())
    return phases, checks


def sweep(*, out: str, **kw) -> None:
    """Phases a-c at every lane chunk of CHUNKS (ops/fast.CHUNK, which the
    app reads at build): first-call s, steady s/launch, Mray/s."""
    from icon_dvr.ops import fast as fast_ops

    log("chunk sweep (0 = whole covered prefix): phase, chunk, first call "
        "s, steady s/launch, Mray/s full-frame")
    default = fast_ops.CHUNK
    try:
        for chunk in CHUNKS:
            fast_ops.CHUNK = chunk
            for name, extra in (("a", ["--sample-limit", "16", "--samples",
                                       "8"]),
                                ("b", ["--march", "--sample-limit", "2"]),
                                ("c", ["--quantized", "--sample-limit",
                                       "16"])):
                _, p = run_phase(name, app_argv(extra, out=f"{out}/{name}",
                                                **kw))
                log(f"sweep {name} chunk {chunk}: {p.first_s:.3f} "
                    f"{p.steady_s:.4f} {p.mray_full:.3f}")
    finally:
        fast_ops.CHUNK = default


def four_cards(*, subdiv: int, layers: int, width: int, height: int,
               samples: int = 4, chunk: int | None = None) -> list:
    """The multi-card paths on a 4-device mesh, each against one card
    rendering the same `samples` accumulation samples of every pixel:
    a. the quantized tier (fine map on) tile-sharded over 4 tiles;
    b. the scene shard, 2 slabs x 2 tiles.
    Both must show identical coverage and rmse < 0.55 / sqrt(samples)
    (tests/test_scene_shard.py's bound).  (a) is bit-equal on the CPU;
    on a GPU the sharded and one-card programs are compiled apart and
    may round differently, so its RGBA8 difference is reported."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from icon_dvr.models.finemap import build_finemap
    from icon_dvr.ops.fast import CHUNK
    from icon_dvr.ops.fastq import render_frame_fast_q
    from icon_dvr.ops.order import pixel_order
    from icon_dvr.ops.render import alloc_frame
    from icon_dvr.parallel.scene_shard import (build_sharded_scene,
                                               jit_render_frame_scene_sharded,
                                               shard_scene)
    from icon_dvr.parallel.sharded import (alloc_fast_sharded_frame,
                                           gather_frame,
                                           jit_render_frame_fastq_sharded,
                                           make_mesh, plan_fast_sharding,
                                           replicate_tables,
                                           scatter_fast_frame,
                                           shard_local_pix)

    chunk = chunk or CHUNK
    t0 = time.perf_counter()
    ds, stats, q, loc, k_cap, bands, tf, lp, _ = quantized_scene(
        subdiv, layers, width, height)
    # the slab build quantizes the field the same way, so the slabs and
    # the one-card scene hold the same quantized field
    scene, k_s, _ = build_sharded_scene(ds, tf, 2)
    fm = build_finemap(loc, q.test12, k_cap)
    devs = jax.devices()[:4]
    mesh_t = make_mesh(devs, tiles=4, samples=1)
    perm, n_active = pixel_order(lp, stats.spherical_bounds_lo[0],
                                 stats.spherical_bounds_hi[0], width, height)
    local = plan_fast_sharding(perm, n_active, 4, chunk)
    q_r, loc_r, fm_r = replicate_tables(mesh_t, (q, loc, fm))
    pix_dev = shard_local_pix(mesh_t, local)
    mesh_s = Mesh(np.asarray(devs).reshape(2, 2), ("slabs", "tiles"))
    sc = shard_scene(mesh_s, scene)
    log(f"four-card set-up (host scene, slabs, tables, fine map, "
        f"placement): {time.perf_counter() - t0:.3f} s")

    tiled = jit_render_frame_fastq_sharded(mesh_t, width=width, height=height,
                                           chunk=chunk, k_cap=k_cap,
                                           donate=False)
    slabbed = jit_render_frame_scene_sharded(mesh_s, k_s, width=width,
                                             height=height, chunk=chunk,
                                             donate=False)
    acc_t, fb_t = alloc_fast_sharded_frame(mesh_t, local)
    acc_s, fb_s = alloc_frame(width, height)
    acc_s = jax.device_put(acc_s, NamedSharding(mesh_s, P("tiles", None)))
    fb_s = jax.device_put(fb_s, NamedSharding(mesh_s, P("tiles")))
    acc_1, fb_1 = alloc_frame(width, height)
    secs = {"4 tiles": [], "2 slabs x 2 tiles": [], "one card": []}
    for s in range(samples):
        lp_s = lp._replace(accum_id=jnp.int32(s))
        t0 = time.perf_counter()
        acc_t, fb_t = tiled(q_r, loc_r, bands, tf, lp_s, acc_t, fb_t,
                            pix_dev, finemap=fm_r)
        img_t = scatter_fast_frame(gather_frame(fb_t), local, width, height)
        secs["4 tiles"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        acc_s, fb_s = slabbed(sc, bands, tf, lp_s, acc_s, fb_s)
        a_s = np.asarray(acc_s)
        secs["2 slabs x 2 tiles"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        acc_1, fb_1 = render_frame_fast_q(q, loc, k_cap, bands, tf, lp_s,
                                          acc_1, fb_1, width=width,
                                          height=height, chunk=chunk)
        a_1, img_1 = np.asarray(acc_1), np.asarray(fb_1)
        secs["one card"].append(time.perf_counter() - t0)
    for name, t in secs.items():
        log(f"four-card {name}: first sample {t[0]:.3f} s (compile "
            f"included), then {np.median(t[1:] or t):.4f} s/sample "
            f"(1 sample = {width}x{height} rays, host read included)")

    flat = local.reshape(-1)
    dealt = flat >= 0
    a_t = np.zeros_like(a_1)
    a_t[flat[dealt]] = np.asarray(acc_t).reshape(-1, 4)[dealt]
    lsb = np.abs(img_t.view(np.uint8).astype(int)
                 - img_1.view(np.uint8).astype(int)).reshape(-1, 4)
    cov = a_1[:, 3] > 0
    bound = 0.55 / np.sqrt(samples)
    checks = []
    for name, acc, extra in (
            ("4-tile quantized vs one card", a_t,
             f"; max RGBA8 difference {lsb.max()} LSB in "
             f"{int((lsb.max(1) > 0).sum())} pixels"),
            ("scene shard 2x2 vs one card", a_s, "")):
        same_cov = bool(((acc[:, 3] > 0) == cov).all())
        rmse = float(np.sqrt(np.mean((acc[cov] - a_1[cov]) ** 2)))
        checks.append(Check(name, bool(same_cov and rmse < bound),
                            f"{samples} samples, coverage "
                            f"{'identical' if same_cov else 'DIFFERS'}, "
                            f"rmse {rmse:.6f} < {bound:.5f}{extra}"))
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on 4 GPUs")
    ap.add_argument("--sweep", action="store_true",
                    help="after the smoke, sweep the lane chunk of a-c")
    ap.add_argument("--out", default=os.path.join(ROOT, ".cache", "smoke"),
                    help="directory for the phases' PNGs")
    args = ap.parse_args(argv)

    # the GPU first, JAX's CPU backend beside it (the parity comparison
    # renders on both); an explicit other choice is left alone
    if os.environ.get("JAX_PLATFORMS", "cuda") in ("cuda", "gpu"):
        os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    t0 = time.perf_counter()
    log(f"native module rebuilt from native/icon_host.cpp in "
        f"{build_native():.3f} s")
    if not args.four_cards:
        run_gpu_tests()

    import jax
    try:
        device = check_device(jax.devices(), 4 if args.four_cards else None)
    except (NoAccelerator, RuntimeError) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}")
    from icon_dvr.utils.cache import enable_compilation_cache
    log(f"compile cache: {enable_compilation_cache()}")
    log(f"device: {device}")

    kw = dict(subdiv=SUBDIV, layers=LAYERS, width=WIDTH, height=HEIGHT)
    if args.four_cards:
        checks = four_cards(**kw)
    else:
        _, checks = smoke(out=args.out, **kw)
    for c in checks:
        log(f"check {c.name}: {'PASS' if c.ok else 'FAIL'} ({c.detail})")
    if args.sweep:
        sweep(out=args.out, **kw)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if not all(c.ok for c in checks):
        return 1
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
