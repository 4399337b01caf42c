#!/usr/bin/env python
"""icon_rt — the ICON direct-volume renderer application.

Functional port of the reference app (ref: icon_rt/hostCode.cu:703-968):
  positional <file>.ic, --num-cells N, --lat-range lo:hi, --lon-range lo:hi,
  -mode M, plus the common pipeline flags (--bgcolor --sample-limit --xf
  -win/--win/--size -fovy --camera).

Extensions over the reference CLI:
  --synthetic SUBDIV[:LAYERS]  render a generated icosphere field (no .ic)
  --raygen {fast,accel,ae}     fast = radial-band Woodcock raygen (ours);
                               accel/ae = reference-parity raygens
  --accel-mode {sphere,grid}   parity accel selection (reference UI combo)
  --sampler {locator,brute,wedge}  point-sampler (reference 'Sampler mode')
  -o PATH                      output PNG name (default icon_rt.png)
  --quantized / --march / --samples N / --preview N / --no-finemap
                               fast-raygen tiers and options (see below)

Batch behavior matches the reference: renders --sample-limit progressive
frames, writes the PNG, prints FPS.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def parse_app_args(argv):
    cfg = {
        "filepath": None, "num_cells": -1,
        "lat_range": None, "lon_range": None,
        "mode": 1,  # TRIANGLE_MODE default (ref: hostCode.cu:74)
        "synthetic": None, "raygen": "fast", "accel_mode": "sphere",
        "sampler": "locator", "out": "icon_rt", "bands": 64,
        "samples": 8, "finemap": True,
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-") and a.endswith(".ic"):
            cfg["filepath"] = a
        elif a == "--num-cells":
            cfg["num_cells"] = int(argv[i + 1]); i += 1
        elif a == "--lat-range":
            lo, hi = argv[i + 1].split(":"); cfg["lat_range"] = (float(lo), float(hi)); i += 1
        elif a == "--lon-range":
            lo, hi = argv[i + 1].split(":"); cfg["lon_range"] = (float(lo), float(hi)); i += 1
        elif a == "-mode":
            # reference sampler modes (ref: Params.h:29-31): 0 = user geom,
            # 1 = triangles, 2 = cuBQL.  0/1 both resolve to analytic column
            # sampling here (locator); 2 selects the wedge Newton sampler.
            cfg["mode"] = int(argv[i + 1])
            if cfg["mode"] == 2:
                # cuBQL mode: wedge sampling.  Orthogonal to the raygen
                # choice (as in the reference, toggleMode vs toggleRayGen,
                # hostCode.cu:138-168): the fast raygen uses the gather-free
                # wedge tier, the parity raygens the Newton sampler.
                cfg["sampler"] = "wedge"
            else:
                cfg["sampler"] = "locator"
            i += 1
        elif a == "--synthetic":
            s = argv[i + 1].split(":")
            cfg["synthetic"] = (int(s[0]), int(s[1]) if len(s) > 1 else 8); i += 1
        elif a == "--raygen":
            cfg["raygen"] = argv[i + 1]; i += 1
        elif a == "--accel-mode":
            cfg["accel_mode"] = argv[i + 1]; i += 1
        elif a == "--sampler":
            cfg["sampler"] = argv[i + 1]; cfg["sampler_explicit"] = True; i += 1
        elif a == "-o":
            cfg["out"] = argv[i + 1].removesuffix(".png"); i += 1
        elif a == "--quantized":
            # R2B9 tier: u16/u8 cell tables + CSR locator (models/qcells.py)
            cfg["quantized"] = True
        elif a == "--finemap":
            cfg["finemap"] = True
        elif a == "--march":
            # deterministic transmittance march on the fast tiers: one
            # CONVERGED pass per launch instead of Woodcock sampling
            # (ops/march.py; statistically the same image, zero variance)
            cfg["march"] = True
        elif a == "--preview":
            # preview tier scale (pipeline.preview_scale): first frame
            # after any reset at 1/N res, presented upscaled (0 = off;
            # the interactive viewer defaults to 4)
            cfg["preview"] = max(0, int(argv[i + 1])); i += 1
        elif a == "--no-finemap":
            # two-stage locate shortcut on the quantized tier
            # (models/finemap.py) is exact and npz-cached, so it defaults
            # ON; this opts out (e.g. memory-tight scenes)
            cfg["finemap"] = False
        elif a == "--samples":
            # progressive samples accumulated per launch on the fast
            # raygens (in-lane batching, ops/fast.py `samples=`): restarts
            # ride the column cache, so S=8 renders several-fold faster
            # per sample than 8 separate launches
            cfg["samples"] = max(1, int(argv[i + 1])); i += 1
        i += 1
    return cfg


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(__doc__)
        return 0
    pl = build(argv)
    if pl is None:
        return 1
    # render loop (ref: hostCode.cu:931-965)
    while True:
        pl.launch()
        if not pl.is_running():
            break
    pl.present()
    return 0


def build(argv):
    """Construct the fully-wired Pipeline (render fn, toggles, TF handler)
    without running the frame loop — the testable seam for driving runtime
    mode toggles (ref: hostCode.cu:843-857) programmatically."""
    cfg = parse_app_args(argv)

    from icon_dvr.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import jax.numpy as jnp
    from icon_dvr.data import icfile, synthetic
    from icon_dvr.models.accel import (build_grid_accel, build_shell_accel,
                                       update_majorants)
    from icon_dvr.models.cells import build_cells, compute_stats
    from icon_dvr.models.locator import build_locator
    from icon_dvr.models.shells import build_radial_bands, update_band_majorants
    from icon_dvr.models.transfunc import DEFAULT_COLORS
    from icon_dvr.models.wedges import build_wedges
    from icon_dvr.ops.camera import Camera
    from icon_dvr.ops.fast import pack_cells, render_frame_fast
    from icon_dvr.ops.order import inverse_order, pixel_order
    from icon_dvr.ops.render import (alloc_frame, make_launch_params,
                                     render_frame_accel, render_frame_ae)
    from icon_dvr.pipeline.pipeline import Pipeline, TransfuncState

    # -- dataset (ref: hostCode.cu:717-808) ---------------------------------
    if cfg["synthetic"] is not None:
        subdiv, layers = cfg["synthetic"]
        ds = synthetic.icosphere(subdivisions=subdiv, num_layers=layers)
    else:
        if not cfg["filepath"]:
            print("Usage: icon_rt <file.ic> | --synthetic SUBDIV[:LAYERS]",
                  file=sys.stderr)
            return None
        ds = icfile.read_ic(cfg["filepath"], cfg["num_cells"]
                            if cfg["num_cells"] >= 0 else None)
        ds = ds.crop(cfg["lat_range"], cfg["lon_range"])
    print(f"cells: {ds.num_cells}")
    stats = compute_stats(ds)

    cells = build_cells(ds)
    locator = build_locator(ds)
    wedges = build_wedges(ds) if cfg["sampler"] == "wedge" else None

    pl = Pipeline(argv, name=cfg["out"])
    pl.set_frame(512, 512)
    # preview tier (pipeline.preview_pending contract): first frame after
    # any reset renders at width//N when the frame divides evenly.
    # Default OFF in batch mode (batch output must be full-res samples
    # only; golden tests depend on it) — the interactive viewer turns it
    # on (apps/viewer.py), and --preview N forces it anywhere.
    pl.preview_scale = int(cfg.get("preview", 0))

    cam = Camera()
    cam.set_aspect(pl.width / pl.height)
    cam.view_all(stats.world_bounds_lo, stats.world_bounds_hi)
    pl.set_camera(cam)

    if not pl.transfunc_valid():
        vr = stats.data_range
        if not (vr[0] < vr[1]):
            vr = np.array([0.0, 1.0], np.float32)
        pl.set_transfunc(TransfuncState(DEFAULT_COLORS, tuple(vr)))

    # value histogram for the TFE overlay (ref: alpha_editor.cpp:209-234)
    if pl.tfe is not None and ds.num_cells:
        mask = (np.arange(ds.value.shape[1])[None, :]
                < ds.num_layers[:, None])
        counts, _ = np.histogram(ds.value[mask], bins=64,
                                 range=tuple(stats.data_range)
                                 if stats.data_range[0] < stats.data_range[1]
                                 else (0.0, 1.0))
        pl.tfe.set_histogram(counts)

    # unit distance slider scaled to shell magnitude (ref: hostCode.cu:838-841)
    magnitude = np.floor(np.log10(stats.spherical_bounds_lo[0]))
    scale = 10.0 ** (magnitude - 3)
    state = {"unit_distance": 1.0 * scale, "accel_active": True,
             "mode": cfg["mode"], "accel_mode": cfg["accel_mode"],
             "raygen": cfg["raygen"]}
    pl.ui_param("Unit distance", lambda: state["unit_distance"],
                lambda v: state.__setitem__("unit_distance", v),
                minf=0.01 * scale, maxf=5.0 * scale)
    pl.ui_param("Use naive accel", lambda: state["accel_active"],
                lambda v: state.__setitem__("accel_active", v))
    # live mode toggles (ref: hostCode.cu:138-199 toggleRayGen/Mode/
    # AccelMode + UI at :843-857): render() reads `state` every frame, so
    # set_ui_param mid-run swaps the path AND resets accumulation.  The
    # fast raygen is our own extension; its sampler is the analytic
    # column cache and its accel the radial bands, so "Sampler mode" /
    # "Accel mode" apply to the two reference-parity raygens (accel, ae).
    pl.ui_param("Raygen", lambda: state["raygen"],
                lambda v: state.__setitem__("raygen", v),
                options=["fast", "accel", "ae"])
    pl.ui_param("Sampler mode", lambda: state["mode"],
                lambda v: state.__setitem__("mode", v),
                options=["user geom mode", "triangle mode", "cuBQL mode"])
    pl.ui_param("Accel mode", lambda: state["accel_mode"],
                lambda v: state.__setitem__("accel_mode", v),
                options=["sphere accel", "grid accel"])

    def set_opacity(v):
        """Live opacity-scale slider (the reference's ImGui opacityScale,
        ref: tfe.cpp:29-50).  Routed through the TFE dirty flags when one
        exists so the next harvest fires on_tf_update, which takes the
        affine scale-only fast path; headless pipelines mutate the
        transfunc state and fire the handler directly."""
        if pl.tfe is not None:
            pl.tfe.set_opacity_scale(float(v))
        elif pl.transfunc is not None:
            pl.transfunc.opacity = float(v)
            on_tf_update(pl.transfunc, pl.tf_index)

    pl.ui_param("Opacity scale", lambda: (pl.tfe.get_opacity_scale()
                                          if pl.tfe is not None else
                                          (pl.transfunc.opacity
                                           if pl.transfunc else 1.0)),
                set_opacity, minf=0.0, maxf=10.0)

    # -- accel structures: built lazily on first use, majorants refreshed on
    # every TF edit (ref: hostCode.cu:440-701 builds all up front on a GPU;
    # lazily here so a toggled-in mode pays its build once) -----------------
    device = {}
    struct = {"shell": None, "grid": None, "bands": None, "wedges": None,
              "packed": None}

    def get_bands():
        if struct["bands"] is None:
            struct["bands"] = update_band_majorants(
                build_radial_bands(ds, cfg["bands"]),
                device["tf"].values, device["tf"].value_range)
        return struct["bands"]

    def get_packed():
        if struct["packed"] is None:
            struct["packed"] = pack_cells(cells, device["tf"])
        return struct["packed"]

    def get_bands_wedge():
        from icon_dvr.models.shells import build_radial_bands_wedge
        if struct.get("bands_w") is None:
            struct["bands_w"] = update_band_majorants(
                build_radial_bands_wedge(ds, cfg["bands"]),
                device["tf"].values, device["tf"].value_range)
        return struct["bands_w"]

    def get_packed_wedge():
        from icon_dvr.ops.fast import pack_cells_wedge
        if struct.get("packed_w") is None:
            struct["packed_w"] = pack_cells_wedge(cells, device["tf"])
        return struct["packed_w"]

    def get_q():
        """Quantized tier (--quantized): cells + dense locator; TF edits
        re-bake only the u8 alpha channel (models/qcells.bake_alpha_q).
        The finemap (default on, --no-finemap opts out) is npz-cached per
        dataset so a viewer session pays its build once, not per launch."""
        from icon_dvr.models.locator import build_locator_csr, densify_csr
        from icon_dvr.models.qcells import (bake_alpha_q, quantize_cells,
                                            quantize_dataset_values)
        if struct.get("q") is None:
            ds_q, lo, hi = quantize_dataset_values(ds)
            struct["q"] = quantize_cells(ds_q, value_range=(lo, hi))
            csr, k_cap = build_locator_csr(ds_q)
            struct["loc_csr"] = (densify_csr(csr, k_cap), k_cap)
            if cfg.get("finemap"):
                from icon_dvr.data.bigscene import build_finemap_cached
                if cfg["synthetic"] is not None:
                    key = "app_s%d_l%d" % cfg["synthetic"]
                else:
                    st = os.stat(cfg["filepath"])
                    key = ("app_%s_%d_%d" %
                           (os.path.basename(cfg["filepath"])
                            .removesuffix(".ic"), st.st_size,
                            int(st.st_mtime)))
                struct["fm"] = build_finemap_cached(
                    struct["loc_csr"][0], struct["q"].test12, k_cap,
                    factor=2, cache_key=key)
        if struct.get("q_tf") is not device["tf"]:
            struct["q"] = bake_alpha_q(struct["q"], device["tf"])
            struct["q_tf"] = device["tf"]
        return struct["q"], struct["loc_csr"]

    def get_shell():
        if struct["shell"] is None:
            struct["shell"] = update_majorants(
                build_shell_accel(ds, stats.spherical_bounds_lo,
                                  stats.spherical_bounds_hi),
                device["tf"].values, device["tf"].value_range)
        return struct["shell"]

    def get_grid():
        if struct["grid"] is None:
            struct["grid"] = update_majorants(
                build_grid_accel(ds, stats.world_bounds_lo,
                                 stats.world_bounds_hi),
                device["tf"].values, device["tf"].value_range)
        return struct["grid"]

    def get_wedges():
        if struct["wedges"] is None:
            struct["wedges"] = build_wedges(ds)
        return struct["wedges"]

    if wedges is not None:
        struct["wedges"] = wedges

    def on_tf_update(tf_state, index):
        """TF-edit handler: refresh device LUT + majorants of every BUILT
        structure (ref: hostCode.cu:878-909).

        Pure opacity-scale edits (LUT + ranges unchanged) skip the full
        profile re-bake: the baked alpha is affine in the scale
        (ops/fast.pack_alpha_scale_parts), so the edit costs one FMA over
        (N, 32) — the same cost profile as the reference, whose scale is
        a postClassify uniform and whose edits pay only
        computeMaxOpacities (ref: hostCode.cu:878-909)."""
        sig = (tf_state.lut.tobytes(), tf_state.value_range.tobytes(),
               tf_state.rel_range.tobytes())
        scale_only = device.get("tf_sig") == sig
        device["tf_sig"] = sig
        device["tf"] = tf_state.to_device()
        if struct["bands"] is not None:
            struct["bands"] = update_band_majorants(
                struct["bands"], device["tf"].values,
                device["tf"].value_range)
        if struct["shell"] is not None:
            struct["shell"] = update_majorants(
                struct["shell"], device["tf"].values,
                device["tf"].value_range)
        if struct["grid"] is not None:
            struct["grid"] = update_majorants(
                struct["grid"], device["tf"].values,
                device["tf"].value_range)
        if not scale_only:
            struct["alpha_parts"] = None   # parts are baked vs LUT+range
        if struct["packed"] is not None:
            if scale_only:
                from icon_dvr.ops.fast import (apply_opacity_scale,
                                               pack_alpha_scale_parts)
                if struct.get("alpha_parts") is None:
                    struct["alpha_parts"] = pack_alpha_scale_parts(
                        cells, device["tf"])
                struct["packed"] = apply_opacity_scale(
                    struct["packed"], struct["alpha_parts"],
                    device["tf"].opacity_scale)
            else:
                struct["packed"] = pack_cells(cells, device["tf"])
        if struct.get("bands_w") is not None:
            struct["bands_w"] = update_band_majorants(
                struct["bands_w"], device["tf"].values,
                device["tf"].value_range)
        if struct.get("packed_w") is not None:
            from icon_dvr.ops.fast import pack_cells_wedge
            struct["packed_w"] = pack_cells_wedge(cells, device["tf"])

    pl.set_transfunc_update_handler(on_tf_update)
    on_tf_update(pl.transfunc, 0)

    from icon_dvr.ops import fast as fast_ops
    chunk_lanes = fast_ops.CHUNK     # read once per build

    def lanes(n_cov, total):
        """(chunk, n_active) of a fast-raygen frame: n_active is the
        covered prefix rounded up to a power-of-two number of chunks;
        a CHUNK of 0 traces that prefix (bucketed at 4096 lanes) as one
        chunk."""
        from icon_dvr.ops.order import bucket_active
        n_act = bucket_active(n_cov, chunk_lanes or 4096, total)
        return (chunk_lanes or n_act), n_act

    W, H = pl.width, pl.height
    frame = {"accum": None, "fb": None, "perm": None, "inv": None}
    frame["accum"], frame["fb"] = alloc_frame(W, H)

    def render(frame_id):
        raygen = state["raygen"]
        # reference sampler modes (ref: Params.h:29-31): 2 = cuBQL -> the
        # Newton wedge sampler; 0/1 -> analytic column sampling (locator),
        # unless an explicit --sampler (e.g. brute) was given on the CLI
        sampler = "wedge" if state["mode"] == 2 else (
            cfg["sampler"] if cfg.get("sampler_explicit") else "locator")
        # in-lane sample batching on the fast raygens (the interactive
        # path should render at the measured batched rate,
        # not samples=1); clamped so batch mode honors --sample-limit
        # exactly.  Parity raygens stay samples=1 (the oracle contract).
        spl = 1
        if raygen == "fast":
            want = cfg["samples"]
            spl = max(1, min(want,
                             pl.sample_limit - frame_id
                             if not pl.interactive else want))
        pl.samples_per_launch = spl
        if (getattr(pl, "preview_pending", False) and raygen == "fast"
                and (sampler != "wedge" or cfg.get("quantized"))
                and pl.preview_scale > 1
                and W % pl.preview_scale == 0
                and H % pl.preview_scale == 0):
            # PREVIEW tier: cheap first frame after
            # any reset (TF edit / camera move) — 1/scale res, samples=1,
            # presented upscaled; samples_per_launch=0 keeps accumulation
            # honest (the full-res sample 0 renders on the NEXT launch).
            pl.preview_pending = False
            pl.samples_per_launch = 0
            sc = pl.preview_scale
            Wp, Hp = W // sc, H // sc
            lp_p = make_launch_params(
                cam.basis(Wp, Hp), stats.world_bounds_lo,
                stats.world_bounds_hi, ambient_color=(1.0, 1.0, 1.0),
                ambient_radiance=1.0,
                unit_distance=state["unit_distance"], accum_id=0)
            p_p, n_cov_p = pixel_order(lp_p, stats.spherical_bounds_lo[0],
                                       stats.spherical_bounds_hi[0],
                                       Wp, Hp)
            chunk_p, n_act_p = lanes(n_cov_p, Wp * Hp)
            acc_p, fb_p = alloc_frame(Wp, Hp)
            if cfg.get("quantized"):
                from icon_dvr.ops.fastq import render_frame_fast_q
                qc, (loc_csr, k_cap) = get_q()
                acc_p, fb_p = render_frame_fast_q(
                    qc, loc_csr, k_cap, get_bands(), device["tf"], lp_p,
                    acc_p, fb_p, width=Wp, height=Hp,
                    pixel_perm=jnp.asarray(p_p), n_active=n_act_p,
                    finemap=struct.get("fm"), samples=1, chunk=chunk_p,
                    refresh_compact=chunk_p // 4)
            else:
                acc_p, fb_p = render_frame_fast(
                    cells, get_packed(), locator, get_bands(), lp_p,
                    acc_p, fb_p, width=Wp, height=Hp,
                    pixel_perm=jnp.asarray(p_p), n_active=n_act_p,
                    samples=1, chunk=chunk_p, refresh_compact=chunk_p // 4)
            small = np.asarray(fb_p)[inverse_order(p_p)].reshape(Hp, Wp)
            frame["natural"] = True
            return np.repeat(np.repeat(small, sc, axis=0),
                             sc, axis=1).ravel()
        frame["natural"] = False
        if frame_id == 0:
            frame["accum"], frame["fb"] = alloc_frame(W, H)
            frame["raygen"] = raygen  # mode changes reset accumulation, so
            # the buffer layout (permuted for fast, natural otherwise) is
            # consistent within one accumulation run
        lp = make_launch_params(
            cam.basis(W, H), stats.world_bounds_lo, stats.world_bounds_hi,
            ambient_color=(1.0, 1.0, 1.0), ambient_radiance=1.0,
            unit_distance=state["unit_distance"], accum_id=frame_id)
        if raygen == "fast":
            if frame["perm"] is None or frame_id == 0:
                # re-sort rays by expected cost on camera change
                p, n_cov = pixel_order(lp, stats.spherical_bounds_lo[0],
                                       stats.spherical_bounds_hi[0], W, H)
                frame["inv"] = inverse_order(p)
                frame["perm"] = jnp.asarray(p)
                frame["chunk"], frame["n_active"] = lanes(n_cov, W * H)
            chunk = frame["chunk"]
            # compacted refresh tiers: lanes/4 base capacity
            compact = chunk // 4
            if cfg.get("march") and sampler != "wedge":
                # deterministic transmittance march (ops/march.py): each
                # launch adds ONE jittered CONVERGED pass; a handful of
                # passes antialias.
                pl.samples_per_launch = 1
                if cfg.get("quantized"):
                    from icon_dvr.ops.march import render_frame_march_q
                    qc, (loc_csr, k_cap) = get_q()
                    frame["accum"], frame["fb"] = render_frame_march_q(
                        qc, loc_csr, k_cap, get_bands(), device["tf"], lp,
                        frame["accum"], frame["fb"], width=W, height=H,
                        pixel_perm=frame["perm"],
                        n_active=frame["n_active"], chunk=chunk)
                else:
                    from icon_dvr.ops.march import render_frame_march
                    frame["accum"], frame["fb"] = render_frame_march(
                        cells, get_packed(), locator, get_bands(), lp,
                        frame["accum"], frame["fb"], width=W, height=H,
                        pixel_perm=frame["perm"],
                        n_active=frame["n_active"], chunk=chunk)
            elif cfg.get("quantized"):
                from icon_dvr.ops.fastq import render_frame_fast_q
                qc, (loc_csr, k_cap) = get_q()
                frame["accum"], frame["fb"] = render_frame_fast_q(
                    qc, loc_csr, k_cap, get_bands(), device["tf"], lp,
                    frame["accum"], frame["fb"],
                    width=W, height=H, pixel_perm=frame["perm"],
                    n_active=frame["n_active"], finemap=struct.get("fm"),
                    samples=spl, chunk=chunk, refresh_compact=compact)
            elif sampler == "wedge":
                # mode 2 on the fast raygen: the gather-free wedge tier
                # (live toggle peer of hostCode.cu:151-168)
                frame["accum"], frame["fb"] = render_frame_fast(
                    cells, get_packed_wedge(), locator, get_bands_wedge(),
                    lp, frame["accum"], frame["fb"],
                    width=W, height=H, pixel_perm=frame["perm"],
                    n_active=frame["n_active"], sampler="wedge",
                    samples=spl, chunk=chunk, refresh_compact=compact)
            else:
                frame["accum"], frame["fb"] = render_frame_fast(
                    cells, get_packed(), locator, get_bands(), lp,
                    frame["accum"], frame["fb"],
                    width=W, height=H, pixel_perm=frame["perm"],
                    n_active=frame["n_active"],
                    samples=spl, chunk=chunk, refresh_compact=compact)
        elif raygen == "accel" and state["accel_active"]:
            accel_mode = state["accel_mode"]
            accel = get_shell() if accel_mode == "sphere" else get_grid()
            frame["accum"], frame["fb"] = render_frame_accel(
                cells, device["tf"], accel, lp, frame["accum"], frame["fb"],
                width=W, height=H, accel_mode=accel_mode,
                sampler=sampler, locator=locator,
                wedges=get_wedges() if sampler == "wedge" else None)
        else:
            frame["accum"], frame["fb"] = render_frame_ae(
                cells, device["tf"], lp, frame["accum"], frame["fb"],
                width=W, height=H, sampler=sampler, locator=locator,
                wedges=get_wedges() if sampler == "wedge" else None)
        return frame["fb"]

    pl.set_render_fn(render)

    def accum_natural():
        """Host copy of the (W*H, 4) linear-RGBA accumulation buffer in
        natural pixel order (the fast raygen accumulates ray-sorted)."""
        acc = np.asarray(frame["accum"])
        if (frame.get("raygen") == "fast" and frame["inv"] is not None
                and not frame.get("natural")):
            acc = acc[frame["inv"]]
        return acc
    pl.accum_natural = accum_natural

    def present_fn(fb, w, h):
        # fast path renders in ray-sorted order; unpermute on the host
        # (preview frames arrive already in natural order, upscaled)
        if (frame.get("raygen") == "fast" and frame["inv"] is not None
                and not frame.get("natural")):
            fb = fb[frame["inv"]]
        pl.write_frame(fb)
    pl.present_fn = present_fn
    return pl


if __name__ == "__main__":
    sys.exit(main())
