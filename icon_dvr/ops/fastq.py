"""Quantized fast raygen — the R2B9 single-chip tier.

Same tracking machine as ops/fast.py (radial-band Woodcock + column-resident
sampling; identical step_core, parameterized to the h|A|V profile-cache
layout), different storage plane:

  * cells: models/qcells.QuantizedCells (48 B + 4*Lm B per cell vs 704 B)
  * locator: a dense models/locator.Locator over the quantized scene
    (see models/locator.densify_csr for why not the CSR)
  * refresh: gathers quantized rows and DEQUANTIZES into the same f32
    per-lane caches the step loop reads — the hot loop never sees u8/u16.
  * shading: the accepted sample's dequantized value is classified through
    the LIVE transfer-function LUT (one small gather per finished ray), so
    RGB needs no bake at all; TF edits re-bake only alpha_q
    (models/qcells.bake_alpha_q).

The estimator is delta tracking on the quantized field — unbiased for that
field; quantization deltas are <= half a level (docs/PARITY.md).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.locator import Locator
from ..models.qcells import QuantizedCells
from ..models.shells import RadialBands
from ..models.transfunc import (Transfunc, pack_lut, post_classify_packed)
from .fast import (CHUNK, F32, _Consts, _State, _fill_slots, _init_lanes,
                   _make_refresh, batch_loop, step_core)

__all__ = ["render_fast_q", "render_frame_fast_q"]


def _expand_test16(t12):
    """(L, 12) storage row -> (L, 16) step-cache layout
    ((nx,ny,nz,w)x3 + h_bot + h_top + nl + pad), w == 0 exactly (side
    planes pass through the origin: column edges are radial)."""
    L = t12.shape[0]
    z = jnp.zeros((L, 1), F32)
    return jnp.concatenate(
        [t12[:, 0:3], z, t12[:, 3:6], z, t12[:, 6:9], z,
         t12[:, 9:12], z], axis=1)


def _locate_q(loc: Locator, q: QuantizedCells, k_cap: int,
              px, py, pz, r, pend):
    """Quantized-tier locator query core on (M,) position arrays: dense
    candidate rows + dequantizing profile build.  Shared by the dense
    refresh (M = L) and the compacted refresh (M = P); identical
    arithmetic either way.  Returns (test16, prof, cid, hit).

    All tables are PACK-8 row layouts (utils/layout.pack_table): gathers
    are aligned 128-wide rows + arithmetic subrow selects (a layout chosen
    for 128-lane tiles; the H100 A/B is ROADMAP D2)."""
    from ..utils.layout import packed_gather
    lm = q.lm
    n_lat = loc.dims[0]
    n_lon = loc.dims[1]
    lat = jnp.arcsin(jnp.clip(pz / r, -1.0, 1.0))
    lon = jnp.arctan2(py, px)
    bl = jnp.clip(((lat - loc.lat_lo) / (loc.lat_hi - loc.lat_lo)
                   * n_lat.astype(F32)).astype(jnp.int32), 0, n_lat - 1)
    bo = jnp.clip(((lon - loc.lon_lo) / (loc.lon_hi - loc.lon_lo)
                   * n_lon.astype(F32)).astype(jnp.int32), 0, n_lon - 1)
    bid = jnp.where(pend, bl * n_lon + bo, 0)
    cand = packed_gather(loc.bins, bid, k_cap)       # (M, K)
    return _test_and_fill(q, cand, px, py, pz, r, pend)


def _test_and_fill(q: QuantizedCells, cand, px, py, pz, r, pend,
                   return_rows: bool = False):
    """Shared locate tail: containment-test the (M, K) candidate ids,
    pick the winner, and build the dequantized (test16, prof) cache rows.
    K is k_cap (16) for the full coarse-locator query and 4 for the
    fine-map primary (models/finemap.py) — same arithmetic, so a primary
    hit is bit-identical to the full query's fill (up to f32 boundary
    ties where a point on a shared radial plane belongs to both
    columns).

    return_rows additionally returns (trows, valid): the gathered
    (M, K, 12) candidate test rows and their validity mask — the
    deterministic march (ops/march.py) derives exact gap-skip distances
    from them without a second candidate gather."""
    from ..utils.layout import packed_gather
    lm = q.lm
    valid = cand >= 0
    safe = jnp.maximum(cand, 0)
    trows = packed_gather(q.test12, safe, 12)        # (M, K, 12)
    ev1 = (trows[..., 0] * px[:, None] + trows[..., 1] * py[:, None]
           + trows[..., 2] * pz[:, None])
    ev2 = (trows[..., 3] * px[:, None] + trows[..., 4] * py[:, None]
           + trows[..., 5] * pz[:, None])
    ev3 = (trows[..., 6] * px[:, None] + trows[..., 7] * py[:, None]
           + trows[..., 8] * pz[:, None])
    inside = (valid & (r[:, None] >= trows[..., 9])
              & (r[:, None] <= trows[..., 10])
              & (ev1 <= 0.0) & (ev2 <= 0.0) & (ev3 <= 0.0))
    hit = jnp.any(inside, axis=1)
    slot = jnp.argmax(inside, axis=1)
    k_oh = (jnp.arange(cand.shape[1])[None, :] == slot[:, None])
    cid = jnp.sum(jnp.where(k_oh, safe, 0), axis=1)
    t12 = jnp.sum(jnp.where(k_oh[..., None], trows, 0.0),
                  axis=1)                            # (M, 12)

    cid2 = jnp.where(pend & hit, cid, 0)
    h_bot = t12[:, 9]
    h_top = t12[:, 10]
    nl = t12[:, 11].astype(jnp.int32)
    # h_frac stays unpacked: (1, Lm) dedup shared row (clamp-index) or
    # (N, Lm) plain on small real-terrain scenes
    hf = q.h_frac[jnp.minimum(cid2, q.h_frac.shape[0] - 1)].astype(F32)
    heights = h_bot[:, None] + hf * ((h_top - h_bot)[:, None]
                                     * jnp.float32(1.0 / 65535.0))
    k1 = jax.lax.broadcasted_iota(jnp.int32, heights.shape, 1) + 1
    heights = jnp.where(k1 <= nl[:, None], heights, jnp.float32(np.inf))
    aa = packed_gather(q.alpha_q, cid2, lm).astype(F32) \
        * (q.alpha_max / 255.0)                               # (M, Lm)
    vv = q.value_lo + packed_gather(q.value_q, cid2, lm).astype(F32) \
        * ((q.value_hi - q.value_lo) / 255.0)                 # (M, Lm)
    prof = jnp.concatenate([heights, aa, vv], axis=1)         # (M, 3*Lm)
    if return_rows:
        return _expand_test16(t12), prof, cid2, hit, trows, valid
    return _expand_test16(t12), prof, cid2, hit


def _refresh_q(s: _State, c: _Consts, loc: Locator, q: QuantizedCells,
               k_cap: int, org, oo) -> _State:
    """Dense batched locator refresh + dequantizing cache fill (every
    lane's gathers execute; see ops/fast._refresh for when to prefer the
    compacted path)."""
    ox, oy, oz = org
    pend = s.pending != 0
    px = ox + c.dx * s.t
    py = oy + c.dy * s.t
    pz = oz + c.dz * s.t
    r = jnp.sqrt(jnp.maximum(oo + 2.0 * s.t * c.od + s.t * s.t, 1e-30))
    test16, prof, cid, hit = _locate_q(loc, q, k_cap, px, py, pz, r, pend)
    return _fill_slots(s, pend & hit, test16, prof, cid)


def _locate_q_fine(fm, loc: Locator, k_cap: int, q: QuantizedCells,
                   px, py, pz, r, pend):
    """Fine-map primary locate: one 4-slot map row + one coarse locator
    row (the u8 slot decode, models/finemap.slots_to_cells) + 4
    candidate test rows instead of the coarse bins row + k_cap test
    rows.  `hit` false means the point is in none of the mapped
    candidates — the caller keeps those lanes pending for the
    authoritative full query (ops/fast._make_refresh second stage)."""
    from ..models.finemap import K_CAND, slots_to_cells
    from ..utils.layout import packed_gather
    f_lat = fm.dims[0]
    f_lon = fm.dims[1]
    lat = jnp.arcsin(jnp.clip(pz / r, -1.0, 1.0))
    lon = jnp.arctan2(py, px)
    fl = jnp.clip(((lat - fm.lat_lo) / (fm.lat_hi - fm.lat_lo)
                   * f_lat.astype(F32)).astype(jnp.int32), 0, f_lat - 1)
    fo = jnp.clip(((lon - fm.lon_lo) / (fm.lon_hi - fm.lon_lo)
                   * f_lon.astype(F32)).astype(jnp.int32), 0, f_lon - 1)
    fbid = jnp.where(pend, fl * f_lon + fo, 0)
    slots = packed_gather(fm.pairs, fbid, K_CAND)    # (M, 4) u8
    cand = slots_to_cells(fm, loc, k_cap, fbid, slots)
    return _test_and_fill(q, cand, px, py, pz, r, pend)


def _shade_q(s: _State, c: _Consts, lp, tf: Transfunc, lutp, oo, lm: int):
    """Composite color of a finished lane: the accepted sample's cached
    dequantized VALUE classified through the live LUT (ref semantics:
    deviceCode.cu:333-340; RGB classify at shade time replaces the f32
    path's baked per-layer RGB).  `lutp` is the pack_lut'd LUT — shade
    runs inside every service phase of the batched loop, so its per-lane
    LUT reads must be aligned row gathers, not 4-wide ones."""
    got = s.alpha > 0.0
    # the accepting lane's c_mru points at the collided column's slot
    prof = jnp.where((s.c_mru != 0)[:, None], s.c_prof2, s.c_prof)
    r = jnp.sqrt(jnp.maximum(oo + 2.0 * s.t * c.od + s.t * s.t, 1e-30))
    hh = prof[:, :lm]
    layer = jnp.sum((r[:, None] > hh).astype(jnp.int32), axis=1)
    ids = jax.lax.broadcasted_iota(jnp.int32, (hh.shape[0], lm), 1)
    oh = (ids == layer[:, None]).astype(F32)
    v = jnp.sum(oh * prof[:, 2 * lm:3 * lm], axis=1)          # (L,)
    rgba = post_classify_packed(tf, lutp, v)     # (L,) aligned row gathers
    amb_r = lp.ambient_color[0] * lp.ambient_radiance
    amb_g = lp.ambient_color[1] * lp.ambient_radiance
    amb_b = lp.ambient_color[2] * lp.ambient_radiance
    zero = jnp.zeros_like(s.t)
    return (jnp.where(got, rgba[:, 0] * amb_r, zero),
            jnp.where(got, rgba[:, 1] * amb_g, zero),
            jnp.where(got, rgba[:, 2] * amb_b, zero),
            jnp.where(got, 1.0, 0.0))


def render_fast_q(q: QuantizedCells, loc: Locator, k_cap: int,
                  bands: RadialBands, tf: Transfunc, lp, xs, ys,
                  width: int, height: int, steps_per_refresh: int = 8,
                  max_outer: int = 16384, return_cost: bool = False,
                  outer_unroll: int = 1, refresh_compact: int = 0,
                  finemap=None, return_t: bool = False, rng_salt: int = 0):
    """One progressive sample for a batch of pixels on the quantized tier.
    Returns (wrote (L,) bool, color_alpha (L, 4) f32) [+ per-lane cost
    (outer iterations to completion) when return_cost].

    return_t: also return the accepted collision's ray parameter ((L,)
    f32, +inf for no collision) — the scene-sharded composite key
    (parallel/scene_shard.py).  rng_salt: see ops/fast._init_lanes."""
    nb = bands.num_bands
    edges = bands.edges
    majors = bands.max_opacities
    lm = q.lm

    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    oo = ox * ox + oy * oy + oz * oz
    org = (ox, oy, oz)
    ud = lp.unit_distance

    init, consts, wrote = _init_lanes(lp, xs, ys, width, height,
                                      edges, majors, oo, nb, prof_w=3 * lm,
                                      rng_salt=rng_salt)

    refresh = _make_refresh(
        lambda s, c: _refresh_q(s, c, loc, q, k_cap, org, oo),
        lambda px, py, pz, r, pend: _locate_q(loc, q, k_cap, px, py, pz,
                                              r, pend),
        org, oo, refresh_compact,
        primary_locate=None if finemap is None else
        (lambda px, py, pz, r, pend: _locate_q_fine(finemap, loc, k_cap,
                                                    q, px, py, pz, r,
                                                    pend)))

    def inner_phase(s: _State) -> _State:
        # Python-unrolled so XLA fuses all steps into one kernel per outer
        # iteration (one memory round trip of the live state; see
        # ops/fast.py)
        for _ in range(steps_per_refresh):
            s = step_core(s, consts, edges, majors, org, oo, ud,
                          nb, ml=lm, a_off=lm)
        return s

    def outer_cond(carry):
        s, it, fin = carry
        return jnp.any(s.done == 0) & (it < max_outer)

    def outer_body(carry):
        # unrolled; see ops/fast.render_fast (bit-identical cadence)
        s, it, fin = carry
        for _ in range(outer_unroll):
            s = jax.lax.cond(jnp.any(s.pending != 0),
                             lambda x: refresh(x, consts),
                             lambda x: x, s)
            s = inner_phase(s)
            it = it + 1
            fin = jnp.where((s.done != 0) & (fin < 0), it, fin)
        return (s, it, fin)

    out, _, fin = jax.lax.while_loop(
        outer_cond, outer_body,
        (init, jnp.int32(0), jnp.where(init.done != 0, 0, -1)))
    color_alpha = jnp.stack(_shade_q(out, consts, lp, tf, pack_lut(tf),
                                     oo, lm), axis=-1)
    if return_t:
        assert not return_cost
        t_hit = jnp.where(out.alpha > 0.0, out.t, jnp.float32(np.inf))
        return wrote, color_alpha, t_hit
    if return_cost:
        return wrote, color_alpha, jnp.maximum(fin, 0)
    return wrote, color_alpha


def render_fast_q_batch(q: QuantizedCells, loc: Locator, k_cap: int,
                        bands: RadialBands, tf: Transfunc, lp, xs, ys,
                        width: int, height: int, accum0, fb0, samples: int,
                        steps_per_refresh: int = 8, max_outer: int = 16384,
                        outer_unroll: int = 1, refresh_compact: int = 0,
                        preserve_cache: bool = True, finemap=None,
                        return_stats: bool = False, service_cap: int = -1):
    """`samples` progressive samples per lane in ONE wavefront loop — the
    quantized-tier instantiation of ops/fast.batch_loop.

    service_cap: flat-service capacity (-1 auto = flat at half the lane
    width for giant tables, legacy cond-ladder otherwise — see
    ops/fast._resolve_service_cap; 0 = legacy; >0 = flat)."""
    nb = bands.num_bands
    edges = bands.edges
    majors = bands.max_opacities
    lm = q.lm
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    oo = ox * ox + oy * oy + oz * oz
    org = (ox, oy, oz)
    ud = lp.unit_distance

    def init(samp):
        return _init_lanes(lp, xs, ys, width, height, edges, majors, oo, nb,
                           prof_w=3 * lm, accum_id=lp.accum_id + samp)

    refresh = _make_refresh(
        lambda s, c: _refresh_q(s, c, loc, q, k_cap, org, oo),
        lambda px, py, pz, r, pend: _locate_q(loc, q, k_cap, px, py, pz,
                                              r, pend),
        org, oo, refresh_compact,
        primary_locate=None if finemap is None else
        (lambda px, py, pz, r, pend: _locate_q_fine(finemap, loc, k_cap,
                                                    q, px, py, pz, r,
                                                    pend)))

    lutp = pack_lut(tf)

    def shade(s, c):
        return _shade_q(s, c, lp, tf, lutp, oo, lm)

    def inner_phase(s, c):
        for _ in range(steps_per_refresh):   # unrolled; see ops/fast.py
            s = step_core(s, c, edges, majors, org, oo, ud,
                          nb, ml=lm, a_off=lm)
        return s

    from .fast import _resolve_service_cap, _two_stage_locate
    service_cap = _resolve_service_cap(service_cap, q.num_cells,
                                       xs.shape[0])
    full5 = lambda px, py, pz, r, ok: (
        *_locate_q(loc, q, k_cap, px, py, pz, r, ok), ok)
    if service_cap <= 0:
        flat_locate = None
    elif finemap is not None:
        flat_locate = _two_stage_locate(
            lambda px, py, pz, r, ok: _locate_q_fine(finemap, loc, k_cap,
                                                     q, px, py, pz, r, ok),
            lambda px, py, pz, r, ok: _locate_q(loc, q, k_cap, px, py,
                                                pz, r, ok),
            min(max(service_cap // 8, 128), service_cap))
    else:
        flat_locate = full5

    return batch_loop(init, refresh, shade, inner_phase, lp, accum0, fb0,
                      samples, max_outer, outer_unroll, preserve_cache,
                      return_stats=return_stats, service_cap=service_cap,
                      flat_locate=flat_locate)


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "steps_per_refresh",
                                    "chunk", "k_cap", "n_active",
                                    "return_cost", "samples",
                                    "outer_unroll", "refresh_compact",
                                    "preserve_cache", "service_cap"),
                   donate_argnames=("accum", "fb"))
def render_frame_fast_q(q: QuantizedCells, loc: Locator, k_cap: int,
                        bands: RadialBands, tf: Transfunc, lp, accum, fb, *,
                        width: int, height: int, steps_per_refresh: int = 8,
                        chunk: int = CHUNK, pixel_perm=None,
                        n_active: int | None = None,
                        return_cost: bool = False,
                        samples: int = 1,
                        outer_unroll: int = 1,
                        refresh_compact: int = 0,
                        preserve_cache: bool = True,
                        finemap=None, service_cap: int = -1):
    """Full-frame progressive step on the quantized tier — drop-in peer of
    ops/fast.render_frame_fast (same pixel_perm / n_active / return_cost /
    samples contract)."""
    from .render import _finalize  # local import to avoid cycle

    total = width * height
    pix = jnp.arange(total, dtype=jnp.int32)
    if pixel_perm is not None:
        pix = pixel_perm
    if n_active is not None and pixel_perm is not None:
        n_proc = min(total, -(-max(n_active, 1) // chunk) * chunk)
    else:
        n_proc = total
    pix = pix[:n_proc]
    ys_all, xs_all = jnp.divmod(pix, width)

    if samples > 1:
        assert not return_cost
        from .fast import _run_batched_generic
        accum_head, fb_head = _run_batched_generic(
            lambda xs, ys, a0, f0: render_fast_q_batch(
                q, loc, k_cap, bands, tf, lp, xs, ys, width, height,
                a0, f0, samples, steps_per_refresh,
                outer_unroll=outer_unroll, refresh_compact=refresh_compact,
                preserve_cache=preserve_cache, finemap=finemap,
                service_cap=service_cap),
            xs_all, ys_all, accum[:n_proc], fb[:n_proc], chunk, n_proc)
        if n_proc == total:
            return accum_head, fb_head
        return (jnp.concatenate([accum_head, accum[n_proc:]]),
                jnp.concatenate([fb_head, fb[n_proc:]]))

    def run(xs, ys):
        return render_fast_q(q, loc, k_cap, bands, tf, lp, xs, ys,
                             width, height, steps_per_refresh,
                             return_cost=return_cost,
                             outer_unroll=outer_unroll,
                             refresh_compact=refresh_compact,
                             finemap=finemap)

    if n_proc <= chunk:
        out = run(xs_all, ys_all)
        wrote, ca = out[0], out[1]
        cost = out[2] if return_cost else None
    else:
        n = -(-n_proc // chunk)
        pad = n * chunk - n_proc
        if pad:
            xs_all = jnp.concatenate([xs_all, jnp.zeros(pad, jnp.int32)])
            ys_all = jnp.concatenate([ys_all, jnp.zeros(pad, jnp.int32)])
        out = jax.lax.map(
            lambda cc: run(cc[0], cc[1]),
            (xs_all.reshape(n, chunk), ys_all.reshape(n, chunk)))
        wrote = out[0].reshape(-1)[:n_proc]
        ca = out[1].reshape(-1, 4)[:n_proc]
        cost = out[2].reshape(-1)[:n_proc] if return_cost else None
    accum_head, fb_head = _finalize(wrote, ca, accum[:n_proc], fb[:n_proc],
                                    lp.accum_id)
    if n_proc == total:
        accum_out, fb_out = accum_head, fb_head
    else:
        accum_out = jnp.concatenate([accum_head, accum[n_proc:]])
        fb_out = jnp.concatenate([fb_head, fb[n_proc:]])
    if not return_cost:
        return accum_out, fb_out
    cost_nat = jnp.zeros(total, jnp.int32).at[pix].set(cost)
    return accum_out, fb_out, cost_nat
