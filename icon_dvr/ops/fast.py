"""The fast raygen: radial-band Woodcock tracking with column-resident
sampling.

Why this exists.  The reference-parity raygens (ops/traverse.py) replicate
the CUDA control flow, which costs one indexed memory lookup per Woodcock
step (cell location + LUT classify).  On a wide vector machine a random
per-lane gather costs far more than a lane of arithmetic, so the parity
paths are gather-bound.  This raygen is a from-scratch design around that
constraint (SURVEY §7 'hard parts' (b)); its gather-vs-arithmetic ratio is
not yet measured on the H100 (ROADMAP D2):

  * SoA scalar layout — every per-ray quantity is its own (L,) array; no
    (L, 3) vectors, no minor-axis reductions, so every lane does work.
  * Empty-space skipping via RADIAL majorant bands (models/shells.py):
    band crossings are closed-form sphere intersections computed from two
    per-ray scalars; the per-band majorant is a one-hot sum.  Zero memory
    traffic in the traversal.
  * Column-resident sampling: each lane caches its current column's packed
    record (side planes, radial bounds, per-layer heights and PRE-CLASSIFIED
    RGBA).  A Woodcock sample inside the cached column is pure arithmetic
    (plane tests + ascending-first-match layer select) — classification
    included, because classify(value[layer]) is per-(cell, layer) constant
    for a fixed transfer function and is baked into the record at TF-edit
    time.  Gathers happen only when a lane's sample exits its cached
    column ("refresh"), and all stalled lanes share one batched refresh.
  * Two-phase loop: an outer while iteration performs one batched locator
    refresh, then `steps_per_refresh` gather-free steps, Python-unrolled so
    XLA fuses them into one kernel.  (A hand-written kernel of the same
    phase lost to XLA's fusion on the earlier accelerator and was removed;
    a GPU megakernel of the inner loop is ROADMAP S6.)
  * Ray ordering (ops/order.py) sorts pixels by expected cost so the
    lane-masked loop isn't bound by one slow ray per 64k chunk.

The estimator is standard delta tracking with a conservative, piecewise-
constant-in-radius majorant: unbiased, so converged images match the
reference-parity modes (verified statistically in tests); per-sample RNG
streams differ by design.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data.icfile import MAX_LAYERS
from ..models.cells import Cells
from ..models.locator import Locator
from ..models.shells import RadialBands
from ..models.transfunc import Transfunc, post_classify
from ..utils.lcg import lcg_init, lcg_next

F32 = jnp.float32
PROF_W = MAX_LAYERS * 2   # heights (32) + classified alpha (32)

#: lanes per lax.map chunk of a full-frame wavefront (every render_frame_*
#: default, the app and the bench).  Scheduling only: the output does not
#: depend on it (tests/test_chunk.py).  Set from the H100 sweep in PERF.md.
CHUNK = 131072


# ===========================================================================
# Packed per-cell records
# ===========================================================================

# Flat-service auto gate (batch_loop service_cap=-1).  The flat loop —
# zero lax.cond in the body, one unconditional compact service per outer
# iteration — wins only where the legacy ladder's cond boundaries are the
# dominant cost: giant tables whose state copies dwarf the locate work
# (R2B9-class).  At small/mid tables the ladder's conds SKIP whole service
# phases that flat pays unconditionally.  The 16M-cell gate was chosen on
# the earlier accelerator; the H100 A/B is ROADMAP D2.
FLAT_AUTO_MIN_CELLS = 16_000_000


def _resolve_service_cap(service_cap: int, n_cells: int, lanes: int) -> int:
    """-1 auto -> flat at half the lane width for giant tables, legacy
    cond-ladder (0) otherwise; explicit values pass through."""
    if service_cap < 0:
        if n_cells >= FLAT_AUTO_MIN_CELLS:
            return max(lanes // 2, 128)
        return 0
    return service_cap


class PackedCells(NamedTuple):
    """Per-cell data packed into single gather-rows, split hot/cold.

    test: (N, 16) f32 — 3 side planes (nx,ny,nz,w)x3, h_bot, h_top,
          float(num_layers), pad.
    prof: (N, 64) f32 — per-layer ceiling heights h[1..32] (inf-padded
          past num_layers) then the CLASSIFIED per-layer ALPHA, planar
          (h[32] | A[32]).  This is the row cached per lane: the tracking
          loop only ever needs (layer-of-r, alpha), so keeping RGB out of
          the hot row cuts both the refresh gather and the per-step live
          state by 2.5x (the loop is memory-bound).
    rgb:  (N, 96) f32 — classified per-layer RGB planar (R|G|B), gathered
          ONCE per finished ray at shade time via the cached cell id.
    """
    test: jnp.ndarray
    prof: jnp.ndarray
    rgb: jnp.ndarray


def pack_test_rows(cells: Cells) -> jnp.ndarray:
    n = cells.num_cells
    rows = jnp.zeros((n, 16), F32)
    rows = rows.at[:, 0:12].set(cells.planes.reshape(n, 12))
    rows = rows.at[:, 12].set(cells.h_bot)
    rows = rows.at[:, 13].set(cells.h_top)
    rows = rows.at[:, 14].set(cells.num_layers.astype(F32))
    return rows


@jax.jit
def pack_profile_rows(cells: Cells, tf: Transfunc
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Bake heights + classified per-layer RGBA; returns (prof (N, 64),
    rgb (N, 96)) — see PackedCells.  Re-run on TF edits (the fast-path
    analog of the reference's computeMaxOpacities TF-edit hook,
    ref: hostCode.cu:878-909).

    Classification is computed per CHANNEL over (N, 32) arrays: a vmapped
    (N, 32, 4) intermediate with a 4-wide minor dim pads badly on
    128-lane tiled layouts."""
    heights_hi = jnp.concatenate(
        [cells.height[:, 1:], cells.height[:, -1:]], axis=1)  # (N, 32)
    k = jnp.arange(1, MAX_LAYERS + 1)
    valid = k[None, :] <= cells.num_layers[:, None]
    heights_hi = jnp.where(valid, heights_hi, jnp.float32(np.inf))

    # postClassify arithmetic (ref: deviceCode.cu:127-135), channel-planar
    chans = _classify_channels(cells.value, cells.num_layers, tf)
    prof = jnp.concatenate([heights_hi, chans[3]], axis=1)
    rgb = jnp.concatenate(chans[:3], axis=1)
    return prof, rgb


def pack_cells(cells: Cells, tf: Transfunc) -> PackedCells:
    prof, rgb = pack_profile_rows(cells, tf)
    return PackedCells(test=pack_test_rows(cells), prof=prof, rgb=rgb)


def _classify_channels(values, nl, tf: Transfunc):
    """postClassify per channel over (N, 32) value arrays (see
    pack_profile_rows); returns [R, G, B, A] each (N, 32).

    The LUT reads are a fused compare-select reduce over the `size`
    levels instead of per-element 1-D gathers (the same pattern as
    models/qcells._bake_lookup; chosen where 1-D gathers lowered to scalar
    loads, not yet measured on the H100 — ROADMAP D2).  The one-hot sum
    reproduces the gather exactly up to FMA contraction (<= 1 ULP on the
    chunked path).  Chunked over rows so the fused (rows, 32, size)
    intermediate stays small."""
    size = tf.size
    vn = (values - tf.value_range[0]) \
        / (tf.value_range[1] - tf.value_range[0])
    vs = vn * jnp.float32(size)
    idx = vs.astype(jnp.int32)
    frac = vs - idx.astype(jnp.float32)
    i1 = jnp.clip(idx, 0, size - 1)
    i2 = jnp.clip(idx + 1, 0, size - 1)

    lev = jnp.arange(size, dtype=jnp.int32)
    scale_a = tf.opacity_scale.astype(jnp.float32)

    def classify_rows(args):
        i1c, i2c, fr = args
        m1 = i1c[..., None] == lev
        m2 = i2c[..., None] == lev
        outs = []
        for c in range(4):
            lut_c = tf.values[:, c]
            scale = scale_a if c == 3 else jnp.float32(1.0)
            a1 = jnp.sum(jnp.where(m1, lut_c, jnp.float32(0.0)), axis=-1)
            a2 = jnp.sum(jnp.where(m2, lut_c, jnp.float32(0.0)), axis=-1)
            outs.append(a1 * fr + a2 * (1.0 - fr) * scale)
        return outs

    n, w = values.shape
    rows = max(1, min(n, (1 << 21) // w))
    if n <= rows:
        return classify_rows((i1, i2, frac))
    pad = (-n) % rows
    if pad:
        i1 = jnp.concatenate([i1, jnp.zeros((pad, w), i1.dtype)])
        i2 = jnp.concatenate([i2, jnp.zeros((pad, w), i2.dtype)])
        frac = jnp.concatenate([frac, jnp.zeros((pad, w), frac.dtype)])
    k = (n + pad) // rows
    out = jax.lax.map(classify_rows, (i1.reshape(k, rows, w),
                                      i2.reshape(k, rows, w),
                                      frac.reshape(k, rows, w)))
    return [o.reshape(-1, w)[:n] for o in out]


@jax.jit
def pack_alpha_scale_parts(cells: Cells, tf: Transfunc
                           ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(A, B) with the baked per-layer alpha == A + B * opacity_scale —
    EXACTLY the postClassify expression (ref: deviceCode.cu:134): the
    reference's asymmetric lerp `a1*frac + a2*(1-frac)*scale` is affine
    in the scale, so the two components can be baked once and any pure
    opacity-scale edit becomes one fused FMA over (N, 32) instead of a
    full 300-level classify re-bake (apply_opacity_scale).  The reference
    analog is exact: its scale lives OUTSIDE the LUT (a postClassify
    uniform), so its scale edits cost only computeMaxOpacities
    (ref: hostCode.cu:878-909); this restores that cost profile for the
    baked-profile design."""
    size = tf.size
    values = cells.value
    vn = (values - tf.value_range[0]) \
        / (tf.value_range[1] - tf.value_range[0])
    vs = vn * jnp.float32(size)
    idx = vs.astype(jnp.int32)
    frac = vs - idx.astype(jnp.float32)
    i1 = jnp.clip(idx, 0, size - 1)
    i2 = jnp.clip(idx + 1, 0, size - 1)
    lev = jnp.arange(size, dtype=jnp.int32)
    lut_a = tf.values[:, 3]

    def parts_rows(args):
        i1c, i2c, fr = args
        a1 = jnp.sum(jnp.where(i1c[..., None] == lev, lut_a,
                               jnp.float32(0.0)), axis=-1)
        a2 = jnp.sum(jnp.where(i2c[..., None] == lev, lut_a,
                               jnp.float32(0.0)), axis=-1)
        return a1 * fr, a2 * (1.0 - fr)

    n, w = values.shape
    rows = max(1, min(n, (1 << 21) // w))
    if n <= rows:
        return parts_rows((i1, i2, frac))
    pad = (-n) % rows
    if pad:
        i1 = jnp.concatenate([i1, jnp.zeros((pad, w), i1.dtype)])
        i2 = jnp.concatenate([i2, jnp.zeros((pad, w), i2.dtype)])
        frac = jnp.concatenate([frac, jnp.zeros((pad, w), frac.dtype)])
    k = (n + pad) // rows
    a, b = jax.lax.map(parts_rows, (i1.reshape(k, rows, w),
                                    i2.reshape(k, rows, w),
                                    frac.reshape(k, rows, w)))
    return a.reshape(-1, w)[:n], b.reshape(-1, w)[:n]


@jax.jit
def apply_opacity_scale(packed: PackedCells, parts, scale) -> PackedCells:
    """Re-derive the baked alpha half of `prof` for a new opacity scale
    from pack_alpha_scale_parts: one fused multiply-add over (N, 32).
    RGB and heights are scale-independent (postClassify scales only the
    alpha channel) and are left untouched."""
    a, b = parts
    alpha = a + b * jnp.float32(scale)
    prof = jax.lax.dynamic_update_slice(
        packed.prof, alpha, (0, MAX_LAYERS))
    return packed._replace(prof=prof)


def pack_cells_wedge(cells: Cells, tf: Transfunc) -> PackedCells:
    """Packed tables for the FAST WEDGE sampler (the reference's mode 2 /
    cuBQL path made gather-free).

    Key facts that make this cacheable (ref: hostCode.cu:556-600):
      * the '#if 1' branch assigns the BOTTOM scalar bv to all six wedge
        vertices — the sampled value is CONSTANT per wedge, so per-layer
        classified alpha/RGB can be pre-baked exactly like the locator
        tier, just from bv (models/wedges.bv_all) instead of value;
      * wedge faces are FLAT triangles whose supporting planes share one
        normal per column (all corners sit on the same three radial
        lines), and with n' = cross(u2-u1, u3-u1) / det(u1,u2,u3) the
        face at height h is exactly {x : dot(x, n') = h} — so layer
        lookup is the SAME compare-against-heights machinery with the
        flat coordinate s = dot(P, n') substituted for the radius.

    test: (N, 32) — pack_test_rows layout in 0..14, n' in 16..18 (15 and
    19..31 pad).  prof: (N, 64) h|A_bv.  rgb: (N, 96) bv RGB.
    """
    from ..models.wedges import bv_all

    n = cells.num_cells
    rows = jnp.zeros((n, 32), F32)
    rows = rows.at[:, :16].set(pack_test_rows(cells))

    lat = np.asarray(cells.lat)
    lon = np.asarray(cells.lon)
    cl = np.cos(lat)
    u = np.stack([cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)],
                 axis=-1)                                  # (N, 3, 3)
    nrm = np.cross(u[:, 1] - u[:, 0], u[:, 2] - u[:, 0])
    det = np.einsum("ij,ij->i", u[:, 0], nrm)
    nprime = (nrm / np.where(np.abs(det) < 1e-30, 1e-30, det)[:, None]
              ).astype(np.float32)
    rows = rows.at[:, 16:19].set(jnp.asarray(nprime))

    bv = jnp.asarray(bv_all(np.asarray(cells.value),
                            np.asarray(cells.num_layers)))
    heights_hi = jnp.concatenate(
        [cells.height[:, 1:], cells.height[:, -1:]], axis=1)
    k = jnp.arange(1, MAX_LAYERS + 1)
    valid = k[None, :] <= cells.num_layers[:, None]
    heights_hi = jnp.where(valid, heights_hi, jnp.float32(np.inf))
    rr, gg, bb, aa = _classify_channels(bv, cells.num_layers, tf)
    prof = jnp.concatenate([heights_hi, aa], axis=1)
    rgb = jnp.concatenate([rr, gg, bb], axis=1)
    return PackedCells(test=rows, prof=prof, rgb=rgb)


# ===========================================================================
# Shape-agnostic step math.  All per-lane arrays are (L,) / (L, W);
# boolean lane masks are int32 0/1.
# ===========================================================================

class _State(NamedTuple):
    """Per-lane tracking state.

    The column cache is TWO-WAY (slots 0/1) with an MRU selector: a
    Woodcock sample tests both cached columns with pure arithmetic before
    parking as `pending`, and the refresh fills the LRU slot.  Why two
    slots: consecutive in-lane-batched samples traverse the SAME 1-2
    columns (about 1.1 column changes per ray at R2B9), so with caches
    preserved across sample restarts (batch_loop.retire) nearly every
    per-sample locator refresh — giant-table gathers, the dominant frame
    cost — becomes a cache hit."""
    t: jnp.ndarray          # f32 current parameter
    seg_end: jnp.ndarray    # f32 current band segment exit
    seg_hi: jnp.ndarray     # f32 current shell segment end
    band: jnp.ndarray       # i32 current band
    was_in: jnp.ndarray     # i32 seg_end crosses the INNER band edge
    m: jnp.ndarray          # f32 current majorant
    si: jnp.ndarray         # i32 shell segment index (0 or 1)
    pending: jnp.ndarray    # i32 sample at t awaits the outer refresh
    c_test: jnp.ndarray     # (L, 16) packed test row, slot 0
    c_prof: jnp.ndarray     # (L, 64) packed profile row (h | alpha), slot 0
    c_cid: jnp.ndarray      # i32 slot 0 column's cell id (shade-time RGB)
    c_valid: jnp.ndarray    # i32 slot 0 holds a real column
    c_test2: jnp.ndarray    # (L, 16) slot 1 test row
    c_prof2: jnp.ndarray    # (L, 64) slot 1 profile row
    c_cid2: jnp.ndarray     # i32 slot 1 cell id
    c_valid2: jnp.ndarray   # i32 slot 1 holds a real column
    c_mru: jnp.ndarray      # i32 most-recently-containing slot (0/1)
    c_hit: jnp.ndarray      # i32 refresh found the point's column
    in_eval: jnp.ndarray    # i32 lane is in EVAL phase
    rng: jnp.ndarray        # u32
    alpha: jnp.ndarray      # f32 accepted sample's classified alpha (0 = none)
    done: jnp.ndarray       # i32


class _Consts(NamedTuple):
    dx: jnp.ndarray         # (L,) ray directions
    dy: jnp.ndarray
    dz: jnp.ndarray
    od: jnp.ndarray         # (L,) dot(org, dir)
    s1_lo: jnp.ndarray      # (L,) second shell segment
    s1_hi: jnp.ndarray


def _point_in_test_row(row, px, py, pz, r):
    """Radial + 3 side-plane containment from packed test rows (L, 16)."""
    ev1 = row[:, 0] * px + row[:, 1] * py + row[:, 2] * pz - row[:, 3]
    ev2 = row[:, 4] * px + row[:, 5] * py + row[:, 6] * pz - row[:, 7]
    ev3 = row[:, 8] * px + row[:, 9] * py + row[:, 10] * pz - row[:, 11]
    return ((r >= row[:, 12]) & (r <= row[:, 13])
            & (ev1 <= 0.0) & (ev2 <= 0.0) & (ev3 <= 0.0))


def _rgb_at(rgb_rows, prof, r):
    """Layer lookup from the cached heights + RGB select from the
    shade-time gathered rows (L, 96).  Heights are ascending and
    inf-padded, so the containing layer is the unique k with
    h[k-1] < r <= h[k] — two compares, no cumsum."""
    ml = MAX_LAYERS
    hh = prof[:, :ml]
    # heights ascend, so the containing layer index is #(h < r); one-hot it
    # via an integer iota (no concats/shifts)
    layer = jnp.sum((r[:, None] > hh).astype(jnp.int32), axis=1)
    ids = jax.lax.broadcasted_iota(jnp.int32, (hh.shape[0], ml), 1)
    oh = (ids == layer[:, None]).astype(F32)
    rr = jnp.sum(oh * rgb_rows[:, :ml], axis=1)
    gg = jnp.sum(oh * rgb_rows[:, ml:2 * ml], axis=1)
    bb = jnp.sum(oh * rgb_rows[:, 2 * ml:3 * ml], axis=1)
    return rr, gg, bb


def _alpha_at(prof, r, ml: int = MAX_LAYERS, a_off: int = MAX_LAYERS):
    """Classified ALPHA only (the per-step need); RGB of an accepted sample
    is recovered once after the loop from the frozen (c_prof, t) state.
    ml/a_off parameterize the profile-cache layout (the f32 path caches
    h|R|G|B|A at MAX_LAYERS width; the quantized tier caches h|A|V at the
    trimmed layer width)."""
    hh = prof[:, :ml]
    layer = jnp.sum((r[:, None] > hh).astype(jnp.int32), axis=1)
    ids = jax.lax.broadcasted_iota(jnp.int32, (hh.shape[0], ml), 1)
    oh = (ids == layer[:, None]).astype(F32)
    return jnp.sum(oh * prof[:, a_off:a_off + ml], axis=1)


def _select_band(arr, b):
    """One-hot select arr[b] without a gather; arr (B,), b (L,) i32."""
    ids = jax.lax.broadcasted_iota(jnp.int32, (b.shape[0], arr.shape[0]), 1)
    oh = (ids == b[:, None]).astype(F32)
    return jnp.sum(oh * arr[None, :], axis=1)


def _band_data(b, edges, majors):
    """(inner radius, outer radius, majorant) of band b via ONE shared
    one-hot (three separate selects would triple the per-step fma count).
    lax.slice, not edges[:nb]: the jnp slice path emits gather ops."""
    nb = majors.shape[0]
    ids = jax.lax.broadcasted_iota(jnp.int32, (b.shape[0], nb), 1)
    oh = (ids == b[:, None]).astype(F32)
    e_lo = jax.lax.slice(edges, (0,), (nb,))
    e_hi = jax.lax.slice(edges, (1,), (nb + 1,))
    r_lo = jnp.sum(oh * e_lo[None, :], axis=1)
    r_hi = jnp.sum(oh * e_hi[None, :], axis=1)
    m = jnp.sum(oh * majors[None, :], axis=1)
    return r_lo, r_hi, m


def _band_exit_from(t, r_lo_b, r_hi_b, shi, od, oo):
    """Closed-form t where the ray leaves the band with the given edge
    radii, capped at shi.  Returns (t_exit, crossed_inner_edge)."""
    t_star = -od
    disc_in = od * od - oo + r_lo_b * r_lo_b
    t_in = -od - jnp.sqrt(jnp.maximum(disc_in, 0.0))
    disc_out = od * od - oo + r_hi_b * r_hi_b
    t_out = -od + jnp.sqrt(jnp.maximum(disc_out, 0.0))
    inward = t < t_star
    use_in = inward & (disc_in > 0.0) & (t_in > t)
    return jnp.minimum(jnp.where(use_in, t_in, t_out), shi), use_in


def _band_exit(t, b, shi, od, oo, edges):
    """Band exit looked up by band index (init-time convenience)."""
    nb = edges.shape[0] - 1
    r_lo_b = _select_band(edges[:nb], b)
    r_hi_b = _select_band(edges[1:], b)
    return _band_exit_from(t, r_lo_b, r_hi_b, shi, od, oo)


def _r_of(t, od, oo):
    return jnp.sqrt(jnp.maximum(oo + 2.0 * t * od + t * t, 1e-30))


def _band_of(r, edges, nb):
    return jnp.clip(
        jnp.sum((edges[None, :] < r[:, None]).astype(jnp.int32), axis=1) - 1,
        0, nb - 1)


def step_core(s: _State, c: _Consts, edges, majors, org, oo, ud,
              nb: int, ml: int = MAX_LAYERS,
              a_off: int = MAX_LAYERS, flat_vert: bool = False) -> _State:
    """One gather-free iteration of the tracking machine.

    flat_vert (the fast WEDGE sampler): containment + layer lookup use the
    flat-face coordinate s = dot(P, n') (n' cached in c_test[:, 16:19])
    instead of the radius — wedge faces are planes, not spheres (see
    pack_cells_wedge).  Band/segment traversal stays radial either way
    (the majorant field is radial bands in both tiers).

    Lane lifecycle per Woodcock sample:
      STEP  — draw the flight distance; overshoot -> band/segment advance;
              otherwise the sample point needs (hit, rgba): in cached
              column -> evaluate now; else park as `pending` (the outer
              refresh resolves it) and resume in EVAL.
      EVAL  — the refresh placed the point's column (or a miss flag,
              c_hit == 0) in the cache; evaluate, then back to STEP.
    Evaluation draws the acceptance uniform only when the point is inside
    the volume — the same draw discipline as the reference
    (ref: deviceCode.cu:160-183).
    """
    ox, oy, oz = org
    active = (s.done == 0) & (s.pending == 0)
    in_eval = active & (s.in_eval != 0)
    in_step = active & (s.in_eval == 0)

    # -- STEP: one tentative collision -------------------------------------
    has_m = s.m > 0.0
    rng1, xi = lcg_next(s.rng)
    stepped = in_step & has_m
    t_new = jnp.where(stepped, s.t - jnp.log(1.0 - xi) / (s.m / ud), s.t)
    rng_a = jnp.where(stepped, rng1, s.rng)
    overshoot = stepped & (t_new > s.seg_end)

    # -- band / segment advance ---------------------------------------------
    adv = in_step & (overshoot | ~has_m)
    t_adv = s.seg_end
    at_seg_end = t_adv >= s.seg_hi
    band_n = s.band + jnp.where(s.was_in != 0, -1, 1)
    to_seg1 = adv & at_seg_end & (s.si == 0) & (c.s1_hi > c.s1_lo)
    t_adv = jnp.where(to_seg1, c.s1_lo, t_adv)
    band_n = jnp.where(to_seg1, _band_of(_r_of(t_adv, c.od, oo), edges, nb),
                       band_n)
    shi_n = jnp.where(to_seg1, c.s1_hi, s.seg_hi)
    exhausted = at_seg_end & ~to_seg1
    band_n = jnp.clip(band_n, 0, nb - 1)
    r_lo_n, r_hi_n, m_n = _band_data(band_n, edges, majors)
    seg_end_n, was_in_n = _band_exit_from(t_adv, r_lo_n, r_hi_n, shi_n,
                                          c.od, oo)

    # -- sample classification: test BOTH cache slots (arithmetic only) -----
    samp_new = stepped & ~overshoot
    px = ox + c.dx * t_new
    py = oy + c.dy * t_new
    pz = oz + c.dz * t_new
    if flat_vert:
        coord0 = (px * s.c_test[:, 16] + py * s.c_test[:, 17]
                  + pz * s.c_test[:, 18])
        coord1 = (px * s.c_test2[:, 16] + py * s.c_test2[:, 17]
                  + pz * s.c_test2[:, 18])
    else:
        coord0 = _r_of(t_new, c.od, oo)
        coord1 = coord0
    in0 = samp_new & (s.c_valid != 0) \
        & _point_in_test_row(s.c_test, px, py, pz, coord0)
    in1 = samp_new & (s.c_valid2 != 0) \
        & _point_in_test_row(s.c_test2, px, py, pz, coord1)
    in_cache = in0 | in1
    mru1 = s.c_mru != 0
    # prefer the MRU slot when both claim the point (f32 boundary ties)
    use1 = jnp.where(mru1, in1, in1 & ~in0)
    to_pending = samp_new & ~in_cache
    # EVAL lanes read the slot the refresh just filled (it set c_mru)
    sel1 = jnp.where(in_eval, mru1, use1)
    hit_vol = in_cache | (in_eval & (s.c_hit != 0))
    aa0 = _alpha_at(s.c_prof, coord0, ml, a_off)
    aa1 = _alpha_at(s.c_prof2, coord1, ml, a_off)
    aa = jnp.where(sel1, aa1, aa0)
    rng2, uu = lcg_next(rng_a)
    rng_b = jnp.where(hit_vol, rng2, rng_a)
    accept = hit_vol & (aa >= uu * s.m)

    done_n = (s.done != 0) | (adv & exhausted) | accept
    i32 = lambda b: b.astype(jnp.int32)
    return _State(
        t=jnp.where(adv, t_adv, t_new),
        seg_end=jnp.where(adv, seg_end_n, s.seg_end),
        seg_hi=jnp.where(to_seg1, shi_n, s.seg_hi),
        band=jnp.where(adv, band_n, s.band),
        was_in=jnp.where(adv, was_in_n.astype(jnp.int32), s.was_in),
        m=jnp.where(adv, m_n, s.m),
        si=jnp.where(to_seg1, 1, s.si),
        pending=i32((s.pending != 0) | to_pending),
        c_test=s.c_test, c_prof=s.c_prof, c_cid=s.c_cid,
        c_valid=s.c_valid,
        c_test2=s.c_test2, c_prof2=s.c_prof2, c_cid2=s.c_cid2,
        c_valid2=s.c_valid2,
        c_mru=jnp.where(in_cache, use1.astype(jnp.int32), s.c_mru),
        c_hit=i32((~in_eval) & (s.c_hit != 0)),
        in_eval=i32((~in_eval) & ((s.in_eval != 0) | to_pending)),
        rng=rng_b,
        alpha=jnp.where(accept, aa, s.alpha),
        done=i32(done_n),
    )


# ===========================================================================
# The render kernel
# ===========================================================================

def _raygen_soa(lp, xs, ys, width, height, accum_id=None):
    """Jittered pinhole rays as SoA scalars (ref: deviceCode.cu:36-49
    semantics).  Returns (dx, dy, dz, od, rng).  accum_id may be a scalar
    (one progressive sample) or an (L,) vector (in-lane sample batching:
    lanes sit at different sample indices)."""
    aid = lp.accum_id if accum_id is None else accum_id
    seed0 = (jnp.asarray(aid).astype(jnp.uint32)
             * jnp.uint32(width * height) + xs.astype(jnp.uint32))
    rng = lcg_init(seed0, ys.astype(jnp.uint32))
    rng, jx = lcg_next(rng)
    rng, jy = lcg_next(rng)
    u = xs.astype(F32) + 0.5 + jx
    v = ys.astype(F32) + 0.5 + jy
    dx = lp.cam_dir00[0] + u * lp.cam_du[0] + v * lp.cam_dv[0]
    dy = lp.cam_dir00[1] + u * lp.cam_du[1] + v * lp.cam_dv[1]
    dz = lp.cam_dir00[2] + u * lp.cam_du[2] + v * lp.cam_dv[2]
    inv = 1.0 / jnp.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    dx = jnp.where(jnp.abs(dx) < 1e-5, F32(1e-5), dx)
    dy = jnp.where(jnp.abs(dy) < 1e-5, F32(1e-5), dy)
    dz = jnp.where(jnp.abs(dz) < 1e-5, F32(1e-5), dz)
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    od = ox * dx + oy * dy + oz * dz
    return dx, dy, dz, od, rng


def _init_lanes(lp, xs, ys, width, height, edges, majors, oo, nb,
                prof_w: int = PROF_W, accum_id=None, test_w: int = 16,
                rng_salt: int = 0):
    """Full per-lane initialization: raygen + shell clip + first band.
    Returns (_State, _Consts, wrote) for a batch of pixels.

    rng_salt != 0 re-keys the per-lane TRACKING stream after the pixel
    jitter draws (scene-sharded rendering: every slab device must trace
    the SAME jittered ray but track its disjoint segments with an
    INDEPENDENT stream — shared streams would correlate the per-slab
    collision draws and bias the min-t composite,
    parallel/scene_shard.py)."""
    dx, dy, dz, od, rng = _raygen_soa(lp, xs, ys, width, height, accum_id)
    if not (isinstance(rng_salt, int) and rng_salt == 0):
        # accepts a traced scalar too (shard_map passes axis_index)
        mix = jnp.uint32(rng_salt) * jnp.uint32(2654435761)
        rng, _ = lcg_next(rng ^ mix)
    r_in = edges[0]
    r_out = edges[-1]

    def sphere_ts(radius):
        disc = od * od - oo + radius * radius
        hit = disc > 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        return hit, -od - sq, -od + sq

    hit_o, to0, to1 = sphere_ts(r_out)
    hit_i, ti0, ti1 = sphere_ts(r_in)

    # shell segments, clamped to t >= 0
    outer_only = hit_o & ~hit_i
    s0_lo = jnp.maximum(to0, 0.0)
    s0_hi = jnp.where(outer_only, to1, ti0)
    s1_lo = jnp.maximum(jnp.where(outer_only, F32(np.inf), ti1), 0.0)
    s1_hi = jnp.where(outer_only, -F32(np.inf), to1)
    wrote = hit_o & (to1 > 0.0)
    # degenerate first segment (camera inside inner sphere): skip to second
    s0_bad = s0_hi <= s0_lo
    seg_lo = jnp.where(s0_bad, s1_lo, s0_lo)
    seg_hi = jnp.where(s0_bad, s1_hi, s0_hi)
    si0 = jnp.where(s0_bad, 1, 0).astype(jnp.int32)

    band0 = _band_of(_r_of(seg_lo, od, oo), edges, nb)
    seg_end0, was_in0 = _band_exit(seg_lo, band0, seg_hi, od, oo, edges)
    m0 = _select_band(majors, band0)

    L = xs.shape[0]
    zero_i = jnp.zeros(L, jnp.int32)
    state = _State(
        t=seg_lo, seg_end=seg_end0, seg_hi=seg_hi, band=band0,
        was_in=was_in0.astype(jnp.int32), m=m0, si=si0,
        pending=zero_i,
        c_test=jnp.zeros((L, test_w), F32),
        c_prof=jnp.full((L, prof_w), jnp.float32(np.inf), F32),
        c_cid=zero_i, c_valid=zero_i,
        c_test2=jnp.zeros((L, test_w), F32),
        c_prof2=jnp.full((L, prof_w), jnp.float32(np.inf), F32),
        c_cid2=zero_i, c_valid2=zero_i,
        c_mru=zero_i,
        c_hit=zero_i, in_eval=zero_i,
        rng=rng,
        alpha=jnp.zeros(L, F32),
        done=(~(wrote & (seg_hi > seg_lo))).astype(jnp.int32),
    )
    consts = _Consts(dx=dx, dy=dy, dz=dz, od=od, s1_lo=s1_lo, s1_hi=s1_hi)
    return state, consts, wrote


def _locate(loc: Locator, packed: PackedCells, px, py, pz, r, pend,
            flat_vert: bool = False):
    """Locator query core on (M,) position arrays — the only gathers in
    the render loop (bins row + candidate test rows + winner profile row).
    Shared by the dense refresh (M = L) and the compacted refresh (M = P
    pending lanes); identical arithmetic either way, so the two paths
    produce bit-identical column data.  flat_vert: candidate containment
    uses the per-candidate flat-face coordinate instead of the radius
    (fast wedge tier).  Returns (new_test, prow, cid, hit)."""
    n_lat = loc.dims[0]
    n_lon = loc.dims[1]
    lat = jnp.arcsin(jnp.clip(pz / r, -1.0, 1.0))
    lon = jnp.arctan2(py, px)
    bl = jnp.clip(((lat - loc.lat_lo) / (loc.lat_hi - loc.lat_lo)
                   * n_lat.astype(F32)).astype(jnp.int32), 0, n_lat - 1)
    bo = jnp.clip(((lon - loc.lon_lo) / (loc.lon_hi - loc.lon_lo)
                   * n_lon.astype(F32)).astype(jnp.int32), 0, n_lon - 1)
    bid = jnp.where(pend, bl * n_lon + bo, 0)
    cand = loc.bins[bid]                             # (M, K) gather
    return _test_and_fill_f32(packed, cand, px, py, pz, r, pend, flat_vert)


def _locate_fine(fm, loc: Locator, k_cap: int, packed: PackedCells,
                 px, py, pz, r, pend, flat_vert: bool = False):
    """Fine-map primary locate, f32 tier (peer of ops/fastq.
    _locate_q_fine): one 4-slot map row + one coarse locator row (the
    u8 slot decode, models/finemap.slots_to_cells) + 4 test rows
    instead of bins row + k_cap.  Misses (hit False) stay pending for
    the full _locate on a compacted second stage — exactness is
    structural (the containment test below is the full one, offsets
    and all; the map only proposes candidates)."""
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
    return _test_and_fill_f32(packed, cand, px, py, pz, r, pend, flat_vert)


def _test_and_fill_f32(packed: PackedCells, cand, px, py, pz, r, pend,
                       flat_vert: bool, return_rows: bool = False):
    """Shared locate tail: containment-test (M, K) candidate ids against
    the full plane equations (offsets included), pick the winner, gather
    its profile row.  K is the locator's k_cap for the full query and 4
    for the fine-map primary — identical arithmetic, so a primary hit is
    bit-identical to the full query's fill.

    return_rows additionally returns (trows, valid) — the gathered
    candidate test rows + validity, for ops/march.py's exact gap skip."""
    valid = cand >= 0
    safe = jnp.maximum(cand, 0)
    trows = packed.test[safe]                        # (M, K, 16|32) gather
    ev1 = (trows[..., 0] * px[:, None] + trows[..., 1] * py[:, None]
           + trows[..., 2] * pz[:, None] - trows[..., 3])
    ev2 = (trows[..., 4] * px[:, None] + trows[..., 5] * py[:, None]
           + trows[..., 6] * pz[:, None] - trows[..., 7])
    ev3 = (trows[..., 8] * px[:, None] + trows[..., 9] * py[:, None]
           + trows[..., 10] * pz[:, None] - trows[..., 11])
    if flat_vert:
        coord = (trows[..., 16] * px[:, None] + trows[..., 17] * py[:, None]
                 + trows[..., 18] * pz[:, None])
    else:
        coord = r[:, None]
    inside = (valid & (coord >= trows[..., 12])
              & (coord <= trows[..., 13])
              & (ev1 <= 0.0) & (ev2 <= 0.0) & (ev3 <= 0.0))
    hit = jnp.any(inside, axis=1)
    slot = jnp.argmax(inside, axis=1)
    k_oh = (jnp.arange(cand.shape[1])[None, :] == slot[:, None])
    cid = jnp.sum(jnp.where(k_oh, safe, 0), axis=1)
    new_test = jnp.sum(jnp.where(k_oh[..., None], trows, 0.0), axis=1)
    prow = packed.prof[jnp.where(pend & hit, cid, 0)]  # (M, 64) gather
    if return_rows:
        return new_test, prow, cid, hit, trows, valid
    return new_test, prow, cid, hit


def _fill_slots(s: _State, upd_hit, new_test, prow, cid) -> _State:
    """Install located columns of upd_hit lanes: slot 0 is PINNED to the
    lane's first-ever column, later fills go to slot 1.

    Why entry-pinning beats LRU here: Woodcock tracking is monotonic in
    t, so within one sample an evicted column is never revisited — but
    across in-lane sample RESTARTS (batch_loop) the ray re-enters the
    shell at the same t0 and its first tracking point almost always lands
    back in the entry column.  Under LRU the walk evicted it, so every
    restart paid a full locator event and most refreshes fell onto the
    DENSE path at R2B9.  Pinning the entry column makes restarts a pure
    cache hit and leaves only genuine mid-walk column changes."""
    f1 = s.c_valid != 0         # slot 0 taken -> fill slot 1
    w0 = upd_hit & ~f1
    w1 = upd_hit & f1
    i32 = lambda b: b.astype(jnp.int32)
    return s._replace(
        pending=jnp.zeros_like(s.pending),
        c_test=jnp.where(w0[:, None], new_test, s.c_test),
        c_prof=jnp.where(w0[:, None], prow, s.c_prof),
        c_cid=jnp.where(w0, cid, s.c_cid),
        c_valid=i32((s.c_valid != 0) | w0),
        c_test2=jnp.where(w1[:, None], new_test, s.c_test2),
        c_prof2=jnp.where(w1[:, None], prow, s.c_prof2),
        c_cid2=jnp.where(w1, cid, s.c_cid2),
        c_valid2=i32((s.c_valid2 != 0) | w1),
        c_mru=jnp.where(upd_hit, f1.astype(jnp.int32), s.c_mru),
        c_hit=upd_hit.astype(jnp.int32),
    )


def _refresh(s: _State, c: _Consts, loc: Locator, packed: PackedCells,
             org, oo, flat_vert: bool = False) -> _State:
    """Dense batched locator refresh: every lane's gathers execute (with
    row-0 dummies for non-pending lanes, so it costs the same however few
    lanes pend); use _refresh_compact when pending lanes are sparse."""
    ox, oy, oz = org
    pend = s.pending != 0
    px = ox + c.dx * s.t
    py = oy + c.dy * s.t
    pz = oz + c.dz * s.t
    r = _r_of(s.t, c.od, oo)
    new_test, prow, cid, hit = _locate(loc, packed, px, py, pz, r, pend,
                                       flat_vert)
    return _fill_slots(s, pend & hit, new_test, prow, cid)


def _compact_service(s: _State, c: _Consts, locate_fn, org, oo, P: int
                     ) -> _State:
    """Serve up to P pending lanes with narrow (P, ·) gathers merged back
    into the cache slots: far cheaper than the dense refresh when few
    lanes are pending (the steady state once caches persist across
    samples).

    locate_fn(px, py, pz, r, ok) -> (new_test, prow, cid, hit, served)
    on (P,) arrays — a full locate (served == ok) or a two-stage
    composition (_two_stage_locate) whose tail may leave a few lanes
    unserved.  Unserved lanes KEEP their pending flag and are picked up
    at the next service point — safe for output bits, because a pending
    lane draws nothing from its per-lane RNG stream while it waits;
    service cadence only moves wall time, never the sample values."""
    L = s.t.shape[0]
    pend = s.pending != 0
    cnt = jnp.sum(pend.astype(jnp.int32))
    idx = jnp.nonzero(pend, size=P, fill_value=L - 1)[0]
    ok = jnp.arange(P) < cnt
    tt = s.t[idx]
    dx = c.dx[idx]
    dy = c.dy[idx]
    dz = c.dz[idx]
    od = c.od[idx]
    ox, oy, oz = org
    px = ox + dx * tt
    py = oy + dy * tt
    pz = oz + dz * tt
    r = jnp.sqrt(jnp.maximum(oo + 2.0 * tt * od + tt * tt, 1e-30))
    new_test, prow, cid, hit, served = locate_fn(px, py, pz, r, ok)
    # scatter-free merge (see _compact_service_packed)
    rank = jnp.cumsum(pend.astype(jnp.int32)) - 1
    in_win = pend & (rank < P)
    rank_c = jnp.clip(rank, 0, P - 1)
    srv_l = in_win & served[rank_c]
    upd_l = srv_l & hit[rank_c]
    f1_l = s.c_valid != 0       # entry-pin policy (see _fill_slots)
    w0 = upd_l & ~f1_l
    w1 = upd_l & f1_l
    test_l = new_test[rank_c]
    prow_l = prow[rank_c]
    cid_l = cid[rank_c]
    i32 = lambda b: b.astype(jnp.int32)
    return s._replace(
        pending=jnp.where(srv_l, 0, s.pending),
        c_test=jnp.where(w0[:, None], test_l, s.c_test),
        c_prof=jnp.where(w0[:, None], prow_l, s.c_prof),
        c_cid=jnp.where(w0, cid_l, s.c_cid),
        c_valid=jnp.where(w0, 1, s.c_valid),
        c_test2=jnp.where(w1[:, None], test_l, s.c_test2),
        c_prof2=jnp.where(w1[:, None], prow_l, s.c_prof2),
        c_cid2=jnp.where(w1, cid_l, s.c_cid2),
        c_valid2=jnp.where(w1, 1, s.c_valid2),
        c_mru=jnp.where(upd_l, i32(f1_l), s.c_mru),
        c_hit=jnp.where(srv_l, i32(upd_l), s.c_hit),
    )


def _two_stage_locate(primary_loc, full_loc, tail_cap: int):
    """Compose a _compact_service locate_fn: the fine-map primary locates
    every compacted lane (5 narrow gathers/lane), then its MISSES are
    sub-compacted to (tail_cap,) rows for the authoritative full locate
    (bins row + k_cap test rows).  Running the primary COMPACTED keeps
    it from paying all L lanes when only about a third pend (R2B9).

    Misses beyond tail_cap stay unserved (kept pending by
    _compact_service) — structurally rare (primary hit rate ~0.94) and
    bit-safe: a waiting lane's RNG stream is untouched.  Exactness is
    the fine map's invariant: a primary hit IS the full query's column
    (up to f32 boundary ties), and every miss that matters reaches
    full_loc."""
    def locate(px, py, pz, r, ok):
        P = px.shape[0]
        t1, p1, c1, h1 = primary_loc(px, py, pz, r, ok)
        miss = ok & ~h1
        mcnt = jnp.sum(miss.astype(jnp.int32))
        j = jnp.nonzero(miss, size=tail_cap, fill_value=P - 1)[0]
        ok2 = jnp.arange(tail_cap) < mcnt
        t2, p2, c2, h2 = full_loc(px[j], py[j], pz[j], r[j], ok2)
        # scatter-free merge (see _compact_service_packed)
        mrank = jnp.cumsum(miss.astype(jnp.int32)) - 1
        in_tail = miss & (mrank < tail_cap)
        mr = jnp.clip(mrank, 0, tail_cap - 1)
        new_test = jnp.where(in_tail[:, None], t2[mr], t1)
        prow = jnp.where(in_tail[:, None], p2[mr], p1)
        cid = jnp.where(in_tail, c2[mr], c1)
        hit = jnp.where(in_tail, h2[mr], h1)
        return new_test, prow, cid, hit, ok & (h1 | in_tail)
    return locate


def _make_refresh(dense_fn, locate_fn, org, oo, refresh_compact: int,
                  primary_locate=None):
    """Adaptive refresh dispatcher.

    Without a primary: serve the pending lanes with the SMALLEST compact
    full-locate capacity that fits them (refresh_compact, 2x, 4x, ... doubling
    until the full lane width), falling back to the dense path only when more
    than half the lanes pend.  Compact cost is linear in the capacity while the
    dense path always pays every lane.  Every tier serves ALL pending lanes
    (the guard guarantees count <= capacity), so cadence and output bits are
    identical across tiers and to the dense path. refresh_compact == 0 disables
    the compact path (always dense).

    With a primary (primary_locate, the fine-map point locate): every
    tier is a COMPACTED TWO-STAGE service (_two_stage_locate) — the
    primary runs on the compacted pending rows, its misses sub-compact
    into a small full-locate tail.  Tiers are FEW and FIXED
    (lanes/8, lanes/2, lanes): once the fine map made the gathers cheap,
    a doubling ladder's per-cond dispatch dominated the phase.  Three
    fixed tiers bound the width waste at ~4x while paying 2 conds per
    phase.  A tier's tail (capacity/8) may
    leave overflow misses pending for the next phase — rare (~6% miss
    rate) and bit-safe (see _compact_service)."""
    if refresh_compact <= 0 and primary_locate is None:
        return lambda s, c: dense_fn(s, c)

    if primary_locate is not None:
        def refresh(s, c):
            lanes_n = s.t.shape[0]
            cnt = jnp.sum((s.pending != 0).astype(jnp.int32))
            tiers = sorted({min(max(lanes_n // 8, 128), lanes_n),
                            min(max(lanes_n // 2, 128), lanes_n),
                            lanes_n})

            def service(p):
                two = _two_stage_locate(primary_locate, locate_fn,
                                        min(max(p // 8, 128), p))
                return lambda ss: _compact_service(ss, c, two, org, oo, p)

            fn = service(tiers[-1])
            for p in reversed(tiers[:-1]):
                fn = (lambda p_, nxt, srv: lambda ss: jax.lax.cond(
                    cnt <= p_, srv, nxt, ss))(p, fn, service(p))
            # callers guard on any-pending, so cnt > 0 here
            return fn(s)
        return refresh

    def refresh(s, c):
        lanes_n = s.t.shape[0]
        cnt = jnp.sum((s.pending != 0).astype(jnp.int32))
        full5 = lambda px, py, pz, r, ok: (*locate_fn(px, py, pz, r, ok),
                                           ok)
        tiers = []
        p = max(refresh_compact, 128)
        while p < lanes_n:
            tiers.append(p)
            p *= 2
        fn = lambda ss: dense_fn(ss, c)
        for p in reversed(tiers):
            fn = (lambda p_, nxt: lambda ss: jax.lax.cond(
                cnt <= p_,
                lambda s2: _compact_service(s2, c, full5, org, oo, p_),
                nxt, ss))(p, fn)
        return fn(s)
    return refresh


# ===========================================================================
# Flat-service machinery: packed state carry + cond-free loop.
#
# A profile of the r2b9q while body on the earlier accelerator put most of
# each phase NOT in the locate gathers but in the lax.cond plumbing around
# them: every cond boundary copied each of the ~37 small per-lane state
# leaves between memory spaces, and per-leaf compaction gathers added
# more.  Not yet profiled on the H100 (ROADMAP S2/S6).  The flat design
# removes both causes:
#   * the while carry is FOUR wide arrays (fmat (L,16) f32, imat (L,16)
#     i32, one merged test|prof row per cache slot) instead of ~37 (L,)
#     leaves — packing is pure layout, bit-exact;
#   * ONE unconditional retire + compact-service per outer iteration at a
#     fixed capacity (pend overflow stays pending for the next phase — the
#     tail-overflow invariant of _compact_service, bit-safe) instead of
#     the nested cond tier ladder;
#   * the service updates state via 2 row gathers + 3 row scatters on the
#     packed arrays instead of ~7 gathers + ~12 scatters on the leaves.
# ===========================================================================

#: fmat columns (f32): tracking scalars + accumulation + ray consts
_FC = dict(t=0, seg_end=1, seg_hi=2, m=3, alpha=4, ar=5, ag=6, ab=7, aa=8,
           dx=9, dy=10, dz=11, od=12, s1_lo=13, s1_hi=14)
_NF = 16   # padded to a multiple of 8 lanes
#: imat columns (i32; rng is the bitcast u32 stream)
_IC = dict(band=0, was_in=1, si=2, pending=3, c_cid=4, c_valid=5,
           c_cid2=6, c_valid2=7, c_mru=8, c_hit=9, in_eval=10, done=11,
           rng=12, wrote=13, samp=14, wany=15)
_NI = 16


def _pack_q(q) -> dict:
    """Batch-loop carry dict -> packed arrays (pure layout, bit-exact)."""
    s, c = q["s"], q["c"]
    L = s.t.shape[0]
    f_cols = [s.t, s.seg_end, s.seg_hi, s.m, s.alpha,
              q["ar"], q["ag"], q["ab"], q["aa"],
              c.dx, c.dy, c.dz, c.od, c.s1_lo, c.s1_hi]
    f_cols += [jnp.zeros(L, F32)] * (_NF - len(f_cols))
    i_cols = [s.band, s.was_in, s.si, s.pending, s.c_cid, s.c_valid,
              s.c_cid2, s.c_valid2, s.c_mru, s.c_hit, s.in_eval, s.done,
              jax.lax.bitcast_convert_type(s.rng, jnp.int32),
              q["wrote"], q["samp"], q["wany"]]
    return dict(
        fmat=jnp.stack(f_cols, axis=1),
        imat=jnp.stack(i_cols, axis=1),
        row0=jnp.concatenate([s.c_test, s.c_prof], axis=1),
        row1=jnp.concatenate([s.c_test2, s.c_prof2], axis=1),
        st_refr=q["st_refr"], st_pend=q["st_pend"],
    )


def _unpack_q(p, test_w: int) -> dict:
    """Packed arrays -> carry dict of (L,) views (slices fuse into
    consumers; no data moves until something materializes)."""
    f, i = p["fmat"], p["imat"]
    fc = lambda k: f[:, _FC[k]]
    ic = lambda k: i[:, _IC[k]]
    s = _State(
        t=fc("t"), seg_end=fc("seg_end"), seg_hi=fc("seg_hi"),
        band=ic("band"), was_in=ic("was_in"), m=fc("m"), si=ic("si"),
        pending=ic("pending"),
        c_test=p["row0"][:, :test_w], c_prof=p["row0"][:, test_w:],
        c_cid=ic("c_cid"), c_valid=ic("c_valid"),
        c_test2=p["row1"][:, :test_w], c_prof2=p["row1"][:, test_w:],
        c_cid2=ic("c_cid2"), c_valid2=ic("c_valid2"),
        c_mru=ic("c_mru"), c_hit=ic("c_hit"), in_eval=ic("in_eval"),
        rng=jax.lax.bitcast_convert_type(ic("rng"), jnp.uint32),
        alpha=fc("alpha"), done=ic("done"),
    )
    c = _Consts(dx=fc("dx"), dy=fc("dy"), dz=fc("dz"), od=fc("od"),
                s1_lo=fc("s1_lo"), s1_hi=fc("s1_hi"))
    return dict(s=s, c=c, wrote=ic("wrote"), samp=ic("samp"),
                ar=fc("ar"), ag=fc("ag"), ab=fc("ab"), aa=fc("aa"),
                wany=ic("wany"), st_refr=p["st_refr"], st_pend=p["st_pend"])


def _compact_service_packed(p, test_w: int, locate_fn, org, oo, P: int
                            ) -> dict:
    """_compact_service on the PACKED carry: serve up to P pending lanes
    with 2 state-row gathers + the locate + 3 row scatters.  Same
    arithmetic, same fill policy (slot 0 entry-pinned), same overflow
    invariant (unserved lanes keep pending; their RNG stream is untouched
    while they wait) as the per-leaf version — outputs are bit-identical.
    Runs unconditionally: with nothing pending every write is dropped
    (ok=False ⇒ served=False) and the gathers read dummy rows."""
    fmat, imat = p["fmat"], p["imat"]
    L = fmat.shape[0]
    pend = imat[:, _IC["pending"]] != 0
    cnt = jnp.sum(pend.astype(jnp.int32))
    idx = jnp.nonzero(pend, size=P, fill_value=L - 1)[0]
    ok = jnp.arange(P) < cnt
    frows = fmat[idx]                                # (P, NF) gather
    tt = frows[:, _FC["t"]]
    dx = frows[:, _FC["dx"]]
    dy = frows[:, _FC["dy"]]
    dz = frows[:, _FC["dz"]]
    od = frows[:, _FC["od"]]
    ox, oy, oz = org
    px = ox + dx * tt
    py = oy + dy * tt
    pz = oz + dz * tt
    r = jnp.sqrt(jnp.maximum(oo + 2.0 * tt * od + tt * tt, 1e-30))
    new_test, prow, cid, hit, served = locate_fn(px, py, pz, r, ok)
    new_row = jnp.concatenate([new_test, prow], axis=1)

    # SCATTER-FREE merge: row scatters serialized on the earlier
    # accelerator, so every lane computes its compaction rank
    # (prefix sum of the pending mask), gathers its own result row, and
    # a lane-wide select keeps or replaces its state.  Value-for-value
    # identical to the scatter (same rows land in the same lanes; same
    # overflow semantics: lanes ranked past P stay pending).
    rank = jnp.cumsum(pend.astype(jnp.int32)) - 1         # (L,)
    in_win = pend & (rank < P)
    rank_c = jnp.clip(rank, 0, P - 1)
    srv_l = in_win & served[rank_c]
    upd_l = srv_l & hit[rank_c]
    v0_l = imat[:, _IC["c_valid"]] != 0  # entry-pin policy (_fill_slots)
    w0_l = upd_l & ~v0_l
    w1_l = upd_l & v0_l
    new_row_l = new_row[rank_c]                            # (L, W) gather
    cid_l = cid[rank_c]
    i32 = lambda b: b.astype(jnp.int32)
    lcol = lambda k: imat[:, _IC[k]]
    upd_cols = {
        "pending": jnp.where(srv_l, 0, lcol("pending")),
        "c_cid": jnp.where(w0_l, cid_l, lcol("c_cid")),
        "c_valid": jnp.where(w0_l, 1, lcol("c_valid")),
        "c_cid2": jnp.where(w1_l, cid_l, lcol("c_cid2")),
        "c_valid2": jnp.where(w1_l, 1, lcol("c_valid2")),
        "c_mru": jnp.where(upd_l, i32(v0_l), lcol("c_mru")),
        "c_hit": jnp.where(srv_l, i32(upd_l), lcol("c_hit")),
    }
    iout = jnp.stack([upd_cols.get(k, lcol(k))
                      for k, _ in sorted(_IC.items(), key=lambda kv: kv[1])],
                     axis=1)
    return dict(
        fmat=fmat,
        imat=iout,
        row0=jnp.where(w0_l[:, None], new_row_l, p["row0"]),
        row1=jnp.where(w1_l[:, None], new_row_l, p["row1"]),
        st_refr=p["st_refr"] + (cnt > 0).astype(jnp.int32),
        st_pend=p["st_pend"] + jnp.minimum(cnt, P),
    )


def render_fast(cells: Cells, packed: PackedCells, loc: Locator,
                bands: RadialBands, lp, xs, ys, width: int, height: int,
                steps_per_refresh: int = 8, max_outer: int = 16384,
                return_cost: bool = False, sampler: str = "locator",
                outer_unroll: int = 1, refresh_compact: int = 0,
                finemap=None):
    """One progressive sample for a batch of pixels.

    lp: ops.render.LaunchParams.  xs, ys: (L,) i32 pixel coords.
    Returns (wrote (L,) bool, color_alpha (L, 4) f32); with return_cost
    also the per-lane outer-iteration count at completion (L,) i32 — the
    measured cost that drives adaptive re-ordering (ops/order.refine_order).

    sampler: 'locator' (per-layer cell values, the default tier) or
    'wedge' (the reference's mode-2 wedge estimator made gather-free;
    packed must come from pack_cells_wedge and bands from
    models/shells.build_radial_bands_wedge).

    finemap: optional models/finemap.FineMap two-stage locate primary
    (build from this tier's planes via normals_table + build_finemap).
    """
    L = xs.shape[0]
    fv = sampler == "wedge"
    nb = bands.num_bands
    edges = bands.edges                      # (B+1,)
    majors = bands.max_opacities             # (B,)

    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    oo = ox * ox + oy * oy + oz * oz         # scalar
    org = (ox, oy, oz)
    ud = lp.unit_distance
    k_cap = int(loc.bins.shape[1])           # f32 bins are unpacked (B, K)

    init, consts, wrote = _init_lanes(lp, xs, ys, width, height,
                                      edges, majors, oo, nb,
                                      test_w=packed.test.shape[1])

    refresh = _make_refresh(
        lambda s, c: _refresh(s, c, loc, packed, org, oo, flat_vert=fv),
        lambda px, py, pz, r, pend: _locate(loc, packed, px, py, pz, r,
                                            pend, flat_vert=fv),
        org, oo, refresh_compact,
        primary_locate=None if finemap is None else
        (lambda px, py, pz, r, pend: _locate_fine(finemap, loc, k_cap,
                                                  packed, px, py, pz, r,
                                                  pend, flat_vert=fv)))

    def inner_phase(s: _State) -> _State:
        # Python-unrolled on purpose: a lax.fori_loop would make every step
        # its own kernel, streaming the ~180 f32/lane live state through
        # device memory per step; unrolled, XLA fuses all steps_per_refresh
        # steps into one kernel and the state makes ONE round trip per
        # outer iteration.
        for _ in range(steps_per_refresh):
            s = step_core(s, consts, edges, majors, org, oo, ud, nb,
                          flat_vert=fv)
        return s

    def outer_cond(carry):
        s, it, fin = carry
        return jnp.any(s.done == 0) & (it < max_outer)

    def outer_body(carry):
        # outer_unroll > 1 amortizes the while_loop mechanics (cond
        # reduction + branch dispatch) over several refresh+steps
        # phases.  The per-lane refresh/step cadence is EXACTLY that of
        # the unroll=1 loop, so outputs are bit-identical; the loop may
        # only run up to outer_unroll-1 extra no-op phases at the tail.
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

    # recover the accepted sample's RGB once, from the frozen state: an
    # accepting lane sets done with t at the collision and its cache still
    # holding the collided column's heights + cell id (ONE rgb-row gather
    # per ray, not per step)
    color_alpha = jnp.stack(_shade(out, consts, packed.rgb, lp, oo,
                                   flat_vert=fv), axis=-1)
    if return_cost:
        return wrote, color_alpha, jnp.maximum(fin, 0)
    return wrote, color_alpha


def batch_loop(init, refresh, shade, inner_phase, lp, accum0, fb0,
               samples: int, max_outer: int = 16384,
               outer_unroll: int = 1, preserve_cache: bool = True,
               return_stats: bool = False, service_cap: int = 0,
               flat_locate=None):
    """Generic in-lane sample-batching wavefront loop (shared by the f32
    and quantized tiers).

    service_cap > 0 (with flat_locate, the composed compact locate fn)
    selects the FLAT loop: a packed state carry and ONE unconditional
    retire + compact service of up to service_cap pending lanes per outer
    iteration — no lax.cond anywhere in the body (see the flat-service
    block comment above).  Pending lanes beyond service_cap wait for the next
    phase (bit-safe: a waiting lane draws nothing from its RNG stream),
    so outputs remain bit-identical to the cond ladder and to `samples`
    sequential single-sample calls.

    The single-sample renderers idle ~90% of their lane-step slots: a lane
    that finishes its sample in 3 steps waits for the chunk's slowest
    lane.  Here a finished lane
    immediately RE-INITIALIZES with its pixel's next progressive sample —
    the per-sample RNG stream (seeded by accum_id + sample index,
    _raygen_soa) and the running-average arithmetic (the reference's
    accumulate(), deviceCode.cu:267-274) are exactly those of `samples`
    sequential single-sample+_finalize rounds, so the output accum/fb are
    BIT-IDENTICAL to the sequential path (asserted in tests) while fixed
    costs amortize and idle slots fill with real work.

    init(samp_vec) -> (_State, _Consts, wrote);  refresh(s, c) -> s;
    shade(s, c) -> (r, g, b, a);  inner_phase(s, c) -> s.
    accum0 (L, 4) f32 / fb0 (L,) u32: prior accumulation state of these
    lanes' pixels.  lp.accum_id: FIRST sample id of the batch.
    Returns (accum (L, 4), fb (L,)).
    """
    from ..utils import color as colorlib

    S = samples
    s0, c0, w0 = init(jnp.zeros(fb0.shape[0], jnp.int32))
    carry0 = dict(
        s=s0, c=c0, wrote=w0.astype(jnp.int32),
        samp=jnp.zeros(fb0.shape[0], jnp.int32),
        ar=accum0[:, 0], ag=accum0[:, 1], ab=accum0[:, 2], aa=accum0[:, 3],
        wany=jnp.zeros(fb0.shape[0], jnp.int32),
        # profiling counters (return_stats): refresh phases entered and
        # total pending lanes they served — the per-call locate demand
        # that sizing decisions (cache slots, primary threshold) need
        st_refr=jnp.int32(0), st_pend=jnp.int32(0),
    )

    def retire(q):
        """Accumulate finished samples (the reference's accumulate() lerp,
        bit-for-bit) and restart those lanes on their next sample."""
        s, c = q["s"], q["c"]
        comp = (s.done != 0) & (q["samp"] < S)
        rr, gg, bb, al = shade(s, c)
        id_k = (lp.accum_id + q["samp"]).astype(F32)
        sc = 1.0 / (id_k + 1.0)
        upd = comp & (q["wrote"] != 0)
        lerp = lambda new, old: jnp.where(upd, sc * new + (1.0 - sc) * old,
                                          old)
        ar, ag, ab = lerp(rr, q["ar"]), lerp(gg, q["ag"]), lerp(bb, q["ab"])
        aa = lerp(al, q["aa"])
        wany = (q["wany"] != 0) | upd
        samp2 = jnp.where(comp, q["samp"] + 1, q["samp"])
        more = comp & (samp2 < S)
        ns, nc, nw = init(samp2)
        # restarted lanes KEEP their column caches (preserve_cache):
        # consecutive samples traverse the same 1-2 columns, so the
        # preserved slots turn the per-sample locator refresh (the
        # dominant gather cost at scale) into an arithmetic cache hit.
        # The cached rows are exactly what a refresh at the same point
        # would fetch, so the estimator is unchanged; outputs can differ
        # from the sequential single-sample path only on f32 boundary
        # ties between adjacent columns (a point exactly on a shared
        # plane "belongs" to both).  preserve_cache=False restores the
        # strict bit-exact-vs-sequential contract for tests.
        if preserve_cache:
            ns = ns._replace(
                c_test=s.c_test, c_prof=s.c_prof, c_cid=s.c_cid,
                c_valid=s.c_valid,
                c_test2=s.c_test2, c_prof2=s.c_prof2, c_cid2=s.c_cid2,
                c_valid2=s.c_valid2, c_mru=s.c_mru)
        pick = lambda n, o: jnp.where(
            more[(...,) + (None,) * (n.ndim - 1)] if n.ndim > 1 else more,
            n, o)
        return dict(
            s=_State(*(pick(a, b) for a, b in zip(ns, s))),
            c=_Consts(*(pick(a, b) for a, b in zip(nc, c))),
            wrote=jnp.where(more, nw.astype(jnp.int32), q["wrote"]),
            samp=samp2, ar=ar, ag=ag, ab=ab, aa=aa,
            wany=wany.astype(jnp.int32),
            st_refr=q["st_refr"], st_pend=q["st_pend"],
        )

    if service_cap > 0 and flat_locate is not None:
        # FLAT loop: cond-free body — one unconditional retire + compact
        # service + steps per outer iteration.
        L = fb0.shape[0]
        test_w = s0.c_test.shape[1]
        P = min(max(service_cap, 128), L)
        # org/oo recovered from lp exactly as the tier drivers compute it
        ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
        org = (ox, oy, oz)
        oo = ox * ox + oy * oy + oz * oz

        # In-step retire (finished lanes restarting mid-phase) and an
        # unpacked flat carry were both slower than this design on the
        # earlier accelerator; neither is measured on the H100.
        def outer_cond_f(carry):
            p, it = carry
            return (jnp.any(p["imat"][:, _IC["samp"]] < S)
                    & (it < max_outer))

        def outer_body_f(carry):
            p, it = carry
            for _ in range(outer_unroll):
                p = _pack_q(retire(_unpack_q(p, test_w)))
                p = _compact_service_packed(p, test_w, flat_locate,
                                            org, oo, P)
                q = _unpack_q(p, test_w)
                p = _pack_q(dict(q, s=inner_phase(q["s"], q["c"])))
            return (p, it + outer_unroll)

        p, n_it = jax.lax.while_loop(outer_cond_f, outer_body_f,
                                     (_pack_q(carry0), jnp.int32(0)))
        q = retire(_unpack_q(p, test_w))
    else:
        def outer_cond(carry):
            q, it = carry
            return jnp.any(q["samp"] < S) & (it < max_outer)

        def outer_body(carry):
            # unrolled like render_fast's outer_body (same bit-exactness
            # argument; amortizes while_loop mechanics over several phases)
            q, it = carry
            for _ in range(outer_unroll):
                need_service = jnp.any(
                    (q["s"].pending != 0)
                    | ((q["s"].done != 0) & (q["samp"] < S)))
                q = jax.lax.cond(need_service, service, lambda x: x, q)
                q = dict(q, s=inner_phase(q["s"], q["c"]))
            return (q, it + outer_unroll)

        def service(q):
            q = jax.lax.cond(
                jnp.any((q["s"].done != 0) & (q["samp"] < S)),
                retire, lambda x: x, q)
            pend_n = jnp.sum((q["s"].pending != 0).astype(jnp.int32))
            s = jax.lax.cond(pend_n > 0,
                             lambda s: refresh(s, q["c"]),
                             lambda s: s, q["s"])
            return dict(
                q, s=s,
                st_refr=q["st_refr"] + (pend_n > 0).astype(jnp.int32),
                st_pend=q["st_pend"] + pend_n)

        q, n_it = jax.lax.while_loop(outer_cond, outer_body,
                                     (carry0, jnp.int32(0)))
        q = retire(q)   # the loop exits with final samples un-retired

    wany = q["wany"] != 0
    srgb = colorlib.linear_to_srgb(jnp.stack([q["ar"], q["ag"], q["ab"]],
                                             axis=-1))
    px = colorlib.make_rgba(jnp.concatenate([srgb, q["aa"][:, None]],
                                            axis=-1))
    accum = jnp.stack([q["ar"], q["ag"], q["ab"], q["aa"]], axis=-1)
    fb = jnp.where(wany, px, fb0)
    if return_stats:
        return accum, fb, (n_it, q["st_refr"], q["st_pend"])
    return accum, fb


def render_fast_batch(cells: Cells, packed: PackedCells, loc: Locator,
                      bands: RadialBands, lp, xs, ys, width: int, height: int,
                      accum0, fb0, samples: int,
                      steps_per_refresh: int = 8, max_outer: int = 16384,
                      sampler: str = "locator", outer_unroll: int = 1,
                      refresh_compact: int = 0, preserve_cache: bool = True,
                      finemap=None, service_cap: int = -1):
    """`samples` progressive samples per lane in ONE wavefront loop — the
    f32-tier instantiation of batch_loop (see its docstring).

    service_cap: flat-service capacity (-1 auto = flat at half the lane
    width for giant tables, legacy cond-ladder otherwise — see
    _resolve_service_cap; 0 = legacy; >0 = flat at that capacity)."""
    fv = sampler == "wedge"
    nb = bands.num_bands
    edges = bands.edges
    majors = bands.max_opacities
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    oo = ox * ox + oy * oy + oz * oz
    org = (ox, oy, oz)
    ud = lp.unit_distance
    k_cap = int(loc.bins.shape[1])           # f32 bins are unpacked (B, K)

    def init(samp):
        return _init_lanes(lp, xs, ys, width, height, edges, majors, oo, nb,
                           accum_id=lp.accum_id + samp,
                           test_w=packed.test.shape[1])

    refresh = _make_refresh(
        lambda s, c: _refresh(s, c, loc, packed, org, oo, flat_vert=fv),
        lambda px, py, pz, r, pend: _locate(loc, packed, px, py, pz, r,
                                            pend, flat_vert=fv),
        org, oo, refresh_compact,
        primary_locate=None if finemap is None else
        (lambda px, py, pz, r, pend: _locate_fine(finemap, loc, k_cap,
                                                  packed, px, py, pz, r,
                                                  pend, flat_vert=fv)))

    def shade(s, c):
        return _shade(s, c, packed.rgb, lp, oo, flat_vert=fv)

    def inner_phase(s, c):
        for _ in range(steps_per_refresh):   # unrolled; see render_fast
            s = step_core(s, c, edges, majors, org, oo, ud, nb,
                          flat_vert=fv)
        return s

    service_cap = _resolve_service_cap(service_cap, cells.num_cells,
                                       xs.shape[0])
    full5 = lambda px, py, pz, r, ok: (
        *_locate(loc, packed, px, py, pz, r, ok, flat_vert=fv), ok)
    if service_cap <= 0:
        flat_locate = None
    elif finemap is not None:
        flat_locate = _two_stage_locate(
            lambda px, py, pz, r, ok: _locate_fine(finemap, loc, k_cap,
                                                   packed, px, py, pz, r,
                                                   ok, flat_vert=fv),
            lambda px, py, pz, r, ok: _locate(loc, packed, px, py, pz, r,
                                              ok, flat_vert=fv),
            min(max(service_cap // 8, 128), service_cap))
    else:
        flat_locate = full5

    return batch_loop(init, refresh, shade, inner_phase, lp, accum0, fb0,
                      samples, max_outer, outer_unroll, preserve_cache,
                      service_cap=service_cap, flat_locate=flat_locate)


def _shade(s: _State, c: _Consts, rgb_table, lp, oo, flat_vert: bool = False):
    """Composite color of a finished lane (ref: deviceCode.cu:333-340):
    classified RGB of the accepted sample x ambient, binary alpha.  An
    accepting lane's c_mru points at the slot that held the collided
    column (step_core marks the containing slot MRU before freezing)."""
    got = s.alpha > 0.0
    mru1 = s.c_mru != 0
    cid = jnp.where(mru1, s.c_cid2, s.c_cid)
    prof = jnp.where(mru1[:, None], s.c_prof2, s.c_prof)
    rgb_rows = rgb_table[jnp.where(got, cid, 0)]       # (L, 96) gather
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    if flat_vert:
        test = jnp.where(mru1[:, None], s.c_test2, s.c_test)
        coord = ((ox + c.dx * s.t) * test[:, 16]
                 + (oy + c.dy * s.t) * test[:, 17]
                 + (oz + c.dz * s.t) * test[:, 18])
    else:
        coord = _r_of(s.t, c.od, oo)
    rr, gg, bb = _rgb_at(rgb_rows, prof, coord)
    amb_r = lp.ambient_color[0] * lp.ambient_radiance
    amb_g = lp.ambient_color[1] * lp.ambient_radiance
    amb_b = lp.ambient_color[2] * lp.ambient_radiance
    zero = jnp.zeros_like(s.t)
    return (jnp.where(got, rr * amb_r, zero),
            jnp.where(got, gg * amb_g, zero),
            jnp.where(got, bb * amb_b, zero),
            jnp.where(got, 1.0, 0.0))


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "steps_per_refresh",
                                    "chunk", "n_active", "return_cost",
                                    "samples", "sampler", "outer_unroll",
                                    "refresh_compact", "preserve_cache",
                                    "service_cap"),
                   donate_argnames=("accum", "fb"))
def render_frame_fast(cells: Cells, packed: PackedCells, loc: Locator,
                      bands: RadialBands, lp, accum, fb, *,
                      width: int, height: int, steps_per_refresh: int = 8,
                      chunk: int = CHUNK, pixel_perm=None,
                      n_active: int | None = None,
                      return_cost: bool = False,
                      samples: int = 1,
                      sampler: str = "locator",
                      outer_unroll: int = 1,
                      refresh_compact: int = 0,
                      preserve_cache: bool = True,
                      finemap=None, service_cap: int = -1):
    """Full-frame progressive step on the fast path (drop-in peer of
    render_frame_ae / render_frame_accel).

    pixel_perm: optional (H*W,) i32 permutation (ops/order.pixel_order);
    when given, lane i renders pixel pixel_perm[i] and accum/fb are in
    PERMUTED order — unpermute with perm at present time.  Sorting by ray
    cost raises wavefront lane utilization several-fold.

    n_active: optional count of covered positions (ops/order.pixel_order's
    second return; requires pixel_perm).  Only the covered prefix is
    traced — the tail's rays can never write (the reference returns
    without writing on a bounds miss, deviceCode.cu:294), so skipping the
    all-background chunks is exact.  Each distinct rounded value compiles
    once; bucket it (order.bucket_active) for moving cameras.

    return_cost: also return the measured per-PIXEL outer-iteration count
    in NATURAL pixel order (total,) i32 — feed to ops/order.refine_order
    to re-sort the next sample's lanes by actual cost.

    samples: progressive samples traced per call.  samples > 1 uses the
    in-lane batching loop (render_fast_batch): lp.accum_id is the FIRST
    sample id and the result equals `samples` sequential samples=1 calls
    bit-for-bit, several-fold faster (finished lanes restart on their
    next sample instead of idling; fixed costs amortize).  Incompatible
    with return_cost.
    """
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
        accum_head, fb_head = _run_batched_generic(
            lambda xs, ys, a0, f0: render_fast_batch(
                cells, packed, loc, bands, lp, xs, ys, width, height,
                a0, f0, samples, steps_per_refresh, sampler=sampler,
                outer_unroll=outer_unroll, refresh_compact=refresh_compact,
                preserve_cache=preserve_cache, finemap=finemap,
                service_cap=service_cap),
            xs_all, ys_all, accum[:n_proc], fb[:n_proc], chunk, n_proc)
        if n_proc == total:
            return accum_head, fb_head
        return (jnp.concatenate([accum_head, accum[n_proc:]]),
                jnp.concatenate([fb_head, fb[n_proc:]]))

    def run(xs, ys):
        return render_fast(cells, packed, loc, bands, lp, xs, ys,
                           width, height, steps_per_refresh,
                           return_cost=return_cost, sampler=sampler,
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
            lambda c: run(c[0], c[1]),
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
    # scatter lane costs to natural pixel order; untraced pixels stay 0
    cost_nat = jnp.zeros(total, jnp.int32).at[pix].set(cost)
    return accum_out, fb_out, cost_nat


def _run_batched_generic(batch_fn, xs_all, ys_all, accum_head, fb_head,
                         chunk, n_proc):
    """Chunked driver for the sample-batching loops (accum/fb updated
    in-loop).  batch_fn(xs, ys, accum0, fb0) -> (accum, fb)."""
    if n_proc <= chunk:
        return batch_fn(xs_all, ys_all, accum_head, fb_head)
    n = -(-n_proc // chunk)
    pad = n * chunk - n_proc
    if pad:
        xs_all = jnp.concatenate([xs_all, jnp.zeros(pad, jnp.int32)])
        ys_all = jnp.concatenate([ys_all, jnp.zeros(pad, jnp.int32)])
        accum_head = jnp.concatenate(
            [accum_head, jnp.zeros((pad, 4), F32)])
        fb_head = jnp.concatenate(
            [fb_head, jnp.zeros(pad, fb_head.dtype)])
    a, f = jax.lax.map(
        lambda c: batch_fn(c[0], c[1], c[2], c[3]),
        (xs_all.reshape(n, chunk), ys_all.reshape(n, chunk),
         accum_head.reshape(n, chunk, 4), fb_head.reshape(n, chunk)))
    return a.reshape(-1, 4)[:n_proc], f.reshape(-1)[:n_proc]
