"""Deterministic transmittance march — the zero-variance fast-tier
integrator.

The classified field is piecewise-constant per (cell, layer): within a
column, alpha(r) and value(r) are step functions of the radius whose
breakpoints are the cached layer ceilings.  Along a ray the per-segment
optical depth is therefore CLOSED-FORM, and one front-to-back march over the
ray's column crossings computes exactly the expectation that the Woodcock
estimator (ops/fast.py / ops/fastq.py — the lane-parallel redesign of the
reference's per-sample tracking loop, ref: icon_rt/deviceCode.cu:149-186) only
converges to over many progressive samples:

    E[rgb]   = ambient * INT sigma(t) e^{-tau(t)} c(t) dt,
               sigma = classified_alpha / unit_distance
    E[alpha] = 1 - e^{-tau(inf)}

One march pass replaces N progressive samples; the remaining per-sample
variation is only the pixel jitter, so a handful of passes give an
antialiased converged frame.  Standard DVR early-ray termination
(transmittance < ET_EPS -> stop) applies — something Woodcock cannot do.

This is our own estimator tier (README: the fast path is licensed to be
statistically equivalent to the reference, not bit-equal): a
zero-variance estimator of the same integral.  The parity raygens
(ops/traverse.py) are untouched.

Mechanics per outer iteration (dense over the lane batch, no RNG after
the pixel-jitter draws):
  * shell-segment advance (the two-segment clip of ops/fast._init_lanes);
  * zero-majorant radial bands are skipped closed-form (band exit);
  * otherwise the lane locates the column at t+eps (same locator tables
    and candidate-test arithmetic as the Woodcock tiers), integrates the
    crossing [t, t_exit] analytically (see _integrate_column), and jumps
    to t_exit;
  * a locate MISS (point in a data gap, e.g. above a terrain column's
    top) advances to the EXACT next event: the minimum over (a) the next
    entry of any of the bin's candidate columns (closed-form ray/column
    interval arithmetic on the already-gathered candidate rows), (b) the
    locator-bin boundary crossing (two latitude cones + two longitude
    planes), and (c) the radial band exit — never past a column it
    should have integrated.

Documented deviations (bounded, see tests/test_march.py):
  * early termination drops <= ET_EPS of the remaining radiance/alpha;
  * locate points are offset +eps along the ray for f32 boundary
    robustness; a tie that re-locates the previous column advances the
    lane by eps with a zero-length integration — bias per such (rare)
    event <= alpha * eps / unit_distance.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.locator import Locator
from ..models.qcells import QuantizedCells
from ..models.shells import RadialBands
from ..models.transfunc import Transfunc, post_classify
from .fast import (CHUNK, F32, _band_exit, _band_of, _init_lanes, _r_of,
                   _select_band)

__all__ = ["march_rays", "march_rays_q", "render_frame_march",
           "render_frame_march_q"]

#: early-ray-termination transmittance floor: the tail below this is
#: dropped (standard DVR; bounded bias, reported in docs)
ET_EPS = 1e-3


# ===========================================================================
# Closed-form column-crossing integral
# ===========================================================================

def _integrate_column(prof, lm: int, h_bot, nl, t0, t1, od, oo, ud,
                      colors):
    """Emission-absorption integral of one column crossing [t0, t1].

    prof: (L, 3*lm) cached h|A|V rows (ops/fastq layout) — per-layer
    ceiling heights ascending (inf past num_layers) and baked classified
    alpha.  h_bot/nl from the test row.  The ray is inside the column
    throughout [t0, t1] (t1 is the first boundary exit), so only the
    RADIAL layer structure matters here.

    r(t) = sqrt(oo + 2 t od + t^2) descends to its apex at t* = -od then
    ascends; each monotonic piece visits layers in radial order, so the
    crossing splits into a descending piece [t0, tm] (front-to-back =
    layer k DESCENDING) and an ascending piece [tm, t1] (k ascending),
    tm = clip(t*, t0, t1).  Per piece, the t-interval of layer k is the
    difference of two sphere crossings — closed form — and the
    emission-absorption integral of a constant-(sigma, c) segment of
    length dt at accumulated depth tau_in is
        c * e^{-tau_in} * (1 - e^{-sigma dt}).

    colors: (r, g, b) per-layer classified RGB, each (L, lm).
    Returns (trans_mult, cr, cg, cb): the caller multiplies its carried
    transmittance by trans_mult and adds T_in * c to its radiance."""
    hh = prof[:, :lm]                     # ceilings h_1..h_lm (asc, inf pad)
    aa = prof[:, lm:2 * lm]               # baked classified alpha
    hlo = jnp.concatenate([h_bot[:, None], hh[:, :lm - 1]], axis=1)
    k1 = jax.lax.broadcasted_iota(jnp.int32, hh.shape, 1) + 1
    sig = jnp.where(k1 <= nl[:, None], aa, 0.0) / ud   # extinction per t

    tstar = -od
    tm = jnp.clip(tstar, t0, t1)
    odc = od[:, None]
    ooc = oo

    def t_dec(h):   # descending-branch crossing of radius h (t <= t*)
        return -odc - jnp.sqrt(jnp.maximum(odc * odc - ooc + h * h, 0.0))

    def t_inc(h):   # ascending-branch crossing (t >= t*)
        return -odc + jnp.sqrt(jnp.maximum(odc * odc - ooc + h * h, 0.0))

    # descending piece [t0, tm]: layer k spans [t_dec(h_k), t_dec(h_{k-1})]
    d_hi = t_dec(hh)
    d_lo = t_dec(hlo)
    len1 = jnp.maximum(0.0, jnp.minimum(d_lo, tm[:, None])
                       - jnp.maximum(d_hi, t0[:, None]))
    # ascending piece [tm, t1]: layer k spans [t_inc(h_{k-1}), t_inc(h_k)]
    i_lo = t_inc(hlo)
    i_hi = t_inc(hh)
    len2 = jnp.maximum(0.0, jnp.minimum(i_hi, t1[:, None])
                       - jnp.maximum(i_lo, tm[:, None]))
    od1 = sig * len1
    od2 = sig * len2

    # piece 1 front-to-back = DESCENDING k: exclusive depth prefix of
    # layer k is the suffix sum over j > k
    suf1 = jnp.cumsum(od1[:, ::-1], axis=1)[:, ::-1]   # inclusive suffix
    w1 = jnp.exp(-(suf1 - od1)) * (1.0 - jnp.exp(-od1))
    tau1 = jnp.sum(od1, axis=1, keepdims=True)
    # piece 2 = ascending k: exclusive prefix sum, offset by piece 1
    c2 = jnp.cumsum(od2, axis=1)
    w2 = jnp.exp(-(tau1 + c2 - od2)) * (1.0 - jnp.exp(-od2))
    w = w1 + w2

    rk, gk, bk = colors
    cr = jnp.sum(w * rk, axis=1)
    cg = jnp.sum(w * gk, axis=1)
    cb = jnp.sum(w * bk, axis=1)
    trans_mult = jnp.exp(-(tau1[:, 0] + jnp.sum(od2, axis=1)))
    return trans_mult, cr, cg, cb


def _column_exit(test16, t0, org, consts_dx, consts_dy, consts_dz, od, oo,
                 seg_hi):
    """First t > t0 where the ray leaves the located column: minimum over
    the three side-plane crossings (n.P(t) = w with n.D > 0), the inward
    bottom-sphere crossing, and the outward top-sphere crossing, clamped
    to the shell segment end."""
    ox, oy, oz = org
    dx, dy, dz = consts_dx, consts_dy, consts_dz
    big = jnp.float32(np.finfo(np.float32).max)
    t_exit = jnp.minimum(seg_hi, big)
    for i in (0, 4, 8):
        nx, ny, nz, w = (test16[:, i], test16[:, i + 1], test16[:, i + 2],
                         test16[:, i + 3])
        a = nx * ox + ny * oy + nz * oz - w
        b = nx * dx + ny * dy + nz * dz
        ti = jnp.where(b > 1e-30, -a / jnp.maximum(b, 1e-30), big)
        t_exit = jnp.minimum(t_exit, jnp.where(ti > t0, ti, big))
    h_bot = test16[:, 12]
    h_top = test16[:, 13]
    disc_b = od * od - oo + h_bot * h_bot
    tb_in = -od - jnp.sqrt(jnp.maximum(disc_b, 0.0))
    t_exit = jnp.minimum(
        t_exit, jnp.where((disc_b > 0.0) & (tb_in > t0), tb_in, big))
    tt_out = -od + jnp.sqrt(jnp.maximum(od * od - oo + h_top * h_top, 0.0))
    t_exit = jnp.minimum(t_exit, jnp.where(tt_out > t0, tt_out, big))
    return t_exit


def _candidate_entries(trows, valid, t_now, org, dx, dy, dz, od, oo,
                       w_cols: bool = False):
    """Exact next-entry t of each candidate column after t_now.

    trows: (M, K, 12) candidate rows for the quantized tier (normals at
    0/3/6, side planes pass through the origin, h_bot/h_top at 9/10) or
    (M, K, 16) for the f32 tier with w_cols=True (the pack_test_rows
    layout: (n, w) x 3 at 0..11, h_bot/h_top at 12/13).  A column is the
    intersection of three half-spaces (an interval [pl_lo, pl_hi] in t)
    with the radial annulus [h_bot, h_top] (up to TWO t-intervals when
    the ray dips below the bottom sphere).  Entry = min t > t_now inside.
    Returns (M,) — +inf where no candidate lies ahead."""
    ox, oy, oz = org
    big = jnp.float32(np.finfo(np.float32).max)
    pl_lo = jnp.full(trows.shape[:2], -big)
    pl_hi = jnp.full(trows.shape[:2], big)
    nonempty = valid
    dxc, dyc, dzc = dx[:, None], dy[:, None], dz[:, None]
    stride = 4 if w_cols else 3
    for i in (0, stride, 2 * stride):
        nx, ny, nz = trows[..., i], trows[..., i + 1], trows[..., i + 2]
        a = nx * ox + ny * oy + nz * oz
        if w_cols:
            a = a - trows[..., i + 3]
        b = nx * dxc + ny * dyc + nz * dzc
        tcross = -a / jnp.where(jnp.abs(b) > 1e-30, b,
                                jnp.float32(1e-30))
        pl_hi = jnp.minimum(pl_hi, jnp.where(b > 1e-30, tcross, big))
        pl_lo = jnp.maximum(pl_lo, jnp.where(b < -1e-30, tcross, -big))
        nonempty = nonempty & ~((jnp.abs(b) <= 1e-30) & (a > 0.0))
    h_bot = trows[..., 12 if w_cols else 9]
    h_top = trows[..., 13 if w_cols else 10]
    odc = od[:, None]
    disc_b = odc * odc - oo + h_bot * h_bot
    disc_t = odc * odc - oo + h_top * h_top
    has_b = disc_b > 0.0
    sb = jnp.sqrt(jnp.maximum(disc_b, 0.0))
    st = jnp.sqrt(jnp.maximum(disc_t, 0.0))
    tt0, tt1 = -odc - st, -odc + st
    tb0, tb1 = -odc - sb, -odc + sb
    nonempty = nonempty & (disc_t > 0.0)
    # annulus piece 1: [tt0, has_b ? min(tb0, tt1) : tt1]
    i1_lo, i1_hi = tt0, jnp.where(has_b, jnp.minimum(tb0, tt1), tt1)
    # annulus piece 2 (re-entry after dipping below h_bot): [tb1, tt1]
    i2_lo, i2_hi = jnp.maximum(tb1, tt0), tt1
    tnc = t_now[:, None]
    ent = jnp.full(trows.shape[:2], big)
    for lo, hi, ok in ((i1_lo, i1_hi, nonempty),
                       (i2_lo, i2_hi, nonempty & has_b)):
        lo2 = jnp.maximum(jnp.maximum(lo, pl_lo), tnc)
        hi2 = jnp.minimum(hi, pl_hi)
        ent = jnp.minimum(ent, jnp.where(ok & (hi2 >= lo2), lo2, big))
    return jnp.min(ent, axis=1)


def _bin_exit(loc: Locator, bl, bo, t_now, org, dx, dy, dz, od, oo):
    """First crossing after t_now of the lane's locator-bin boundary:
    two latitude cones (|z| = sin(lat_e) * r — solved squared, so the
    mirror cone contributes spurious EARLIER crossings, which only
    shorten the skip: conservative, never wrong) and two longitude
    planes through the z axis."""
    ox, oy, oz = org
    big = jnp.float32(np.finfo(np.float32).max)
    n_lat = loc.dims[0].astype(F32)
    n_lon = loc.dims[1].astype(F32)
    lat_step = (loc.lat_hi - loc.lat_lo) / n_lat
    lon_step = (loc.lon_hi - loc.lon_lo) / n_lon
    out = jnp.full(t_now.shape, big)
    for e in (0, 1):
        s = jnp.sin(loc.lat_lo + (bl.astype(F32) + e) * lat_step)
        s2 = s * s
        A = dz * dz - s2
        B = 2.0 * (oz * dz - s2 * od)
        C = oz * oz - s2 * oo
        disc = B * B - 4.0 * A * C
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        safe_a = jnp.where(jnp.abs(A) > 1e-30, 2.0 * A, jnp.float32(1e-30))
        r1 = (-B - sq) / safe_a
        r2 = (-B + sq) / safe_a
        rl = -C / jnp.where(jnp.abs(B) > 1e-30, B, jnp.float32(1e-30))
        quad = jnp.abs(A) > 1e-30
        for root, okm in ((r1, quad & (disc > 0.0)),
                          (r2, quad & (disc > 0.0)),
                          (rl, ~quad & (jnp.abs(B) > 1e-30))):
            out = jnp.minimum(out, jnp.where(okm & (root > t_now),
                                             root, big))
    for e in (0, 1):
        le = loc.lon_lo + (bo.astype(F32) + e) * lon_step
        nx, ny = -jnp.sin(le), jnp.cos(le)
        a = nx * ox + ny * oy
        b = nx * dx + ny * dy
        tc = -a / jnp.where(jnp.abs(b) > 1e-30, b, jnp.float32(1e-30))
        out = jnp.minimum(out, jnp.where((jnp.abs(b) > 1e-30)
                                         & (tc > t_now), tc, big))
    return out


# ===========================================================================
# The march loop (quantized tier)
# ===========================================================================

def _vq_rgb_table(q: QuantizedCells, tf: Transfunc):
    """(8, 128)-packed RGBA of every dequantized u8 value code — the
    exact post_classify chain on the 256 representable values, rebuilt
    per call (tiny) so TF edits need no extra bake."""
    codes = jnp.arange(256, dtype=F32)
    v = q.value_lo + codes * ((q.value_hi - q.value_lo) / 255.0)
    rgba = post_classify(tf, v)                       # (256, 4)
    return rgba.reshape(8, 128)                       # pack_table layout


def _bin_indices(loc: Locator, px, py, pz, r, pend):
    """(bl, bo) lat/lon locator-bin indices of (M,) points — the shared
    bin arithmetic of ops/fast._locate / ops/fastq._locate_q."""
    n_lat = loc.dims[0]
    n_lon = loc.dims[1]
    lat = jnp.arcsin(jnp.clip(pz / r, -1.0, 1.0))
    lon = jnp.arctan2(py, px)
    bl = jnp.clip(((lat - loc.lat_lo) / (loc.lat_hi - loc.lat_lo)
                   * n_lat.astype(F32)).astype(jnp.int32), 0, n_lat - 1)
    bo = jnp.clip(((lon - loc.lon_lo) / (loc.lon_hi - loc.lon_lo)
                   * n_lon.astype(F32)).astype(jnp.int32), 0, n_lon - 1)
    return bl, bo


def _march_loop(lp, xs, ys, width, height, edges, majors, nb, ml,
                locate_march, colors_fn, max_outer, et_eps, return_cost,
                prof_w, generations: int = 3):
    """Shared march driver (both tiers): the dense event loop described
    in the module docstring.  locate_march(px, py, pz, r, pend, tl, cs)
    -> (test16, prof, cid, hit, t_skip, served) with cs = (dx, dy, dz,
    od) of the CURRENT lane set; colors_fn(prof, cid, hit) -> per-layer
    (r, g, b) each (L, ml).

    GENERATIONAL COMPACTION: rays finish at very different
    iteration counts (early termination; radial vs tangential chords),
    and a dense loop pays every lane every iteration.  The loop runs in
    up to `generations` stages of halving width: stage g exits once the
    active count fits the next width, the survivors (and their per-lane
    ray constants) GATHER into the narrower arrays, and results merge
    back with the scatter-free rank-gather select (see
    ops/fast._compact_service_packed).  Per-lane math is untouched —
    outputs are bit-identical to the single-stage loop (locked by
    tests/test_march.py); only wall time changes."""
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    oo = ox * ox + oy * oy + oz * oz
    org = (ox, oy, oz)
    ud = lp.unit_distance

    init, consts, wrote = _init_lanes(lp, xs, ys, width, height,
                                      edges, majors, oo, nb, prof_w=prof_w)
    cs_full = (consts.dx, consts.dy, consts.dz, consts.od,
               consts.s1_lo, consts.s1_hi)

    eps_rel = jnp.float32(4e-7)
    eps_abs = jnp.float32(1e-4) * ud

    def run_gen(carry, cs, min_active):
        dx, dy, dz, od, s1_lo, s1_hi = cs

        def cond(c):
            done, it = c[7], c[8]
            alive = jnp.sum((done == 0).astype(jnp.int32))
            return (alive > min_active) & (it < max_outer)

        def body(carry):
            t, si, seg_hi, T, ar, ag, ab, done, it = carry
            active = done == 0
            # shell-segment advance / exhaustion (step_core semantics)
            at_end = t >= seg_hi
            to1 = active & at_end & (si == 0) & (s1_hi > s1_lo)
            t = jnp.where(to1, s1_lo, t)
            seg_hi = jnp.where(to1, s1_hi, seg_hi)
            si = jnp.where(to1, 1, si)
            done = jnp.where(active & at_end & ~to1, 1, done)
            act = done == 0

            eps = jnp.maximum(eps_abs, jnp.abs(t) * eps_rel)
            tl = t + eps
            r = _r_of(tl, od, oo)
            band = _band_of(r, edges, nb)
            m = _select_band(majors, band)
            seg_end, _ = _band_exit(tl, band, seg_hi, od, oo, edges)
            zero = m <= 0.0
            pend = act & ~zero

            px = ox + dx * tl
            py = oy + dy * tl
            pz = oz + dz * tl
            test16, prof, cid, hit, t_skip, served = locate_march(
                px, py, pz, r, pend, tl, (dx, dy, dz, od))
            hit = pend & hit

            # HIT: integrate the crossing [t, t_exit] analytically
            t_exit = _column_exit(test16, t, org, dx, dy, dz, od, oo,
                                  seg_hi)
            t_exit = jnp.maximum(t_exit, tl)
            tmul, cr, cg, cb = _integrate_column(
                prof, ml, test16[:, 12], test16[:, 14].astype(jnp.int32),
                t, t_exit, od, oo, ud, colors_fn(prof, cid, hit))
            ar = jnp.where(hit, ar + T * cr, ar)
            ag = jnp.where(hit, ag + T * cg, ag)
            ab = jnp.where(hit, ab + T * cb, ab)
            T = jnp.where(hit, T * tmul, T)

            # next position: hit -> column exit; served miss -> exact gap
            # skip; UNSERVED miss (two-stage tail overflow) -> stay put
            # and retry next iteration (latency only, never bias); zero
            # band -> band exit.  Progress floor tl guards f32 ties.
            t_miss = jnp.maximum(jnp.minimum(t_skip, seg_end), tl)
            t_new = jnp.where(hit, t_exit,
                              jnp.where(zero, jnp.maximum(seg_end, tl),
                                        jnp.where(served, t_miss, t)))
            t = jnp.where(act, t_new, t)
            done = jnp.where(act & (T < et_eps), 1, done)
            return (t, si, seg_hi, T, ar, ag, ab, done, it + 1)

        return jax.lax.while_loop(cond, body, carry)

    L = xs.shape[0]
    widths = [L]
    w = L
    for _ in range(max(generations, 1) - 1):
        if w // 2 < 512:
            break
        w //= 2
        widths.append(w)

    zero_f = jnp.zeros(L, F32)
    carry = (init.t, init.si, init.seg_hi, jnp.ones(L, F32),
             zero_f, zero_f, zero_f, init.done, jnp.int32(0))
    carry = run_gen(carry, cs_full,
                    widths[1] if len(widths) > 1 else 0)
    for s in range(1, len(widths)):
        Lg = widths[s]
        t, si, seg_hi, T, ar, ag, ab, done, it = carry
        active = done == 0
        cnt = jnp.sum(active.astype(jnp.int32))
        idx = jnp.nonzero(active, size=Lg, fill_value=0)[0]
        okg = jnp.arange(Lg) < cnt      # fill slots become inert lanes
        sub = (t[idx], si[idx], seg_hi[idx], T[idx],
               ar[idx], ag[idx], ab[idx],
               jnp.where(okg, 0, 1).astype(jnp.int32), it)
        cs_g = tuple(a[idx] for a in cs_full)
        out = run_gen(sub, cs_g,
                      widths[s + 1] if s + 1 < len(widths) else 0)
        to, sio, shio, To, aro, ago, abo, doneo, it = out
        # scatter-free merge: each original lane gathers its own result
        # row by compaction rank (inactive lanes keep their values)
        rank = jnp.cumsum(active.astype(jnp.int32)) - 1
        in_win = active & (rank < Lg)
        rc = jnp.clip(rank, 0, Lg - 1)
        carry = (jnp.where(in_win, to[rc], t),
                 jnp.where(in_win, sio[rc], si),
                 jnp.where(in_win, shio[rc], seg_hi),
                 jnp.where(in_win, To[rc], T),
                 jnp.where(in_win, aro[rc], ar),
                 jnp.where(in_win, ago[rc], ag),
                 jnp.where(in_win, abo[rc], ab),
                 jnp.where(in_win, doneo[rc], done), it)
    t, si, seg_hi, T, ar, ag, ab, done, n_it = carry

    amb_r = lp.ambient_color[0] * lp.ambient_radiance
    amb_g = lp.ambient_color[1] * lp.ambient_radiance
    amb_b = lp.ambient_color[2] * lp.ambient_radiance
    color_alpha = jnp.stack([ar * amb_r, ag * amb_g, ab * amb_b,
                             1.0 - T], axis=-1)
    color_alpha = jnp.where(wrote[:, None], color_alpha, 0.0)
    if return_cost:
        return wrote, color_alpha, n_it
    return wrote, color_alpha


def march_rays_q(q: QuantizedCells, loc: Locator, k_cap: int,
                 bands: RadialBands, tf: Transfunc, lp, xs, ys,
                 width: int, height: int, max_outer: int = 8192,
                 et_eps: float = ET_EPS, finemap=None,
                 return_cost: bool = False, generations: int = 3):
    """One deterministic march for a batch of pixels on the quantized
    tier.  Returns (wrote (L,) bool, color_alpha (L, 4) f32) — the same
    contract as ops/fastq.render_fast_q, but color_alpha is the CONVERGED
    expected radiance of the jittered ray (alpha = 1 - transmittance),
    not a one-sample estimate."""
    from ..utils.layout import packed_gather
    from .fastq import _test_and_fill

    lm = q.lm
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    oo = ox * ox + oy * oy + oz * oz
    org = (ox, oy, oz)
    tab = _vq_rgb_table(q, tf)
    inv_span = 255.0 / jnp.maximum(q.value_hi - q.value_lo,
                                   jnp.float32(1e-30))

    def locate_march(px, py, pz, r, pend, tl):
        bl, bo = _bin_indices(loc, px, py, pz, r, pend)
        bid = jnp.where(pend, bl * loc.dims[1] + bo, 0)
        cand = packed_gather(loc.bins, bid, k_cap)    # (L, K)
        test16, prof, cid, hit, trows, valid = _test_and_fill(
            q, cand, px, py, pz, r, pend, return_rows=True)
        return test16, prof, cid, hit, trows, valid, bl, bo

    def colors_q(prof, cid, hit):
        vq = jnp.clip(jnp.rint((prof[:, 2 * lm:3 * lm] - q.value_lo)
                               * inv_span), 0, 255).astype(jnp.int32)
        rgba = packed_gather(tab, vq, 4)              # (L, lm, 4)
        return rgba[..., 0], rgba[..., 1], rgba[..., 2]

    from .fastq import _locate_q_fine
    primary = None if finemap is None else (
        lambda px, py, pz, r, pend: _locate_q_fine(
            finemap, loc, k_cap, q, px, py, pz, r, pend))
    return _march_generic(q_locate=locate_march, colors_fn=colors_q,
                          loc=loc, bands=bands, lp=lp, xs=xs, ys=ys,
                          width=width, height=height, ml=lm,
                          prof_w=3 * lm, w_cols=False,
                          max_outer=max_outer, et_eps=et_eps,
                          return_cost=return_cost, primary=primary,
                          tail_cap=max(xs.shape[0] // 4, 128),
                          generations=generations)


def march_rays(cells, packed, loc: Locator, bands: RadialBands, lp,
               xs, ys, width: int, height: int, max_outer: int = 8192,
               et_eps: float = ET_EPS, return_cost: bool = False,
               generations: int = 3):
    """f32-tier deterministic march (peer of ops/fast.render_fast on the
    'locator' sampler): per-layer colors come from the baked
    PackedCells.rgb rows (one (L, 96) gather per column crossing)."""
    from ..data.icfile import MAX_LAYERS
    from .fast import PROF_W, _test_and_fill_f32

    k_cap = int(loc.bins.shape[1])           # f32 bins are unpacked (B, K)
    ml = MAX_LAYERS

    def locate_march(px, py, pz, r, pend, tl):
        bl, bo = _bin_indices(loc, px, py, pz, r, pend)
        bid = jnp.where(pend, bl * loc.dims[1] + bo, 0)
        cand = loc.bins[bid]                          # (L, K) gather
        test16, prof, cid, hit, trows, valid = _test_and_fill_f32(
            packed, cand, px, py, pz, r, pend, False, return_rows=True)
        return test16, prof, cid, hit, trows, valid, bl, bo

    def colors_f32(prof, cid, hit):
        rows = packed.rgb[jnp.where(hit, cid, 0)]     # (L, 96) gather
        return rows[:, :ml], rows[:, ml:2 * ml], rows[:, 2 * ml:3 * ml]

    return _march_generic(q_locate=locate_march, colors_fn=colors_f32,
                          loc=loc, bands=bands, lp=lp, xs=xs, ys=ys,
                          width=width, height=height, ml=ml,
                          prof_w=PROF_W, w_cols=True,
                          max_outer=max_outer, et_eps=et_eps,
                          return_cost=return_cost,
                          generations=generations)


def _march_generic(*, q_locate, colors_fn, loc, bands, lp, xs, ys,
                   width, height, ml, prof_w, w_cols, max_outer, et_eps,
                   return_cost, primary=None, tail_cap: int = 0,
                   generations: int = 3):
    """Tier glue: wraps a tier's locate (which returns the raw candidate
    rows) with the exact gap-skip computation, then runs _march_loop.

    With `primary` (the finemap point locate): a TWO-STAGE service — the
    cheap primary runs dense on all pending lanes, and only its MISSES
    (true gaps + unmapped points) are compacted to `tail_cap` rows for
    the full query + skip computation.  The march is refresh-bound by
    construction (every column change is a locate; the two-slot cache
    never hits on a monotonic walk), so the primary carries most of the
    gather cost at giant-table scales, exactly as in the Woodcock tiers.
    Tail overflow lanes report served=False and retry next iteration
    (latency only, never bias — _march_loop keeps their t)."""
    ox, oy, oz = lp.cam_org[0], lp.cam_org[1], lp.cam_org[2]
    oo = ox * ox + oy * oy + oz * oz
    org = (ox, oy, oz)
    edges = bands.edges
    majors = bands.max_opacities
    nb = bands.num_bands

    def full_with_skip(px, py, pz, r, pend, tl, dxs, dys, dzs, ods):
        test16, prof, cid, hit, trows, valid, bl, bo = q_locate(
            px, py, pz, r, pend, tl)
        entry = _candidate_entries(trows, valid, tl, org, dxs, dys, dzs,
                                   ods, oo, w_cols=w_cols)
        tbin = _bin_exit(loc, bl, bo, tl, org, dxs, dys, dzs, ods, oo)
        return test16, prof, cid, hit, jnp.minimum(entry, tbin)

    if primary is None:
        def locate(px, py, pz, r, pend, tl, cs):
            dx, dy, dz, od = cs
            out = full_with_skip(px, py, pz, r, pend, tl, dx, dy, dz, od)
            return (*out, pend)
    else:
        def locate(px, py, pz, r, pend, tl, cs):
            dx, dy, dz, od = cs
            t16a, profa, cida, hita = primary(px, py, pz, r, pend)
            miss = pend & ~hita
            L = px.shape[0]
            P = min(max(tail_cap, 128), L)
            cnt = jnp.sum(miss.astype(jnp.int32))
            idx = jnp.nonzero(miss, size=P, fill_value=L - 1)[0]
            ok = jnp.arange(P) < cnt
            t16b, profb, cidb, hitb, skipb = full_with_skip(
                px[idx], py[idx], pz[idx], r[idx], ok, tl[idx],
                dx[idx], dy[idx], dz[idx], od[idx])
            # scatter-free rank-gather merge (see
            # ops/fast._compact_service_packed)
            rank = jnp.cumsum(miss.astype(jnp.int32)) - 1
            in_win = miss & (rank < P)
            rc = jnp.clip(rank, 0, P - 1)
            big = jnp.float32(np.finfo(np.float32).max)
            test16 = jnp.where(in_win[:, None], t16b[rc], t16a)
            prof = jnp.where(in_win[:, None], profb[rc], profa)
            cid = jnp.where(in_win, cidb[rc], cida)
            hit = jnp.where(in_win, hitb[rc], hita)
            t_skip = jnp.where(in_win, skipb[rc], big)
            served = (pend & hita) | (in_win & ok[rc])
            return test16, prof, cid, hit, t_skip, served

    return _march_loop(lp, xs, ys, width, height, edges, majors, nb, ml,
                       locate, colors_fn, max_outer, et_eps, return_cost,
                       prof_w, generations=generations)


def _frame_driver(run, accum, fb, width, height, chunk, pixel_perm,
                  n_active, accum_id):
    """Shared full-frame chunking + _finalize (the render_frame_fast_q
    pixel_perm / n_active contract)."""
    from .render import _finalize

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

    if n_proc <= chunk:
        wrote, ca = run(xs_all, ys_all)
    else:
        n = -(-n_proc // chunk)
        pad = n * chunk - n_proc
        if pad:
            xs_all = jnp.concatenate([xs_all, jnp.zeros(pad, jnp.int32)])
            ys_all = jnp.concatenate([ys_all, jnp.zeros(pad, jnp.int32)])
        wrote, ca = jax.lax.map(
            lambda cc: run(cc[0], cc[1]),
            (xs_all.reshape(n, chunk), ys_all.reshape(n, chunk)))
        wrote = wrote.reshape(-1)[:n_proc]
        ca = ca.reshape(-1, 4)[:n_proc]
    accum_head, fb_head = _finalize(wrote, ca, accum[:n_proc], fb[:n_proc],
                                    accum_id)
    if n_proc == total:
        return accum_head, fb_head
    return (jnp.concatenate([accum_head, accum[n_proc:]]),
            jnp.concatenate([fb_head, fb[n_proc:]]))


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "chunk", "k_cap",
                                    "n_active", "max_outer", "et_eps",
                                    "generations"),
                   donate_argnames=("accum", "fb"))
def render_frame_march_q(q: QuantizedCells, loc: Locator, k_cap: int,
                         bands: RadialBands, tf: Transfunc, lp, accum, fb,
                         *, width: int, height: int, chunk: int = CHUNK,
                         pixel_perm=None, n_active: int | None = None,
                         max_outer: int = 8192, et_eps: float = ET_EPS,
                         finemap=None, generations: int = 3):
    """Full-frame deterministic march on the quantized tier — drop-in
    peer of ops/fastq.render_frame_fast_q (same pixel_perm / n_active /
    chunking / _finalize contract).  Each call adds ONE jittered
    converged sample (lp.accum_id selects the jitter); a few calls give
    an antialiased converged frame."""
    def run(xs, ys):
        return march_rays_q(q, loc, k_cap, bands, tf, lp, xs, ys,
                            width, height, max_outer=max_outer,
                            et_eps=et_eps, finemap=finemap,
                            generations=generations)

    return _frame_driver(run, accum, fb, width, height, chunk, pixel_perm,
                         n_active, lp.accum_id)


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "chunk",
                                    "n_active", "max_outer", "et_eps",
                                    "generations"),
                   donate_argnames=("accum", "fb"))
def render_frame_march(cells, packed, loc: Locator, bands: RadialBands,
                       lp, accum, fb, *, width: int, height: int,
                       chunk: int = CHUNK, pixel_perm=None,
                       n_active: int | None = None,
                       max_outer: int = 8192, et_eps: float = ET_EPS,
                       generations: int = 3):
    """Full-frame deterministic march on the f32 tier — drop-in peer of
    ops/fast.render_frame_fast (locator sampler)."""
    def run(xs, ys):
        return march_rays(cells, packed, loc, bands, lp, xs, ys,
                          width, height, max_outer=max_outer,
                          et_eps=et_eps, generations=generations)

    return _frame_driver(run, accum, fb, width, height, chunk, pixel_perm,
                         n_active, lp.accum_id)
