"""Accelerated ray traversal fused with Woodcock tracking.

The reference drives Woodcock tracking through per-cell majorants with two
traversals — a Cartesian 3-DDA (ref: icon_rt/DDA.h:37-136) and a
spherical-shell DDA (ref: icon_rt/ShellAccel.h:82-229) — using device-side
callbacks.  Callbacks don't exist under XLA, so each traversal+tracking
pair is flattened into ONE lane-masked `lax.while_loop` state machine:
every iteration performs at most one Woodcock step and, when the current
cell segment is exhausted, one DDA advance.  Under vmap all rays march in
lockstep with per-lane masks — the wavefront shape wide vector
machines want.

RNG parity: zero-majorant cells consume no draws (the reference breaks
before drawing, deviceCode.cu:161-162); every tentative collision consumes
one draw; acceptance consumes one more only when the sample landed inside
the volume.

Faithful reference quirk (do NOT "fix"): sdda builds its lat/lon boundary
planes via toCartesian with radius 0 (ref: ShellAccel.h:150-155,186-199),
which yields all-zero planes whose evalPlane is identically 0.  The
traversal therefore gives the whole shell segment the ENTRY cell's majorant
and then steps diagonally through zero-length visits.  We reproduce that
exactly (tnext_lat = tnext_lon = 0) so images and RNG streams match the
CUDA reference.  A corrected, genuinely skipping traversal is provided by
the Cartesian grid mode.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.lcg import lcg_next

# numpy, not jnp: a module-level device constant would force backend
# init at import time; numpy scalars trace identically
FLT_MAX = np.float32(np.finfo(np.float32).max)


class TraceResult(NamedTuple):
    color: jnp.ndarray   # (3,) f32 albedo (pre-ambient)
    alpha: jnp.ndarray   # () f32
    rng: jnp.ndarray     # () uint32


def _woodcock_step(rng, wt, seg0, seg1, majorant, unit_distance,
                   sample_fn, classify_fn, org, direction):
    """One tentative collision (ref: deviceCode.cu:160-183) plus the
    collision-window check of woodcockFunc (ref: deviceCode.cu:304-323).

    Returns (rng, wt, seg_over, collided, rgba).
    """
    active = majorant > 0.0
    rng1, xi = lcg_next(rng)
    wt_new = wt - jnp.log(1.0 - xi) / (majorant / unit_distance)
    rng = jnp.where(active, rng1, rng)
    wt = jnp.where(active, wt_new, wt)
    beyond = wt > seg1
    pos = org + direction * wt
    hit, value = sample_fn(pos)
    rgba = classify_fn(value)
    rng2, u = lcg_next(rng)
    sampled = active & (~beyond) & hit
    accept = sampled & (rgba[3] >= u * majorant)
    rng = jnp.where(sampled, rng2, rng)
    # woodcockFunc records the hit only for t strictly inside (t0, t1);
    # t here is min(wt, seg1) = wt when accepted
    collided = accept & (wt > seg0) & (wt < seg1)
    seg_over = (~active) | beyond | accept
    return rng, wt, seg_over, collided, rgba


def _linear_index(cell, dims):
    """z-major linearization (ref: DDA.h:16-21)."""
    return (cell[2] * dims[0] * dims[1] + cell[1] * dims[0] + cell[0])


# ===========================================================================
# Cartesian grid (dda3, ref: DDA.h:37-136)
# ===========================================================================

def trace_dda3(sample_fn: Callable, classify_fn: Callable,
               max_opacities, dims, box_lo, box_hi,
               org, direction, tmin, tmax, rng, unit_distance,
               active=True, max_iters: int = 1 << 20) -> TraceResult:
    """Woodcock tracking through a Cartesian majorant grid, one ray.

    All scalar/vec3 per-ray args; vmap over rays outside.  dims (3,) i32.
    `active=False` lanes (rays that missed the volume) skip the loop.
    """
    f32 = jnp.float32
    ray_tmin = jnp.asarray(tmin, f32)
    org_s = org + ray_tmin * direction          # shifted so tmin = 0
    tmax_s = jnp.asarray(tmax, f32) - ray_tmin
    rcp = 1.0 / direction
    lo = (box_lo - org_s) * rcp
    hi = (box_hi - org_s) * rcp
    tnear = jnp.minimum(lo, hi)
    tfar = jnp.maximum(lo, hi)
    dimsf = dims.astype(f32)
    # projectOnGrid (ref: DDA.h:24-31): clamped trunc-toward-zero
    v01 = (org_s - box_lo) / (box_hi - box_lo)
    cell0 = jnp.clip((v01 * dimsf).astype(jnp.int32), 0, dims - 1)
    dist = jnp.maximum(0.0, (tfar - tnear) / dimsf)
    pos_dir = direction > 0.0
    step = jnp.where(pos_dir, 1, -1).astype(jnp.int32)
    stop = jnp.where(pos_dir, dims, -1).astype(jnp.int32)
    tnext0 = jnp.where(pos_dir,
                       tnear + (cell0 + 1).astype(f32) * dist,
                       tnear + (dims - cell0).astype(f32) * dist)

    def visit(cell, tnext, t0):
        """Start a cell visit: segment bounds + majorant (loop head of
        ref DDA.h:98-100)."""
        t1 = jnp.minimum(jnp.min(tnext), tmax_s)
        majorant = max_opacities[_linear_index(cell, dims)]
        return t1, ray_tmin + t0, ray_tmin + t1, majorant

    t1_0, seg0_0, seg1_0, m_0 = visit(cell0, tnext0, f32(0.0))

    class _S(NamedTuple):
        cell: jnp.ndarray
        tnext: jnp.ndarray
        t0: jnp.ndarray
        t1: jnp.ndarray
        seg0: jnp.ndarray
        seg1: jnp.ndarray
        majorant: jnp.ndarray
        wt: jnp.ndarray
        rng: jnp.ndarray
        color: jnp.ndarray
        alpha: jnp.ndarray
        done: jnp.ndarray
        it: jnp.ndarray

    def cond(s: _S):
        return (~s.done) & (s.it < max_iters)

    def body(s: _S) -> _S:
        rng, wt, seg_over, collided, rgba = _woodcock_step(
            s.rng, s.wt, s.seg0, s.seg1, s.majorant, unit_distance,
            sample_fn, classify_fn, org, direction)
        color = jnp.where(collided, rgba[:3], s.color)
        alpha = jnp.where(collided, jnp.where(rgba[3] > 0.0, 1.0, 0.0), s.alpha)
        done = s.done | collided

        # DDA advance (ref: DDA.h:110-133), sequential axis updates
        adv = seg_over & ~done
        t_closest = jnp.min(s.tnext)
        tnext, cell = s.tnext, s.cell
        out = jnp.bool_(False)
        for k in range(3):
            mk = adv & (~out) & (tnext[k] == t_closest)
            tnext = tnext.at[k].set(jnp.where(mk, tnext[k] + dist[k], tnext[k]))
            cell = cell.at[k].set(jnp.where(mk, cell[k] + step[k], cell[k]))
            out = out | (mk & (cell[k] == stop[k]))
        done = done | (adv & out)

        # new visit for lanes that advanced and stayed in the grid
        t0_new = jnp.where(adv, s.t1, s.t0)
        t1_new, seg0_new, seg1_new, m_new = visit(cell, tnext, t0_new)
        live = adv & ~out
        return _S(
            cell=cell, tnext=tnext,
            t0=jnp.where(live, t0_new, s.t0),
            t1=jnp.where(live, t1_new, s.t1),
            seg0=jnp.where(live, seg0_new, s.seg0),
            seg1=jnp.where(live, seg1_new, s.seg1),
            majorant=jnp.where(live, m_new, s.majorant),
            wt=jnp.where(live, seg0_new, wt),
            rng=rng, color=color, alpha=alpha, done=done, it=s.it + 1)

    init = _S(cell=cell0, tnext=tnext0, t0=f32(0.0), t1=t1_0,
              seg0=seg0_0, seg1=seg1_0, majorant=m_0, wt=seg0_0,
              rng=rng, color=jnp.zeros(3, f32), alpha=f32(0.0),
              done=~jnp.asarray(active, jnp.bool_), it=jnp.int32(0))
    out = jax.lax.while_loop(cond, body, init)
    return TraceResult(out.color, out.alpha, out.rng)


# ===========================================================================
# Spherical shell (sdda, ref: ShellAccel.h:82-229)
# ===========================================================================

def _intersect_sphere(org, direction, radius):
    """Origin-centered sphere (ref: ShellAccel.h:34-53)."""
    a = jnp.sum(direction * direction)
    b = jnp.sum(direction * org) * 2.0
    c = jnp.sum(org * org) - radius * radius
    d = b * b - 4.0 * a * c
    hit = d >= 0.0
    sq = jnp.sqrt(jnp.maximum(d, 0.0))
    q = jnp.where(b < 0.0, -0.5 * (b - sq), -0.5 * (b + sq))
    t1 = q / a
    t2 = c / q
    return hit, jnp.minimum(t1, t2), jnp.maximum(t1, t2)


def _project_spherical(sph, dims, slo, shi):
    """Unclamped, (dims-1)-scaled projection (ref: ShellAccel.h:57-68)."""
    scaled = (sph - slo) / (shi - slo) * (dims - 1).astype(jnp.float32)
    return scaled.astype(jnp.int32)


def _to_spherical(p):
    r = jnp.sqrt(jnp.sum(p * p))
    return jnp.stack([r, jnp.arcsin(p[2] / r), jnp.arctan2(p[1], p[0])])


def trace_sdda(sample_fn: Callable, classify_fn: Callable,
               max_opacities, dims, sph_lo, sph_hi,
               org, direction, tmin, tmax, rng, unit_distance,
               active=True, max_iters: int = 1 << 20) -> TraceResult:
    """Woodcock tracking through the spherical-shell grid, one ray —
    faithful to the reference sdda including its degenerate lat/lon planes
    (see module docstring)."""
    f32 = jnp.float32
    hit1, ts1, ts4 = _intersect_sphere(org, direction, sph_hi[0])
    hit2, ts2, ts3 = _intersect_sphere(org, direction, sph_lo[0])

    none = (~hit1 & ~hit2) | (ts4 < tmin)
    # segment table (ref: ShellAccel.h:94-111)
    outer_only = hit1 & ~hit2
    front = jnp.asarray(tmin, f32) < ts2
    r0_lo = jnp.where(outer_only, ts1, jnp.where(front, ts1, ts3))
    r0_hi = jnp.where(outer_only, ts4, jnp.where(front, ts2, ts4))
    r1_lo = jnp.where(outer_only, FLT_MAX, jnp.where(front, ts3, FLT_MAX))
    r1_hi = jnp.where(outer_only, -FLT_MAX, jnp.where(front, ts4, -FLT_MAX))
    ranges = jnp.stack([jnp.stack([r0_lo, r0_hi]), jnp.stack([r1_lo, r1_hi])])
    eps = sph_lo[0] * 1e-6

    def range_setup(si):
        """Enter segment si (ref: ShellAccel.h:113-162). Returns
        (invalid, cell, step, stop, tnext, t)."""
        rlo = ranges[si, 0]
        rhi = ranges[si, 1]
        invalid = rhi <= rlo
        p1 = org + direction * (rlo + eps)
        p2 = org + direction * (rhi - eps)
        sp1 = _to_spherical(p1)
        sp2 = _to_spherical(p2)
        cell = _project_spherical(sp1, dims, sph_lo, sph_hi)
        step = jnp.where(sp1 < sp2, 1, -1).astype(jnp.int32)
        stop = _project_spherical(sp2, dims, sph_lo, sph_hi) + step
        # lat/lon planes are degenerate (r=0 -> zero plane): eval == 0
        tnext = jnp.stack([rhi, f32(0.0), f32(0.0)])
        return invalid, cell, step, stop, tnext, rlo

    def visit(cell, tnext, t):
        """Loop-head visit (ref: ShellAccel.h:163-172): t1 = smallest
        tnext >= t (FLT_MAX if none); leaf via wrapped coords."""
        cand = jnp.where(tnext >= t, tnext, FLT_MAX)
        t1 = jnp.min(cand)
        wrapped = jnp.mod(cell, dims)  # floored mod == the while-loop wrap
        majorant = max_opacities[_linear_index(wrapped, dims)]
        return t1, majorant

    inv0, cell_0, step_0, stop_0, tnext_0, t_0 = range_setup(jnp.int32(0))
    t1_0, m_0 = visit(cell_0, tnext_0, t_0)

    class _S(NamedTuple):
        si: jnp.ndarray
        cell: jnp.ndarray
        step: jnp.ndarray
        stop: jnp.ndarray
        tnext: jnp.ndarray
        t: jnp.ndarray
        t1: jnp.ndarray
        majorant: jnp.ndarray
        wt: jnp.ndarray
        rng: jnp.ndarray
        color: jnp.ndarray
        alpha: jnp.ndarray
        done: jnp.ndarray
        it: jnp.ndarray

    def cond(s: _S):
        return (~s.done) & (s.it < max_iters)

    def body(s: _S) -> _S:
        rng, wt, seg_over, collided, rgba = _woodcock_step(
            s.rng, s.wt, s.t, s.t1, s.majorant, unit_distance,
            sample_fn, classify_fn, org, direction)
        color = jnp.where(collided, rgba[:3], s.color)
        alpha = jnp.where(collided, jnp.where(rgba[3] > 0.0, 1.0, 0.0), s.alpha)
        done = s.done | collided

        # advance (ref: ShellAccel.h:174-201), sequential with break-on-stop
        adv = seg_over & ~done
        t_closest = jnp.min(s.tnext)
        tnext, cell = s.tnext, s.cell
        out = jnp.bool_(False)
        # radial axis: no tnext update on advance (stays at range end)
        m0 = adv & (tnext[0] == t_closest)
        cell = cell.at[0].set(jnp.where(m0, cell[0] + s.step[0], cell[0]))
        out = out | (m0 & (cell[0] == s.stop[0]))
        for k in (1, 2):
            mk = adv & (~out) & (tnext[k] == t_closest)
            cell = cell.at[k].set(jnp.where(mk, cell[k] + s.step[k], cell[k]))
            outk = mk & (cell[k] == s.stop[k])
            # degenerate plane re-eval -> 0 (only when not stopping)
            tnext = tnext.at[k].set(jnp.where(mk & ~outk, 0.0, tnext[k]))
            out = out | outk

        # in-range advance: t <- t_closest, new visit
        t_new = jnp.where(adv & ~out, t_closest, s.t)

        # range switch when stepping out: si+1 (or finished)
        switch = adv & out
        si_new = s.si + jnp.where(switch, 1, 0)
        inv_n, cell_n, step_n, stop_n, tnext_n, t_n = range_setup(
            jnp.minimum(si_new, 1))
        finished = switch & ((si_new > 1) | inv_n)
        use_new_range = switch & ~finished

        cell = jnp.where(use_new_range, cell_n, cell)
        stepv = jnp.where(use_new_range, step_n, s.step)
        stopv = jnp.where(use_new_range, stop_n, s.stop)
        tnext = jnp.where(use_new_range, tnext_n, tnext)
        t_new = jnp.where(use_new_range, t_n, t_new)

        t1_new, m_new = visit(cell, tnext, t_new)
        live = adv & ~finished
        done = done | finished
        return _S(
            si=si_new, cell=cell, step=stepv, stop=stopv, tnext=tnext,
            t=jnp.where(live, t_new, s.t),
            t1=jnp.where(live, t1_new, s.t1),
            majorant=jnp.where(live, m_new, s.majorant),
            wt=jnp.where(live, t_new, wt),
            rng=rng, color=color, alpha=alpha, done=done, it=s.it + 1)

    init = _S(si=jnp.int32(0), cell=cell_0, step=step_0, stop=stop_0,
              tnext=tnext_0, t=t_0, t1=t1_0, majorant=m_0, wt=t_0,
              rng=rng, color=jnp.zeros(3, f32), alpha=f32(0.0),
              done=none | inv0 | ~jnp.asarray(active, jnp.bool_),
              it=jnp.int32(0))
    out = jax.lax.while_loop(cond, body, init)
    return TraceResult(out.color, out.alpha, out.rng)
