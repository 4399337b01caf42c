"""Scalar numpy oracle: an independent, straightforward transliteration of
the reference renderer's per-pixel semantics (icon_rt/deviceCode.cu), used
to validate the vectorized JAX engine.  Deliberately slow and simple.

Float32 discipline: every intermediate is float32, matching CUDA single
precision up to libm ULP differences.
"""
from __future__ import annotations

import numpy as np

from icon_dvr.utils.lcg import np_lcg_init, np_lcg_next

F = np.float32


class Rng:
    def __init__(self, v0, v1):
        self.state = np_lcg_init(np.uint32(v0 & 0xFFFFFFFF), np.uint32(v1 & 0xFFFFFFFF))

    def __call__(self):
        self.state, v = np_lcg_next(self.state)
        return F(v)


def to_spherical(p):
    r = np.sqrt(np.sum(p * p, dtype=F))
    return np.array([r, np.arcsin(p[2] / r), np.arctan2(p[1], p[0])], F)


def to_cartesian(s):
    r, lat, lon = s
    cl = np.cos(lat, dtype=F)
    return np.array([r * cl * np.cos(lon, dtype=F),
                     r * cl * np.sin(lon, dtype=F),
                     r * np.sin(lat, dtype=F)], F)


def make_plane(a, b, c):
    n = np.cross(b - a, c - a).astype(F)
    return np.concatenate([n, [np.sum(a * n, dtype=F)]]).astype(F)


def eval_plane(p, pos):
    return F(np.sum(pos * p[:3], dtype=F) - p[3])


def find_height(height, num_layers, hpos):
    for i in range(num_layers):
        if hpos <= height[i + 1]:
            return i
    return num_layers  # unreachable given the radial check


def sample_cell(ds, i, pos):
    """Point-in-prism + value (ref: ICONGrid.h:181-208). Returns (hit, value)."""
    sph = to_spherical(pos)
    h = ds.height[i]
    nl = int(ds.num_layers[i])
    if sph[0] < h[0] or sph[0] > h[nl]:
        return False, F(0)
    bv = [to_cartesian(np.array([h[0], ds.lat[i, k], ds.lon[i, k]], F)) for k in range(3)]
    tv = [to_cartesian(np.array([h[nl], ds.lat[i, k], ds.lon[i, k]], F)) for k in range(3)]
    for (a, b, t) in ((0, 1, 1), (1, 2, 2), (2, 0, 0)):
        if eval_plane(make_plane(bv[a], bv[b], tv[t]), pos) > 0.0:
            return False, F(0)
    layer = find_height(h, nl, sph[0])
    return True, F(ds.value[i, layer])


def sample_volume_brute(ds, pos):
    for i in range(ds.num_cells):
        hit, v = sample_cell(ds, i, pos)
        if hit:
            return True, v
    return False, F(0)


def post_classify(lut, value_range, opacity_scale, v):
    size = lut.shape[0]
    v = F((v - value_range[0]) / (value_range[1] - value_range[0]))
    idx = int(v * size)  # trunc toward zero
    frac = F(v * size - idx)
    v1 = lut[min(max(idx, 0), size - 1)]
    v2 = lut[min(max(idx + 1, 0), size - 1)]
    return (v1 * frac + v2 * (F(1) - frac) * np.array([1, 1, 1, opacity_scale], F)).astype(F)


def box_test(org, direction, tmin, tmax, lo, hi):
    t_lo = (lo - org) / direction
    t_hi = (hi - org) / direction
    t0 = max(tmin, np.minimum(t_lo, t_hi).max())
    t1 = min(tmax, np.maximum(t_lo, t_hi).min())
    return t0 < t1, F(t0), F(t1)


def generate_ray(rng, x, y, cam):
    org, dir00, du, dv = cam
    u = F(x + 0.5 + rng())
    v = F(y + 0.5 + rng())
    d = (dir00 + u * du + v * dv).astype(F)
    d = d / np.sqrt(np.sum(d * d, dtype=F))
    d = np.where(np.abs(d) < 1e-5, F(1e-5), d).astype(F)
    return org.astype(F), d


def woodcock(ds, lut, value_range, opacity_scale, rng, org, direction,
             tmin, tmax, majorant, unit_distance, sample_fn=None):
    """ref: deviceCode.cu:149-186. Returns (t, albedo, extinction)."""
    sample_fn = sample_fn or (lambda pos: sample_volume_brute(ds, pos))
    t = F(tmin)
    albedo = np.zeros(3, F)
    extinction = F(0)
    while True:
        if majorant <= 0.0:
            break
        t = F(t - np.log(F(1) - rng(), dtype=F) / F(majorant / unit_distance))
        if t > tmax:
            break
        pos = (org + direction * t).astype(F)
        hit, value = sample_fn(pos)
        if not hit:
            continue
        rgba = post_classify(lut, value_range, opacity_scale, value)
        u = rng()
        if rgba[3] >= u * majorant:
            albedo = rgba[:3].copy()
            extinction = rgba[3]
            break
    return F(min(t, tmax)), albedo, extinction


def linear_to_srgb(x):
    if x <= 0.0031308:
        return F(12.92 * x)
    return F(1.055 * np.power(x, F(1.0 / 2.4), dtype=F) - 0.055)


def make_8bit(f):
    return min(255, max(0, int(f * 256)))


def make_rgba(c):
    return (make_8bit(c[0]) | (make_8bit(c[1]) << 8)
            | (make_8bit(c[2]) << 16) | (make_8bit(c[3]) << 24))


def render_ae(ds, lut, value_range, opacity_scale, cam, width, height,
              bounds_lo, bounds_hi, unit_distance=1.0, ambient_color=(1, 1, 1),
              ambient_radiance=1.0, num_samples=1, sample_fn=None):
    """Full oracle render of raygen woodcockTrackingAE
    (ref: deviceCode.cu:239-275).  Returns (accum (H*W,4) f32, fb (H*W,) u32)."""
    accum = np.zeros((width * height, 4), F)
    fb = np.zeros(width * height, np.uint32)
    ambient = (np.asarray(ambient_color, F) * F(ambient_radiance)).astype(F)
    for accum_id in range(num_samples):
        for y in range(height):
            for x in range(width):
                pixel = x + y * width
                rng = Rng((accum_id * width * height + x) & 0xFFFFFFFF, y)
                org, d = generate_ray(rng, x, y, cam)
                hit, t0, t1 = box_test(org, d, F(0), F(1e10), bounds_lo, bounds_hi)
                if not hit:
                    continue
                _, albedo, extinction = woodcock(
                    ds, lut, value_range, opacity_scale, rng, org, d,
                    t0, t1, F(1.0), F(unit_distance), sample_fn)
                color = (albedo * ambient).astype(F)
                alpha = F(1.0) if extinction > 0 else F(0.0)
                s = F(1.0 / (accum_id + 1))
                new = np.concatenate([color, [alpha]]).astype(F)
                accum[pixel] = (s * new + (F(1) - s) * accum[pixel]).astype(F)
                out = accum[pixel].copy()
                out[0] = linear_to_srgb(out[0])
                out[1] = linear_to_srgb(out[1])
                out[2] = linear_to_srgb(out[2])
                fb[pixel] = make_rgba(out)
    return accum, fb


# ===========================================================================
# Acceleration structures (ref: hostCode.cu kernels + DDA.h + ShellAccel.h)
# ===========================================================================

def project_on_grid(v, dims, lo, hi):
    """ref: DDA.h:24-31 (clamped)."""
    v01 = (v - lo) / (hi - lo)
    vs = (v01 * dims.astype(F)).astype(F)
    return np.clip(vs.astype(np.int64), 0, dims - 1)


def linear_index(idx, dims):
    """ref: DDA.h:16-21 (z-major)."""
    return (idx[..., 2] * dims[0] * dims[1] + idx[..., 1] * dims[0] + idx[..., 0])


def project_to_spherical_grid(sph, dims, slo, shi):
    """ref: ShellAccel.h:57-68 — unclamped, scaled by (dims-1)."""
    out = np.empty(3, np.int64)
    for k in range(3):
        out[k] = int(F((sph[k] - slo[k]) / (shi[k] - slo[k]) * (dims[k] - 1)))
    return out


def get_value(ds, i, hpos):
    return F(ds.value[i, find_height(ds.height[i], int(ds.num_layers[i]), hpos)])


def build_grid_icon(ds, dims, world_lo, world_hi):
    """Cartesian majorant grid (ref: hostCode.cu:245-297): per cell+layer,
    rasterize the layer AABB's (quirky, unsorted) value range."""
    dims = np.asarray(dims, np.int64)
    n = int(np.prod(dims))
    vr_lo = np.full(n, np.finfo(np.float32).max, F)
    vr_hi = np.full(n, -np.finfo(np.float32).max, F)
    for i in range(ds.num_cells):
        nl = int(ds.num_layers[i])
        for L in range(nl):
            pts = []
            for k in range(3):
                pts.append(to_cartesian(np.array([ds.height[i, L], ds.lat[i, k], ds.lon[i, k]], F)))
            tv = [to_cartesian(np.array([ds.height[i, L + 1], ds.lat[i, k], ds.lon[i, k]], F))
                  for k in range(3)]
            bary = (tv[0] + tv[1] + tv[2]) / F(3)
            R = F(ds.height[i, L + 1])
            off = F((R - np.sqrt(np.sum(bary * bary, dtype=F))) / R)
            tv = [t + t * off for t in tv]
            pts.extend(tv)
            pts = np.stack(pts).astype(F)
            blo, bhi = pts.min(0), pts.max(0)
            r_lo = get_value(ds, i, ds.height[i, L])       # value[L-1 or 0]
            r_hi = get_value(ds, i, ds.height[i, L + 1])   # value[L]
            lo_mc = project_on_grid(blo, dims, world_lo, world_hi)
            up_mc = project_on_grid(bhi, dims, world_lo, world_hi)
            for z in range(lo_mc[2], up_mc[2] + 1):
                for y in range(lo_mc[1], up_mc[1] + 1):
                    for x in range(lo_mc[0], up_mc[0] + 1):
                        lid = int(z * dims[0] * dims[1] + y * dims[0] + x)
                        vr_lo[lid] = min(vr_lo[lid], r_lo)
                        vr_hi[lid] = max(vr_hi[lid], r_hi)
    return vr_lo, vr_hi


def build_shell_icon(ds, dims, slo, shi):
    """Spherical-shell majorant grid (ref: hostCode.cu:299-336).
    loMC from BOTTOM corners only, upMC from TOP corners only (faithful)."""
    dims = np.asarray(dims, np.int64)
    n = int(np.prod(dims))
    vr_lo = np.full(n, np.finfo(np.float32).max, F)
    vr_hi = np.full(n, -np.finfo(np.float32).max, F)
    for i in range(ds.num_cells):
        nl = int(ds.num_layers[i])
        for L in range(nl):
            cb = [project_to_spherical_grid(
                np.array([ds.height[i, L], ds.lat[i, k], ds.lon[i, k]], F), dims, slo, shi)
                for k in range(3)]
            ct = [project_to_spherical_grid(
                np.array([ds.height[i, L + 1], ds.lat[i, k], ds.lon[i, k]], F), dims, slo, shi)
                for k in range(3)]
            lo_mc = np.minimum(np.minimum(cb[0], cb[1]), cb[2])
            up_mc = np.maximum(np.maximum(ct[0], ct[1]), ct[2])
            r_lo = get_value(ds, i, ds.height[i, L])
            r_hi = get_value(ds, i, ds.height[i, L + 1])
            for z in range(lo_mc[2], up_mc[2] + 1):
                for y in range(lo_mc[1], up_mc[1] + 1):
                    for x in range(lo_mc[0], up_mc[0] + 1):
                        lid = int(z * dims[0] * dims[1] + y * dims[0] + x)
                        vr_lo[lid] = min(vr_lo[lid], r_lo)
                        vr_hi[lid] = max(vr_hi[lid], r_hi)
    return vr_lo, vr_hi


def compute_max_opacities(vr_lo, vr_hi, lut, tf_value_range):
    """ref: hostCode.cu:362-434."""
    size = lut.shape[0]
    out = np.zeros(vr_lo.shape[0], F)
    for m in range(vr_lo.shape[0]):
        if vr_hi[m] < vr_lo[m]:
            out[m] = 0.0
            continue
        lo = F((vr_lo[m] - tf_value_range[0]) / (tf_value_range[1] - tf_value_range[0]))
        hi = F((vr_hi[m] - tf_value_range[0]) / (tf_value_range[1] - tf_value_range[0]))
        ilo = min(max(int(lo * (size - 1)), 0), size - 1)
        ihi = min(max(int(hi * (size - 1)) + 1, 0), size - 1)
        mo = F(0)
        for i in range(ilo, ihi + 1):
            mo = max(mo, lut[i, 3])
        out[m] = mo
    return out


# ===========================================================================
# Traversals (ref: DDA.h:37-136 dda3; ShellAccel.h:82-229 sdda)
# ===========================================================================

def dda3(org, direction, tmin, tmax, dims, blo, bhi, func):
    dims = np.asarray(dims, np.int64)
    ray_tmin = F(tmin)
    org = (org + tmin * direction).astype(F)
    tmax = F(tmax - ray_tmin)
    rcp = (F(1) / direction).astype(F)
    lo = ((blo - org) * rcp).astype(F)
    hi = ((bhi - org) * rcp).astype(F)
    tnear = np.minimum(lo, hi)
    tfar = np.maximum(lo, hi)
    cell = project_on_grid(org, dims, blo, bhi)
    dist = np.maximum(F(0), (tfar - tnear) / dims.astype(F)).astype(F)
    step = np.where(direction > 0, 1, -1).astype(np.int64)
    stop = np.where(direction > 0, dims, -1).astype(np.int64)
    tnext = np.where(direction > 0,
                     tnear + (cell + 1).astype(F) * dist,
                     tnear + (dims - cell).astype(F) * dist).astype(F)
    t0 = F(0)
    while True:
        t1 = F(min(tnext.min(), tmax))
        if not func(int(linear_index(cell, dims)), F(ray_tmin + t0), F(ray_tmin + t1)):
            return
        t_closest = tnext.min()
        brk = False
        for k in range(3):
            if tnext[k] == t_closest:
                tnext[k] = F(tnext[k] + dist[k])
                cell[k] += step[k]
                if cell[k] == stop[k]:
                    brk = True
                    break
        if brk:
            break
        t0 = t1


def intersect_sphere(org, direction, radius):
    """ref: ShellAccel.h:34-53."""
    A = F(np.sum(direction * direction, dtype=F))
    B = F(np.sum(direction * org, dtype=F) * 2)
    C = F(np.sum(org * org, dtype=F) - radius * radius)
    d = F(B * B - 4 * A * C)
    if d < 0:
        return False, F(0), F(0)
    d = F(np.sqrt(d))
    q = F(-0.5 * (B - d)) if B < 0 else F(-0.5 * (B + d))
    t1, t2 = F(q / A), F(C / q)
    return True, F(min(t1, t2)), F(max(t1, t2))


def sdda(org, direction, tmin, tmax, dims, slo, shi, func):
    """Faithful port of the reference spherical-shell DDA, including its
    degenerate lat/lon boundary planes (built via toCartesian with r=0,
    ref: ShellAccel.h:150-155 — all-zero planes whose evalPlane is 0)."""
    dims = np.asarray(dims, np.int64)
    s1, t1, t4 = intersect_sphere(org, direction, shi[0])
    s2, t2, t3 = intersect_sphere(org, direction, slo[0])
    if not s1 and not s2:
        return
    if t4 < tmin:
        return
    INF = np.float32(np.inf)
    ranges = [[INF, -INF], [INF, -INF]]
    if s1 and not s2:
        ranges[0] = [t1, t4]
    elif tmin < t2:
        ranges[0] = [t1, t2]
        ranges[1] = [t3, t4]
    else:
        ranges[0] = [t3, t4]

    eps = F(slo[0] * 1e-6)
    for i in range(2):
        if ranges[i][1] <= ranges[i][0]:
            break
        P1 = (org + direction * F(ranges[i][0] + eps)).astype(F)
        P2 = (org + direction * F(ranges[i][1] - eps)).astype(F)
        SP1 = to_spherical(P1)
        SP2 = to_spherical(P2)
        cell = project_to_spherical_grid(SP1, dims, slo, shi)
        step = np.where(SP1 < SP2, 1, -1).astype(np.int64)
        stop = project_to_spherical_grid(SP2, dims, slo, shi) + step
        # lat/lon "planes" are degenerate (r=0 -> zero vectors), eval == 0
        tnext = np.array([ranges[i][1], 0.0, 0.0], F)
        t = F(ranges[i][0])
        terminate = False
        while True:
            t1v = np.float32(np.finfo(np.float32).max)
            for k in range(3):
                if tnext[k] < t1v and tnext[k] >= t:
                    t1v = tnext[k]
            wrapped = np.mod(cell, dims)
            leaf = int(linear_index(wrapped, dims))
            if not func(leaf, F(t), F(t1v)):
                return
            t_closest = tnext.min()
            brk = False
            if tnext[0] == t_closest:
                cell[0] += step[0]
                if cell[0] == stop[0]:
                    brk = True
            if not brk and tnext[1] == t_closest:
                cell[1] += step[1]
                if cell[1] == stop[1]:
                    brk = True
                else:
                    tnext[1] = F(0)  # evalPlane of the degenerate plane
            if not brk and tnext[2] == t_closest:
                cell[2] += step[2]
                if cell[2] == stop[2]:
                    brk = True
                else:
                    tnext[2] = F(0)
            if brk:
                break
            t = t_closest


def render_accel(ds, lut, value_range, opacity_scale, cam, width, height,
                 bounds_lo, bounds_hi, accel, unit_distance=1.0,
                 ambient_color=(1, 1, 1), ambient_radiance=1.0, num_samples=1,
                 sample_fn=None):
    """Oracle for raygen woodcockTrackingWithAccel (ref: deviceCode.cu:281-341).

    accel: dict with keys mode ('sphere'|'grid'), dims, max_opacities, and
    either (slo, shi) for sphere or (blo, bhi) for grid.
    """
    accum = np.zeros((width * height, 4), F)
    fb = np.zeros(width * height, np.uint32)
    ambient = (np.asarray(ambient_color, F) * F(ambient_radiance)).astype(F)
    for accum_id in range(num_samples):
        for y in range(height):
            for x in range(width):
                pixel = x + y * width
                rng = Rng((accum_id * width * height + x) & 0xFFFFFFFF, y)
                org, d = generate_ray(rng, x, y, cam)
                hit, t0, t1 = box_test(org, d, F(0), F(1e10), bounds_lo, bounds_hi)
                if not hit:
                    continue
                state = {"color": np.zeros(3, F), "alpha": F(0)}

                def wfunc(leaf, s0, s1):
                    majorant = F(accel["max_opacities"][leaf])
                    t, albedo, ext = woodcock(
                        ds, lut, value_range, opacity_scale, rng, org, d,
                        s0, s1, majorant, F(unit_distance), sample_fn)
                    if t > s0 and t < s1:
                        state["color"] = (albedo * ambient).astype(F)
                        state["alpha"] = F(1.0) if ext > 0 else F(0.0)
                        return False
                    return True

                if accel["mode"] == "sphere":
                    sdda(org, d, t0, t1, accel["dims"], accel["slo"], accel["shi"], wfunc)
                else:
                    dda3(org, d, t0, t1, accel["dims"], accel["blo"], accel["bhi"], wfunc)

                s = F(1.0 / (accum_id + 1))
                new = np.concatenate([state["color"], [state["alpha"]]]).astype(F)
                accum[pixel] = (s * new + (F(1) - s) * accum[pixel]).astype(F)
                out = accum[pixel].copy()
                out[0] = linear_to_srgb(out[0])
                out[1] = linear_to_srgb(out[1])
                out[2] = linear_to_srgb(out[2])
                fb[pixel] = make_rgba(out)
    return accum, fb


# ===========================================================================
# UElems Newton intersectors (ref: icon_rt/UElems.h)
# ===========================================================================

def _newton_ref(P, V, S, shape_fn, deriv_fn, extra):
    bbox = V.max(axis=0) - V.min(axis=0)
    tol = F(np.sum(bbox * bbox, dtype=F) * 1e-6)
    pc = np.array([0.5, 0.5, 0.5], F)
    w = None
    converged = False
    for _ in range(10):
        if converged:
            break
        w = shape_fn(pc)
        dr, ds_, dt = deriv_fn(pc)
        fcol = (V * w[:, None]).sum(0).astype(F) - P
        rcol = (V * dr[:, None]).sum(0).astype(F)
        scol = (V * ds_[:, None]).sum(0).astype(F)
        tcol = (V * dt[:, None]).sum(0).astype(F)
        d = F(np.dot(rcol, np.cross(scol, tcol)))
        if abs(d) < tol:
            return False, F(0)
        d0 = F(np.dot(fcol, np.cross(scol, tcol)) / d)
        d1 = F(np.dot(rcol, np.cross(fcol, tcol)) / d)
        d2 = F(np.dot(rcol, np.cross(scol, fcol)) / d)
        pc = (pc - np.array([d0, d1, d2], F)).astype(F)
        if abs(d0) < 1e-4 and abs(d1) < 1e-4 and abs(d2) < 1e-4:
            converged = True
        elif abs(pc[0]) > 1e6 or abs(pc[1]) > 1e6 or abs(pc[2]) > 1e6:
            return False, F(0)
    if not converged:
        return False, F(0)
    lo, hi = -1e-6, 1.0 + 1e-6
    if np.all(pc >= lo) and np.all(pc <= hi) and extra(pc, hi):
        return True, F(np.sum(w * S, dtype=F))
    return False, F(0)


def _wedge_shape_ref(pc):
    r, s, t = pc
    return np.array([(1 - r - s) * (1 - t), r * (1 - t), s * (1 - t),
                     (1 - r - s) * t, r * t, s * t], F)


def _wedge_derivs_ref(pc):
    r, s, t = pc
    dr = np.array([-1 + t, 1 - t, 0, -t, t, 0], F)
    ds_ = np.array([-1 + t, 0, 1 - t, -t, 0, t], F)
    dt = np.array([-1 + r + s, -r, -s, 1 - r - s, r, s], F)
    return dr, ds_, dt


def intersect_wedge_ref(P, V, S):
    return _newton_ref(P, V, S, _wedge_shape_ref, _wedge_derivs_ref,
                       lambda pc, hi: pc[0] + pc[1] <= hi)
