"""Full-frame progressive render step.

This is the JAX replacement for the reference's raygen megakernels
(ref: icon_rt/deviceCode.cu:239-341): one jitted, donated-buffer function
per (width, height, mode) computing one accumulation sample for every pixel.

The OWL name->pointer launch-params registry of the reference
(ref: common/pipeline.cu:357-411) becomes an ordinary pytree argument
(`LaunchParams`); the accumulation buffers are donated so progressive
refinement updates in place on device.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.accel import GridAccel, ShellAccel
from ..models.cells import Cells, sample_brute_force
from ..models.locator import Locator, sample_locator
from ..models.transfunc import Transfunc, post_classify
from ..utils import color as colorlib
from ..utils.lcg import lcg_init, lcg_next
from ..utils.vecmath import box_test
from .traverse import trace_dda3, trace_sdda
from .woodcock import woodcock_track


def make_sample_fn(cells: Cells, locator: Locator | None, sampler: str,
                   wedges=None):
    """Volume point-sampler dispatch (ref: deviceCode.cu:58-125).

    'brute'   — linear scan (reference's no-RT fallback)
    'locator' — grid-of-lists query (replaces OptiX/cuBQL BVH queries);
                the reference's user-geom and triangle modes both resolve
                to this analytic column sampling
    'wedge'   — UElems Newton prism inversion (the cuBQL mode)
    """
    if sampler == "brute":
        return lambda pos: sample_brute_force(cells, pos)
    if sampler == "locator":
        if locator is None:
            raise ValueError("sampler='locator' needs a Locator")
        return lambda pos: sample_locator(cells, locator, pos)
    if sampler == "wedge":
        if locator is None or wedges is None:
            raise ValueError("sampler='wedge' needs a Locator and Wedges")
        from ..models.wedges import sample_wedges
        return lambda pos: sample_wedges(cells, wedges, locator, pos)
    raise ValueError(f"unknown sampler {sampler!r}")


class LaunchParams(NamedTuple):
    """Per-frame traced parameters (ref: icon_rt/Params.h:92-119)."""
    cam_org: jnp.ndarray        # (3,) f32
    cam_dir00: jnp.ndarray      # (3,) f32
    cam_du: jnp.ndarray         # (3,) f32
    cam_dv: jnp.ndarray         # (3,) f32
    bounds_lo: jnp.ndarray      # (3,) f32 volume world bounds
    bounds_hi: jnp.ndarray      # (3,) f32
    ambient_color: jnp.ndarray  # (3,) f32
    ambient_radiance: jnp.ndarray  # () f32
    unit_distance: jnp.ndarray  # () f32
    accum_id: jnp.ndarray       # () i32


def make_launch_params(camera_basis, bounds_lo, bounds_hi,
                       ambient_color=(1.0, 1.0, 1.0), ambient_radiance=1.0,
                       unit_distance=1.0, accum_id=0) -> LaunchParams:
    org, dir00, du, dv = camera_basis
    f32 = functools.partial(jnp.asarray, dtype=jnp.float32)
    return LaunchParams(
        cam_org=f32(org), cam_dir00=f32(dir00), cam_du=f32(du), cam_dv=f32(dv),
        bounds_lo=f32(bounds_lo), bounds_hi=f32(bounds_hi),
        ambient_color=f32(ambient_color),
        ambient_radiance=f32(ambient_radiance),
        unit_distance=f32(unit_distance),
        accum_id=jnp.asarray(accum_id, jnp.int32),
    )


def generate_ray(lp: LaunchParams, x, y, rng):
    """Jittered pinhole ray (ref: icon_rt/deviceCode.cu:36-49).

    Reference quirk kept: the raygen passes pixel+0.5 and adds another
    rnd() in [0,1), so the jitter window is [0.5, 1.5) of the pixel.
    Direction components are clamped away from zero to +1e-5.
    """
    rng, jx = lcg_next(rng)
    rng, jy = lcg_next(rng)
    u = x.astype(jnp.float32) + 0.5 + jx
    v = y.astype(jnp.float32) + 0.5 + jy
    d = lp.cam_dir00 + u * lp.cam_du + v * lp.cam_dv
    d = d / jnp.sqrt(jnp.sum(d * d))
    d = jnp.where(jnp.abs(d) < 1e-5, jnp.float32(1e-5), d)
    return lp.cam_org, d, rng


def _pixel_ae(sample_fn, cells: Cells, tf: Transfunc, lp: LaunchParams,
              x, y, w, h):
    """One pixel of woodcockTrackingAE (ref: deviceCode.cu:239-275).

    Returns (wrote: bool, color_alpha: (4,) f32) — `wrote` is False when the
    ray misses the volume bounds (the reference returns without writing).
    """
    seed0 = (lp.accum_id.astype(jnp.uint32) * jnp.uint32(w * h)
             + x.astype(jnp.uint32))
    rng = lcg_init(seed0, y.astype(jnp.uint32))
    org, direction, rng = generate_ray(lp, x, y, rng)
    hit_box, t0, t1 = box_test(org, direction, jnp.float32(0.0),
                               jnp.float32(1e10), lp.bounds_lo, lp.bounds_hi)

    res = woodcock_track(
        sample_fn,
        lambda value: post_classify(tf, value),
        org, direction, t0, t1, jnp.float32(1.0), rng, lp.unit_distance,
        active=hit_box)

    rgb = res.albedo * lp.ambient_color * lp.ambient_radiance
    alpha = jnp.where(res.extinction > 0.0, 1.0, 0.0).astype(jnp.float32)
    return hit_box, jnp.concatenate([rgb, alpha[None]])


def _finalize(wrote, color_alpha, accum, fb, accum_id):
    """Running-average accumulation + sRGB + RGBA8 pack
    (ref: deviceCode.cu:267-274).  Pixels whose rays missed keep their
    previous accum/fb content."""
    s = 1.0 / (accum_id.astype(jnp.float32) + 1.0)
    new_accum = s * color_alpha + (1.0 - s) * accum  # ref lerp(a,b,x)=x*a+(1-x)*b
    accum_out = jnp.where(wrote[..., None], new_accum, accum)
    srgb = colorlib.linear_to_srgb(accum_out[..., :3])
    packed = colorlib.make_rgba(jnp.concatenate([srgb, accum_out[..., 3:]], axis=-1))
    fb_out = jnp.where(wrote, packed, fb)
    return accum_out, fb_out


#: default rays-in-flight per wavefront chunk; bounds the live-state and
#: gather-intermediate memory of the vmapped tracking loops, and limits
#: loop-length divergence (each chunk's while_loop runs only as long as its
#: own slowest ray, instead of the whole frame's)
DEFAULT_CHUNK = 64 * 1024


def _map_chunks(pixel_fn, xs, ys, chunk: int):
    """vmap(pixel_fn) over pixels, sequentially lax.map'ed in chunks."""
    total = xs.shape[0]
    if total <= chunk:
        return jax.vmap(pixel_fn)(xs, ys)
    n = -(-total // chunk)
    pad = n * chunk - total
    if pad:
        xs = jnp.concatenate([xs, jnp.zeros(pad, xs.dtype)])
        ys = jnp.concatenate([ys, jnp.zeros(pad, ys.dtype)])
    wrote, ca = jax.lax.map(
        lambda c: jax.vmap(pixel_fn)(c[0], c[1]),
        (xs.reshape(n, chunk), ys.reshape(n, chunk)))
    return wrote.reshape(-1)[:total], ca.reshape(-1, 4)[:total]


def frame_pixels_ae(cells: Cells, tf: Transfunc, lp: LaunchParams,
                    xs, ys, width: int, height: int,
                    sampler: str = "brute", locator: Locator | None = None,
                    chunk: int = DEFAULT_CHUNK, wedges=None):
    """Vectorized AE raygen over arbitrary pixel index arrays.
    Returns (wrote (P,), color_alpha (P, 4))."""
    sample_fn = make_sample_fn(cells, locator, sampler, wedges)
    return _map_chunks(
        lambda x, y: _pixel_ae(sample_fn, cells, tf, lp, x, y, width, height),
        xs, ys, chunk)


@functools.partial(jax.jit, static_argnames=("width", "height", "sampler"),
                   donate_argnames=("accum", "fb"))
def render_frame_ae(cells: Cells, tf: Transfunc, lp: LaunchParams,
                    accum, fb, *, width: int, height: int,
                    sampler: str = "brute", locator: Locator | None = None,
                    wedges=None):
    """One progressive sample over the whole frame, global majorant = 1
    (reference raygen 'woodcockTrackingAE').

    accum: (H*W, 4) f32; fb: (H*W,) uint32; row 0 = bottom of image.
    Returns updated (accum, fb).
    """
    ys, xs = jnp.divmod(jnp.arange(width * height, dtype=jnp.int32), width)
    wrote, color_alpha = frame_pixels_ae(cells, tf, lp, xs, ys, width, height,
                                         sampler, locator, wedges=wedges)
    return _finalize(wrote, color_alpha, accum, fb, lp.accum_id)


def _pixel_accel(sample_fn, cells: Cells, tf: Transfunc, accel,
                 lp: LaunchParams, x, y, w, h, accel_mode: str):
    """One pixel of woodcockTrackingWithAccel (ref: deviceCode.cu:281-341)."""
    seed0 = (lp.accum_id.astype(jnp.uint32) * jnp.uint32(w * h)
             + x.astype(jnp.uint32))
    rng = lcg_init(seed0, y.astype(jnp.uint32))
    org, direction, rng = generate_ray(lp, x, y, rng)
    hit_box, t0, t1 = box_test(org, direction, jnp.float32(0.0),
                               jnp.float32(1e10), lp.bounds_lo, lp.bounds_hi)

    classify_fn = lambda value: post_classify(tf, value)

    if accel_mode == "sphere":
        res = trace_sdda(sample_fn, classify_fn, accel.max_opacities,
                         accel.dims, accel.sph_lo, accel.sph_hi,
                         org, direction, t0, t1, rng, lp.unit_distance,
                         active=hit_box)
    elif accel_mode == "grid":
        res = trace_dda3(sample_fn, classify_fn, accel.max_opacities,
                         accel.dims, accel.world_lo, accel.world_hi,
                         org, direction, t0, t1, rng, lp.unit_distance,
                         active=hit_box)
    else:
        raise ValueError(f"unknown accel_mode {accel_mode!r}")

    rgb = res.color * lp.ambient_color * lp.ambient_radiance
    return hit_box, jnp.concatenate([rgb, res.alpha[None]])


def frame_pixels_accel(cells: Cells, tf: Transfunc, accel, lp: LaunchParams,
                       xs, ys, width: int, height: int,
                       accel_mode: str = "sphere", sampler: str = "brute",
                       locator: Locator | None = None,
                       chunk: int = DEFAULT_CHUNK, wedges=None):
    """Vectorized accel raygen over arbitrary pixel index arrays.
    Returns (wrote (P,), color_alpha (P, 4))."""
    sample_fn = make_sample_fn(cells, locator, sampler, wedges)
    return _map_chunks(
        lambda x, y: _pixel_accel(sample_fn, cells, tf, accel, lp, x, y,
                                  width, height, accel_mode),
        xs, ys, chunk)


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "accel_mode", "sampler"),
                   donate_argnames=("accum", "fb"))
def render_frame_accel(cells: Cells, tf: Transfunc, accel, lp: LaunchParams,
                       accum, fb, *, width: int, height: int,
                       accel_mode: str = "sphere", sampler: str = "brute",
                       locator: Locator | None = None, wedges=None):
    """One progressive sample with per-cell majorants driven by a traversal
    (reference raygen 'woodcockTrackingWithAccel').

    accel: ShellAccel (accel_mode='sphere') or GridAccel (accel_mode='grid')
    with max_opacities up to date for the current transfer function.
    """
    ys, xs = jnp.divmod(jnp.arange(width * height, dtype=jnp.int32), width)
    wrote, color_alpha = frame_pixels_accel(cells, tf, accel, lp, xs, ys,
                                            width, height, accel_mode,
                                            sampler, locator, wedges=wedges)
    return _finalize(wrote, color_alpha, accum, fb, lp.accum_id)


def alloc_frame(width: int, height: int):
    """Cleared accumulation + framebuffer (ref: common/pipeline.cu:171-199)."""
    return (jnp.zeros((width * height, 4), jnp.float32),
            jnp.zeros((width * height,), jnp.uint32))


def fb_to_image(fb, width: int, height: int, bgcolor=None) -> np.ndarray:
    """Packed uint32 framebuffer -> (H, W, 4) uint8, bottom-up row order.

    bgcolor: optional (3,) linear RGB in [0,1].  The reference presents the
    framebuffer over a window cleared to --bgcolor
    (ref: common/pipeline.cu:721,760); pass it here to alpha-composite the
    rendered image over that clear color (our fb alpha is the reference's
    binary hit alpha, so this fills exactly the never-hit pixels)."""
    img = colorlib.unpack_rgba(np.asarray(fb).reshape(height, width))
    if bgcolor is not None:
        b = np.asarray(bgcolor, np.float32)
        bg_srgb = np.where(b <= 0.0031308, 12.92 * b,
                           1.055 * np.power(b, 1.0 / 2.4) - 0.055)
        bg = np.clip(bg_srgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
        a = img[..., 3:4].astype(np.float32) / 255.0
        rgb = img[..., :3].astype(np.float32) * a + bg * (1.0 - a)
        img = np.concatenate([(rgb + 0.5).astype(np.uint8),
                              np.full_like(img[..., 3:4], 255)], axis=-1)
    return img
