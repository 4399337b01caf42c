"""Vector math for the renderer, as functions over trailing-axis-(3,) arrays.

Where the reference carries a 1.9k-line C++ header of vector classes
(ref: common/vecmath.h), this design needs only a thin layer of
jnp helpers: rays, boxes and planes are plain arrays (structs-of-arrays),
and everything batches over leading axes so the same code serves one ray
or a million.

Spherical conventions follow the reference (ref: icon_rt/ICONGrid.h:36-54):
spherical = (r, lat, lon) with lat = asin(z/r), lon = atan2(y, x).
All math is float32.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def length(v):
    return jnp.sqrt(dot(v, v))


def normalize(v):
    return v / length(v)[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def deg2rad(d):
    return d * (np.pi / 180.0)


def rad2deg(r):
    return r * (180.0 / np.pi)


def to_spherical(p):
    """Cartesian (..., 3) -> spherical (..., 3) = (r, lat, lon)."""
    r = length(p)
    lat = jnp.arcsin(p[..., 2] / r)
    lon = jnp.arctan2(p[..., 1], p[..., 0])
    return jnp.stack([r, lat, lon], axis=-1)


def to_cartesian(s):
    """Spherical (..., 3) = (r, lat, lon) -> Cartesian (..., 3)."""
    r, lat, lon = s[..., 0], s[..., 1], s[..., 2]
    cl = jnp.cos(lat)
    return jnp.stack([r * cl * jnp.cos(lon), r * cl * jnp.sin(lon), r * jnp.sin(lat)], axis=-1)


def sph(r, lat, lon):
    """Build an (..., 3) spherical coordinate from components."""
    return jnp.stack(jnp.broadcast_arrays(jnp.asarray(r, F32),
                                          jnp.asarray(lat, F32),
                                          jnp.asarray(lon, F32)), axis=-1)


# ---------------------------------------------------------------------------
# Planes.  A plane is an (..., 4) array (nx, ny, nz, w) with the convention
# eval(p, pos) = dot(pos, n) - w (ref: icon_rt/ICONGrid.h:168-179).
# ---------------------------------------------------------------------------

def make_plane(a, b, c):
    n = cross(b - a, c - a)
    return jnp.concatenate([n, dot(a, n)[..., None]], axis=-1)


def eval_plane(plane, pos):
    return dot(pos, plane[..., :3]) - plane[..., 3]


# ---------------------------------------------------------------------------
# Ray/box slab test (ref: common/vecmath.h:1926-1937).  No zero-direction
# guard, exactly like the reference — ray directions are clamped away from
# zero at generation time.
# ---------------------------------------------------------------------------

def box_test(org, direction, tmin, tmax, box_lo, box_hi):
    """Returns (hit, t0, t1); all batched over leading axes."""
    t_lo = (box_lo - org) / direction
    t_hi = (box_hi - org) / direction
    t_nr = jnp.minimum(t_lo, t_hi)
    t_fr = jnp.maximum(t_lo, t_hi)
    t0 = jnp.maximum(tmin, jnp.max(t_nr, axis=-1))
    t1 = jnp.minimum(tmax, jnp.min(t_fr, axis=-1))
    return t0 < t1, t0, t1


def lerp(a, b, x):
    """Reference-convention lerp: x*a + (1-x)*b (ref: common/vecmath.h:56-58).

    Note the argument order quirk: x == 1 returns a.
    """
    return x * a + (1.0 - x) * b


# ---------------------------------------------------------------------------
# Small square matrices (ref: common/vecmath.h:705-894).  A matrix is an
# (..., N, N) array indexed [row, col]; the reference's column-major
# storage is an implementation detail its operator() hides, so the math
# below matches entry-for-entry.  vectorN/matrixN (ref: :1328-1356,
# 1475-1600) are dynamic containers with slice/block views — numpy/jnp
# arrays ARE that type here; no port needed.
# ---------------------------------------------------------------------------

def mat_identity(n: int = 4):
    return jnp.eye(n, dtype=F32)


def mat_mul(a, b):
    """Matrix product, batched over leading axes (ref: vecmath.h:820-846).
    HIGHEST precision keeps f32 on GPUs, whose default matmul is TF32."""
    return jnp.einsum("...ij,...jk->...ik", a, b,
                      precision=jax.lax.Precision.HIGHEST)


def mat_vec(a, v):
    """Matrix-vector product (ref: vecmath.h:726-732, 849-855)."""
    return jnp.einsum("...ij,...j->...i", a, v,
                      precision=jax.lax.Precision.HIGHEST)


def mat3_determinant(m):
    """Cofactor-expansion determinant (ref: vecmath.h:735-752)."""
    a00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 2, 1] * m[..., 1, 2]
    a01 = m[..., 1, 0] * m[..., 2, 2] - m[..., 2, 0] * m[..., 1, 2]
    a02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 2, 0] * m[..., 1, 1]
    return m[..., 0, 0] * a00 - m[..., 0, 1] * a01 + m[..., 0, 2] * a02


def mat3_inverse(m):
    """Adjugate inverse (ref: vecmath.h:755-777); no singularity guard,
    exactly like the reference."""
    def det2(r0, c0, r1, c1):
        return (m[..., r0, c0] * m[..., r1, c1]
                - m[..., r1, c0] * m[..., r0, c1])

    cof = jnp.stack([
        jnp.stack([det2(1, 1, 2, 2), -det2(1, 0, 2, 2), det2(1, 0, 2, 1)],
                  axis=-1),
        jnp.stack([-det2(0, 1, 2, 2), det2(0, 0, 2, 2), -det2(0, 0, 2, 1)],
                  axis=-1),
        jnp.stack([det2(0, 1, 1, 2), -det2(0, 0, 1, 2), det2(0, 0, 1, 1)],
                  axis=-1),
    ], axis=-2)
    det = (m[..., 0, 0] * cof[..., 0, 0] + m[..., 0, 1] * cof[..., 0, 1]
           + m[..., 0, 2] * cof[..., 0, 2])
    # adjugate = cofactor transpose (the reference's column-wise mat3f
    # constructor performs this transpose implicitly, vecmath.h:770-776)
    return jnp.swapaxes(cof, -1, -2) / det[..., None, None]


def make_frustum(left, right, bottom, top, znear, zfar):
    """Perspective frustum matrix (ref: vecmath.h:858-880)."""
    z = jnp.zeros_like(jnp.asarray(left, F32))
    l, r = jnp.asarray(left, F32), jnp.asarray(right, F32)
    b, t = jnp.asarray(bottom, F32), jnp.asarray(top, F32)
    n, f = jnp.asarray(znear, F32), jnp.asarray(zfar, F32)
    return jnp.stack([
        jnp.stack([2 * n / (r - l), z, (r + l) / (r - l), z], -1),
        jnp.stack([z, 2 * n / (t - b), (t + b) / (t - b), z], -1),
        jnp.stack([z, z, -(f + n) / (f - n), -(2 * f * n) / (f - n)], -1),
        jnp.stack([z, z, z - 1.0, z], -1),
    ], axis=-2)


def make_ortho(left, right, bottom, top, znear, zfar):
    """Orthographic projection matrix (ref: vecmath.h:883-905)."""
    z = jnp.zeros_like(jnp.asarray(left, F32))
    l, r = jnp.asarray(left, F32), jnp.asarray(right, F32)
    b, t = jnp.asarray(bottom, F32), jnp.asarray(top, F32)
    n, f = jnp.asarray(znear, F32), jnp.asarray(zfar, F32)
    return jnp.stack([
        jnp.stack([2 / (r - l), z, z, -(r + l) / (r - l)], -1),
        jnp.stack([z, 2 / (t - b), z, -(t + b) / (t - b)], -1),
        jnp.stack([z, z, -2 / (f - n), -(f + n) / (f - n)], -1),
        jnp.stack([z, z, z, z + 1.0], -1),
    ], axis=-2)


# ---------------------------------------------------------------------------
# Interval arithmetic (ref: common/vecmath.h:1166-1326).  An interval is a
# (lo, hi) pair of same-shape arrays — SoA, batched, branch-free.  The 3-D
# flavor is the same functions mapped over a trailing (..., 3) axis.
# ---------------------------------------------------------------------------

def interval(lo, hi=None):
    """Build an interval; a single argument makes the degenerate [f, f]
    (ref: vecmath.h:1172-1173)."""
    lo = jnp.asarray(lo, F32)
    return (lo, lo if hi is None else jnp.asarray(hi, F32))


def interval_length(a):
    return a[1] - a[0]


def interval_contains(a, f):
    return (a[0] <= f) & (f <= a[1])


def interval_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def interval_sub(a, b):
    """Endpoint-wise difference — the reference's (non-conservative)
    convention (ref: vecmath.h:1185-1187), kept as-is."""
    return (a[0] - b[0], a[1] - b[1])


def interval_mul(a, b):
    """Conservative product: min/max over all endpoint products
    (ref: vecmath.h:1190-1200)."""
    ac, ad, bc, bd = a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]
    return (jnp.minimum(jnp.minimum(ac, ad), jnp.minimum(bc, bd)),
            jnp.maximum(jnp.maximum(ac, ad), jnp.maximum(bc, bd)))


def interval_div(a, b):
    """Conservative quotient; a divisor interval containing 0 widens to
    [-inf, inf] (ref: vecmath.h:1202-1216), branch-free via where."""
    ac, ad, bc, bd = a[0] / b[0], a[0] / b[1], a[1] / b[0], a[1] / b[1]
    lo = jnp.minimum(jnp.minimum(ac, ad), jnp.minimum(bc, bd))
    hi = jnp.maximum(jnp.maximum(ac, ad), jnp.maximum(bc, bd))
    zero_in = (b[0] <= 0.0) & (0.0 <= b[1])
    return (jnp.where(zero_in, -jnp.inf, lo),
            jnp.where(zero_in, jnp.inf, hi))


def clamp(x, a, b):
    """max(a, min(x, b)) for any dtype/shape (ref: vecmath.h:1358-1376)."""
    return jnp.maximum(a, jnp.minimum(x, b))


# ---------------------------------------------------------------------------
# NumPy twins for host-side (dataset/build-time) code paths.
# ---------------------------------------------------------------------------

def np_to_cartesian(s):
    s = np.asarray(s, np.float32)
    r, lat, lon = s[..., 0], s[..., 1], s[..., 2]
    cl = np.cos(lat, dtype=np.float32)
    out = np.stack([r * cl * np.cos(lon, dtype=np.float32),
                    r * cl * np.sin(lon, dtype=np.float32),
                    r * np.sin(lat, dtype=np.float32)], axis=-1)
    return out.astype(np.float32)


def np_to_spherical(p):
    p = np.asarray(p, np.float32)
    r = np.sqrt(np.sum(p * p, axis=-1, dtype=np.float32)).astype(np.float32)
    lat = np.arcsin(p[..., 2] / r).astype(np.float32)
    lon = np.arctan2(p[..., 1], p[..., 0]).astype(np.float32)
    return np.stack([r, lat, lon], axis=-1)
