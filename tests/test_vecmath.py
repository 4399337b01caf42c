import jax.numpy as jnp
import numpy as np

from icon_dvr.utils import color as colorlib
from icon_dvr.utils.vecmath import (box_test, eval_plane, make_plane, lerp,
                                    to_cartesian, to_spherical,
                                    np_to_cartesian, np_to_spherical, sph)


def test_spherical_roundtrip():
    rs = np.random.RandomState(0)
    p = rs.randn(128, 3).astype(np.float32) * 100.0
    s = to_spherical(jnp.asarray(p))
    p2 = to_cartesian(s)
    np.testing.assert_allclose(np.asarray(p2), p, rtol=2e-5, atol=1e-3)
    # numpy twin agrees with jax
    np.testing.assert_allclose(np_to_spherical(p), np.asarray(s), rtol=1e-6, atol=1e-6)


def test_spherical_conventions():
    # (r, lat, lon): lat = asin(z/r), lon = atan2(y, x)
    s = to_spherical(jnp.asarray([0.0, 0.0, 5.0]))
    assert np.allclose(np.asarray(s), [5.0, np.pi / 2, 0.0], atol=1e-6)
    p = to_cartesian(sph(2.0, 0.0, np.pi / 2))
    assert np.allclose(np.asarray(p), [0.0, 2.0, 0.0], atol=1e-6)


def test_plane():
    a = jnp.asarray([0.0, 0.0, 0.0])
    b = jnp.asarray([1.0, 0.0, 0.0])
    c = jnp.asarray([0.0, 1.0, 0.0])
    pl = make_plane(a, b, c)
    # normal (0,0,1); points above have positive eval
    assert float(eval_plane(pl, jnp.asarray([0.2, 0.2, 3.0]))) > 0
    assert float(eval_plane(pl, jnp.asarray([0.2, 0.2, -3.0]))) < 0
    assert abs(float(eval_plane(pl, jnp.asarray([0.5, 0.5, 0.0])))) < 1e-6


def test_box_test():
    org = jnp.asarray([0.0, 0.0, -10.0])
    d = jnp.asarray([0.0, 0.0, 1.0])
    hit, t0, t1 = box_test(org, d, 0.0, 1e10,
                           jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]))
    assert bool(hit) and np.isclose(float(t0), 9.0) and np.isclose(float(t1), 11.0)
    # miss
    org2 = jnp.asarray([5.0, 0.0, -10.0])
    hit2, _, _ = box_test(org2, d, 0.0, 1e10,
                          jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]))
    assert not bool(hit2)
    # batched
    orgs = jnp.stack([org, org2])
    ds = jnp.stack([d, d])
    hits, _, _ = box_test(orgs, ds, 0.0, 1e10,
                          jnp.asarray([-1.0, -1.0, -1.0]), jnp.asarray([1.0, 1.0, 1.0]))
    assert hits.tolist() == [True, False]


def test_lerp_reference_convention():
    # lerp(a, b, x) = x*a + (1-x)*b : x == 1 returns a
    assert float(lerp(jnp.float32(3.0), jnp.float32(7.0), jnp.float32(1.0))) == 3.0
    assert float(lerp(jnp.float32(3.0), jnp.float32(7.0), jnp.float32(0.0))) == 7.0


def test_srgb_golden():
    # golden values from the reference linear_to_srgb compiled host-side
    xs = np.array([0.0, 0.001, 0.0031308, 0.004, 0.18, 0.5, 1.0], np.float32)
    expected = np.array([0.0, 0.0129200006, 0.0404499359, 0.0507087186,
                         0.461356103, 0.735356927, 0.99999994], np.float32)
    got = np.asarray(colorlib.linear_to_srgb(jnp.asarray(xs)))
    # XLA pow vs libm powf differ by ~1e-6, far below tone-map LSB (1/256)
    np.testing.assert_allclose(got, expected, rtol=5e-6, atol=2e-6)


def test_make_rgba():
    c = jnp.asarray([[0.0, 0.5, 1.0, 1.0], [-1.0, 2.0, 0.999, 0.0]], jnp.float32)
    packed = colorlib.make_rgba(c)
    px = colorlib.unpack_rgba(np.asarray(packed))
    # int(0.5*256)=128, int(1.0*256)=256 -> clamp 255
    assert px[0].tolist() == [0, 128, 255, 255]
    assert px[1].tolist() == [0, 255, 255, 0]


def test_mat3_inverse_determinant():
    from icon_dvr.utils.vecmath import (mat3_determinant, mat3_inverse,
                                        mat_mul, mat_vec)
    rng = np.random.default_rng(7)
    m = jnp.asarray(rng.normal(size=(5, 3, 3)).astype(np.float32))
    det = np.asarray(mat3_determinant(m))
    np.testing.assert_allclose(det, np.linalg.det(np.asarray(m)),
                               rtol=2e-4, atol=1e-5)
    inv = mat3_inverse(m)
    np.testing.assert_allclose(np.asarray(mat_mul(m, inv)),
                               np.broadcast_to(np.eye(3), (5, 3, 3)),
                               atol=2e-5)
    v = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(mat_vec(m, v)),
                               np.einsum("bij,bj->bi", np.asarray(m),
                                         np.asarray(v)), rtol=1e-5, atol=1e-6)


def test_mat4_frustum_ortho():
    """Entries match the reference formulas (ref: vecmath.h:858-905) and
    the projections behave: frustum maps the near plane to z=-1, ortho
    maps the box corners to the unit cube."""
    from icon_dvr.utils.vecmath import (make_frustum, make_ortho,
                                        mat_identity, mat_mul, mat_vec)
    l, r, b, t, n, f = -0.2, 0.3, -0.1, 0.25, 0.5, 100.0
    M = np.asarray(make_frustum(l, r, b, t, n, f))
    p = np.asarray(mat_vec(jnp.asarray(M), jnp.asarray([l, b, -n, 1.0])))
    p = p / p[3]
    np.testing.assert_allclose(p[:3], [-1, -1, -1], atol=1e-5)
    p = np.asarray(mat_vec(jnp.asarray(M), jnp.asarray([r * f / n, t * f / n,
                                                        -f, 1.0])))
    p = p / p[3]
    np.testing.assert_allclose(p[:3], [1, 1, 1], atol=1e-4)

    O = np.asarray(make_ortho(l, r, b, t, n, f))
    p = np.asarray(mat_vec(jnp.asarray(O), jnp.asarray([l, b, -n, 1.0])))
    np.testing.assert_allclose(p, [-1, -1, -1, 1], atol=1e-5)
    p = np.asarray(mat_vec(jnp.asarray(O), jnp.asarray([r, t, -f, 1.0])))
    np.testing.assert_allclose(p, [1, 1, 1, 1], atol=1e-5)

    eye = mat_identity(4)
    np.testing.assert_array_equal(np.asarray(mat_mul(eye, jnp.asarray(M))), M)


def test_interval_arithmetic():
    from icon_dvr.utils.vecmath import (interval, interval_add,
                                        interval_contains, interval_div,
                                        interval_length, interval_mul,
                                        interval_sub)
    a = interval(jnp.asarray([-1.0, 2.0]), jnp.asarray([3.0, 5.0]))
    b = interval(jnp.asarray([2.0, -4.0]), jnp.asarray([4.0, -1.0]))
    lo, hi = interval_add(a, b)
    np.testing.assert_allclose(np.asarray(lo), [1.0, -2.0])
    np.testing.assert_allclose(np.asarray(hi), [7.0, 4.0])
    # reference convention: endpoint-wise sub (vecmath.h:1185-1187)
    lo, hi = interval_sub(a, b)
    np.testing.assert_allclose(np.asarray(lo), [-3.0, 6.0])
    np.testing.assert_allclose(np.asarray(hi), [-1.0, 6.0])
    # conservative product: contains every pairwise product
    lo, hi = interval_mul(a, b)
    np.testing.assert_allclose(np.asarray(lo), [-4.0, -20.0])
    np.testing.assert_allclose(np.asarray(hi), [12.0, -2.0])
    # division by a zero-straddling interval widens to [-inf, inf]
    z = interval(jnp.asarray([-1.0, 1.0]), jnp.asarray([1.0, 2.0]))
    lo, hi = interval_div(a, z)
    assert np.isneginf(np.asarray(lo)[0]) and np.isposinf(np.asarray(hi)[0])
    np.testing.assert_allclose(np.asarray(lo)[1], 1.0)
    np.testing.assert_allclose(np.asarray(hi)[1], 5.0)
    # degenerate single-value interval + contains/length
    s = interval(2.0)
    assert float(interval_length(s)) == 0.0
    assert bool(interval_contains(a, 0.0)[0])
    assert not bool(interval_contains(a, 4.0)[0])
