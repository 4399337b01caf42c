"""Ray ordering: sort pixels by expected tracking length.

Lane-masked wavefront loops run as long as their slowest lane; an
unsorted 64k-pixel chunk mixes background rays (~1 iteration) with
grazing rays (~1000+ Woodcock steps through the long shell chord), idling
most lanes most of the time.  Sorting pixels by the analytic chord length
of the central ray through the outer shell groups similar-cost rays into
the same chunk, raising lane utilization several-fold.

The permutation depends only on the camera and shell radii, so it is
computed once per camera move; accumulation and framebuffer live in
permuted order and are unpermuted on the host at present time (a cheap
numpy fancy-index, off the device entirely).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _chord_keys(cam_org, cam_dir00, cam_du, cam_dv, r_in, r_out, xs, ys):
    ox, oy, oz = cam_org[0], cam_org[1], cam_org[2]
    oo = ox * ox + oy * oy + oz * oz
    u = xs.astype(jnp.float32) + 1.0   # central ray (pixel + 0.5 + mean jitter)
    v = ys.astype(jnp.float32) + 1.0
    dx = cam_dir00[0] + u * cam_du[0] + v * cam_dv[0]
    dy = cam_dir00[1] + u * cam_du[1] + v * cam_dv[1]
    dz = cam_dir00[2] + u * cam_du[2] + v * cam_dv[2]
    inv = 1.0 / jnp.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    od = ox * dx + oy * dy + oz * dz

    def chord(radius):
        disc = od * od - oo + radius * radius
        hit = (disc > 0.0) & (-od + jnp.sqrt(jnp.maximum(disc, 0.0)) > 0.0)
        return hit, 2.0 * jnp.sqrt(jnp.maximum(disc, 0.0))

    hit_o, c_o = chord(r_out)
    hit_i, c_i = chord(r_in)

    # conservative coverage: a jittered ray lands up to ~1.5 pixels from
    # the center, so classify against the outer radius inflated by a few
    # pixel footprints at the closest-approach distance
    pix = jnp.sqrt(cam_du[0] ** 2 + cam_du[1] ** 2 + cam_du[2] ** 2) \
        + jnp.sqrt(cam_dv[0] ** 2 + cam_dv[1] ** 2 + cam_dv[2] ** 2)
    margin = 4.0 * pix * jnp.abs(od)
    disc_m = od * od - oo + (r_out + margin) ** 2
    covered = (disc_m > 0.0) & (-od + jnp.sqrt(jnp.maximum(disc_m, 0.0)) > 0.0)

    # in-shell path length of the central ray; misses sort to the BACK
    # (so the covered pixels form a prefix that can be rendered alone)
    length = jnp.where(covered, jnp.where(hit_o, c_o - jnp.where(hit_i, c_i, 0.0),
                                          0.0),
                       jnp.float32(np.inf))
    return length


def pixel_order(lp, r_in, r_out, width: int, height: int
                ) -> tuple[np.ndarray, int]:
    """(permutation of pixel ids sorted by expected ray cost, n_covered).

    Covered pixels (central ray hits the outer shell) come first, cheapest
    to costliest; misses trail.  Rendering only the first n_covered
    positions skips every all-background chunk — those rays never write
    (the reference's early return, deviceCode.cu:294) so the tail's
    accum/fb stay untouched either way.  The count is conservative only up
    to jitter: rays within a pixel of the silhouette are classified by the
    unjittered center, matching the reference's per-pixel boxTest granularity.
    """
    total = width * height
    ys, xs = jnp.divmod(jnp.arange(total, dtype=jnp.int32), width)
    keys = _chord_keys(lp.cam_org, lp.cam_dir00, lp.cam_du, lp.cam_dv,
                       jnp.float32(r_in), jnp.float32(r_out), xs, ys)
    keys = np.asarray(keys)
    perm = np.argsort(keys, kind="stable").astype(np.int32)
    n_covered = int(np.isfinite(keys).sum())
    return perm, n_covered


def inverse_order(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def refine_order(perm, n_active: int, cost_nat) -> np.ndarray:
    """Re-sort the covered prefix of `perm` by MEASURED per-pixel cost.

    The analytic chord key can't see transfer-function-dependent early
    termination (an opaque surface kills a long-chord ray in ~3 steps), so
    static ordering leaves chunks bound by mispredicted stragglers.
    Progressive accumulation renders the same camera repeatedly — the
    previous sample's outer-iteration counts (render_frame_fast's
    return_cost output, natural pixel order) are a near-exact predictor
    for the next.  Stable-sorting the covered prefix by them makes chunk
    cost nearly uniform.  The tail (uncovered pixels) is untouched, so
    n_active semantics survive.  Returns a new (total,) i32 permutation.
    """
    perm = np.asarray(perm)
    head = perm[:n_active]
    key = np.asarray(cost_nat)[head]
    out = perm.copy()
    out[:n_active] = head[np.argsort(key, kind="stable")]
    return out


def refine_order_device(perm, n_active: int, cost_nat):
    """Device-side refine_order (jit-compatible; argsort + gathers stay on
    the device, so per-sample adaptive re-ordering needs no host round
    trip).  perm/cost_nat are jnp arrays; n_active is static."""
    import jax

    @jax.jit
    def _go(perm, cost_nat):
        head = perm[:n_active]
        order = jnp.argsort(cost_nat[head], stable=True)
        return jnp.concatenate([head[order], perm[n_active:]])

    return _go(perm, cost_nat)


def repermute_device(arr, old_perm, new_perm):
    """Device-side repermute: arr stored in old_perm order -> new_perm
    order.  One scatter + one gather, jit-compiled."""
    import jax

    @jax.jit
    def _go(arr, old_perm, new_perm):
        nat = jnp.zeros_like(arr).at[old_perm].set(arr)
        return nat[new_perm]

    return _go(arr, old_perm, new_perm)


def repermute(arr, old_perm, new_perm):
    """Re-index an accumulation buffer stored in old_perm order into
    new_perm order (arr[i] holds pixel old_perm[i]'s data)."""
    arr = np.asarray(arr)
    nat = np.empty_like(arr)
    nat[np.asarray(old_perm)] = arr
    return nat[np.asarray(new_perm)]


def bucket_active(n_active: int, chunk: int, total: int) -> int:
    """Round the active count up to a power-of-two number of chunks so a
    moving camera cycles through O(log) compiled variants instead of one
    per frame."""
    if n_active >= total:
        return total
    chunks = max(1, -(-n_active // chunk))
    p = 1
    while p < chunks:
        p *= 2
    return min(total, p * chunk)
