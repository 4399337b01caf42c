"""Packed layouts for large gather tables.

pack_table / packed_gather reshape a row-major (N, W) table to
(N/f, f*W') with f*W' = 128: the same bytes (plus W'-W pad lanes per row
when W does not divide 128), so a row gather is one aligned 128-wide
burst followed by an arithmetic subrow select.  Every table the render
loop gathers from uses it.

The 128-lane width and the slot alignment were chosen for (8, 128)
vector tiles; they are not yet measured on the H100 (ROADMAP D2).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def aligned_width(w: int) -> int:
    """Smallest divisor of 128 >= w (for w <= 128): the slot width a
    logical-w row occupies inside an aligned 128-lane physical row.

    Padding each row slot to the next divisor of 128 keeps the subrow
    extract at a power-of-two minor shape for ~11% more memory at w=12.
    Not yet measured on the H100 (ROADMAP D2)."""
    if w >= 128:
        return w
    a = 1
    while a < w:
        a *= 2
    return a


def pack_factor(w: int, align: bool = True) -> int:
    """Rows of logical width w packed per 128-lane physical row."""
    return max(1, 128 // (aligned_width(w) if align else w))


def pack_table(x: np.ndarray, pad_value=0, align: bool = True) -> np.ndarray:
    """(N, W) row-major -> (ceil(N/f), f*W'), W' = aligned_width(W),
    f = 128 // W': the same bytes reshaped (plus W'-W pad lanes per row when W
    does not divide 128) so the minor dim fills a 128-lane row AND each row
    slot sits at an aligned offset (see module docstring).  N pads up to a
    multiple of f with pad_value rows (use -1 for candidate-id tables whose -1
    means empty).

    align=False packs at the true width (f*W minor, e.g. the locator's
    (B, 18) i32 -> 126 lanes) — for tables where the aligned slot would
    cost real memory (18 -> 32 is +78%) and the gather is off the hottest
    path."""
    n, w = x.shape
    wa = aligned_width(w) if align else w
    f = max(1, 128 // wa)
    if f == 1 and wa == w:
        return np.ascontiguousarray(x)
    pad = (-n) % f
    if pad:
        x = np.concatenate(
            [x, np.full((pad, w), pad_value, x.dtype)], axis=0)
    if wa != w:
        x = np.concatenate(
            [x, np.full((x.shape[0], wa - w), pad_value, x.dtype)], axis=1)
    return np.ascontiguousarray(x).reshape(-1, f * wa)


def slot_width(minor: int, w: int) -> tuple[int, int]:
    """(f, slot_w) of a packed table from its physical minor dim and the
    logical row width: legacy true-width tables (minor % w == 0, e.g.
    npz-cached locator bins at 126 = 7*18) and aligned tables (slot padded
    to aligned_width(w)) are both recognized, so cached artifacts packed
    under either scheme stay readable."""
    if minor % w == 0:
        return minor // w, w
    wa = aligned_width(w)
    if minor % wa == 0:
        return minor // wa, wa
    raise ValueError(f"minor dim {minor} fits no packing of width {w}")


def packed_gather(table, idx, w: int):
    """rows[idx] (logical width w) from a pack_table'd device array: one
    aligned 128-wide row gather + an arithmetic subrow select.  idx may
    have any shape; returns idx.shape + (w,)."""
    f, wa = slot_width(table.shape[-1], w)
    if f == 1 and wa == w:
        return table[idx]
    rows = table[idx // f]                       # idx.shape + (f*wa,)
    sub = idx % f
    r = rows.reshape(rows.shape[:-1] + (f, wa))
    oh = (sub[..., None] == jnp.arange(f, dtype=sub.dtype))
    if jnp.issubdtype(r.dtype, jnp.floating):
        out = jnp.sum(r * oh[..., None].astype(r.dtype), axis=-2)
    else:
        out = jnp.sum(r.astype(jnp.int32) * oh[..., None].astype(jnp.int32),
                      axis=-2)
        out = out if table.dtype == jnp.int32 else out.astype(table.dtype)
    return out if wa == w else out[..., :w]


def unpack_table(x, w: int, n: int | None = None) -> np.ndarray:
    """Host-side inverse of pack_table: (N/f, f*w') -> (N, w) (the same
    bytes minus slot padding), trimmed to n logical rows when given."""
    x = np.asarray(x)
    f, wa = slot_width(x.shape[-1], w)
    out = x.reshape(-1, wa)[:, :w]
    return out[:n] if n is not None else out
