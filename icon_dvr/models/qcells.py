"""Quantized device cells — the single-chip R2B9 tier.

The f32 fast-path tables (ops/fast.PackedCells) cost 64 + 640 bytes/cell;
at R2B9 (84M columns, the north-star scale the reference builds on one GPU,
ref: icon_rt/hostCode.cu:639-645) that is ~59 GB of tables.
This tier stores the same information quantized:

  test12   (N, 12) f32 — 3 side-plane NORMALS (the planes pass through the
           origin because column edges are radial, so w == 0 exactly and is
           not stored) + h_bot + h_top + num_layers.          48 B/cell
  h_frac   (N, Lm) u16 — per-layer ceiling heights normalized to
           [h_bot, h_top] (error ~0.5 m at a 30 km column).    2 Lm B/cell
  value_q  (N, Lm) u8 — layer scalars normalized to the global data range.
           TF-independent: never re-baked on TF edits.          Lm B/cell
  alpha_q  (N, Lm) u8 — post-classified alpha (incl. opacity scale),
           normalized by alpha_max, FLOOR-quantized so every value stays
           <= the true alpha <= the band majorant (conservativeness of the
           Woodcock acceptance test survives quantization).     Lm B/cell

Lm trims the MAX_LAYERS=32 padding to the next multiple of 8 >= the real
layer count.  At Lm=16, R2B9 totals ~8.4 GB + locator.

TF edits re-bake ONLY alpha_q — through a 256-entry table (one entry per
distinct quantized value) instead of the 54 GB full-profile rewrite of the
f32 path.  RGB is never baked: the shader classifies the accepted sample's
dequantized value through the live LUT (one small gather per finished ray).

Fidelity: the rendered field is the value/height-quantized field — the
estimator stays unbiased for THAT field, which differs from the exact one
by <= half a quantization step (documented fast-path deviation; the parity
raygens remain exact).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data.icfile import ICDataset, MAX_LAYERS
from .cells import _corner_xyz, _np_plane
from .transfunc import Transfunc

F = np.float32


class QuantizedCells(NamedTuple):
    """All 2-D tables are PACK row layouts (utils/layout.pack_table):
    logical (N, W) rows stored as (N/f, f*W') with W' = aligned_width(W)
    (the next divisor of 128) and f = 128 // W' — small padding AND
    aligned-row gathers with an aligned subrow extract; test12's 12 -> 16
    slot padding costs ~1 GB at R2B9 (a choice made for 128-lane tiles,
    not yet measured on the H100 — ROADMAP D2).  Logical
    row widths: test12 12 (slot 16), value_q/alpha_q Lm, h_frac Lm."""
    test12: jnp.ndarray    # packed (N, 12) f32: 3 normals + h_bot h_top nl
    h_frac: jnp.ndarray    # UNPACKED (N, Lm) f32 — or (1, Lm) u16 when all
                           # columns share the layer spacing (uniform
                           # grids — saves 2.7 GB at R2B9).  Stays
                           # unpacked so lm is recoverable from its shape
                           # (packed widths are ambiguous); the padded
                           # layout only costs on small real-terrain
                           # scenes, the big synthetic tiers dedup
    value_q: jnp.ndarray   # packed (N, Lm) u8
    alpha_q: jnp.ndarray   # packed (N, Lm) u8
    value_lo: jnp.ndarray  # () f32
    value_hi: jnp.ndarray  # () f32
    alpha_max: jnp.ndarray  # () f32 dequant scale for alpha_q
    alpha_tab: np.ndarray = None  # (256,) u8 HOST copy of the normalized
                           # bake table alpha_q was built from; lets
                           # bake_alpha_q skip the (N, Lm) rewrite when an
                           # edit leaves the normalized table unchanged
                           # (every pure opacity-scale edit does: alpha and
                           # alpha_max scale together).  None = unknown.
                           # INVARIANT: alpha_q == alpha_tab[value_q]; any
                           # _replace that swaps value_q must reset
                           # alpha_tab=None (see data/animation.py)

    @property
    def num_cells(self) -> int:
        """Cell capacity incl. pack padding (pad rows are all-zero)."""
        from ..utils.layout import slot_width
        f, _ = slot_width(self.test12.shape[1], 12)
        return self.test12.shape[0] * f

    @property
    def lm(self) -> int:
        # h_frac is always stored unpacked ((N, Lm) or dedup (1, Lm)),
        # so its width is the authoritative logical layer count — packed
        # widths (f*Lm = 128) would be ambiguous
        return self.h_frac.shape[1]


def quantize_dataset_values(ds: ICDataset) -> tuple[ICDataset, float, float]:
    """Round ds.value to the 256-level grid IN the dataset, so every
    consumer (radial-band value ranges, stats, renders) sees the exact
    field the quantized renderer samples — majorants stay conservative."""
    mask = np.arange(MAX_LAYERS)[None, :] < ds.num_layers[:, None]
    # min/max via where (a boolean fancy-index gather over (N, 32) costs
    # minutes at R2B9; where+reduce is pure bandwidth)
    if ds.num_cells:
        lo = float(np.where(mask, ds.value, np.float32(np.inf)).min())
        hi = float(np.where(mask, ds.value, np.float32(-np.inf)).max())
    else:
        lo, hi = 0.0, 1.0
    if not hi > lo:
        hi = lo + 1.0
    q = np.clip(np.rint((ds.value - lo) / (hi - lo) * 255.0), 0, 255)
    value = (lo + q * ((hi - lo) / 255.0)).astype(F)
    import dataclasses
    ds_q = dataclasses.replace(ds, value=np.where(mask, value, 0.0).astype(F))
    return ds_q, lo, hi


def quantize_cells(ds: ICDataset, lm: int | None = None,
                   value_range: tuple[float, float] | None = None
                   ) -> QuantizedCells:
    """Host-side quantization (numpy, slab-friendly); alpha_q starts at 0 —
    call bake_alpha_q with a transfer function before rendering.

    value_range: pass the (lo, hi) from an earlier quantize_dataset_values
    to skip the redundant re-snap pass (minutes at R2B9)."""
    n = ds.num_cells
    idx = np.arange(n)
    h_bot = ds.height[:, 0].astype(F)
    h_top = ds.height[idx, ds.num_layers].astype(F)
    if lm is None:
        lm = int(ds.num_layers.max()) if n else 1
        lm = max(8, -(-lm // 8) * 8)
    assert lm >= int(ds.num_layers.max() if n else 0)

    bv = _corner_xyz(ds, h_bot)
    tv = _corner_xyz(ds, h_top)
    # planes through (bv_i, bv_j, tv_j), CCW (ref: icon_rt/ICONGrid.h:197-199)
    p1 = _np_plane(bv[:, 0], bv[:, 1], tv[:, 1])
    p2 = _np_plane(bv[:, 1], bv[:, 2], tv[:, 2])
    p3 = _np_plane(bv[:, 2], bv[:, 0], tv[:, 0])

    test12 = np.zeros((n, 12), F)
    test12[:, 0:3] = p1[:, :3]
    test12[:, 3:6] = p2[:, :3]
    test12[:, 6:9] = p3[:, :3]
    test12[:, 9] = h_bot
    test12[:, 10] = h_top
    test12[:, 11] = ds.num_layers.astype(F)

    # per-layer CEILING heights h[1..lm] normalized to [h_bot, h_top]
    span = np.maximum(h_top - h_bot, 1e-6).astype(F)
    ceil_h = ds.height[:, 1:lm + 1].astype(F)  # (N, lm); garbage past nl
    hf = np.clip(np.rint((ceil_h - h_bot[:, None]) / span[:, None] * 65535.0),
                 0, 65535).astype(np.uint16)
    k = np.arange(1, lm + 1)
    valid = k[None, :] <= ds.num_layers[:, None]
    hf = np.where(valid, hf, np.uint16(65535))

    if value_range is None:
        ds_q, lo, hi = quantize_dataset_values(ds)
    else:
        ds_q, (lo, hi) = ds, value_range
    vq = np.clip(np.rint((ds_q.value[:, :lm] - lo)
                         * (np.float32(255.0) / np.float32(hi - lo))),
                 0, 255).astype(np.uint8)

    import jax

    from ..utils.layout import pack_table
    if n and bool((hf == hf[0]).all()):
        hf = hf[:1]   # uniform layer spacing: one shared row
    else:
        # PER-CELL heights (real terrain) are stored f32, not u16, so the
        # gather stays in the (N, 16) f32 row-gather family of the other
        # tables (a wide u16 gather failed on the earlier accelerator).
        # Values keep the 0..65535 grid, exactly representable in f32,
        # so the dequant arithmetic and images are bit-identical.
        hf = hf.astype(F)
    return QuantizedCells(
        test12=jax.device_put(pack_table(test12)),
        h_frac=jax.device_put(np.ascontiguousarray(hf)),
        value_q=jax.device_put(pack_table(vq)),
        alpha_q=jax.device_put(pack_table(np.zeros((n, lm), np.uint8))),
        value_lo=jnp.float32(lo), value_hi=jnp.float32(hi),
        alpha_max=jnp.float32(1.0),
    )


def _classify_alpha_table(tf: Transfunc, value_lo, value_hi) -> jnp.ndarray:
    """(256,) classified alpha of each dequantized value level — the exact
    postClassify arithmetic (ref: deviceCode.cu:127-135), alpha channel."""
    levels = value_lo + jnp.arange(256, dtype=jnp.float32) / 255.0 \
        * (value_hi - value_lo)
    size = tf.size
    vn = (levels - tf.value_range[0]) / (tf.value_range[1] - tf.value_range[0])
    vs = vn * jnp.float32(size)
    idx = vs.astype(jnp.int32)
    frac = vs - idx.astype(jnp.float32)
    i1 = jnp.clip(idx, 0, size - 1)
    i2 = jnp.clip(idx + 1, 0, size - 1)
    lut_a = tf.values[:, 3]
    return lut_a[i1] * frac + lut_a[i2] * (1.0 - frac) \
        * tf.opacity_scale.astype(jnp.float32)


def bake_alpha_q(q: QuantizedCells, tf: Transfunc) -> QuantizedCells:
    """TF-edit hook of the quantized tier (analog of the f32 path's full
    profile re-bake, ref: hostCode.cu:878-909): one 256-entry table bake +
    a u8 table lookup over (N, Lm).  Floor quantization keeps every stored
    alpha <= the true alpha, preserving majorant conservativeness.

    FAST PATH: when the NORMALIZED 256-entry table equals the one alpha_q was
    baked from (q.alpha_tab), the (N, Lm) table is already correct and only the
    alpha_max dequant scalar moves.  Every pure opacity-scale edit — the
    reference's most common TFE gesture — lands here, because alpha and its max
    scale together, so floor(a/amax*255) is unchanged.

    Deliberately NOT jitted as a whole: the host compares the 256-entry
    table with the baked one and dispatches between the no-op, patch and
    full-bake paths.  Every path runs on the device, and a device failure
    propagates to the caller."""
    a_tab = _classify_alpha_table(tf, q.value_lo, q.value_hi)
    a_max = jnp.maximum(jnp.max(a_tab), jnp.float32(1e-8))
    q_tab = jnp.floor(a_tab / a_max * 255.0).astype(jnp.uint8)
    tab_host = np.asarray(q_tab)
    if q.alpha_tab is not None and np.array_equal(tab_host, q.alpha_tab):
        return q._replace(alpha_max=a_max)
    if q.alpha_tab is not None:
        # INCREMENTAL PATH: a TFE stroke usually touches a narrow value
        # band, so few of the 256 normalized levels actually change;
        # patching only those is an 8x narrower select-reduce than the
        # full bake (the bake is compute-bound: 256 compare-selects per
        # u8 element)
        changed = np.nonzero(tab_host != q.alpha_tab)[0]
        if changed.size <= 32:
            lev = np.full(32, -1, np.int32)   # -1 pads: never matches
            lev[:changed.size] = changed
            alpha_q = _bake_patch(q.value_q, q.alpha_q, jnp.asarray(lev),
                                  jnp.asarray(tab_host[np.maximum(lev, 0)]))
            return q._replace(alpha_q=alpha_q, alpha_max=a_max,
                              alpha_tab=tab_host)
    alpha_q = _bake_lookup(q.value_q, q_tab)
    return q._replace(alpha_q=alpha_q, alpha_max=a_max, alpha_tab=tab_host)


_BAKE_CACHE: dict = {}


def _bake_lookup(vq, tab):
    """tab[vq] elementwise over the packed u8 table, WITHOUT a gather: a
    fused (v == k) * tab_k compare-select reduce over the 256 levels,
    with no s32 index temp over the whole table (gigabytes at R2B9).
    Memory traffic is one read + write of the u8 table.  Chosen where 1-D
    gathers lowered to scalar loads; the H100 A/B against a plain
    gather is ROADMAP D2."""
    def body(v, t):
        n, w = v.shape
        rows = max(1, min(n, (1 << 21) // max(w, 1)))
        pad = (-n) % rows
        if pad:
            v = jnp.concatenate([v, jnp.zeros((pad, w), v.dtype)])
        lev = jnp.arange(256, dtype=jnp.int32)
        ti = t.astype(jnp.int32)

        def chunk(c):
            m = c.astype(jnp.int32)[..., None] == lev
            return jnp.sum(jnp.where(m, ti, 0), axis=-1).astype(jnp.uint8)

        out = jax.lax.map(chunk, v.reshape(-1, rows, w))
        return out.reshape(-1, w)[:n]

    fn = _BAKE_CACHE.get("bake")
    if fn is None:
        fn = jax.jit(body)
        _BAKE_CACHE["bake"] = fn
    return fn(vq, tab)


def _bake_patch(vq, aq_old, lev, new):
    """Patch alpha_q where value_q hits one of <= 32 changed levels:
    out = new[j] where vq == lev[j] else aq_old.  lev is -1-padded
    (never matches a u8 value), entries are distinct, so the masked sum
    selects exactly one new value.  Same chunking as _bake_lookup.  The
    old table is NOT donated: callers edit repeatedly from one base q
    (e.g. successive TFE strokes), so its buffer must stay valid."""
    def body(v, a, lv, nw):
        n, w = v.shape
        rows = max(1, min(n, (1 << 21) // max(w, 1)))
        pad = (-n) % rows
        if pad:
            v = jnp.concatenate([v, jnp.zeros((pad, w), v.dtype)])
            a = jnp.concatenate([a, jnp.zeros((pad, w), a.dtype)])
        ni = nw.astype(jnp.int32)

        def chunk(c):
            cv, ca = c
            m = cv.astype(jnp.int32)[..., None] == lv
            sel = jnp.sum(jnp.where(m, ni, 0), axis=-1).astype(jnp.uint8)
            return jnp.where(jnp.any(m, axis=-1), sel, ca)

        out = jax.lax.map(chunk, (v.reshape(-1, rows, w),
                                  a.reshape(-1, rows, w)))
        return out.reshape(-1, w)[:n]

    fn = _BAKE_CACHE.get("patch")
    if fn is None:
        fn = jax.jit(body)
        _BAKE_CACHE["patch"] = fn
    return fn(vq, aq_old, lev, new)
