"""Device-side synthetic scene generation — zero-upload scene builds.

The host builder (bigscene.synth_quantized) takes about 20 min of
single-threaded numpy at R2B9, and its 8.4 GB of tables must then be
uploaded.  But the synthetic scene is PROCEDURAL: cell
i of a subdivision-s icosphere decomposes as

    base face  = i % 20
    child path = base-4 digits of i // 20   (LSB = first subdivision)

so every cell's corner triangle is s steps of midpoint-subdivision
arithmetic from a 20-triangle constant — pure vector arithmetic.  This module
evaluates the same construction (geometry, banded-wave field, u8
quantization, radial band ranges) directly on the accelerator in packed
table layouts (utils/layout.pack_table): an R2B9 build is seconds of
device compute and the only remaining upload is the locator table.

Fidelity: the arithmetic mirrors bigscene.synth_quantized step for step
(same subdivision recurrence incl. the all-rows renormalization, same
plane construction, same rint quantization).  Device transcendentals can
differ from numpy by ~1 ulp, so individual u8 levels may differ by +-1
in rare cells; all DERIVED aggregates (value range, band ranges, bounds)
are computed from the device tables themselves, so majorant
conservativeness holds by construction.  Small-scale agreement with the
host builder is asserted in tests/test_device_scene.py.

Reference analog: the converter + hostCode build path
(ref: tools/convert_icon/convert_icon.cpp:163-452, icon_rt/hostCode.cu:
639-645) — the reference builds its 84M-cell accel on the machine the
renderer runs on; here the renderer's chip builds its own tables.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from .synthetic import EARTH_RADIUS
from ..models.cells import CellStats
from .bigscene import _ICO_FACES, _ICO_VERTS


def _base_triangles() -> np.ndarray:
    verts = _ICO_VERTS / np.linalg.norm(_ICO_VERTS, axis=1, keepdims=True)
    return verts[_ICO_FACES].astype(np.float32)     # (20, 3, 3)


def _default_field_jnp(lat, lon, h_rel):
    """jnp twin of synthetic._default_field (banded waves, height decay)."""
    import jax.numpy as jnp
    v = 0.5 + 0.35 * jnp.sin(3.0 * lon) * jnp.cos(2.0 * lat) \
        + 0.15 * jnp.cos(7.0 * lat)
    return jnp.clip(v * (1.0 - 0.5 * h_rel), 0.0, 1.0)


def _cell_corners(idx, subdivisions: int, base_tri):
    """(M,) i32 cell indices -> (M, 3, 3) f32 unit corner vectors.

    Mirrors bigscene._subdivide_f32's block order: child digit d_k of
    i // 20 (LSB first) selects, at step k, one of
      0:(a, ab, ca)  1:(ab, b, bc)  2:(ca, bc, c)  3:(ab, bc, ca)
    with all three rows renormalized each step (the host code divides
    every vertex by its norm at every level, so we do too)."""
    import jax.numpy as jnp
    tri = base_tri[idx % 20]                        # (M, 3, 3)
    rest = idx // 20
    for k in range(subdivisions):
        d = (rest >> (2 * k)) & 3                   # (M,)
        a = tri[:, 0]
        b = tri[:, 1]
        c = tri[:, 2]
        ab = a + b
        bc = b + c
        ca = c + a
        d_ = d[:, None]
        v0 = jnp.where(d_ == 0, a, jnp.where(d_ == 2, ca, ab))
        v1 = jnp.where(d_ == 0, ab, jnp.where(d_ == 1, b, bc))
        v2 = jnp.where(d_ == 2, c, jnp.where(d_ == 1, bc, ca))
        tri = jnp.stack([v0, v1, v2], axis=1)
        tri = tri / jnp.sqrt(jnp.sum(tri * tri, axis=-1, keepdims=True))
    return tri


def _orient_ccw(tri):
    """Swap corners 1<->2 where the triangle is clockwise seen from
    outside (same predicate as the host builder)."""
    import jax.numpy as jnp
    nrm = jnp.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    cw = jnp.sum(nrm * tri.mean(axis=1), axis=-1) < 0.0
    t1 = jnp.where(cw[:, None], tri[:, 2], tri[:, 1])
    t2 = jnp.where(cw[:, None], tri[:, 1], tri[:, 2])
    return jnp.stack([tri[:, 0], t1, t2], axis=1)


class DeviceScene(NamedTuple):
    """Device twin of bigscene.QuantScene (tables already packed)."""
    cells: object            # models.qcells.QuantizedCells
    bands: object            # models.shells.RadialBands (majorants zeroed)
    stats: CellStats


def synth_quantized_device(subdivisions: int, num_layers: int,
                           radius: float = float(EARTH_RADIUS),
                           thickness: float = 3.0e4,
                           num_bands: int = 64,
                           chunk_cells: int = 1 << 20,
                           field_lod: int = 0) -> DeviceScene:
    """Build the quantized scene entirely on the default device.

    Two chunked passes over the cell index space (lax.map so each pass is
    one compiled program regardless of scene scale):
      pass 1: field min/max + AABB bulge term + lat/lon bounds
      pass 2: test12 / value_q tables in PACK layout + per-layer u8
              min/max for the radial band ranges

    field_lod > 0 builds a MIP TIER (data/lod.py): geometry stays the
    subdivision-`subdivisions` icosphere, but each cell's field value is
    the MEAN over its 4**field_lod descendant cells at subdivision
    (subdivisions + field_lod) — i.e. the level-`field_lod` value-space
    mip of the fine scene.  Filtering happens in VALUE space and
    classification at sample time, matching the reference's sampling
    order (ref: icon_rt/deviceCode.cu:127-135).  Descendant index rule:
    descendants(p) at the fine level are { p + m * n : m < 4**lod } —
    see data/lod.py for the digit argument.
    """
    import jax
    import jax.numpy as jnp
    from ..models.qcells import QuantizedCells
    from ..models.shells import RadialBands

    from ..utils.layout import aligned_width, pack_factor

    n = 20 * 4 ** subdivisions
    # a pooled field evaluation costs 4**lod descendant corner walks per
    # cell; shrink the chunk so per-chunk work (and the unrolled program)
    # stays at the plain pass's scale
    if field_lod > 0:
        chunk_cells = max(1024, chunk_cells >> (2 * field_lod))
    lm = max(8, -(-num_layers // 8) * 8)
    sw12 = aligned_width(12)                         # test12 slot width (16)
    f12 = pack_factor(12)                            # test12 pack factor
    swlm = aligned_width(lm)                         # value/alpha slot
    flm = pack_factor(lm)                            # value/alpha factor
    gran = math.lcm(f12, flm)
    n_pad = -(-n // gran) * gran
    # chunk_cells must DIVIDE n_pad: exact cover makes merge() a reshape
    # that bitcasts the donated chunk stacks in place.  A ragged tail
    # chunk would force a concatenate whose output can't alias the
    # donated input ("donated buffers were not usable"), transiently
    # doubling the ~5.4 GB of R2B9 chunk stacks.
    m_req = max(1, min(chunk_cells, n_pad) // gran)
    while (n_pad // gran) % m_req:
        m_req -= 1
    chunk_cells = m_req * gran
    n_chunks = n_pad // chunk_cells

    base_tri = jnp.asarray(_base_triangles())
    h_bot = np.float32(radius)
    h_top = np.float32(radius + thickness)
    layer_rel = [np.float32((j + 0.5) / num_layers)
                 for j in range(num_layers)]

    def corners_of(idx):
        # pad indices re-generate the last real cell; table rows for
        # them are zeroed below, aggregates are duplicate-insensitive
        tri = _cell_corners(jnp.minimum(idx, n - 1), subdivisions,
                            base_tri)
        return _orient_ccw(tri)

    def _field_of_tri(tri):
        clat = jnp.arcsin(jnp.clip(tri[..., 2], -1.0, 1.0)).mean(axis=1)
        lon = jnp.arctan2(tri[..., 1], tri[..., 0])
        clon = jnp.arctan2(jnp.sin(lon).mean(axis=1),
                           jnp.cos(lon).mean(axis=1))
        return jnp.stack([_default_field_jnp(clat, clon, layer_rel[j])
                          for j in range(num_layers)], axis=1)  # (M, nl)

    def field_chunk(tri, idx):
        if field_lod == 0:
            return _field_of_tri(tri)
        # mip tier: mean over the cell's 4**lod fine-level descendants
        # (orientation is irrelevant for centroids, so no _orient_ccw)
        fine = jnp.minimum(idx, n - 1)
        acc = None
        for m in range(4 ** field_lod):
            tri_f = _cell_corners(fine + m * n, subdivisions + field_lod,
                                  base_tri)
            v = _field_of_tri(tri_f)
            acc = v if acc is None else acc + v
        return acc * jnp.float32(1.0 / 4 ** field_lod)

    starts = jnp.asarray(
        [min(ci * chunk_cells, n_pad - chunk_cells)
         for ci in range(n_chunks)], jnp.int32)

    @jax.jit
    def pass1(starts):
        def body(s0):
            idx = s0 + jnp.arange(chunk_cells, dtype=jnp.int32)
            tri = corners_of(idx)
            v = field_chunk(tri, idx)
            ctr = tri.mean(axis=1)
            m = jnp.sqrt(jnp.sum(ctr * ctr, axis=-1))
            lat = jnp.arcsin(jnp.clip(tri[..., 2], -1.0, 1.0))
            lon = jnp.arctan2(tri[..., 1], tri[..., 0])
            return (v.min(), v.max(), m.min(),
                    lat.min(), lat.max(), lon.min(), lon.max())
        outs = jax.lax.map(body, starts)
        return (outs[0].min(), outs[1].max(), outs[2].min(),
                outs[3].min(), outs[4].max(), outs[5].min(), outs[6].max())

    lo_d, hi_d, m_min_d, lat0, lat1, lon0, lon1 = pass1(starts)
    lo = float(lo_d)
    hi = float(hi_d)
    if not hi > lo:
        hi = lo + 1.0

    @jax.jit
    def pass2(starts, lo, hi):
        scale = jnp.float32(255.0) / (hi - lo)

        def body(s0):
            idx = s0 + jnp.arange(chunk_cells, dtype=jnp.int32)
            real = (idx < n)[:, None]
            tri = corners_of(idx)
            rows = []
            for (i, j) in ((0, 1), (1, 2), (2, 0)):
                a = tri[:, i] * h_bot
                b = tri[:, j] * h_bot
                c = tri[:, j] * h_top
                rows.append(jnp.cross(b - a, c - a))
            t12 = jnp.concatenate(
                rows + [jnp.full((chunk_cells, 1), h_bot),
                        jnp.full((chunk_cells, 1), h_top),
                        jnp.full((chunk_cells, 1), np.float32(num_layers)),
                        jnp.zeros((chunk_cells, sw12 - 12))],
                axis=1)                                   # (M, sw12)
            t12 = jnp.where(real, t12, 0.0)
            v = field_chunk(tri, idx)                     # (M, nl)
            qv = jnp.clip(jnp.rint((v - lo) * scale), 0, 255) \
                .astype(jnp.uint8)
            vq = jnp.zeros((chunk_cells, swlm), jnp.uint8) \
                .at[:, :num_layers].set(qv)
            vq = jnp.where(real, vq, jnp.uint8(0))
            return (t12.reshape(-1, f12 * sw12), vq.reshape(-1, flm * swlm),
                    qv.min(axis=0), qv.max(axis=0))
        t12p, vqp, qmin, qmax = jax.lax.map(body, starts)
        return (t12p, vqp, qmin.min(axis=0), qmax.max(axis=0))

    t12p, vqp, qmin, qmax = pass2(starts, jnp.float32(lo), jnp.float32(hi))

    def merge(stacked, rows_per_chunk, total_rows):
        """(n_chunks, rows, W) -> (total_rows, W); the short tail chunk
        re-generated the last full window, so drop its duplicated head."""
        flat = stacked.reshape(-1, stacked.shape[-1])
        if n_chunks * chunk_cells == n_pad:
            return flat
        keep_head = (n_chunks - 1) * rows_per_chunk
        tail = total_rows - keep_head
        return jnp.concatenate(
            [flat[:keep_head], flat[flat.shape[0] - tail:]], axis=0)

    merge_tables = jax.jit(
        lambda t12p, vqp: (merge(t12p, chunk_cells // f12, n_pad // f12),
                           merge(vqp, chunk_cells // flm, n_pad // flm)),
        donate_argnums=(0, 1))   # exact-cover case is a free bitcast

    test12, value_q = merge_tables(t12p, vqp)
    del t12p, vqp

    # uniform layer spacing -> one shared h_frac row (host arithmetic,
    # same as bigscene.synth_quantized)
    k1 = np.arange(1, lm + 1)
    row = np.where(k1 <= num_layers,
                   np.clip(np.rint(k1 / num_layers * 65535.0), 0, 65535),
                   65535).astype(np.uint16)
    q = QuantizedCells(
        test12=test12, h_frac=jax.device_put(row[None, :]),
        value_q=value_q,
        alpha_q=jnp.zeros((n_pad // flm, flm * swlm), jnp.uint8),
        value_lo=jnp.float32(lo), value_hi=jnp.float32(hi),
        alpha_max=jnp.float32(1.0))

    # radial band ranges from the DEVICE tables' per-layer u8 extrema
    # (conservative for exactly the field the renderer samples)
    qmin_h = np.asarray(qmin).astype(np.float64)
    qmax_h = np.asarray(qmax).astype(np.float64)
    edges = np.linspace(h_bot, h_top, num_bands + 1).astype(np.float32)
    br_lo = np.full(num_bands, np.finfo(np.float32).max, np.float32)
    br_hi = np.full(num_bands, -np.finfo(np.float32).max, np.float32)
    layer_h = thickness / num_layers
    for j in range(num_layers):
        v_lo = lo + float(qmin_h[j]) * (hi - lo) / 255.0
        v_hi = lo + float(qmax_h[j]) * (hi - lo) / 255.0
        b0 = min(int((j * layer_h) / thickness * num_bands), num_bands - 1)
        b1 = min(int(((j + 1) * layer_h) / thickness * num_bands),
                 num_bands - 1)
        br_lo[b0:b1 + 1] = np.minimum(br_lo[b0:b1 + 1], np.float32(v_lo))
        br_hi[b0:b1 + 1] = np.maximum(br_hi[b0:b1 + 1], np.float32(v_hi))
    bands = RadialBands(
        edges=jnp.asarray(edges),
        value_ranges=jnp.asarray(np.stack([br_lo, br_hi], axis=1)),
        max_opacities=jnp.zeros(num_bands, jnp.float32))

    r_box = float(h_top) * (2.0 - float(m_min_d))
    stats = CellStats(
        world_bounds_lo=np.array([-r_box, -r_box, -r_box], np.float32),
        world_bounds_hi=np.array([r_box, r_box, r_box], np.float32),
        spherical_bounds_lo=np.array([h_bot, float(lat0), float(lon0)],
                                     np.float32),
        spherical_bounds_hi=np.array([h_top, float(lat1), float(lon1)],
                                     np.float32),
        data_range=np.array([lo, hi], np.float32),
    )
    return DeviceScene(cells=q, bands=bands, stats=stats)
