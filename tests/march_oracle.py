"""Dense-scan quadrature oracle of the quantized march (ops/march.py).

The per-ray ground truth the march must reproduce: walk the ray through
the actual quantized scene at `n` evenly spaced points per shell segment,
find the containing cell of every point by testing EVERY cell (side
planes + radial bounds, no locator), and integrate emission-absorption
with a Riemann sum in float64 on the host.  A coarse pass first keeps
the cells whose side-plane cone comes within one coarse step of the
ray's great-circle arc (a conservative cull: a cell that contains any
scan point passes it), then the dense scan tests only those, in blocks
of at most about `block_cells` (point, cell) pairs — so a scan over
R2B4 (20,480 cells) costs about what one over R2B1 does.

Only the ray set-up (jitter, shell entry/exit) comes from the renderer
(ops/fast._init_lanes); location, layer select, classification and the
integral are independent numpy code.
"""
import numpy as np


def post_classify_np(lut, value_range, opacity_scale, v):
    """Vectorized float64 mirror of the reference postClassify
    (ref: deviceCode.cu:127-135), asymmetric lerp included: (n,) values ->
    (n, 4) RGBA."""
    lut = np.asarray(lut, np.float64)
    size = lut.shape[0]
    vn = (v - value_range[0]) / (value_range[1] - value_range[0])
    vs = vn * size
    idx = np.trunc(vs).astype(np.int64)       # int() truncates toward 0
    frac = (vs - idx)[:, None]
    v1 = lut[np.clip(idx, 0, size - 1)]
    v2 = lut[np.clip(idx + 1, 0, size - 1)]
    scale = np.array([1.0, 1.0, 1.0, float(opacity_scale)])
    return v1 * frac + v2 * (1.0 - frac) * scale


class MarchOracle:
    """Host copy of a quantized scene + launch params; `pixel(x, y)`
    returns the dense-scan RGBA of one pixel's accum_id-0 ray."""

    def __init__(self, q, bands, tf, lp, width, height, ud,
                 n=100000, block_cells=2e7):
        from icon_dvr.utils.layout import unpack_table
        self.bands, self.lp = bands, lp
        self.width, self.height, self.ud, self.n = width, height, ud, n
        self.lm = q.lm
        # padded rows of a packed table never contain a point (zero radial
        # bounds), so the unpacked tables are used as they come
        self.t12 = unpack_table(np.asarray(q.test12), 12).astype(np.float64)
        self.hf = np.asarray(q.h_frac).astype(np.float64)
        self.vqt = unpack_table(np.asarray(q.value_q), q.lm)
        self.aqt = unpack_table(np.asarray(q.alpha_q), q.lm)
        self.block_cells = block_cells
        self.lut = np.asarray(tf.values, np.float64)
        self.vr = np.asarray(tf.value_range, np.float64)
        self.scale = float(tf.opacity_scale)
        self.alpha_max = float(q.alpha_max)
        self.value_lo = float(q.value_lo)
        self.value_step = float(q.value_hi - q.value_lo) / 255.0
        self.org = np.asarray(lp.cam_org, np.float64)
        self.oo = float(np.dot(np.asarray(lp.cam_org),
                               np.asarray(lp.cam_org)))

    def _segments(self, x, y):
        import jax.numpy as jnp

        from icon_dvr.ops.fast import _init_lanes
        init, consts, wrote = _init_lanes(
            self.lp, jnp.asarray([x], jnp.int32), jnp.asarray([y], jnp.int32),
            self.width, self.height, self.bands.edges,
            self.bands.max_opacities, self.oo, self.bands.num_bands,
            prof_w=3 * self.lm)
        if not bool(wrote[0]):
            return None, []
        d = np.array([float(consts.dx[0]), float(consts.dy[0]),
                      float(consts.dz[0])])
        segs = [(float(init.t[0]), float(init.seg_hi[0]))]
        if float(consts.s1_hi[0]) > float(consts.s1_lo[0]):
            segs.append((float(consts.s1_lo[0]), float(consts.s1_hi[0])))
        return d, segs

    def _near_arc(self, d, a, b, n_coarse=2048):
        """Ids (ascending) of the cells whose side planes admit a
        direction within one coarse angular step of the arc of the ray
        directions over [a, b]."""
        ts = np.linspace(a, b, n_coarse)
        u = self.org[None, :] + ts[:, None] * d[None, :]
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        step = float(np.arccos(np.clip(
            (u[1:] * u[:-1]).sum(1), -1.0, 1.0)).max()) if n_coarse > 1 \
            else 0.0
        keep = np.zeros(self.t12.shape[0], bool)
        rows = max(1, int(self.block_cells // n_coarse))
        for i in range(0, self.t12.shape[0], rows):
            t = self.t12[i:i + rows]
            ok = np.ones((n_coarse, t.shape[0]), bool)
            for k in (0, 3, 6):
                nk = t[:, k:k + 3]
                ok &= u @ nk.T <= 2.0 * step * np.linalg.norm(nk, axis=1)
            keep[i:i + rows] = ok.any(0)
        return np.nonzero(keep)[0]

    def _block(self, p, cells):
        """(hit, alpha, rgba) per point of a (B, 3) block, testing only
        `cells` (ascending ids: the first containing cell wins, as in a
        scan over all cells)."""
        t12, lm = self.t12[cells], self.lm
        rr = np.linalg.norm(p, axis=1)
        ins = ((p @ t12[:, 0:3].T <= 0) & (p @ t12[:, 3:6].T <= 0)
               & (p @ t12[:, 6:9].T <= 0)
               & (rr[:, None] >= t12[None, :, 9])
               & (rr[:, None] <= t12[None, :, 10]))
        hit = ins.any(1)
        cell = cells[np.where(hit, np.argmax(ins, 1), 0)]
        row = self.t12[cell]
        hf = self.hf[np.minimum(cell, self.hf.shape[0] - 1)]  # 1 row: shared
        heights = row[:, 9:10] + hf * (
            (row[:, 10] - row[:, 9])[:, None] * (1.0 / 65535.0))
        nl = row[:, 11].astype(np.int64)
        heights = np.where(np.arange(1, lm + 1)[None, :] <= nl[:, None],
                           heights, np.inf)
        lay = np.minimum((rr[:, None] > heights).sum(1), lm - 1)
        alpha = self.aqt[cell, lay].astype(np.float64) / 255.0 \
            * self.alpha_max
        v = self.value_lo + self.vqt[cell, lay].astype(np.float64) \
            * self.value_step
        rgba = post_classify_np(self.lut, self.vr, self.scale, v)
        return hit, np.where(hit, alpha, 0.0), rgba

    def pixel(self, x: int, y: int) -> np.ndarray:
        d, segs = self._segments(x, y)
        tau, rgb = 0.0, np.zeros(3)
        for a, b in segs:
            ts = np.linspace(a, b, self.n)
            dt = ts[1] - ts[0]
            cells = self._near_arc(d, a, b)
            if cells.size == 0:
                continue
            block = max(1, int(self.block_cells // cells.size))
            for i in range(0, self.n, block):
                tb = ts[i:i + block]
                hit, alpha, rgba = self._block(
                    self.org[None, :] + tb[:, None] * d[None, :], cells)
                odseg = alpha / self.ud * dt
                taupre = tau + np.concatenate([[0.0],
                                               np.cumsum(odseg)[:-1]])
                w = np.exp(-taupre) * (1.0 - np.exp(-odseg))
                rgb += (w[:, None] * rgba[:, :3] * hit[:, None]).sum(0)
                tau += odseg.sum()
        return np.concatenate([rgb, [1.0 - np.exp(-tau)]])
