"""Multi-timestep animation on a shared grid."""
import numpy as np
import jax.numpy as jnp
import pytest

from icon_dvr.data import synthetic
from icon_dvr.data.animation import Animation, animate_fast
from icon_dvr.data.icfile import ICDataset
from icon_dvr.models.cells import build_cells, compute_stats
from icon_dvr.models.locator import build_locator
from icon_dvr.models.shells import build_radial_bands, update_band_majorants
from icon_dvr.models.transfunc import make_transfunc
from icon_dvr.ops.camera import Camera
from icon_dvr.ops.render import make_launch_params


def _series(n_t=3):
    base = synthetic.latlon_section(n_lat=2, n_lon=2, num_layers=3,
                                    radius=100.0, thickness=30.0)
    steps = []
    for t in range(n_t):
        v = np.clip(base.value * (0.3 + 0.35 * t), 0, 1).astype(np.float32)
        steps.append(ICDataset(base.lat, base.lon, base.num_layers,
                               base.height, v))
    return steps


def test_animation_validates_grid():
    steps = _series()
    anim = Animation(steps)
    assert anim.num_timesteps == 3
    bad = _series(2)
    bad[1] = ICDataset(bad[1].lat * 1.01, bad[1].lon, bad[1].num_layers,
                       bad[1].height, bad[1].value)
    with pytest.raises(ValueError):
        Animation(bad)


def test_animate_fast_yields_changing_frames():
    W = H = 16
    anim = Animation(_series(3))
    ds0 = anim.geometry
    stats = compute_stats(ds0)
    cells = build_cells(ds0)
    loc = build_locator(ds0)
    tf = make_transfunc(value_range=(0.0, 1.0), size=32)
    # conservative over ALL timesteps: widen the band ranges to [0,1]
    bands = build_radial_bands(ds0, 8)
    bands = bands._replace(value_ranges=jnp.tile(
        jnp.asarray([[0.0, 1.0]], jnp.float32), (bands.num_bands, 1)))
    bands = update_band_majorants(bands, tf.values, tf.value_range)

    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    diag = np.linalg.norm(stats.world_bounds_hi - stats.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)

    def lp_for(t, s):
        return make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                                  stats.world_bounds_hi, unit_distance=5.0,
                                  accum_id=s)

    frames = list(animate_fast(anim, cells, loc, bands, tf, lp_for,
                               W, H, samples_per_frame=2))
    assert len(frames) == 3
    assert all(f.shape == (W * H,) for f in frames)
    # scalar field changes over time -> frames differ
    assert not np.array_equal(frames[0], frames[2])


def test_animate_fast_sharded_matches_single():
    """Tile-sharded animation equals the single-device animation on the
    covered pixels (per-pixel results depend only on pixel id + accum_id);
    BASELINE configs[4] composition, f32 tier."""
    from icon_dvr.data.animation import animate_fast_sharded
    from icon_dvr.parallel.sharded import make_mesh

    W = H = 16
    anim = Animation(_series(2))
    ds0 = anim.geometry
    stats = compute_stats(ds0)
    cells = build_cells(ds0)
    loc = build_locator(ds0)
    tf = make_transfunc(value_range=(0.0, 1.0), size=32)
    bands = build_radial_bands(ds0, 8)
    bands = bands._replace(value_ranges=jnp.tile(
        jnp.asarray([[0.0, 1.0]], jnp.float32), (bands.num_bands, 1)))
    bands = update_band_majorants(bands, tf.values, tf.value_range)
    cam = Camera()
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    diag = np.linalg.norm(stats.world_bounds_hi - stats.world_bounds_lo)
    cam.set_orientation(center + np.array([0.7 * diag, 0, 0], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)

    def lp_for(t, s):
        return make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                                  stats.world_bounds_hi, unit_distance=5.0,
                                  accum_id=s)

    single = list(animate_fast(anim, cells, loc, bands, tf, lp_for,
                               W, H, samples_per_frame=2))
    mesh = make_mesh(tiles=8, samples=1)
    sharded = list(animate_fast_sharded(anim, cells, loc, bands, tf, lp_for,
                                        mesh, W, H, samples_per_frame=2,
                                        chunk=16))
    assert len(sharded) == len(single) == 2
    for fs, f1 in zip(sharded, single):
        m = fs != 0   # sharded renders only the covered (dealt) prefix
        assert m.any()
        np.testing.assert_array_equal(fs[m], f1[m])


def test_animate_fastq_sharded_4k_two_timesteps():
    """The FULL north-star composition (BASELINE configs[4]): quantized
    tier x tile-sharded mesh x animation, at a 4K-shaped
    framebuffer.  The camera is pulled far back so the covered prefix stays
    CPU-sized — the frame SHAPE (3840x2160) and the uneven-tile dealing are
    what this exercises."""
    from icon_dvr.data import synthetic as syn
    from icon_dvr.data.animation import animate_fastq_sharded
    from icon_dvr.models.locator import build_locator_csr, densify_csr
    from icon_dvr.models.qcells import (quantize_cells,
                                        quantize_dataset_values)
    from icon_dvr.parallel.sharded import make_mesh

    W, H = 3840, 2160
    ds = syn.icosphere(subdivisions=1, num_layers=3)
    ds_q, lo, hi = quantize_dataset_values(ds)
    stats = compute_stats(ds_q)
    tf = make_transfunc(value_range=tuple(stats.data_range), size=32)
    q = quantize_cells(ds_q)
    csr, k_cap = build_locator_csr(ds_q)
    loc = densify_csr(csr, k_cap)
    bands = build_radial_bands(ds_q, 8)
    # conservative over both timesteps: widen band ranges to the data range
    bands = bands._replace(value_ranges=jnp.tile(
        jnp.asarray([[lo, hi]], jnp.float32), (bands.num_bands, 1)))
    bands = update_band_majorants(bands, tf.values, tf.value_range)

    # two timesteps: the field scales by 0.5 between them
    vq0 = np.asarray(q.value_q)
    vq1 = (vq0.astype(np.float32) * 0.5).astype(np.uint8)

    cam = Camera()
    cam.set_aspect(W / H)
    center = 0.5 * (stats.world_bounds_lo + stats.world_bounds_hi)
    R = float(stats.spherical_bounds_hi[0])
    cam.set_orientation(center + np.array([28 * R, 4 * R, 9 * R], np.float32),
                        center, np.array([0, 0, 1], np.float32), cam.fovy)

    def lp_for(t, s):
        return make_launch_params(cam.basis(W, H), stats.world_bounds_lo,
                                  stats.world_bounds_hi, unit_distance=1e4,
                                  accum_id=s)

    mesh = make_mesh(tiles=8, samples=1)
    frames = list(animate_fastq_sharded(q, [vq0, vq1], loc, k_cap, bands,
                                        tf, lp_for, mesh, stats, W, H,
                                        samples_per_frame=1, chunk=256))
    assert len(frames) == 2
    assert all(f.shape == (W * H,) for f in frames)
    assert (frames[0] != 0).any()
    # the field halves between timesteps -> images differ
    assert not np.array_equal(frames[0], frames[1])

    # with the two-stage locate (one geometry-only map serves every
    # timestep): bit-identical frames
    from icon_dvr.models.finemap import build_finemap
    fm = build_finemap(loc, q.test12, k_cap)
    frames_fm = list(animate_fastq_sharded(q, [vq0, vq1], loc, k_cap, bands,
                                           tf, lp_for, mesh, stats, W, H,
                                           samples_per_frame=1, chunk=256,
                                           finemap=fm))
    for a, b in zip(frames_fm, frames):
        np.testing.assert_array_equal(a, b)
