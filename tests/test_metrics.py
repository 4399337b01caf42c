import numpy as np

from icon_dvr.utils.color import make_rgba
from icon_dvr.utils.metrics import (PhaseTimer, accum_rmse, image_rmse,
                                    within_tonemap_lsb)

import jax.numpy as jnp


def _pack(rgb):
    return np.asarray(make_rgba(jnp.asarray(rgb, jnp.float32)))


def test_image_rmse():
    a = _pack(np.tile([[0.5, 0.5, 0.5, 1.0]], (64, 1)))
    assert image_rmse(a, a) == 0.0
    b = _pack(np.tile([[0.5 + 1.5 / 256, 0.5, 0.5, 1.0]], (64, 1)))
    r = image_rmse(a, b)
    assert 0.0 < r < 1.0  # ~1 LSB in one of four channels


def test_within_tonemap_lsb():
    a = _pack(np.tile([[0.25, 0.5, 0.75, 1.0]], (100, 1)))
    b = _pack(np.tile([[0.25 + 0.9 / 256, 0.5, 0.75, 1.0]], (100, 1)))
    assert within_tonemap_lsb(a, b, tolerance_lsb=1)
    c = _pack(np.tile([[0.25 + 8 / 256, 0.5, 0.75, 1.0]], (100, 1)))
    assert not within_tonemap_lsb(a, c, tolerance_lsb=1)


def test_accum_rmse():
    a = np.zeros((16, 4), np.float32)
    b = np.full((16, 4), 0.1, np.float32)
    assert abs(accum_rmse(a, b) - 0.1) < 1e-6


def test_phase_timer():
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("frame"):
            pass
    assert t.count["frame"] == 3
    assert t.fps("frame") > 0
    assert "frame" in t.report()
