"""Runtime mode hot-swapping: raygen / sampler / accel toggles flipped
mid-accumulation must swap the render path AND reset accumulation
(ref: icon_rt/hostCode.cu:138-199 toggleRayGen/toggleMode/toggleAccelMode,
UI at :843-857).

Dispatch is asserted two ways: by spying on which render function actually
runs, and by image differences under a SEMI-TRANSPARENT transfer function
(with the default near-opaque TF all estimators collide in the same
piecewise-constant layer and the 8-bit images can be identical)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "apps"))

import icon_rt  # noqa: E402

from icon_dvr.pipeline.xf import save_xf  # noqa: E402
from icon_dvr.utils.png import read_png  # noqa: E402


def _frame(pl, out):
    """Render one progressive frame and capture the presented image."""
    pl.launch()
    pl.present()
    return read_png(out + ".png").astype(np.int32)


@pytest.fixture()
def spy(monkeypatch):
    """Record which render path each frame dispatches to."""
    import icon_dvr.ops.fast as fast_mod
    import icon_dvr.ops.render as render_mod
    calls = []

    def wrap(mod, name):
        orig = getattr(mod, name)

        def wrapper(*a, **k):
            calls.append(name)
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    wrap(fast_mod, "render_frame_fast")
    wrap(render_mod, "render_frame_accel")
    wrap(render_mod, "render_frame_ae")
    return calls


def _build(tmp_path, *extra):
    out = str(tmp_path / "t")
    # optically THIN blue->red ramp (shell is ~30 ud thick, so alpha 0.02
    # gives per-ray optical depth ~1): collision outcomes and layers then
    # genuinely differ between estimators/paths, instead of every path
    # colliding in the same opaque outermost layer
    xf = str(tmp_path / "t.xf")
    lut = np.stack([np.linspace(0, 1, 16, dtype=np.float32),
                    np.zeros(16, np.float32),
                    np.linspace(1, 0, 16, dtype=np.float32),
                    np.full(16, 0.02, np.float32)], axis=1)
    save_xf(xf, 1.0, (0.0, 1.0), (0.0, 1.0), lut)
    pl = icon_rt.build(["--synthetic", "1:3", "--sample-limit", "99",
                        "--size", "24", "24", "-o", out, "--xf", xf, *extra])
    return pl, out


def test_raygen_toggle_changes_image_and_resets(tmp_path, spy):
    pl, out = _build(tmp_path)
    img_fast = _frame(pl, out)
    assert (img_fast[..., 3] > 0).any()
    assert spy[-1] == "render_frame_fast"
    assert pl.is_running()
    # accumulating: the fast raygen renders a BATCH of in-lane samples per
    # launch (apps/icon_rt.py --samples), so one launch advances frame_id
    # by the batch size
    assert pl.frame_id == pl.samples_per_launch >= 1

    pl.set_ui_param("Raygen", "ae")
    assert pl.frame_id == 0          # toggle reset accumulation
    img_ae = _frame(pl, out)
    assert spy[-1] == "render_frame_ae"
    assert (img_ae[..., 3] > 0).any()
    assert (img_fast != img_ae).any()

    pl.set_ui_param("Raygen", "accel")
    img_accel = _frame(pl, out)
    assert spy[-1] == "render_frame_accel"
    assert (img_accel[..., 3] > 0).any()

    # back to fast: buffer layout swaps back to permuted order and the
    # presented image must still be coherent (same coverage footprint)
    pl.set_ui_param("Raygen", "fast")
    img_fast2 = _frame(pl, out)
    assert spy[-1] == "render_frame_fast"
    cov1 = img_fast[..., 3] > 0
    cov2 = img_fast2[..., 3] > 0
    assert (cov1 == cov2).mean() > 0.9


def test_accel_mode_toggle(tmp_path, spy):
    pl, out = _build(tmp_path, "--raygen", "accel")
    img_sphere = _frame(pl, out)
    assert spy[-1] == "render_frame_accel"
    pl.set_ui_param("Accel mode", "grid")
    assert pl.frame_id == 0
    img_grid = _frame(pl, out)
    assert spy[-1] == "render_frame_accel"
    assert (img_grid[..., 3] > 0).any()
    # different majorant segmentation -> different per-sample collisions
    assert (img_sphere != img_grid).any()


def test_sampler_mode_toggle(tmp_path, spy):
    pl, out = _build(tmp_path, "--raygen", "accel")
    img_locator = _frame(pl, out)
    pl.set_ui_param("Sampler mode", 2)   # cuBQL mode -> Newton wedge sampler
    assert pl.frame_id == 0
    img_wedge = _frame(pl, out)
    assert spy[-1] == "render_frame_accel"
    assert (img_wedge[..., 3] > 0).any()
    # wedge interpolates per-vertex scalars; locator is piecewise constant
    assert (img_locator != img_wedge).any()


def test_unit_distance_toggle_changes_noise(tmp_path):
    pl, out = _build(tmp_path)
    img_a = _frame(pl, out)
    ud = None
    for p in pl.ui_params:
        if p.name == "Unit distance":
            ud = p.get()
    pl.set_ui_param("Unit distance", ud * 3.0)
    img_b = _frame(pl, out)
    assert (img_a != img_b).any()


def test_accel_active_toggle_falls_back_to_ae(tmp_path, spy):
    """'Use naive accel' off routes the accel raygen to the AE path
    (reference accel on/off toggle semantics)."""
    pl, out = _build(tmp_path, "--raygen", "accel")
    _frame(pl, out)
    assert spy[-1] == "render_frame_accel"
    pl.set_ui_param("Use naive accel", False)
    _frame(pl, out)
    assert spy[-1] == "render_frame_ae"
