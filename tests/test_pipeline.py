"""Pipeline layer: .xf IO, TFE editing semantics, frame-loop rules, CLI."""
import os
import sys

import numpy as np

from icon_dvr.pipeline.pipeline import Pipeline, TransfuncState
from icon_dvr.pipeline.tfe import TFE, AlphaEditor, MouseEvent
from icon_dvr.pipeline.xf import load_xf, save_xf


def test_xf_roundtrip(tmp_path):
    p = str(tmp_path / "t.xf")
    lut = np.random.RandomState(0).rand(17, 4).astype(np.float32)
    assert save_xf(p, 0.7, (1.0, 5.0), (0.1, 0.9), lut)
    got = load_xf(p)
    assert got is not None
    op, vr, rr, lut2 = got
    assert op == np.float32(0.7)
    np.testing.assert_array_equal(vr, np.array([1.0, 5.0], np.float32))
    np.testing.assert_array_equal(rr, np.array([0.1, 0.9], np.float32))
    np.testing.assert_array_equal(lut2, lut)
    # binary layout: 24-byte header + 16 bytes per entry
    assert os.path.getsize(p) == 24 + 16 * 17


def test_xf_invalid():
    assert load_xf("/nonexistent/file.xf") is None


def test_alpha_editor_freehand_interpolation():
    ed = AlphaEditor(canvas=(100, 100))
    ed.set_lut(np.tile(np.array([[1, 0, 0, 0.0]], np.float32), (100, 1)))
    assert ed.lut_updated()
    # press at x=10 (alpha .99), fast drag to x=20: skipped columns filled
    ed.handle_mouse_event(MouseEvent(10, 99, MouseEvent.LEFT, MouseEvent.PRESS))
    ed.handle_mouse_event(MouseEvent(20, 0, MouseEvent.LEFT, MouseEvent.MOTION))
    ed.handle_mouse_event(MouseEvent(20, 0, MouseEvent.NONE, MouseEvent.RELEASE))
    assert ed.lut_updated()
    lut = ed.get_lut()
    assert lut[10, 3] > 0.9
    assert lut[20, 3] == 0.0
    mid = lut[11:20, 3]
    assert np.all(np.diff(mid) < 0)  # monotone interpolation across the gap
    assert not ed.drawing


def test_tfe_dirty_flags():
    tfe = TFE()
    tfe.init_from(1.0, (0, 1), (0, 1),
                  np.tile(np.array([[0, 0, 1, 0.5]], np.float32), (8, 1)))
    assert not tfe.lut_updated() and not tfe.range_updated()
    tfe.set_range(2.0, 3.0)
    assert tfe.range_updated()
    assert not tfe.range_updated()  # cleared by harvest
    tfe.set_opacity_scale(0.25)
    assert tfe.scale_updated()


def test_tfe_rasterize():
    tfe = TFE(canvas=(64, 32))
    tfe.init_from(1.0, (0, 1), (0, 1),
                  np.array([[1, 0, 0, 1.0], [0, 0, 1, 0.0]], np.float32))
    tfe.set_histogram(np.arange(16))
    img = tfe.rasterize()
    assert img.shape == (32, 64, 4)
    assert img[..., :3].max() > 0


def test_pipeline_cli_and_loop():
    pl = Pipeline(["--sample-limit", "3", "--size", "8", "4",
                   "--bgcolor", "0.5", "0.5", "0.5"])
    pl.set_frame(999, 999)  # overridden by --size
    assert (pl.width, pl.height) == (8, 4)
    assert pl.sample_limit == 3
    from icon_dvr.ops.camera import Camera
    cam = Camera()
    pl.set_camera(cam)
    pl.set_transfunc(TransfuncState(
        np.array([[1, 0, 0, 1], [0, 1, 0, 0]], np.float32)))
    assert pl.transfunc.size == 300  # batch resample parity
    frames = []
    pl.set_render_fn(lambda fid: (frames.append(fid),
                                  np.zeros(8 * 4, np.uint32))[1])
    # loop runs exactly sample_limit frames like the reference batch mode
    while True:
        pl.launch()
        if not pl.is_running():
            break
    assert frames == [0, 1, 2]
    # TF edit resets accumulation
    pl2 = Pipeline(["--sample-limit", "100"])
    pl2.set_camera(cam)
    pl2.set_transfunc(TransfuncState(
        np.array([[1, 0, 0, 1], [0, 1, 0, 0]], np.float32)))
    pl2.set_render_fn(lambda fid: np.zeros(1, np.uint32))
    pl2.launch()
    assert pl2.is_running()
    assert pl2.frame_id == 1
    pl2.tfe.set_range(0.2, 0.8)
    pl2.launch()
    assert pl2.is_running()
    assert pl2.frame_id == 0  # reset by the TFE edit
    assert pl2.transfunc.value_range.tolist() == [np.float32(0.2), np.float32(0.8)]


def test_pipeline_camera_cli_override():
    pl = Pipeline(["--camera", "1", "2", "3", "0", "0", "0", "0", "0", "1",
                   "-fovy", "45"])
    from icon_dvr.ops.camera import Camera
    cam = Camera()
    pl.set_camera(cam)
    np.testing.assert_allclose(cam.position, [1, 2, 3], atol=1e-6)
    assert abs(cam.get_fovy_degrees() - 45.0) < 1e-4


def test_pipeline_save_transfunc(tmp_path):
    pl = Pipeline([])
    pl.set_transfunc(TransfuncState(
        np.array([[1, 0, 0, 1], [0, 1, 0, 0]], np.float32), (2.0, 4.0)))
    p = str(tmp_path / "s.xf")
    assert pl.save_transfunc(p)
    got = load_xf(p)
    assert got is not None and got[3].shape[0] == 300


def test_pipeline_key_handlers(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pl = Pipeline([], name="keys")
    from icon_dvr.ops.camera import Camera
    cam = Camera()
    cam.set_orientation([1, 2, 3], [0, 0, 0], [0, 0, 1], cam.fovy)
    pl.set_camera(cam)
    pl.set_transfunc(TransfuncState(
        np.array([[1, 0, 0, 1], [0, 1, 0, 0]], np.float32)))
    # Shift+C prints reproducible camera CLI args
    assert pl.handle_key("c", shift=True)
    out = capsys.readouterr().out
    assert "--camera" in out and "-fovy" in out
    # Shift+T writes <name>.xf
    assert pl.handle_key("t", shift=True)
    assert os.path.exists("keys.xf")
    assert load_xf("keys.xf") is not None
    # unconsumed keys go to the app hook
    seen = []
    pl.set_key_down_handler(lambda k, s: (seen.append((k, s)), True)[1])
    assert pl.handle_key("x")
    assert seen == [("x", False)]


def test_pipeline_multiple_transfuncs():
    """Multiple TF slots with independent editor tabs
    (ref: pipeline.cu:456-478, 645-668)."""
    pl = Pipeline(["--sample-limit", "10"])
    from icon_dvr.ops.camera import Camera
    pl.set_camera(Camera())
    lut_a = np.tile(np.array([[1, 0, 0, 1.0]], np.float32), (4, 1))
    lut_b = np.tile(np.array([[0, 0, 1, 0.5]], np.float32), (4, 1))
    updates = []
    pl.set_transfunc_update_handler(lambda tf, i: updates.append(i))
    pl.set_transfunc(TransfuncState(lut_a), index=0)
    pl.set_transfunc(TransfuncState(lut_b), index=1)
    assert pl.transfunc_valid(0) and pl.transfunc_valid(1)
    assert updates == [0, 1]
    # editing the active tab only touches its own slot
    pl.tf_index = 1
    pl.tfe.set_opacity_scale(0.25)
    pl.set_render_fn(lambda fid: np.zeros(1, np.uint32))
    pl.launch()
    assert pl.is_running()
    assert pl.transfuncs[1].opacity == 0.25
    assert pl.transfuncs[0].opacity == 1.0
    assert pl.frame_id == 0  # edit reset accumulation
    assert updates[-1] == 1


def test_bgcolor_composite(tmp_path):
    """--bgcolor fills never-hit pixels at presentation, like the
    reference's cleared canvas (ref: common/pipeline.cu:721,760)."""
    from icon_dvr.ops.render import fb_to_image

    pl = Pipeline(["--bgcolor", "0.25", "0.5", "1.0"], name=str(tmp_path / "p"))
    np.testing.assert_allclose(pl.bgcolor, [0.25, 0.5, 1.0])
    fb = np.zeros(4, np.uint32)
    fb[1] = 0xFF00_00FF          # alpha=255, red=255: a hit pixel
    img = fb_to_image(fb, 2, 2, bgcolor=pl.bgcolor)
    # sRGB encode of the linear bgcolor, rounded to u8
    exp = np.round(
        (1.055 * np.array([0.25, 0.5, 1.0]) ** (1 / 2.4) - 0.055) * 255)
    np.testing.assert_array_equal(img[0, 0, :3], exp.astype(np.uint8))
    np.testing.assert_array_equal(img[0, 1, :3], [255, 0, 0])  # hit kept
    assert (img[..., 3] == 255).all()
    # composite flows through the batch present path
    pl.width = pl.height = 2
    img2 = None

    def spy(path, arr):
        nonlocal img2
        img2 = arr
        return True

    import icon_dvr.pipeline.pipeline as plmod
    orig = plmod.write_png
    plmod.write_png = spy
    try:
        pl.write_frame(fb)
    finally:
        plmod.write_png = orig
    np.testing.assert_array_equal(img2, img)
