"""End-to-end CLI application tests (CPU, tiny frames)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "apps"))

import icon_rt  # noqa: E402

from icon_dvr.data import icfile, synthetic  # noqa: E402
from icon_dvr.utils.png import read_png  # noqa: E402


def _run(args):
    rc = icon_rt.main(args)
    assert rc == 0


def test_app_synthetic_fast(tmp_path):
    out = str(tmp_path / "fast")
    _run(["--synthetic", "1:3", "--sample-limit", "3", "--size", "32", "32",
          "-o", out])
    img = read_png(out + ".png")
    assert img.shape == (32, 32, 4)
    assert (img[..., 3] > 0).any()


def test_app_ic_file_roundtrip(tmp_path):
    ds = synthetic.icosphere(subdivisions=1, num_layers=2)
    ic = str(tmp_path / "scene.ic")
    icfile.write_ic(ic, ds)
    out = str(tmp_path / "scene")
    _run([ic, "--sample-limit", "2", "--size", "24", "24", "-o", out,
          "--num-cells", "40"])
    assert os.path.exists(out + ".png")


def test_app_accel_raygen(tmp_path):
    out = str(tmp_path / "accel")
    _run(["--synthetic", "1:2", "--sample-limit", "2", "--size", "16", "16",
          "-o", out, "--raygen", "accel", "--accel-mode", "grid"])
    img = read_png(out + ".png")
    assert (img[..., 3] > 0).any()


def test_app_cubql_mode(tmp_path):
    """-mode 2 = wedge Newton sampling (reference cuBQL mode)."""
    out = str(tmp_path / "cubql")
    _run(["--synthetic", "1:2", "--sample-limit", "1", "--size", "12", "12",
          "-o", out, "-mode", "2", "--accel-mode", "grid"])
    assert os.path.exists(out + ".png")


def test_app_xf_roundtrip(tmp_path):
    """--xf load path: render with a custom transfer function."""
    from icon_dvr.pipeline.xf import save_xf
    xf = str(tmp_path / "t.xf")
    lut = np.tile(np.array([[1, 0, 0, 1.0]], np.float32), (8, 1))
    save_xf(xf, 1.0, (0.0, 1.0), (0.0, 1.0), lut)
    out = str(tmp_path / "red")
    # presented PNGs composite over --bgcolor (alpha forced opaque, like
    # the reference's cleared window) — use a black clear so traced
    # coverage is detectable by brightness
    _run(["--synthetic", "1:2", "--sample-limit", "2", "--size", "24", "24",
          "-o", out, "--xf", xf, "--bgcolor", "0", "0", "0"])
    img = read_png(out + ".png")
    cov = img[..., :3].sum(axis=-1) > 0
    assert cov.any()
    # fully red, fully opaque TF -> covered pixels are red-ish
    assert img[cov][:, 0].mean() > img[cov][:, 1].mean() + 50


def test_app_preview_tier(tmp_path):
    """Preview contract: with --preview N, the first
    frame after a reset renders at 1/N res and is presented upscaled in
    natural order; samples_per_launch drops to 0 for that launch so the
    full-res sample 0 still renders next."""
    out = str(tmp_path / "prev")
    pl = icon_rt.build(["--synthetic", "1:3", "--sample-limit", "2",
                        "--size", "32", "32", "-o", out, "--preview", "4"])
    pl.launch()                        # frame 0: full res (no reset yet)
    assert pl.samples_per_launch >= 1
    pl.reset_accumulation()            # a camera/TF-style reset
    assert pl.preview_pending
    pl.launch()                        # preview frame
    assert not pl.preview_pending
    assert pl.samples_per_launch == 0  # accumulation not advanced
    fb = np.asarray(pl._last_fb)
    assert fb.shape == (32 * 32,)      # presented full-size (upscaled)
    # upscaled 4x4 blocks are constant
    img = fb.reshape(8, 4, 8, 4)
    assert (img == img[:, :1, :, :1]).all()
    pl.launch()                        # full-res sample 0 resumes
    assert pl.samples_per_launch >= 1


def test_app_march_raygen(tmp_path):
    """--march: the deterministic integrator drives the batch render and
    converges in very few passes (the PNG must match the Woodcock
    output's coverage)."""
    out = str(tmp_path / "march")
    _run(["--synthetic", "1:3", "--sample-limit", "2", "--size", "32", "32",
          "-o", out, "--march"])
    img = read_png(out + ".png")
    assert (img[..., 3] > 0).any()
    out_q = str(tmp_path / "marchq")
    _run(["--synthetic", "1:3", "--sample-limit", "2", "--size", "32", "32",
          "-o", out_q, "--march", "--quantized"])
    assert os.path.exists(out_q + ".png")
