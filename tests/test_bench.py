"""bench.py row functions run end-to-end at toy shapes (CPU).

The benchmark runs unattended on the GPU; a shape/keyword regression there
would otherwise only surface on the card.  This exercises both tiers' full row
logic — scene build, render step, median windows, TF-edit and TFE-stroke timing
— at a tiny framebuffer and asserts the row contract bench's _emit formats."""
import numpy as np
import pytest

import bench


ROW_KEYS = {"cells", "framing", "coverage", "mray_full", "mray_traced",
            "fps", "fps1", "spread", "tf_edit_s"}


@pytest.fixture()
def tiny_frame(monkeypatch):
    monkeypatch.setattr(bench, "WIDTH", 64)
    monkeypatch.setattr(bench, "HEIGHT", 36)


def test_bench_row_f32(tiny_frame):
    r = bench.bench_row(subdiv=1, num_layers=2, iters=1, framing="closeup",
                        chunk=64, spr=4, spp=2)
    assert ROW_KEYS <= set(r)
    assert r["coverage"] > 0.3          # closeup framing covers the globe
    assert r["mray_full"] > 0 and r["tf_edit_s"] > 0


def test_bench_row_quantized(tiny_frame, monkeypatch, tmp_path):
    # keep the locator npz cache out of the repo-level cache dir
    from icon_dvr.data import bigscene
    monkeypatch.setattr(bigscene, "_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("BENCH_FINEMAP", "2")
    r = bench.bench_row_q(subdiv=1, num_layers=2, iters=1,
                          framing="closeup", chunk=64, spr=4, spp=2)
    assert (ROW_KEYS | {"tf_stroke_s"}) <= set(r)
    assert r["framing"].endswith("/quantized")
    assert r["coverage"] > 0.3
    assert r["tf_stroke_s"] > 0


def test_bench_row_quantized_lod(tiny_frame, monkeypatch, tmp_path):
    """BENCH_LOD renders the mip tier (subdiv-1 geometry, pooled subdiv-2
    field) and tags the row's framing with the level."""
    from icon_dvr.data import bigscene
    monkeypatch.setattr(bigscene, "_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("BENCH_FINEMAP", "2")
    monkeypatch.setenv("BENCH_LOD", "1")
    r = bench.bench_row_q(subdiv=2, num_layers=2, iters=1,
                          framing="viewall", chunk=64, spr=4, spp=2)
    assert r["framing"].endswith("/quantized+lod1")
    assert r["cells"] == 20 * 4 ** 2    # reports the FINE scene identity
    assert r["coverage"] > 0


def test_run_row_prints_benchrow(tiny_frame, monkeypatch, capsys):
    """Child/parent subprocess contract: `--row` prints a BENCHROW line the
    parent's parser recovers verbatim, with the device it ran on (rows
    run in subprocesses so each group starts with the card's memory
    free)."""
    fake = dict(cells=7, framing="closeup", coverage=0.5, mray_full=1.0,
                mray_traced=0.5, fps=1.0, spread=0.0, tf_edit_s=0.1)
    dev = bench.device_info("cpu")
    assert dev["platform"] == "cpu" and dev["count"] >= 1
    want = dict(fake, device=dev)
    monkeypatch.setattr(bench, "bench_row",
                        lambda *a, **k: fake)
    bench._run_row("r2b4_closeup", platform="cpu")
    out = capsys.readouterr().out
    assert bench._parse_row_output(out.encode()) == {"r2b4_closeup": want}
    assert bench._parse_row_output(b"no row here\n") == {}
    # multi-row groups: one named line per completed row
    monkeypatch.setattr(bench, "bench_row_q", lambda *a, **k: fake)
    bench._run_row("r2b4_closeup,r2b8q_closeup", platform="cpu")
    out = capsys.readouterr().out
    assert bench._parse_row_output(out.encode()) == {
        "r2b4_closeup": want, "r2b8q_closeup": want}
    # a line cut short by a killed child is skipped, not fatal
    assert bench._parse_row_output(
        b'BENCHROW a {"cells": 1}\nBENCHROW b {"cel\nBENCHROW c\n') == {
        "a": {"cells": 1}}
    # legacy nameless line still parses
    assert bench._parse_row_output(
        b'BENCHROW {"cells": 1}\n') == {None: {"cells": 1}}


def test_emit_formats_all_rows(capsys):
    bench.RESULTS.clear()
    bench.RESULTS["a_viewall"] = dict(
        cells=1, framing="viewall", coverage=0.04, mray_full=94.0,
        mray_traced=4.4, fps=45.0, spread=0.02, tf_edit_s=0.3)
    bench.RESULTS["b_closeup"] = dict(
        cells=2, framing="closeup/quantized", coverage=0.55, mray_full=8.0,
        mray_traced=5.0, fps=4.0, spread=0.05, tf_edit_s=0.7,
        tf_stroke_s=0.1)
    try:
        bench.HEADLINE, old = "b_closeup", bench.HEADLINE
        bench._emit()
    finally:
        bench.HEADLINE = old
        bench.RESULTS.clear()
    out = capsys.readouterr().out
    import json
    line = json.loads(out.strip().splitlines()[-1])
    assert line["value"] == 8.0 and line["unit"] == "Mray/s"
    # low-coverage row leads with traced; stroke metric present
    assert "4.4 traced / 94.0 full" in line["metric"]
    assert "stroke 0.1s" in line["metric"]


def test_bench_row_ic(tiny_frame, monkeypatch, tmp_path):
    """Reference-format row: NetCDF -> convert_icon
    -> .ic -> quantized render with finemap, at toy scale."""
    monkeypatch.setattr(bench, "IC_CACHE_DIR", str(tmp_path))
    r = bench.bench_row_ic(subdiv=2, num_layers=4, iters=1,
                           framing="closeup", chunk=64, spr=4, spp=2)
    assert (ROW_KEYS | {"tf_preview_s"}) <= set(r)
    assert r["framing"].startswith("closeup/ic-quantized")
    assert r["coverage"] > 0.3
    # the .ic product is cached and re-read on the second call
    r2 = bench.bench_row_ic(subdiv=2, num_layers=4, iters=1,
                            framing="viewall", chunk=64, spr=4, spp=2)
    assert r2["framing"].startswith("viewall/ic-quantized")
    assert r2["coverage"] > 0


def test_bench_rmse_q(tiny_frame):
    """Deterministic quantization-error metric:
    march-vs-march RMSE between the tiers, zero MC noise."""
    r = bench._rmse_q_vs_f32(2, 4, Wr=64, Hr=36)
    assert np.isfinite(r)
    assert 0.0 <= r < 0.06, r


def test_bench_row_march(tiny_frame, monkeypatch, tmp_path):
    """March row: converged frames/s + edit-to-converged latency."""
    from icon_dvr.data import bigscene
    monkeypatch.setattr(bigscene, "_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("BENCH_FINEMAP", "2")
    r = bench.bench_row_m(subdiv=1, num_layers=2, iters=1,
                          framing="closeup", chunk=64, spr=4, spp=1)
    assert r["framing"] == "closeup/march"
    assert r["coverage"] > 0.3
    assert r["fps"] > 0 and r["tf_edit_s"] > 0


def test_bench_row_ic_march(tiny_frame, monkeypatch, tmp_path):
    """ic-march row: converged frames on the reference-format scene."""
    monkeypatch.setattr(bench, "IC_CACHE_DIR", str(tmp_path))
    r = bench.bench_row_icm(subdiv=2, num_layers=4, iters=1,
                            framing="closeup", chunk=64, spr=4, spp=1)
    assert r["framing"].startswith("closeup/ic-march")
    assert r["coverage"] > 0.3
    assert r["fps"] > 0


def test_row_child_refuses_cpu():
    """A bench child times nothing on the CPU: the device check raises
    before any row runs."""
    with pytest.raises(RuntimeError, match="need a gpu device"):
        bench.device_info("gpu")
    with pytest.raises(RuntimeError):
        bench._run_row("r2b4_closeup")


def test_row_groups_consistent():
    """Group registry sanity: no stale names, headline first, and every
    ALL_ROWS entry reachable (ungrouped rows are auto-appended as solo
    children by main())."""
    names = {r[0] for r in bench.ALL_ROWS}
    grouped = [n for g in bench.ROW_GROUPS for n in g]
    assert set(grouped) <= names
    assert len(grouped) == len(set(grouped))   # no row in two groups
    assert bench.ROW_GROUPS[0] == ["r2b9q_closeup"]   # headline first
