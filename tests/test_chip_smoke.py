"""chip_smoke.py: its device contract on the CPU, its phases and
comparisons on toy scenes (the rehearsal of the on-card run), and the
item comparisons on the card (`gpu` marker)."""
import json

import jax
import numpy as np
import pytest

import chip_smoke as cs


def test_check_device_refuses_cpu():
    """No CPU path: a CPU device is refused before any phase runs."""
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(cs.NoAccelerator, match="no GPU"):
        cs.check_device(jax.devices())


def test_check_device_counts_cards():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"
    assert cs.check_device([Dev()]) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    with pytest.raises(cs.NoAccelerator, match="need 4 GPUs"):
        cs.check_device([Dev()], count=4)


def test_result_line_is_the_contract():
    line = cs.result_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                           "count": 4})
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 4}}')
    assert json.loads(line)["device"]["count"] == 4


def test_main_exits_nonzero_without_gpu(monkeypatch, capsys):
    """On the CPU main() stops at the device check: non-zero exit, no ok
    line (the card-only tests and nvidia-smi are stubbed out here)."""
    monkeypatch.setattr(cs, "run_gpu_tests", lambda: 0.0)
    monkeypatch.setattr(cs, "card_line", lambda: "none")
    assert cs.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out


def test_pick_pixels_covers_three_groups():
    W, H = 64, 48
    yy, xx = np.mgrid[0:H, 0:W]
    alpha = (np.hypot(yy - 24, xx - 32) < 20).astype(np.float32).ravel()
    pix = cs.pick_pixels(alpha, W, H, 16)
    assert len(pix) == 16 and len(set(pix)) >= 14
    assert all(alpha[p] > 0 for p in pix)
    r = [np.hypot(p // W - 24, p % W - 32) for p in pix]
    assert min(r) < 6 and max(r) > 18        # centre ... silhouette


def test_compare_woodcock_march_bounds():
    rng = np.random.default_rng(0)
    acc_m = np.concatenate([rng.uniform(0, 1, (400, 3)),
                            np.ones((400, 1))], 1).astype(np.float32)
    assert cs.compare_woodcock_march(acc_m + 0.01, acc_m).ok
    assert not cs.compare_woodcock_march(acc_m + [0.1, 0.1, 0.1, 0], acc_m).ok
    assert not cs.compare_woodcock_march(acc_m[:40], acc_m[:40]).ok


def test_smoke_phases_toy(tmp_path):
    """Phases a-d through apps/icon_rt.build() and every comparison, on
    an 80-cell scene at 32x18 — the CPU rehearsal of the on-card run."""
    phases, checks = cs.smoke(subdiv=1, layers=2, width=32, height=18,
                              out=str(tmp_path), oracle_subdiv=1,
                              oracle_n=2000, woodcock_spp=32,
                              rmse_size=(32, 18))
    assert [p.name[0] for p in phases] == ["a", "b", "c"]
    for p in phases:
        assert p.samples == (2 if p.name[0] == "b" else 16)
        assert p.first_s > 0 and p.steady_s > 0 and p.mray_full > 0
    assert [c.name for c in checks] == [
        "tf-edit round trip", "woodcock mean vs march",
        "quantized vs f32 march rmse", "march vs dense-scan oracle",
        "ae parity vs refimpl"]
    assert all(c.ok for c in checks), checks
    assert (tmp_path / "a.png").exists()


def test_sweep_toy(monkeypatch, capsys, tmp_path):
    """The lane-chunk sweep sets ops/fast.CHUNK per run and restores it."""
    from icon_dvr.ops import fast
    default = fast.CHUNK
    monkeypatch.setattr(cs, "CHUNKS", (64, 0))
    cs.sweep(out=str(tmp_path), subdiv=1, layers=2, width=32, height=18)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("sweep ")]
    assert [ln.split(":")[0] for ln in lines] == [
        "sweep a chunk 64", "sweep b chunk 64", "sweep c chunk 64",
        "sweep a chunk 0", "sweep b chunk 0", "sweep c chunk 0"]
    assert fast.CHUNK == default


def test_four_cards_toy():
    """The --four-cards paths on four of the virtual CPU devices."""
    checks = cs.four_cards(subdiv=1, layers=2, width=16, height=12,
                           samples=2, chunk=16)
    assert [c.name for c in checks] == ["4-tile quantized vs one card",
                                        "scene shard 2x2 vs one card"]
    assert all(c.ok for c in checks), checks


# -- the comparisons on the card ---------------------------------------------

@pytest.mark.gpu
def test_gpu_march_matches_oracle(gpu_device):
    """The stated configuration: R2B4 (20,480 columns) x 16 layers, 16
    pixels of a 1920x1080 grid.  (Small scenes whose quantized codes sit
    on a LUT knot differ by a LUT step on the card; see PERF.md.)"""
    c = cs.compare_march_oracle(5, 16, 1920, 1080)
    assert c.ok, c


@pytest.mark.gpu
def test_gpu_woodcock_mean_vs_march(gpu_device):
    """S=128 quantized Woodcock mean vs the quantized march, on the card
    (test_march.py's bounds; the full-size run is chip_smoke.py's own)."""
    import jax.numpy as jnp

    from icon_dvr.ops.fastq import render_frame_fast_q
    from icon_dvr.ops.march import render_frame_march_q
    from icon_dvr.ops.render import alloc_frame

    W, H = 192, 108
    _, _, q, loc, k_cap, bands, tf, lp, _ = cs.quantized_scene(3, 8, W, H)
    lp0 = lp._replace(accum_id=jnp.int32(0))
    acc_m, _ = render_frame_march_q(q, loc, k_cap, bands, tf, lp0,
                                    *alloc_frame(W, H), width=W, height=H,
                                    chunk=W * H)
    acc_w, _ = render_frame_fast_q(q, loc, k_cap, bands, tf, lp0,
                                   *alloc_frame(W, H), width=W, height=H,
                                   chunk=W * H, samples=128)
    c = cs.compare_woodcock_march(np.asarray(acc_w), np.asarray(acc_m))
    assert c.ok, c


@pytest.mark.gpu
def test_gpu_rmse_q(gpu_device):
    c = cs.compare_rmse_q(3, 8, 192, 108)
    assert c.ok, c


@pytest.mark.gpu
def test_gpu_parity_ae(gpu_device):
    c = cs.compare_parity_ae()
    assert c.ok, c
