"""The port's research drivers at toy sizes on the CPU: each one's JSON keys,
that it writes only to ``--out``, that no K1 failure falls back to another
trainer, and ``robustness_row`` against the JAX script's own output.

The drivers run here through the kernels' plain versions (``--device
cpu``), so their times are the host clock's and no device figure; on the
card ``chip_smoke.py``'s ``drivers`` phase runs them through the kernels.
"""

import importlib.util
import json

import pytest
import torch

from conftest import REPO_ROOT
from defensive_model_vae_tpu_torch.ops import _build
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft
from defensive_model_vae_tpu_torch.scripts import (grid_probe, hot_probe,
                                                   mint_provenance_probe, robustness_row,
                                                   run_baseline_configs, serve_latency)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes that
    would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _line(capsys, key):
    """The driver's one JSON line on stdout → its payload under ``key``."""
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    return json.loads(lines[0])[key]


def test_grid_probe_small(capsys, tmp_path):
    """Two seeds, three epochs: the five variants under JAX's keys, each
    with its seeds and cluster; the masked and static checks hold."""
    out_file = tmp_path / "grid.json"
    assert grid_probe.main(["--device", "cpu", "--seeds", "2", "--epochs", "3", "--reps", "1",
                            "--out", str(out_file)]) == 0
    res = _line(capsys, "grid_probe")
    assert json.loads(out_file.read_text()) == res
    assert set(res["variants"]) == set(grid_probe.VARIANTS)
    for v, r in res["variants"].items():
        assert {"best_s", "all_s", "us_per_epoch_seed", "seeds", "cluster"} <= set(r)
        assert len(r["all_s"]) == 1 and r["us_per_epoch_seed"] > 0
    assert res["variants"]["grid_s8"]["seeds"] == 1
    assert res["checks"]["static_params_bit_for_bit_grid"]
    assert res["checks"]["masked_bit_for_bit_grid"]
    assert res["checks"]["descent_factor"] == 1.0 and res["device"] == "cpu"


def test_run_baseline_configs_small(capsys, tmp_path):
    """Three epochs, no data root: configs 1-4 finite and descending, config
    5 JAX's skip string, nothing written without ``--out``."""
    before = set(tmp_path.iterdir())
    assert run_baseline_configs.main(["--device", "cpu", "--epochs", "3", "--conv-epochs", "3",
                                      "--data-root", str(tmp_path / "absent")]) == 0
    rep = _line(capsys, "baseline_configs")
    assert set(tmp_path.iterdir()) == before
    c1 = rep["config1_dense_sce1"]
    assert c1["final_loss"] < c1["loss_first"] and "plain" in c1["trainer"]
    c2 = rep["config2_four_scenarios"]
    assert set(c2["final_losses"]) == {"sce1", "sce2", "sce3", "sce4"}
    assert all(c2["final_losses"][k] < c2["first_losses"][k] for k in c2["final_losses"])
    assert c2["generated_shape"] == [38, 4, 10, 3] and c2["generated_finite"]
    c3 = rep["config3_conv_long_windows"]
    assert c3["loss_final"] < c3["loss_first"] and c3["window_shape"] == [50, 2]
    c4 = rep["config4_conditioned"]
    assert c4["corpus_size"] == 254 and c4["cond_dim"] == 7
    assert c4["final_loss"] < c4["loss_first"]
    assert rep["config5_end_to_end_sce2"] == "skipped (data root absent)"


def test_run_baseline_configs_raises_when_k1_fails(monkeypatch, tmp_path):
    """A failed K1 entry raises out of the driver: no scan-trainer fallback."""
    def broken(*args, **kwargs):
        raise RuntimeError("K1 launch failed: CUDA error 1")

    monkeypatch.setattr(tft, "fused_call", broken)
    with pytest.raises(RuntimeError, match="K1 launch failed"):
        run_baseline_configs.run(3, 3, str(tmp_path / "absent"), torch.device("cpu"))


def test_serve_latency_small(capsys, tmp_path):
    """4 steps, 2 reps, two clients: JAX's keys (tests/test_scripts.py:622),
    no error under load, both servers closed."""
    import threading

    out_file = tmp_path / "serve.json"
    threads = threading.active_count()
    assert serve_latency.main(["--device", "cpu", "--steps", "4", "--reps", "2",
                               "--concurrency", "2", "--load-requests", "2",
                               "--throughput-batch", "2", "--out", str(out_file)]) == 0
    data = _line(capsys, "serve_latency")
    assert json.loads(out_file.read_text()) == data
    assert data["config"]["steps"] == 4 and data["config"]["reps"] == 2
    for route in ("serve", "generate"):
        stats = data[route]
        assert stats["client_ms_median"] > 0
        assert stats["client_ms_median"] >= stats["server_ms_median"]
    assert data["serve_throughput"]["batch"] == 2
    assert data["serve_throughput"]["req_per_s_best"] > 0
    assert data["serve_throughput"]["npz_req_per_s_best"] > 0
    tail = data["serve_tail_under_load"]
    assert tail["concurrency"] == 2 and tail["requests"] == 4 and tail["errors"] == 0
    assert tail["p50_ms"] <= tail["p95_ms"] <= tail["p99_ms"] <= tail["max_ms"]
    assert tail["req_per_s"] > 0
    assert data["diverged_rows"] == 0
    assert data["total_request_rows"] == 2 * 2 + 4 + 3 * 2 * 2
    assert data["startup_s"] > 0 and data["backend"] == "cpu"
    assert threading.active_count() == threads


def test_hot_probe_small(capsys):
    """Two tiles, two epochs: the six variants, the split and its verdict."""
    assert hot_probe.main(["--device", "cpu", "--n", "32", "--tile", "16", "--epochs", "2",
                           "--reps", "1"]) == 0
    res = _line(capsys, "hot_probe")
    assert set(res["variants"]) == set(hot_probe.VARIANTS)
    assert res["variants"]["gen"]["mwindows_per_s"] is None
    assert all(res["variants"][v]["mwindows_per_s"] > 0 for v in hot_probe.VARIANTS
               if v != "gen")
    split = res["split_s"]
    assert split["verdict"] == "unresolved: one timed rep shows no spread"
    assert split["streaming"] == pytest.approx(split["hbm_over_packed"] - split["generation"])
    assert set(res["losses_first_last"]) == set(hot_probe.VARIANTS) - {"gen"}


@pytest.mark.parametrize("hbm, verdict", [((1.10, 1.11), "unresolved: hbm - packed is "
                                                         "within the reps' spread"),
                                          ((1.20, 1.21), "streaming")])
def test_hot_probe_split_verdict(hbm, verdict):
    """hbm − packed within the spread of either's reps is unresolved; above
    it, the larger of generation and streaming."""
    times = {"gen": [0.001, 0.002], "packed": [1.09, 1.10], "hbm": list(hbm),
             "prng": [1.1, 1.1], "hbm+dwT": [1.3, 1.3], "packed+dwT": [1.3, 1.3]}
    out = hot_probe.split(times)
    assert out["verdict"] == verdict
    assert out["reps_spread"] == pytest.approx(0.01)


def test_mint_provenance_probe_keys(capsys, monkeypatch, tmp_path):
    """With ``nvcc --version`` fixed: a comment line in a kernel source
    re-keys that library alone, a move of the checkout or a Python edit
    re-keys nothing, and the one absolute flag is Python's include path."""
    monkeypatch.setattr(_build, "nvcc_version", lambda: "nvcc: release 12.9 (fixed)\n")
    assert mint_provenance_probe.main(["--no-build", "--workdir",
                                       str(tmp_path / "work")]) == 0
    res = _line(capsys, "mint_provenance_probe")
    assert res["a_deterministic_across_loads"]
    assert res["comment_line_in_cu_rekeys"] == ["fused_scale"]
    assert res["checkout_path_rekeys"] == []
    assert res["comment_line_in_py_rekeys"] == []
    assert [f["flag"] for f in res["absolute_flags_in_key"]] == [_build.PY_HEADERS]
    assert not any(f["inside_checkout"] for f in res["absolute_flags_in_key"])
    assert set(res["keys_pristine"]) == set(_build.KERNELS)
    assert "decoy_builds" not in res and not (tmp_path / "work").exists()


def test_robustness_row_equals_the_jax_script():
    """The port's row is the JAX script's ``build()`` (loaded by path, so
    nothing is written) on the committed sweeps."""
    spec = importlib.util.spec_from_file_location("jax_robustness_row",
                                                  REPO_ROOT / "scripts" / "robustness_row.py")
    jrr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jrr)
    assert robustness_row.build() == jrr.build()


def test_robustness_row_prints_one_line_and_writes_only_out(capsys, tmp_path):
    out_file = tmp_path / "row.json"
    assert robustness_row.main(["--out", str(out_file)]) == 0
    row = _line(capsys, "robustness_row")
    assert json.loads(out_file.read_text()) == row
    assert set(row["scenarios"]) == {"sce1", "sce2", "sce3", "sce4"}
    assert row["scenarios"]["sce4"]["n_rows"] == 8
