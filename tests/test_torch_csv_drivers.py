"""The port's last four research drivers (``seed_sweep``,
``multiseed_validate``, ``stage_timings``, ``dnda_drift_probe``) against
the JAX package's scripts, on the CPU.

Their pure functions equal JAX's on the same inputs; the chunked resume of
``multiseed_validate`` runs with fakes, as ``tests/test_scripts.py:442``;
each driver's ``main`` runs at a tiny depth on episode trees written from
the committed windows (``scripts/episodes.py``) and on SUT episodes written
back from committed traces, and writes JSON with the top-level keys JAX's
script writes on the same data.  The drivers run here through the
kernels' plain versions (``--device cpu``): their times are the host
clock's, no device figure.
"""

import functools
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from defensive_model_vae_tpu_torch import scenarios
from defensive_model_vae_tpu_torch.scripts import (dnda_drift_probe, episodes,
                                                   multiseed_validate, seed_sweep,
                                                   stage_timings)
from defensive_model_vae_tpu_torch.scripts._timing import jittered_sut_copy
from test_torch_pipeline import BANNED, PORT, _imports

CKPTS = str(REPO_ROOT / "results" / "checkpoints")
TRACES = REPO_ROOT / "results" / "GeneratedData"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes that
    would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name, monkeypatch=None):
    """The JAX package's ``scripts/<name>.py``, loaded by path; its hash-seed
    re-exec and persistent cache switched off, as tests/test_scripts.py does."""
    if monkeypatch is not None:
        import defensive_model_vae_tpu.utils.cache as cache_mod

        monkeypatch.setattr(cache_mod, "ensure_deterministic_hash_seed", lambda: None)
        monkeypatch.setattr(cache_mod, "enable_persistent_cache", lambda: None)
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  REPO_ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _line(capsys, key):
    """The driver's one JSON line on stdout → its payload under ``key``."""
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    return json.loads(lines[0])[key]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("episodes")
    episodes.write_fixture_trees(str(root), ["sce2"])
    return str(root)


@pytest.fixture(scope="module")
def sut_dir(tmp_path_factory):
    """Four written episodes, one a scenario, and two episodes with the first
    committed trace of sce1 and of sce3 written back, named as the scoring
    driver expects: ``<model>_<town>_<trial>.csv``."""
    from defensive_model_vae_tpu_torch.sut import (expected_csv_name, parse_tracked_npy_name,
                                                   writeback_npy_to_csv)

    root = tmp_path_factory.mktemp("sut")
    src, out = root / "src", root / "score"
    out.mkdir()
    for key in ("sce1", "sce2", "sce3", "sce4"):
        sce = scenarios.get(key)
        paths = episodes.write_episodes(np.load(sce.fixture_windows)[:2], key,
                                        str(root / "episodes"))
        shutil.copy(paths[0], out / f"EP_{sce.town}_1.csv")
        if key in ("sce1", "sce3"):
            name = sorted(f for f in os.listdir(TRACES)
                          if f.startswith(f"tracked_trajectory_{key}_"))[0]
            (src / sce.town).mkdir(parents=True)
            shutil.copy(paths[1], src / sce.town / expected_csv_name(
                *parse_tracked_npy_name(name)))
            wb = writeback_npy_to_csv(TRACES / name, src, root / "def")
            shutil.copy(wb, out / f"DEF_{sce.town}_1.csv")
    return str(out)


# ---------------------------------------------------------------------------
# the pure functions, equal to JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["0:4", "59:61,29,13", "7", "3:3,1", "0:70"])
def test_parse_seed_spec_equals_jax(spec):
    assert seed_sweep.parse_seed_spec(spec) == _jax_script("seed_sweep").parse_seed_spec(spec)


def _means(**kw):
    return dict({m: 0.9 for m in seed_sweep.METRICS}, **kw)


@pytest.mark.parametrize("means", [
    _means(),
    _means(velocity_js_divergence=0.99),
    _means(surface_rmse_with_zeros=1.3),
    _means(rmse_frequency_trajcount=float("nan")),
    _means(surface_rmse_no_zeros=None),          # jsonable's null
    _means(velocity_js_divergence=float("inf")),
])
def test_score_candidate_equals_jax(means):
    """Maximin over relative margins; a non-finite or null mean ranks last."""
    jss = _jax_script("seed_sweep")
    pub = {m: 1.0 + 0.5 * i for i, m in enumerate(seed_sweep.METRICS)}
    got = seed_sweep.score_candidate(means, pub)
    assert got == jss.score_candidate(means, pub)
    if not all(v is not None and np.isfinite(v) for v in means.values()):
        assert got[1] == float("-inf")
    assert seed_sweep.METRICS == jss.METRICS


def test_rank_candidates_equals_jax():
    rows = [{"train_seed": s, "beats_published": b, "worst_margin": w}
            for s, b, w in ((0, 4, 0.02), (1, 3, 0.5), (2, 4, 0.1), (3, 4, float("-inf")),
                            (4, 0, -0.3), (5, 4, 0.1))]
    got = seed_sweep.rank_candidates(rows)
    assert got == _jax_script("seed_sweep").rank_candidates(rows)
    assert [r["train_seed"] for r in got] == [2, 5, 0, 3, 1, 4]


@pytest.mark.parametrize("manifest, gens, root", [
    ({}, [0, 1, 2], "/data"),
    ({"scenario": "sce2", "selected_seed": 3, "recipe": {"epochs": 3000}}, [5, 6], "d"),
    ({"b": 1, "a": [1, 2]}, list(range(70)), "/data/x"),
])
def test_progress_fingerprint_and_seed_lists_equal_jax(manifest, gens, root):
    jmv = _jax_script("multiseed_validate")
    assert multiseed_validate.progress_fingerprint(manifest, gens, root) == \
        jmv.progress_fingerprint(manifest, gens, root)
    assert multiseed_validate.DEFAULT_GEN_SEEDS == jmv.DEFAULT_GEN_SEEDS
    assert multiseed_validate.METRICS == jmv.METRICS


@pytest.mark.parametrize("eps", [1e-3, 2e-3 + 1e-12 * 987654321])
def test_jittered_sut_copy_is_benchs_bytes(sut_dir, tmp_path, monkeypatch, eps):
    """The port's copy is ``bench._jittered_sut_copy``'s byte for byte, with
    pandas reading each field exactly (``float_precision="round_trip"``):
    its default parser puts some 17-digit fields one ulp off, which
    ``to_csv`` then writes back, while the port reads them exactly."""
    import pandas as pd

    sys.path.insert(0, str(REPO_ROOT))
    try:
        import bench
    finally:
        sys.path.remove(str(REPO_ROOT))
    monkeypatch.setattr(pd, "read_csv", functools.partial(pd.read_csv,
                                                          float_precision="round_trip"))
    bench._jittered_sut_copy(sut_dir, str(tmp_path / "bench"), eps=eps)
    jittered_sut_copy(sut_dir, str(tmp_path / "port"), eps=eps)
    names = sorted(os.listdir(sut_dir))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "bench" / name).read_bytes(), name


# ---------------------------------------------------------------------------
# multiseed_validate's chunked resume, with fakes
# ---------------------------------------------------------------------------

def test_multiseed_chunked_resume(tmp_path, monkeypatch, capsys):
    """``--chunk N`` splits the seeds into N-seed tracking batches, saves each
    finished seed's report, clears its block on success, resumes from a
    matching block (the band in seed order), and discards a stale one."""
    calls = []

    def fake_multi(params, cfg, sce, csvs, seeds):
        calls.append([int(s) for s in seeds])
        return {int(s): ([np.full((4, 4), float(s))], ["t.npy"]) for s in seeds}

    def fake_validate(traces, humans, sce):
        s = float(traces[0][0, 0])
        return {m: s + i for i, m in enumerate(multiseed_validate.METRICS)}

    monkeypatch.setattr(multiseed_validate, "load_checkpoint", lambda d, dev: (None, None, {}))
    monkeypatch.setattr(multiseed_validate, "collect_csv_files", lambda d: [])
    monkeypatch.setattr(multiseed_validate, "load_humans", lambda sce, csvs: [])
    monkeypatch.setattr(multiseed_validate, "generate_and_track_multi", fake_multi)
    monkeypatch.setattr(multiseed_validate, "validate", fake_validate)
    root = tmp_path / "data"
    (root / scenarios.get("sce1").town).mkdir(parents=True)
    out, prog = tmp_path / "band.json", tmp_path / "progress.json"
    argv = ["--scenarios", "sce1", "--gen-seeds", "0,1,2,3,4,5,6", "--chunk", "3",
            "--data-root", str(root), "--out", str(out), "--progress", str(prog),
            "--device", "cpu"]

    def band():
        doc = json.loads(out.read_text())
        for i, m in enumerate(multiseed_validate.METRICS):
            assert doc["sce1"][m]["values"] == [s + i for s in range(7)], m
        return doc

    assert multiseed_validate.main(argv) == 0
    assert calls == [[0, 1, 2], [3, 4, 5], [6]]
    assert any("chunked" in n for n in band()["provenance"]["sce1"]["notes"])
    assert "sce1" not in json.loads(prog.read_text())

    fp = multiseed_validate.progress_fingerprint({}, list(range(7)), str(root))
    reports = {str(s): {m: s + i for i, m in enumerate(multiseed_validate.METRICS)}
               for s in range(5)}
    prog.write_text(json.dumps({"sce1": {"fingerprint": fp, "reports": reports}}))
    calls.clear()
    out.unlink()
    assert multiseed_validate.main(argv) == 0
    assert calls == [[5, 6]]
    band()

    prog.write_text(json.dumps({"sce1": {"fingerprint": "stale", "reports": reports}}))
    calls.clear()
    assert multiseed_validate.main(argv) == 0
    assert calls == [[0, 1, 2], [3, 4, 5], [6]]
    band()
    assert "DISCARDING stale progress" in capsys.readouterr().err

    with pytest.raises(SystemExit, match="--chunk needs"):
        multiseed_validate.main(argv[:6] + ["--data-root", str(root)])


# ---------------------------------------------------------------------------
# each driver's main on the written trees, JAX's top-level keys
# ---------------------------------------------------------------------------

def test_seed_sweep_main_keys_equal_jax(tree, tmp_path, monkeypatch, capsys):
    """2 train seeds x 20 epochs on sce2, the top one on 2 band seeds: JAX's
    keys, its candidates' keys and its band's, and a ranking that
    ``rank_candidates`` leaves as it is."""
    args = ["--scenario", "sce2", "--train-seeds", "0:2", "--epochs", "20",
            "--select-gen-seeds", "5", "--band-eval-top", "1", "--band-gen-seeds", "0,1",
            "--data-root", tree]
    out = tmp_path / "port.json"
    assert seed_sweep.main(args + ["--device", "cpu", "--out", str(out)]) == 0
    doc = _line(capsys, "seed_sweep")
    assert json.loads(out.read_text()) == doc
    jss = _jax_script("seed_sweep", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["seed_sweep"] + args + ["--out", str(tmp_path / "j.json")])
    jss.main()
    jdoc = json.loads((tmp_path / "j.json").read_text())
    assert list(doc) == list(jdoc)
    assert [set(r) for r in doc["ranked"]] == [set(r) for r in jdoc["ranked"]]
    assert set(doc["band_eval"][0]) == set(jdoc["band_eval"][0])
    assert set(doc["band_eval"][0]["band"]) == set(jdoc["band_eval"][0]["band"])
    rows = [dict(r, worst_margin=float("-inf") if r["worst_margin"] is None
                 else r["worst_margin"]) for r in doc["ranked"]]
    assert seed_sweep.rank_candidates(rows) == rows
    assert {r["train_seed"] for r in doc["ranked"]} == {0, 1}
    with pytest.raises(SystemExit, match="no episode tree for sce2 at"):
        seed_sweep.main(args[:-1] + [str(tmp_path / "absent"), "--device", "cpu"])


def test_multiseed_validate_main_keys_equal_jax(tree, tmp_path, monkeypatch, capsys):
    """Two generation seeds of sce2 from the committed checkpoint: JAX's
    keys, each metric's band_stats keys, the provenance block's keys."""
    args = ["--scenarios", "sce2", "--gen-seeds", "0,1", "--data-root", tree,
            "--ckpt-root", CKPTS]
    assert multiseed_validate.main(args + ["--device", "cpu"]) == 0
    doc = _line(capsys, "multiseed_validate")
    jmv = _jax_script("multiseed_validate", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["mv"] + args + ["--out", str(tmp_path / "j.json")])
    jmv.main()
    jdoc = json.loads((tmp_path / "j.json").read_text())
    assert list(doc) == list(jdoc) == ["sce2", "provenance"]
    assert {m: set(v) for m, v in doc["sce2"].items()} == \
        {m: set(v) for m, v in jdoc["sce2"].items()}
    assert set(doc["provenance"]["sce2"]) == set(jdoc["provenance"]["sce2"])
    assert doc["provenance"]["sce2"]["notes"][0] == jdoc["provenance"]["sce2"]["notes"][0]
    assert all(len(v["values"]) == 2 and np.isfinite(v["mean"]) for v in doc["sce2"].values())
    with pytest.raises(SystemExit, match="no episode tree for sce1 at"):
        multiseed_validate.main(["--scenarios", "sce1", "--data-root", tree, "--device",
                                 "cpu"])


def test_stage_timings_main_keys_equal_jax(tree, sut_dir, tmp_path, monkeypatch, capsys):
    """sce2's pipeline stages, K2's plain version at 20 epochs, the DNDA
    stage over the SUT episodes: JAX's stage names, but for K2's epochs and
    the real episode count in place of JAX's fixed "4x300" and "21" (JAX's
    run on sce2 alone, its K2 call stubbed: the names do not depend on it)."""
    out = tmp_path / "port.json"
    assert stage_timings.main(["--data-root", tree, "--sut-dir", sut_dir, "--ckpt-root", CKPTS,
                               "--scenarios", "sce2", "--epochs", "20", "--processes", "1",
                               "--device", "cpu", "--out", str(out)]) == 0
    rep = _line(capsys, "stage_timings")
    assert json.loads(out.read_text()) == rep
    assert all(r["calls"] == 1 and r["seconds"] > 0 for r in rep.values())

    import defensive_model_vae_tpu.dnda as jdnda
    import defensive_model_vae_tpu.ops as jops
    from defensive_model_vae_tpu import scenarios as jscenarios

    jst = _jax_script("stage_timings", monkeypatch)
    monkeypatch.setattr(jscenarios, "REGISTRY", {"sce2": jscenarios.REGISTRY["sce2"]})
    monkeypatch.setattr(jops, "fused_train_multi", lambda *a, **k: None)
    monkeypatch.setattr(jdnda, "score_directory",
                        functools.partial(jdnda.score_directory, processes=1))
    monkeypatch.setattr(sys, "argv", ["st", "--out", str(tmp_path / "j.json"), "--data-root",
                                      tree, "--sut-dir", sut_dir, "--ckpt-root", CKPTS])
    jst.main()
    jrep = json.loads((tmp_path / "j.json").read_text())
    n = len(os.listdir(sut_dir))
    rename = {"multi_kernel_train_4x300": "multi_kernel_train_4x20",
              "dnda_sweep_21_episodes": f"dnda_sweep_{n}_episodes"}
    assert [rename.get(k, k) for k in jrep] == list(rep)
    assert {tuple(v) for v in jrep.values()} == {tuple(v) for v in rep.values()}
    with pytest.raises(SystemExit, match="no such directory"):
        stage_timings.main(["--data-root", tree, "--sut-dir", str(tmp_path / "absent"),
                            "--scenarios", "sce2", "--device", "cpu"])


def test_dnda_drift_probe_main_keys_equal_jax(sut_dir, tmp_path, monkeypatch, capsys):
    """One rep at 3 frames an episode against JAX's script at one rep on the
    same episodes (its corpus and REPS pointed at them, its output under a
    temporary results/): JAX's keys, each rep's and the summary's; an absent
    directory prints and returns, as JAX's does."""
    out = tmp_path / "port.json"
    monkeypatch.setattr(dnda_drift_probe, "probe",
                        functools.partial(dnda_drift_probe.probe, max_frames=3))
    assert dnda_drift_probe.main(["--sut-dir", sut_dir, "--reps", "1", "--processes", "1",
                                  "--device", "cpu", "--out", str(out)]) == 0
    res = _line(capsys, "dnda_drift_probe")
    assert json.loads(out.read_text()) == res
    assert len(res["reps"]) == 1 and res["reps"][0]["n_frames"] > 0

    import defensive_model_vae_tpu.dnda.calculator as jcalc

    jdp = _jax_script("dnda_drift_probe", monkeypatch)
    (tmp_path / "jax" / "results").mkdir(parents=True)
    monkeypatch.setattr(jdp, "__file__", str(tmp_path / "jax" / "scripts" / "probe.py"))
    monkeypatch.setattr(jdp, "CORPUS", sut_dir)
    monkeypatch.setattr(jdp, "REPS", 1)
    monkeypatch.setattr(jdp, "score_directory",
                        functools.partial(jcalc.score_directory, processes=1))
    jdp.main()
    jres = json.loads((tmp_path / "jax" / "results" / "dnda_drift_probe.json").read_text())
    assert list(res) == list(jres)
    assert set(res["reps"][0]) == set(jres["reps"][0])
    assert set(res["summary"]) == set(jres["summary"])

    capsys.readouterr()
    assert dnda_drift_probe.main(["--sut-dir", str(tmp_path / "absent"), "--device",
                                  "cpu"]) == 0
    captured = capsys.readouterr()
    assert captured.out == "" and "absent" in captured.err


def test_staged_sweep_agrees_with_score_directory_and_jax(sut_dir, monkeypatch):
    """``staged_sweep`` re-implements ``score_directory``'s stages to time
    them: its maxima are the port's ``score_directory`` rows episode for
    episode, and JAX's ``staged_sweep``'s on the same episodes (the
    counterpart of the reference-corpus case of tests/test_scripts.py:608)."""
    n = dnda_drift_probe._smoke(sut_dir, "cpu", max_frames=3)
    assert n > 0
    *_, frames, maxes = dnda_drift_probe.staged_sweep(sut_dir, "cpu", max_frames=3)
    *_, jframes, jmaxes = _jax_script("dnda_drift_probe").staged_sweep(sut_dir, max_frames=3)
    assert frames == jframes == n
    assert len(maxes) == len(os.listdir(sut_dir))
    assert maxes == jmaxes


def test_import_scan_covers_the_new_drivers():
    """The four drivers (and the build-timing script) are among the files the
    import scan of tests/test_torch_pipeline.py reads, and import nothing of
    JAX, the JAX package, ``bench`` or a root ``scripts/`` module."""
    scanned = set(PORT.rglob("*.py"))
    for name in ("seed_sweep", "multiseed_validate", "stage_timings", "dnda_drift_probe",
                 "build_timing"):
        path = PORT / "scripts" / f"{name}.py"
        assert path in scanned
        mods = list(_imports(path))
        assert not [m for m in mods if m.split(".")[0] in BANNED or m.startswith("scripts")]
