"""The port's data layer (``data/``, the scenario registry's predicates, the
episode writer) against the JAX package's on the same CSVs.

The CSVs are the committed windows written as CARLA episodes by
``scripts/episodes.py``, plus small hand-written ones for the loader's edge
cases.  Tolerance: none — every array is compared bit for bit.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conftest import REPO_ROOT
from defensive_model_vae_tpu import data as jdata
from defensive_model_vae_tpu import scenarios as jscen
from defensive_model_vae_tpu.data import csv_io as jcsv
from defensive_model_vae_tpu.data import features as jfeat
from defensive_model_vae_tpu_torch import data as tdata
from defensive_model_vae_tpu_torch import scenarios as tscen
from defensive_model_vae_tpu_torch.data import csv_io as tcsv
from defensive_model_vae_tpu_torch.data import features as tfeat
from defensive_model_vae_tpu_torch.scripts import episodes

KEYS = ("sce1", "sce2", "sce3", "sce4")
N_WINDOWS = {"sce1": 38, "sce2": 16, "sce3": 66, "sce4": 134}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The four committed corpora as episode trees → (root, {key: paths})."""
    root = str(tmp_path_factory.mktemp("episodes"))
    return root, episodes.write_fixture_trees(root)


def _same(a, b):
    """Bit for bit: the same dtype, shape and bytes (None only with None)."""
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the column table and its loader
# ---------------------------------------------------------------------------

EDGE_CSVS = {
    "plus_sign": "a,b,c\n+1.5,+.25,+3e2\n+-1.5,++2,+\n+inf,-inf,-4\n",
    "blank_header": "frame,,ego_x, \n1,2,3,4\n5,6,7,8\n",
    "empty_cell": "x,y,z\n1,,3\n,5,\n7,8,9\n",
}


@pytest.mark.parametrize("case", sorted(EDGE_CSVS))
def test_frame_matches_jax_read_csv(tmp_path, case):
    """Names (blank fields as ``Unnamed: i``) and values (NaN where JAX's
    DataFrame has NaN) equal JAX's ``read_csv`` on the same file."""
    p = tmp_path / f"{case}.csv"
    p.write_text(EDGE_CSVS[case])
    ref = jcsv.read_csv(str(p))
    got = tcsv.read_csv(str(p))
    assert got.columns == list(ref.columns)
    assert got.data.dtype == np.float64 and got.data.shape == ref.shape
    assert np.array_equal(got.data, ref.to_numpy(np.float64), equal_nan=True)
    for name in ref.columns:
        assert name in got
        assert np.array_equal(got[name], ref[name].to_numpy(), equal_nan=True)
    assert "nope" not in got


def test_frame_masks_slices_and_rows(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("ego_x,ego_y,sv1_x\n1,10,-1\n2,20,-2\n3,30,-3\n4,40,-4\n")
    f = tcsv.read_csv(str(p))
    assert len(f) == 4 and f.data.shape == (4, 3)
    sub = f[f["ego_x"] >= 2]
    assert len(sub) == 3 and sub["ego_y"].tolist() == [20.0, 30.0, 40.0]
    assert f.rows(1, 3)["sv1_x"].tolist() == [-2.0, -3.0]
    assert f.rows(2)["ego_x"].tolist() == [3.0, 4.0]
    assert f[["ego_y", "ego_x"]].tolist() == [[10, 1], [20, 2], [30, 3], [40, 4]]
    row = f.row(1)
    assert row["ego_y"] == 20.0 and isinstance(row["ego_y"], float)
    assert row.get("sv1_x", 0.0) == -2.0 and np.isnan(row.get("sv9_x", np.nan))
    with pytest.raises(TypeError):
        f[np.array([1, 0, 1, 0])]
    with pytest.raises(KeyError):
        f["sv9_x"]


def test_parse_cache_returns_copies(tmp_path):
    """Each read is a copy of the cached parse; an edit of the file (its
    mtime and size) is a new parse."""
    p = tmp_path / "t.csv"
    p.write_text("a,b\n1,2\n")
    first = tcsv.read_csv(str(p))
    first.data[:] = 99.0
    assert tcsv.read_csv(str(p)).data.tolist() == [[1.0, 2.0]]
    p.write_text("a,b\n1,2\n3,4\n")
    assert tcsv.read_csv(str(p)).data.tolist() == [[1.0, 2.0], [3.0, 4.0]]


def test_loader_refuses_what_it_cannot_parse(tmp_path):
    """No pandas fallback: a missing file, an empty one and a row wider
    than its header raise."""
    with pytest.raises(FileNotFoundError):
        tcsv.read_csv(str(tmp_path / "missing.csv"))
    (tmp_path / "empty.csv").write_text("")
    with pytest.raises(ValueError, match="cannot parse"):
        tcsv.read_csv(str(tmp_path / "empty.csv"))
    (tmp_path / "wide.csv").write_text("a,b\n1,2,3\n")
    with pytest.raises(ValueError, match="cannot parse"):
        tcsv.read_csv(str(tmp_path / "wide.csv"))


def test_loader_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    """A loader that does not build raises with the compiler's stderr; a
    missing compiler raises too.  Nothing falls back."""
    bad = tmp_path / "csvloader.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(tcsv, "SOURCE", bad)
    monkeypatch.setattr(tcsv, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tcsv, "_lib", None)
    with pytest.raises(RuntimeError, match="building the CSV loader failed:\n.*error"):
        tcsv.read_csv_native(str(tmp_path / "any.csv"))
    monkeypatch.setattr(tcsv, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="needs a C\\+\\+ compiler"):
        tcsv.build()
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.so"))


def test_loader_is_built_into_the_port_build_dir():
    path = tcsv.build()
    assert path.parent == REPO_ROOT / "defensive_model_vae_tpu_torch" / "build"
    assert path.name.startswith("libdmvcsv_") and path.exists()
    assert tcsv.build() == path  # keyed by content: built once


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_carries_every_field_and_entry():
    """Every field of every scenario equals JAX's; callables by name."""
    assert tscen.keys() == jscen.keys()
    assert tscen.ACTIONS == jscen.ACTIONS and tscen.DATASET_ACTIONS == jscen.DATASET_ACTIONS
    assert tscen.TOWN_TO_KEY == jscen.TOWN_TO_KEY
    for key in KEYS:
        t, j = tscen.get(key), jscen.get(key)
        tf = {f.name for f in dataclasses.fields(t)}
        assert tf == {f.name for f in dataclasses.fields(j)}
        for name in tf:
            a, b = getattr(t, name), getattr(j, name)
            if name == "dnda":
                for g in dataclasses.fields(a):
                    x, y = getattr(a, g.name), getattr(b, g.name)
                    if g.name == "baseline_fn":
                        assert _same(x(), y())
                    elif callable(x):
                        assert x.__name__ == y.__name__
                    else:
                        assert x == y
            elif callable(a):
                assert a.__name__ == b.__name__, (key, name)
            elif name == "lane_lines":
                assert [dataclasses.astuple(x) for x in a] == [dataclasses.astuple(x) for x in b]
            else:
                assert a == b, (key, name)
    assert tscen.get("vae_offset_sce2_cond_ld8_epoch3000.pth").key == "sce2"
    assert tscen.get("UnpredictableMovementTown04").key == "sce4"
    with pytest.raises(KeyError):
        tscen.get("nonsense")


@pytest.mark.parametrize("key", KEYS)
def test_predicates_match_jax_on_episode_rows(trees, key):
    """Every predicate of the registry (dataset, artifact, start condition,
    human, SUT, trim) gives JAX's mask on the same episode, and the row
    predicates (dataset end, DNDA stop) JAX's value on every row."""
    root, paths = trees
    path = paths[key][0]
    t, j = tscen.get(key), jscen.get(key)
    tf, jf = tcsv.read_csv(path), jcsv.read_csv(path)
    # SUT predicates read an acceleration column the writer leaves at 0
    for name in ("dataset_start", "artifact_dataset_start", "start_condition_mask",
                 "human_start_mask", "human_end_mask", "sut_episode_start",
                 "sut_episode_end", "dataset_end_row"):
        ft, fj = getattr(t, name), getattr(j, name)
        if ft is None:
            assert fj is None
            continue
        assert np.array_equal(np.asarray(ft(tf)), np.asarray(fj(jf))), name
    for i in range(0, len(tf), 37):
        assert bool(t.dataset_end_row(tf.row(i))) == bool(j.dataset_end_row(jf.iloc[i]))
        assert bool(t.dnda.stop_fn(tf.row(i))) == bool(j.dnda.stop_fn(jf.iloc[i]))
    human, _, _ = jdata.get_human_and_bv_trajectories(path, key)
    assert np.array_equal(t.human_trim_mask(human), j.human_trim_mask(human))


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", KEYS)
def test_episode_round_trip_to_the_fixtures(trees, key):
    """JAX's build_dataset turns the written episodes back into the
    committed fixture byte for byte (so the writer is held to the JAX
    package independently of the port), and so does the port's."""
    root, paths = trees
    want = np.load(tscen.get(key).fixture_windows)
    assert len(paths[key]) == N_WINDOWS[key] == len(want)
    assert _same(jdata.build_dataset(root, key), want)
    assert _same(tdata.build_dataset(root, key), want)


@pytest.mark.parametrize("variant", ["shipped", "artifact"])
@pytest.mark.parametrize("mode", ["normal", "extend_mid"])
@pytest.mark.parametrize("key", KEYS)
def test_build_dataset_matches_jax(trees, key, mode, variant):
    root, _ = trees
    assert _same(tdata.build_dataset(root, key, point_mode=mode, dataset_variant=variant),
                 jdata.build_dataset(root, key, point_mode=mode, dataset_variant=variant))


def test_process_csv_matches_jax_per_file(trees):
    """Every episode, both point modes, an explicit time step and P = 7."""
    root, paths = trees
    for key in KEYS:
        for path in paths[key][::5]:
            for mode in ("normal", "extend_mid"):
                for kw in ({}, {"time_interval": 0.05, "target_points": 7}):
                    assert _same(tdata.process_csv(path, key, point_mode=mode, **kw),
                                 jdata.process_csv(path, key, point_mode=mode, **kw))
    with pytest.raises(ValueError, match="dataset_variant"):
        tdata.process_csv(paths["sce2"][0], "sce2", dataset_variant="typo")
    with pytest.raises(ValueError, match="point_mode"):
        tdata.process_csv(paths["sce2"][0], "sce2", point_mode="typo")


def test_process_csv_edges_match_jax(tmp_path):
    """No start hit, no end hit (the window runs to the file's end), an end
    hit on the start row only (ignored: the search starts after it), and
    fewer rows than points."""
    head = ",".join(episodes.COLUMNS)
    col = {c: i for i, c in enumerate(episodes.COLUMNS)}

    def write(name, rows):
        m = np.zeros((len(rows), len(episodes.COLUMNS)))
        for r, (x, yaw) in enumerate(rows):
            m[r, col["ego_x"]], m[r, col["ego_y"]], m[r, col["sv1_yaw"]] = x, 0.5 * r, yaw
        p = tmp_path / name
        p.write_text(head + "\n" + "\n".join(",".join(map(repr, r)) for r in m.tolist()))
        return str(p)

    cases = [
        write("no_start.csv", [(-150.0 - i, 0.0) for i in range(30)]),
        write("no_end.csv", [(-150.0 - i, -175.0) for i in range(30)]),
        write("end_on_start.csv", [(-190.0, -175.0)] + [(-150.0 - i, -175.0) for i in range(30)]
              + [(-187.0, -175.0)]),
        write("short.csv", [(-150.0 - i, -175.0) for i in range(5)] + [(-190.0, 0.0)]),
    ]
    for p in cases:
        for mode in ("normal", "extend_mid"):
            assert _same(tdata.process_csv(p, "sce2", point_mode=mode),
                         jdata.process_csv(p, "sce2", point_mode=mode)), p
    assert tdata.process_csv(cases[0], "sce2") is None
    assert tdata.process_csv(cases[3], "sce2") is None


def test_iter_windows_collect_and_save_match_jax(trees, tmp_path):
    root, _ = trees
    got = list(tdata.iter_windows(root, "sce3"))
    want = list(jdata.iter_windows(root, "sce3"))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(_same(a, b) for (_, a), (_, b) in zip(got, want))
    both = tdata.collect_trajectories(root, ["sce2", "sce1"])
    jboth = jdata.collect_trajectories(root, ["sce2", "sce1"])
    assert len(both) == len(jboth) == 16 + 38
    assert all(_same(a, b) for a, b in zip(both, jboth))
    arr = tdata.save_windows(both, str(tmp_path / "w" / "windows.npy"))
    assert _same(np.load(tmp_path / "w" / "windows.npy"), arr)
    with pytest.raises(RuntimeError, match="no trajectories"):
        tdata.build_dataset(str(tmp_path), "sce1")


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_random_trajectories_match_jax(seed):
    for dev in (0.0, 5.0):
        assert _same(tdata.generate_random_trajectories(6, 40, dev, seed=seed),
                     jdata.generate_random_trajectories(6, 40, dev, seed=seed))


# ---------------------------------------------------------------------------
# conditions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", KEYS)
def test_start_conditions_match_jax(trees, key, tmp_path):
    """Every episode's start conditions, a missing file, a file whose mask
    never hits and one that lacks a column all give JAX's (the last three
    the scenario's fallback)."""
    root, paths = trees
    hits = 0
    for path in paths[key]:
        a = tdata.get_start_conditions(path, key)
        b = jdata.get_start_conditions(path, key)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert _same(a.as_state(), b.as_state())
        hits += (a.x, a.y) != tscen.get(key).start_fallback[:2]
    assert hits == len(paths[key])
    rows = episodes.episode_rows(np.load(tscen.get(key).fixture_windows)[0], key)
    lead = tmp_path / "lead_in_only.csv"
    lead.write_text(",".join(episodes.COLUMNS) + "\n" + "\n".join(
        ",".join(map(repr, r)) for r in rows[: episodes.LEAD_IN].tolist()))
    (tmp_path / "no_cols.csv").write_text("frame,id\n1,0\n")
    for path in (tmp_path / "missing.csv", lead, tmp_path / "no_cols.csv"):
        a = tdata.get_start_conditions(str(path), key)
        b = jdata.get_start_conditions(str(path), key)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert dataclasses.astuple(a) == (*tscen.get(key).start_fallback, 0.0, 0.0)


@pytest.mark.parametrize("key", KEYS)
def test_human_and_bv_extraction_and_trim_match_jax(trees, key):
    """Human and background-vehicle tracks (end row included) and their
    trimming (sce1: the splice) equal JAX's on every episode."""
    root, paths = trees
    for path in paths[key]:
        got = tdata.get_human_and_bv_trajectories(path, key)
        want = jdata.get_human_and_bv_trajectories(path, key)
        assert all(_same(a, b) for a, b in zip(got, want))
        assert _same(tdata.trim_human_trajectory(got[0], key),
                     jdata.trim_human_trajectory(want[0], key))
    human = got[0]
    # the track runs from the first ego row through the end row
    assert len(human) == int(round(np.load(tscen.get(key).fixture_windows)[-1, -1, 0]
                                   / tscen.get(key).dt)) + 2
    assert (got[2] is None) == (key == "sce4")


def test_human_extraction_edges_match_jax(tmp_path):
    """No start hit, no end hit (to the file's end) and an end hit on the
    start row (no track), for sce2."""
    head = ",".join(episodes.COLUMNS)
    col = {c: i for i, c in enumerate(episodes.COLUMNS)}
    cases = {"no_start": [(-150.0, 0.0)] * 12, "no_end": [(-150.0 - i, -175.0) for i in range(12)],
             "end_on_start": [(-190.0, -175.0)] * 3}
    for name, rows in cases.items():
        m = np.zeros((len(rows), len(episodes.COLUMNS)))
        for r, (x, yaw) in enumerate(rows):
            m[r, col["ego_x"]], m[r, col["sv1_yaw"]] = x, yaw
        p = tmp_path / f"{name}.csv"
        p.write_text(head + "\n" + "\n".join(",".join(map(repr, r)) for r in m.tolist()))
        got = tdata.get_human_and_bv_trajectories(str(p), "sce2")
        want = jdata.get_human_and_bv_trajectories(str(p), "sce2")
        assert all(_same(a, b) for a, b in zip(got, want)), name
        assert (got[0] is None) == (name != "no_end")


def test_sce1_splice_trim_matches_jax():
    """sce1 splices the y >= 40 rows' (x, y) with the FIRST times of the
    track; the others drop the rows before the first mask hit (or keep all
    when nothing hits)."""
    rng = np.random.default_rng(3)
    tr = np.column_stack([rng.normal(-194, 1, 60), np.linspace(20, 90, 60),
                          np.arange(60) * 0.02])
    for key in KEYS:
        for h in (tr, tr[::-1].copy(), tr[:5]):
            assert _same(tdata.trim_human_trajectory(h, key),
                         jdata.trim_human_trajectory(h, key))
    spliced = tdata.trim_human_trajectory(tr, "sce1")
    assert _same(spliced[:, 2], tr[: len(spliced), 2]) and np.all(spliced[:, 1] >= 40)


def test_align_model_trajectory_matches_jax():
    """The truncate, exact, extend and no-match branches."""
    rng = np.random.default_rng(0)
    human = np.column_stack([rng.normal(-190.0, 2.0, 20), rng.normal(45.0, 5.0, 20),
                             np.cumsum(rng.uniform(0.01, 0.05, 20))])
    for n_model in (8, 15, 40):
        states = rng.normal(0.0, 1.0, (n_model, 4))
        assert _same(tdata.align_model_trajectory(human, human[5, 0], human[5, 1], states, 0.02),
                     jdata.align_model_trajectory(human, human[5, 0], human[5, 1], states, 0.02))
    assert tdata.align_model_trajectory(human, 999.0, 999.0, states, 0.02) is None


def test_collect_csv_files_matches_jax(trees, tmp_path):
    """``ACTIONS`` order (not the dataset's), files sorted, non-CSVs left."""
    root, paths = trees
    for key in KEYS:
        folder = os.path.join(root, tscen.get(key).town)
        got = tdata.collect_csv_files(folder)
        assert got == jdata.collect_csv_files(folder)
        assert sorted(got) == sorted(paths[key])
    (tmp_path / "减速").mkdir()
    (tmp_path / "减速" / "notes.txt").write_text("x")
    assert tdata.collect_csv_files(str(tmp_path)) == []


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def test_window_features_match_jax(trees, all_windows):
    root, _ = trees
    for key in KEYS:
        for mode in ("normal", "extend_mid"):
            s = tfeat.window_trial_suffixes(root, key, point_mode=mode)
            assert s == jfeat.window_trial_suffixes(root, key, point_mode=mode)
            assert len(s) == len(tdata.build_dataset(root, key, point_mode=mode))
        for i, w in enumerate(all_windows[key][:20]):
            assert tfeat.window_start_speed(w) == jfeat.window_start_speed(w)
            for suffix in ("", "3", "1"):
                kw = {"default_distance": 45.0} if key == "sce2" else {}
                assert tfeat.window_thw(w, key, suffix, **kw) == \
                    jfeat.window_thw(w, jscen.get(key), suffix, **kw)
    with pytest.raises(ValueError, match="THW distance"):
        tfeat.window_thw(all_windows["sce2"][0], "sce2")


def test_build_conditioned_corpus_matches_jax(trees, all_windows):
    """With the suffixes read from the episodes (sce4's 40 m for trial 3)
    and without; the result feeds the port's train_conditioned."""
    root, _ = trees
    suffixes = {k: tfeat.window_trial_suffixes(root, k) for k in KEYS}
    for suf in (suffixes, None):
        got = tfeat.build_conditioned_corpus(all_windows, suf)
        want = jfeat.build_conditioned_corpus(all_windows, suf)
        assert all(_same(a, b) for a, b in zip(got, want))
    windows, extra = got
    assert windows.shape == (254, 10, 3) and extra.shape == (254, 5)
    from defensive_model_vae_tpu_torch.train import TrainConfig, train_conditioned

    params, hist, cfg = train_conditioned(windows[:32], extra[:32], TrainConfig(epochs=2),
                                          device="cpu")
    assert cfg.cond_dim == 2 + 5 and np.all(np.isfinite(hist["total"]))


# ---------------------------------------------------------------------------
# the import rule
# ---------------------------------------------------------------------------

def test_data_metrics_pipeline_import_neither_jax_nor_pandas(trees):
    """A fresh process that imports the port's data, metrics, pipeline,
    utils, the CLI and the episode writer, and reads an episode, has
    neither jax nor pandas (nor the JAX package) in sys.modules."""
    root, paths = trees
    script = textwrap.dedent(f"""
        import sys
        from defensive_model_vae_tpu_torch import cli, data, metrics, pipeline, utils
        from defensive_model_vae_tpu_torch.scripts import episodes
        data.get_start_conditions({paths["sce2"][0]!r}, "sce2")
        assert len(data.build_dataset({root!r}, "sce2")) == 16
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "pandas", "matplotlib", "defensive_model_vae_tpu"))
        assert not bad, bad
        print("CLEAN")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout
