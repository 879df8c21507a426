"""The port's HTTP server and ``serve`` CLI on the CPU (``device="cpu"``,
small batch and steps), mirroring ``tests/test_serving.py`` and
``tests/test_cli.py::test_cli_serve``.

The serve program's arithmetic is held against JAX in
``tests/test_torch_device_reference.py``; these tests pin the endpoint
around it: padding to the fixed batch, seeds, validation, routing, the
npz format, per-row divergence, and the CLI.  The HTTP path is a
transport, so its arrays equal a direct call's exactly (both run the
padded batch at one shape).
"""

import http.client
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from conftest import REPO_ROOT
from defensive_model_vae_tpu_torch import serving
from defensive_model_vae_tpu_torch.cli import _parse_ckpt_specs, main
from defensive_model_vae_tpu_torch.control import MPCConfig
from defensive_model_vae_tpu_torch.control.device_reference import make_serve_fn
from defensive_model_vae_tpu_torch.models import CVAEConfig, init_params
from defensive_model_vae_tpu_torch.serving import _parse_requests, make_http_server
from defensive_model_vae_tpu_torch.train.checkpoint import save_checkpoint

BATCH, STEPS = 4, 6
CKPTS = REPO_ROOT / "results" / "checkpoints"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _running(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def _stop(server, t):
    server.shutdown()
    server.server_close()
    t.join(timeout=10)


@pytest.fixture(scope="module")
def served():
    cfg = CVAEConfig()
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    mpc = MPCConfig(prediction_horizon=5, control_horizon=3, dt=0.1)
    serve_fn = make_serve_fn(params, cfg, mpc, num_steps=STEPS)
    server = make_http_server(serve_fn, BATCH, STEPS)
    t = _running(server)
    yield server, serve_fn
    _stop(server, t)


@pytest.fixture(scope="module")
def two_models(tmp_path_factory):
    """serve_checkpoint over two saved models, with /generate."""
    cfg = CVAEConfig()
    root = tmp_path_factory.mktemp("ck")
    dirs = {name: save_checkpoint(str(root / name),
                                  init_params(torch.Generator().manual_seed(i), cfg, "cpu"),
                                  cfg, name)
            for i, name in enumerate(["sce1", "sce2"])}
    server = serving.serve_checkpoint(dirs, batch=2, num_steps=4, dt=0.1, warm_seed=1,
                                      device="cpu")
    t = _running(server)
    yield server, dirs
    _stop(server, t)


def _call(server, payload=None, path="/serve", method="POST"):
    host, port = server.server_address[:2]
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npz(server, payload, path="/serve"):
    host, port = server.server_address[:2]
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers["Content-Type"] == "application/octet-stream"
        return np.load(io.BytesIO(r.read()))


ROWS = [{"start_x": -193.3, "start_y": 50.0},
        {"start_x": -192.8, "start_y": 42.0, "heading": 1.5, "vy": 8.0}]


def test_healthz_counters(served):
    server, _ = served
    code, body = _call(server, path="/healthz", method="GET")
    assert code == 200
    assert {k: body[k] for k in ("ok", "batch", "steps", "models")} == {
        "ok": True, "batch": BATCH, "steps": STEPS, "models": ["default"]}
    before = body["served"]
    code, _ = _call(server, {"requests": [{"start_x": 0.0, "start_y": 0.0}], "seed": 1})
    assert code == 200
    _, body2 = _call(server, path="/healthz", method="GET")
    assert body2["served"] == before + 1
    assert body2["last_ms"] is not None and body2["last_ms"] >= 0
    rej = body2["rejected"]
    code, _ = _call(server, {"requests": []})
    assert code == 400
    _, body3 = _call(server, path="/healthz", method="GET")
    assert body3["rejected"] == rej + 1 and body3["served"] == before + 1


def test_serve_matches_direct_call_and_pads(served):
    server, serve_fn = served
    code, body = _call(server, {"requests": ROWS, "seed": 7})
    assert code == 200 and body["seed"] == 7 and body["n"] == 2
    states = np.asarray(body["states"], np.float32)
    controls = np.asarray(body["controls"], np.float32)
    assert states.shape == (2, STEPS + 1, 4) and controls.shape == (2, STEPS, 2)
    assert np.all(np.isfinite(states)) and np.all(np.isfinite(controls))
    starts, inits, k = _parse_requests(ROWS, BATCH)
    d_states, d_controls = serve_fn(7, starts, inits)
    np.testing.assert_array_equal(states, d_states.numpy()[:k])
    np.testing.assert_array_equal(controls, d_controls.numpy()[:k])
    # padding never moves a real row: the first request alone is row 0
    code1, body1 = _call(server, {"requests": ROWS[:1], "seed": 7})
    assert code1 == 200 and body1["n"] == 1
    np.testing.assert_array_equal(np.asarray(body1["states"][0]),
                                  np.asarray(body["states"][0]))


def test_npz_response_format(served):
    server, _ = served
    _, jbody = _call(server, {"requests": ROWS, "seed": 11})
    z = _npz(server, {"requests": ROWS, "seed": 11, "format": "npz"})
    assert str(z["model"]) == "default" and int(z["seed"]) == 11
    assert int(z["n"]) == 2 and z["invalid"].size == 0
    np.testing.assert_array_equal(z["states"], np.asarray(jbody["states"], np.float32))
    np.testing.assert_array_equal(z["controls"], np.asarray(jbody["controls"], np.float32))
    code, body = _call(server, {"requests": ROWS, "format": "csv"})
    assert code == 400 and "unknown format" in body["error"]


def test_generate_route_absent_is_501(served):
    server, _ = served
    code, body = _call(server, {"requests": [{"start_x": 0.0, "start_y": 0.0}]},
                       path="/generate")
    assert code == 501 and "not configured" in body["error"]


def test_pinned_seed_repeats_and_entropy_seed_differs(served):
    server, _ = served
    rows = [{"start_x": -193.3, "start_y": 50.0}]
    _, a = _call(server, {"requests": rows, "seed": 3})
    _, b = _call(server, {"requests": rows, "seed": 3})
    assert a["states"] == b["states"]
    _, c = _call(server, {"requests": rows})
    _, d = _call(server, {"requests": rows})
    assert c["seed"] != d["seed"] and c["states"] != d["states"]


def test_generate_route_matches_direct_call_and_npz(two_models):
    server, dirs = two_models
    code, body = _call(server, {"requests": ROWS, "seed": 9, "model": "sce1"},
                       path="/generate")
    assert code == 200 and body["n"] == 2 and body["model"] == "sce1"
    trajs = np.asarray(body["trajectories"], np.float32)
    assert trajs.shape == (2, 10, 3) and np.all(np.isfinite(trajs))
    starts, _, k = _parse_requests(ROWS, 2)
    direct = serving.build_generate_fn(dirs["sce1"], device="cpu")(9, starts)
    np.testing.assert_array_equal(trajs, direct.numpy()[:k])
    z = _npz(server, {"requests": ROWS, "seed": 9, "format": "npz", "model": "sce1"},
             path="/generate")
    np.testing.assert_array_equal(z["trajectories"], trajs)


def test_multi_model_routing(two_models):
    server, _ = two_models
    code, body = _call(server, path="/healthz", method="GET")
    assert code == 200 and body["models"] == ["sce1", "sce2"]
    rows = ROWS[:1]
    _, a = _call(server, {"requests": rows, "seed": 3, "model": "sce1"})
    _, b = _call(server, {"requests": rows, "seed": 3, "model": "sce2"})
    assert a["model"] == "sce1" and b["model"] == "sce2"
    assert a["states"] != b["states"]  # other weights, same seed
    code, body = _call(server, {"requests": rows, "seed": 3})
    assert code == 400 and "'model' is required" in body["error"]
    code, body = _call(server, {"requests": rows, "seed": 3, "model": "sce9"})
    assert code == 400 and "unknown model" in body["error"]


def test_body_limit_is_413(served):
    server, _ = served
    host, port = server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.putrequest("POST", "/serve")
    conn.putheader("Content-Length", str(serving._MAX_BODY_BYTES + 1))
    conn.endheaders()
    r = conn.getresponse()
    assert r.status == 413 and "body exceeds" in json.loads(r.read())["error"]
    conn.close()


def test_diverged_rows_are_nulled_per_row():
    def half_bad_serve(seed, starts, inits):
        states = torch.ones((BATCH, STEPS + 1, 4))
        states[1] = float("nan")  # only padded-batch row 1 diverges
        return states, torch.zeros((BATCH, STEPS, 2))

    server = make_http_server(half_bad_serve, BATCH, STEPS)
    t = _running(server)
    try:
        code, body = _call(server, {"requests": [{"start_x": 0.0, "start_y": 0.0}] * 3,
                                    "seed": 1})
        assert code == 200 and body["invalid"] == [1]
        assert body["states"][1] is None and body["controls"][1] is None
        for i in (0, 2):
            assert np.asarray(body["states"][i]).shape == (STEPS + 1, 4)
        z = _npz(server, {"requests": [{"start_x": 0.0, "start_y": 0.0}] * 3, "seed": 1,
                          "format": "npz"})
        assert z["invalid"].tolist() == [1] and np.isnan(z["states"][1]).all()
    finally:
        _stop(server, t)


def test_request_validation(served):
    server, _ = served
    over = [{"start_x": 0.0, "start_y": 0.0}] * (BATCH + 1)
    code, body = _call(server, {"requests": over})
    assert code == 400 and "exceed the compiled batch" in body["error"]
    code, body = _call(server, {"requests": [{"start_y": 1.0}]})
    assert code == 400 and "start_x" in body["error"]
    for bad in ({"start_x": float("nan"), "start_y": 0.0},
                {"start_x": 0.0, "start_y": 0.0, "vy": 1e999},
                {"start_x": 1e200, "start_y": 0.0}):  # finite in float64 only
        code, body = _call(server, {"requests": [bad]})
        assert code == 400 and "finite" in body["error"]
    ok = [{"start_x": 0.0, "start_y": 0.0}]
    for bad_seed in (1 << 64, 1 << 32, -1):
        code, body = _call(server, {"requests": ok, "seed": bad_seed})
        assert code == 400 and "seed" in body["error"]
    for not_a_dict in ([1, 2, 3], "just a string"):
        code, body = _call(server, not_a_dict)
        assert code == 400 and "JSON object" in body["error"]
    assert _call(server, {})[0] == 400
    assert _call(server, {"requests": ok}, path="/nope")[0] == 404
    assert _call(server, path="/nope", method="GET")[0] == 404


def test_conv_checkpoint_refused_at_the_boundary(tmp_path):
    cfg = CVAEConfig()
    d = save_checkpoint(str(tmp_path / "conv"),
                        init_params(torch.Generator().manual_seed(0), cfg, "cpu"), cfg, None)
    manifest = json.loads((tmp_path / "conv" / "manifest.json").read_text())
    manifest["model_config"] = {"seq_len": 20, "dim": 2, "channels": [16, 32]}
    (tmp_path / "conv" / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(TypeError, match="MLP CVAE family only"):
        serving.build_serve_fn(d, num_steps=4, dt=0.1, device="cpu")


def test_cli_serve_one_shot(tmp_path, capsys):
    """The one-shot ``serve`` (tests/test_cli.py:137) on a committed
    checkpoint."""
    out = tmp_path / "states.npy"
    main(["serve", "--ckpt", str(CKPTS / "sce2"), "--start-x", "-150.0", "--start-y", "-0.7",
          "--heading", "3.14", "--vx", "-8.0", "--vy", "0.0", "--steps", "16",
          "--out", str(out), "--device", "cpu"])
    assert "saved" in capsys.readouterr().out
    states = np.load(out)
    assert states.shape == (1, 17, 4) and np.all(np.isfinite(states))
    main(["serve", "--ckpt", f"sce2={CKPTS / 'sce2'}", "--start-x", "-150.0",
          "--start-y", "-0.7", "--steps", "8", "--batch", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out)
    assert line["batch"] == 2 and line["steps"] == 8 and len(line["final_xy"]) == 2


def test_cli_serve_refusals():
    with pytest.raises(SystemExit, match="not ported yet"):
        main(["serve", "--data-parallel", "--batch", "16", "--ckpt", str(CKPTS / "sce2"),
              "--start-x", "-150.0", "--start-y", "-0.7", "--device", "cpu"])
    with pytest.raises(SystemExit, match="required without --listen"):
        main(["serve", "--ckpt", str(CKPTS / "sce2"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="exactly one --ckpt"):
        main(["serve", "--ckpt", "a=x", "--ckpt", "b=y", "--start-x", "0",
              "--start-y", "0", "--device", "cpu"])


def test_parse_ckpt_specs():
    assert _parse_ckpt_specs(["d"]) == {"default": "d"}
    assert _parse_ckpt_specs(["sce1=a", "sce2=b"]) == {"sce1": "a", "sce2": "b"}
    assert _parse_ckpt_specs(["run=3/ckpt"]) == {"run": "3/ckpt"}
    assert _parse_ckpt_specs(["./run=3/ckpt"]) == {"default": "./run=3/ckpt"}
    assert _parse_ckpt_specs(["=a"]) == {"default": "=a"}
    with pytest.raises(SystemExit, match="must be NAME=DIR"):
        _parse_ckpt_specs(["a", "b"])
    with pytest.raises(SystemExit, match="duplicate model name"):
        _parse_ckpt_specs(["x=a", "x=b"])
