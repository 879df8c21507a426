"""The port's temporal-conv VAE (BASELINE config 3) against the JAX package,
on the CPU, at small widths (channels (8, 16), H 32).

Tolerances, all float32:
- the model's functions against ``jax.lax``'s convolutions on the same
  params and inputs: atol 1e-5 (other summation orders; measured ≤ 3e-8);
  samples, absolute coordinates up to 500 m: atol 1e-4 (a float32 ulp
  there is 3e-5);
- ``train_conv`` over 20 epochs on JAX's own init and draws (rebuilt from
  ``PRNGKey(seed)``): the loss rows to a relative 1e-5 of each row's
  largest value (measured ≤ 8e-7), the params to 1e-4, a tenth of one of
  Adam's steps (lr 1e-3; measured ≤ 5e-7);
- checkpoints: bit for bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from defensive_model_vae_tpu.models import conv_cvae as J
from defensive_model_vae_tpu.train import TrainConfig as JTrainConfig
from defensive_model_vae_tpu.train import checkpoint as jck
from defensive_model_vae_tpu.train.train import train_conv as j_train_conv

from defensive_model_vae_tpu_torch.models import (
    ConvCVAEConfig, conv_decode, conv_encode, conv_forward, conv_sample, init_conv_params)
from defensive_model_vae_tpu_torch.train import (
    TrainConfig, load_checkpoint, params_from_numpy, params_to_numpy, require_cvae_config,
    save_checkpoint, train_conv)

SMALL = dict(channels=(8, 16), hidden_dim=32)
FN_ATOL, SAMPLE_ATOL = 1e-5, 1e-4
TRAIN_METRICS_REL, TRAIN_PARAMS_ABS = 1e-5, 1e-4
SHAPES = [(16, 2), (15, 3), (50, 2), (13, 3)]  # even and odd lengths, dim 2 and 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the suite runs in
    several worker processes that would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(L, dim, **kw):
    return (J.ConvCVAEConfig(seq_len=L, dim=dim, **SMALL, **kw),
            ConvCVAEConfig(seq_len=L, dim=dim, **SMALL, **kw))


def _jax_params(cfg, seed=0):
    p = J.init_conv_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _close(a, b, atol=FN_ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(), rtol=0, atol=atol)


def test_default_config_and_layout_match_jax():
    """361,938 parameters at the default width, and JAX's layer names and
    shapes (conv w (K, Cin, Cout)), bottleneck 7."""
    cfg = ConvCVAEConfig()
    assert cfg.n_params() == 361_938 and cfg.bottleneck_len == 7
    jp = _jax_params(J.ConvCVAEConfig())
    tp = init_conv_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: {n: tuple(a.shape) for n, a in v.items()} for k, v in tp.items()} == \
        {k: {n: a.shape for n, a in v.items()} for k, v in jp.items()}
    # the port's init draws U(±1/sqrt(fan_in)) as JAX's does
    for k, v in tp.items():
        s = v["w"].shape
        bound = 1.0 / np.sqrt(s[0] * s[1] if len(s) == 3 else s[0])
        assert float(v["w"].abs().max()) <= bound and float(v["b"].abs().max()) <= bound


@pytest.mark.parametrize("L,dim", SHAPES)
def test_encode_decode_forward_match_jax(L, dim):
    jcfg, cfg = _cfgs(L, dim)
    jp = _jax_params(jcfg)
    tp = params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(L + dim)
    x = rng.normal(size=(5, L, dim)).astype(np.float32)
    cond = rng.normal(size=(5, 2)).astype(np.float32)
    eps = rng.normal(size=(5, jcfg.latent_dim)).astype(np.float32)

    jmu, jlv, jhc = J.conv_encode(jp, jnp.asarray(x), jnp.asarray(cond), jcfg)
    mu, lv, hc = conv_encode(tp, torch.tensor(x), torch.tensor(cond), cfg)
    for a, b in ((jmu, mu), (jlv, lv), (jhc, hc)):
        _close(a, b)
    _close(J.conv_decode(jp, jnp.asarray(eps), jhc, jcfg),
           conv_decode(tp, torch.tensor(eps), hc, cfg))
    # conv_forward with the noise fed: JAX draws it from the key, so feed
    # the port that draw
    key = jax.random.PRNGKey(7)
    jout = J.conv_forward(jp, key, jnp.asarray(x), jnp.asarray(cond), jcfg)
    draw = np.asarray(jax.random.normal(key, (5, jcfg.latent_dim), jnp.float32))
    out = conv_forward(tp, None, torch.tensor(x), torch.tensor(cond), cfg,
                       eps=torch.tensor(draw))
    assert out[0].shape == (5, L, dim)
    for a, b in zip(jout, out):
        _close(a, b)


@pytest.mark.parametrize("L,dim,cond_dim", [(16, 2, 2), (15, 3, 2), (20, 2, 4)])
def test_conv_sample_matches_jax(L, dim, cond_dim):
    """z fed from JAX's draw; the start zero-padded to cond_dim, shifted in
    columns 1:3 for dim 3 (JAX tests/test_model.py:394)."""
    jcfg, cfg = _cfgs(L, dim, cond_dim=cond_dim)
    jp = _jax_params(jcfg, 1)
    tp = params_from_numpy(jp, "cpu")
    start = np.array([[1.0, 2.0], [-150.0, 40.0], [500.0, -300.0]], np.float32)
    key = jax.random.PRNGKey(3)
    jout = np.asarray(J.conv_sample(jp, key, start, jcfg))
    z = np.asarray(jax.random.normal(key, (3, jcfg.latent_dim), jnp.float32))
    out = conv_sample(tp, None, torch.tensor(start), cfg, z=torch.tensor(z))
    assert out.shape == (3, L, dim) and torch.isfinite(out).all()
    np.testing.assert_allclose(jout, out.numpy(), rtol=0, atol=SAMPLE_ATOL)
    # the draws of a CPU generator are repeatable
    g = [conv_sample(tp, torch.Generator().manual_seed(5), torch.tensor(start), cfg)
         for _ in range(2)]
    assert torch.equal(g[0], g[1])


@pytest.mark.parametrize("L,dim", [(16, 2), (15, 3)])
def test_train_conv_matches_jax_on_jax_draws(L, dim):
    """20 epochs of train_conv against JAX's on JAX's init
    (init_conv_params(PRNGKey(seed))) and noise (normal(fold_in(key, e)))."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (12, L, dim)).cumsum(1).astype(np.float32)
    if dim == 3:
        w[:, :, 0] = np.arange(L, dtype=np.float32) * 0.1
    jcfg, cfg = _cfgs(L, dim)
    E, seed = 20, 3
    jp, jh, jc = j_train_conv(w, jcfg, JTrainConfig(epochs=E, seed=seed))
    key = jax.random.PRNGKey(seed)
    init = _jax_params(jcfg, seed)
    eps = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, e),
                                                 (len(w), jcfg.latent_dim)))
                    for e in range(E)])
    tp, th, tc = train_conv(w, cfg, TrainConfig(epochs=E, seed=seed), init_params=init,
                            eps=eps, device="cpu")
    assert tc == cfg and set(th) == {"total", "recon", "kld"}
    for k in th:
        jr = np.asarray(jh[k])
        assert np.abs(th[k] - jr).max() <= TRAIN_METRICS_REL * np.abs(jr).max(), k
    got = params_to_numpy(tp)
    for k in got:
        for n in ("w", "b"):
            np.testing.assert_allclose(got[k][n], np.asarray(jp[k][n]), rtol=0,
                                       atol=TRAIN_PARAMS_ABS)


def test_train_conv_descends_and_defaults():
    """The port's own init and noise stream: the loss falls (JAX
    tests/test_extras.py:241 at a small size), the config comes from the
    windows, and the same seed gives the same run."""
    from defensive_model_vae_tpu_torch.data import generate_random_trajectories

    w = generate_random_trajectories(24, 16, 5.0, seed=2).astype(np.float32)
    runs = [train_conv(w, ConvCVAEConfig(seq_len=16, dim=2, **SMALL),
                       TrainConfig(epochs=60, seed=4), device="cpu") for _ in range(2)]
    (p, h, cfg), (p2, h2, _) = runs
    assert np.all(np.isfinite(h["total"])) and h["total"][-1] < h["total"][0] / 3
    assert np.array_equal(h["total"], h2["total"])
    assert all(torch.equal(p[k][n], p2[k][n]) for k in p for n in ("w", "b"))
    _, _, c = train_conv(w, train_cfg=TrainConfig(epochs=1), device="cpu")
    assert (c.seq_len, c.dim, c.channels) == (16, 2, (32, 64, 128))
    # init_params given as port params are copied, not trained in place
    before = {k: {n: a.clone() for n, a in v.items()} for k, v in p.items()}
    train_conv(w, cfg, TrainConfig(epochs=2), init_params=p, device="cpu")
    assert all(torch.equal(p[k][n], before[k][n]) for k in p for n in ("w", "b"))


def test_train_conv_and_model_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    w = np.zeros((2, 8, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_conv(w, train_cfg=TrainConfig(epochs=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_conv_params(torch.Generator(), ConvCVAEConfig())


def test_conv_checkpoint_from_jax_loads_as_conv_config(tmp_path):
    """A Conv1D checkpoint saved by JAX loads in the port as an equal
    ConvCVAEConfig with bit-equal params (the manifest stores channels as a
    list), and the MLP-only guard names the config's type."""
    jcfg = J.ConvCVAEConfig(seq_len=20, dim=2, **SMALL)
    jp = J.init_conv_params(jax.random.PRNGKey(0), jcfg)
    d = jck.save_checkpoint(str(tmp_path / "j"), jp, jcfg, None)
    params, cfg, manifest = load_checkpoint(d, "cpu")
    assert isinstance(cfg, ConvCVAEConfig) and cfg.channels == (8, 16)
    assert cfg == ConvCVAEConfig(seq_len=20, dim=2, **SMALL)
    got = params_to_numpy(params)
    assert set(got) == set(jp)
    assert all(np.array_equal(got[k][n], np.asarray(jp[k][n])) for k in got for n in ("w", "b"))
    with pytest.raises(TypeError, match="ConvCVAEConfig"):
        require_cvae_config(cfg, "generation")


def test_conv_checkpoint_from_port_loads_in_jax(tmp_path):
    cfg = ConvCVAEConfig(seq_len=15, dim=3, cond_dim=4, **SMALL)
    params = init_conv_params(torch.Generator().manual_seed(2), cfg, "cpu")
    save_checkpoint(str(tmp_path), params, cfg, "sce2")
    jp, jcfg, manifest = jck.load_checkpoint(str(tmp_path))
    assert jcfg == J.ConvCVAEConfig(seq_len=15, dim=3, cond_dim=4, **SMALL)
    assert manifest["scenario"] == "sce2"
    ref = params_to_numpy(params)
    assert all(np.array_equal(np.asarray(jp[k][n]), ref[k][n]) for k in ref for n in ("w", "b"))
    # and back into the port, unchanged
    p2, cfg2, _ = load_checkpoint(str(tmp_path), "cpu")
    assert cfg2 == cfg
    assert all(torch.equal(p2[k][n], params[k][n]) for k in params for n in ("w", "b"))
