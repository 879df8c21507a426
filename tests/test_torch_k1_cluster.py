"""The K1 family's cluster-size argument, phase timer and digest script, on
the CPU.

The cluster kernel itself runs only on the card (tests/test_torch_k1_card.py,
tests/test_torch_k2_card.py, chip_smoke.py's ``k1_digest`` phase); here the
wrappers' checks, which run before the plain version, and the digest and
phase scripts' cases, reference and refusals.
"""

import json

import numpy as np
import pytest
import torch

from defensive_model_vae_tpu_torch.models import CVAEConfig, LossWeights, init_params
from defensive_model_vae_tpu_torch.ops import fused_trainer as tft
from defensive_model_vae_tpu_torch.scripts import k1_digest, k1_phases

CFG, LW = CVAEConfig(), LossWeights()
SEEDS = [0, 1]


def _runs(rows=(3, 2)):
    """Two tiny ragged runs on the CPU: (stacked, x, cond, row_off)."""
    n = sum(rows)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((n, 30)).astype(np.float32))
    c = torch.as_tensor(np.random.default_rng(1).standard_normal((n, 2)).astype(np.float32))
    stacked = tft.stack_flat_params(
        [init_params(torch.Generator().manual_seed(s), CFG, "cpu") for s in SEEDS])
    return stacked, x, c, [0, rows[0], n]


def _calls(cluster):
    """Each K1-family entry on CPU tensors with ``cluster``, one epoch."""
    stacked, x, c, off = _runs()
    plist = [a[0] for a in stacked]
    return {
        "K1": lambda: tft.fused_call(plist, x, c, 0, CFG, LW, 1, 1e-3, cluster=cluster),
        "K2": lambda: tft._fused_multi_call(stacked, x, c, off, SEEDS, CFG, LW, 1, 1e-3,
                                            cluster=cluster),
        "the seed grid": lambda: tft._fused_seeds_call(stacked, x, c, SEEDS, CFG, LW, 1,
                                                       1e-3, cluster=cluster),
    }


@pytest.mark.parametrize("cluster", [-1, 3, 5, 32, 1.0, True, None, "4"])
@pytest.mark.parametrize("entry", ["K1", "K2", "the seed grid"])
def test_cluster_size_outside_the_set_is_refused(entry, cluster):
    """A forced size outside {0, 1, 2, 4, 8, 16} is refused before any
    launch or plain run, whatever the device."""
    with pytest.raises(ValueError, match="cluster must be one of"):
        _calls(cluster)[entry]()


@pytest.mark.parametrize("cluster", tft.CLUSTER_SIZES)
def test_every_cluster_size_runs_the_plain_version_on_the_cpu(cluster):
    """On CPU tensors every size is taken and runs the plain version, which
    has no clusters: the results do not depend on the size, and nothing is
    launched."""
    before = (tft.fused_call.launches, tft._fused_multi_call.launches,
              tft._fused_seeds_call.launches)
    outs = {k: f() for k, f in _calls(cluster).items()}
    ref = {k: f() for k, f in _calls(0).items()}
    for k in outs:
        (pa, ma), (pb, mb) = outs[k], ref[k]
        assert all(torch.equal(a, b) for a, b in zip(pa, pb)) and torch.equal(ma, mb)
    assert (tft.fused_call.launches, tft._fused_multi_call.launches,
            tft._fused_seeds_call.launches) == before


def test_phase_split_reads_the_timer_slots():
    t = torch.zeros(tft.TIMER_SLOTS, dtype=torch.int64)
    t[:len(tft.PHASES)] = torch.arange(1, len(tft.PHASES) + 1) * 1_000_000
    t[len(tft.PHASES)] = 3000
    split = tft.phase_split(t)
    assert list(split) == list(tft.PHASES) + ["epochs"]
    assert split["noise"] == 1.0 and split["barrier_waits"] == 8.0
    assert split["epochs"] == 3000
    assert tft.phase_timer("cpu").shape == (tft.TIMER_SLOTS,)


def test_k1_digest_cases_and_reference():
    """Every case has a reference digest of the one-block build, on the one
    card the reference was taken on; other cards are refused."""
    assert set(k1_digest.REFERENCE) == {132}
    ref = k1_digest.reference(132)
    assert set(ref) == set(k1_digest.CASES)
    assert all(len(d) == 64 and int(d, 16) >= 0 for d in ref.values())
    assert len(set(ref.values())) == len(ref)
    entries = {v[0] for v in k1_digest.CASES.values()}
    assert entries == {"k1", "k2", "grid"}
    assert {v[1] for v in k1_digest.CASES.values()} == {"manual", "auto"}
    assert {v[2] for v in k1_digest.CASES.values()} == {50, 3000}
    for sms in (114, 108, 0):
        with pytest.raises(ValueError, match="no K1 reference digests"):
            k1_digest.reference(sms)
    assert k1_digest.mismatches(dict(ref), ref) == []
    assert k1_digest.mismatches({"k1_manual_e50": "0" * 64}, ref) == ["k1_manual_e50"]


def test_k1_digest_runs_on_the_cpu_and_refuses_without_cuda(capsys):
    assert k1_digest.main(["--device", "cpu", "--cases", "k1_manual_e50_eps"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out["k1_digest"]) == ["k1_manual_e50_eps"]
    assert len(out["k1_digest"]["k1_manual_e50_eps"]) == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            k1_digest.main(["--cases", "k1_manual_e50"])


def test_k1_phases_kernels_and_refusal_without_cuda():
    assert set(k1_phases.KERNELS) == {f"{k}{a}" for k in ("k1", "k2", "grid")
                                      for a in ("", "_auto")}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            k1_phases.main(["--kernels", "k1", "--epochs", "1"])
