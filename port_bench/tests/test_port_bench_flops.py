"""The frozen operation counts against counts made by hand."""

import json

import pytest

from port_bench import flops
from port_bench.manifest import HERE

CVAE = json.loads((HERE / "configs/cvae.json").read_text())
CONV = json.loads((HERE / "configs/conv_cvae.json").read_text())


def test_dense_cvae_counts():
    # forward multiply-adds: cond_0, six 128×128 layers, enc_0, the two
    # heads, dec_0, dec_3
    mac = 2 * 128 + 6 * 128 * 128 + 30 * 128 + 2 * 256 * 8 + 136 * 128 + 128 * 30
    assert mac == 127_744
    # forward, weight gradients, activation gradients but cond_0's and enc_0's
    assert flops.cvae_window_epoch_flops(CVAE) == 2 * (2 * mac + mac - 2 * 128 - 30 * 128)
    assert flops.cvae_window_epoch_flops(CVAE) == 758_272
    assert flops.cvae_params(CVAE) == CVAE["n_params"] == 128_942
    job = flops.cvae_job_flops(CVAE, 131_072, 200)
    assert job == 200 * (131_072 * 758_272 + 10 * 128_942)
    assert job / 1e12 == pytest.approx(19.88, abs=0.005)


def test_conv_counts():
    macs = flops.conv_forward_macs(CONV)
    # encoder: out length × kernel × in × out channels (50 → 25 → 13 → 7)
    assert macs["conv_0"] == 25 * 5 * 2 * 32
    assert macs["conv_1"] == 13 * 5 * 32 * 64
    assert macs["conv_2"] == 7 * 5 * 64 * 128
    assert macs["enc_proj"] == 7 * 128 * 128 and macs["dec_proj"] == 136 * 7 * 128
    # a stride-2 transposed conv of kernel 5 touches 2 or 3 real inputs an
    # output: 7 → 13 points, 13 → 25, 25 → 50
    assert macs["deconv_0"] == 30 * 128 * 64
    assert macs["deconv_1"] == 60 * 64 * 32
    assert macs["deconv_2"] == 122 * 32 * 2
    assert flops.conv_params(CONV) == CONV["n_params"] == 361_938
    total = sum(macs.values())
    assert flops.conv_window_epoch_flops(CONV) == 2 * (3 * total - macs["conv_0"] - macs["cond_0"])


def test_deconv_taps_count_real_inputs():
    # brute force: the dilated input's real points under each output's window
    for L_in, L_out in ((7, 13), (13, 25), (25, 50)):
        pad = 3
        real = {q for q in range(0, 2 * (L_in - 1) + 1, 2)}
        n = sum(1 for t in range(L_out) for k in range(5) if t + k - pad in real)
        assert flops._deconv_taps(L_in, L_out, 5) == n


def test_serve_and_lu_counts():
    R, n = 2 * 31 + 40, 40
    it = 3 * 2 * 31 * 30 * 20 + 2 * n * n * R + 2 * n * R + 2 * n ** 3 / 3 + 2 * n ** 2
    assert flops.lm_iteration_flops(30, 20) == int(it)
    ops, nbytes = flops.lu_flops_bytes(16, 40)
    assert nbytes == 16 * (1600 + 80) * 4
    assert flops.bound_s(ops, nbytes, flops.PEAKS["float32"]) == pytest.approx(
        max(ops / 67e12, nbytes / 3.35e12))
