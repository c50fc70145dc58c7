"""The yardstick's arithmetic against hand counts and against the kernel
table's bounds."""

import json

import pytest

from odb_bench import bounds
from odb_bench.flops import mamba2, qwen3
from odb_bench.tests.conftest import ROOT


def config(name):
    return json.loads((ROOT / "odb_bench" / "configs" / f"{name}.json").read_text())


def test_qwen3_hand_count():
    c = config("qwen3_0_6b")
    per_layer = 1024 * 2048 + 2 * 1024 * 1024 + 2048 * 1024 + 3 * 1024 * 3072
    assert qwen3.matmul_params(c) == (28 * per_layer, 1024 * 151936) == (440401920, 155582464)
    want = 6 * (440401920 + 155582464) * 103 + 12 * 128 * 16 * 28 * (100 * 101 // 2 + 3 * 4 // 2)
    assert qwen3.train_flops(c, [100, 3]) == want
    assert 3.5e9 < qwen3.train_flops(c, [1]) < 3.6e9  # ~3.58 GFLOP a token


def test_mamba2_hand_count():
    c = config("mamba2_130m")
    per_token = 6 * (24 * 3753984 + 768 * 50277) + 3 * 24 * 14336
    assert per_token == 773282304
    pairs = 256 * 257 // 2 + 44 * 45 // 2
    ssd = 2 * (pairs * 128 + 24 * (pairs * 64 + 2 * 300 * 64 * 128))
    assert ssd == 348702208 == mamba2.ssd_flops(c, 300)
    assert mamba2.train_flops(c, [300]) == per_token * 300 + 3 * 24 * ssd


def test_flash_bound_matches_the_kernel_table():
    # K4 at training step 1's shape: 2 x 6144, 254,265,872 visible pairs over 16 heads.
    work = bounds.flash_work(2, 6144, 16, 8, 128, 254265872 // 16)
    assert bounds.bound_s(*work["fwd"]) * 1e3 == pytest.approx(0.1316, abs=5e-5)
    assert bounds.bound_s(*work["dq"]) * 1e3 == pytest.approx(0.1974, abs=5e-5)
    assert bounds.bound_s(*work["dkv"]) * 1e3 == pytest.approx(0.2633, abs=5e-5)


def test_ssd_bound_matches_the_kernel_table():
    flops, nbytes = bounds.ssd_work(8, 2048, 24, 64, 128, 256)
    assert nbytes / bounds.PEAK_BYTES > flops / bounds.PEAK_FLOPS  # bytes-bound
    assert bounds.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.0354, abs=5e-5)
    assert bounds.bound_s(*bounds.ssd_work(2, 6144, 24, 64, 128, 256)) * 1e3 == pytest.approx(0.0256, abs=5e-5)


def test_visible_pairs():
    assert bounds.visible_pairs([1, 2, 3]) == 1 + 3 + 6
