"""The benchmark's weights: a rule for every leaf of every port
architecture, the small cells' tensors as recorded, experts unlike one
another, norms at one and biases at zero."""

import hashlib
import json
import math

import pytest
import torch
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config

from odb_bench import harness, weights
from odb_bench.tests import smallcell
from odb_bench.tests.conftest import ROOT

RECORDED = json.loads((ROOT / "odb_bench" / "tests" / "small_readings.json").read_text())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_leaf_of_the_full_tree_has_a_rule(arch):
    specs = harness.leaf_specs(get_config(arch))
    assert [weights.kind(path, shape) for path, shape, _ in specs]


def digest(specs, tensors) -> str:
    h = hashlib.sha256()
    for (path, _, _), w in zip(specs, tensors):
        h.update(repr((path, tuple(w.shape), str(w.dtype))).encode())
        h.update(w.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", ("qwen3_0_6b", "mamba2_130m"))
def test_small_cell_tensors_are_as_recorded(name):
    specs = harness.leaf_specs(harness.port_config(smallcell.config(name)))
    assert digest(specs, weights.make(specs, 2**31 + 7, "cpu")) == RECORDED[name]["weights_sha256"]


def test_expert_slabs_differ_with_the_spread_of_their_width():
    specs = harness.leaf_specs(get_smoke_config("deepseek_v3_671b"))
    slabs = [(p, w) for (p, s, _), w in zip(specs, weights.make(specs, 5, "cpu")) if len(s) == 3]
    assert slabs
    for path, w in slabs:
        w = w.float()
        for i in range(w.shape[0]):
            # a standard normal clamped at ±2 has a deviation of 0.959
            assert 0.9 < float(w[i].std()) * math.sqrt(w.shape[1]) < 1.02, (path, i)
            for j in range(i):
                assert not torch.equal(w[i], w[j]), (path, i, j)


def test_norms_are_ones_and_biases_zeros():
    specs = [(("attn", "kv_norm"), (16,), torch.bfloat16), (("moe", "router_bias"), (8,), torch.float32),
             (("mixer", "conv_bias"), (12,), torch.float32), (("mixer", "dt_bias"), (4,), torch.float32),
             (("w",), (8, 4), torch.float32)]
    kv_norm, router_bias, conv_bias, dt_bias, _ = weights.make(specs, 3, "cpu")
    assert torch.equal(kv_norm, torch.ones(16, dtype=torch.bfloat16))
    for bias in (router_bias, conv_bias, dt_bias):
        assert torch.equal(bias, torch.zeros_like(bias))


@pytest.mark.parametrize("path, shape", [(("gamma",), (8,)), (("norm_w",), (8,)), (("w",), (2, 2, 2, 2))])
def test_a_leaf_with_no_rule_raises(path, shape):
    with pytest.raises(ValueError, match="no initialisation rule"):
        weights.kind(path, shape)


def test_host_like_gives_disjoint_aligned_views():
    tensors = [torch.ones(3, 5, dtype=torch.bfloat16), torch.ones(7, dtype=torch.float32),
               torch.ones(0, 4, dtype=torch.bfloat16), torch.ones(2, dtype=torch.int64)]
    host = weights.host_like(tensors, pin=False)
    for h, t in zip(host, tensors):
        assert (h.shape, h.dtype, h.device.type) == (t.shape, t.dtype, "cpu")
        assert h.data_ptr() % 16 == 0
        h.copy_(t)
    host[0].zero_()
    assert all(torch.equal(h, t) for h, t in zip(host[1:], tensors[1:]))
