"""Jamba-1.5-Large in the port against the JAX package, on the CPU: the
hybrid period (one GQA attention layer among Mamba-2 layers, MoE on every
second layer) through training, per-request serving and the launchers.

The smoke config (fp32; one period of 8 layers: attention at layer 4, MoE
of 4 experts top-2 on the even layers) with weights from the JAX
``LM.init`` (seed 0) through ``bridge.params_from_jax``; inputs are made
with numpy from a seed.  The tolerance is ``tests/test_kernels.py::_tol``'s
fp32 2e-5.  The SSD wrapper (K7) takes its plain version here.  The
serve-launcher and engine refusals cover both added architectures, and the
train launcher DeepSeek-V3.  The flash route, with the gradients of the
mean loss, and three trainer steps are in ``tests/test_torch_hybrid_run.py``.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM
from repro_torch.models.attention import KVCache
from repro_torch.models.blocks import stack_plan
from repro_torch.models.ssm import SSMCache
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig
from repro_torch.train import optimizer
from test_torch_archs import _assert_trees_close, _batch, _np, _torch_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

ARCH = "jamba_1_5_large"
TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def weights():
    """The JAX smoke weights as numpy (one init for the module)."""
    return jax.tree.map(np.asarray, jax.jit(JaxLM(jax_smoke_config(ARCH)).init)(jax.random.PRNGKey(0)))


def _pair(weights, **overrides):
    cfg = dataclasses.replace(get_smoke_config(ARCH), **overrides)
    model = LM(cfg, device="cpu")
    params = model.load_params(params_from_jax(weights, cfg, "cpu"))
    return JaxLM(dataclasses.replace(jax_smoke_config(ARCH), **overrides)), model, params


def test_the_smoke_is_one_hybrid_period():
    cfg = get_smoke_config(ARCH)
    kinds = [(cfg.layer_kind(l), cfg.layer_is_moe(l)) for l in range(cfg.n_layers)]
    assert kinds == [("ssm", True), ("ssm", False), ("ssm", True), ("ssm", False),
                     ("attn", True), ("ssm", False), ("ssm", True), ("ssm", False)]
    assert stack_plan(cfg).unit_layers == (tuple(range(8)),) and stack_plan(cfg).prefix_layers == ()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_forward_and_loss_match_jax(weights, packed):
    """The SSM layers ignore the segments (the state flows across packed
    samples, as in JAX); only the attention layer sees them."""
    jmodel, model, params = _pair(weights)
    batch = _batch(model.cfg, seed=12, s=64, packed=packed)
    jp = jax.tree.map(jnp.asarray, weights)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = model.forward(params, _torch_batch(batch))
        tsum, ttok = model.loss_sums(params, _torch_batch(batch))
    jlogits, (jsum, jtok) = jax.jit(lambda p, b: (jmodel.forward(p, b), jmodel.loss_sums(p, b)))(jp, jbatch)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL)
    assert float(ttok) == float(jtok) > 0
    np.testing.assert_allclose(float(tsum), float(jsum), **TOL)


def test_prefill_and_decode_steps_match_jax(weights):
    """``LM.prefill`` of 3 prompts of 40 tokens (the SSD over chunks of 16
    from a zero state, the attention layer's KV cache filled) and 4 greedy
    ``decode_step``s: ids and every step's logits against JAX's."""
    jmodel, model, params = _pair(weights)
    vocab = model.cfg.vocab_size
    prompts = np.random.default_rng(15).integers(1, vocab, (3, 40)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, weights)
    prefill, decode_step = jax.jit(jmodel.prefill, static_argnums=2), jax.jit(jmodel.decode_step)
    jlogits, jcaches = prefill(jp, jnp.asarray(prompts), 48)
    logits, caches = model.prefill(params, torch.from_numpy(prompts).long(), 48)
    kinds = [type(c) for c in caches]
    assert kinds == [KVCache if l == 4 else SSMCache for l in range(8)]
    ids, jids = [], []
    for step in range(5):
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), err_msg=f"step {step}", **TOL)
        tok, jtok = logits[:, -1, :vocab].argmax(-1, keepdim=True), jnp.argmax(jlogits[:, -1, :vocab], -1)[:, None]
        ids.append(tok[:, 0].tolist())
        jids.append(np.asarray(jtok)[:, 0].tolist())
        if step == 4:
            break
        logits, caches = model.decode_step(params, caches, tok, 40 + step)
        jlogits, jcaches = decode_step(jp, jcaches, jtok.astype(jnp.int32), jnp.array(40 + step, jnp.int32))
    assert ids == jids


def test_decode_steps_equal_the_forward(weights):
    """One prompt of 4 tokens and 4 ``decode_step``s (the SSM recurrence,
    the KV cache) give ``forward``'s logits at positions 3-7 (fp32 2e-5):
    with at most 8 tokens in a call no expert drops a pair."""
    _, model, params = _pair(weights)
    vocab = model.cfg.vocab_size
    tokens = torch.from_numpy(np.random.default_rng(16).integers(1, vocab, (1, 8))).long()
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})[..., :vocab]
    logits, caches = model.prefill(params, tokens[:, :4], 8)
    steps = [logits]
    for i in range(4, 8):
        logits, caches = model.decode_step(params, caches, tokens[:, i:i + 1], i)
        steps.append(logits)
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)[..., :vocab]), _np(full[:, 3:8]), **TOL)


def test_bridge_round_trip_exact(weights):
    """JAX tree -> port -> JAX tree exactly: one unit of 8 layers, whose
    ``sub{j}`` mix attention and Mamba-2 mixers, MoE and dense FFNs."""
    _, model, params = _pair(weights)
    _assert_trees_close(params_to_jax(params, model.cfg), weights, atol=0, rtol=0)
    assert sorted(weights["stack"]) == [f"sub{j}" for j in range(8)]
    assert "wq" in params["layers"][4]["mixer"] and "in_x" in params["layers"][0]["mixer"]
    assert "moe" in params["layers"][0] and "mlp" in params["layers"][1]
    assert {id(p) for p in model.parameters()} == {id(p) for p in optimizer.tree_leaves(params)}


# -- the launchers, both added architectures ---------------------------------------


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "jamba_1_5_large"])
def test_engine_and_serve_launcher_refuse(arch):
    """The continuous-batching engine serves GQA stacks only, as JAX's."""
    model = LM(get_smoke_config(arch), device="cpu")
    with pytest.raises(NotImplementedError, match="per-request prefill loop"):
        ContinuousBatchingEngine(model, None, ServeConfig(num_slots=2, max_len=64, l_max=128), device="cpu")
    from repro_torch.launch import serve

    with pytest.raises(NotImplementedError, match="MLA/SSM archs stay on the per-request prefill loop"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["deepseek_v3_671b"])
def test_train_launcher_trains(arch, capsys, monkeypatch):
    """The launcher builds the model from ``--arch`` and nothing else of it
    depends on the architecture; Jamba's trainer is held against JAX in
    ``tests/test_torch_hybrid_run.py`` (its launcher run is one of the verify
    notes' commands: the SSD's chunk loop makes it this file's slowest test
    when the workers share the CPU)."""
    from repro_torch.launch import train

    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                                      "--world", "2", "--l-max", "256", "--dataset", "uniform_narrow",
                                      "--data-scale", "0.05", "--log-every", "1"])
    train.main()
    out = capsys.readouterr().out
    losses = [float(line.split("loss")[1].split()[0].strip("=")) for line in out.splitlines()
              if line.lstrip().startswith("step") and "loss" in line]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert "eta_identity=0.0 eta_quota=0.0" in out
