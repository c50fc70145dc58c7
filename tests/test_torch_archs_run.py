"""The added architectures through the port's entry points against the JAX
package's, on the CPU: the serving engine (DeepSeek-7B, Yi-34B,
Chameleon-34B, Arctic-480B smokes) and three trainer steps (OLMo-1B,
Arctic-480B smokes).

Weights come from the JAX ``LM.init`` (seed 0) through
``bridge.params_from_jax``; fp32.  The engines must generate identical ids
with identical stats, their picked prefill logits within 1e-4 (as
``tests/test_torch_serve.py``); the trainers' per-step loss and grad_norm
agree at rtol 1e-4 and the weights afterwards within 2·Σ lr_t (as
``tests/test_torch_train.py``, whose reasons hold here).  The flash route's
JAX side runs its Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import BucketSpec as JaxBucketSpec
from repro.core import OdbConfig as JaxOdbConfig
from repro.data import OnlineDynamicLoader as JaxLoader
from repro.data import get_dataset as jax_get_dataset
from repro.models import LM as JaxLM
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import ServeConfig as JaxServeConfig
from repro.train import optimizer as jax_optimizer
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.models import LM
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, synth_request_trace
from repro_torch.train import optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

SERVE = dict(num_slots=4, max_len=128, l_max=384, lookahead=8)
STATS = ("decode_steps", "prefill_calls", "admitted", "finished", "generated_tokens",
         "peak_projected_tokens", "peak_active_slots")


def _jax_weights(arch: str) -> dict:
    return jax.tree.map(np.asarray, JaxLM(jax_smoke_config(arch)).init(jax.random.PRNGKey(0)))


def _serve(engine, trace):
    """Serve ``trace``; the generated ids, the stats and every prefill
    call's picked logits (the engine discards them after the argmax)."""
    picked: list = []
    lookup = engine._prefill_fn

    def wrapped(shape):
        fn = lookup(shape)

        def call(*args):
            out, caches = fn(*args)
            picked.append(np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out))
            return out, caches

        return call

    engine._prefill_fn = wrapped
    rids = [engine.submit(p, n) for p, n in trace]
    outputs = engine.run()
    return [outputs[r].tolist() for r in rids], engine.stats, picked


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("arch", ["deepseek_7b", "yi_34b", "chameleon_34b", "arctic_480b"])
def test_engine_matches_jax_engine(arch, impl):
    jcfg = dataclasses.replace(jax_smoke_config(arch), attn_impl=impl)
    tcfg = dataclasses.replace(get_smoke_config(arch), attn_impl=impl)
    weights = _jax_weights(arch)
    trace = synth_request_trace(10, vocab=tcfg.vocab_size, prompt_min=4, prompt_max=40,
                                new_min=2, new_max=16, seed=1)
    jids, jstats, jpicked = _serve(JaxEngine(JaxLM(jcfg), weights, JaxServeConfig(**SERVE)), trace)
    model = LM(tcfg, device="cpu")
    params = model.load_params(params_from_jax(weights, tcfg, "cpu"))
    engine = ContinuousBatchingEngine(model, params, ServeConfig(**SERVE), device="cpu")
    ids, stats, picked = _serve(engine, trace)

    assert ids == jids
    assert {k: getattr(stats, k) for k in STATS} == {k: getattr(jstats, k) for k in STATS}
    assert stats.finished == len(trace) and engine.decode_traces == 1
    assert len(picked) == len(jpicked) == stats.prefill_calls
    for ours, theirs in zip(picked, jpicked):
        np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=1e-4)


# Short samples (64-512 tokens) keep the steps at (2, 512), as in test_torch_train.py.
LOADER = dict(world_size=2, layout="packed", vocab_size=512)
ODB = dict(l_max=512, buffer_size=64, prefetch_factor=16, num_workers=4, join_mode=True)
BUCKETS = dict(min_len=128, max_len=16384, max_count=1024)


@pytest.mark.parametrize("arch", ["olmo_1b", "arctic_480b"])
def test_trainer_three_steps_match_jax(arch):
    """Three steps of the JAX trainer and of the port's (packed, flash
    pruned; the port's kernels on their plain versions) from the same
    weights on the same streaming data path."""
    three_trainer_steps(arch, attn_impl="flash", attn_grid="pruned")


def three_trainer_steps(arch: str, weights: dict | None = None, **overrides) -> None:
    """Three steps of the JAX trainer and of the port's on ``arch``'s smoke
    config with ``overrides`` (the attention route), from the same weights
    (``weights``, numpy, or the JAX ``LM.init``'s) on the same packed
    streaming data path: per-step tokens, loss and grad_norm, and the
    weights afterwards."""
    steps = 3
    weights = _jax_weights(arch) if weights is None else weights
    jcfg = dataclasses.replace(jax_smoke_config(arch), **overrides)
    tcfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    opt = dict(total_steps=100)
    data = ("uniform_narrow", 0.05)
    jloader = JaxLoader(jax_get_dataset(data[0], scale=data[1]), config=JaxOdbConfig(**ODB),
                        bucket_spec=JaxBucketSpec(**BUCKETS), **LOADER)
    jtrainer = JaxTrainer(JaxLM(jcfg), jloader, jax_optimizer.OptimizerConfig(**opt),
                          JaxTrainerConfig(log_every=1, max_steps=steps, prefetch=False))
    jstate, _ = jtrainer.train_epoch({"params": jax.tree.map(jnp.asarray, weights),
                                      "opt": jax_optimizer.init_opt_state(
                                          jax.tree.map(jnp.asarray, weights),
                                          jax_optimizer.OptimizerConfig(**opt))})

    loader = OnlineDynamicLoader(get_dataset(data[0], scale=data[1]), config=OdbConfig(**ODB),
                                 bucket_spec=BucketSpec(**BUCKETS), **LOADER)
    model = LM(tcfg, device="cpu")
    trainer = Trainer(model, loader, optimizer.OptimizerConfig(**opt),
                      TrainerConfig(log_every=1, max_steps=steps))
    params = model.load_params(params_from_jax(weights, tcfg, "cpu"))
    state, n = trainer.train_epoch({"params": params,
                                    "opt": optimizer.init_opt_state(params, trainer.opt_cfg)})
    assert n == steps
    if "attn_impl" in overrides:
        assert (trainer.attn_impl, trainer.attn_grid) == (overrides["attn_impl"], overrides["attn_grid"])
    assert len(trainer.history) == len(jtrainer.history) == steps
    for ours, theirs in zip(trainer.history, jtrainer.history):
        assert ours["tokens"] == theirs["tokens"]
        np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-4)
        np.testing.assert_allclose(ours["grad_norm"], theirs["grad_norm"], rtol=1e-4)
    lr_sum = sum(float(jax_optimizer.cosine_lr(jnp.float32(t), jtrainer.opt_cfg))
                 for t in range(1, steps + 1))
    ours = jax.tree.leaves_with_path(params_to_jax(state["params"], tcfg))
    theirs = jax.tree.leaves_with_path(jstate["params"])
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    moved = 0.0
    for (path, a), (_, b), p0 in zip(ours, theirs, jax.tree.leaves(weights)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2 * lr_sum, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, float(np.abs(a - p0).max()))
    assert moved > lr_sum / 2  # the weights did move
