"""The port's Eq. 2 data-parallel step against the JAX package, on the CPU.

``core/loss_scaling.py`` runs every case of tests/test_loss_scaling.py;
``train/compression.py`` matches JAX's bit for bit; ``dp_step`` runs over
gloo in 2 and 3 spawned ranks (``tests/_torch_rank_worker.py``) and is held
against the JAX ``make_train_step`` on the concatenated batch: the loss, the
reduced gradients and ``grad_norm`` at 2e-5 in fp32, every rank's
parameters equal after the step, and the three loss modes against
``ddp_scaled_loss``.  A subprocess runs the JAX ``dp_shardmap_step`` on two
forced host devices and shows its gradient is W times the port's: the
reference differentiates ``psum(scaled) / W`` inside
``shard_map(check_vma=False)`` (the transpose of psum is psum) and then sums
the gradients again.  The port follows the intent; the JAX package is left
as it is.
"""

import dataclasses
import json
import multiprocessing as mp
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import RankLossStats as JaxRankLossStats
from repro.core import ddp_scaled_loss as jax_ddp_scaled_loss
from repro.models import LM as JaxLM
from repro.train import compression as jax_compression
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.core import (
    RankLossStats,
    ddp_scaled_loss,
    prescale_factor,
    prescaled_loss,
    reference_per_token_loss,
)
from repro_torch.train import compression

import _torch_rank_worker

TOL = dict(atol=2e-5, rtol=2e-5)
APPROX = dict(abs=2e-5, rel=2e-5)
VOCAB = 64
CFG = dict(vocab_size=VOCAB, dtype="float32")


# -- loss scaling: every case of tests/test_loss_scaling.py --------------------


def stats_from(per_rank_token_losses):
    out = []
    for losses in per_rank_token_losses:
        arr = np.asarray(losses, dtype=np.float64)
        out.append(RankLossStats(loss_sum=float(arr.sum()), tokens=len(arr),
                                 samples=max(1, len(arr) // 7)))
    return out


@st.composite
def rank_losses(draw, max_world=8):
    world = draw(st.integers(1, max_world))
    return [
        draw(st.lists(st.floats(0.0, 20.0, allow_nan=False, width=32), min_size=1, max_size=200))
        for _ in range(world)
    ]


class TestEq2Exactness:
    @given(rank_losses())
    @settings(max_examples=80, deadline=None)
    def test_exact_token_equals_reference_bitwise(self, per_rank):
        stats = stats_from(per_rank)
        scaled = ddp_scaled_loss(stats, "exact_token")
        ref = reference_per_token_loss(stats)
        assert scaled == ref or abs(scaled - ref) <= 4 * np.finfo(np.float64).eps * max(abs(ref), 1.0)

    @given(rank_losses(max_world=6))
    @settings(max_examples=60, deadline=None)
    def test_naive_average_biased_unless_equal_tokens(self, per_rank):
        stats = stats_from(per_rank)
        naive = float(np.mean([s.mean_loss for s in stats]))
        ref = reference_per_token_loss(stats)
        if len({s.tokens for s in stats}) == 1:
            assert abs(naive - ref) < 1e-9

    @given(rank_losses(max_world=6))
    @settings(max_examples=40, deadline=None)
    def test_every_mode_equals_jax(self, per_rank):
        stats = stats_from(per_rank)
        jstats = [JaxRankLossStats(**dataclasses.asdict(s)) for s in stats]
        for mode in ("sample", "approx_token", "exact_token"):
            assert ddp_scaled_loss(stats, mode) == jax_ddp_scaled_loss(jstats, mode)

    def test_sample_level_exact_only_when_tokens_per_sample_constant(self):
        stats = [RankLossStats(loss_sum=10.0, tokens=10, samples=2),
                 RankLossStats(loss_sum=40.0, tokens=20, samples=4)]
        assert abs(ddp_scaled_loss(stats, "sample") - reference_per_token_loss(stats)) < 1e-12
        stats = [RankLossStats(loss_sum=10.0, tokens=10, samples=2),
                 RankLossStats(loss_sum=60.0, tokens=40, samples=2)]
        assert abs(ddp_scaled_loss(stats, "sample") - reference_per_token_loss(stats)) > 1e-3

    def test_idle_rank_annihilated(self):
        stats = [RankLossStats(loss_sum=30.0, tokens=15, samples=3),
                 RankLossStats(loss_sum=0.0, tokens=0, samples=0)]
        assert ddp_scaled_loss(stats, "exact_token") == 2.0
        assert reference_per_token_loss(stats) == 2.0

    def test_approx_mode_uses_prealignment_means(self):
        stats = [
            RankLossStats(loss_sum=30.0, tokens=12, samples=3,
                          tokens_pre_alignment=40, samples_pre_alignment=10),
            RankLossStats(loss_sum=10.0, tokens=10, samples=2,
                          tokens_pre_alignment=25, samples_pre_alignment=5),
        ]
        assert abs(ddp_scaled_loss(stats, "exact_token") - ddp_scaled_loss(stats, "approx_token")) < 1e-12

    def test_all_idle_step(self):
        stats = [RankLossStats(loss_sum=0.0, tokens=0, samples=0)] * 4
        for mode in ("sample", "approx_token", "exact_token"):
            assert ddp_scaled_loss(stats, mode) == 0.0

    def test_prescale_factor_on_tensors_matches_numpy_path(self):
        stats = [RankLossStats(loss_sum=7.0, tokens=7, samples=2),
                 RankLossStats(loss_sum=24.0, tokens=12, samples=3)]
        t_tok, w = sum(s.tokens for s in stats), len(stats)
        vals = [float(prescale_factor(torch.tensor(float(s.tokens)), torch.tensor(float(t_tok)), w))
                * s.mean_loss for s in stats]
        assert abs(sum(vals) / w - reference_per_token_loss(stats)) < 1e-5

    def test_prescaled_loss_stable_form(self):
        """The token modes' prescaled losses average to Σ ℓ_sum / T_tok as
        the stable form rounds; sample mode scales the local mean."""
        sums, toks, samples = [7.0, 24.0, 0.0], [7.0, 12.0, 0.0], [2.0, 3.0, 0.0]
        t = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
        for mode in ("exact_token", "approx_token", "sample"):
            scaled = [prescaled_loss(t(ls), t(tk), t(19.0), 3, mode, local_samples=t(n),
                                     global_samples=t(5.0)) for ls, tk, n in zip(sums, toks, samples)]
            stats = [RankLossStats(loss_sum=ls, tokens=int(tk), samples=int(n))
                     for ls, tk, n in zip(sums, toks, samples)]
            assert float(sum(scaled) / 3) == pytest.approx(ddp_scaled_loss(stats, mode), rel=1e-15)


# -- compression: bit for bit against JAX ----------------------------------------


@pytest.mark.parametrize("steps", [1, 5])
def test_compress_decompress_bitwise_equal_to_jax(steps):
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((64, 33), dtype=np.float32) * 1e-3,
             "b": {"c": rng.standard_normal((257,), dtype=np.float32) * 7.0}}
    jg = jax.tree.map(jnp.asarray, grads)
    tg = {"a": torch.from_numpy(grads["a"]), "b": {"c": torch.from_numpy(grads["b"]["c"])}}
    jerr, terr = jax_compression.init_error_state(jg), compression.init_error_state(tg)
    for _ in range(steps):
        jq, jerr = jax_compression.compress_decompress(jg, jerr)
        tq, terr = compression.compress_decompress(tg, terr)
        for path in (("a",), ("b", "c")):
            jv, tv, je, te = jq, tq, jerr, terr
            for key in path:
                jv, tv, je, te = jv[key], tv[key], je[key], te[key]
            assert tv.dtype == torch.bfloat16 and te.dtype == torch.float32
            np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                          np.asarray(jv).view(np.int16))
            np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_error_feedback_unbiased_over_steps():
    g = {"w": torch.full((256,), 1.0 + 2.0**-12)}  # not bf16-representable
    err = compression.init_error_state(g)
    acc = torch.zeros(256)
    for _ in range(64):
        gq, err = compression.compress_decompress(g, err)
        acc += gq["w"].float()
    np.testing.assert_allclose((acc / 64).numpy(), g["w"].numpy(), rtol=1e-4)


# -- dp_step over gloo against the JAX step on the global batch ------------------


def _global_batch(world: int) -> dict:
    """W = 2: the two rows of the reference's fault check (2 x 16, row 1
    masked after position 10).  W = 3: 6 x 16 with a fully masked row (an
    IDLE-like rank block), so the ranks' token counts differ."""
    rng = np.random.default_rng(0)
    b = 2 if world == 2 else 6
    tokens = rng.integers(0, VOCAB, (b, 16)).astype(np.int32)
    mask = np.ones((b, 16), np.float32)
    mask[:, -1] = 0.0
    mask[1, 10:] = 0.0
    if world == 3:
        mask[3] = 0.0
        mask[4, 5:] = 0.0
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1), "loss_mask": mask}


def _jax_model():
    cfg = dataclasses.replace(jax_smoke_config("qwen3_0_6b"), **CFG)
    model = JaxLM(cfg)
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))


RUNS = {2: [("exact_token", False), ("sample", False), ("approx_token", False),
            ("exact_token", True)],
        3: [("exact_token", False)]}


def _spawn(target, world: int, args_of) -> None:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(rank)) for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


def _dp_run(world: int, tmp) -> dict:
    model, params = _jax_model()
    batch = _global_batch(world)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"cfg": CFG, "params": params, "batch": batch, "runs": RUNS[world]}, f)
    _spawn(_torch_rank_worker.dp_rank, world,
           lambda r: (r, world, str(tmp / "pg"), str(tmp / "inputs.pkl"), str(tmp / f"out{r}.pkl")))
    ranks = []
    for r in range(world):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(world=world, model=model, params=params, batch=batch, ranks=ranks, tmp=tmp)


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    return _dp_run(2, tmp_path_factory.mktemp("dp2"))


@pytest.fixture(scope="module")
def dp3(tmp_path_factory):
    return _dp_run(3, tmp_path_factory.mktemp("dp3"))


@pytest.fixture(params=["dp2", "dp3"])
def dp_run(request):
    return request.getfixturevalue(request.param)


def _jax_reference(model, params, batch):
    """JAX ``make_train_step`` on the global batch, and the gradient of the
    global per-token mean it steps on."""
    jbatch = jax.tree.map(jnp.asarray, batch)
    opt_cfg = JaxOptimizerConfig()

    def loss_fn(p):
        loss_sum, tokens = model.loss_sums(p, jbatch)
        return loss_sum / jnp.maximum(tokens, 1.0)

    grads = jax.grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    state = {"params": jax.tree.map(jnp.asarray, params)}
    state["opt"] = jax_init_opt_state(state["params"], opt_cfg)
    state, metrics = jax.jit(jax_make_train_step(model, opt_cfg))(state, jbatch)
    return metrics, grads, state["params"]


def _assert_trees_close(port, ref, **tol):
    flat_p = jax.tree_util.tree_leaves_with_path(port)
    flat_r = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(flat_p) == len(flat_r)
    for path, leaf in flat_p:
        np.testing.assert_allclose(np.asarray(leaf, np.float32), np.asarray(flat_r[path], np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def test_dp_step_matches_jax_global_step(dp_run):
    """Loss, reduced gradients and grad_norm equal the JAX step's on the
    concatenated batch at 2e-5; the parameters after the step too."""
    metrics, grads, params = _jax_reference(dp_run["model"], dp_run["params"], dp_run["batch"])
    run = dp_run["ranks"][0][0]
    assert run["metrics"]["loss"] == pytest.approx(float(metrics["loss"]), **APPROX)
    assert run["metrics"]["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), **APPROX)
    assert run["metrics"]["tokens"] == float(dp_run["batch"]["loss_mask"].sum())
    _assert_trees_close(run["grads"], grads, **TOL)
    _assert_trees_close(run["params"], params, **TOL)


def test_dp_ranks_hold_equal_parameters(dp_run):
    """Every rank applies the same reduced gradient: parameters, gradients
    and metrics equal across ranks bit for bit, in every run."""
    first = dp_run["ranks"][0]
    for other in dp_run["ranks"][1:]:
        for a, b in zip(first, other):
            assert a["metrics"] == b["metrics"]
            for tree in ("grads", "params"):
                for (pa, la), (pb, lb) in zip(jax.tree_util.tree_leaves_with_path(a[tree]),
                                              jax.tree_util.tree_leaves_with_path(b[tree])):
                    assert pa == pb
                    np.testing.assert_array_equal(la, lb)


def _rank_stats(model, params, batch, world) -> list:
    stats = []
    for r in range(world):
        rows = {k: jnp.asarray(v[r * v.shape[0] // world:(r + 1) * v.shape[0] // world])
                for k, v in batch.items()}
        loss_sum, tokens = model.loss_sums(jax.tree.map(jnp.asarray, params), rows)
        samples = int(np.asarray(rows["loss_mask"]).max(axis=1).sum())
        stats.append(JaxRankLossStats(loss_sum=float(loss_sum), tokens=int(tokens), samples=samples))
    return stats


@pytest.mark.parametrize("index", [0, 1, 2], ids=["exact_token", "sample", "approx_token"])
def test_dp_loss_modes_match_ddp_scaled_loss(dp2, index):
    mode = RUNS[2][index][0]
    stats = _rank_stats(dp2["model"], dp2["params"], dp2["batch"], 2)
    got = dp2["ranks"][0][index]["metrics"]["loss"]
    assert got == pytest.approx(jax_ddp_scaled_loss(stats, mode), **APPROX)


def test_dp_compressed_gradients_within_bf16(dp2):
    """bf16 all-reduce with error feedback: the reduced gradient within the
    bf16 tolerance of the exact one, the loss unchanged (it is reduced
    before compression)."""
    exact, compressed = dp2["ranks"][0][0], dp2["ranks"][0][3]
    assert compressed["metrics"]["loss"] == exact["metrics"]["loss"]
    _assert_trees_close(compressed["grads"], exact["grads"], atol=2e-2, rtol=2e-2)
    assert compressed["metrics"]["grad_norm"] == pytest.approx(exact["metrics"]["grad_norm"], rel=2e-2)


_JAX_DP = textwrap.dedent('''
    import dataclasses, json, pickle, sys
    import jax, jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_host_mesh
    from repro.models import LM
    from repro.train.optimizer import OptimizerConfig, init_opt_state
    from repro.train.trainer import dp_shardmap_step

    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    model = LM(dataclasses.replace(get_smoke_config("qwen3_0_6b"), **inp["cfg"]))
    params = jax.tree.map(jnp.asarray, inp["params"])
    opt_cfg = OptimizerConfig()
    step, init_err = dp_shardmap_step(model, make_host_mesh(), opt_cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    _, metrics, _ = step(state, jax.tree.map(jnp.asarray, inp["batch"]), init_err(params))
    print(json.dumps({"devices": jax.device_count(), "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"])}))
''')


def test_jax_dp_shardmap_step_gradient_is_world_times_the_port(dp2):
    """The reference's fault, documented: at W = 2 the JAX dp_shardmap_step
    reports the same loss as the port, and a grad_norm W times the port's
    (the gradient of the loss it reports, as the JAX make_train_step gives)."""
    src = str(pathlib.Path(jax_compression.__file__).resolve().parents[2])
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": src,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    proc = subprocess.run([sys.executable, "-c", _JAX_DP, str(dp2["tmp"] / "inputs.pkl")],
                          env=env, capture_output=True, text=True, timeout=240, check=True)
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    port = dp2["ranks"][0][0]["metrics"]
    assert ref["devices"] == 2
    assert ref["loss"] == pytest.approx(port["loss"], **APPROX)
    assert ref["grad_norm"] == pytest.approx(2 * port["grad_norm"], rel=2e-5)
