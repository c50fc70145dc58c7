"""The port's training slice against the JAX package's, on the CPU.

Same inputs on both sides, made with numpy from a seed; model weights come
from the JAX ``LM.init`` through ``bridge.params_from_jax`` and go back
through ``bridge.params_to_jax`` for comparison.  The JAX flash kernels run
in interpret mode, as tests/test_kernels.py runs them; the port's kernel
wrappers take their plain versions on CPU tensors.  Tolerances are those of
``tests/test_kernels.py::_tol`` (fp32 2e-5, bf16 2e-2) unless a test states
another with its reason.
"""

import dataclasses
import sys

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
from repro.kernels.ops import flash_attention as jax_flash_attention
from repro.models import LM as JaxLM
from repro.models.model import shift_labels as jax_shift_labels
from repro.train import optimizer as jax_optimizer
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.core.layout import global_batch_arrays
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import LM
from repro_torch.train import optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig, assemble_model_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype: str) -> dict:
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _packed_segments(rng, b: int, s: int) -> np.ndarray:
    """Three or four segments per row with a padding tail; the last row of a
    batch of 3 is all padding."""
    seg = np.zeros((b, s), np.int32)
    for i in range(b if b < 3 else b - 1):
        end = s - int(rng.integers(1, s // 4))
        n = 3 + i % 2
        cuts = np.sort(rng.choice(np.arange(1, end), size=n - 1, replace=False))
        for j, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, end])):
            seg[i, lo:hi] = j + 1
    return seg


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_smoke_config("qwen3_0_6b")
    return jax.tree.map(np.asarray, JaxLM(cfg).init(jax.random.PRNGKey(0)))


def _loader_kwargs(world: int, layout: str, join: bool = True, l_max: int = 512) -> dict:
    return dict(
        world_size=world, layout=layout, vocab_size=512,
        config=dict(l_max=l_max, buffer_size=64, prefetch_factor=16, num_workers=4,
                    join_mode=join),
        bucket_spec=dict(min_len=128, max_len=16384, max_count=1024),
    )


# Short samples (64-512 tokens) keep the model tests' steps at (2, 512).
SMALL = ("uniform_narrow", 0.05)


def _port_loader(world, layout, join=True, l_max=512, data=SMALL):
    kw = _loader_kwargs(world, layout, join, l_max)
    return OnlineDynamicLoader(
        get_dataset(data[0], scale=data[1]), kw["world_size"], OdbConfig(**kw["config"]),
        bucket_spec=BucketSpec(**kw["bucket_spec"]), layout=layout, vocab_size=kw["vocab_size"],
    )


def _jax_loader(world, layout, join=True, l_max=512, data=SMALL):
    kw = _loader_kwargs(world, layout, join, l_max)
    return JaxLoader(
        jax_get_dataset(data[0], scale=data[1]), kw["world_size"], JaxOdbConfig(**kw["config"]),
        bucket_spec=JaxBucketSpec(**kw["bucket_spec"]), layout=layout, vocab_size=kw["vocab_size"],
    )


# -- (a) the flash-attention gradient ------------------------------------------

# (B, S, H, KV, D, block_q, block_kv, segments, grid, dtype)
GRAD_CASES = [
    (3, 256, 4, 2, 16, 128, 128, True, "pruned", "float32"),  # GQA, all-padding row
    (3, 256, 4, 2, 16, 64, 128, True, "dense", "float32"),
    (2, 200, 4, 1, 16, 128, 128, True, "pruned", "float32"),  # S = 200 -> block 40
    (2, 200, 4, 1, 16, 128, 128, True, "dense", "float32"),
    (2, 128, 4, 4, 16, 64, 64, False, "dense", "float32"),  # no segments
    (2, 256, 4, 2, 16, 128, 128, True, "pruned", "bfloat16"),
]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_flash_grads_match_jax(case):
    b, s, h, kv, d, bq, bk, with_seg, grid, dtype = case
    rng = np.random.default_rng(7)
    q, k, v, w = (rng.standard_normal((b, s, n, d), dtype=np.float32) for n in (h, kv, kv, h))
    seg = _packed_segments(rng, b, s) if with_seg else None
    jt = JAX_DTYPES[dtype]

    def jax_loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, None if seg is None else jnp.asarray(seg),
                                  True, bq, bk, grid)
        return jnp.sum(out.astype(jnp.float32) * w)

    theirs = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jt) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(TORCH_DTYPES[dtype]).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, None if seg is None else torch.from_numpy(seg),
                          True, bq, bk, grid)
    ours = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for name, a, ref in zip(("dq", "dk", "dv"), ours, theirs):
        assert a.dtype == TORCH_DTYPES[dtype], name
        np.testing.assert_allclose(_np(a), np.asarray(ref, np.float32), err_msg=name, **_tol(dtype))
    if seg is not None:  # all-padding positions get exactly zero gradient
        assert np.all(_np(ours[0])[seg == 0] == 0)
        assert np.all(_np(ours[1])[seg == 0] == 0) and np.all(_np(ours[2])[seg == 0] == 0)


# -- (b) the model's loss and gradients ----------------------------------------


def _first_batch(layout: str):
    loader = _port_loader(2, layout)
    step = next(iter(loader.epoch(0)))
    return step, loader.layout


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_sums_and_grads_match_jax(jax_params, layout, impl):
    step, lay = _first_batch(layout)
    arrays = global_batch_arrays(step.batches, lay)
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_0_6b"), attn_impl=impl, attn_grid="pruned")
    tcfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), attn_impl=impl, attn_grid="pruned")

    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    segs = jbatch.get("segments")
    jbatch["labels"], jbatch["loss_mask"] = jax_shift_labels(jbatch["tokens"], jbatch["loss_mask"],
                                                             segments=segs)
    jmodel = JaxLM(jcfg)
    jp = jax.tree.map(jnp.asarray, jax_params)
    jsum, jtok = jmodel.loss_sums(jp, jbatch)
    jgrads = jax.grad(lambda p: jnp.divide(*jmodel.loss_sums(p, jbatch)))(jp)

    model = LM(tcfg, device="cpu")
    params = model.load_params(params_from_jax(jax_params, tcfg, "cpu"))
    batch = assemble_model_batch(step, lay, "cpu")
    tsum, ttok = model.loss_sums(params, batch)
    leaves = optimizer.tree_leaves(params)
    flat = dict(zip(map(id, leaves), torch.autograd.grad(tsum / ttok, leaves)))
    tgrads = params_to_jax(optimizer.tree_map(lambda p: flat[id(p)], params), tcfg)

    assert float(ttok) == float(jtok) > 0
    np.testing.assert_allclose(float(tsum.detach()), float(jsum), **_tol("float32"))
    ours, theirs = jax.tree.leaves_with_path(tgrads), jax.tree.leaves_with_path(jgrads)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, ref) in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(ref), err_msg=jax.tree_util.keystr(path),
                                   **_tol("float32"))


# -- (c) the optimizer -----------------------------------------------------------


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(moment_dtype, param_dtype):
    rng = np.random.default_rng(11)
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5)}}

    def tree(scale):
        def leaf(shape):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        return {"a": leaf(shapes["a"]), "b": {k: leaf(v) for k, v in shapes["b"].items()}}

    cfg = dict(lr=1e-2, total_steps=10, warmup_ratio=0.2, moment_dtype=moment_dtype, grad_clip=1.0)
    init = tree(1.0)
    grads = [tree(s) for s in (3.0, 0.1, 1.0)]  # the first is clipped (norm > 1)
    jt, tt = JAX_DTYPES[param_dtype], TORCH_DTYPES[param_dtype]
    jcfg, tcfg = jax_optimizer.OptimizerConfig(**cfg), optimizer.OptimizerConfig(**cfg)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jt), init)
    jst = jax_optimizer.init_opt_state(jp, jcfg)
    tp = optimizer.tree_map(lambda a: torch.from_numpy(a).to(tt), init)
    tst = optimizer.init_opt_state(tp, tcfg)
    for g in grads:
        jp, jst, jm = jax_optimizer.adamw_update(jp, jax.tree.map(lambda a: jnp.asarray(a, jt), g),
                                                jst, jcfg)
        tm = optimizer.adamw_update(tp, optimizer.tree_map(lambda a: torch.from_numpy(a).to(tt), g),
                                    tst, tcfg)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        for ours, theirs, dt in ((tp, jp, param_dtype), (tst["m"], jst["m"], moment_dtype),
                                 (tst["v"], jst["v"], moment_dtype)):
            for a, b in zip(optimizer.tree_leaves(ours), jax.tree.leaves(theirs)):
                assert a.dtype == TORCH_DTYPES[dt]
                np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), **_tol(dt))
    assert int(tst["step"]) == int(jst["step"]) == len(grads)
    for step in (0.0, 1.0, 2.0, 5.0, 9.0, 10.0, 12.0):
        np.testing.assert_allclose(
            float(optimizer.cosine_lr(torch.tensor(step), tcfg)),
            float(jax_optimizer.cosine_lr(jnp.float32(step), jcfg)), rtol=1e-6,
        )


@pytest.mark.parametrize("chunk", [1 << 28, 7], ids=["one-call", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_matches_jax(dtype, chunk, monkeypatch):
    """The fp32 norm over a tree, with leaves summed whole or, past
    ``NORM_CHUNK`` elements, a chunk at a time, against JAX's (fp32 2e-5)."""
    monkeypatch.setattr(optimizer, "NORM_CHUNK", chunk)
    rng = np.random.default_rng(12)
    tree = {"a": rng.standard_normal((4, 8)), "b": [rng.standard_normal(5), rng.standard_normal((3, 2))],
            "c": np.float32(2.5)}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    ours = optimizer.global_norm(optimizer.tree_map(lambda a: torch.from_numpy(a).to(TORCH_DTYPES[dtype]), tree))
    theirs = jax_optimizer.global_norm(jax.tree.map(lambda a: jnp.asarray(a, JAX_DTYPES[dtype]), tree))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(float(ours), float(theirs), rtol=2e-5)


# -- (d) the data path -------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "packed"])
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("join", [True, False])
def test_loader_epoch_matches_jax_streaming(layout, world, join):
    """The port's eager epoch against the JAX package's default training data
    path, ``streaming_epoch`` at the full lookahead (no prefetch thread):
    every array of every rank batch, the step metadata, the accounting and
    the epoch audit.  One audit field differs between the two JAX paths
    themselves: in non-join mode the streaming executor counts one protocol
    round fewer in ``rounds`` than the eager engine (``rounds_offline``
    agrees), so ``rounds`` is held against the JAX eager epoch instead."""
    data = ("ultrachat", 0.0005)
    ours_loader = _port_loader(world, layout, join, data=data)
    theirs_loader = _jax_loader(world, layout, join, data=data)
    ours = list(ours_loader.epoch(0))
    theirs = list(theirs_loader.streaming_epoch(0, lookahead=None, prefetch=False))
    assert len(ours) == len(theirs) > 2
    for a, b in zip(ours, theirs):
        assert dataclasses.asdict(a.metadata) == dataclasses.asdict(b.metadata)
        assert len(a.batches) == len(b.batches) == world
        for x, y in zip(a.batches, b.batches):
            for field in ("tokens", "positions", "segments", "loss_mask", "lengths"):
                np.testing.assert_array_equal(getattr(x, field), getattr(y, field))
            assert (x.real_samples, x.real_tokens) == (y.real_samples, y.real_tokens)
    ours_audit = dataclasses.asdict(ours_loader.last_audit)
    theirs_audit = dataclasses.asdict(theirs_loader.last_audit)
    rounds = ours_audit.pop("rounds")
    theirs_audit.pop("rounds")
    assert ours_audit == theirs_audit
    eager = _jax_loader(world, layout, join, data=data)
    list(eager.epoch(0))
    assert rounds == eager.last_audit.rounds
    assert dataclasses.asdict(ours_loader.accounting) == dataclasses.asdict(theirs_loader.accounting)


# -- (e) three trainer steps ----------------------------------------------------------


def _three_steps(jax_params, jax_trainer_cfg: dict, trainer_cfg: dict):
    """Three steps of the JAX trainer and of the port's (CPU, packed, flash
    pruned; interpret-mode Pallas on the JAX side) from the same weights,
    with the given data-path settings on each side."""
    steps = 3
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_0_6b"), attn_impl="flash",
                               attn_grid="pruned")
    tcfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), attn_impl="flash",
                               attn_grid="pruned")
    opt = dict(total_steps=100)
    jtrainer = JaxTrainer(JaxLM(jcfg), _jax_loader(2, "packed"), jax_optimizer.OptimizerConfig(**opt),
                          JaxTrainerConfig(log_every=1, max_steps=steps, **jax_trainer_cfg))
    jstate, _ = jtrainer.train_epoch({"params": jax.tree.map(jnp.asarray, jax_params),
                                      "opt": jax_optimizer.init_opt_state(
                                          jax.tree.map(jnp.asarray, jax_params),
                                          jax_optimizer.OptimizerConfig(**opt))})

    model = LM(tcfg, device="cpu")
    trainer = Trainer(model, _port_loader(2, "packed"), optimizer.OptimizerConfig(**opt),
                      TrainerConfig(log_every=1, max_steps=steps, **trainer_cfg))
    params = model.load_params(params_from_jax(jax_params, tcfg, "cpu"))
    state, n = trainer.train_epoch({"params": params,
                                    "opt": optimizer.init_opt_state(params, trainer.opt_cfg)})
    assert n == steps and (trainer.attn_impl, trainer.attn_grid) == ("flash", "pruned")
    assert len(trainer.history) == len(jtrainer.history) == steps
    for ours, theirs in zip(trainer.history, jtrainer.history):
        assert ours["tokens"] == theirs["tokens"]
        np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-4)
        np.testing.assert_allclose(ours["grad_norm"], theirs["grad_norm"], rtol=1e-4)
    lr_sum = sum(float(jax_optimizer.cosine_lr(jnp.float32(t), jtrainer.opt_cfg))
                 for t in range(1, steps + 1))
    ours = jax.tree.leaves(params_to_jax(state["params"], tcfg))
    theirs = jax.tree.leaves(jstate["params"])
    moved = 0.0
    for a, b, p0 in zip(ours, theirs, jax.tree.leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2 * lr_sum, rtol=0)
        moved = max(moved, float(np.abs(a - p0).max()))
    assert moved > lr_sum / 2  # the weights did move
    return trainer, jtrainer


def test_trainer_three_steps_match_jax(jax_params):
    """Port (CPU, packed, flash pruned) against JAX (packed, flash pruned,
    interpret mode): per-step loss and grad_norm at rtol 1e-4 (fp32 sums in
    another order over a few thousand tokens), and the weights afterwards
    within 2·Σ lr_t: one AdamW step moves an element by at most ~lr·(1 + wd·|p|)
    whatever its gradient, so an element whose near-zero gradient differs in
    sign between the two can end up to 2·lr apart per step."""
    _three_steps(jax_params, dict(prefetch=False), {})


@pytest.mark.parametrize("data_path", [
    {},  # the default: streaming with prefetch
    dict(streaming=False, device_put=True),  # eager, arrays staged by the loader
    dict(num_workers=2, device_put=True),  # worker processes + producer staging
], ids=["default", "eager-device-put", "workers-device-put"])
def test_trainer_data_paths_match_jax_default(jax_params, data_path):
    """The port's data paths against the JAX trainer's default (streaming
    with prefetch), at the tolerances of test_trainer_three_steps_match_jax;
    after the epoch the prefetch thread is stopped and the audit covers the
    whole epoch, as in JAX."""
    trainer, jtrainer = _three_steps(jax_params, {}, data_path)
    assert dataclasses.asdict(trainer.loader.last_audit) == dataclasses.asdict(
        jtrainer.loader.last_audit)
    stats = trainer.loader.last_prefetch_stats
    if data_path.get("streaming", True):
        assert stats is not None and stats.consumed == 3


# -- (f) the launcher -------------------------------------------------------------------


def test_train_launcher_on_cpu(capsys, monkeypatch):
    from repro_torch.launch import train

    argv = ["train", "--smoke", "--layout", "packed", "--steps", "3", "--world", "2",
            "--l-max", "512", "--dataset", SMALL[0], "--data-scale", str(SMALL[1]),
            "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    train.main()
    out = capsys.readouterr().out
    assert "layout=packed attn_impl=xla attn_grid=dense device=cpu" in out
    assert out.count("loss ") == 3 and "eta_identity=" in out
    if torch.cuda.is_available():
        return
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main()


@pytest.mark.parametrize("flags", [
    ["--eager"],
    ["--no-prefetch", "--lookahead", "8"],
    ["--device-put", "--num-workers", "2", "--prefetch-depth", "3"],
    ["--max-quarantine", "2"],
], ids=["eager", "no-prefetch-lookahead", "device-put-workers", "fault-knobs"])
def test_train_launcher_data_path_flags(capsys, monkeypatch, flags):
    """Every data-path flag runs on the CPU: three finite losses and a full
    identity coverage audit; the streaming paths report their prefetch and
    worker stats."""
    import math

    from repro_torch.launch import train

    argv = ["train", "--smoke", "--layout", "packed", "--steps", "3", "--world", "2",
            "--l-max", "512", "--dataset", SMALL[0], "--data-scale", str(SMALL[1]),
            "--log-every", "1", *flags]
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    train.main()
    out = capsys.readouterr().out
    losses = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses), out
    assert "eta_identity=0.0" in out
    assert ("prefetch hit_rate=" in out) == ("--eager" not in flags and "--no-prefetch" not in flags)
    assert ("workers completed=" in out) == ("--num-workers" in flags)
    if "--device-put" in flags and not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main()
