"""The port's model checkpoints and the train launcher's restart loop, on the CPU.

Checkpoints cross packages: a trainer state written by the JAX package's
``save_checkpoint`` restores in the port bit for bit, and the reverse, for
the qwen3, mamba2, OLMo, Arctic, DeepSeek-V3 (the ``prefix/{i}/sub0`` keys
of its dense layers) and Jamba (units of 8 mixed layers) smoke configs
(fp32) and, from JAX to the port, for a bf16 mamba2 state.  Bit for bit is checked twice: every leaf's values
against the other side's, and the npz members that the two packages write
for the same state, byte for byte.  The moments are random numbers from a
seed (a trained state is not needed to move bits), the step counter 7.
"""

import dataclasses
import json
import math
import pathlib
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.stream import StreamCheckpoint as JaxStreamCheckpoint
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jax_optimizer
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.bridge import params_to_jax
from repro_torch.configs import get_smoke_config
from repro_torch.core import OdbConfig
from repro_torch.data.datasets import _records_from_lengths
from repro_torch.data.pipeline import PipelinePolicy
from repro_torch.launch import train as train_launcher
from repro_torch.models import LM
from repro_torch.stream import EpochAborted, StreamCheckpoint, StreamExecutor
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


def _members(path) -> dict:
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def _jax_state(arch: str, dtype: str = "float32", moments: str = "float32"):
    """A JAX trainer state: ``LM.init`` weights, random moments, step 7."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    trainer = JaxTrainer(JaxLM(jcfg), None, jax_optimizer.OptimizerConfig(moment_dtype=moments))
    state = trainer.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def fill(a):
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32), a.dtype)

    state["opt"] = {"m": jax.tree.map(fill, state["opt"]["m"]),
                    "v": jax.tree.map(fill, state["opt"]["v"]), "step": jnp.array(7, jnp.int32)}
    return trainer, state


def _port_trainer(arch: str, directory, dtype: str = "float32", moments: str = "float32"):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    return Trainer(LM(cfg, device="cpu"), None, OptimizerConfig(moment_dtype=moments),
                   TrainerConfig(checkpoint_dir=str(directory)))


def _assert_state_equal(state, jstate, cfg) -> None:
    """Every leaf of the port's state equal to the JAX state's (bf16 and
    fp32 both compare exactly as fp32)."""
    for name, ours, theirs in (("params", state["params"], jstate["params"]),
                               ("m", state["opt"]["m"], jstate["opt"]["m"]),
                               ("v", state["opt"]["v"], jstate["opt"]["v"])):
        ours = jax.tree.leaves_with_path(params_to_jax(ours, cfg))
        theirs = jax.tree.leaves_with_path(theirs)
        assert [p for p, _ in ours] == [p for p, _ in theirs], name
        for (path, a), (_, b) in zip(ours, theirs):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32),
                                          err_msg=f"{name}{jax.tree_util.keystr(path)}")
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])


# The manifest's first two keys: an empty norm group (OLMo) gives no key.
FIRST_KEYS = {
    "qwen3_0_6b": ["opt/m/embed", "opt/m/final_norm/scale"],
    "mamba2_130m": ["opt/m/embed", "opt/m/final_norm/scale"],
    "olmo_1b": ["opt/m/embed", "opt/m/stack/sub0/mixer/wk"],
    "arctic_480b": ["opt/m/embed", "opt/m/final_norm/scale"],
    "deepseek_v3_671b": ["opt/m/embed", "opt/m/final_norm/scale"],
    "jamba_1_5_large": ["opt/m/embed", "opt/m/final_norm/scale"],
}


@pytest.mark.parametrize("arch", list(FIRST_KEYS))
def test_jax_checkpoint_restores_in_port(tmp_path, arch):
    """JAX ``save_checkpoint`` → the port's ``Trainer.restore_or_init``: the
    step, every leaf, and the port's own save of the restored state, whose
    npz members and manifest keys equal JAX's byte for byte."""
    _, jstate = _jax_state(arch)
    jax_ckpt.save_checkpoint(tmp_path / "jax", 7, jstate)
    trainer = _port_trainer(arch, tmp_path / "jax")
    state, step = trainer.restore_or_init(torch.Generator().manual_seed(3))
    assert step == 7
    _assert_state_equal(state, jstate, trainer.model.cfg)
    ours = ckpt.save_checkpoint(tmp_path / "port", 7, state, cfg=trainer.model.cfg)
    assert _members(ours) == _members(tmp_path / "jax" / "step_00000007.npz")
    manifests = [json.loads((tmp_path / side / "latest.json").read_text()) for side in ("port", "jax")]
    assert manifests[0]["keys"] == manifests[1]["keys"]
    assert manifests[0]["keys"][:2] == FIRST_KEYS[arch]
    if trainer.model.cfg.first_k_dense:
        assert "params/prefix/0/sub0/mixer/w_dq" in manifests[0]["keys"]


@pytest.mark.parametrize("arch", list(FIRST_KEYS))
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    """The port's ``save_checkpoint`` → JAX ``restore_checkpoint`` into the
    shapes of its ``init_state``: every leaf equal, and JAX's save of what
    it restored equal to the port's file member by member."""
    jtrainer, _ = _jax_state(arch)
    trainer = _port_trainer(arch, tmp_path / "port")
    state = trainer.init_state(torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for t in tree_leaves(state["opt"]["m"]) + tree_leaves(state["opt"]["v"]):
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
        state["opt"]["step"].fill_(7)
    ours = ckpt.save_checkpoint(tmp_path / "port", 7, state, cfg=trainer.model.cfg)
    like = jax.eval_shape(jtrainer.init_state, jax.random.PRNGKey(0))
    jstate, step = jax_ckpt.restore_checkpoint(tmp_path / "port", like)
    assert step == 7
    _assert_state_equal(state, jstate, trainer.model.cfg)
    theirs = jax_ckpt.save_checkpoint(tmp_path / "jax", 7, jstate)
    assert _members(theirs) == _members(ours)


def test_jax_bf16_checkpoint_restores_in_port(tmp_path):
    """A bf16 mamba2 state (bf16 weights beside fp32 a_log, dt_bias, d_skip;
    bf16 moments) written by JAX: numpy holds the bf16 leaves as raw two-byte
    voids, and the port restores them bit for bit by viewing the bits.  The
    JAX package's own restore of the same file raises (its restore casts the
    voids with ``jnp.asarray``): a fault of the reference, kept as it is."""
    jtrainer, jstate = _jax_state("mamba2_130m", dtype="bfloat16", moments="bfloat16")
    jax_ckpt.save_checkpoint(tmp_path / "jax", 7, jstate)
    trainer = _port_trainer("mamba2_130m", tmp_path / "jax", dtype="bfloat16", moments="bfloat16")
    state, step = trainer.restore_or_init(torch.Generator().manual_seed(3))
    assert step == 7
    mixer = state["params"]["layers"][0]["mixer"]
    assert mixer["in_x"].dtype == torch.bfloat16 and mixer["a_log"].dtype == torch.float32
    assert state["opt"]["m"]["embed"].dtype == torch.bfloat16
    _assert_state_equal(state, jstate, trainer.model.cfg)
    ours = ckpt.save_checkpoint(tmp_path / "port", 7, state, cfg=trainer.model.cfg)
    jax_file = tmp_path / "jax" / "step_00000007.npz"
    assert _members(ours) == _members(jax_file)
    assert b"'descr': '<V2'" in _members(jax_file)["params__SEP__embed.npy"][:128]
    like = jax.eval_shape(jtrainer.init_state, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="No cast function available"):
        jax_ckpt.restore_checkpoint(tmp_path / "jax", like)


# -- the scheme: rotation, fallback, explicit steps, shapes ------------------------------


def _tree(value: float) -> dict:
    return {"params": {"w": torch.full((2, 3), value)},
            "opt": {"step": torch.tensor(int(value), dtype=torch.int32)}}


def test_roundtrip_and_keep_k_rotation(tmp_path):
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(tmp_path, s, _tree(s), keep=2)
    assert ckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == ["step_00000003.npz",
                                                                   "step_00000004.npz"]
    like = _tree(0)
    assert ckpt.restore_checkpoint(tmp_path, like) == 4
    assert torch.equal(like["params"]["w"], torch.full((2, 3), 4.0))
    assert int(like["opt"]["step"]) == 4
    assert ckpt.restore_checkpoint(tmp_path, like, step=3) == 3
    assert torch.equal(like["params"]["w"], torch.full((2, 3), 3.0))


def test_torn_latest_falls_back_with_a_warning(tmp_path):
    for s in (1, 2):
        ckpt.save_checkpoint(tmp_path, s, _tree(s), keep=3)
    latest = tmp_path / "step_00000002.npz"
    latest.write_bytes(latest.read_bytes()[: latest.stat().st_size // 2])  # a torn write
    like = _tree(0)
    with pytest.warns(RuntimeWarning, match="step_00000002"):
        assert ckpt.restore_checkpoint(tmp_path, like) == 1
    assert torch.equal(like["params"]["w"], torch.full((2, 3), 1.0))


def test_explicit_step_never_falls_back(tmp_path):
    for s in (1, 2):
        ckpt.save_checkpoint(tmp_path, s, _tree(s))
    latest = tmp_path / "step_00000002.npz"
    latest.write_bytes(latest.read_bytes()[:10])
    like = _tree(0)
    with pytest.raises(ckpt._CORRUPT_ERRORS):
        ckpt.restore_checkpoint(tmp_path, like, step=2)
    assert torch.equal(like["params"]["w"], torch.zeros(2, 3))  # nothing half-applied


def test_all_corrupt_raises_with_the_candidates(tmp_path):
    ckpt.save_checkpoint(tmp_path, 1, _tree(1))
    (tmp_path / "step_00000001.npz").write_bytes(b"\x00" * 16)
    with pytest.warns(RuntimeWarning), pytest.raises(FileNotFoundError, match="step_00000001"):
        ckpt.restore_checkpoint(tmp_path, _tree(0))


def test_shape_mismatch_is_a_hard_error(tmp_path):
    """A shape mismatch is a topology error, not corruption: no fallback
    to an older checkpoint, and no tensor written."""
    for s in (1, 2):
        ckpt.save_checkpoint(tmp_path, s, _tree(s))
    like = {"params": {"w": torch.zeros(3, 3)}, "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    with pytest.raises(ValueError, match="params/w: shape"):
        ckpt.restore_checkpoint(tmp_path, like)
    assert int(like["opt"]["step"]) == 0
    model = {"layers": [{"w": torch.zeros(2)}]}
    with pytest.raises(ValueError, match="pass its cfg"):
        ckpt.save_checkpoint(tmp_path, 3, {"params": model})


# -- the trainer and the launcher -------------------------------------------------------------

SMOKE_ARGS = ["train", "--arch", "mamba2_130m", "--smoke", "--device", "cpu", "--layout", "dense",
              "--world", "2", "--l-max", "512", "--dataset", "uniform_narrow", "--data-scale", "0.05",
              "--log-every", "1"]


def _launcher_trainer(directory, steps: int, every: int, keep: int) -> Trainer:
    args = train_launcher.parser().parse_args(SMOKE_ARGS[1:] + ["--steps", str(steps)])
    trainer, _ = train_launcher.build(args)
    trainer.cfg = dataclasses.replace(trainer.cfg, checkpoint_dir=str(directory),
                                      checkpoint_every=every, keep_checkpoints=keep)
    return trainer


def test_trainer_saves_and_resumes(tmp_path):
    """mamba2 smoke: four steps with a checkpoint every two, keep two; a
    fresh trainer's ``restore_or_init`` restores step 4 with every leaf
    equal, and trains two more steps."""
    trainer = _launcher_trainer(tmp_path, 4, 2, 2)
    state, step = trainer.restore_or_init(torch.Generator().manual_seed(0))
    assert step == 0
    state, step = trainer.train_epoch(state, start_step=step)
    assert step == 4 and ckpt.latest_step(tmp_path) == 4
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == ["step_00000002.npz",
                                                                   "step_00000004.npz"]
    fresh = _launcher_trainer(tmp_path, 6, 2, 2)
    restored, step = fresh.restore_or_init(torch.Generator().manual_seed(9))
    assert step == 4
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _, step = fresh.train_epoch(restored, start_step=step)
    assert step == 6 and [r["step"] for r in fresh.history] == [5, 6]
    assert all(math.isfinite(r["loss"]) for r in fresh.history)


def _step_lines(out: str) -> list[int]:
    return [int(line.split()[1]) for line in out.splitlines() if line.startswith("step ")]


def test_launcher_restores_after_a_crash(tmp_path, capsys, monkeypatch):
    """A crash right after the step-2 checkpoint: the restart loop counts a
    restart, restores step 2 (the step counter and the optimizer resume;
    the epoch's data is replayed from its start, as in JAX) and finishes."""
    monkeypatch.setattr(train_launcher, "CHECKPOINT_EVERY", 2)
    save = ckpt.save_checkpoint
    crashed = []

    def save_then_crash(*args, **kwargs):
        path = save(*args, **kwargs)
        if not crashed:
            crashed.append(path)
            raise RuntimeError("injected crash")
        return path

    monkeypatch.setattr(ckpt, "save_checkpoint", save_then_crash)
    monkeypatch.setattr(sys, "argv", SMOKE_ARGS + ["--steps", "4", "--checkpoint-dir", str(tmp_path)])
    train_launcher.main()
    out = capsys.readouterr().out
    assert "[train] crash (RuntimeError: injected crash); restart 1" in out
    assert _step_lines(out) == [1, 2, 3, 4]  # resumed at step 3, not re-run from step 1
    assert ckpt.latest_step(tmp_path) == 4


@pytest.mark.parametrize("extra", [[], ["--checkpoint-dir", "DIR", "--max-restarts", "1"]],
                         ids=["no-checkpoint-dir", "past-max-restarts"])
def test_launcher_reraises(tmp_path, capsys, monkeypatch, extra):
    def crash(self, state, epoch=0, start_step=0):
        raise RuntimeError("injected crash")

    monkeypatch.setattr(Trainer, "train_epoch", crash)
    argv = SMOKE_ARGS + ["--steps", "2"] + [str(tmp_path) if a == "DIR" else a for a in extra]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(RuntimeError, match="injected crash"):
        train_launcher.main()
    out = capsys.readouterr().out
    assert out.count("[train] crash") == (2 if extra else 1)


class DropRound:
    """Every gather attempt of one round loses rank 1's payload."""

    def __init__(self, at_round: int) -> None:
        self.at_round = at_round

    def on_gather(self, round_index, attempt, rank, tag):
        return "drop" if (round_index == self.at_round and rank == 1) else None


def test_epoch_aborted_writes_a_stream_checkpoint(tmp_path, capsys, monkeypatch):
    """An ``EpochAborted`` (a round whose gather lost rank 1 past its
    retries) prints its cause and failed ranks and writes its stream
    checkpoint to ``stream_abort.json``, which both packages'
    ``StreamCheckpoint.load`` read; past ``--max-restarts`` it is raised."""
    lengths = [int(x) for x in np.random.default_rng(4).integers(16, 900, size=100)]
    cfg = OdbConfig(l_max=1024, buffer_size=16, prefetch_factor=8, num_workers=1,
                    round_retries=1, retry_backoff_s=1e-4)
    ex = StreamExecutor(_records_from_lengths(lengths), PipelinePolicy(), 4, cfg, seed=1,
                        lookahead=8, fault_injector=DropRound(10))
    with pytest.raises(EpochAborted) as info:
        while ex.step() is not None:
            pass
    aborted = info.value

    def abort(self, state, epoch=0, start_step=0):
        raise aborted

    monkeypatch.setattr(Trainer, "train_epoch", abort)
    monkeypatch.setattr(sys, "argv", SMOKE_ARGS + ["--steps", "2", "--checkpoint-dir", str(tmp_path),
                                                   "--max-restarts", "0"])
    with pytest.raises(EpochAborted):
        train_launcher.main()
    out = capsys.readouterr().out
    assert "[train] epoch aborted (" in out and "[train] failed ranks: [1]" in out
    path = pathlib.Path(tmp_path) / "stream_abort.json"
    want = aborted.checkpoint().to_json()
    assert StreamCheckpoint.load(str(path)).to_json() == want
    assert JaxStreamCheckpoint.load(str(path)).to_json() == want
