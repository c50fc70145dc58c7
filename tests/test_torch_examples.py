"""The port's four examples (``examples/*_torch.py``) on the CPU, against the
JAX package's examples where both are host-side and exact.

Each example's ``main([..., "--device", "cpu"])`` runs at its smoke preset
with few steps and returns what it printed.  The training examples are held
against the JAX loader run alone (no JAX model, so no XLA compile of one)
under the same configuration, consumed as the JAX trainer consumes it: the
per-step tokens and padding of the printed table, the protocol audit and
the accounting.  ``odb_vs_standard_torch.py`` must print every row of the
JAX script's table, run in the same process (the datasets seed from
salted tuple hashes), the host-time line excepted.  The examples' card
runs are in tests/test_torch_cuda.py.
"""

import contextlib
import importlib.util
import io
import pathlib
import sys

import pytest
import torch

from repro.core import BucketSpec as JaxBucketSpec
from repro.core import OdbConfig as JaxOdbConfig
from repro.data import OnlineDynamicLoader as JaxLoader
from repro.data import get_dataset as jax_get_dataset
from repro.train.trainer import assemble_model_batch as jax_assemble_model_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_packed", "train_100m", "odb_vs_standard")


def _load(name: str):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def _jax_loader_run(loader: JaxLoader, steps: int):
    """The JAX trainer's data path without its model: the default streaming
    epoch, ``steps`` steps, then closed as the trainer closes it.  Per step:
    (real tokens, the loss's token count, padding); then the audit and the
    accounting."""
    it = loader.streaming_epoch(0, lookahead=None, prefetch=True, prefetch_depth=2,
                                device_put=False, num_workers=0)
    rows = []
    try:
        for loader_step in it:
            batch = jax_assemble_model_batch(loader_step, loader.layout)
            rows.append((float(batch["loss_mask"].sum()), loader_step.metadata.padding_fraction))
            if len(rows) == steps:
                break
    finally:
        it.close()
    return rows, loader.last_audit, loader.accounting


def test_every_port_example_exists_beside_the_jax_one():
    for name in EXAMPLES:
        assert (ROOT / "examples" / f"{name}.py").is_file()
        assert hasattr(_load(f"{name}_torch"), "main")


def test_quickstart_matches_the_jax_loader():
    """One step, on four torch threads: a CPU step at the JAX example's 4 x
    2048 budget (dense rows of up to 4096 tokens) takes 25 s on one thread
    and 11 s on four.  The loader is examples/quickstart.py's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        out = _load("quickstart_torch").main(["--device", "cpu", "--steps", "1"])
    finally:
        torch.set_num_threads(threads)
    loader = JaxLoader(
        jax_get_dataset("longtail", scale=0.5), world_size=4,
        config=JaxOdbConfig(l_max=2048, buffer_size=64, prefetch_factor=32, num_workers=4),
        bucket_spec=JaxBucketSpec(min_len=512, max_len=4096, align=512, max_count=64, use_midpoints=False),
        vocab_size=512,
    )
    rows, audit, acc = _jax_loader_run(loader, 1)
    lines = out.splitlines()
    table = [line.split() for line in lines if line.strip()[:1].isdigit()]
    assert len(table) == len(rows) == 1
    for cells, (tokens, padding) in zip(table, rows):
        assert cells[2] == f"{tokens:.0f}" and cells[4] == f"{100 * padding:.1f}%"
    assert (f"protocol audit: eta_identity={audit.eta_identity:.4f} eta_quota={audit.eta_quota:.4f} "
            f"rounds={audit.rounds} (join mode, Theorem 1: both must be 0)") in lines
    assert (f"accounting: {acc.emitted_samples} samples, {acc.emitted_tokens} real tokens, "
            f"padding {100 * acc.padding_fraction:.2f}%") in lines
    assert "device: cpu" in lines


def test_train_100m_matches_the_jax_loader(tmp_path):
    args = ["--dataset", "uniform_narrow", "--data-scale", "0.05", "--world", "2", "--l-max", "512",
            "--steps", "5"]
    out = _load("train_100m_torch").main([*args, "--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    jax_example = _load("train_100m")
    cfg = jax_example.PRESETS["smoke"]
    loader = JaxLoader(
        jax_get_dataset("uniform_narrow", scale=0.05), world_size=2,
        config=JaxOdbConfig(l_max=512, buffer_size=256, prefetch_factor=64, num_workers=4),
        bucket_spec=JaxBucketSpec(min_len=128, max_len=8192, max_count=512),
        vocab_size=cfg.vocab_size,
    )
    rows, audit, _ = _jax_loader_run(loader, 5)
    lines = out.splitlines()
    assert lines[0] == f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params"
    logged = [line for line in lines if line.startswith("step")]
    assert len(logged) == 1 and logged[0].split()[1] == "5"  # log_every 5
    assert logged[0].endswith(f"pad {100 * rows[4][1]:.2f}%")
    assert lines[-1] == f"eta_identity={audit.eta_identity} eta_quota={audit.eta_quota}"


def test_serve_packed_runs_every_request():
    out = _load("serve_packed_torch").main(["--device", "cpu"]).splitlines()
    assert out[0].startswith("12 requests -> ")
    assert any(line.startswith("fixed shapes: decode ran at 1 shape(s)") for line in out)
    assert out[-1] == "segment flash attention (plain version) output: (1, 128, 4, 32), finite=True"


def test_odb_vs_standard_prints_the_jax_table():
    """Every row equals the JAX script's; the port adds the cost model's
    label, and the length-cache build's host time is left out."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))  # the JAX script imports benchmarks.common
    jax_example = _load("odb_vs_standard")
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured), pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["odb_vs_standard.py"])
        jax_example.main()
    theirs = captured.getvalue().strip().splitlines()
    ours = _load("odb_vs_standard_torch").main(["--device", "cpu"])
    ours = [line for line in ours.strip().splitlines() if "H20 cost model" not in line]
    host_time = "length-cache build took"
    assert len(ours) == len(theirs) == 11
    for a, b in zip(ours, theirs):
        if host_time in b:
            assert a.split(host_time)[0] == b.split(host_time)[0]
        else:
            assert a == b
