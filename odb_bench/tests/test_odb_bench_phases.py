"""The train step's phase readers (``forward_ms``, ``backward_ms``,
``optimizer_ms``) and ``liveness_builds_per_step``: each reads its counter's
delta a step from a hand-made reading, and leaves the metric out where the
counter is absent or zero, as in a traced run on the CPU."""

import importlib
import types

import pytest
import torch

from odb_bench.tests import smallcell

READS = {
    "forward_ms": ("train_forward_device_seconds_total", 1e3),
    "backward_ms": ("train_backward_device_seconds_total", 1e3),
    "optimizer_ms": ("train_optimizer_device_seconds_total", 1e3),
    "liveness_builds_per_step": ("kernel_liveness_tables_built_total", 1.0),
}


def reader(name):
    return importlib.import_module(f"odb_bench.metrics.{name}")


def ctx(counters: dict):
    return types.SimpleNamespace(counters=counters)


@pytest.mark.parametrize("name", READS)
def test_reader_reads_its_counter_a_step(name):
    counter, scale = READS[name]
    value = reader(name).read(ctx({"train_steps_total": 4.0, counter: 2.5, "other_total": 9.0}))
    assert value == pytest.approx(scale * 2.5 / 4.0)


@pytest.mark.parametrize("case", ["nothing", "absent", "zero", "no_steps"])
@pytest.mark.parametrize("name", READS)
def test_reader_finds_nothing(name, case):
    counter = READS[name][0]
    counters = {"nothing": {}, "absent": {"train_steps_total": 4.0},
                "zero": {"train_steps_total": 4.0, counter: 0.0}, "no_steps": {counter: 1.0}}[case]
    assert reader(name).read(ctx(counters)) is None


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_traced_cpu_cell_leaves_the_readers_out(few_threads):
    from odb_bench import harness

    name = "qwen3_0_6b"
    readers = {n: reader(n) for n in (*smallcell.READERS, *READS)}
    out = harness.run_cell(name, smallcell.config(name), smallcell.traffic(), smallcell.WINDOW,
                           2**31 + 11, 2.0, True, readers, smallcell.limits(name), device="cpu",
                           log=lambda line: None)
    assert out["correct"], out["checks"]
    assert "data_wait_ms" in out["metrics"]
    assert not set(READS) & set(out["metrics"])
