"""The check reads what it read before the start weights moved to the
host: on the CPU small cells, the program's and the reference's losses,
first gradients and changes equal the recorded ones to the last digit
(one thread, so that every sum runs in one order)."""

import json

import pytest
import torch

from odb_bench import harness
from odb_bench.tests import smallcell
from odb_bench.tests.conftest import ROOT

RECORDED = json.loads((ROOT / "odb_bench" / "tests" / "small_readings.json").read_text())


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ("qwen3_0_6b", "mamba2_130m"))
def test_readings_are_as_recorded(name, one_thread, monkeypatch):
    seen = {}
    compare = harness.compare

    def spy(program, ref, counted):
        seen.update(program=program, reference=ref)
        return compare(program, ref, counted)

    monkeypatch.setattr(harness, "compare", spy)
    assert smallcell.run(name)["correct"]
    for side in ("program", "reference"):
        for key in ("loss", "grad", "change"):
            assert seen[side][key] == RECORDED[name][side][key], (side, key)
