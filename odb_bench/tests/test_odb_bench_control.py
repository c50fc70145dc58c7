"""The control and the half-batch fault put in the program's place fail the
cell's limits, at a size the CPU holds (the chip runs ``control.py`` at the
cell's own size)."""

import pytest
import torch

from odb_bench import control
from odb_bench.tests import smallcell


@pytest.mark.parametrize("name", ("qwen3_0_6b", "mamba2_130m"))
def test_control_fails_the_limits(name):
    torch.set_num_threads(2)
    out = control.control_readings(name, smallcell.config(name), smallcell.traffic(), 2**31 + 3, "cpu")
    limits = smallcell.limits(name)
    assert out["data_faults"] == 0
    assert control.judged(out, limits) == {"fp8": False, "half_batch": False}, (out, limits)
