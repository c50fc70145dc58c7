"""A cell's configuration cut to a size the CPU tests can hold (fp32, two
layers, narrow widths, short samples), and the harness's pieces for it."""

import copy
import importlib
import json

from odb_bench.tests.conftest import ROOT

BENCH = ROOT / "odb_bench"
READERS = ("data_wait_ms", "pad_share", "device_idle_share", "kernels_per_step", "peak_mem_gib",
           "device_mfu", "flash_roofline", "ssd_roofline", "ssd_bwd_share")


def config(name: str) -> dict:
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c = copy.deepcopy(c)
    if c["run"]["family"] == "qwen3":
        c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                 head_dim=16, intermediate_size=128, vocab_size=512, torch_dtype="float32")
    else:
        c.update(n_layer=2, d_model=64, vocab_size=512)
        c["assumed"].update(d_state=16, headdim=16, chunk_size=16, dtype="float32")
    c["run"].update(l_max=512, trace_steps=2)
    return c


def traffic(image: bool = True) -> dict:
    t = {"generator": "mixture",
         "components": [{"weight": 1, "kind": "lognormal", "mean": 120, "cv": 0.8, "lo": 16, "hi": 400}],
         "stratum": 256, "samples_per_rank": 512, "cutoff": 1024,
         "pipeline": json.loads((BENCH / "traffic" / "llava.json").read_text())["pipeline"]}
    if image:
        t["image"] = {"share": 0.33, "token_share": 0.35, "min_tokens": 64}
    return t


WINDOW = {"window_steps_per_second": 2.0}
CELLS = {"qwen3_0_6b": "qwen3_0_6b.sharegpt4o", "mamba2_130m": "mamba2_130m.ultrachat"}


def limits(name: str) -> dict:
    """The limits of the configuration's first cell."""
    return json.loads((BENCH / "limits" / f"{CELLS[name]}.json").read_text())


def readers() -> dict:
    return {n: importlib.import_module(f"odb_bench.metrics.{n}") for n in READERS}


def run(name: str, seed: int = 2**31 + 7, trace: bool = False) -> dict:
    from odb_bench import harness

    return harness.run_cell(name, config(name), traffic(), WINDOW, seed, 2.0, trace, readers(),
                            limits(name), device="cpu", log=lambda line: None)
