"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import importlib
import json
import re

import pytest

from odb_bench.tests.conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|head|expan|expert|d_model)")


def test_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["odb_bench"]
    assert MANIFEST["command"] == ["python3", "odb_bench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert e2e == {"tokens_per_s", "samples_per_s", "mfu", "setup_s"}
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert config["file"].startswith("odb_bench/configs/")
    assert data["source"] == config["source"]
    assert all(not WIDTH.search(key) for key in config["reduced"]), config["reduced"]
    assert set(config["reduced"]) == set(data["changed"])
    assert any(w["config"] == config["name"] for w in MANIFEST["workloads"])
    family = data["run"]["family"]
    for folder in ("flops", "reference"):
        assert (ROOT / "odb_bench" / folder / f"{family}.py").is_file()


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda c: c["name"])
def test_cells_find_their_files(cell):
    assert cell["chips"] in (1, 4)
    traffic = json.loads((ROOT / "odb_bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    importlib.import_module(f"odb_bench.generators.{traffic['generator']}")
    assert traffic["samples_per_rank"] % traffic["stratum"] == 0
    assert traffic["samples_per_rank"] >= 20 * traffic["stratum"]
    window = json.loads((ROOT / "odb_bench" / "cells" / f"{cell['name']}.json").read_text())
    assert window["window_steps_per_second"] > 0
    readers = [m for m in MANIFEST["per_layer"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert readers
    for m in readers:
        assert callable(importlib.import_module(f"odb_bench.metrics.{m['name']}").read)
    limits = json.loads((ROOT / "odb_bench" / "limits" / f"{cell['name']}.json").read_text())
    assert {"data_faults"} <= set(limits) <= {"data_faults", "loss_gap", "grad_gap", "change_gap"}
    assert limits["data_faults"] == 0
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_every_listed_workload_exists():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
