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
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state|proj|_dim$|_rank$|head|expan|expert|d_model)")
EXPERT_COUNTS = ("n_routed_experts", "num_local_experts", "num_experts")  # the families' names


def reduced_faults(reduced, data: dict) -> list:
    """How the cuts ``reduced`` of the configuration file ``data`` break the
    contract (empty where they keep to it).  No width is cut.  A file that
    states the deployment whose one chip it stands for, ``"deployment":
    {"chips_per_layer": n, "published": {key: published value}}``, may hold
    that chip's share of a layer: the routed experts (held × chips =
    published, at least 8 held) and the vocabulary (at least an eighth).
    Past any leading dense layers at least four layers stay."""
    faults = []
    deployment = data.get("deployment")
    share = {k for k in reduced if k in EXPERT_COUNTS + ("vocab_size",)}
    if share and deployment is None:
        faults.append(f"{sorted(share)} cut with no deployment stated")
    elif share:
        chips, published = deployment["chips_per_layer"], deployment["published"]
        for key in sorted(share):
            if key not in published:
                faults.append(f"{key}: no published value")
            elif key == "vocab_size" and 8 * data[key] < published[key]:
                faults.append(f"vocab_size {data[key]}: under an eighth of {published[key]}")
            elif key != "vocab_size" and data[key] * chips != published[key]:
                faults.append(f"{key} {data[key]} over {chips} chips is not the published {published[key]}")
            elif key != "vocab_size" and data[key] < 8:
                faults.append(f"{key} {data[key]}: under 8 experts held")
    if "first_k_dense_replace" in data and data["num_hidden_layers"] - data["first_k_dense_replace"] < 4:
        faults.append("fewer than 4 layers past the leading dense ones")
    faults += [f"{key}: a width" for key in reduced if key not in share and WIDTH.search(key)]
    return faults


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
    assert reduced_faults(config["reduced"], data) == []
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


# A model of hidden size 2,048, one dense layer and 26 expert
# layers of 64 experts (6 a token), each layer over 8 chips.
MOE64 = {"hidden_size": 2048, "num_hidden_layers": 27, "first_k_dense_replace": 1,
         "n_routed_experts": 8, "num_experts_per_tok": 6, "n_shared_experts": 2,
         "moe_intermediate_size": 1408, "vocab_size": 12800,
         "deployment": {"chips_per_layer": 8, "published": {"n_routed_experts": 64, "vocab_size": 102400}}}
# DeepSeek-V3: one chip of a 32-chip expert-parallel layer, one dense and
# five expert layers, an eighth of the vocabulary.
DEEPSEEK_V3 = {"hidden_size": 7168, "num_hidden_layers": 6, "first_k_dense_replace": 1,
               "n_routed_experts": 8, "num_experts_per_tok": 8, "n_shared_experts": 1,
               "moe_intermediate_size": 2048, "kv_lora_rank": 512, "q_lora_rank": 1536,
               "vocab_size": 16160,
               "deployment": {"chips_per_layer": 32, "published": {"n_routed_experts": 256, "vocab_size": 129280}}}
SHARE = ["num_hidden_layers", "first_k_dense_replace", "n_routed_experts", "vocab_size"]
# Arctic's name for the count: 128 experts over 16 chips, no leading dense layer.
ARCTIC = {"hidden_size": 7168, "num_hidden_layers": 4, "num_local_experts": 8, "num_experts_per_tok": 2,
          "deployment": {"chips_per_layer": 16, "published": {"num_local_experts": 128}}}


@pytest.mark.parametrize("reduced, data", [(SHARE, MOE64), (SHARE, DEEPSEEK_V3),
                                           (["num_hidden_layers", "num_local_experts"], ARCTIC)],
                         ids=["moe64", "deepseek_v3", "arctic"])
def test_the_expert_share_cut_is_admitted(reduced, data):
    assert reduced_faults(reduced, data) == []


def changed(data, **keys):
    return {**data, **keys}


def deployed(data, chips, experts):
    return {**data, "n_routed_experts": experts,
            "deployment": {**data["deployment"], "chips_per_layer": chips}}


@pytest.mark.parametrize("reduced, data", [
    (SHARE + ["num_experts_per_tok"], changed(DEEPSEEK_V3, num_experts_per_tok=4)),
    (SHARE + ["n_shared_experts"], changed(DEEPSEEK_V3, n_shared_experts=0)),
    (SHARE + ["moe_intermediate_size"], changed(DEEPSEEK_V3, moe_intermediate_size=1024)),
    (SHARE + ["kv_lora_rank"], changed(DEEPSEEK_V3, kv_lora_rank=256)),
    (SHARE + ["q_lora_rank"], changed(DEEPSEEK_V3, q_lora_rank=768)),
    (SHARE + ["num_attention_heads"], changed(DEEPSEEK_V3, num_attention_heads=16)),
    (SHARE + ["hidden_size"], changed(DEEPSEEK_V3, hidden_size=4096)),
    (SHARE, deployed(DEEPSEEK_V3, 64, 4)),
    (SHARE, deployed(DEEPSEEK_V3, 25, 10)),
    (SHARE, deployed(MOE64, 8, 7)),
    (SHARE, changed(DEEPSEEK_V3, vocab_size=16000)),
    (SHARE, changed(DEEPSEEK_V3, num_hidden_layers=4)),
    (SHARE, {k: v for k, v in DEEPSEEK_V3.items() if k != "deployment"}),
    (SHARE, changed(DEEPSEEK_V3, deployment={"chips_per_layer": 32, "published": {"n_routed_experts": 256}})),
], ids=["experts_per_tok", "shared_experts", "moe_intermediate", "kv_lora_rank", "q_lora_rank", "heads",
        "hidden_size", "under_8_held", "not_the_published_count", "not_a_divisor", "vocab_under_an_eighth",
        "three_expert_layers", "no_deployment", "no_published_vocab"])
def test_other_cuts_are_refused(reduced, data):
    assert reduced_faults(reduced, data) != []
