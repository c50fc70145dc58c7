"""The traffic generator: one seed, one epoch; every seed the same lengths
in another order; no salted hash; the clones' mean and CV."""

import ast
import dataclasses
import json
import math
import statistics

import pytest

from odb_bench.generators import mixture
from odb_bench.reference.data import realized_length
from odb_bench.tests.conftest import ROOT

MIXES = ("sharegpt4o", "ultrachat", "llava")


def traffic(name):
    return json.loads((ROOT / "odb_bench" / "traffic" / f"{name}.json").read_text())


def records(t, seed, n, world=2):
    """n records over ``world`` ranks, rank r admitting r, r + world, ..."""
    return mixture.records(t, seed, [list(range(r, n, world)) for r in range(world)])


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_per_seed(name):
    t = traffic(name)
    a, b = records(t, 2**31 + 11, 1200), records(t, 2**31 + 11, 1200)
    c = records(t, 5, 1200)
    assert a == b
    assert a != c
    assert sorted(r["target"] for r in a) == sorted(r["target"] for r in c)
    assert sum(r["image_pixels"] > 0 for r in a) == sum(r["image_pixels"] > 0 for r in c)


@pytest.mark.parametrize("name", MIXES)
def test_every_stratum_holds_the_same_lengths(name):
    t = traffic(name)
    world, size = 2, t["stratum"]
    for seed in (7, 2**31 + 5):
        recs = records(t, seed, world * size * 3, world)
        strata = {(r["identity"] % world, r["identity"] // world // size) for r in recs}
        seen = set()
        for rank, block in strata:
            members = [r for r in recs if r["identity"] % world == rank
                       and r["identity"] // world // size == block]
            seen.add(tuple(sorted((r["target"], r["image_pixels"] > 0) for r in members)))
        assert len(seen) == 1
        assert len(next(iter(seen))) == size


def test_no_builtin_hash():
    for path in (ROOT / "odb_bench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name) and n.func.id == "hash"]
        calls += [n for n in ast.walk(tree) if isinstance(n, ast.Attribute) and n.attr == "__hash__"]
        assert not calls, path


@pytest.mark.parametrize("name", MIXES)
def test_realized_lengths_hit_targets(name):
    t = traffic(name)
    for r in records(t, 3, 600):
        assert abs(realized_length(r, t["pipeline"], t["cutoff"]) - r["target"]) <= 1


@pytest.mark.parametrize("name", MIXES)
def test_mean_and_cv_match_the_clone(name):
    from repro_torch.data.datasets import DATASET_CLONES

    n = 20000
    t = traffic(name)
    if name == "sharegpt4o":  # the cell's clip at 8192; the clone keeps 12,110
        t["components"][0]["hi"] = 12110
    ours = [realized_length(r, t["pipeline"], t["cutoff"]) for r in records(t, 1, n)]
    theirs = dataclasses.replace(DATASET_CLONES[name], size=n).lengths(seed=0)
    m_ours, m_theirs = statistics.fmean(ours), statistics.fmean(theirs)
    cv = lambda xs: statistics.pstdev(xs) / statistics.fmean(xs)  # noqa: E731
    se = cv(theirs) * m_theirs / math.sqrt(n)
    assert abs(m_ours - m_theirs) < 4 * se + 0.01 * m_theirs
    assert abs(cv(ours) - cv(theirs)) < 0.08 * cv(theirs)
    assert max(ours) <= max(c["hi"] for c in t["components"]) + 1
