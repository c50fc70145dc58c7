"""The paper's comparators and the tile census: the port against JAX, on the CPU.

Standard, Sorted and Packing (``data/baselines.py``) and the GMT, BMT and
HFG oracles over the scalar length cache (``data/oracles.py``) are host
Python in both packages, seeded explicitly, so every schedule must equal
the JAX package's step for step: the view id, identity and length of every
sample of every rank, and the IDLE positions.  HFG and BMT seed Python's
``random`` from a tuple hash, so the two packages agree within one process
(as here) for any ``PYTHONHASHSEED``.

The census (``live_tile_counts``, ``fetched_tile_counts``) must give the
JAX package's dicts, and its ``segment_live`` must equal the live entries
of the port's liveness tables, the tiles the pruned kernels visit.
"""

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.data import baselines as jax_baselines
from repro.data import oracles as jax_oracles
from repro.data.datasets import get_dataset as jax_get_dataset
from repro.data.pipeline import PipelinePolicy as JaxPolicy
from repro.kernels.flash_attention import live_tile_counts as jax_live_tile_counts
from repro.kernels.liveness import fetched_tile_counts as jax_fetched_tile_counts
from repro_torch import obs
from repro_torch.data import (
    LengthCache,
    PipelinePolicy,
    StaleCacheError,
    bmt_schedule,
    get_dataset,
    gmt_schedule,
    hfg_schedule,
    packing_schedule,
    sorted_schedule,
    standard_schedule,
)
from repro_torch.data import baselines, oracles
from repro_torch.data.baselines import packed_area, sweep_batch_sizes
from repro_torch.kernels.flash_attention import live_tile_counts
from repro_torch.kernels.liveness import build_liveness_tables, fetched_tile_counts
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

# (dataset, scale): a few hundred records each; budgets and batch sizes are
# those of benchmarks/throughput.py's SELECTED for the "2b" model.
DATASETS = {
    "ultrachat": (0.002, dict(std_bs=8, sorted_bs=16, budget=16384, hfg_bs=8)),
    "llava": (0.002, dict(std_bs=4, sorted_bs=16, budget=8192, hfg_bs=8)),
    "sharegpt4o": (0.005, dict(std_bs=1, sorted_bs=2, budget=12288, hfg_bs=1)),
}
WORLD = 4
SEEDS = (0, 1)


def _canon(steps) -> list:
    """Every step as a tuple per rank: None (IDLE) or the samples'
    (view_id, identity, length)."""
    return [
        tuple(None if g is None else tuple((s.view_id, s.identity, s.length) for s in g.samples)
              for g in step)
        for step in steps
    ]


def _schedules(mod_baselines, mod_oracles, ds, seed: int, sel: dict) -> dict:
    lengths = ds.lengths(seed=seed)
    cache = mod_oracles.LengthCache.build(ds, seed=seed)
    return {
        "lengths": lengths,
        "cache": (cache.dataset, cache.key, cache.lengths),
        "standard": _canon(mod_baselines.standard_schedule(lengths, WORLD, sel["std_bs"], seed=seed)),
        "sorted": _canon(mod_baselines.sorted_schedule(
            lengths, WORLD, sel["sorted_bs"], buffer_size=64, seed=seed)),
        "packing": _canon(mod_baselines.packing_schedule(lengths, WORLD, sel["budget"], seed=seed)),
        "packing_epoch1": _canon(mod_baselines.packing_schedule(
            lengths, WORLD, sel["budget"], seed=seed, epoch=1)),
        "gmt": _canon(mod_oracles.gmt_schedule(cache, WORLD, sel["budget"])),
        "bmt": _canon(mod_oracles.bmt_schedule(
            cache, WORLD, sel["budget"], bucket_samples=128, seed=seed)),
        "hfg": _canon(mod_oracles.hfg_schedule(cache, WORLD, sel["hfg_bs"], seed=seed)),
        "hfg_epoch1": _canon(mod_oracles.hfg_schedule(
            cache, WORLD, sel["hfg_bs"], megabatch_factor=4, seed=seed, epoch=1)),
    }


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", DATASETS)
def test_schedules_match_jax(name, seed):
    scale, sel = DATASETS[name]
    ours = _schedules(baselines, oracles, get_dataset(name, scale=scale), seed, sel)
    theirs = _schedules(jax_baselines, jax_oracles, jax_get_dataset(name, scale=scale), seed, sel)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key] == theirs[key], key
    n = len(ours["lengths"])
    assert n > 100
    # Full coverage in every schedule; IDLE only in the fixed-batch tails.
    for key in ("standard", "sorted", "packing", "gmt", "bmt", "hfg"):
        ids = [s[1] for step in ours[key] for g in step if g is not None for s in g]
        assert set(ids) == set(range(n)), key
        assert all(len(step) == WORLD for step in ours[key]), key


def test_schedules_from_numpy_lengths_match_jax():
    lengths = [int(x) for x in np.random.default_rng(11).integers(16, 5000, size=300)]
    for fn, arg in (("standard_schedule", 8), ("sorted_schedule", 8), ("packing_schedule", 8192)):
        assert _canon(getattr(baselines, fn)(lengths, 3, arg, seed=4)) == _canon(
            getattr(jax_baselines, fn)(lengths, 3, arg, seed=4)), fn


def test_packed_area_and_sweep_match_jax():
    steps = packing_schedule([100, 900, 4000, 30, 7000], 1, 4096)
    for step in steps:
        for g in step:
            assert packed_area(g, 4096) == jax_baselines.packed_area(g, 4096)
            assert packed_area(g, 4096) % 4096 == 0 and packed_area(g, 4096) >= g.real_tokens
    assert sweep_batch_sizes() == jax_baselines.sweep_batch_sizes() == (1, 2, 4, 8, 16)


def test_gmt_batches_respect_the_budget():
    ds = get_dataset("ultrachat", scale=0.002)
    cache = LengthCache.build(ds)
    for step in gmt_schedule(cache, WORLD, 8192):
        for g in step:
            if g is not None and len(g.samples) > 1:
                assert max(s.length for s in g.samples) * len(g.samples) <= 8192
    for step in hfg_schedule(cache, WORLD, 8):
        assert all(g is not None and len(g.samples) <= 8 for g in step)
    assert len({len(s) for s in bmt_schedule(cache, WORLD, 8192)}) == 1


@pytest.mark.parametrize("name", ["ultrachat", "sharegpt4o"])
def test_stale_length_cache_raises_in_both(name):
    scale, _ = DATASETS[name]
    ds, jax_ds = get_dataset(name, scale=scale), jax_get_dataset(name, scale=scale)
    ours, theirs = LengthCache.build(ds), jax_oracles.LengthCache.build(jax_ds)
    assert ours.key == theirs.key and ours.lengths == theirs.lengths
    ours.validate(ds, ds.policy)
    theirs.validate(jax_ds, jax_ds.policy)
    with pytest.raises(StaleCacheError, match="rebuild required"):
        ours.validate(ds, PipelinePolicy(template="llama3", cutoff_len=16384))
    with pytest.raises(jax_oracles.StaleCacheError, match="rebuild required"):
        theirs.validate(jax_ds, JaxPolicy(template="llama3", cutoff_len=16384))


# -- the tile census -------------------------------------------------------------


def _packed_segments(seed: int, rows: int, s: int) -> np.ndarray:
    """Seeded packing: samples of random length back to back, a padding
    tail (and one all-padding row when rows > 2)."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((rows, s), np.int32)
    for r in range(rows - (rows > 2)):
        end = s - int(rng.integers(0, s // 3))
        cursor, sid = 0, 1
        while cursor < end:
            n = int(rng.integers(4, s // 3))
            seg[r, cursor:min(end, cursor + n)] = sid
            cursor, sid = cursor + n, sid + 1
    return seg


# (S, requested block_q, requested block_kv): 200 resolves to block 40.
CENSUS = ((256, 64, 64), (200, 128, 128), (384, 128, 64), (256, 32, 128))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,bq,bkv", CENSUS)
def test_live_tile_counts_match_jax_and_the_tables(s, bq, bkv, causal):
    for seed in (0, 1):
        seg = _packed_segments(seed + s, 3, s)
        ours = live_tile_counts(seg, s, bq, bkv, causal=causal)
        assert ours == jax_live_tile_counts(seg, s, bq, bkv, causal=causal)
        assert live_tile_counts(torch.from_numpy(seg), s, bq, bkv, causal=causal) == ours
        tables = build_liveness_tables(torch.from_numpy(seg), block_q=ours["block_q"],
                                       block_kv=ours["block_kv"], causal=causal)
        assert int(tables.kv_count.sum()) == ours["segment_live"]
        assert int(tables.q_count.sum()) == ours["segment_live"]
        nq, nk = s // ours["block_q"], s // ours["block_kv"]
        reach = sum(1 for qb in range(nq) for kb in range(nk)
                    if not causal or qb * ours["block_q"] + ours["block_q"] - 1 >= kb * ours["block_kv"])
        assert ours["causal_live"] == 3 * reach
        assert 0 < ours["segment_live"] < ours["causal_live"] <= ours["tiles"]
    if s == 200:
        assert ours["block_q"] == ours["block_kv"] == 40


@pytest.mark.parametrize("s,bq,bkv", CENSUS)
def test_fetched_tile_counts_match_jax(s, bq, bkv):
    seg = _packed_segments(7 + s, 3, s)
    for kw in (dict(), dict(heads=4, kv_heads=2, head_dim=128, itemsize=2),
               dict(causal=False, heads=2, kv_heads=2)):
        ours = fetched_tile_counts(seg, s, bq, bkv, **kw)
        assert ours == jax_fetched_tile_counts(seg, s, bq, bkv, **kw), kw
        assert ours["pruned_fetches"] < ours["dense_fetches"] == ours["grid_steps"]
        assert ours["live_tiles"] == live_tile_counts(
            seg, s, bq, bkv, causal=kw.get("causal", True))["segment_live"]


def test_census_gauges_match_jax():
    seg = _packed_segments(3, 3, 256)
    reg, jax_reg = obs.default_registry(), jax_obs.default_registry()
    live_tile_counts(seg, 256, 64, 64)
    fetched_tile_counts(seg, 256, 64, 64, heads=4, kv_heads=2)
    jax_live_tile_counts(seg, 256, 64, 64)
    jax_fetched_tile_counts(seg, 256, 64, 64, heads=4, kv_heads=2)
    names = ("kernel_live_tile_fraction", "kernel_fetched_tile_fraction", "kernel_fetched_kv_bytes")
    ours = {k: v for k, v in reg.flat().items() if k.startswith(names)}
    theirs = {k: v for k, v in jax_reg.flat().items() if k.startswith(names)}
    assert len(ours) == 6 and ours == theirs
