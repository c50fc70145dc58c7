"""The multi-tensor AdamW's host side, on the CPU: the chunk table the
kernels walk (``kernels/adamw.plan``), the constants they are handed, and
the dispatch of ``adamw_update``, which keeps CPU and meta leaves on the
plain version.  The kernels themselves run only on the card
(``tests/test_torch_adamw_cuda.py``)."""

import bisect
import math
import types

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.kernels import adamw, build, flash_attention, mla_attention, ssd_scan
from repro_torch.models import LM
from repro_torch.train import optimizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)


def _rows(launches, numels, chunk):
    """(launch, block, leaf, start, length) of every block, in launch and
    block order, by the mapping the kernels use: a block's leaf is the last
    one whose first block is at most the block."""
    rows = []
    for j, launch in enumerate(launches):
        for b in range(launch.blocks):
            k = bisect.bisect_right(launch.chunk0, b) - 1
            leaf, start = launch.leaves[k], (b - launch.chunk0[k]) * chunk
            rows.append((j, b, leaf, start, min(chunk, numels[leaf] - start)))
    return rows


def _qwen3_numels():
    params = LM(get_config("qwen3_0_6b"), device="meta").init()
    return [p.numel() for p in optimizer.tree_leaves(params)]


_CASES = {
    "one-leaf-past-2^31": ([(1 << 31) + 5], None, adamw.CHUNK, adamw.MAX_LEAVES),
    "empty-leaves": ([0, 5, 0, 0, 17, 0, 8, 0], None, 8, adamw.MAX_LEAVES),
    "all-empty": ([0, 0], None, 8, adamw.MAX_LEAVES),
    "odd-sizes": ([1, 7, 1023, (1 << 16) + 3], None, adamw.CHUNK, adamw.MAX_LEAVES),
    "dtype-groups": ([9, 3, 16, 1, 0, 40, 8, 2], ["bf16", "f32", "bf16", "mixed", "f32", "f32", "mixed", "bf16"],
                     8, 2),
    "qwen3-311-leaves": (_qwen3_numels(), None, adamw.CHUNK, adamw.MAX_LEAVES),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_plan_covers_every_element_once_in_order(case):
    """Within each dtype group, the blocks of the launches, in order, cover
    every element of every leaf with elements once, leaf after leaf in the
    tree's order and each leaf from its first element to its last; a leaf
    with no elements takes no block; no launch holds more than its share of
    leaves, and every launch's leaves share its key."""
    numels, keys, chunk, max_leaves = _CASES[case]
    launches = adamw.plan(numels, keys, chunk=chunk, max_leaves=max_leaves)
    keys = keys or [None] * len(numels)
    rows = _rows(launches, numels, chunk)
    for launch in launches:
        assert 1 <= len(launch.leaves) <= max_leaves
        assert {keys[i] for i in launch.leaves} == {launch.key}
        assert launch.chunk0[0] == 0 and list(launch.chunk0) == sorted(set(launch.chunk0))
        assert launch.blocks == sum(-(-numels[i] // chunk) for i in launch.leaves)
    for key in dict.fromkeys(keys):
        mine = [r for r in rows if keys[r[2]] == key]
        expected = [i for i, n in enumerate(numels) if n and keys[i] == key]
        assert list(dict.fromkeys(r[2] for r in mine)) == expected
        for leaf in expected:
            spans = [(start, length) for _, _, i, start, length in mine if i == leaf]
            assert spans[0][0] == 0 and all(length >= 1 for _, length in spans)
            assert all(a + la == b for (a, la), (b, _) in zip(spans, spans[1:]))
            assert spans[-1][0] + spans[-1][1] == numels[leaf]
    assert not any(numels[r[2]] == 0 for r in rows)
    assert sum(r[4] for r in rows) == sum(numels)


def test_plan_of_a_leaf_past_2_31_elements_reaches_its_last():
    """The 64-bit offsets: a leaf of 2^31 + 5 elements takes 2^15 + 1
    blocks, the last starting at 2^31 and holding 5 elements."""
    (launch,) = adamw.plan([(1 << 31) + 5])
    assert launch.blocks == (1 << 15) + 1 and launch.chunk0 == (0,)
    assert _rows([launch], [(1 << 31) + 5], adamw.CHUNK)[-1] == (0, 1 << 15, 0, 1 << 31, 5)


def test_plan_splits_qwen3_into_four_launches():
    """Qwen3-0.6B's 311 leaves, one dtype group: four launches of each pass,
    nine kernels a step with the finish."""
    launches = adamw.plan(_qwen3_numels(), [(1, 1, 0)] * 311)
    assert [len(launch.leaves) for launch in launches] == [80, 80, 80, 71]
    assert 2 * len(launches) + 1 == 9


def test_hyper_constants_are_the_plain_versions_fp32_scalars():
    """The finish and update kernels' constants are the fp32 values the
    plain version computes with: ``cosine_lr``'s warmup and span tensors,
    and the Python scalars as torch rounds them."""
    cfg = optimizer.OptimizerConfig(lr=3e-4, warmup_ratio=0.07, total_steps=333, betas=(0.9, 0.95),
                                    eps=1e-8, weight_decay=0.1, grad_clip=1.5, min_lr_fraction=0.1)
    finish, update = adamw._hyper(cfg)
    warmup = torch.tensor(max(cfg.warmup_ratio * cfg.total_steps, 1.0), dtype=torch.float32)
    span = torch.clamp(torch.tensor(float(cfg.total_steps)) - warmup, min=1.0)
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    assert finish.tolist() == [f32(1.5), f32(3e-4), float(warmup), float(span), f32(0.1), f32(0.9 * 0.5),
                               f32(math.pi), f32(0.9), f32(0.95)]
    assert update.tolist() == [f32(0.9), f32(1 - 0.9), f32(0.95), f32(1 - 0.95), f32(1e-8), f32(0.1)]


def _tree(rng, device, dtype):
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5)}, "e": (0,)}
    leaf = lambda s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)  # noqa: E731
    return {"a": leaf(shapes["a"]), "b": {k: leaf(v) for k, v in shapes["b"].items()}, "e": leaf(shapes["e"])}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_off_the_card_takes_the_plain_version(device, moment_dtype, monkeypatch):
    """CPU and meta leaves never reach the kernel: no launch is counted, on
    the wrapper or in the registry, and the result is the plain version's
    (bit for bit on the CPU; the meta stand-ins keep their shapes and
    dtypes, as the dry runs need)."""
    monkeypatch.setattr(obs.metrics, "_DEFAULT", obs.MetricsRegistry(enabled=True))
    adamw.reset_launches()
    cfg = optimizer.OptimizerConfig(lr=1e-2, total_steps=10, warmup_ratio=0.2, grad_clip=1.0,
                                    moment_dtype=moment_dtype)
    rng = np.random.default_rng(3)
    ours, theirs = (_tree(np.random.default_rng(5), device, torch.bfloat16) for _ in range(2))
    states = [optimizer.init_opt_state(t, cfg) for t in (ours, theirs)]
    for scale in (3.0, 0.1):
        grads = _tree(rng, device, torch.bfloat16)
        grads = optimizer.tree_map(lambda g: g * scale, grads)
        got = optimizer.adamw_update(ours, grads, states[0], cfg)
        want = optimizer.adamw_update_plain(theirs, grads, states[1], cfg)
        for a, b in zip(optimizer.tree_leaves([ours, states[0], got]),
                        optimizer.tree_leaves([theirs, states[1], want])):
            assert a.device.type == device and a.dtype == b.dtype and a.shape == b.shape
            if device == "cpu":
                assert torch.equal(a, b)
    assert adamw.LAUNCHES == dict.fromkeys(adamw.LAUNCHES, 0)
    assert "kernel_adamw_launches_total" not in obs.default_registry().flat()


def test_adamw_step_refuses_leaves_off_the_card():
    """The kernel's wrapper, called directly with CPU tensors, raises before
    it builds or loads anything: it has no CPU mode and no fallback."""
    p = [torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA device"):
        adamw.adamw_step(p, [torch.zeros(4)], [torch.zeros(4)], [torch.zeros(4)],
                         torch.zeros((), dtype=torch.int32), optimizer.OptimizerConfig())
    assert adamw.LAUNCHES == dict.fromkeys(adamw.LAUNCHES, 0)


# The four kernel modules and the registry counter each one feeds, if any.
LAUNCH_MODULES = {flash_attention: None, mla_attention: "kernel_mla_launches_total",
                  adamw: "kernel_adamw_launches_total", ssd_scan: None}
LAUNCH_CASES = [(module, name) for module in LAUNCH_MODULES for name in sorted(module.LAUNCHES)]


@pytest.mark.parametrize("module, name", LAUNCH_CASES, ids=[name for _, name in LAUNCH_CASES])
def test_each_launch_is_counted_as_it_is_made(monkeypatch, module, name):
    """``kernels/build.launch``, as each kernel module calls it: tensors pass
    as their addresses, None as a null pointer and the device's current
    stream last; every launch adds one to its module's ``LAUNCHES`` entry
    and one to the module's registry counter, if it has one, at once; a
    launch whose CUDA call failed raises the library's message and counts
    nowhere."""
    monkeypatch.setattr(obs.metrics, "_DEFAULT", obs.MetricsRegistry(enabled=True))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=7))
    for m in LAUNCH_MODULES:
        m.reset_launches()
    counter = getattr(module, "_COUNTER", None)
    assert (counter and counter[0]) == LAUNCH_MODULES[module]
    calls, rcs = [], iter([0, 0, 0, 1])
    lib = types.SimpleNamespace(error_string=lambda rc: b"invalid argument",
                                kernel=lambda *args: calls.append(args) or next(rcs))
    t = torch.zeros(4)

    def counts():
        flat = obs.default_registry().flat()
        return [dict(m.LAUNCHES) for m in LAUNCH_MODULES], [flat.get(c, 0) for c in LAUNCH_MODULES.values() if c]

    def want(k):
        launches = [{**dict.fromkeys(m.LAUNCHES, 0), **({name: k} if m is module else {})} for m in LAUNCH_MODULES]
        return launches, [k if c == LAUNCH_MODULES[module] else 0 for c in LAUNCH_MODULES.values() if c]

    for k in range(1, 4):
        build.launch(lib, "kernel", 3, t, None, 2.5, device=torch.device("cuda"), launches=module.LAUNCHES,
                     name=name, counter=counter)
        args = calls[-1]
        assert args[0] == 3 and args[3] == 2.5
        assert [a.value for a in (args[1], args[2], args[4])] == [t.data_ptr(), None, 7]
        assert counts() == want(k)
    with pytest.raises(RuntimeError, match=f"{name}: CUDA error 1 \\(invalid argument\\)"):
        build.launch(lib, "kernel", device=torch.device("cuda"), launches=module.LAUNCHES, name=name,
                     counter=counter)
    assert counts() == want(3)
    module.reset_launches()
