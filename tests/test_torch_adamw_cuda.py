"""The multi-tensor AdamW kernels (``kernels/adamw.py``, ``csrc/adamw.cu``)
on the card, against their plain version ``adamw_update_plain``.

Every test here is marked ``cuda`` and skips itself where no CUDA device is
present (the kernels have no CPU mode).  The file imports neither JAX nor
the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_adamw_cuda.py

Tolerances, each with its reason:

* ``grad_norm``: relative 1e-6 against the plain version's norm, since the
  two sum the squares in other orders (fp32 in both);
* the update is held against the plain version given the kernel's norm
  (``global_norm`` patched to return it), so that the sum order, the one
  input the two compute differently, does not enter it: the clip scale's
  last bit would flip the bf16 rounding of a few clipped gradients;
* m and v: relative 1e-6 in fp32, one ulp in bf16; p: one ulp of its dtype
  (contraction of products into FMAs, which the kernel's explicit
  round-to-nearest intrinsics rule out, so the kernel is expected bit-exact).
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.kernels import adamw
from repro_torch.models import LM
from repro_torch.train import optimizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MANTISSA = {torch.float32: 23, torch.bfloat16: 7}
CFG = dict(lr=1e-2, total_steps=10, warmup_ratio=0.2, grad_clip=4.0)  # steps 1-3 cross the warmup's end


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _qwen3_shapes():
    params = LM(get_config("qwen3_0_6b"), device="meta").init()
    return [tuple(p.shape) for p in optimizer.tree_leaves(params)]


LEAVES = {
    "qwen3-311": _qwen3_shapes,
    "odd": lambda: [(1,), (7,), (1023,), ((1 << 16) + 3,)],
}


def _randn(shape, std, dtype, gen):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)


def _grads(shapes, dtype, gen, step):
    """Gradients of global norm ~20 on step 0 (clipped at 4) and ~1 after."""
    total = sum(int(np.prod(s)) for s in shapes)
    std = (20.0 if step == 0 else 1.0) / total ** 0.5
    return [_randn(s, std, dtype, gen) for s in shapes]


def _ulps(a, b):
    """The largest distance between ``a`` and ``b`` in units in the last
    place of their dtype, at the larger magnitude of each pair."""
    mant = MANTISSA[a.dtype]
    a64, b64 = a.double(), b.double()
    mag = torch.maximum(a64.abs(), b64.abs())
    ulp = torch.exp2(torch.clamp(torch.floor(torch.log2(mag)), min=-126.0) - mant)
    diff = (a64 - b64).abs()
    return float(torch.where(diff == 0, 0.0, diff / ulp).max()) if a.numel() else 0.0


def _assert_matches(kernel_tree, plain_tree, what):
    for a, b in zip(optimizer.tree_leaves(kernel_tree), optimizer.tree_leaves(plain_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if what in ("m", "v") and a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
        else:
            assert _ulps(a, b) <= 1.0, what


def _run_pair(params, grads_of, cfg, monkeypatch, steps=3):
    """``steps`` steps of the kernel and of the plain version given the
    kernel's norm, from the same weights; the last metrics of each and the
    plain version's own norm at each step."""
    plain = [p.clone() for p in params]
    kst, pst = optimizer.init_opt_state(params, cfg), optimizer.init_opt_state(plain, cfg)
    norms = []
    for step in range(steps):
        grads = grads_of(step)
        own = optimizer.global_norm(grads)
        km = optimizer.adamw_update(params, grads, kst, cfg)
        with monkeypatch.context() as patch:
            patch.setattr(optimizer, "global_norm", lambda tree, norm=km["grad_norm"]: norm.clone())
            pm = optimizer.adamw_update_plain(plain, grads, pst, cfg)
        norms.append((float(km["grad_norm"]), float(own)))
        assert float(km["lr"]) == pytest.approx(float(pm["lr"]), rel=1e-6)
        _assert_matches(params, plain, "p")
        _assert_matches(kst["m"], pst["m"], "m")
        _assert_matches(kst["v"], pst["v"], "v")
        assert int(kst["step"]) == int(pst["step"]) == step + 1
    return norms


@pytest.mark.cuda
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("leaves", list(LEAVES))
def test_kernel_matches_plain_version(leaves, param_dtype, moment_dtype, monkeypatch):
    """Three steps, the first clipped (norm > grad_clip), of the kernel
    against the plain version: the norm at each step, then p, m and v
    (module docstring)."""
    _need_card()
    shapes = LEAVES[leaves]()
    dtype = DTYPES[param_dtype]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = [_randn(s, 0.02, dtype, gen) for s in shapes]
    cfg = optimizer.OptimizerConfig(**CFG, moment_dtype=moment_dtype)
    norms = _run_pair(params, lambda step: _grads(shapes, dtype, gen, step), cfg, monkeypatch)
    assert norms[0][1] > cfg.grad_clip > norms[1][1]
    for ours, theirs in norms:
        assert ours == pytest.approx(theirs, rel=1e-6)
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_kernel_on_a_tree_of_mixed_dtypes(monkeypatch):
    """bf16 and fp32 weights in one tree, one bf16 weight with fp32
    gradients (what the data-parallel step's compressed all-reduce hands
    over), unaligned views of one flat buffer and a leaf with no elements:
    one launch a dtype group and pass, each leaf as the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(3, 1000), (17,), (0,), (4097,), (64, 65)]
    dtypes = [torch.bfloat16, torch.float32, torch.float32, torch.bfloat16, torch.float32]
    grad_dtypes = [torch.bfloat16, torch.float32, torch.float32, torch.float32, torch.float32]
    params = [_randn(s, 0.02, d, gen) for s, d in zip(shapes, dtypes)]

    def grads_of(step):
        flat = _randn((1 + sum(int(np.prod(s)) for s in shapes),), 0.1 if step == 0 else 0.01, torch.float32, gen)
        views, at = [], 1  # offset 1: no fp32 view starts on 16 bytes
        for s, d in zip(shapes, grad_dtypes):
            n = int(np.prod(s))
            views.append(flat[at:at + n].view(s) if d == torch.float32 else flat[at:at + n].view(s).to(d))
            at += n
        return views

    cfg = optimizer.OptimizerConfig(**CFG)
    adamw.reset_launches()
    norms = _run_pair(params, grads_of, cfg, monkeypatch)
    assert norms[0][1] > cfg.grad_clip > norms[1][1]
    for ours, theirs in norms:
        assert ours == pytest.approx(theirs, rel=1e-6)
    # Groups (bf16, bf16, f32), (f32, f32, f32), (bf16, f32, f32): three
    # launches of each pass and the finish, three steps.
    assert adamw.LAUNCHES == {"adamw_sqnorm": 9, "adamw_finish": 3, "adamw_update": 9}


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit():
    """Two runs of two steps from the same inputs give the same bits: a fixed
    chunk per block and a fixed order of every sum, no atomics."""
    _need_card()
    shapes = _qwen3_shapes()
    cfg = optimizer.OptimizerConfig(**CFG)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device="cuda").manual_seed(2)
        params = [_randn(s, 0.02, torch.bfloat16, gen) for s in shapes]
        state = optimizer.init_opt_state(params, cfg)
        metrics = [optimizer.adamw_update(params, _grads(shapes, torch.bfloat16, gen, step), state, cfg)
                   for step in range(2)]
        runs.append(optimizer.tree_leaves([params, state, metrics]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    del runs
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_kernel_counts_its_launches(monkeypatch):
    """Qwen3-0.6B's 311 leaves: four launches of each pass and the finish, on
    the wrapper's counts and in ``kernel_adamw_launches_total``, each step."""
    _need_card()
    monkeypatch.setattr(obs.metrics, "_DEFAULT", obs.MetricsRegistry(enabled=True))
    shapes = _qwen3_shapes()
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = [_randn(s, 0.02, torch.bfloat16, gen) for s in shapes]
    cfg = optimizer.OptimizerConfig(**CFG)
    state = optimizer.init_opt_state(params, cfg)
    adamw.reset_launches()
    for step in range(2):
        optimizer.adamw_update(params, _grads(shapes, torch.bfloat16, gen, step), state, cfg)
    assert adamw.LAUNCHES == {"adamw_sqnorm": 8, "adamw_finish": 2, "adamw_update": 8}
    assert obs.default_registry().flat()["kernel_adamw_launches_total"] == 18
    torch.cuda.synchronize()
    del params, state
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    """A non-contiguous leaf, a dtype the kernels do not take, a gradient on
    another device and shapes that differ each raise before any launch."""
    _need_card()
    cfg = optimizer.OptimizerConfig(**CFG)

    def call(p, g):
        optimizer.adamw_update([p], [g], optimizer.init_opt_state([p], cfg), cfg)

    p = torch.zeros((8, 8), device="cuda")
    adamw.reset_launches()
    with pytest.raises(ValueError, match="contiguous"):
        call(p, torch.zeros((8, 8), device="cuda").t())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        call(p.half(), torch.zeros((8, 8), device="cuda", dtype=torch.float16))
    with pytest.raises(ValueError, match="one device"):
        call(p, torch.zeros((8, 8)))
    with pytest.raises(ValueError, match="shapes differ"):
        call(p, torch.zeros((64,), device="cuda"))
    assert adamw.LAUNCHES == dict.fromkeys(adamw.LAUNCHES, 0)


@pytest.mark.cuda
def test_leaf_past_2_31_elements_matches_plain_at_its_ends():
    """One leaf of 2^31 + 5 elements with bf16 weights, gradients and
    moments (8 B a weight, ~17 GB): the 64-bit offsets reach its last
    elements.  The step is not clipped, so the kernel's update of the first
    and last elements equals the plain version's on copies of them (one ulp,
    as above), and its norm the plain chunked norm (relative 1e-6)."""
    _need_card()
    n = (1 << 31) + 5
    gen = torch.Generator(device="cuda").manual_seed(4)
    p = _randn((n,), 0.02, torch.bfloat16, gen)
    g = _randn((n,), 1e-5, torch.bfloat16, gen)
    cfg = optimizer.OptimizerConfig(**CFG, moment_dtype="bfloat16")
    ends = [slice(0, 4096), slice(n - (1 << 20) - 5, n)]
    plain = [p[s].clone() for s in ends]
    state = optimizer.init_opt_state([p], cfg)
    plain_state = optimizer.init_opt_state(plain, cfg)
    metrics = optimizer.adamw_update([p], [g], state, cfg)
    own = optimizer.global_norm([g])
    assert float(own) < cfg.grad_clip
    assert float(metrics["grad_norm"]) == pytest.approx(float(own), rel=1e-6)
    optimizer.adamw_update_plain(plain, [g[s].clone() for s in ends], plain_state, cfg)
    for i, s in enumerate(ends):
        for ours, theirs in ((p, plain), (state["m"][0], plain_state["m"]), (state["v"][0], plain_state["v"])):
            assert _ulps(ours[s], theirs[i]) <= 1.0
    del p, g, state, plain_state
    torch.cuda.empty_cache()
