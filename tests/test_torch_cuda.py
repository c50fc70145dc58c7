"""Card-only checks of the port: the CUDA kernels, the engine and a train
step on the GPU.

Every test here is marked ``cuda`` and skips itself where no CUDA device is
present (the kernels have no CPU mode).  The file imports neither JAX nor the
JAX package, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: bf16 atol = rtol = 2e-2, fp32 2e-5 (no TF32 anywhere), on rows
with at least one visible key.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import segment_flash_attention_bwd_ref, segment_flash_attention_ref
from repro_torch.models import LM
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, synth_request_trace
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state, tree_leaves
from repro_torch.train.trainer import assemble_model_batch, make_train_step

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _inputs(seed, b, s, h, kv, d, dtype):
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        end = s - int(rng.integers(1, s // 4))
        cuts = np.sort(rng.choice(np.arange(1, end), size=3, replace=False))
        for j, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, end])):
            seg[i, lo:hi] = j + 1
    qkv = [torch.from_numpy(rng.standard_normal((b, s, n, d), dtype=np.float32)).to("cuda", dtype)
           for n in (h, kv, kv)]
    return (*qkv, torch.from_numpy(seg).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 16, 8, 128), (8, 256, 16, 8, 128), (3, 96, 4, 2, 64),
                                   (2, 200, 4, 1, 32)])
def test_kernels_vs_plain_and_bitexact(dtype, shape):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, d = shape
    q, k, v, seg = _inputs(0, b, s, h, kv, d, dtype)
    blk = fa.select_block(s, 128)  # 200 -> 40: a block that is not a power of two
    fa.reset_launches()
    o1, l1 = fa.segment_flash_attention(q, k, v, seg, block_q=blk, block_kv=blk, return_lse=True)
    o4, l4 = fa.segment_flash_attention_pruned(q, k, v, seg, block_q=blk, block_kv=blk,
                                               return_lse=True)
    ro, rl = segment_flash_attention_ref(q, k, v, seg, return_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {**dict.fromkeys(fa.LAUNCHES, 0),
                           "segment_flash_attention": 1, "segment_flash_attention_pruned": 1}
    assert torch.equal(o1, o4) and torch.equal(l1, l4)
    valid = seg > 0
    tol = TOL[dtype]
    torch.testing.assert_close(o1[valid].float(), ro[valid].float(), atol=tol, rtol=tol)
    torch.testing.assert_close(l1[valid], rl[valid], atol=2e-5, rtol=2e-5)
    assert torch.all(o1[~valid] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 16, 8, 128), (2, 256, 16, 8, 128), (3, 96, 4, 2, 64),
                                   (2, 200, 4, 1, 32)])
def test_backward_kernels_vs_plain_and_bitexact(dtype, shape):
    """K2/K3 (dense) and K5/K6 (pruned) against the plain backward on valid
    rows, K5 == K2 and K6 == K3 bit for bit, and exactly zero gradients on
    all-padding rows."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, d = shape
    q, k, v, seg = _inputs(2, b, s, h, kv, d, dtype)
    blk = fa.select_block(s, 128)
    kw = dict(block_q=blk, block_kv=blk)
    out, lse = fa.segment_flash_attention(q, k, v, seg, return_lse=True, **kw)
    do = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(3), device="cuda",
                     dtype=torch.float32).to(dtype)
    fa.reset_launches()
    dense = fa.segment_flash_attention_bwd(q, k, v, seg, out, lse, do, **kw)
    pruned = fa.segment_flash_attention_bwd_pruned(q, k, v, seg, out, lse, do, **kw)
    ref = segment_flash_attention_bwd_ref(q, k, v, seg, out, lse, do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {**dict.fromkeys(fa.LAUNCHES, 0),
                           "segment_flash_attention_bwd_dq": 1, "segment_flash_attention_bwd_dkv": 1,
                           "segment_flash_attention_bwd_pruned_dq": 1,
                           "segment_flash_attention_bwd_pruned_dkv": 1}
    valid, tol = seg > 0, TOL[dtype]
    for name, ours, plain, theirs in zip(("dq", "dk", "dv"), dense, ref, pruned):
        assert torch.equal(ours, theirs), f"{name}: pruned != dense"
        torch.testing.assert_close(ours[valid].float(), plain[valid].float(), atol=tol, rtol=tol)
        assert torch.all(ours[~valid] == 0), f"{name} is not zero on padding rows"


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    _need_card()
    q, k, v, seg = _inputs(1, 1, 64, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.segment_flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, seg,
                                   block_q=64, block_kv=64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.segment_flash_attention(q.half(), k.half(), v.half(), seg, block_q=64, block_kv=64)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.detach().to(device)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_engine():
    """Smoke-size fp32 engine on one set of weights: the card (pruned kernel)
    and the CPU (the kernels' plain version) generate the same ids."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen3_0_6b")
    trace = synth_request_trace(10, vocab=cfg.vocab_size, prompt_min=4, prompt_max=40,
                                new_min=2, new_max=16, seed=0)
    config = ServeConfig(num_slots=4, max_len=128, l_max=384, lookahead=8)
    cpu_model = LM(dataclasses.replace(cfg, attn_impl="flash"), device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    card_model = LM(cfg)
    card_params = card_model.load_params(_to(cpu_params, card_model.device))
    ids = {}
    for name, model, params in (("cpu", cpu_model, cpu_params), ("cuda", card_model, card_params)):
        fa.reset_launches()
        engine = ContinuousBatchingEngine(model, params, config, device=model.device)
        rids = [engine.submit(p, n) for p, n in trace]
        out = engine.run()
        ids[name] = [out[r].tolist() for r in rids]
    assert fa.LAUNCHES["segment_flash_attention_pruned"] == engine.stats.prefill_calls * cfg.n_layers
    assert fa.LAUNCHES["segment_flash_attention"] == 0
    assert ids["cuda"] == ids["cpu"]


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """One smoke-size fp32 train step (packed, flash pruned) on the card
    against the same step on the CPU (the kernels' plain versions): loss and
    grad_norm at rtol 1e-4, and the updated weights within 2·lr (an element
    whose near-zero gradient differs in sign moves by up to lr either way)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), attn_impl="flash", attn_grid="pruned")
    loader = OnlineDynamicLoader(
        get_dataset("uniform_narrow", scale=0.05), 2,
        OdbConfig(l_max=512, buffer_size=64, prefetch_factor=16),
        bucket_spec=BucketSpec(min_len=128, max_len=16384, max_count=1024),
        layout="packed", vocab_size=cfg.vocab_size,
    )
    step = next(iter(loader.epoch(0)))
    opt_cfg = OptimizerConfig(total_steps=100)
    cpu_model = LM(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    card_model = LM(cfg)
    card_params = card_model.load_params(_to(cpu_params, card_model.device))
    results = {}
    for name, model, params in (("cpu", cpu_model, cpu_params), ("cuda", card_model, card_params)):
        fa.reset_launches()
        state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
        batch = assemble_model_batch(step, loader.layout, model.device)
        _, metrics = make_train_step(model, opt_cfg)(state, batch)
        results[name] = (float(metrics["loss"]), float(metrics["grad_norm"]), float(metrics["lr"]),
                         [p.detach().cpu() for p in tree_leaves(params)])
    n = cfg.n_layers
    assert fa.LAUNCHES == {**dict.fromkeys(fa.LAUNCHES, 0),
                           "segment_flash_attention_pruned": 2 * n,  # remat: forward twice
                           "segment_flash_attention_bwd_pruned_dq": n,
                           "segment_flash_attention_bwd_pruned_dkv": n}
    (l_cpu, g_cpu, lr, p_cpu), (l_card, g_card, _, p_card) = results["cpu"], results["cuda"]
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    np.testing.assert_allclose(g_card, g_cpu, rtol=1e-4)
    for a, b in zip(p_card, p_cpu):
        torch.testing.assert_close(a, b, atol=2 * lr, rtol=0)
