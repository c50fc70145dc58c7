"""Card-only checks of the port: the CUDA kernels, the engine, a train step,
the streaming data path's staging of step arrays on the card, the SSM
model's prefill and decode, the SSD's autograd Function and a bf16 SSM
checkpoint on the GPU.

Every test here is marked ``cuda`` and skips itself where no CUDA device is
present (the kernels have no CPU mode).  The file imports neither JAX nor the
JAX package, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: bf16 atol = rtol = 2e-2, fp32 2e-5 (no TF32 anywhere), on rows
with at least one visible key.  The SSD kernel (K7) in fp32 at atol 1e-4,
rtol 1e-3, the JAX package's SSD tolerance (the kernel and the plain version
sum in other orders and take differences of cumulative sums).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import (
    segment_flash_attention_bwd_ref,
    segment_flash_attention_ref,
    ssd_chunked_ref,
)
from repro_torch.models import LM
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, synth_request_trace
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state, tree_leaves
from repro_torch.core.layout import global_batch_arrays
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    assemble_model_batch,
    make_train_step,
    staged_arrays,
)

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
@pytest.mark.parametrize("shape,q_scale", [
    ((1, 64, 16, 8, 128), 1.0), ((8, 256, 16, 8, 128), 1.0), ((3, 96, 4, 2, 64), 1.0),
    ((2, 200, 4, 1, 32), 1.0),
    ((2, 256, 16, 8, 128), 4.0),  # peaked softmax: P near one-hot
    ((2, 256, 16, 2, 128), 1.0),  # a GQA group of 8
], ids=["1x64", "8x256", "3x96-d64", "2x200-block40", "2x256-peaked", "2x256-group8"])
def test_kernels_vs_plain_and_bitexact(dtype, shape, q_scale):
    """K1 (dense) and K4 (pruned) against the plain forward on valid rows
    (out at the dtype's tolerance, lse at 2e-5), K4 == K1 bit for bit, and
    exactly zero output on all-padding rows.  In bf16 both run on the tensor
    cores with P rounded to bf16 before P·V."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, d = shape
    q, k, v, seg = _inputs(0, b, s, h, kv, d, dtype)
    q = (q.float() * q_scale).to(dtype)
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
@pytest.mark.parametrize("shape,q_scale", [
    ((1, 64, 16, 8, 128), 1.0), ((2, 256, 16, 8, 128), 1.0), ((3, 96, 4, 2, 64), 1.0),
    ((2, 200, 4, 1, 32), 1.0),
    ((2, 256, 16, 8, 128), 4.0),  # peaked softmax: P near one-hot, its bf16 rounding at its worst
    ((2, 256, 16, 2, 128), 1.0),  # a GQA group of 8
], ids=["1x64", "2x256", "3x96-d64", "2x200-block40", "2x256-peaked", "2x256-group8"])
def test_backward_kernels_vs_plain_and_bitexact(dtype, shape, q_scale):
    """K2/K3 (dense) and K5/K6 (pruned) against the plain backward on valid
    rows, K5 == K2 and K6 == K3 bit for bit, and exactly zero gradients on
    all-padding rows.  In bf16 both passes run on the tensor cores with P
    and scale·dS rounded to bf16 (the same tolerance holds)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, d = shape
    q, k, v, seg = _inputs(2, b, s, h, kv, d, dtype)
    q = (q.float() * q_scale).to(dtype)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_backward_without_segments(dtype, causal):
    """K1 and K2/K3 with no segment ids (every row valid), causal or not,
    against the plain forward (out at the dtype's tolerance, lse at 2e-5)
    and the plain backward."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = _inputs(4, 2, 256, 16, 8, 128, dtype)
    kw = dict(causal=causal, block_q=128, block_kv=128)
    out, lse = fa.segment_flash_attention(q, k, v, None, return_lse=True, **kw)
    ref_out, ref_lse = segment_flash_attention_ref(q, k, v, None, causal=causal, return_lse=True)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol, msg="out")
    torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=2e-5, msg="lse")
    do = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(5), device="cuda",
                     dtype=torch.float32).to(dtype)
    ours = fa.segment_flash_attention_bwd(q, k, v, None, out, lse, do, **kw)
    ref = segment_flash_attention_bwd_ref(q, k, v, None, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    _need_card()
    q, k, v, seg = _inputs(1, 1, 64, 4, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.segment_flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, seg,
                                   block_q=64, block_kv=64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.segment_flash_attention(q.half(), k.half(), v.half(), seg, block_q=64, block_kv=64)
    # The bf16 kernels copy rows in 16-byte pieces: D % 8 == 0, aligned rows.
    # Nothing falls back: the forward and the backward raise.
    q, k, v, seg = _inputs(1, 1, 64, 4, 2, 12, torch.bfloat16)
    out, lse = (t.contiguous() for t in segment_flash_attention_ref(q, k, v, seg, return_lse=True))
    for fwd in (fa.segment_flash_attention, fa.segment_flash_attention_pruned):
        with pytest.raises(ValueError, match="forward kernels take head dims that are multiples of 8"):
            fwd(q, k, v, seg, block_q=64, block_kv=64)
    for bwd in (fa.segment_flash_attention_bwd, fa.segment_flash_attention_bwd_pruned):
        with pytest.raises(ValueError, match="backward kernels take head dims that are multiples of 8"):
            bwd(q, k, v, seg, out, lse, out, block_q=64, block_kv=64)
    q, k, v, seg = _inputs(1, 1, 64, 4, 2, 32, torch.bfloat16)
    out, lse = fa.segment_flash_attention(q, k, v, seg, block_q=64, block_kv=64, return_lse=True)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)[1:].view(q.shape)
    shifted.copy_(q)
    for fwd in (fa.segment_flash_attention, fa.segment_flash_attention_pruned):
        with pytest.raises(ValueError, match="forward kernels take 16-byte aligned q, k and v"):
            fwd(shifted, k, v, seg, block_q=64, block_kv=64)
    with pytest.raises(ValueError, match="backward kernels take 16-byte aligned"):
        fa.segment_flash_attention_bwd(shifted, k, v, seg, out, lse, out, block_q=64, block_kv=64)


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


@pytest.mark.cuda
@pytest.mark.parametrize("num_workers", [0, 2])
def test_streaming_device_put_stages_on_card(num_workers):
    """``streaming_epoch(prefetch=True, device_put=True, device="cuda")``
    with a long kernel queued on the stager's own stream before each step's
    copies, so the copies are still pending when a step reaches the
    consumer: every step carries the event recorded after its copies and its pinned sources,
    and after the consumer's wait (the trainer's ``staged_arrays``) every
    staged tensor equals the eager path's host array, exactly.  Most steps
    must reach the consumer with their event still pending, so a consumer
    that did not wait on it would read the copies' destinations before they
    are written."""
    _need_card()

    def loader():
        return OnlineDynamicLoader(
            get_dataset("uniform_narrow", scale=0.05), 2,
            OdbConfig(l_max=512, buffer_size=64, prefetch_factor=16),
            bucket_spec=BucketSpec(min_len=128, max_len=16384, max_count=1024),
            layout="packed", vocab_size=512,
        )

    eager = loader()
    want = [global_batch_arrays(s.batches, eager.layout) for s in eager.epoch(0)]
    streaming = loader()
    stage = streaming._stage_device

    def delayed_stage(loader_step, device, stream):
        with torch.cuda.device(device), torch.cuda.stream(stream):
            torch.cuda._sleep(50_000_000)  # ~25 ms of a long kernel before the copies
        return stage(loader_step, device, stream)

    streaming._stage_device = delayed_stage
    got, pending = [], 0
    for ls in streaming.streaming_epoch(0, prefetch=True, device_put=True, device="cuda",
                                        num_workers=num_workers):
        staged = ls.device
        assert isinstance(staged.event, torch.cuda.Event)
        assert all(t.is_pinned() for t in staged.host.values())
        pending += not staged.event.query()
        arrays = staged_arrays(staged, "cuda")
        assert all(t.is_cuda for t in arrays.values())
        got.append({k: v.cpu().numpy() for k, v in arrays.items()})
    assert len(got) == len(want) > 3
    # The race is real: most steps reach the consumer before their copies ran.
    assert pending >= len(got) // 2, f"{pending} of {len(got)} steps arrived with copies pending"
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert streaming.last_prefetch_stats.consumed == len(want)
    if num_workers:
        assert streaming.last_worker_stats.completed == len(want)


SSD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _ssd_inputs(seed, b, s, h, p, n, dtype, strided=False, decay=1.0):
    """x, adt, dt, B, C and an initial state on the card.  With ``strided``,
    x, B and C are column views of one (B, S, H*P + 2N) tensor, as the model
    passes them.  ``decay`` scales a (0.02: the state carries over chunks)."""
    rng = np.random.default_rng(seed)

    def card(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    xbc = card(np.concatenate([rng.standard_normal((b, s, h * p)) * 0.5,
                               rng.standard_normal((b, s, 2 * n)) * 0.4], axis=-1), dtype)
    if not strided:
        xbc = xbc.contiguous()
    x = xbc[..., : h * p].reshape(b, s, h, p)
    bp, cp = xbc[..., h * p : h * p + n], xbc[..., h * p + n :]
    if not strided:
        x, bp, cp = x.contiguous(), bp.contiguous(), cp.contiguous()
    dt = card(np.log1p(np.exp(rng.standard_normal((b, s, h)))))
    a = card(-np.exp(rng.standard_normal(h) * 0.3) * decay)
    init = card(rng.standard_normal((b, h, p, n)) * 0.5)
    return x, (a[None, None, :] * dt).contiguous(), dt, bp, cp, init


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [1.0, 0.02])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 64, 1, 8, 16, 16, False),  # the JAX sweep's ragged shapes: chunk 16, N 8
    (2, 96, 4, 8, 8, 32, False),
    (1, 256, 2, 16, 32, 64, True),
    (2, 96, 3, 12, 8, 32, True),  # rows not 16-byte aligned: plain loads
    (1, 320, 2, 16, 32, 160, True),  # a chunk of 64 + 64 + 32 rows: a ring stage reused
    (2, 64, 3, 5, 12, 32, True),  # odd P: plain loads of x, scalar stores of y
    (1, 48, 2, 6, 7, 24, False),  # odd N, P*N % 4 != 0, a chunk that is no multiple of 16
    (1, 2048, 2, 64, 128, 1024, True),  # the largest chunk: the most shared memory
    (2, 512, 24, 64, 128, 256, True),
    (1, 4096, 24, 64, 128, 256, True),  # the state passed over 16 chunks
])
def test_ssd_kernel_vs_plain(dtype, shape, decay):
    """K7 against its plain chunked version: y and the final state, from a
    zero and from a random initial state, on contiguous and strided inputs,
    with fast and slow decay.  bf16 runs the chunk-parallel tensor-core
    passes, fp32 the CUDA-core kernel, which gives the same bits on a second
    call (no atomics: its sums run in one fixed order)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    *dims, strided = shape
    b, s, h, p, n, chunk = dims
    x, adt, dt, bp, cp, init = _ssd_inputs(0, b, s, h, p, n, dtype, strided, decay)
    for initial in (None, init):
        ssd.reset_launches()
        y, final = ssd.ssd_scan(x, adt, dt, bp, cp, chunk=chunk, initial_state=initial,
                                return_final_state=True)
        ry, rfinal = ssd_chunked_ref(x, adt, dt, bp, cp, chunk, initial)
        torch.cuda.synchronize()
        assert ssd.LAUNCHES == {"ssd_scan": 1}
        assert y.dtype == dtype and final.dtype == torch.float32
        torch.testing.assert_close(y.float(), ry.float(), **SSD_TOL[dtype])
        torch.testing.assert_close(final, rfinal, **SSD_TOL[dtype])
        if dtype == torch.float32:
            y2, final2 = ssd.ssd_scan(x, adt, dt, bp, cp, chunk=chunk, initial_state=initial,
                                      return_final_state=True)
            assert torch.equal(y, y2) and torch.equal(final, final2)


@pytest.mark.cuda
def test_ssd_kernel_rejects_what_it_cannot_take():
    _need_card()
    x, adt, dt, bp, cp, _ = _ssd_inputs(1, 1, 64, 2, 8, 16, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd.ssd_scan(x.half(), adt, dt, bp.half(), cp.half(), chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd.ssd_scan(x, adt, dt, bp, cp, chunk=48)
    with pytest.raises(ValueError, match=r"\(B, S, N\)"):
        ssd.ssd_scan(x, adt, dt, bp[:, :32], cp, chunk=16)
    with pytest.raises(ValueError, match="P <= 64"):
        wide = torch.zeros((1, 64, 1, 128), device="cuda")
        ssd.ssd_scan(wide, adt[..., :1].contiguous(), dt[..., :1].contiguous(), bp, cp, chunk=16)
    with pytest.raises(ValueError, match="contiguous over"):
        ssd.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), adt, dt, bp, cp, chunk=16)
    x.requires_grad_()
    with pytest.raises(NotImplementedError, match="SSD backward is not ported"):
        ssd.ssd_scan(x, adt, dt, bp, cp, chunk=16)
    with torch.no_grad():
        ssd.ssd_scan(x, adt, dt, bp, cp, chunk=16)


@pytest.mark.cuda
def test_ssm_prefill_decode_on_card_matches_cpu():
    """Smoke-size fp32 mamba2 on one set of weights: prefill (a full chunk
    and a padded one, through K7) and eight decode steps (no kernel) on the
    card against the CPU port (the kernel's plain version)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("mamba2_130m")
    cpu_model = LM(cfg, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    card_model = LM(cfg)
    card_params = card_model.load_params(_to(cpu_params, card_model.device))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(1, cfg.vocab_size, size=(2, 32)))
    logits = {}
    for name, model, params in (("cpu", cpu_model, cpu_params), ("cuda", card_model, card_params)):
        ssd.reset_launches()
        t = tokens.to(model.device)
        first, caches = model.prefill(params, t[:, :24], 32)
        prefill_launches = dict(ssd.LAUNCHES)
        steps = [first]
        for i in range(24, 32):
            lg, caches = model.decode_step(params, caches, t[:, i : i + 1], i)
            steps.append(lg)
        logits[name] = torch.cat(steps, dim=1).cpu()
        if name == "cuda":
            assert prefill_launches == {"ssd_scan": cfg.n_layers}
            assert ssd.LAUNCHES == {"ssd_scan": cfg.n_layers}  # decode launches none
    torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["smoke", "overflow"])
def test_ssd_function_grads_on_card(dtype, case):
    """``ops.ssd_chunked_scan`` under grad on the card: K7 forward (one
    launch), the plain chunked form's gradient backward.  y against the
    plain version at the SSD tolerance, and the gradients of x, dt, a, B, C
    against plain autograd through ``ssd_chunked_ref`` at 2e-5 (fp32) or
    2e-2 (bf16), all finite.  "overflow" draws a and dt from mamba2's init
    (dt_bias 0, a over [-1, -16]): exp(acs_i - acs_j) above the diagonal
    overflows fp32 within a chunk of 256."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    if case == "smoke":
        b, s, h, p, n, chunk = 2, 128, 4, 16, 16, 32
        x, _, dt, bp, cp, _ = _ssd_inputs(3, b, s, h, p, n, dtype, strided=True, decay=0.02)
        a = -torch.exp(torch.linspace(0.0, 0.5, h, device="cuda")) * 0.02
    else:
        b, s, h, p, n, chunk = 1, 512, 8, 64, 128, 256
        x, _, _, bp, cp, _ = _ssd_inputs(4, b, s, h, p, n, dtype, strided=True)
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), device="cuda") * 0.5)
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    w = torch.randn(x.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    results = {}
    for route in ("function", "plain"):
        leaves = [t.detach().clone().requires_grad_() for t in (x, dt, a, bp, cp)]
        xx, dd, aa, bb, cc = leaves
        ssd.reset_launches()
        if route == "function":
            y = ops.ssd_chunked_scan(xx, dd, aa, bb, cc, chunk=chunk)
            assert ssd.LAUNCHES == {"ssd_scan": 1}
        else:
            y, _ = ssd_chunked_ref(xx, aa[None, None, :] * dd, dd, bb, cc, chunk)
        grads = torch.autograd.grad((y.float() * w).sum(), leaves)
        results[route] = (y, grads)
    (y, grads), (ry, rgrads) = results["function"], results["plain"]
    torch.testing.assert_close(y.float(), ry.float(), **SSD_TOL[dtype])
    for name, g, ref in zip(("x", "dt", "a", "B", "C"), grads, rgrads):
        assert g.dtype == ref.dtype and bool(torch.isfinite(g).all()), name
        torch.testing.assert_close(g.float(), ref.float(), atol=TOL[g.dtype], rtol=TOL[g.dtype],
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_bf16_mamba2_checkpoint_round_trip_on_card(tmp_path):
    """A bf16 mamba2 smoke state on the card (bf16 weights and moments, fp32
    a_log, dt_bias, d_skip) saved and restored in place by a fresh trainer:
    every leaf equal, on the card, in its dtype."""
    _need_card()
    cfg = dataclasses.replace(get_smoke_config("mamba2_130m"), dtype="bfloat16")

    def trainer():
        return Trainer(LM(cfg), None, OptimizerConfig(moment_dtype="bfloat16"),
                       TrainerConfig(checkpoint_dir=str(tmp_path)))

    first = trainer()
    state, step = first.restore_or_init(torch.Generator("cuda").manual_seed(0))
    assert step == 0
    gen = torch.Generator("cuda").manual_seed(1)
    with torch.no_grad():
        for t in tree_leaves(state["opt"]["m"]) + tree_leaves(state["opt"]["v"]):
            t.copy_(torch.randn(t.shape, device="cuda", generator=gen))
        state["opt"]["step"].fill_(5)
    save_checkpoint(tmp_path, 5, state, cfg=cfg)
    restored, step = trainer().restore_or_init(torch.Generator("cuda").manual_seed(2))
    assert step == 5
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
    assert restored["params"]["layers"][0]["mixer"]["in_x"].dtype == torch.bfloat16
    assert restored["params"]["layers"][0]["mixer"]["a_log"].dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["dense", "pruned"])
def test_autotune_probe_on_card(grid, tmp_path):
    """The measured block probe on the card (bf16, packed rows): every
    candidate runs, the pick is one of them, the second call is a hit."""
    _need_card()
    from repro_torch import obs
    from repro_torch.kernels import autotune

    cache = tmp_path / "blocks.json"
    reg = obs.default_registry()
    reg.reset()
    picked = autotune.autotune_blocks(2, 1024, 16, 8, 128, dtype=torch.bfloat16,
                                      has_segments=True, cache_path=cache, grid=grid)
    seconds = autotune.LAST_PROBE["seconds"]
    assert set(seconds) == set(autotune.candidate_blocks(1024)) and picked in seconds
    assert all(s > 0 for s in seconds.values())
    assert all(len(ts) == autotune.WINDOWS for ts in autotune.LAST_PROBE["windows"].values())
    assert autotune.LAST_PROBE["key"].startswith("gpu/b2s1024h16kv8d128/bfloat16/")
    assert autotune.autotune_blocks(2, 1024, 16, 8, 128, dtype=torch.bfloat16,
                                    has_segments=True, cache_path=cache, grid=grid) == picked
    assert reg.flat()["kernel_autotune_cache_hits_total"] == 1
    assert reg.flat()["kernel_autotune_cache_misses_total"] == 1


@pytest.mark.cuda
def test_gloo_all_reduce_of_cuda_tensors(tmp_path):
    """Two gloo ranks sharing the card reduce CUDA tensors in place (the
    dp_step's transport when one card holds both ranks)."""
    _need_card()
    import multiprocessing as mp
    import pickle

    import _torch_rank_worker

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_torch_rank_worker.cuda_reduce_rank,
                         args=(r, 2, str(tmp_path / "pg"), str(tmp_path / f"{r}.pkl")))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        with open(tmp_path / f"{r}.pkl", "rb") as f:
            seen = pickle.load(f)
        for dtype in ("torch.float32", "torch.bfloat16"):
            assert seen[dtype] == ("cuda", 3.0, 3.0)
        assert seen["gather"] == [[0, 1], [1, 2]]


@pytest.mark.cuda
def test_dp_step_world1_over_nccl_matches_train_step(tmp_path):
    """dp_step at world 1 over NCCL on the smoke model in fp32 equals the
    single-process train step (loss, grad_norm, parameters); the
    TorchProcessCollective gathers on the card."""
    _need_card()
    import torch.distributed as dist

    from repro_torch.core.comm import TorchProcessCollective
    from repro_torch.models.model import shift_labels
    from repro_torch.train.trainer import dp_step

    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), attn_impl="flash")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)).cuda()
    mask = torch.ones(2, 256, device="cuda")
    mask[1, 100:] = 0
    labels, mask = shift_labels(tokens, mask)
    batch = {"tokens": tokens, "labels": labels, "loss_mask": mask}
    opt_cfg = OptimizerConfig()
    runs = []
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        gathered = TorchProcessCollective(1).all_gather(0, [3, 4])
        assert [g.tolist() for g in gathered] == [[3, 4]]
        for make in ("train_step", "dp_step"):
            model = LM(cfg, device="cuda")
            params = model.init(torch.Generator(device="cuda").manual_seed(0))
            state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
            if make == "dp_step":
                step, init_err = dp_step(model, opt_cfg)
                state, metrics, _ = step(state, batch, init_err(params))
            else:
                state, metrics = make_train_step(model, opt_cfg)(state, batch)
            runs.append((metrics, tree_leaves(state["params"])))
    finally:
        dist.destroy_process_group()
    (m_ref, p_ref), (m_dp, p_dp) = runs
    for key in ("loss", "grad_norm"):
        assert float(m_dp[key]) == pytest.approx(float(m_ref[key]), rel=2e-5, abs=2e-5)
    for a, b in zip(p_dp, p_ref):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)
