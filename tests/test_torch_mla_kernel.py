"""MLA's segment flash attention (``kernels/mla_attention.py``,
``csrc/mla_attention.cu``): its plain version against the model's plain
blockwise path and the flash kernels' plain version on the CPU, the route
that takes it, and the kernels against the plain version on the card.

The CPU cases run everywhere; the card cases are marked ``cuda`` and skip
themselves where no CUDA device is present (the kernels have no CPU mode).
The file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_mla_kernel.py

Tolerances, each with its reason:

* the plain version against ``_mla_block_sdpa`` and against the flash
  kernels' plain backward, fp32: 2e-5 (relative and absolute), the same
  function with the scores and sums taken in other orders (one 192-column
  product against a nope and a rope product; the heads' rope columns of dK
  summed after, against autograd's sum of the shared key's uses);
* the kernels against the plain version, bf16: out and every gradient at
  2e-2 of (1 + |plain|), the flash kernels' bf16 rail (P rounded to bf16
  before P.V, scale.dS one bf16 term in dQ and two in dK); lse at 2e-5, the
  fp32 rail of the softmax statistics.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import mla_attention as mk
from repro_torch.kernels.ref import segment_flash_attention_bwd_ref, segment_flash_attention_ref
from repro_torch.models import LM, attention
from repro_torch.models.layers import yarn_mscale
from repro_torch.models.model import shift_labels
from repro_torch.train.trainer import resolve_attn_impl
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

FP32_TOL = 2e-5
BF16_TOL = 2e-2
SMOKE = get_smoke_config("deepseek_v2_lite")
# DeepSeek-V2-Lite's scale: 1/sqrt(192) times YaRN's temperature squared.
YARN_SCALE = (128 + 64) ** -0.5 * yarn_mscale(40.0, 0.707) ** 2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _packed(rng, rows: int, cap: int, lengths=None, empty_rows=()):
    """(segments, positions) int32 of packed rows: samples of ``lengths``
    (UltraChat-like lognormal draws when None) until a row is full, a
    padding tail, and rows in ``empty_rows`` all padding."""
    seg = np.zeros((rows, cap), np.int32)
    pos = np.zeros((rows, cap), np.int32)
    for r in range(rows):
        if r in empty_rows:
            continue
        at, sid = 0, 1
        while True:
            n = int(lengths[sid - 1]) if lengths is not None and sid <= len(lengths) else \
                int(np.clip(rng.lognormal(np.log(1196 * cap / 4096) - 0.1, 0.48), 16, cap))
            if at + n > cap - 8:  # leave a padding tail
                n = cap - 8 - at
            if n <= 0:
                break
            seg[r, at:at + n], pos[r, at:at + n] = sid, np.arange(n)
            at, sid = at + n, sid + 1
    return torch.from_numpy(seg), torch.from_numpy(pos)


def _inputs(rng, b, s, h, nope, rope, vdim, dtype, device="cpu"):
    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)

    return draw(b, s, h, nope + rope), draw(b, s, h, nope), draw(b, s, rope), draw(b, s, h, vdim)


def _close(a, b, tol):
    return torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)


# ------------------------------------------------------------------------------
# CPU: the plain version
# ------------------------------------------------------------------------------

CASES = {
    "v2lite-widths": dict(b=2, s=96, h=3, nope=128, rope=64, vdim=128, seed=0),
    "smoke-widths": dict(b=3, s=64, h=4, nope=16, rope=16, vdim=16, seed=1),
    "one-head": dict(b=2, s=80, h=1, nope=32, rope=8, vdim=24, seed=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_block_sdpa(case):
    """The wrapper's plain version (CPU tensors: forward and backward of the
    autograd Function) against the model's plain blockwise path in fp32, on
    packed rows of several segments with a padding tail, at YaRN's scale:
    out on the real rows, and the gradients of q, k_nope, the shared k_rope
    and v.  The cotangent is zero on padding rows, as training gives it
    (their outputs reach no loss); there the blockwise path averages every
    key while the kernels' contract gives 0."""
    c = CASES[case]
    rng = np.random.default_rng(c["seed"])
    seg, pos = _packed(rng, c["b"], c["s"], lengths=[17, 30, 9, 22])
    leaves = [t.requires_grad_() for t in _inputs(rng, c["b"], c["s"], c["h"], c["nope"], c["rope"],
                                                  c["vdim"], torch.float32)]
    q, k_nope, k_rope, v = leaves
    do = torch.from_numpy(rng.standard_normal((c["b"], c["s"], c["h"], c["vdim"])).astype(np.float32))
    do = do * (seg > 0)[..., None, None]

    ours = mk.mla_attention(q, k_nope, k_rope, v, seg, True, YARN_SCALE)
    grads = torch.autograd.grad(ours, leaves, do)
    theirs = attention._mla_block_sdpa(q[..., :c["nope"]], q[..., c["nope"]:], k_nope, k_rope, v,
                                       pos, pos, seg, seg, None, True, YARN_SCALE, q_block=32)
    want = torch.autograd.grad(theirs, leaves, do)
    real = seg > 0
    assert _close(ours[real], theirs[real], FP32_TOL)
    assert bool(torch.all(ours[~real] == 0))
    for name, g, w in zip(("q", "k_nope", "k_rope", "v"), grads, want):
        assert _close(g, w, FP32_TOL), f"d{name}: {(g - w).abs().max().item()}"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_flash_plain(case):
    """The plain backward against the flash kernels' plain version on the
    same function written with per-head keys: k = [k_nope, k_rope repeated
    for each head] and v padded to q's width with zero columns.  dk_rope must
    be the sum over the heads of the per-head keys' rope columns; dq, dk_nope
    and dv, and out and lse from the forward, must agree too."""
    c = CASES[case]
    rng = np.random.default_rng(10 + c["seed"])
    seg, _ = _packed(rng, c["b"], c["s"])
    q, k_nope, k_rope, v = _inputs(rng, c["b"], c["s"], c["h"], c["nope"], c["rope"], c["vdim"],
                                   torch.float32)
    out, lse = mk.mla_attention_fwd(q, k_nope, k_rope, v, seg, causal=True, scale=YARN_SCALE)
    do = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    dq, dk_nope, dk_rope, dv = mk.mla_attention_bwd(q, k_nope, k_rope, v, seg, out, lse, do,
                                                    causal=True, scale=YARN_SCALE)

    width = c["nope"] + c["rope"]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(-1, -1, c["h"], -1)], dim=-1)
    pad = torch.zeros(*v.shape[:3], width - c["vdim"]) if width > c["vdim"] else None
    v_wide = v if pad is None else torch.cat([v, pad], dim=-1)
    f_out, f_lse = segment_flash_attention_ref(q, k, v_wide, seg, True, YARN_SCALE, return_lse=True)
    assert _close(out, f_out[..., :c["vdim"]], FP32_TOL)
    real = seg > 0
    assert _close(lse[real], f_lse[real], FP32_TOL)
    assert bool(torch.all(lse[~real] == mk.NEG_INF))
    do_wide = do if pad is None else torch.cat([do, pad], dim=-1)
    out_wide = out if pad is None else torch.cat([out, pad], dim=-1)
    f_dq, f_dk, f_dv = segment_flash_attention_bwd_ref(q, k, v_wide, seg, out_wide, lse, do_wide, True,
                                                       YARN_SCALE)
    assert _close(dq, f_dq, FP32_TOL)
    assert _close(dk_nope, f_dk[..., :c["nope"]], FP32_TOL)
    assert _close(dk_rope, f_dk[..., c["nope"]:].sum(dim=2), FP32_TOL)
    assert _close(dv, f_dv[..., :c["vdim"]], FP32_TOL)


def test_empty_rows_give_zero():
    """A row of padding alone: out 0, lse NEG_INF, zero gradients."""
    rng = np.random.default_rng(3)
    seg, _ = _packed(rng, 2, 64, empty_rows=(1,))
    q, k_nope, k_rope, v = _inputs(rng, 2, 64, 2, 16, 8, 16, torch.float32)
    out, lse = mk.mla_attention_fwd(q, k_nope, k_rope, v, seg, scale=YARN_SCALE)
    do = torch.ones_like(out)
    grads = mk.mla_attention_bwd(q, k_nope, k_rope, v, seg, out, lse, do, scale=YARN_SCALE)
    assert bool(torch.all(out[1] == 0)) and bool(torch.all(lse[1] == mk.NEG_INF))
    assert all(bool(torch.all(g[1] == 0)) for g in grads)


@pytest.mark.parametrize("fault", ["fp32", "widths", "strided", "no-segments", "int64-segments", "shapes"])
def test_inputs_the_kernels_refuse(fault):
    """What the kernels do not take raises before any launch: the checks
    run on CPU tensors as they would on the card's."""
    rng = np.random.default_rng(4)
    seg, _ = _packed(rng, 1, 64)
    q, k_nope, k_rope, v = _inputs(rng, 1, 64, 2, 128, 64, 128, torch.bfloat16)
    if fault == "fp32":
        with pytest.raises(TypeError, match="bfloat16"):
            mk.check_kernel_inputs(q.float(), k_nope.float(), k_rope.float(), v.float())
    elif fault == "widths":
        with pytest.raises(ValueError, match="widths"):
            mk.check_kernel_inputs(q[..., :96].contiguous(), k_nope[..., :64].contiguous(), k_rope[..., :32]
                                   .contiguous(), v)
    elif fault == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            mk.check_kernel_inputs(q, k_nope, k_rope, v.transpose(1, 2).contiguous().transpose(1, 2))
    elif fault == "no-segments":
        with pytest.raises(ValueError, match="segment_ids"):
            mk.mla_attention_fwd(q, k_nope, k_rope, v, None)
    elif fault == "int64-segments":
        with pytest.raises(ValueError, match="segment_ids"):
            mk.mla_attention_fwd(q, k_nope, k_rope, v, seg.long())
    else:
        with pytest.raises(ValueError, match="bad shapes"):
            mk.mla_attention_fwd(q, k_nope[:, :32], k_rope, v, seg)


# ------------------------------------------------------------------------------
# CPU: the route
# ------------------------------------------------------------------------------


ROUTE_CONFIGS = {"gqa": get_smoke_config("qwen3_0_6b"), "mla": SMOKE}


@pytest.mark.parametrize("kind", list(ROUTE_CONFIGS))
def test_use_flash_attention_rule(kind):
    """One rule for both attention kinds: the kernels exactly for the
    cache-free packed call on a CUDA device under "auto"; "xla", a cache
    (prefill or decode), CPU segments and a dense batch keep the plain path;
    "flash" takes the kernels (their plain versions on CPU tensors) wherever
    there is no cache.  The device is read from the segments."""
    cfg = ROUTE_CONFIGS[kind]
    auto = dataclasses.replace(cfg, attn_impl="auto")
    xla, flash = (dataclasses.replace(cfg, attn_impl=impl) for impl in ("xla", "flash"))
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    on_cpu = torch.zeros((1, 8), dtype=torch.int32)
    assert attention.use_flash_attention(auto, on_card, None)
    assert not attention.use_flash_attention(xla, on_card, None)
    assert not attention.use_flash_attention(auto, on_card, object())  # a cache: prefill or decode
    assert not attention.use_flash_attention(flash, on_card, object())
    assert not attention.use_flash_attention(auto, on_cpu, None)
    assert not attention.use_flash_attention(auto, None, None)
    assert attention.use_flash_attention(flash, on_cpu, None)
    assert attention.use_flash_attention(flash, None, None)


def test_resolve_attn_impl_keeps_auto_for_mla():
    """The trainer's pin is one rule for both attention kinds: "flash"
    exactly where the kernels run (packed, CUDA), else "xla"; "xla" for a
    model without attention; an explicit choice is kept; "auto" is never
    returned."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    gqa = get_smoke_config("qwen3_0_6b")
    for cfg in (SMOKE, gqa):
        assert resolve_attn_impl(cfg, packed=True, device=cuda) == "flash"
        assert resolve_attn_impl(cfg, packed=False, device=cuda) == "xla"
        assert resolve_attn_impl(cfg, packed=True, device=cpu) == "xla"
        for impl in ("xla", "flash"):
            pinned = dataclasses.replace(cfg, attn_impl=impl)
            assert resolve_attn_impl(pinned, packed=True, device=cuda) == impl
            assert resolve_attn_impl(pinned, packed=False, device=cpu) == impl
    assert resolve_attn_impl(get_smoke_config("mamba2_130m"), packed=True, device=cuda) == "xla"  # no attention


def test_flash_mla_model_takes_the_plain_version_on_cpu(monkeypatch):
    """``LM`` takes ``attn_impl="flash"`` for MLA: on CPU tensors every
    layer runs the kernels' plain version (``mla_attention_ref``), launches
    nothing, and ``LM.forward`` equals the "xla" route's (``_mla_block_sdpa``)
    at fp32's 2e-5 on rows packed without padding."""
    obs.default_registry().reset()
    mk.reset_launches()
    rng = np.random.default_rng(6)
    b, s = 2, 32
    seg = torch.from_numpy(np.repeat(np.array([[1] * 10 + [2] * 12 + [3] * 10]), b, axis=0).astype(np.int32))
    pos = torch.from_numpy(np.concatenate([np.arange(10), np.arange(12), np.arange(10)])[None].repeat(b, 0)
                           .astype(np.int32))
    batch = dict(tokens=torch.from_numpy(rng.integers(1, SMOKE.vocab_size, (b, s))), positions=pos, segments=seg)
    logits = {}
    for impl in ("xla", "flash"):
        model = LM(dataclasses.replace(SMOKE, attn_impl=impl), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        calls = []
        plain = mk.mla_attention_ref
        monkeypatch.setattr(mk, "mla_attention_ref", lambda *a, **k: calls.append(1) or plain(*a, **k))
        with torch.no_grad():
            logits[impl] = model.forward(params, batch)
        monkeypatch.setattr(mk, "mla_attention_ref", plain)
        assert len(calls) == (SMOKE.n_layers if impl == "flash" else 0)
    assert all(n == 0 for n in mk.LAUNCHES.values())
    assert "kernel_mla_launches_total" not in obs.default_registry().flat()
    assert _close(logits["flash"], logits["xla"], FP32_TOL), (logits["flash"] - logits["xla"]).abs().max().item()


def test_flash_mla_without_segments_raises():
    """An explicit "flash" on a dense MLA batch raises the MLA wrapper's
    segment check: the kernels need segments, and there is no dense MLA
    kernel path."""
    model = LM(dataclasses.replace(SMOKE, attn_impl="flash"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(1, SMOKE.vocab_size, (1, 16)))
    with pytest.raises(ValueError, match=r"segment_ids must be \(B, S\) int32"):
        model.forward(params, dict(tokens=tokens))


@pytest.mark.parametrize("route", ["auto-cpu", "xla", "prefill-cache"])
def test_cpu_calls_stay_on_the_plain_path(route, monkeypatch):
    """CPU tensors under "auto", "xla", and the prefill that fills a cache
    run ``_mla_block_sdpa`` and launch nothing: the counts stay at 0 and the
    registry has no ``kernel_mla_launches_total``."""
    obs.default_registry().reset()
    mk.reset_launches()
    cfg = SMOKE if route != "xla" else dataclasses.replace(SMOKE, attn_impl="xla")
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    layer = params["layers"][0]["mixer"]
    rng = np.random.default_rng(5)
    seg, pos = _packed(rng, 2, 32, lengths=[10, 12])
    x = torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32))
    calls = []
    plain = attention._mla_block_sdpa
    monkeypatch.setattr(attention, "_mla_block_sdpa", lambda *a, **k: calls.append(1) or plain(*a, **k))
    monkeypatch.setattr(mk, "mla_attention", lambda *a, **k: pytest.fail("the kernel route was taken"))
    cache, index = None, None
    if route == "prefill-cache":
        cache, index = attention.init_kv_cache(cfg, 2, 64, torch.float32, "cpu"), 0
    out, _ = attention.mla_attention(layer, x, cfg, pos, seg, cache, index)
    assert out.shape == (2, 32, cfg.d_model) and calls == [1]
    assert all(n == 0 for n in mk.LAUNCHES.values())
    assert "kernel_mla_launches_total" not in obs.default_registry().flat()


# ------------------------------------------------------------------------------
# The card
# ------------------------------------------------------------------------------


def _card_case(s: int, seed: int):
    """bf16 inputs at DeepSeek-V2-Lite's heads (16, qk 192 over v 128) on
    three rows of ``s``: UltraChat-like samples with a padding tail, the same
    again, and a row of padding alone; q scaled up so the softmax peaks."""
    rng = np.random.default_rng(seed)
    seg, _ = _packed(rng, 3, s, empty_rows=(2,))
    q, k_nope, k_rope, v = _inputs(rng, 3, s, 16, 128, 64, 128, torch.float32, "cuda")
    q = (q * 2.0).bfloat16()
    do = torch.from_numpy(rng.standard_normal((3, s, 16, 128)).astype(np.float32)).cuda().bfloat16()
    return seg.cuda(), q, k_nope.bfloat16(), k_rope.bfloat16(), v.bfloat16(), do


@pytest.mark.cuda
@pytest.mark.parametrize("s", [3072, 4096])
def test_kernels_match_plain_on_card(s):
    """The three kernels against the plain version in bf16: out and every
    gradient at 2e-2 of (1 + |plain|) on real rows, lse at 2e-5, exactly
    zero on padding rows; two runs bit for bit; each call counted once a
    kind in ``LAUNCHES`` and ``kernel_mla_launches_total``."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    seg, q, k_nope, k_rope, v, do = _card_case(s, seed=s)
    obs.default_registry().reset()
    mk.reset_launches()
    runs = []
    for _ in range(2):
        out, lse = mk.mla_attention_fwd(q, k_nope, k_rope, v, seg, scale=YARN_SCALE)
        runs.append((out, lse, *mk.mla_attention_bwd(q, k_nope, k_rope, v, seg, out, lse, do, scale=YARN_SCALE)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs)), "two runs differ"
    assert mk.LAUNCHES == {"mla_fwd": 2, "mla_bwd_dq": 2, "mla_bwd_dkv": 2}
    assert obs.default_registry().flat()["kernel_mla_launches_total"] == 6

    out, lse, dq, dk_nope, dk_rope, dv = runs[0]
    p_out, p_lse = mk.mla_attention_ref(q, k_nope, k_rope, v, seg, True, YARN_SCALE)
    plain = mk.mla_attention_bwd_ref(q, k_nope, k_rope, v, seg, out, lse, do, True, YARN_SCALE)
    real = seg > 0
    assert torch.allclose(lse[real], p_lse[real], atol=FP32_TOL, rtol=FP32_TOL)
    assert bool(torch.all(lse[~real] == mk.NEG_INF))
    for name, ours, ref in zip(("out", "dq", "dk_nope", "dk_rope", "dv"), (out, dq, dk_nope, dk_rope, dv),
                               (p_out, *plain)):
        a, b = ours[real].float(), ref[real].float()
        assert torch.allclose(a, b, atol=BF16_TOL, rtol=BF16_TOL), f"{name}: {(a - b).abs().max().item()}"
        assert bool(torch.all(ours[~real] == 0)), f"{name} not zero on padding rows"


def _v2_lite_kernel_widths(layers: int = 2):
    """DeepSeek-V2-Lite's attention widths (16 heads, qk 192 over v 128,
    kv latent 512) in a two-layer bf16 model small elsewhere."""
    return dataclasses.replace(SMOKE, n_layers=layers, d_model=256, n_heads=16, n_kv_heads=16, d_head=128,
                               kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
                               dtype="bfloat16")


@pytest.mark.cuda
def test_training_route_takes_the_kernels_on_card(monkeypatch):
    """A packed loss with its gradients on the card, under remat: every
    layer's attention runs the kernels (2 forwards, the layer's and its
    recompute, one dQ and one dK/dV) and never ``_mla_block_sdpa``; the loss
    and gradients agree with the plain path's ("xla") on the card within
    the bf16 rail."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _v2_lite_kernel_widths()
    rng = np.random.default_rng(7)
    seg, pos = _packed(rng, 2, 1024)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, seg.shape)).cuda()
    labels, mask = shift_labels(tokens, (seg > 0).cuda(), segments=seg.cuda())
    batch = dict(tokens=tokens, positions=pos.cuda(), segments=seg.cuda(), labels=labels, loss_mask=mask)

    def loss_and_grads(impl):
        model = LM(dataclasses.replace(cfg, attn_impl=impl))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        leaves = [p for p in model.parameters() if p.requires_grad]
        loss, count = model.loss_sums(params, batch)
        return loss / count, torch.autograd.grad(loss / count, leaves)

    plain_loss, plain_grads = loss_and_grads("xla")
    obs.default_registry().reset()
    mk.reset_launches()
    monkeypatch.setattr(attention, "_mla_block_sdpa", lambda *a, **k: pytest.fail("the plain path was taken"))
    loss, grads = loss_and_grads("auto")
    torch.cuda.synchronize()
    assert mk.LAUNCHES == {"mla_fwd": 2 * cfg.n_layers, "mla_bwd_dq": cfg.n_layers, "mla_bwd_dkv": cfg.n_layers}
    assert obs.default_registry().flat()["kernel_mla_launches_total"] == 4 * cfg.n_layers
    assert abs(loss.item() - plain_loss.item()) <= BF16_TOL * (1 + abs(plain_loss.item()))
    for g, w in zip(grads, plain_grads):
        scale = w.float().abs().max().item()
        assert torch.isfinite(g.float()).all()
        assert (g.float() - w.float()).abs().max().item() <= BF16_TOL * (1 + scale)
