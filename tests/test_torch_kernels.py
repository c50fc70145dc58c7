"""The port's flash-attention kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their plain version (kernels/ref.py);
the JAX kernels run in interpret mode, as tests/test_kernels.py runs them.
Both sides get the same inputs, made with numpy from a seed.  Tolerances are
``_tol``: fp32 2e-5, bf16 2e-2.  The CUDA kernels themselves are held
against the plain version on the card by tests/test_torch_cuda.py.
"""

import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (
    segment_flash_attention as jax_dense,
    segment_flash_attention_bwd as jax_bwd,
    segment_flash_attention_pruned as jax_pruned,
    select_block as jax_select_block,
)
from repro.kernels.liveness import build_liveness_tables as jax_tables
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.liveness import build_liveness_tables
from repro_torch.kernels.ops import flash_attention, resolve_grid
from repro_torch.kernels.ref import NEG_INF, segment_flash_attention_ref
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype: str) -> dict:
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=2e-5, rtol=2e-5)


def packed_segments(rng, b: int, s: int, max_segs: int = 4) -> np.ndarray:
    """Nondecreasing segment ids per row with a padding tail; the last row of
    a batch of 3 or more is all padding."""
    seg = np.zeros((b, s), np.int32)
    for i in range(b if b < 3 else b - 1):
        end = s - int(rng.integers(0, s // 4))
        cuts = np.sort(rng.choice(np.arange(1, end), size=max_segs - 1, replace=False))
        bounds = [0, *cuts.tolist(), end]
        for j in range(len(bounds) - 1):
            seg[i, bounds[j] : bounds[j + 1]] = j + 1
    return seg


def make_inputs(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    return q, k, v, packed_segments(rng, b, s)


def _to_torch(a, dtype="float32", device="cpu"):
    t = torch.from_numpy(np.asarray(a))
    return t.to(device, TORCH_DTYPES[dtype]) if t.is_floating_point() else t.to(device)


def _to_np(t) -> np.ndarray:
    return t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


# (B, S, H, KV, D, block_q, block_kv)
SWEEP = [
    (1, 64, 2, 1, 16, 64, 64),
    (2, 128, 4, 2, 32, 64, 32),
    (3, 128, 4, 4, 16, 128, 64),  # MHA, one all-padding row
    (3, 96, 8, 2, 16, 32, 96),  # S not a power of two
]


class TestAgainstPallas:
    @pytest.mark.parametrize("shape", SWEEP)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("grid", ["dense", "pruned"])
    def test_ops_vs_jax_kernel(self, shape, dtype, grid):
        b, s, h, kv, d, bq, bk = shape
        q, k, v, seg = make_inputs(0, b, s, h, kv, d)
        jt = JAX_DTYPES[dtype]
        jfn = jax_pruned if grid == "pruned" else jax_dense
        ref = jfn(
            jnp.asarray(q, jt), jnp.asarray(k, jt), jnp.asarray(v, jt), jnp.asarray(seg),
            block_q=bq, block_kv=bk, interpret=True,
        )
        out = flash_attention(
            _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype), _to_torch(seg),
            True, bq, bk, grid,
        )
        assert out.dtype == TORCH_DTYPES[dtype] and out.shape == q.shape
        # Rows with no visible key are 0 on both sides (the kernels' contract).
        np.testing.assert_allclose(_to_np(out), np.asarray(ref, np.float32), **_tol(dtype))

    @pytest.mark.parametrize("shape", SWEEP[:3])
    @pytest.mark.parametrize("causal", [True, False])
    def test_lse_vs_jax_kernel(self, shape, causal):
        b, s, h, kv, d, bq, bk = shape
        q, k, v, seg = make_inputs(1, b, s, h, kv, d)
        ref_out, ref_lse = jax_dense(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
            causal=causal, block_q=bq, block_kv=bk, interpret=True, return_residuals=True,
        )
        for wrapper in (fa.segment_flash_attention, fa.segment_flash_attention_pruned):
            out, lse = wrapper(
                _to_torch(q), _to_torch(k), _to_torch(v), _to_torch(seg),
                causal=causal, block_q=bq, block_kv=bk, return_lse=True,
            )
            assert lse.dtype == torch.float32 and lse.shape == (b, s, h)
            np.testing.assert_allclose(_to_np(out), np.asarray(ref_out), **_tol("float32"))
            np.testing.assert_allclose(_to_np(lse), np.asarray(ref_lse), **_tol("float32"))
        assert np.all(np.asarray(ref_lse)[seg == 0] == np.float32(NEG_INF))

    def test_no_segments_vs_jax_kernel(self):
        q, k, v, _ = make_inputs(2, 2, 128, 4, 2, 32)
        ref = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                        block_q=64, block_kv=64, interpret=True)
        out = flash_attention(_to_torch(q), _to_torch(k), _to_torch(v), None, True, 64, 64)
        np.testing.assert_allclose(_to_np(out), np.asarray(ref), **_tol("float32"))


class TestBlocksAndTables:
    def test_select_block_equals_jax(self):
        for s in range(1, 400):
            for requested in (8, 15, 32, 64, 100, 128, 256):
                assert fa.select_block(s, requested) == jax_select_block(s, requested)

    @pytest.mark.parametrize("shape", [(3, 256, 64, 64), (3, 256, 128, 32), (2, 200, 40, 40),
                                       (4, 128, 128, 128), (2, 64, 32, 64)])
    @pytest.mark.parametrize("causal", [True, False])
    def test_liveness_tables_equal_jax(self, shape, causal):
        b, s, bq, bk = shape
        seg = packed_segments(np.random.default_rng(3), b, s)
        ours = build_liveness_tables(_to_torch(seg), block_q=bq, block_kv=bk, causal=causal)
        theirs = jax_tables(jnp.asarray(seg), block_q=bq, block_kv=bk, causal=causal)
        for a, b_ in zip(ours, theirs):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(_to_np(a), np.asarray(b_))

    def test_resolve_grid_matrix(self):
        seg = torch.ones((1, 8), dtype=torch.int32)
        assert resolve_grid("pruned", None) == "dense"  # nothing to prune
        assert resolve_grid("dense", seg) == "dense"
        assert resolve_grid("pruned", seg) == "pruned"
        assert resolve_grid(None, None) == "dense"
        assert resolve_grid("auto", seg) == "dense"  # CPU tensors
        on_card = types.SimpleNamespace(device=torch.device("cuda", 0))  # no card here
        assert resolve_grid("auto", on_card) == "pruned"
        with pytest.raises(ValueError, match="grid"):
            resolve_grid("sparse", seg)

    def test_unresolved_blocks_rejected(self):
        q, k, v, seg = make_inputs(4, 1, 120, 2, 1, 16)
        with pytest.raises(ValueError, match="not resolved"):
            fa.segment_flash_attention(
                _to_torch(q), _to_torch(k), _to_torch(v), _to_torch(seg), block_q=15, block_kv=8
            )

    def test_cpu_tensors_take_the_plain_version(self):
        fa.reset_launches()
        q, k, v, seg = make_inputs(5, 1, 64, 2, 1, 16)
        out = flash_attention(_to_torch(q), _to_torch(k), _to_torch(v), _to_torch(seg),
                              True, 64, 64, "pruned")
        ref = segment_flash_attention_ref(_to_torch(q), _to_torch(k), _to_torch(v), _to_torch(seg))
        assert torch.equal(out, ref)
        assert fa.LAUNCHES == dict.fromkeys(fa.LAUNCHES, 0) and len(fa.LAUNCHES) == 6


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bwd_p_ds(q, k, v, seg, out, lse, do, scale):
    """The backward's recompute as the bf16 tensor-core kernels do it, in
    fp32 from the bf16 inputs: P = exp(scale·QKᵀ − lse) under the mask (0
    elsewhere) and scale·dS = scale·P∘(dO·Vᵀ − delta), both (B, KV, G, Sq,
    Sk), with q and do grouped as (B, S, KV, G, D)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.float().reshape(b, s, kv, g, d)
    dog = do.float().reshape(b, s, kv, g, d)

    def per_q_row(x):  # (B, S, H) -> (B, KV, G, S, 1)
        return x.float().reshape(b, s, kv, g).permute(0, 2, 3, 1)[..., None]

    pos = torch.arange(s)
    allowed = (pos[None, None, :] <= pos[None, :, None]) & (seg[:, :, None] == seg[:, None, :]) & (
        seg[:, None, :] > 0
    )
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    p = torch.where(allowed[:, None, None], torch.exp(scores - per_q_row(lse)), 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - per_q_row((do.float() * out.float()).sum(-1))) * scale
    return qg, dog, p, ds


def _bwd_bf16_dkv_model(q, k, v, seg, out, lse, do, scale, split_ds=True):
    """dK and dV as the bf16 tensor-core kernel rounds them: P rounded to
    bf16 before dV = Σ Pᵀ·dO, and scale·dS as the sum of two bf16 terms
    (hi = rn(x), lo = rn(x − hi); one term with ``split_ds=False``) before
    dK = Σ (scale·dS)ᵀ·Q; fp32 sums, stored in bf16."""
    qg, dog, p, ds = _bwd_p_ds(q, k, v, seg, out, lse, do, scale)
    ds_hi = _bf16(ds)
    ds_used = ds_hi + _bf16(ds - ds_hi) if split_ds else ds_hi
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds_used, qg)
    dv = torch.einsum("bkgqs,bqkgd->bskd", _bf16(p), dog)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _bwd_bf16_dq_model(q, k, v, seg, out, lse, do, scale):
    """dQ as the bf16 tensor-core kernel rounds it: scale·dS rounded to one
    bf16 term before dQ = Σ (scale·dS)·K; fp32 sums, stored in bf16."""
    _, _, _, ds = _bwd_p_ds(q, k, v, seg, out, lse, do, scale)
    dq = torch.einsum("bkgqs,bskd->bqkgd", _bf16(ds), k.float())
    return dq.reshape(q.shape).to(torch.bfloat16)


def _jax_bwd_case(shape, q_scale):
    """One bf16 case: the models' arguments (torch tensors, with the JAX
    forward's out and lse), the JAX backward's (dq, dk, dv) in interpret
    mode, and the segment ids."""
    b, s, h, kv, d, bq, bk = shape
    q, k, v, seg = make_inputs(6, b, s, h, kv, d)
    q = q * np.float32(q_scale)
    do = np.random.default_rng(7).standard_normal(q.shape, dtype=np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    jseg = jnp.asarray(seg)
    out, lse = jax_dense(jq, jk, jv, jseg, block_q=bq, block_kv=bk, interpret=True,
                         return_residuals=True)
    grads = jax_bwd(jq, jk, jv, jseg, out, lse, jdo, block_q=bq, block_kv=bk, interpret=True)
    args = (
        _to_torch(q, "bfloat16"), _to_torch(k, "bfloat16"), _to_torch(v, "bfloat16"),
        _to_torch(seg), _to_torch(np.asarray(out, np.float32), "bfloat16"),
        _to_torch(np.array(lse)), _to_torch(do, "bfloat16"), 1.0 / d**0.5,
    )
    return args, tuple(np.asarray(grad, np.float32) for grad in grads), seg


PEAKED_D64 = (2, 256, 8, 2, 64, 128, 128)  # q x 4: one bf16 term of scale·dS is not enough here


class TestBf16DkvRounding:
    """The bf16 dK/dV kernel rounds P to bf16 and splits scale·dS into two
    bf16 terms before its second products (the JAX kernel keeps both in
    fp32).  This model of that rounding stays within the bf16 tolerance of
    the JAX backward (interpret mode, bf16 inputs), also where the softmax is
    peaked (q × 4: P near one-hot, large dS terms that cancel in dK)."""

    @pytest.mark.parametrize("shape,q_scale", [
        ((2, 128, 4, 2, 32, 64, 64), 1.0),
        ((3, 96, 8, 2, 16, 32, 96), 1.0),
        ((2, 128, 4, 2, 32, 64, 64), 4.0),
        (PEAKED_D64, 4.0),
    ], ids=["2x128", "3x96-group4", "2x128-peaked", "2x256-d64-peaked"])
    def test_rounding_model_vs_jax_bwd(self, shape, q_scale):
        args, (_, *theirs), seg = _jax_bwd_case(shape, q_scale)
        dk, dv = _bwd_bf16_dkv_model(*args)
        for ours, ref in zip((dk, dv), theirs):
            assert ours.dtype == torch.bfloat16
            np.testing.assert_allclose(_to_np(ours), ref, **_tol("bfloat16"))
        assert np.all(_to_np(dk)[seg == 0] == 0) and np.all(_to_np(dv)[seg == 0] == 0)

    def test_one_bf16_term_of_ds_misses_the_tolerance(self):
        """Why the kernel splits scale·dS: rounded once to bf16, dK leaves
        the tolerance on the peaked case that the split model meets."""
        args, (_, ref, _), _ = _jax_bwd_case(PEAKED_D64, 4.0)
        dk, _ = _bwd_bf16_dkv_model(*args, split_ds=False)
        tol = _tol("bfloat16")
        excess = np.abs(_to_np(dk) - ref) / (tol["atol"] + tol["rtol"] * np.abs(ref))
        assert excess.max() > 1.0


class TestBf16DqRounding:
    """The bf16 dQ kernels (K2, K5) round scale·dS to one bf16 term before
    dQ = Σ (scale·dS)·K (the JAX kernel keeps it in fp32).  This model of
    that rounding stays within the bf16 tolerance of the JAX dQ (interpret
    mode, bf16 inputs) on the dK/dV model's cases, the peaked d_head-64 one
    that needs two terms for dK among them, and at d_head 128 over rows of
    up to 512 keys."""

    @pytest.mark.parametrize("shape,q_scale", [
        ((2, 128, 4, 2, 32, 64, 64), 1.0),
        ((3, 96, 8, 2, 16, 32, 96), 1.0),
        ((2, 128, 4, 2, 32, 64, 64), 4.0),
        (PEAKED_D64, 4.0),
        ((1, 512, 4, 2, 128, 128, 128), 1.0),
    ], ids=["2x128", "3x96-group4", "2x128-peaked", "2x256-d64-peaked", "1x512-d128"])
    def test_rounding_model_vs_jax_bwd(self, shape, q_scale):
        args, (ref, _, _), seg = _jax_bwd_case(shape, q_scale)
        dq = _bwd_bf16_dq_model(*args)
        assert dq.dtype == torch.bfloat16
        np.testing.assert_allclose(_to_np(dq), ref, **_tol("bfloat16"))
        assert np.all(_to_np(dq)[seg == 0] == 0)


def _fwd_bf16_model(q, k, v, seg, scale):
    """The forward as the bf16 tensor-core kernel rounds it: fp32 scores from
    the bf16 inputs (the scale applied in fp32), the fp32 softmax statistics
    with l summed from the fp32 P, P rounded to bf16 before P·V, fp32 sums,
    out stored in bf16.  Returns (out, lse = m + log(l) in fp32)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, d)
    pos = torch.arange(s)
    allowed = ((pos[None, None, :] <= pos[None, :, None]) & (seg[:, :, None] == seg[:, None, :])
               & (seg[:, None, :] > 0))[:, None, None]
    scores = torch.where(allowed, torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(scores - torch.where(m <= NEG_INF, 0.0, m)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bkgqs,bskd->bqkgd", p.to(torch.bfloat16).float(), v.float())
    out = (acc / denom.permute(0, 3, 1, 2, 4)).reshape(b, s, h, d).to(torch.bfloat16)
    lse = torch.where(l > 0.0, m + torch.log(denom), NEG_INF)[..., 0]
    return out, lse.permute(0, 3, 1, 2).reshape(b, s, h)


class TestBf16FwdRounding:
    """The bf16 forward kernels (K1, K4) round P to bf16 before P·V (the JAX
    kernel keeps P in fp32) and sum l from the fp32 P.  This model of that
    rounding stays within the bf16 tolerance of the JAX forward (interpret
    mode, bf16 inputs) on the output and within the fp32 tolerance on lse,
    also where the softmax is peaked (q × 4) and over a GQA group of 4."""

    @pytest.mark.parametrize("grid", ["dense", "pruned"])
    @pytest.mark.parametrize("shape,q_scale", [
        ((2, 128, 4, 2, 32, 64, 64), 1.0),
        ((3, 96, 8, 2, 16, 32, 96), 1.0),  # a GQA group of 4, one all-padding row
        ((2, 128, 4, 2, 32, 64, 64), 4.0),
        ((2, 256, 8, 2, 64, 128, 128), 4.0),
    ], ids=["2x128", "3x96-group4", "2x128-peaked", "2x256-d64-peaked"])
    def test_rounding_model_vs_jax_fwd(self, shape, q_scale, grid):
        b, s, h, kv, d, bq, bk = shape
        q, k, v, seg = make_inputs(8, b, s, h, kv, d)
        q = q * np.float32(q_scale)
        jfn = jax_pruned if grid == "pruned" else jax_dense
        ref_out, ref_lse = jfn(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(seg),
            block_q=bq, block_kv=bk, interpret=True, return_residuals=True,
        )
        out, lse = _fwd_bf16_model(_to_torch(q, "bfloat16"), _to_torch(k, "bfloat16"),
                                   _to_torch(v, "bfloat16"), _to_torch(seg), 1.0 / d**0.5)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        np.testing.assert_allclose(_to_np(out), np.asarray(ref_out, np.float32), **_tol("bfloat16"))
        np.testing.assert_allclose(_to_np(lse), np.asarray(ref_lse), **_tol("float32"))
        assert np.all(_to_np(out)[seg == 0] == 0)
        assert np.all(_to_np(lse)[seg == 0] == np.float32(NEG_INF))


class TestBuild:
    def test_library_path_hashes_the_shared_headers(self, tmp_path, monkeypatch):
        """An edited or added header under csrc/ gives every library a new
        path, so a stale build is never loaded."""
        csrc = tmp_path / "csrc"
        shutil.copytree(build.CSRC, csrc)
        monkeypatch.setattr(build, "CSRC", csrc)
        before = {name: build.library_path(name) for name in build.SOURCES}
        assert before == {name: build.library_path(name) for name in build.SOURCES}
        header = csrc / "tc_common.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
        edited = {name: build.library_path(name) for name in build.SOURCES}
        assert all(edited[name] != before[name] for name in build.SOURCES)
        (csrc / "extra.cuh").write_text("#pragma once\n")
        added = {name: build.library_path(name) for name in build.SOURCES}
        assert all(added[name] != edited[name] for name in build.SOURCES)

    def test_ptxas_spills_reads_each_function(self):
        log = (
            "ptxas info    : 0 bytes gmem\n"
            "ptxas info    : Compiling entry function '_ZN2tc19flash_fwd_tc_kernelILb1EEEvPKi' for 'sm_90a'\n"
            "ptxas info    : Function properties for _ZN2tc19flash_fwd_tc_kernelILb1EEEvPKi\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 168 registers, used 1 barriers, 464 bytes cmem[0]\n"
            "ptxas info    : Compiling entry function '_Z16flash_fwd_kernelIfLb0EEvPKT_' for 'sm_90a'\n"
            "ptxas info    : Function properties for _Z16flash_fwd_kernelIfLb0EEvPKT_\n"
            "    16 bytes stack frame, 24 bytes spill stores, 20 bytes spill loads\n"
        )
        assert build.ptxas_spills(log) == {
            "_ZN2tc19flash_fwd_tc_kernelILb1EEEvPKi": 0, "_Z16flash_fwd_kernelIfLb0EEvPKT_": 44,
        }
