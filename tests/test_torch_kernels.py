"""The port's flash-attention kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their plain version (kernels/ref.py);
the JAX kernels run in interpret mode, as tests/test_kernels.py runs them.
Both sides get the same inputs, made with numpy from a seed.  Tolerances are
``_tol``: fp32 2e-5, bf16 2e-2.  The CUDA kernels themselves are held
against the plain version on the card by tests/test_torch_cuda.py.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (
    segment_flash_attention as jax_dense,
    segment_flash_attention_pruned as jax_pruned,
    select_block as jax_select_block,
)
from repro.kernels.liveness import build_liveness_tables as jax_tables
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.liveness import build_liveness_tables
from repro_torch.kernels.ops import flash_attention, resolve_grid
from repro_torch.kernels.ref import NEG_INF, segment_flash_attention_ref

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
