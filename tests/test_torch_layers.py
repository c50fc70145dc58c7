"""The port's layers and attention module against the JAX package's.

Same inputs on both sides, made with numpy from a seed; weights of the
attention test come through ``bridge.params_from_jax`` from the JAX
``LM.init``.  fp32, tolerance 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, layers
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = dict(atol=2e-5, rtol=2e-5)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64), dtype=np.float32) * 3.0
    w = rng.standard_normal((64,), dtype=np.float32)
    ours = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(_np(ours), np.asarray(jax_layers.rms_norm(x, w)), **TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16), dtype=np.float32)
    pos = rng.integers(0, 200, size=(2, 9)).astype(np.int32)
    ours = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(
        _np(ours), np.asarray(jax_layers.apply_rope(x, pos, theta)), **TOL
    )


def test_apply_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    p = {
        name: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
        for name, shape in (("w_in", (64, 128)), ("w_gate", (64, 128)), ("w_out", (128, 64)))
    }
    ours = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), "silu", True)
    np.testing.assert_allclose(
        _np(ours), np.asarray(jax_layers.apply_mlp(p, x, "silu", True)), **TOL
    )


@pytest.fixture(scope="module")
def attn_setup():
    jcfg = jax_smoke_config("qwen3_0_6b")
    jparams = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_jax(jparams, get_smoke_config("qwen3_0_6b"), "cpu")
    layer0 = jax.tree.map(lambda a: a[0], jparams["stack"]["sub0"]["mixer"])
    return jcfg, layer0, params["layers"][0]["mixer"]


def _packed_stream(rng, rows, cap, num_slots):
    """Two or three prompts per row, a padding tail; padding → row num_slots."""
    positions = np.zeros((rows, cap), np.int32)
    segments = np.zeros((rows, cap), np.int32)
    dest = np.full((rows, cap), num_slots, np.int32)
    slot = 0
    for r in range(rows):
        cursor = 0
        for seg_id in range(1, 3 + r % 2):
            n = int(rng.integers(3, cap // 3))
            positions[r, cursor:cursor + n] = np.arange(n)
            segments[r, cursor:cursor + n] = seg_id
            dest[r, cursor:cursor + n] = slot
            slot, cursor = slot + 1, cursor + n
    return positions, segments, dest


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_slot_scatter_prefill_matches_jax(attn_setup, impl):
    """Packed prefill: attention output on valid rows and the scattered cache
    (padding writes dropped).  The two routes differ only on all-padding rows
    (uniform average vs 0), which never reach a picked logit, so only valid
    rows are compared."""
    jcfg, jp, tp = attn_setup
    rng = np.random.default_rng(3)
    rows, cap, num_slots, max_len = 2, 32, 6, 40
    positions, segments, dest = _packed_stream(rng, rows, cap, num_slots)
    x = rng.standard_normal((rows, cap, jcfg.d_model), dtype=np.float32)
    cache0 = rng.standard_normal((num_slots, max_len, jcfg.n_kv_heads, jcfg.d_head), dtype=np.float32)
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    tcfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), attn_impl=impl)
    jout, jcache = jax_attention.gqa_attention(
        jp, jnp.asarray(x), jcfg, jnp.asarray(positions), jnp.asarray(segments),
        jax_attention.KVCache(jnp.asarray(cache0), jnp.asarray(-cache0)),
        dest_slot=jnp.asarray(dest),
    )
    tcache = attention.KVCache(torch.from_numpy(cache0.copy()), torch.from_numpy(-cache0))
    tout, tcache = attention.gqa_attention(
        tp, torch.from_numpy(x), tcfg, torch.from_numpy(positions), torch.from_numpy(segments),
        tcache, dest_slot=torch.from_numpy(dest),
    )
    valid = segments > 0
    np.testing.assert_allclose(_np(tout)[valid], np.asarray(jout)[valid], **TOL)
    np.testing.assert_allclose(_np(tcache.k), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(_np(tcache.v), np.asarray(jcache.v), **TOL)


def test_slot_decode_matches_jax(attn_setup):
    """Per-slot decode, including a free slot whose stale frontier equals
    max_len: its write is dropped on both sides."""
    jcfg, jp, tp = attn_setup
    rng = np.random.default_rng(4)
    b, max_len = 4, 24
    lengths = np.array([0, 5, 23, 24], np.int32)
    x = rng.standard_normal((b, 1, jcfg.d_model), dtype=np.float32)
    k0 = rng.standard_normal((b, max_len, jcfg.n_kv_heads, jcfg.d_head), dtype=np.float32)
    v0 = rng.standard_normal(k0.shape, dtype=np.float32)
    positions = lengths[:, None]
    jout, jcache = jax_attention.gqa_attention(
        jp, jnp.asarray(x), jcfg, jnp.asarray(positions), None,
        jax_attention.KVCache(jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(lengths),
    )
    tcfg = get_smoke_config("qwen3_0_6b")
    tout, tcache = attention.gqa_attention(
        tp, torch.from_numpy(x), tcfg, torch.from_numpy(positions), None,
        attention.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())),
        torch.from_numpy(lengths),
    )
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(tcache.k), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(_np(tcache.v), np.asarray(jcache.v), **TOL)
    np.testing.assert_array_equal(_np(tcache.k)[3], k0[3])  # dropped write
