"""DeepSeek-V3 in the port against the JAX package, on the CPU: MLA (the
direct form of training and prefill, the absorbed decode over the latent
cache), the dense-layer prefix and the MoE with a shared expert.

The smoke config (fp32; 1 dense prefix layer, 2 MoE layers of 8 experts
top-2 and one shared expert) with weights from the JAX ``LM.init`` (seed 0)
through ``bridge.params_from_jax``; inputs are made with numpy from a seed.
Tolerances are ``tests/test_kernels.py::_tol``'s: fp32 2e-5, bf16 2e-2.
On the CPU "auto" takes the plain path in both packages (the JAX package
has no MLA kernel; the port's run on the card), so every route here is the
plain one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.models import attention as jax_attention
from repro_torch.bridge import jax_layout, params_from_jax, params_to_jax
from repro_torch.configs import get_smoke_config
from repro_torch.models import LM, attention
from repro_torch.models.blocks import stack_plan
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer
from test_torch_archs import _assert_trees_close, _batch, _np, _port_grads, _torch_batch
from test_torch_archs_run import three_trainer_steps

ARCH = "deepseek_v3_671b"
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture(scope="module")
def weights():
    """The JAX smoke weights as numpy (one init for the module)."""
    return jax.tree.map(np.asarray, jax.jit(JaxLM(jax_smoke_config(ARCH)).init)(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def pair(weights):
    cfg = get_smoke_config(ARCH)
    model = LM(cfg, device="cpu")
    params = model.load_params(params_from_jax(weights, cfg, "cpu"))
    return JaxLM(jax_smoke_config(ARCH)), model, params


# -- the MLA mixer ---------------------------------------------------------------


def _mixer(weights, dtype: str):
    """Layer 0's MLA weights (the prefix's), as JAX arrays and as tensors."""
    np_mixer = weights["prefix"][0]["sub0"]["mixer"]
    jp = {k: jnp.asarray(v, dtype) for k, v in np_mixer.items()}
    tp = {k: torch.from_numpy(np.array(v)).to(getattr(torch, dtype)) for k, v in np_mixer.items()}
    return jp, tp


def _x(cfg, seed: int, b: int, s: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _positions_segments(rng, b: int, s: int):
    seg = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = [0, *sorted(rng.choice(np.arange(1, s - 8), size=2, replace=False)), s - 5]
        for j, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            seg[i, lo:hi], pos[i, lo:hi] = j + 1, np.arange(hi - lo)
    return pos, seg


def test_mla_params_have_the_jax_shapes():
    cfg = get_smoke_config(ARCH)
    ours = attention.make_attention_params(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    theirs = jax.eval_shape(lambda k: jax_attention.make_attention_params(k, jax_smoke_config(ARCH),
                                                                          jnp.float32),
                            jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in theirs.items()}


@pytest.mark.parametrize("segmented", [True, False], ids=["segments", "no-segments"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_direct_form_matches_jax(weights, dtype, segmented):
    """The train/prefill form at S = 512 (two query blocks of 256), with and
    without packed segments."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jp, tp = _mixer(weights, dtype)
    b, s = 2, 512
    x = _x(cfg, 1, b, s)
    if segmented:
        pos, seg = _positions_segments(np.random.default_rng(2), b, s)
    else:
        pos, seg = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)), None
    theirs, _ = jax.jit(lambda p, xx, pp, sg: jax_attention.mla_attention(p, xx, jcfg, pp, sg))(
        jp, jnp.asarray(x, dtype), jnp.asarray(pos), None if seg is None else jnp.asarray(seg))
    with torch.no_grad():
        ours, cache = attention.mla_attention(
            tp, torch.from_numpy(x).to(getattr(torch, dtype)), cfg, torch.from_numpy(np.array(pos)),
            None if seg is None else torch.from_numpy(seg))
    assert cache is None and ours.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs, np.float32), **TOL[dtype])


def test_mla_gradients_match_jax(weights):
    """The direct form's gradients (blocks recomputed in the backward)."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jp, tp = _mixer(weights, "float32")
    b, s = 2, 512
    x = _x(cfg, 3, b, s)
    pos, seg = _positions_segments(np.random.default_rng(4), b, s)
    ct = np.random.default_rng(5).standard_normal((b, s, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, _ = jax_attention.mla_attention(p, xx, jcfg, jnp.asarray(pos), jnp.asarray(seg))
        return jnp.sum(out * ct)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = attention.mla_attention(leaves, xt, cfg, torch.from_numpy(pos), torch.from_numpy(seg))
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [xt, *leaves.values()])
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx), **TOL["float32"])
    for name, g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(_np(g), np.asarray(jgp[name]), err_msg=name, **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_absorbed_decode_match_jax(weights, dtype):
    """Prefill of 12 tokens into a latent cache of 20, then three one-token
    decode steps (the absorbed form) at a scalar frontier: outputs and
    caches against JAX's.  The port's decode takes the frontier per row
    (``decode_step``'s (B,) lengths) as well as a scalar."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    tdt = getattr(torch, dtype)
    jp, tp = _mixer(weights, dtype)
    b, s, max_len = 2, 12, 20
    x = _x(cfg, 6, b, s + 3)
    pos = np.broadcast_to(np.arange(s + 3, dtype=np.int32), (b, s + 3))
    jcache = jax_attention.init_kv_cache(jcfg, b, max_len, jnp.dtype(dtype))
    tcache = attention.init_kv_cache(cfg, b, max_len, tdt, "cpu")
    assert isinstance(tcache, attention.MLACache)
    assert tuple(tcache.ckv.shape) == (b, max_len, cfg.kv_lora_rank)
    jmla = jax.jit(lambda p, xx, pp, c, i: jax_attention.mla_attention(p, xx, jcfg, pp, None, c, i))
    with torch.no_grad():
        for i, (lo, hi) in enumerate([(0, s), (s, s + 1), (s + 1, s + 2), (s + 2, s + 3)]):
            jout, jcache = jmla(jp, jnp.asarray(x[:, lo:hi], dtype), jnp.asarray(pos[:, lo:hi]), jcache,
                                jnp.array(lo, jnp.int32))
            index = lo if i % 2 == 0 else torch.full((b,), lo, dtype=torch.int32)
            tout, tcache = attention.mla_attention(
                tp, torch.from_numpy(x[:, lo:hi]).to(tdt), cfg, torch.from_numpy(np.array(pos[:, lo:hi])),
                None, tcache, index)
            np.testing.assert_allclose(_np(tout), np.asarray(jout, np.float32), err_msg=f"call {i}",
                                       **TOL[dtype])
            for name in ("ckv", "k_rope"):
                np.testing.assert_allclose(_np(getattr(tcache, name)),
                                           np.asarray(getattr(jcache, name), np.float32),
                                           err_msg=f"call {i} {name}", **TOL[dtype])


def test_mla_absorbed_decode_equals_direct_form(weights):
    """Prefill of 9 tokens and four absorbed decode steps give the direct
    form's output over all 13 at fp32 2e-5, every row at its own frontier
    (rows 0 and 1 decode from depths 9 and 6 in one call: row 1's prefill is
    shorter, its cache past 6 stale)."""
    cfg = get_smoke_config(ARCH)
    _, tp = _mixer(weights, "float32")
    b, total = 2, 13
    x = torch.from_numpy(_x(cfg, 7, b, total))
    pos = torch.arange(total, dtype=torch.int32).expand(b, total)
    with torch.no_grad():
        full, _ = attention.mla_attention(tp, x, cfg, pos)
        cache = attention.init_kv_cache(cfg, b, 16, torch.float32, "cpu")
        _, cache = attention.mla_attention(tp, x[:, :9], cfg, pos[:, :9], None, cache, 0)
        cache.ckv[1, 6:9] = 7.0  # row 1 restarts at depth 6: what lies past it is never read
        cache.k_rope[1, 6:9] = -7.0
        depth = torch.tensor([9, 6], dtype=torch.int32)
        for _ in range(4):
            rows = torch.arange(b)
            xi = x[rows, depth.long()][:, None]
            out, cache = attention.mla_attention(tp, xi, cfg, depth[:, None], None, cache, depth)
            np.testing.assert_allclose(_np(out[:, 0]), _np(full[rows, depth.long()]), **TOL["float32"])
            depth = depth + 1


def test_mla_decode_drops_a_write_past_the_cache():
    """A free slot's frontier at max_len writes nothing (as the GQA decode)."""
    cfg = get_smoke_config(ARCH)
    tp = attention.make_attention_params(torch.Generator().manual_seed(1), cfg, torch.float32, "cpu")
    cache = attention.init_kv_cache(cfg, 2, 4, torch.float32, "cpu")
    x = torch.randn((2, 1, cfg.d_model), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out, cache = attention.mla_attention(tp, x, cfg, torch.tensor([[1], [4]], dtype=torch.int32), None,
                                             cache, torch.tensor([1, 4], dtype=torch.int32))
    assert bool(torch.isfinite(out).all())
    assert bool(cache.ckv[0, 1].abs().sum() > 0) and bool((cache.ckv[1] == 0).all())
    assert bool((cache.k_rope[1] == 0).all())


# -- the model -------------------------------------------------------------------------


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_forward_and_loss_match_jax(weights, pair, packed):
    jmodel, model, params = pair
    batch = _batch(model.cfg, seed=8, s=64, packed=packed)
    jp = jax.tree.map(jnp.asarray, weights)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = model.forward(params, _torch_batch(batch))
        tsum, ttok = model.loss_sums(params, _torch_batch(batch))
    jlogits, (jsum, jtok) = jax.jit(lambda p, b: (jmodel.forward(p, b), jmodel.loss_sums(p, b)))(jp, jbatch)
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), **TOL["float32"])
    assert float(ttok) == float(jtok) > 0
    np.testing.assert_allclose(float(tsum), float(jsum), **TOL["float32"])


def test_grads_of_mean_loss_match_jax(weights, pair):
    """Every gradient, the prefix layer's and the shared expert's included,
    under the trainer's ``remat="full"``."""
    jmodel, model, params = pair
    assert model.cfg.remat == "full"
    batch = _batch(model.cfg, seed=9)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.jit(jax.grad(lambda p: jnp.divide(*jmodel.loss_sums(p, jbatch))))(
        jax.tree.map(jnp.asarray, weights))
    _, _, tgrads = _port_grads(model, params, batch)
    _assert_trees_close(tgrads, jgrads, **TOL["float32"])
    assert "shared" in tgrads["stack"]["sub0"]["moe"] and "mlp" in tgrads["prefix"][0]["sub0"]


def test_prefill_and_decode_steps_match_jax(weights, pair):
    """``LM.prefill`` of 3 prompts of 24 tokens and 4 greedy ``decode_step``s:
    the ids and every step's logits against JAX's."""
    jmodel, model, params = pair
    vocab = model.cfg.vocab_size
    prompts = np.random.default_rng(10).integers(1, vocab, (3, 24)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, weights)
    prefill, decode_step = jax.jit(jmodel.prefill, static_argnums=2), jax.jit(jmodel.decode_step)
    jlogits, jcaches = prefill(jp, jnp.asarray(prompts), 32)
    logits, caches = model.prefill(params, torch.from_numpy(prompts).long(), 32)
    assert all(isinstance(c, attention.MLACache) for c in caches)
    ids, jids = [], []
    for step in range(5):
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), err_msg=f"step {step}", **TOL["float32"])
        tok, jtok = logits[:, -1, :vocab].argmax(-1, keepdim=True), jnp.argmax(jlogits[:, -1, :vocab], -1)[:, None]
        ids.append(tok[:, 0].tolist())
        jids.append(np.asarray(jtok)[:, 0].tolist())
        if step == 4:
            break
        logits, caches = model.decode_step(params, caches, tok, 24 + step)
        jlogits, jcaches = decode_step(jp, jcaches, jtok.astype(jnp.int32), jnp.array(24 + step, jnp.int32))
    assert ids == jids


def test_decode_steps_equal_the_forward(pair):
    """One prompt of 4 tokens and 4 ``decode_step``s give ``forward``'s logits
    on the 8 tokens at positions 3-7 (fp32 2e-5): the absorbed decode
    against the direct form through the whole model.  At most 8 tokens in
    a call: no expert exceeds its capacity of 8, so neither side drops a
    (token, expert) pair."""
    _, model, params = pair
    vocab = model.cfg.vocab_size
    tokens = torch.from_numpy(np.random.default_rng(11).integers(1, vocab, (1, 8))).long()
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})[..., :vocab]
    logits, caches = model.prefill(params, tokens[:, :4], 8)
    steps = [logits]
    for i in range(4, 8):
        logits, caches = model.decode_step(params, caches, tokens[:, i:i + 1], i)
        steps.append(logits)
    np.testing.assert_allclose(_np(torch.cat(steps, dim=1)[..., :vocab]), _np(full[:, 3:8]),
                               **TOL["float32"])


# -- the tree: the prefix list ---------------------------------------------------------


def test_bridge_round_trip_and_checkpoint_keys(weights, pair):
    """JAX tree -> port -> JAX tree exactly, with ``prefix`` a list of
    one-layer units; the checkpoint keys walk it by index."""
    _, model, params = pair
    cfg = model.cfg
    assert stack_plan(cfg).prefix_layers == (0,) and stack_plan(cfg).unit_layers == ((1,), (2,))
    _assert_trees_close(params_to_jax(params, cfg), weights, atol=0, rtol=0)
    assert isinstance(jax_layout(params, cfg)["prefix"], list)
    assert {id(p) for p in model.parameters()} == {id(p) for p in optimizer.tree_leaves(params)}
    keys = [k for k, _ in ckpt._flatten({"params": params}, cfg)]
    assert "params/prefix/0/sub0/mixer/w_dq" in keys and "params/stack/sub0/moe/shared/w_in" in keys


def test_trainer_three_steps_match_jax(weights):
    """Three JAX and port trainer steps on the packed layout (MLA on its
    plain path: ``auto`` resolves to it in both packages)."""
    three_trainer_steps(ARCH, weights)
