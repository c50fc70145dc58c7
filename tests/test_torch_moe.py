"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
single-device branch (``repro.models.moe`` with ``mesh=None``), on the CPU.

Expert weights come from the JAX ``make_moe_params`` with seeded numpy noise
added per expert before either side takes them: the JAX init repeats one
draw over every expert, and with identical experts a wrong dispatch index
would pass unseen.  Capacity factors low enough that (token, expert) pairs
are dropped.  Tolerances of ``tests/test_kernels.py::_tol``: fp32 2e-5, bf16
2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as jax_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _configs(capacity_factor: float, shared: int = 0):
    overrides = dict(capacity_factor=capacity_factor, n_shared_experts=shared)
    return (dataclasses.replace(jax_smoke_config("arctic_480b"), **overrides),
            dataclasses.replace(get_smoke_config("arctic_480b"), **overrides))


def _distinct_params(jcfg, seed: int = 0) -> dict:
    """JAX MoE params (fp32 numpy) with seeded noise on every expert slab,
    and a gated dense residual MLP."""
    params = jax.tree.map(np.asarray, jax_moe.make_moe_params(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for name in ("w_in", "w_gate", "w_out"):
        w = params[name]
        params[name] = (w + rng.standard_normal(w.shape).astype(np.float32) / np.sqrt(w.shape[1]))
    d, ff = jcfg.d_model, jcfg.d_ff
    params["dense"] = {
        "w_in": (rng.standard_normal((d, ff)) / np.sqrt(d)).astype(np.float32),
        "w_gate": (rng.standard_normal((d, ff)) / np.sqrt(d)).astype(np.float32),
        "w_out": (rng.standard_normal((ff, d)) / np.sqrt(ff)).astype(np.float32),
    }
    return params


def _tree(params: dict, fn) -> dict:
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in params.items()}


def _x(cfg, seed: int, b: int = 3, s: int = 40) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def test_router_topk_matches_jax_with_ties():
    """Weights and ids equal JAX's, ties included: two router columns are
    equal, so their experts score alike in every token, and JAX's
    ``lax.top_k`` takes the lower id first."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    w[:, 5] = w[:, 1]
    w[:, 6] = w[:, 1]
    jw, jids = jax_moe.router_topk(x, w, 3)
    tw, tids = moe.router_topk(_t(x), _t(w), 3)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), **TOL["float32"])
    assert tw.dtype == torch.float32
    ties = (np.asarray(jids)[:, :, None] == np.array([1, 5, 6])).any(-1).sum(-1)
    assert (ties >= 2).any()  # tied experts were picked together somewhere


@pytest.mark.parametrize("tokens,top_k,experts,factor", [
    (120, 2, 8, 1.25), (120, 2, 8, 0.3), (7, 1, 16, 1.0), (4096, 2, 128, 1.25), (1, 2, 128, 1.25),
    (8192, 8, 256, 1.0), (3000, 2, 0, 1.25),
])
def test_moe_capacity_matches_jax(tokens, top_k, experts, factor):
    cap = moe.moe_capacity(tokens, top_k, experts, factor)
    assert cap == jax_moe.moe_capacity(tokens, top_k, experts, factor)
    assert cap >= 8 and cap % 8 == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [0.25, 0.6, 1.25])
def test_dispatch_compute_combine_matches_jax(dtype, factor):
    jcfg, cfg = _configs(factor)
    params = _distinct_params(jcfg, seed=1)
    x = _x(cfg, 2).reshape(-1, cfg.d_model)
    jt, tt = jnp.dtype(dtype), getattr(torch, dtype)
    weights, ids = jax_moe.router_topk(x, params["router"], cfg.top_k)
    cap = moe.moe_capacity(x.shape[0], cfg.top_k, cfg.n_experts, factor)
    theirs = jax_moe.dispatch_compute_combine(
        jnp.asarray(x, jt), weights, ids, *(jnp.asarray(params[n], jt) for n in ("w_in", "w_gate", "w_out")),
        e_start=0, capacity=cap, act=cfg.act)
    tw, tids = moe.router_topk(_t(x), _t(params["router"]), cfg.top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    ours = moe.dispatch_compute_combine(
        _t(x, tt), tw, tids, *(_t(params[n], tt) for n in ("w_in", "w_gate", "w_out")),
        capacity=cap, act=cfg.act)
    assert ours.dtype == tt
    np.testing.assert_allclose(_np(ours), np.asarray(theirs, np.float32), **TOL[dtype])
    _, _, keep = moe.dispatch_slots(tids, cfg.n_experts, cap)
    if factor < 1:
        assert int(keep.sum()) < keep.numel()  # pairs were dropped
        dropped = ~keep.reshape(tids.shape).all(dim=1)
        assert not np.allclose(_np(ours)[dropped.numpy()], 0)  # a partly kept token still has output


def test_dispatch_slots_token_major():
    """Slots count each expert's pairs in token-major order; pairs past the
    capacity and experts out of range go to the trash bucket."""
    ids = torch.tensor([[0, 1], [1, 0], [0, 2], [0, 1], [5, 1]])
    dest_e, dest_c, keep = moe.dispatch_slots(ids, n_local=3, capacity=2)
    assert dest_e.tolist() == [0, 1, 1, 0, 3, 2, 3, 3, 3, 3]
    assert dest_c.tolist() == [0, 0, 1, 1, 0, 0, 0, 0, 0, 0]
    assert keep.tolist() == [True, True, True, True, False, True, False, False, False, False]


@pytest.mark.parametrize("shared", [0, 1], ids=["dense-residual", "shared-and-dense-residual"])
def test_moe_ffn_matches_jax(shared):
    """fp32.  (In bf16 the routed sum, the shared expert and the dense
    residual each differ from JAX's by an ulp of their own magnitude, XLA
    and PyTorch rounding bf16 silu and products apart; where the three
    cancel, that exceeds 2e-2 of the small sum.  The routed part is held in
    bf16 by test_dispatch_compute_combine_matches_jax.)"""
    jcfg, cfg = _configs(0.5, shared=shared)
    params = _distinct_params(jcfg, seed=2)
    assert ("shared" in params) == bool(shared)
    dense = params.pop("dense")
    x = _x(cfg, 3)
    theirs = jax_moe.moe_ffn(_tree(params, jnp.asarray), jnp.asarray(x), jcfg,
                             dense_params=_tree(dense, jnp.asarray))
    tparams = _tree(params, _t)
    ours = moe.moe_ffn(tparams, _t(x), cfg, dense_params=_tree(dense, _t))
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), **TOL["float32"])
    _, ids = moe.router_topk(_t(x).reshape(-1, cfg.d_model), tparams["router"], cfg.top_k)
    cap = moe.moe_capacity(ids.shape[0], cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    assert not bool(moe.dispatch_slots(ids, cfg.n_experts, cap)[2].all())  # tokens dropped


def test_moe_ffn_grads_match_jax():
    """Gradients of a weighted sum of the output in x, the router, the
    expert slabs, the shared expert and the dense residual, with pairs
    dropped."""
    jcfg, cfg = _configs(0.5, shared=1)
    params = _distinct_params(jcfg, seed=3)
    x = _x(cfg, 4, b=2, s=32)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jax_loss(p, x_):
        moe_p = {k: v for k, v in p.items() if k != "dense"}
        return jnp.sum(jax_moe.moe_ffn(moe_p, x_, jcfg, dense_params=p["dense"]) * w)

    jgrads, jgx = jax.grad(jax_loss, argnums=(0, 1))(_tree(params, jnp.asarray), jnp.asarray(x))
    tparams = _tree(params, lambda a: _t(a).requires_grad_())
    tx = _t(x).requires_grad_()
    moe_p = {k: v for k, v in tparams.items() if k != "dense"}
    loss = (moe.moe_ffn(moe_p, tx, cfg, dense_params=tparams["dense"]) * _t(w)).sum()
    leaves, paths = [], []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves.append(v)
                paths.append(path + (k,))

    walk(tparams, ())
    grads = torch.autograd.grad(loss, [tx, *leaves])
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx), **TOL["float32"])
    for path, g in zip(paths, grads[1:]):
        ref = jgrads
        for k in path:
            ref = ref[k]
        np.testing.assert_allclose(_np(g), np.asarray(ref), err_msg="/".join(path), **TOL["float32"])


def test_moe_ffn_is_deterministic():
    _, cfg = _configs(0.5, shared=1)
    params = _tree(_distinct_params(_configs(0.5, shared=1)[0], seed=4), _t)
    dense = params.pop("dense")
    x = _t(_x(cfg, 6))
    a = moe.moe_ffn(params, x, cfg, dense_params=dense)
    b = moe.moe_ffn(params, x, cfg, dense_params=dense)
    assert torch.equal(a, b)


def test_make_moe_params_repeats_one_draw():
    """The port's own init: an fp32 router and, as in JAX, one draw repeated
    over the experts (the shapes JAX makes)."""
    jcfg, cfg = _configs(1.25, shared=1)
    ours = moe.make_moe_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16, "cpu")
    theirs = jax.eval_shape(lambda: jax_moe.make_moe_params(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    flat_ours = {k: v for k, v in ours.items() if k != "shared"}
    flat_ours.update({f"shared/{k}": v for k, v in ours["shared"].items()})
    flat_theirs = {k: v for k, v in theirs.items() if k != "shared"}
    flat_theirs.update({f"shared/{k}": v for k, v in theirs["shared"].items()})
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in flat_ours.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in flat_theirs.items()}
    for name in ("w_in", "w_gate", "w_out"):
        assert all(torch.equal(ours[name][0], e) for e in ours[name])
