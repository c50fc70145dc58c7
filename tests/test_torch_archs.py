"""The port's six added architectures against the JAX package, on the CPU.

OLMo-1B (non-parametric LayerNorm), DeepSeek-7B (MHA), Yi-34B (GQA 7:1,
smoke 4:1), Chameleon-34B (``vlm``: qk-norm), HuBERT-XLarge (parametric LN,
tanh GELU, a non-gated MLP, input embeddings, bidirectional attention) and
Arctic-480B (MoE top-2 with a dense residual MLP), at their smoke configs in
fp32.  Weights come from the JAX ``LM.init`` (seed 0) through
``bridge.params_from_jax``; inputs are made with numpy from a seed.  The
tolerance is ``tests/test_kernels.py::_tol``'s fp32 2e-5.  The flash route's
JAX side runs its Pallas kernels in interpret mode; the port's wrappers take
their plain versions on CPU tensors.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.models import layers as jax_layers
from repro.models.blocks import stack_plan as jax_stack_plan
from repro.models.model import shift_labels as jax_shift_labels
from repro_torch.bridge import jax_layout, params_from_jax, params_to_jax
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import LM, layers
from repro_torch.models.blocks import stack_plan
from repro_torch.train import optimizer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

TOL = dict(atol=2e-5, rtol=2e-5)
ARCHS = ("olmo_1b", "deepseek_7b", "yi_34b", "chameleon_34b", "hubert_xlarge", "arctic_480b")


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# -- the new layers --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parametric", [True, False], ids=["ln", "ln_nonparam"])
def test_layer_norm_matches_jax(parametric, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3.0 + 1.5).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32) if parametric else None
    jt, tt = jnp.dtype(dtype), getattr(torch, dtype)
    theirs = jax_layers.layer_norm(jnp.asarray(x, jt), None if w is None else jnp.asarray(w, jt), None)
    ours = layers.layer_norm(torch.from_numpy(x).to(tt), None if w is None else torch.from_numpy(w).to(tt),
                             None)
    assert ours.dtype == tt
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_np(ours), np.asarray(theirs, np.float32), **tol)


@pytest.mark.parametrize("norm", ["rms", "ln", "ln_nonparam"])
def test_apply_norm_matches_jax(norm):
    cfg = dataclasses.replace(get_smoke_config("olmo_1b"), norm=norm)
    jcfg = dataclasses.replace(jax_smoke_config("olmo_1b"), norm=norm)
    params = layers.make_norm_params(cfg, torch.float32, "cpu")
    assert sorted(params) == ([] if norm == "ln_nonparam" else ["scale"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    scale = rng.standard_normal((cfg.d_model,)).astype(np.float32)
    jparams = {"scale": scale} if params else {}
    ours = layers.apply_norm({k: torch.from_numpy(v) for k, v in jparams.items()}, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(ours), np.asarray(jax_layers.apply_norm(jparams, x, jcfg)), **TOL)


def test_gelu_is_jax_tanh_form():
    """``act_fn("gelu")`` is ``jax.nn.gelu`` (the tanh form), within 2e-5
    where the exact erf form is not."""
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    theirs = np.asarray(jax_layers.act_fn("gelu")(x))
    np.testing.assert_allclose(_np(layers.act_fn("gelu")(torch.from_numpy(x))), theirs, **TOL)
    exact = _np(torch.nn.functional.gelu(torch.from_numpy(x)))
    assert np.abs(exact - theirs).max() > 2e-4


def test_non_gated_gelu_mlp_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    p = {"w_in": (rng.standard_normal((64, 128)) / 8).astype(np.float32),
         "w_out": (rng.standard_normal((128, 64)) / 11).astype(np.float32)}
    ours = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                            "gelu", False)
    np.testing.assert_allclose(_np(ours), np.asarray(jax_layers.apply_mlp(p, x, "gelu", False)), **TOL)


# -- the models --------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jax_smoke_config(arch)
            cache[arch] = jax.tree.map(np.asarray, JaxLM(cfg).init(jax.random.PRNGKey(0)))
        return cache[arch]

    return get


def _segments(rng, b: int, s: int) -> np.ndarray:
    """Two to four segments per row and a padding tail."""
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        end = s - int(rng.integers(1, s // 4))
        cuts = np.sort(rng.choice(np.arange(1, end), size=1 + i % 3, replace=False))
        for j, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, end])):
            seg[i, lo:hi] = j + 1
    return seg


def _batch(cfg, seed: int, b: int = 2, s: int = 64, packed: bool = True) -> dict:
    """A numpy batch: ``tokens`` (or ``embeds``), shifted labels and mask,
    and with ``packed`` the within-segment positions and the segments."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.input_embeds:
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)  # cluster targets
    else:
        tokens = batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    segments = None
    if packed:
        segments = _segments(rng, b, s)
        positions = np.zeros((b, s), np.int32)
        for i in range(b):
            for sid in np.unique(segments[i]):
                idx = np.nonzero(segments[i] == sid)[0]
                positions[i, idx] = np.arange(len(idx))
        batch.update(positions=positions, segments=segments)
        mask = (segments > 0).astype(np.float32)
    labels, mask = jax_shift_labels(jnp.asarray(tokens), jnp.asarray(mask),
                                    segments=None if segments is None else jnp.asarray(segments))
    batch.update(labels=np.asarray(labels), loss_mask=np.asarray(mask))
    return batch


def _pair(jax_weights, arch: str, **overrides):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **overrides)
    tcfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    model = LM(tcfg, device="cpu")
    params = model.load_params(params_from_jax(jax_weights(arch), tcfg, "cpu"))
    return JaxLM(jcfg), model, params


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_grads(model, params, batch):
    tsum, ttok = model.loss_sums(params, _torch_batch(batch))
    leaves = optimizer.tree_leaves(params)
    flat = dict(zip(map(id, leaves), torch.autograd.grad(tsum / ttok, leaves)))
    return tsum, ttok, params_to_jax(optimizer.tree_map(lambda p: flat[id(p)], params), model.cfg)


def _assert_trees_close(ours: dict, theirs, **tol) -> None:
    ours, theirs = jax.tree.leaves_with_path(ours), jax.tree.leaves_with_path(theirs)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, ref) in zip(ours, theirs):
        np.testing.assert_allclose(a, np.asarray(ref, np.float32), err_msg=jax.tree_util.keystr(path),
                                   **tol)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(jax_weights, arch, packed):
    jmodel, model, params = _pair(jax_weights, arch)
    batch = _batch(model.cfg, seed=3, packed=packed)
    jp = jax.tree.map(jnp.asarray, jax_weights(arch))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = model.forward(params, _torch_batch(batch))
        tsum, ttok = model.loss_sums(params, _torch_batch(batch))
    assert logits.dtype == torch.float32 and logits.shape[-1] % 256 == 0
    np.testing.assert_allclose(_np(logits), np.asarray(jmodel.forward(jp, jbatch)), **TOL)
    jsum, jtok = jmodel.loss_sums(jp, jbatch)
    assert float(ttok) == float(jtok) > 0
    np.testing.assert_allclose(float(tsum), float(jsum), **TOL)


@pytest.mark.parametrize("arch", ["olmo_1b", "arctic_480b", "hubert_xlarge"])
def test_grads_of_mean_loss_match_jax(jax_weights, arch):
    jmodel, model, params = _pair(jax_weights, arch)
    batch = _batch(model.cfg, seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.grad(lambda p: jnp.divide(*jmodel.loss_sums(p, jbatch)))(
        jax.tree.map(jnp.asarray, jax_weights(arch)))
    _, _, tgrads = _port_grads(model, params, batch)
    _assert_trees_close(tgrads, jgrads, **TOL)


@pytest.mark.parametrize("packed", [True, False], ids=["segments", "no-segments"])
def test_hubert_embeds_on_flash_route_match_jax(jax_weights, packed):
    """HuBERT's ``embeds`` batch on the flash route with ``causal=False``:
    JAX's Pallas kernels in interpret mode against the port's kernel
    wrappers on their plain versions: logits, loss and gradients."""
    jmodel, model, params = _pair(jax_weights, "hubert_xlarge", attn_impl="flash", attn_grid="dense")
    assert not model.cfg.causal
    batch = _batch(model.cfg, seed=5, s=128, packed=packed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, jax_weights("hubert_xlarge"))
    with torch.no_grad():
        logits = model.forward(params, _torch_batch(batch))
    np.testing.assert_allclose(_np(logits), np.asarray(jmodel.forward(jp, jbatch)), **TOL)
    jgrads = jax.grad(lambda p: jnp.divide(*jmodel.loss_sums(p, jbatch)))(jp)
    _, _, tgrads = _port_grads(model, params, batch)
    _assert_trees_close(tgrads, jgrads, **TOL)


# -- the bridge and the parameter tree -------------------------------------------


def _moe_every_two(cfg):
    """Arctic's smoke config with MoE on every second layer: units of two."""
    return dataclasses.replace(cfg, n_layers=4, moe_every=2)


@pytest.mark.parametrize("arch", [*ARCHS, "arctic_480b-moe-every-2"])
def test_bridge_round_trip_exact(jax_weights, arch):
    """JAX tree -> port -> JAX tree, every leaf equal, the same paths; the
    module holds every leaf as a parameter (nested groups and empty norm
    groups included)."""
    if arch.endswith("moe-every-2"):
        jcfg, tcfg = _moe_every_two(jax_smoke_config("arctic_480b")), _moe_every_two(
            get_smoke_config("arctic_480b"))
        np_params = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(1)))
        assert stack_plan(tcfg).unit_layers == ((0, 1), (2, 3))
        assert sorted(np_params["stack"]) == ["sub0", "sub1"]
    else:
        tcfg, np_params = get_smoke_config(arch), jax_weights(arch)
    model = LM(tcfg, device="cpu")
    params = model.load_params(params_from_jax(np_params, tcfg, "cpu"))
    _assert_trees_close(params_to_jax(params, tcfg), np_params, atol=0, rtol=0)
    leaves = optimizer.tree_leaves(params)
    assert {id(p) for p in model.parameters()} == {id(p) for p in leaves}
    assert ("embed" in params) != tcfg.input_embeds
    if tcfg.norm == "ln_nonparam":
        assert params["final_norm"] == {} and params["layers"][0]["norm_mixer"] == {}
    if tcfg.n_experts:
        moe = params["layers"][0]["moe"]
        assert moe["router"].dtype == torch.float32
        assert tuple(moe["w_in"].shape) == (tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff)
        assert tuple(moe["w_out"].shape) == (tcfg.n_experts, tcfg.moe_d_ff, tcfg.d_model)


@pytest.mark.parametrize("arch", [*ARCHS, "deepseek_v3_671b", "jamba_1_5_large"])
def test_port_init_has_the_jax_tree(arch):
    """The port's own ``LM.init`` gives the JAX tree's paths, shapes and
    dtypes (the values are the port's own draws)."""
    cfg = get_smoke_config(arch)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    theirs = jax.eval_shape(JaxLM(jax_smoke_config(arch)).init, jax.random.PRNGKey(0))
    ours = jax.tree.leaves_with_path(params_to_jax(params, cfg))
    theirs = jax.tree.leaves_with_path(theirs)
    assert [(p, a.shape) for p, a in ours] == [(p, b.shape) for p, b in theirs]
    ours_dtypes = [str((leaf[0] if isinstance(leaf, list) else leaf).dtype).removeprefix("torch.")
                   for leaf in _layout_leaves(jax_layout(params, cfg))]
    assert ours_dtypes == [str(b.dtype) for _, b in theirs]


def _layout_leaves(tree) -> list:
    """The leaves of a ``jax_layout`` tree in JAX's order; a stacked leaf
    stays the list of its units' tensors (``prefix``, a list of dicts, is
    walked)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _layout_leaves(tree[key])]
    if isinstance(tree[0], dict):
        return [leaf for item in tree for leaf in _layout_leaves(item)]
    return [tree]


# -- what the port refuses, as the JAX package does --------------------------------


def test_encoder_has_no_decode():
    model = LM(get_smoke_config("hubert_xlarge"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="encoder-only"):
        model.prefill(params, tokens, 8)
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step(params, model.init_caches(1, 8), tokens[:, :1], 0)


def test_serve_launcher_refuses_hubert(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only: no decode step"):
        serve.main()


def test_train_launcher_refuses_hubert(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "hubert_xlarge", "--smoke", "--device", "cpu",
                                      "--steps", "1", "--dataset", "uniform_narrow",
                                      "--data-scale", "0.05"])
    with pytest.raises(ValueError, match="input embeddings"):
        train.main()


# The full-width configs, and the depth cuts that chip_smoke.py runs on the card.
PLAN_CASES = {**{arch: {} for arch in JAX_ARCH_IDS},
              "deepseek_v3_671b-4-layers": dict(n_layers=4),
              "jamba_1_5_large-2-layers": dict(n_layers=2, attn_period=2)}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_stack_plan_matches_jax(case):
    """The port's prefix and units equal JAX ``stack_plan``'s (the layout
    the bridge and the checkpoints follow): DeepSeek-V3's 3-layer dense
    prefix, Jamba's periods of 8 (one attention layer, MoE every second)."""
    arch, overrides = case.split("-")[0], PLAN_CASES[case]
    ours = stack_plan(dataclasses.replace(get_config(arch), **overrides))
    theirs = jax_stack_plan(dataclasses.replace(jax_get_config(arch), **overrides))
    assert (ours.prefix_layers, ours.unit_layers) == (theirs.prefix_layers, theirs.unit_layers)
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)


def test_stack_plan_refuses_inhomogeneous_units():
    """Units must share their layer kinds (the JAX package asserts it): a
    hybrid period of 3 over MoE every second layer does not."""
    cfg = dataclasses.replace(get_config("jamba_1_5_large"), n_layers=6, attn_period=3)
    with pytest.raises(ValueError, match="inhomogeneous units"):
        stack_plan(cfg)
    with pytest.raises(ValueError, match="not whole units"):
        stack_plan(dataclasses.replace(get_config("jamba_1_5_large"), n_layers=12))
