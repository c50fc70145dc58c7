"""The port's SSM family against the JAX package's, on the CPU.

Same inputs on both sides, made with numpy from a seed; model weights come
from the JAX ``LM.init`` through ``bridge.params_from_jax``.  On the CPU the
SSD kernel's wrapper takes its plain chunked version, which is held against
the Pallas kernel in interpret mode and the JAX chunked and sequential forms.

Tolerances: the SSD in fp32 at atol 1e-4, rtol 1e-3 (the JAX package's own
SSD tolerance, ``tests/test_kernels.py``: the chunked and sequential forms
sum in different orders and the chunked form takes differences of
cumulative sums); bf16 inputs at 2e-2 (y is rounded to bf16 on both sides);
the SSM block and model logits in fp32 at 1e-4; teacher-forced decode
against the full forward at 2e-3 (``tests/test_models.py``'s check of the
JAX model).
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import BucketSpec as JaxBucketSpec
from repro.core import OdbConfig as JaxOdbConfig
from repro.data import OnlineDynamicLoader as JaxLoader
from repro.data import get_dataset as jax_get_dataset
from repro.kernels.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models import LM as JaxLM
from repro.models import ssm as jax_ssm
from repro.models.model import shift_labels as jax_shift_labels
from repro.train import optimizer as jax_optimizer
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.core.layout import global_batch_arrays
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels.ref import ssd_chunked_ref, ssd_scan_ref
from repro_torch.models import LM, ssm
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state, tree_leaves, tree_map
from repro_torch.train.trainer import Trainer, TrainerConfig, assemble_model_batch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread a module)

SSD_TOL = dict(atol=1e-4, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=2e-3, rtol=2e-3)

SSD_SWEEP = [  # (B, S, H, P, N, chunk): the JAX package's sweep
    (1, 64, 1, 8, 16, 16),
    (2, 128, 3, 8, 16, 32),
    (1, 256, 2, 16, 32, 64),
    (2, 96, 4, 8, 8, 32),
]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _ssd_inputs(seed, b, s, h, p, n, dtype=np.float32, decay=1.0):
    """x, dt, a, B, C as the JAX sweep draws them, in numpy; x, B and C
    rounded to ``dtype`` (fp32 or bf16).  ``decay`` scales a: at 1 the state
    forgets in ~20 steps, at 0.02 it carries over chunks."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3) * decay).astype(np.float32)
    bp = (rng.standard_normal((b, s, n)) * 0.4).astype(np.float32)
    cp = (rng.standard_normal((b, s, n)) * 0.4).astype(np.float32)
    if dtype != np.float32:
        x, bp, cp = (v.astype(dtype) for v in (x, bp, cp))
    return x, dt, a, bp, cp


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def test_full_width_config_matches_jax():
    for ours, theirs in ((get_config("mamba2-130m"), jax_get_config("mamba2_130m")),
                         (get_smoke_config("mamba2_130m"), jax_smoke_config("mamba2_130m"))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    cfg = get_config("mamba2_130m")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_state, cfg.ssm_headdim,
            cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_chunk, cfg.d_ff) == (
        24, 768, 50280, 128, 64, 1536, 24, 256, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SSD_SWEEP)
def test_ssd_plain_matches_pallas(shape, dtype):
    """The K7 wrapper's plain version against the Pallas kernel (interpret
    mode) on the same inputs, zero initial state."""
    b, s, h, p, n, chunk = shape
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x, dt, a, bp, cp = _ssd_inputs(0, b, s, h, p, n, np_dtype)
    adt = (a[None, None, :] * dt).astype(np.float32)
    theirs = jax_ssd_scan(jnp.asarray(x), jnp.asarray(adt), jnp.asarray(dt), jnp.asarray(bp),
                          jnp.asarray(cp), chunk=chunk, interpret=True)
    ssd.reset_launches()
    ours = ssd.ssd_scan(_t(x), _t(adt), _t(dt), _t(bp), _t(cp), chunk=chunk)
    assert ours.dtype == getattr(torch, dtype) and ssd.LAUNCHES["ssd_scan"] == 0  # CPU: no kernel
    np.testing.assert_allclose(_np(ours), np.asarray(theirs, np.float32),
                               **(SSD_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("decay", [1.0, 0.02])
@pytest.mark.parametrize("shape", [(2, 128, 3, 8, 16, 32), (2, 96, 4, 8, 8, 32)])
def test_ssd_states_match_jax(shape, decay):
    """``ops.ssd_chunked_scan`` from a random initial state: y and the final
    state against the JAX ``ssd_chunked`` and the sequential ``ssd_scan_ref``,
    and the port's own sequential form against the JAX one; with slow decay
    the initial state reaches the final one."""
    b, s, h, p, n, chunk = shape
    x, dt, a, bp, cp = _ssd_inputs(1, b, s, h, p, n, decay=decay)
    init = (np.random.default_rng(2).standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    y, final = ops.ssd_chunked_scan(_t(x), _t(dt), _t(a), _t(bp), _t(cp), chunk=chunk,
                                    initial_state=_t(init), return_final_state=True)
    jy, jfinal = jax_ssm.ssd_chunked(x, dt, a, bp, cp, chunk, jnp.asarray(init))
    ry, rfinal = jax_ssd_scan_ref(x, dt, a, bp, cp, jnp.asarray(init))
    for ref_y, ref_final in ((jy, jfinal), (ry, rfinal)):
        np.testing.assert_allclose(_np(y), np.asarray(ref_y), **SSD_TOL)
        np.testing.assert_allclose(_np(final), np.asarray(ref_final), **SSD_TOL)
    sy, sfinal = ssd_scan_ref(_t(x), _t(dt), _t(a), _t(bp), _t(cp), _t(init))
    np.testing.assert_allclose(_np(sy), np.asarray(ry), **SSD_TOL)
    np.testing.assert_allclose(_np(sfinal), np.asarray(rfinal), **SSD_TOL)
    # The zero-state call returns y alone.
    y0 = ops.ssd_chunked_scan(_t(x), _t(dt), _t(a), _t(bp), _t(cp), chunk=chunk)
    np.testing.assert_allclose(_np(y0), np.asarray(jax_ssm.ssd_chunked(x, dt, a, bp, cp, chunk)[0]),
                               **SSD_TOL)


def test_ssd_wrapper_rejects_what_it_cannot_take():
    x, dt, a, bp, cp = (_t(v) for v in _ssd_inputs(3, 1, 48, 2, 8, 16))
    adt = a[None, None, :] * dt
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd.ssd_scan(x, adt, dt, bp, cp, chunk=32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd.ssd_scan(x.half(), adt, dt, bp.half(), cp.half(), chunk=16)
    with pytest.raises(TypeError, match="adt and dt"):
        ssd.ssd_scan(x, adt.double(), dt, bp, cp, chunk=16)
    with pytest.raises(ValueError, match=r"\(B, S, N\)"):
        ssd.ssd_scan(x, adt, dt, bp[:, :40], cp, chunk=16)
    with pytest.raises(ValueError, match="initial_state"):
        ssd.ssd_scan(x, adt, dt, bp, cp, chunk=16, initial_state=torch.zeros(1, 2, 8, 8))


def _bf16_terms(v: torch.Tensor, terms: int) -> torch.Tensor:
    """v as the kernel hands it to an MMA: one bf16 term, or two (hi =
    rn(v), lo = rn(v − hi)) summed in fp32."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float() if terms == 2 else hi


def _ssd_bf16_model(x, adt, dt, bp, cp, chunk, init=None, x_terms=2, state_terms=2, w_terms=2):
    """The SSD as the bf16 tensor-core passes of K7 round it, in fp32 from
    the bf16 inputs: (1) per chunk S_c = Σ_j xs_jᵀ B_j with the scaled
    inputs xs_j = x_j·(exp(acs_last − acs_j)·dt_j) in ``x_terms`` bf16
    terms; (2) s_enter(c+1) = exp(acs_last(c))·s_enter(c) + S_c in fp32;
    (3) y_i = exp(acs_i)·(C_i·s_enter) + Σ_{j≤i} W_ij x_j with s_enter in
    ``state_terms`` and W_ij = exp(acs_i − acs_j)·(C_i·B_j)·dt_j (selected
    to 0 for j > i) in ``w_terms`` bf16 terms.  Returns (y in bf16, the
    fp32 final state)."""
    b, s, h, p = x.shape
    n, nc = bp.shape[-1], s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    bf, cf = bp.float().reshape(b, nc, chunk, n), cp.float().reshape(b, nc, chunk, n)
    acs = torch.cumsum(adt.float().reshape(b, nc, chunk, h), dim=2)
    xs = _bf16_terms(xf * (torch.exp(acs[:, :, -1:] - acs) * dtf)[..., None], x_terms)
    s_c = torch.einsum("bcqhp,bcqn->bchpn", xs, bf)
    state = init.float() if init is not None else torch.zeros(b, h, p, n)
    s_enter = []
    for c in range(nc):
        s_enter.append(state)
        state = torch.exp(acs[:, c, -1])[..., None, None] * state + s_c[:, c]
    scores = torch.einsum("bcin,bcjn->bcij", cf, bf)
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    ah = acs.permute(0, 1, 3, 2)  # (B, nc, H, Q)
    decay = torch.where(tri, torch.exp(ah[..., :, None] - ah[..., None, :]), 0.0)
    w = _bf16_terms(decay * scores[:, :, None] * dtf.permute(0, 1, 3, 2)[..., None, :], w_terms)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", w, xf)
    y_off = torch.einsum("bcin,bchpn->bcihp", cf, _bf16_terms(torch.stack(s_enter, 1), state_terms))
    y = y_diag + y_off * torch.exp(acs)[..., None]
    return y.reshape(b, s, h, p).to(torch.bfloat16), state


def _allowance_share(ours: np.ndarray, ref: np.ndarray, tol=BF16_TOL) -> float:
    """The worst |ours − ref| as a share of what allclose allows there."""
    ref = np.asarray(ref, np.float32)
    return float((np.abs(ours - ref) / (tol["atol"] + tol["rtol"] * np.abs(ref))).max())


MAMBA2_WIDTH = (1, 512, 4, 64, 128, 256)  # mamba2-130m's P, N and chunk, four heads


def _ssd_model_shares(shape, decay, **terms):
    """The bf16 model's worst shares of the bf16 allowance: y against the
    JAX Pallas kernel (interpret mode, zero state), and y and the final state
    against the JAX ``ssd_chunked`` from a random initial state."""
    b, s, h, p, n, chunk = shape
    x, dt, a, bp, cp = _ssd_inputs(0, b, s, h, p, n, ml_dtypes.bfloat16, decay=decay)
    adt = (a[None, None, :] * dt).astype(np.float32)
    init = (np.random.default_rng(2).standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    jy = jax_ssd_scan(*(jnp.asarray(v) for v in (x, adt, dt, bp, cp)), chunk=chunk, interpret=True)
    ky, kfinal = jax_ssm.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bp, cp)), chunk,
                                     jnp.asarray(init))
    args = (_t(x), _t(adt), _t(dt), _t(bp), _t(cp), chunk)
    y0, _ = _ssd_bf16_model(*args, **terms)
    y1, final = _ssd_bf16_model(*args, _t(init), **terms)
    assert y0.dtype == torch.bfloat16 and final.dtype == torch.float32
    return {"y zero state": _allowance_share(_np(y0), jy),
            "y random state": _allowance_share(_np(y1), ky),
            "final state": _allowance_share(_np(final), kfinal)}


class TestBf16SsdRounding:
    """K7's bf16 route multiplies on the tensor cores three operands that the
    JAX kernel keeps in fp32: the scaled inputs of the chunk states, the
    state entering a chunk, and the weights W.  Each goes in as two bf16
    terms (hi + lo).  This model of that rounding stays within the bf16
    tolerance of the JAX SSD at both decays, with half the allowance to
    spare; with any one of the three as a single bf16 term it leaves the
    tolerance at mamba2's widths with slow decay."""

    @pytest.mark.parametrize("decay", [1.0, 0.02])
    @pytest.mark.parametrize("shape", [(2, 128, 3, 8, 16, 32), (2, 96, 4, 8, 8, 32), MAMBA2_WIDTH],
                             ids=["2x128", "2x96-n8", "mamba2-width"])
    def test_rounding_model_vs_jax(self, shape, decay):
        shares = _ssd_model_shares(shape, decay)
        assert max(shares.values()) < 0.5, shares

    @pytest.mark.parametrize("single", ["x_terms", "state_terms", "w_terms"])
    def test_one_bf16_term_misses_the_tolerance(self, single):
        """Why each operand is split: one bf16 term of it, the other two
        split, leaves the tolerance on the mamba2-width case with decay
        0.02 (|y| up to ~35, |state| up to ~6)."""
        shares = _ssd_model_shares(MAMBA2_WIDTH, 0.02, **{single: 1})
        assert max(shares.values()) > 1.0, shares


# ---------------------------------------------------------------------------
# Block and model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    jcfg = jax_smoke_config("mamba2_130m")
    jmodel = JaxLM(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    cfg = get_smoke_config("mamba2_130m")
    model = LM(cfg, device="cpu")
    params = model.load_params(params_from_jax(jparams, cfg, "cpu"))
    return jcfg, jmodel, jparams, cfg, model, params


def _random_cache(rng, cfg, b):
    state = rng.standard_normal((b, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.d_state)) * 0.3
    conv = rng.standard_normal((b, cfg.d_conv - 1, cfg.d_inner + 2 * cfg.d_state)) * 0.5
    return state.astype(np.float32), conv.astype(np.float32)


@pytest.mark.parametrize(
    "case", ["no_cache", "prefill_cache", "decode", "fresh_prefill", "fresh_decode"]
)
def test_ssm_block_matches_jax(mamba, case):
    """The mixer against JAX's with no cache, a random cache and a fresh one
    (the port's fresh cache holds None where JAX's holds zeros)."""
    jcfg, _, jparams, cfg, _, params = mamba
    jmixer = jax.tree.map(lambda a: a[0], jparams["stack"]["sub0"]["mixer"])
    mixer = params["layers"][0]["mixer"]
    rng = np.random.default_rng(4)
    b, s = 2, 1 if case.endswith("decode") else 40
    u = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    cache = jcache = None
    if case.startswith("fresh"):
        cache = ssm.init_ssm_cache()
        jcache = jax_ssm.init_ssm_cache(jcfg, b, jnp.float32)
    elif case != "no_cache":
        state, conv = _random_cache(rng, cfg, b)
        cache = ssm.SSMCache(state=_t(state), conv=_t(conv))
        jcache = jax_ssm.SSMCache(state=jnp.asarray(state), conv=jnp.asarray(conv))
    with torch.no_grad():
        out, new = ssm.apply_ssm_block(mixer, _t(u), cfg, cache)
    jout, jnew = jax_ssm.apply_ssm_block(jmixer, jnp.asarray(u), jcfg, jcache)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    if case == "no_cache":
        assert new is None and jnew is None
        return
    np.testing.assert_allclose(_np(new.state), np.asarray(jnew.state), **TOL)
    np.testing.assert_allclose(_np(new.conv), np.asarray(jnew.conv), **TOL)
    assert str(new.state.dtype).removeprefix("torch.") == str(jnew.state.dtype)


def test_forward_logits_match_jax(mamba):
    _, jmodel, jparams, cfg, model, params = mamba
    tokens = np.random.default_rng(5).integers(1, cfg.vocab_size, size=(2, 48)).astype(np.int32)
    with torch.no_grad():
        ours = model.forward(params, {"tokens": torch.from_numpy(tokens).long()})
        loss, count = model.loss_sums(params, {
            "tokens": torch.from_numpy(tokens).long(),
            "labels": torch.from_numpy(np.roll(tokens, -1, axis=1)).long(),
            "loss_mask": torch.ones(tokens.shape),
        })
    theirs = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), **TOL)
    jloss, jcount = jmodel.loss_sums(jparams, {
        "tokens": jnp.asarray(tokens), "labels": jnp.roll(jnp.asarray(tokens), -1, axis=1),
        "loss_mask": jnp.ones(tokens.shape),
    })
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(count) == float(jcount)


def _prefill_decode(model, params, tokens, split, max_len, torch_side):
    """Prefill tokens[:, :split], then teacher-forced decode of the rest;
    returns (prefill logits, stacked decode logits, caches)."""
    if torch_side:
        t = torch.from_numpy(tokens).long()
        first, caches = model.prefill(params, t[:, :split], max_len)
        steps = []
        for i in range(split, tokens.shape[1]):
            lg, caches = model.decode_step(params, caches, t[:, i : i + 1], i)
            steps.append(lg)
        return _np(first), _np(torch.cat(steps, dim=1)), caches
    first, caches = model.prefill(params, jnp.asarray(tokens[:, :split]), max_len)
    decode = jax.jit(model.decode_step)
    steps = []
    for i in range(split, tokens.shape[1]):
        lg, caches = decode(params, caches, jnp.asarray(tokens[:, i : i + 1]), jnp.array(i, jnp.int32))
        steps.append(lg)
    return np.asarray(first), np.asarray(jnp.concatenate(steps, axis=1)), caches


def test_prefill_and_decode_match_jax(mamba):
    """Prefill of 24 tokens (one full chunk of 16 and a padded one), then
    eight decode steps: logits and the SSM caches against JAX's."""
    _, jmodel, jparams, cfg, model, params = mamba
    tokens = np.random.default_rng(6).integers(1, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    first, dec, caches = _prefill_decode(model, params, tokens, 24, 32, True)
    jfirst, jdec, jcaches = _prefill_decode(jmodel, jparams, tokens, 24, 32, False)
    np.testing.assert_allclose(first, jfirst, **TOL)
    np.testing.assert_allclose(dec, jdec, **TOL)
    jstack = jcaches["stack"]["sub0"]
    for l, cache in enumerate(caches):
        np.testing.assert_allclose(_np(cache.state), np.asarray(jstack.state[l]), **TOL)
        np.testing.assert_allclose(_np(cache.conv), np.asarray(jstack.conv[l]), **TOL)


@pytest.mark.parametrize("split", [8, 20])
def test_decode_matches_forward(mamba, split):
    """Teacher-forced decode reproduces the full forward (the JAX package's
    consistency check, here on the port alone)."""
    _, _, _, cfg, model, params = mamba
    tokens = np.random.default_rng(7).integers(1, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    with torch.no_grad():
        full = _np(model.forward(params, {"tokens": torch.from_numpy(tokens).long()}))
    first, dec, _ = _prefill_decode(model, params, tokens, split, 32, True)
    vp = first.shape[-1]
    np.testing.assert_allclose(first[:, 0], full[:, split - 1, :vp], **DECODE_TOL)
    np.testing.assert_allclose(dec, full[:, split:, :vp], **DECODE_TOL)


def test_qwen3_prefill_and_decode_match_jax():
    """The attention family through the same two entry points: slot-scatter
    prefill with one segment per row, per-slot decode at one frontier."""
    jcfg = jax_smoke_config("qwen3_0_6b")
    jmodel = JaxLM(jcfg)
    jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    cfg = get_smoke_config("qwen3_0_6b")
    model = LM(cfg, device="cpu")
    params = model.load_params(params_from_jax(jparams, cfg, "cpu"))
    tokens = np.random.default_rng(8).integers(1, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    first, dec, _ = _prefill_decode(model, params, tokens, 16, 32, True)
    jfirst, jdec, _ = _prefill_decode(jmodel, jparams, tokens, 16, 32, False)
    np.testing.assert_allclose(first, jfirst, **TOL)
    np.testing.assert_allclose(dec, jdec, **TOL)


def test_bridge_round_trip(mamba):
    _, _, jparams, cfg, _, params = mamba
    layer = params["layers"][0]
    assert set(layer) == {"norm_mixer", "mixer"}  # no FFN group
    assert set(layer["mixer"]) == {"in_z", "in_x", "in_b", "in_c", "in_dt", "conv_w", "dt_bias",
                                   "a_log", "d_skip", "out_norm", "out_proj"}
    for name, leaf in layer["mixer"].items():
        assert leaf.dtype == torch.float32, name  # the smoke config is fp32
    back = params_to_jax(params, cfg)
    flat, tree = jax.tree.flatten(back)
    jflat, jtree = jax.tree.flatten(jparams)
    assert tree == jtree
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_bridge_keeps_bf16_and_fp32_leaves():
    """At the model's bf16 the projections stay bf16 and a_log, dt_bias,
    d_skip fp32, as the JAX package keeps them."""
    jcfg = dataclasses.replace(jax_smoke_config("mamba2_130m"), dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, JaxLM(jcfg).init(jax.random.PRNGKey(2)))
    cfg = dataclasses.replace(get_smoke_config("mamba2_130m"), dtype="bfloat16")
    mixer = params_from_jax(jparams, cfg, "cpu")["layers"][1]["mixer"]
    for name, leaf in mixer.items():
        want = torch.float32 if name in ("a_log", "dt_bias", "d_skip") else torch.bfloat16
        assert leaf.dtype == want, name
    np.testing.assert_array_equal(
        _np(mixer["in_x"]), np.asarray(jparams["stack"]["sub0"]["mixer"]["in_x"][1], np.float32))


# ---------------------------------------------------------------------------
# What the port refuses, as the JAX package does
# ---------------------------------------------------------------------------


def test_engine_refuses_ssm():
    model = LM(get_smoke_config("mamba2_130m"), device="cpu")
    with pytest.raises(NotImplementedError, match="GQA-attention"):
        ContinuousBatchingEngine(model, None, ServeConfig(num_slots=2, max_len=64, l_max=128),
                                 device="cpu")


def test_slot_scatter_prefill_refuses_ssm(mamba):
    _, _, _, cfg, model, params = mamba
    caches = model.init_caches(1, 16)
    tokens = torch.ones((1, 8), dtype=torch.long)
    zeros = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="per-request prefill"):
        model.prefill_packed(params, caches, tokens, zeros, zeros + 1, zeros)


# ---------------------------------------------------------------------------
# Training: the SSD's gradient, the model's, three trainer steps
# ---------------------------------------------------------------------------

GRAD_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_kernels.py::_tol, fp32


def _overflow_inputs():
    """mamba2's overflow regime at (1, 256, 4, 8, 16), one chunk of 256:
    a = -(1, 4, 8, 16) and dt in [0.001, 0.1], so Σ a·dt over the chunk
    reaches a few hundred and exp(acs_i - acs_j) above the diagonal
    overflows fp32."""
    rng = np.random.default_rng(11)
    b, s, h, p, n = 1, 256, 4, 8, 16
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32)
    a = -np.array([1.0, 4.0, 8.0, 16.0], np.float32)
    bp = (rng.standard_normal((b, s, n)) * 0.4).astype(np.float32)
    cp = (rng.standard_normal((b, s, n)) * 0.4).astype(np.float32)
    w = rng.standard_normal((b, s, h, p)).astype(np.float32)
    return (x, dt, a, bp, cp), w, 256


def _jax_ssd_grads(inputs, w, chunk, init=None):
    def loss(x, dt, a, bp, cp, *state):
        y, _ = jax_ssm.ssd_chunked(x, dt, a, bp, cp, chunk, *state)
        return jnp.sum(y.astype(jnp.float32) * w)

    args = [jnp.asarray(v) for v in inputs] + ([jnp.asarray(init)] if init is not None else [])
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=tuple(range(len(args))))(*args)]


def test_ssd_plain_grads_finite_in_overflow_regime():
    """The gradients of the plain chunked form, where exp(acs_i - acs_j)
    overflows above the diagonal: all finite and equal to JAX's.  The
    difference is masked to -inf before the exp, as JAX's ``_segsum`` does;
    a mask after the exp gave NaN gradients (0 · inf in exp's backward)."""
    inputs, w, chunk = _overflow_inputs()
    x, dt, a, bp, cp = (_t(v).requires_grad_() for v in inputs)
    y, _ = ssd_chunked_ref(x, a[None, None, :] * dt, dt, bp, cp, chunk)
    ours = torch.autograd.grad((y * _t(w)).sum(), (x, dt, a, bp, cp))
    for name, g, ref in zip(("x", "dt", "a", "B", "C"), ours, _jax_ssd_grads(inputs, w, chunk)):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(_np(g), ref, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", ["overflow", "sweep-init", "sweep-bf16"])
def test_ssd_function_grads_match_plain_and_jax(case):
    """``ops.ssd_chunked_scan`` under grad goes through the autograd
    Function (its forward the kernel's wrapper, its backward the plain
    form's gradient, recomputed): gradients of x, dt, a, B, C (and the
    initial state) equal plain autograd through ``ssd_chunked_ref`` bit for
    bit, and JAX's at the fp32 gradient tolerance.

    With bf16 x, B and C the port rounds each of their gradients to bf16
    once, from an fp32 sum.  JAX's bf16 gradient is a bf16 sum of one
    rounded cotangent per use of the input (the chunk's output and its state
    update), which cancel: here it is 0.075 from JAX's own fp32 gradient at
    |g| ≤ 25.  So the bf16 case is held against JAX's fp32 gradient on the
    same (bf16-valued) inputs and the bf16-rounded cotangent, at 2e-2 for
    the bf16 leaves and the fp32 tolerance for dt and a."""
    init = None
    if case == "overflow":
        inputs, w, chunk = _overflow_inputs()
    else:
        b, s, h, p, n, chunk = SSD_SWEEP[1]
        dtype = ml_dtypes.bfloat16 if case == "sweep-bf16" else np.float32
        inputs = _ssd_inputs(9, b, s, h, p, n, dtype, decay=0.02)
        w = np.random.default_rng(10).standard_normal((b, s, h, p)).astype(np.float32)
        if case == "sweep-init":
            init = (np.random.default_rng(2).standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    grads = {}
    for route in ("function", "plain"):
        tensors = [_t(v).requires_grad_() for v in inputs] + (
            [_t(init).requires_grad_()] if init is not None else [])
        x, dt, a, bp, cp, *state = tensors
        if route == "function":
            ssd.reset_launches()
            y = ops.ssd_chunked_scan(x, dt, a, bp, cp, chunk=chunk, initial_state=state[0] if state else None)
            assert ssd.LAUNCHES["ssd_scan"] == 0  # the CPU takes the plain forward
        else:
            y, _ = ssd_chunked_ref(x, a[None, None, :] * dt, dt, bp, cp, chunk, *state)
        grads[route] = torch.autograd.grad((y.float() * _t(w)).sum(), tensors)
    if case == "sweep-bf16":
        theirs = _jax_ssd_grads([np.asarray(v, np.float32) for v in inputs],
                                np.asarray(w.astype(ml_dtypes.bfloat16), np.float32), chunk)
    else:
        theirs = _jax_ssd_grads(inputs, w, chunk, init)
    for name, g, plain, ref in zip(("x", "dt", "a", "B", "C", "initial state"),
                                   grads["function"], grads["plain"], theirs):
        assert g.dtype == plain.dtype and torch.equal(g, plain), name
        assert bool(torch.isfinite(g).all()), name
        tol = BF16_TOL if g.dtype == torch.bfloat16 else GRAD_TOL
        np.testing.assert_allclose(_np(g), ref, err_msg=name, **tol)


def _loaders(layout: str):
    """The port's and the JAX package's loaders over the same short samples
    (64-512 tokens), two ranks at l_max 512, the mamba2 smoke vocabulary."""
    kw = dict(config=dict(l_max=512, buffer_size=64, prefetch_factor=16, num_workers=4),
              bucket=dict(min_len=128, max_len=16384, max_count=1024))
    ours = OnlineDynamicLoader(get_dataset("uniform_narrow", scale=0.05), 2, OdbConfig(**kw["config"]),
                               bucket_spec=BucketSpec(**kw["bucket"]), layout=layout, vocab_size=512)
    theirs = JaxLoader(jax_get_dataset("uniform_narrow", scale=0.05), 2, JaxOdbConfig(**kw["config"]),
                       bucket_spec=JaxBucketSpec(**kw["bucket"]), layout=layout, vocab_size=512)
    return ours, theirs


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_ssm_loss_sums_and_grads_match_jax(mamba, layout):
    """Gradients of the mean loss of ``loss_sums`` on the mamba2 smoke
    config from JAX ``LM.init`` weights, every leaf against JAX at the fp32
    tolerance (the mean, as test_torch_train.py's attention test: the sum's
    fp32 order noise exceeds 2e-5).  On the packed layout the SSM ignores
    the segments in both packages: state flows across packed samples, and
    only the shifted labels mask cross-sample targets."""
    jcfg, jmodel, jparams, cfg, model, params = mamba
    loader, _ = _loaders(layout)
    step = next(iter(loader.epoch(0)))
    arrays = global_batch_arrays(step.batches, loader.layout)
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    jbatch["labels"], jbatch["loss_mask"] = jax_shift_labels(
        jbatch["tokens"], jbatch["loss_mask"], segments=jbatch.get("segments"))
    jp = jax.tree.map(jnp.asarray, jparams)
    jsum, jtok = jmodel.loss_sums(jp, jbatch)
    jgrads = jax.grad(lambda q: jnp.divide(*jmodel.loss_sums(q, jbatch)))(jp)

    batch = assemble_model_batch(step, loader.layout, "cpu")
    assert ("segments" in batch) == (layout == "packed")
    tsum, ttok = model.loss_sums(params, batch)
    leaves = tree_leaves(params)
    flat = dict(zip(map(id, leaves), torch.autograd.grad(tsum / ttok, leaves)))
    tgrads = params_to_jax(tree_map(lambda q: flat[id(q)], params), cfg)

    assert float(ttok) == float(jtok) > 0
    np.testing.assert_allclose(float(tsum.detach()), float(jsum), **GRAD_TOL)
    ours, theirs = jax.tree.leaves_with_path(tgrads), jax.tree.leaves_with_path(jgrads)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, ref) in zip(ours, theirs):
        assert np.isfinite(a).all(), jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, np.asarray(ref), err_msg=jax.tree_util.keystr(path), **GRAD_TOL)


def test_ssm_trainer_three_steps_match_jax(mamba):
    """Three ``Trainer`` steps of the mamba2 smoke config (CPU, dense, the
    default streaming data path) against the JAX trainer from the same
    weights: per-step loss and grad_norm at rtol 1e-4, as
    test_torch_train.py's three-step test holds the attention family."""
    jcfg, _, jparams, cfg, _, _ = mamba
    opt = dict(total_steps=100)
    loader, jloader = _loaders("dense")
    jtrainer = JaxTrainer(JaxLM(jcfg), jloader, jax_optimizer.OptimizerConfig(**opt),
                          JaxTrainerConfig(log_every=1, max_steps=3))
    jp = jax.tree.map(jnp.asarray, jparams)
    jtrainer.train_epoch({"params": jp, "opt": jax_optimizer.init_opt_state(jp, jtrainer.opt_cfg)})

    model = LM(cfg, device="cpu")
    trainer = Trainer(model, loader, OptimizerConfig(**opt), TrainerConfig(log_every=1, max_steps=3))
    params = model.load_params(params_from_jax(jparams, cfg, "cpu"))
    _, n = trainer.train_epoch({"params": params, "opt": init_opt_state(params, trainer.opt_cfg)})
    assert n == 3 and len(trainer.history) == len(jtrainer.history) == 3
    for ours, theirs in zip(trainer.history, jtrainer.history):
        assert ours["tokens"] == theirs["tokens"]
        np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-4)
        np.testing.assert_allclose(ours["grad_norm"], theirs["grad_norm"], rtol=1e-4)
