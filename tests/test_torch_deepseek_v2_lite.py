"""DeepSeek-V2-Lite in the port (``repro_torch.configs.deepseek_v2_lite``):
MLA without a query latent, YaRN rope with the published pairing, and the
dropless MoE of the experts held here (``models/moe.dropless_ffn``), held on
the CPU against the benchmark's plain float32 reference
(``odb_bench/reference/deepseek_v2.py``), which imports nothing of the port.

Weights come from the benchmark's own draw (``odb_bench/weights.make``):
each expert of a slab is its own slice of the draw, so a pair sent to the
wrong expert changes the result.  Tolerances, each for its reason:

  * ``GRAD_RTOL`` 1e-5 (fp32): the port and the reference compute the same
    sums in other orders (scores as a nope and a rope product against one
    product over the concatenated dims, the combine over k against one
    index_add per expert); fp32 leaves them a few ulps apart, ~1e-6 of a
    leaf's norm here;
  * ``LOSS_RTOL`` 1e-6 (fp32): the loss sum over a few hundred tokens, the
    same orders;
  * the grouped products against a plain product per expert, 1e-5 relative
    and 1e-6 absolute (fp32: sums of a few products in other orders);
  * YaRN's frequencies to the six digits the published numbers give; the
    port's against the reference's at 1e-6 relative (fp32, one division
    done in another order).
"""

import copy
import dataclasses
import json
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from odb_bench import harness, weights  # noqa: E402
from odb_bench.reference import deepseek_v2 as ref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import LM, moe  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    YARN_BETA_FAST,
    YARN_BETA_SLOW,
    YARN_ORIGINAL_MAX_POS,
    apply_rope,
    yarn_frequencies,
    yarn_mscale,
)
from repro_torch.models.model import shift_labels  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a module)

GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-6
SMOKE = get_smoke_config("deepseek_v2_lite")
CONFIG_FILE = ROOT / "odb_bench" / "configs" / "deepseek_v2_lite.json"


def ref_config(cfg) -> dict:
    """The reference's configuration (the published keys) of a port config."""
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads, "qk_nope_head_dim": cfg.qk_nope_dim,
        "qk_rope_head_dim": cfg.qk_rope_dim, "v_head_dim": cfg.v_head_dim, "kv_lora_rank": cfg.kv_lora_rank,
        "rms_norm_eps": 1e-6, "rope_theta": cfg.rope_theta,
        "rope_scaling": {"factor": cfg.yarn_factor, "original_max_position_embeddings": YARN_ORIGINAL_MAX_POS,
                         "beta_fast": YARN_BETA_FAST, "beta_slow": YARN_BETA_SLOW,
                         "mscale": cfg.yarn_mscale_all_dim, "mscale_all_dim": cfg.yarn_mscale_all_dim},
        "num_experts_per_tok": cfg.top_k, "norm_topk_prob": cfg.moe_renormalize,
        "routed_scaling_factor": 1.0, "n_routed_experts": cfg.experts_held,
        "assumed": {"held_start": cfg.moe_held_start}, "vocab_size": cfg.vocab_size,
    }


def specs_of(cfg) -> list:
    return [(p, tuple(leaf.shape), leaf.dtype) for p, leaf in weights.flatten(LM(cfg, device="meta").init())]


def start_weights(cfg, seed: int = 1234) -> tuple:
    specs = specs_of(cfg)
    return specs, weights.make(specs, seed, "cpu")


def packed_batch(cfg, rows: list, width: int, seed: int = 0) -> tuple:
    """A packed batch of ``rows`` (each a list of sample lengths) and the
    samples in order."""
    gen = torch.Generator().manual_seed(seed)
    arrays = {k: torch.zeros(len(rows), width, dtype=torch.long) for k in ("tokens", "positions", "segments")}
    mask = torch.zeros(len(rows), width)
    samples = []
    for r, lengths in enumerate(rows):
        at = 0
        for i, n in enumerate(lengths):
            s = torch.randint(1, cfg.vocab_size, (n,), generator=gen)
            samples.append(s)
            arrays["tokens"][r, at:at + n] = s
            arrays["positions"][r, at:at + n] = torch.arange(n)
            arrays["segments"][r, at:at + n] = i + 1
            mask[r, at:at + n] = 1.0
            at += n
    labels, loss_mask = shift_labels(arrays["tokens"], mask, segments=arrays["segments"])
    return dict(arrays, labels=labels, loss_mask=loss_mask), samples


def port_loss_and_grads(cfg, specs, start, batch):
    model = LM(cfg, device="cpu")
    params = model.load_params(weights.unflatten(zip([p for p, _, _ in specs], [w.clone() for w in start])))
    loss, count = model.loss_sums(params, batch)
    return loss, count, torch.autograd.grad(loss, [leaf for _, leaf in weights.flatten(params)])


def ref_loss_and_grads(cfg, specs, start, samples):
    leaves = [w.clone().requires_grad_(True) for w in start]
    loss, count = ref.loss_sums(weights.unflatten(zip([p for p, _, _ in specs], leaves)), samples, ref_config(cfg))
    return loss, count, torch.autograd.grad(loss, leaves)


def assert_grads_close(specs, ours, theirs):
    for (path, _, _), a, b in zip(specs, ours, theirs):
        gap = float((a - b).norm() / b.norm().clamp(min=1e-30))
        assert gap <= GRAD_RTOL, ("/".join(map(str, path)), gap)


def test_loss_and_every_gradient_match_the_reference():
    specs, start = start_weights(SMOKE)
    batch, samples = packed_batch(SMOKE, [[20, 9, 2], [30], [7, 14]], 32)
    loss, count, grads = port_loss_and_grads(SMOKE, specs, start, batch)
    r_loss, r_count, r_grads = ref_loss_and_grads(SMOKE, specs, start, samples)
    assert float(count) == float(r_count) == sum(len(s) - 1 for s in samples)
    assert float(loss.detach()) == pytest.approx(float(r_loss.detach()), rel=LOSS_RTOL)
    assert {p[-1] for p, _, _ in specs} >= {"w_q", "w_dkv", "kv_norm", "router", "w_in", "w_gate", "w_out"}
    assert not {p[-1] for p, _, _ in specs} & {"w_dq", "q_norm", "w_uq"}
    assert_grads_close(specs, grads, r_grads)


def test_the_config_file_states_what_the_port_fixes():
    """The settings the port does not take from a config, as the file
    states them: YaRN's original context and ramp, the cos/sin factor
    mscale(s, mscale) / mscale(s, mscale_all_dim) at 1, no routed scaling."""
    c = json.loads(CONFIG_FILE.read_text())
    rs = c["rope_scaling"]
    assert (rs["original_max_position_embeddings"], rs["beta_fast"], rs["beta_slow"]) == (
        YARN_ORIGINAL_MAX_POS, YARN_BETA_FAST, YARN_BETA_SLOW)
    assert rs["mscale"] == rs["mscale_all_dim"] and c["routed_scaling_factor"] == 1
    assert not set(c["run"]["port"]) - {f.name for f in dataclasses.fields(type(SMOKE))}


def test_yarn_frequencies_and_softmax_scale_as_published():
    freqs = yarn_frequencies(64, 10000.0, 40.0)
    want = {0: 1.0, 10: 0.0562341, 16: 0.0055, 23: 3.33380e-5, 31: 3.33380e-6}
    for i, value in want.items():  # equal to the six digits given
        assert f"{float(freqs[i]):.6g}" == f"{value:.6g}", i
    ref_freqs, ref_mscale = ref.yarn_inv_freq(json.loads(CONFIG_FILE.read_text()), "cpu")
    torch.testing.assert_close(freqs, ref_freqs, rtol=1e-6, atol=0)
    assert ref_mscale == 1.0
    assert yarn_mscale(40.0, 0.707) == pytest.approx(1.260804, rel=1e-6)
    assert 192 ** -0.5 * yarn_mscale(40.0, 0.707) ** 2 == pytest.approx(0.114721, rel=1e-5)
    assert ref.softmax_scale(json.loads(CONFIG_FILE.read_text())) == pytest.approx(0.114721, rel=1e-5)


def test_the_pairing_rotates_adjacent_pairs():
    """Published pairing: dims (2i, 2i+1) turn together by frequency i; the
    output is laid out as (even dims, odd dims), the order the published
    code leaves queries and keys in."""
    x = torch.randn(1, 5, 3, 16, generator=torch.Generator().manual_seed(2))
    positions = torch.arange(5)[None]
    freqs = yarn_frequencies(16, 10000.0, 40.0)
    out = apply_rope(x, positions, 10000.0, freqs=freqs, pairs=True)
    ang = positions[0, :, None, None].float() * freqs
    even, odd = x[..., 0::2], x[..., 1::2]
    want = torch.cat([even * ang.cos() - odd * ang.sin(), odd * ang.cos() + even * ang.sin()], dim=-1)
    torch.testing.assert_close(out, want)
    # the same through the reference's rotary
    c = json.loads(CONFIG_FILE.read_text())
    c.update(qk_rope_head_dim=16, rope_theta=10000.0)
    torch.testing.assert_close(ref.rope(x[0], positions[0], c), want[0])


def moe_case(n_experts=64, held=8, top_k=6, d=64, ff=32, tokens=48, seed=5):
    cfg = dataclasses.replace(SMOKE, d_model=d, moe_d_ff=ff, n_experts=n_experts, moe_held=held, top_k=top_k,
                              n_shared_experts=2)
    gen = torch.Generator().manual_seed(seed)
    full = {
        "router": torch.randn(d, n_experts, generator=gen) / d ** 0.5,
        "w_in": torch.randn(n_experts, d, ff, generator=gen) / d ** 0.5,
        "w_gate": torch.randn(n_experts, d, ff, generator=gen) / d ** 0.5,
        "w_out": torch.randn(n_experts, ff, d, generator=gen) / ff ** 0.5,
        "shared": {"w_in": torch.randn(d, 2 * ff, generator=gen) / d ** 0.5,
                   "w_gate": torch.randn(d, 2 * ff, generator=gen) / d ** 0.5,
                   "w_out": torch.randn(2 * ff, d, generator=gen) / ff ** 0.5}}
    return cfg, full, torch.randn(1, tokens, d, generator=gen)


def share(full: dict, start: int, held: int, shared: bool = True) -> dict:
    p = {"router": full["router"], **{k: full[k][start:start + held] for k in ("w_in", "w_gate", "w_out")}}
    if shared:
        p["shared"] = full["shared"]
    return p


def test_the_shares_add_up_to_the_whole_layer():
    """All 8 shares of an 8-way layer (experts [8c, 8c + 8) of 64), their
    routed parts summed and the shared experts counted once, equal the
    uncut reference's whole MoE layer."""
    cfg, full, x = moe_case()
    parts = sum(moe.moe_ffn(share(full, 8 * c, 8, shared=False), x,
                            dataclasses.replace(cfg, moe_held_start=8 * c)) for c in range(8))
    whole = parts + moe._dense_mlp(x.reshape(-1, 64), full["shared"], "silu").view_as(x)
    uncut = dict(ref_config(dataclasses.replace(cfg, moe_held=64)), n_routed_experts=64)
    torch.testing.assert_close(whole[0], ref.experts(full, x[0], uncut, None), rtol=1e-5, atol=1e-6)


def test_dropless_under_imbalance():
    """A router biased so that held expert 2 takes most pairs: every pair
    is computed, no capacity drops any, and the layer matches the
    reference."""
    cfg, full, x = moe_case(tokens=64)
    full["router"][:, 2] += 0.5 * x[0].sum(0) / x[0].sum(0).norm() * 40
    p = share(full, 0, 8)
    ids = torch.topk(torch.softmax(x[0] @ full["router"], -1), 6).indices
    assert int((ids == 2).sum()) > 0.9 * 64  # most tokens choose it
    torch.testing.assert_close(moe.moe_ffn(p, x, cfg)[0], ref.experts(p, x[0], ref_config(cfg), None),
                               rtol=1e-5, atol=1e-6)
    capacity = moe.moe_capacity(64, 6, 64, cfg.capacity_factor)
    assert int((ids == 2).sum()) > capacity  # the capacity path would have dropped pairs


def test_counters_equal_the_reference_pair_counts():
    cfg, full, x = moe_case(tokens=40)
    p = share(full, 8, 8)
    cfg = dataclasses.replace(cfg, moe_held_start=8)
    registry, tracer = obs.default_registry(), obs.default_tracer()
    before = dict(registry.flat())
    tracer.enable()
    try:
        y = moe.moe_ffn(p, x.requires_grad_(True), cfg)
        torch.autograd.grad(y.sum(), [x])
    finally:
        tracer.disable()
    got = {k: v - before.get(k, 0.0) for k, v in registry.flat().items() if k in moe.PAIR_COUNTERS}
    ids = torch.topk(torch.softmax(x[0].detach() @ full["router"], -1), 6).indices
    per_expert = [(ids == e).sum().item() for e in range(8, 16)]
    assert got == {"moe_routed_pairs_total": 40 * 6, "moe_held_pairs_total": sum(per_expert),
                   "moe_held_peak_pairs_total": max(per_expert)}


@pytest.mark.parametrize("offsets", [[4, 4, 11], [4, 11, 11], [0, 0, 0]],
                         ids=["empty_middle", "empty_last", "all_empty"])
def test_held_experts_backward_matches_autograd(offsets):
    """The grouped products and their hand-written backward against
    autograd through a plain product per expert, in float32, with empty
    groups (``torch._grouped_mm`` takes no float64, so no gradcheck): equal
    to 1e-5, the float32 sums of a few products in other orders."""
    gen = torch.Generator().manual_seed(3)
    n = offsets[-1]
    rows = torch.randn(n, 8, generator=gen, requires_grad=True)
    # widths of whole 16-byte multiples, as torch._grouped_mm wants its strides
    w = [torch.randn(3, *s, generator=gen, requires_grad=True) for s in ((8, 12), (8, 12), (12, 8))]
    d_out = torch.randn(n, 8, generator=gen)
    bounds = list(zip([0] + offsets[:-1], offsets))

    def plain(r, w_in, w_gate, w_out):
        return torch.cat([(torch.nn.functional.silu(r[a:b] @ w_gate[e]) * (r[a:b] @ w_in[e])) @ w_out[e]
                          for e, (a, b) in enumerate(bounds)])

    got = moe._HeldExperts.apply(rows, torch.tensor(offsets, dtype=torch.int32), *w)
    want = plain(rows, *w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    for a, b in zip(torch.autograd.grad(got, [rows, *w], d_out), torch.autograd.grad(want, [rows, *w], d_out)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_pair_gather_and_combine_backwards_match_autograd():
    """The fixed-order backwards of the pair gather and the combine against
    autograd's index backward, in float64: a token with several held
    choices, one with none."""
    gen = torch.Generator().manual_seed(6)
    ids = torch.tensor([[0, 2], [3, 1], [5, 4], [1, 0]])
    order, offsets, _ = moe.held_pairs(ids, 0, 4)
    pairs = order[:int(offsets[-1])]
    cell = torch.full((8,), len(pairs), dtype=torch.long)
    cell[pairs] = torch.arange(len(pairs))
    cell = cell.view(4, 2)
    token = pairs // 2
    x = torch.randn(4, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    rows = torch.randn(len(pairs), 3, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x_: moe._PairRows.apply(x_, token, cell), (x,))
    assert torch.autograd.gradcheck(lambda r: moe._Combine.apply(r, token, cell), (rows,))
    plain = torch.zeros(4, 3, dtype=torch.float64).index_add(0, token, rows)
    torch.testing.assert_close(moe._Combine.apply(rows, token, cell), plain)
    torch.testing.assert_close(moe._PairRows.apply(x, token, cell), x[token])


def test_capacity_dispatch_refuses_weights_not_renormalised():
    """The capacity path renormalises the top-k weights; a config that
    asks otherwise is refused there, not run as if it had not asked."""
    cfg, full, x = moe_case(n_experts=8, held=8)
    with pytest.raises(NotImplementedError, match="renormalises"):
        moe.moe_ffn(share(full, 0, 8), x, dataclasses.replace(cfg, moe_dispatch="capacity", moe_held=0))


def test_existing_configs_keep_their_trees():
    """The new fields' defaults: DeepSeek-V3 keeps its query latent and the
    capacity dispatch, and every config the JAX package describes keeps its
    size."""
    v3 = get_config("deepseek_v3_671b")
    assert v3.moe_dispatch == "capacity" and v3.experts_held == 256 and v3.yarn_factor == 0.0
    tree = LM(get_smoke_config("deepseek_v3_671b"), device="meta").init()
    assert {"w_dq", "q_norm", "w_uq"} <= set(tree["layers"][0]["mixer"])
    lite = get_config("deepseek_v2_lite")
    assert round(lite.param_count() / 1e9, 1) == 15.7
    assert round(dataclasses.replace(lite, moe_held=8, vocab_size=12800).param_count() / 1e9, 3) == 2.744


def small_config() -> dict:
    """The benchmark's configuration file, cut in this test to a CPU size."""
    c = copy.deepcopy(json.loads(CONFIG_FILE.read_text()))
    c.update(num_hidden_layers=3, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=16, qk_rope_head_dim=16, qk_nope_head_dim=16, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=32, num_experts_per_tok=3, vocab_size=512)
    c["deployment"]["published"]["n_routed_experts"] = 16
    c["assumed"].update(dtype="float32", held_start=8)
    c["run"].update(world=2, l_max=512, trace_steps=2)
    return c


def test_a_small_cell_runs_through_the_harness():
    from odb_bench.tests import smallcell

    c = small_config()
    cfg = harness.port_config(c)
    assert (cfg.n_experts, cfg.experts_held, cfg.moe_held_start, cfg.moe_dispatch) == (16, 8, 8, "dropless")
    assert cfg.q_lora_rank == 0 and cfg.yarn_factor == 40 and cfg.rope_pairing == "pairs"
    assert not cfg.moe_renormalize
    limits = json.loads((ROOT / "odb_bench" / "limits" / "deepseek_v2_lite.ultrachat.json").read_text())
    readers = {m: __import__(f"odb_bench.metrics.{m}", fromlist=["read"])
               for m in ("expert_roofline", "moe_ms", "expert_load_peak", "device_mfu")}
    out = harness.run_cell("deepseek_v2_lite.ultrachat", c, smallcell.traffic(image=False), smallcell.WINDOW,
                           2**31 + 19, 2.0, True, readers, limits, device="cpu", log=lambda line: None)
    assert out["correct"], out["checks"]
    assert out["checks"]["loss_gap"]["value"] < 1e-5
    assert out["metrics"]["expert_load_peak"] >= 1.0


def test_moe_readers_on_a_made_up_trace():
    """The three readers on a hand-made trace: which kernels each counts
    (the profiler's own ``moe/...`` device rows left out, the recompute
    inside the exit node counted once, by its range) and their arithmetic."""
    import types

    from odb_bench.flops import deepseek_v2 as flops
    from odb_bench.metrics import expert_load_peak, expert_roofline, moe_ms

    node = "autograd::engine::evaluate_function: "
    ms = 1_000_000
    # host: (name, start, end, thread, correlation); device: (name, start, end, linked correlation)
    host = [("moe/layer", 0, 10 * ms, 1, 1), ("moe/experts", 2 * ms, 5 * ms, 1, 2),
            ("launch", 1 * ms, 1 * ms, 1, 10), ("launch", 3 * ms, 3 * ms, 1, 11),
            (node + "_MoeExitBackward", 20 * ms, 30 * ms, 2, 3),
            ("moe/layer", 21 * ms, 29 * ms, 2, 4), ("moe/experts", 22 * ms, 23 * ms, 2, 5),
            ("launch", 22 * ms, 22 * ms, 2, 12),
            (node + "_HeldExpertsBackward", 31 * ms, 35 * ms, 2, 6), ("launch", 32 * ms, 32 * ms, 2, 13),
            ("launch", 36 * ms, 36 * ms, 2, 14), (node + "_MoeEnterBackward", 37 * ms, 38 * ms, 2, 7),
            ("launch", 40 * ms, 40 * ms, 2, 15)]
    device = [("gate_kernel", 0, 1 * ms, 10), ("grouped", 0, 2 * ms, 11), ("moe/experts", 0, 3 * ms, 2),
              ("grouped", 0, 2 * ms, 12), ("grouped_bwd", 0, 4 * ms, 13), ("combine_bwd", 0, 1 * ms, 14),
              ("attention_bwd", 0, 9 * ms, 15)]
    profile = types.SimpleNamespace(host=host, device=device, steps=1)
    config = json.loads(CONFIG_FILE.read_text())
    counters = {"moe_routed_pairs_total": 6000.0, "moe_held_pairs_total": 1500.0,
                "moe_held_peak_pairs_total": 400.0}
    ctx = types.SimpleNamespace(profile=profile, counters=counters, config=config, flops=flops,
                                profiled=[(2, 500, [400, 600])])
    # forward 1 + 2, the recompute's 2, backward 4 + 1 (not the attention after the enter node)
    assert moe_ms.read(ctx) == pytest.approx(10.0)
    pairs = 1000 * 6 * 0.25  # a layer's: the step's slots x k x the held share
    flops_, bytes_ = flops.expert_work(pairs, 2048, 1408, 8)
    assert flops_ == 6 * 2048 * 1408 * 1500 and bytes_ == 2 * (2 * 2048 * 1500 + 8 * 3 * 2048 * 1408)
    bound = max(flops_ / 989e12, bytes_ / 3.35e12)
    assert expert_roofline.read(ctx) == pytest.approx(100 * 4 * bound * 26 / 8e-3)
    assert expert_load_peak.read(ctx) == pytest.approx(400 / (1500 / 8))
    assert expert_load_peak.read(types.SimpleNamespace(counters={}, config=config)) is None
