"""Mixture-of-Experts FFN: router, capacity dispatch, the batched expert
products, the weighted combine, the shared expert and the dense residual
MLP, on one device or with expert parallelism (EP) over the mesh's
``model`` axis; or, with ``moe_dispatch="dropless"``, every pair of the
experts held here computed through grouped products (:func:`dropless_ffn`).

The JAX package's ``moe_ffn``, token for token:

  * Router: fp32 softmax over the experts, top-k, renormalised (floor 1e-9).
    Ties go to the lower expert id, as ``lax.top_k`` breaks them.
  * Dispatch: the slot of a (token, choice) pair within its expert is a
    cumulative sum over the token-major flattened (T·k) one-hot of the
    rank's own experts, with a trash bucket for the others; pairs past the
    capacity are dropped (GShard semantics).  Every token is routed and
    counts toward capacity, padding of a packed prefill and free decode
    slots included, as in JAX.
  * Experts: batched products ``(E_loc, C, d) × (E_loc, d, ff)``.
  * Combine: each token's k gathered outputs, weighted, summed over k in a
    fixed order.  Kept pairs own distinct buffer cells, so the dispatch is a
    plain index write and the combine a sum over a (T, k, d) gather: no
    atomic add anywhere, and two runs on the card are bitwise equal.

With no mesh, no ``model`` axis or a ``model`` axis of 1, every expert runs
here with no collective (``dispatch_chunks`` is ignored, as in JAX).  With
``model`` = ep > 1 (the JAX package's ``shard_map`` body, executed per rank
over ``torch.distributed``): every rank of a ``model`` group holds the same
token rows (the activations are replicated over ``model``, as in JAX) and
its shard of the MoE tree (``launch/sharding.local_moe_params``): experts
``[e_start, e_start + E/ep)`` with ``e_start = index · E/ep``, and the
column (``w_in``, ``w_gate``) and row (``w_out``) slices of the shared
expert and the dense residual.  It routes its rows with the replicated
router, takes the capacity from its own token count (per chunk with
``dispatch_chunks`` > 1 when the tokens divide evenly), adds its slices of
the shared expert and the dense residual to its partial output, and one sum
over the ``model`` process group completes every token.  Capacity, and so
every kept and dropped pair, is the single-device branch's: a pair's slot
is counted among its own expert's pairs only.  The sum runs in the tokens'
dtype, as JAX's ``psum`` does (gloo and NCCL both sum bfloat16).

Gradients are the single-device MoE's: the sum is a ``torch.autograd``
Function whose backward is the identity (every rank already holds the
whole cotangent of the replicated output), and the tokens and the router
enter through one whose forward is the identity and whose backward sums
over ``model`` (each rank sees only its own experts' share of the
cotangent, its router share included).  A plain differentiable
``all_reduce`` would hand each rank ep times the cotangent.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch import obs
from repro_torch.models.layers import act_fn, dense_init

Params = dict[str, Any]


def make_moe_params(generator, cfg, dtype, device) -> Params:
    """fp32 router over all ``n_experts``; the slabs of the experts held
    (``cfg.experts_held``) are one draw repeated over the experts, as the
    JAX package initialises them."""
    e, d = cfg.experts_held, cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff

    def slab(d_in, d_out):
        return dense_init(generator, d_in, d_out, dtype, device)[None].repeat(e, 1, 1)

    p: Params = {
        "router": dense_init(generator, d, cfg.n_experts, torch.float32, device),
        "w_in": slab(d, ff),
        "w_gate": slab(d, ff),
        "w_out": slab(ff, d),
    }
    if cfg.n_shared_experts:
        width = ff * cfg.n_shared_experts
        p["shared"] = {
            "w_in": dense_init(generator, d, width, dtype, device),
            "w_gate": dense_init(generator, d, width, dtype, device),
            "w_out": dense_init(generator, width, d, dtype, device),
        }
    return p


def router_topk(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int, renormalize: bool = True):
    """(T, d) -> (T, k) fp32 weights and int64 ids, in descending weight
    with the lower id first among equal weights; the weights renormalised
    to sum 1 where ``renormalize``."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :top_k], ids[:, :top_k]
    if renormalize:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, ids


def moe_capacity(tokens_local: int, top_k: int, n_experts: int, factor: float) -> int:
    cap = int(tokens_local * top_k / max(n_experts, 1) * factor)
    return max((cap + 7) // 8 * 8, 8)


def _expert_ffn(buf, w_in, w_gate, w_out, act: str) -> torch.Tensor:
    """(E, C, d) x (E, d, ff) -> (E, C, d): the batched gated expert MLP."""
    h = torch.bmm(buf, w_in)
    g = torch.bmm(buf, w_gate)
    return torch.bmm(act_fn(act)(g) * h, w_out)


def dispatch_slots(ids: torch.Tensor, n_local: int, capacity: int, e_start: int = 0):
    """(T, k) global expert ids -> per (token, choice) pair, flattened
    token-major: the destination among the rank's experts ``[e_start,
    e_start + n_local)`` (``n_local`` = the trash bucket), the slot within
    it, and whether the pair is kept (its expert is local and has room)."""
    local = ids.reshape(-1) - e_start
    in_range = (local >= 0) & (local < n_local)
    safe_local = torch.where(in_range, local, n_local)
    onehot = torch.nn.functional.one_hot(safe_local, n_local + 1)
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=1)
    keep = in_range & (slot < capacity)
    dest_e = torch.where(keep, safe_local, n_local)
    dest_c = torch.where(keep, slot, 0)
    return dest_e, dest_c, keep


def dispatch_compute_combine(
    x_flat: torch.Tensor,  # (T, d) tokens
    weights: torch.Tensor,  # (T, k) fp32
    ids: torch.Tensor,  # (T, k) global expert ids
    w_in: torch.Tensor,  # (E_loc, d, ff) expert slab
    w_gate: torch.Tensor,
    w_out: torch.Tensor,  # (E_loc, ff, d)
    *,
    capacity: int,
    act: str,
    e_start: int = 0,
) -> torch.Tensor:
    """Scatter into capacity buffers → batched expert products → weighted
    combine; (T, d) in the tokens' dtype.  The slab holds experts
    ``[e_start, e_start + E_loc)``; the others contribute zero (the caller
    sums the partial outputs over the EP axis)."""
    t, k = ids.shape
    n_local, d = w_in.shape[0], x_flat.shape[-1]
    dest_e, dest_c, keep = dispatch_slots(ids, n_local, capacity, e_start)
    # Kept pairs own distinct (expert, slot) cells; every dropped pair writes
    # a zero into the trash cell (n_local, 0), which no expert reads.
    rows = x_flat[:, None, :].expand(t, k, d).reshape(t * k, d)
    rows = rows * keep[:, None].to(x_flat.dtype)
    buf = x_flat.new_zeros((n_local + 1, capacity, d)).index_put((dest_e, dest_c), rows)
    out_buf = _expert_ffn(buf[:n_local], w_in, w_gate, w_out, act)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1, capacity, d))], dim=0)
    gathered = out_buf[dest_e, dest_c]  # (T*k, d)
    w = (weights.reshape(-1) * keep).to(gathered.dtype)
    return (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)


def _dense_mlp(x_flat: torch.Tensor, p: Params, act: str) -> torch.Tensor:
    """The shared expert / the dense residual MLP (always gated), or its TP
    slice (columns of ``w_in``/``w_gate``, the rows of ``w_out``)."""
    h = x_flat @ p["w_in"]
    g = x_flat @ p["w_gate"]
    return (act_fn(act)(g) * h) @ p["w_out"]


def model_axis(mesh):
    """``(process group, ep, index)`` of this rank on the mesh's ``model``
    axis, or None when the MoE takes the single-device branch (no mesh, no
    ``model`` axis, or one of size 1)."""
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    ep = mesh.size(mesh.mesh_dim_names.index("model"))
    if ep == 1:
        return None
    return mesh.get_group("model"), ep, mesh.get_local_rank("model")


def ep_widths(cfg, ep: int) -> dict:
    """The per-rank widths of the EP branch: experts, and the TP slices of
    the shared expert and the dense residual.  Raises unless ``ep`` divides
    each of them (there is no floor and no fallback)."""
    ff = cfg.moe_d_ff or cfg.d_ff
    widths = {"n_experts": cfg.n_experts}
    if cfg.n_shared_experts:
        widths["shared"] = ff * cfg.n_shared_experts
    if cfg.dense_residual:
        widths["dense"] = cfg.d_ff
    bad = {k: v for k, v in widths.items() if v % ep}
    if bad:
        raise ValueError(f"{cfg.name}: a model axis of {ep} does not divide {bad}")
    return {k: v // ep for k, v in widths.items()}


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum of every rank's partial output over the ``model``
    group.  Backward: the identity, since every rank holds the whole
    cotangent of the replicated output."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone()
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterModel(torch.autograd.Function):
    """Forward: the identity.  Backward: the sum over the ``model`` group of
    the ranks' partial cotangents (each holds its own experts' share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


# ------------------------------------------------------------------------------
# Dropless dispatch to the experts held here
# ------------------------------------------------------------------------------

PAIR_COUNTERS = {
    "moe_routed_pairs_total": "(token, choice) pairs the routers scored: tokens x top_k, every MoE layer",
    "moe_held_pairs_total": "pairs whose expert is held here, all computed (dropless)",
    "moe_held_peak_pairs_total": "the busiest held expert's pairs, summed over the layers",
}


@contextlib.contextmanager
def _traced(name: str, on: bool):
    """A ``moe/...`` span of the tracer and a profiler range of the same
    name, while the tracer is on; nothing otherwise."""
    if not on:
        yield
        return
    with obs.span(name, cat="moe"), torch.profiler.record_function(name):
        yield


class _HeldExperts(torch.autograd.Function):
    """The held experts' SiLU-gated MLPs over their pairs' rows, sorted by
    expert, each product one ``torch._grouped_mm`` over the groups that
    ``offsets`` (int32 cumulative ends, one an expert) marks: three forward,
    six backward (three weight gradients, the activation's, two for the
    rows).  ``torch._grouped_mm`` runs fp32 and bf16 on the CPU (the
    tests) and bf16 on the card (the benchmark); it takes no fp64.  A
    Function so that its backward is one node (``_HeldExpertsBackward``)
    that a device trace can find; the forward keeps its two grouped
    products' outputs for the backward and recomputes the gate there."""

    @staticmethod
    def forward(ctx, rows, offsets, w_in, w_gate, w_out):
        h = torch._grouped_mm(rows, w_in, offs=offsets)
        g = torch._grouped_mm(rows, w_gate, offs=offsets)
        ctx.save_for_backward(rows, offsets, w_in, w_gate, w_out, h, g)
        return torch._grouped_mm(torch.nn.functional.silu(g) * h, w_out, offs=offsets)

    @staticmethod
    def backward(ctx, d_out):
        rows, offsets, w_in, w_gate, w_out, h, g = ctx.saved_tensors
        d_out = d_out.contiguous()
        act = torch.nn.functional.silu(g)
        # A weight gradient: each group's aᵀ·b (an empty group gives zeros).
        d_w_out = torch._grouped_mm((act * h).t(), d_out, offs=offsets)
        d_act = torch._grouped_mm(d_out, w_out.transpose(1, 2), offs=offsets)
        d_h = d_act * act
        d_g = torch.ops.aten.silu_backward(d_act * h, g)
        d_rows = (torch._grouped_mm(d_h, w_in.transpose(1, 2), offs=offsets)
                  + torch._grouped_mm(d_g, w_gate.transpose(1, 2), offs=offsets))
        d_w_in = torch._grouped_mm(rows.t(), d_h, offs=offsets)
        d_w_gate = torch._grouped_mm(rows.t(), d_g, offs=offsets)
        return d_rows, None, d_w_in, d_w_gate, d_w_out


class _MoeEnter(torch.autograd.Function):
    """The identity on the layer's tokens, applied while tracing: its
    backward node (``_MoeEnterBackward``) runs after every node of the MoE
    layer's backward, so a device trace can tell where that ends."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _MoeExit(torch.autograd.Function):
    """The identity on the layer's output, applied while tracing: its
    backward node (``_MoeExitBackward``) runs before every node of the MoE
    layer's backward.  It reads back the tensor it saved, so under
    per-layer checkpointing the layer's recompute runs inside this node and
    not among the MoE's own backward nodes."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors  # noqa: B018 -- unpacked for the recompute, see the docstring
        return g


def _sum_over_choices(rows: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """(P, d) pair rows -> (T, d): each token's cells of the token-major
    (T, k) grid ``cell`` (a pair's row, or P for a choice not held here,
    which reads a zero row), summed over k in order: no atomics, no sort."""
    padded = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    return padded[cell].sum(dim=1)


class _PairRows(torch.autograd.Function):
    """The tokens' rows of the held pairs (``x[token]``); the backward sums
    each token's pair gradients over k in a fixed order (autograd's index
    backward would sort and accumulate them)."""

    @staticmethod
    def forward(ctx, x, token, cell):
        ctx.save_for_backward(cell)
        return x[token]

    @staticmethod
    def backward(ctx, g):
        (cell,) = ctx.saved_tensors
        return _sum_over_choices(g, cell), None, None


class _Combine(torch.autograd.Function):
    """The weighted pair outputs summed into their tokens
    (:func:`_sum_over_choices`); the backward hands each pair its token's
    gradient, a gather (autograd's would accumulate the choices not held
    here into one padding row)."""

    @staticmethod
    def forward(ctx, out, token, cell):
        ctx.save_for_backward(token)
        return _sum_over_choices(out, cell)

    @staticmethod
    def backward(ctx, g):
        (token,) = ctx.saved_tensors
        return g[token], None, None


def held_pairs(ids: torch.Tensor, start: int, held: int):
    """(T, k) global expert ids -> the flat (token-major) pair ids in the
    order of their experts, the pairs of experts ``[start, start + held)``
    first (token order within an expert), and (held,) int32 cumulative ends
    of each held expert's pairs in that order, and each one's count."""
    local = ids.reshape(-1) - start
    key = torch.where((local >= 0) & (local < held), local, held)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=held + 1)[:held]
    return order, torch.cumsum(counts, 0).to(torch.int32), counts


def _counts_later(values: torch.Tensor):
    """A function that returns ``values`` (a few int64 on the device) as
    host ints.  On the card the copy is queued now and waited for when the
    function is called, so the card goes on with the work queued between."""
    if not values.is_cuda:
        now = values.tolist()
        return lambda: now
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host.tolist()

    return wait


def dropless_ffn(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """(B, S, d) -> (B, S, d): the MoE of a chip that holds experts
    ``[moe_held_start, moe_held_start + experts_held)`` of the router's
    ``n_experts``, with no capacity: every token is routed over all the
    experts (fp32 softmax, greedy top-k, renormalised where the config says),
    every (token, choice) pair of a held expert
    is computed, sorted by expert, through one grouped product per
    projection (:class:`_HeldExperts`), and each token's pairs are summed
    over k in a fixed order, forward and backward (:class:`_PairRows`,
    :class:`_Combine`); the pairs of experts held elsewhere add nothing.
    The shared experts are added once.

    The count of held pairs sizes the grouped products, so the host reads
    it once a layer: the copy is queued before the shared experts and
    waited for after them, so the card is not left idle meanwhile.  While
    the tracer is on: the spans ``moe/layer``, ``moe/route`` and
    ``moe/experts`` (with profiler ranges of the same names), the boundary
    nodes ``_MoeEnter``/``_MoeExit``, and the counters of
    :data:`PAIR_COUNTERS`, counted in the forward and not in its recompute."""
    if cfg.act != "silu":
        raise ValueError(f"{cfg.name}: dropless dispatch computes SiLU-gated experts, not {cfg.act!r}")
    b, s, d = x.shape
    k, held = cfg.top_k, cfg.experts_held
    traced = obs.default_tracer().enabled
    with _traced("moe/layer", traced):
        x_flat = x.reshape(-1, d)
        if traced:
            x_flat = _MoeEnter.apply(x_flat)
        t = x_flat.shape[0]
        with _traced("moe/route", traced):
            weights, ids = router_topk(x_flat, params["router"], k, cfg.moe_renormalize)
            order, offsets, counts = held_pairs(ids, cfg.moe_held_start, held)
            total = offsets[-1:].long()
            read_counts = _counts_later(torch.cat([total, counts.max()[None]]) if traced else total)
        shared = _dense_mlp(x_flat, params["shared"], cfg.act) if "shared" in params else None
        n_pairs, *peak = read_counts()
        pairs = order[:n_pairs]
        token = pairs // k
        # Each pair's row of the token-major (T, k) grid; n_pairs where the
        # choice is not held here.
        cell = torch.full((t * k,), n_pairs, dtype=torch.long, device=x.device)
        cell[pairs] = torch.arange(n_pairs, device=x.device)
        cell = cell.view(t, k)
        rows = _PairRows.apply(x_flat, token, cell)
        with _traced("moe/experts", traced):
            out = _HeldExperts.apply(rows, offsets, params["w_in"], params["w_gate"], params["w_out"])
        out = out * weights.reshape(-1)[pairs].to(out.dtype)[:, None]
        y = _Combine.apply(out, token, cell)
        if shared is not None:
            y = y + shared
        if traced:
            if torch._C._current_graph_task_id() == -1:  # the forward, not a recompute in the backward
                for name, value in zip(PAIR_COUNTERS, (t * k, n_pairs, *peak)):
                    obs.counter(name, help=PAIR_COUNTERS[name]).inc(value)
            y = _MoeExit.apply(y)
    return y.reshape(b, s, d).to(x.dtype)


def moe_ffn(params: Params, x: torch.Tensor, cfg, mesh=None, dense_params: Params | None = None,
            dispatch_chunks: int = 1) -> torch.Tensor:
    """(B, S, d) -> (B, S, d): routed experts, plus the shared expert when the
    tree has one and the dense residual branch (Arctic) when given; EP over
    the mesh's ``model`` axis when it is larger than 1, with ``params`` and
    ``dense_params`` the rank's shard (see the module docstring)."""
    b, s, d = x.shape
    axis = model_axis(mesh)
    if cfg.moe_dispatch == "dropless":
        if axis is not None or dense_params is not None:
            raise NotImplementedError("dropless dispatch runs the experts held here, with no EP exchange "
                                      "(moe_held, moe_held_start give a chip's share) and no dense residual")
        return dropless_ffn(params, x, cfg)
    if not cfg.moe_renormalize:
        raise NotImplementedError("capacity dispatch renormalises the top-k weights; "
                                  "moe_renormalize=False runs with moe_dispatch='dropless'")
    router, e_start, chunks = params["router"], 0, 1
    if axis is not None:
        group, ep, index = axis
        n_local = ep_widths(cfg, ep)["n_experts"]
        if params["w_in"].shape[0] != n_local:
            raise ValueError(f"EP over {ep} ranks wants {n_local} experts a rank, the slab holds "
                             f"{params['w_in'].shape[0]}: hand moe_ffn the rank's shard "
                             "(launch.sharding.local_moe_params)")
        e_start, chunks = index * n_local, dispatch_chunks
        x = _EnterModel.apply(x, group)
        router = _EnterModel.apply(router, group)
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    weights, ids = router_topk(x_flat, router, cfg.top_k)
    slabs = (params["w_in"], params["w_gate"], params["w_out"])
    if chunks > 1 and t % chunks == 0:
        cap = moe_capacity(t // chunks, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        y = torch.cat([
            dispatch_compute_combine(xc, wc, ic, *slabs, capacity=cap, act=cfg.act, e_start=e_start)
            for xc, wc, ic in zip(x_flat.chunk(chunks), weights.chunk(chunks), ids.chunk(chunks))
        ])
    else:
        cap = moe_capacity(t, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        y = dispatch_compute_combine(x_flat, weights, ids, *slabs, capacity=cap, act=cfg.act,
                                     e_start=e_start)
    if "shared" in params:
        y = y + _dense_mlp(x_flat, params["shared"], cfg.act)
    if dense_params is not None:
        y = y + _dense_mlp(x_flat, dense_params, cfg.act)
    if axis is not None:
        y = _SumOverModel.apply(y, axis[0])
    return y.reshape(b, s, d).to(x.dtype)
