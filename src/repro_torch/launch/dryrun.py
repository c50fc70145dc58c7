"""Multi-pod dry run: every (arch x shape x mesh) cell's per-device program,
counted on the meta device.

For each cell:

  1. build the production mesh (16x16 single-pod, 2x16x16 two-pod) under a
     fake process group of its size, then the step's meta stand-ins and
     their placements (``launch/steps.py``);
  2. check that every placement divides its dimension (the rules fall back
     to replication, so a failure here is a bug);
  3. run the local program once on the meta device under
     ``roofline/cost.py``: the step on the rows of one data shard through
     unsharded layers.  Per device, the counted FLOPs and bytes of the model
     are divided by the TP degree and the optimizer's by the shards of the
     weights; the activation peak is not divided, so it is an upper bound;
  4. sum the bytes one device holds: its shards of the weights, the
     optimizer moments, the gradients, the batch and the caches, plus the
     activation peak of 3; model the collectives from the sharding rules
     (:func:`modelled_collectives`); and write one JSON record per cell
     under ``artifacts/dryrun_torch/`` with the roofline at an H100's peaks.

Depth: every unit of a stack does the same work, so the local program is
counted at one and at two units (a leading prefix kept whole) and the
counts are extrapolated linearly to the model's units.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--list] [--force]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
import torch.fx.experimental._config

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import sharding as shr
from repro_torch.launch.mesh import (
    dp_axes,
    fake_world,
    make_host_mesh,
    make_production_mesh,
    mesh_shape,
    production_world,
    tp_size,
)
from repro_torch.launch.shapes import SHAPE_ORDER, SHAPES, ShapeCell, applicability
from repro_torch.launch.steps import (
    abstract_caches,
    build_decode_step,
    build_prefill_step,
    build_train_step,
)
from repro_torch.models.blocks import stack_plan
from repro_torch.models.model import LM
from repro_torch.roofline.analysis import model_flops_for_cell, roofline_from_artifacts
from repro_torch.roofline.cost import count
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves

ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
DEVICE_BYTES = 80 * 2**30  # an H100 80GB
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
HBM_NOTE = "every aten op's inputs and outputs, nothing fused: an upper bound on traffic"
ACTIVATION_BOUND = "upper, not split over model"


def opt_config_for(cfg) -> OptimizerConfig:
    # bf16 moments for the giants: the memory lever.
    mdt = "bfloat16" if cfg.param_count() > 8e9 else "float32"
    return OptimizerConfig(moment_dtype=mdt)


def builder_for(model: LM, mesh, cell):
    if cell.kind == "train":
        return build_train_step(model, mesh, cell, opt_config_for(model.cfg))
    if cell.kind == "prefill":
        return build_prefill_step(model, mesh, cell)
    return build_decode_step(model, mesh, cell)


def _mesh(mesh_name: str):
    """A production mesh, or ``"DxM"``: a ``(data, model)`` mesh of D x M
    ranks.  Needs a process group of its size."""
    if mesh_name in ("single", "multi"):
        return make_production_mesh(multi_pod=mesh_name == "multi")
    return make_host_mesh(int(mesh_name.split("x")[1]))


def _world(mesh_name: str) -> int:
    if mesh_name in ("single", "multi"):
        return production_world(mesh_name == "multi")
    return math.prod(int(n) for n in mesh_name.split("x"))


def _nbytes(t, spec, mesh) -> int:
    return math.prod(shr.local_shape(tuple(t.shape), spec, mesh)) * t.element_size()


def _leaves(tree, specs) -> list:
    """(path, tensor, spec) of every leaf; ``specs`` has the tree's shape."""
    spec_of = {tuple(p): s for p, s in shr.tree_leaves_with_path(specs)}
    return [(p, t, spec_of[tuple(p)]) for p, t in shr.tree_leaves_with_path(tree) if t is not None]


def _bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs``."""
    return sum(_nbytes(t, spec, mesh) for _, t, spec in _leaves(tree, specs))


def check_placements(args, placements, mesh) -> int:
    """Every placement divides its dimension; returns the leaves checked."""
    size = mesh_shape(mesh)
    pl = {tuple(p): x for p, x in shr.tree_leaves_with_path(list(placements))}
    n = 0
    for path, t in shr.tree_leaves_with_path(list(args)):
        if t is None:
            continue
        spec = shr.spec_of(pl[tuple(path)], mesh)
        for d, entry in enumerate(spec):
            parts = math.prod(size[a] for a in shr.spec_axes(entry))
            if t.shape[d] % parts:
                raise ValueError(f"{'/'.join(path)}: dim {d} of {tuple(t.shape)} does not divide "
                                 f"over {entry} ({parts})")
        n += 1
    return n


def modelled_collectives(cfg, cell, mesh, params, pspecs, rows: int) -> dict:
    """Operand bytes of the collectives of one step on one device, from the
    sharding rules, in the JAX convention (each collective's operand bytes on
    one device).  This is the port's model of what GSPMD inserts for these
    specs, not a reading of a compiled program (there is none):

    * FSDP: per leaf stored over ``data``, an all-gather of its shard in the
      forward, one more in the backward under ``remat`` "full" or "dots",
      and a reduce-scatter of its gradient (the shard gathered over ``data``);
    * gradient reduction: an all-reduce of the leaf's local gradient over
      each pure-DP axis the leaf is replicated on;
    * TP: on ``model``, an all-reduce of the layer's ``(rows, S, d_model)``
      activations after each row-parallel projection (``wo``, ``out_proj``,
      a dense ``w_out``) and one after the MoE (its shared expert and dense
      residual summed in), in the forward, and as many in the backward.

    Not modelled: the lookup in the vocab-sharded embedding and the loss's
    reductions over the vocab.  The MoE's dispatch needs no collective: in
    both packages its EP is local to the rank (every rank of a ``model``
    group holds the same rows, routes them with the replicated router and
    runs its own experts), so its only collective is the one sum after the
    MoE, counted above with the TP all-reduces."""
    size = mesh_shape(mesh)
    per = dict.fromkeys(COLLECTIVE_OPS, 0.0)
    counts = dict.fromkeys(COLLECTIVE_OPS, 0)

    def add(op: str, nbytes: float, n: int = 1) -> None:
        per[op] += nbytes * n
        counts[op] += n

    train = cell.kind == "train"
    for path, t, spec in _leaves(params, pspecs):
        local = _nbytes(t, spec, mesh)
        used = {a for entry in spec for a in shr.spec_axes(entry)}
        if "data" in used:
            add("all-gather", local, 2 if train and cfg.remat in ("full", "dots") else 1)
            if train:
                add("reduce-scatter", local * size["data"])
        if train:
            for a in dp_axes(mesh):
                if a not in used:
                    add("all-reduce", local)
    if size.get("model", 1) > 1:
        seq = 1 if cell.kind == "decode" else cell.seq_len
        activation = rows * seq * cfg.d_model * getattr(torch, cfg.dtype).itemsize
        sites = 0
        for layer, lspec in zip(params["layers"], pspecs["layers"]):
            mixer = lspec.get("mixer", {})
            sites += any(mixer.get(k, (None,))[0] == "model" for k in ("wo", "out_proj"))
            if "moe" in layer:
                sites += lspec["moe"]["w_out"][0] == "model"
            elif "mlp" in layer:
                sites += lspec["mlp"]["w_out"][0] == "model"
        add("all-reduce", activation, sites * (2 if train else 1))
    out = dict(per, ops=sum(counts.values()), per_op_counts=counts)
    out["coll_bytes"] = sum(per.values())
    return out


def _depth_cut(cfg, units: int):
    plan = stack_plan(cfg)
    return dataclasses.replace(cfg, n_layers=len(plan.prefix_layers) + units * len(plan.unit_layers[0]))


def _local_cost(cfg, cell: ShapeCell, mesh, rows: int):
    """The local program's cost at full depth: counted at one and two units
    and extrapolated linearly (or counted whole when the stack has at most
    two units).  Returns (cost, depth record)."""
    local_cell = dataclasses.replace(cell, global_batch=rows)
    units = stack_plan(cfg).n_units

    def run(c):
        fn, args, _ = builder_for(LM(c, device="meta"), mesh, local_cell)
        state = tree_leaves(args[0]["params"]) if cell.kind == "train" else ()
        if cell.kind != "prefill":
            return count(fn, *args, state=state)
        # ``LM.prefill`` scatters every row's K/V through a boolean mask that
        # is all true there (row i into slot i, positions below max_len); the
        # meta device needs to be told so.
        with torch.fx.experimental._config.patch(meta_nonzero_assume_all_nonzero=True):
            return count(fn, *args, state=state)

    if units <= 2:
        return run(cfg), {"units": units, "counted_units": [units]}
    one, two = run(_depth_cut(cfg, 1)), run(_depth_cut(cfg, 2))
    return one.scaled(two, units - 1), {"units": units, "counted_units": [1, 2],
                                         "extrapolated": "linear in units"}


def _cell_record(arch: str, shape: str, mesh_name: str, cfg, cell: ShapeCell, mesh) -> dict:
    chips = math.prod(mesh.shape)
    tp = tp_size(mesh)
    model = LM(cfg, device="meta")
    fn, args, placements = builder_for(model, mesh, cell)
    leaves = check_placements(args, placements, mesh)

    train, decode = cell.kind == "train", cell.kind == "decode"
    params = args[0]["params"] if train else args[0]
    pspecs = shr.param_specs(params, cfg, mesh)
    weights = _bytes(params, pspecs, mesh)
    parts = dict(params=weights, opt_moments=0, grads=0, batch=0, caches=0)
    if train:
        opt, batch = args[0]["opt"], args[1]
        parts.update(opt_moments=_bytes(opt, shr.opt_state_specs(opt, pspecs), mesh), grads=weights,
                     batch=_bytes(batch, shr.batch_specs(batch, mesh), mesh))
    else:
        # a prefill returns the caches the decode reads: they are its output
        caches = args[1] if decode else abstract_caches(model, cell.global_batch, cell.seq_len) \
            if cfg.has_decode and not cfg.input_embeds else []
        tokens = args[2] if decode else args[1]
        parts.update(batch=_bytes(tokens, shr.batch_specs(tokens, mesh), mesh)
                     + (args[3].nbytes if decode else 0),  # cache_index
                     caches=_bytes(caches, shr.cache_specs(caches, cfg, mesh), mesh))

    dp = shr.batch_dp_axes(cell.global_batch, mesh)
    rows = cell.global_batch // math.prod(mesh_shape(mesh)[a] for a in (dp or ()))
    cost, depth = _local_cost(cfg, cell, mesh, rows)
    parts["activations"] = cost.peak_bytes
    per_device = sum(parts.values())

    # The model's work splits over `model`; the optimizer's over the shards
    # of the weights.
    total_param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    weight_share = parts["params"] / total_param_bytes
    flops = (cost.flops - cost.update_flops) / tp + cost.update_flops * weight_share
    hbm = (cost.hbm_bytes - cost.update_bytes) / tp + cost.update_bytes * weight_share
    coll = modelled_collectives(cfg, cell, mesh, params, pspecs, rows)
    parsed = {"flops": flops, "hbm_bytes": hbm, "coll_bytes": coll["coll_bytes"],
              "transcendentals": None}
    terms = roofline_from_artifacts(arch, shape, mesh_name, chips, parsed,
                                    model_flops_for_cell(cfg, cell))
    params_bytes = cfg.param_count() * 2.0 / chips  # bf16, fully sharded ideal
    useful_bytes = params_bytes * (3 + 2 + 4) if train else params_bytes
    return dict(
        leaves_checked=leaves,
        local_rows=rows,
        depth=depth,
        moment_dtype=opt_config_for(cfg).moment_dtype if train else None,
        bytes_per_device=per_device,
        bytes_parts=parts,
        activation_bound=ACTIVATION_BOUND,
        fits=per_device <= DEVICE_BYTES,
        device_bytes=DEVICE_BYTES,
        counted={"flops": cost.flops, "hbm_bytes": cost.hbm_bytes, "peak_bytes": cost.peak_bytes,
                 "update_flops": cost.update_flops, "update_bytes": cost.update_bytes,
                 "ops": cost.ops, "tp": tp, "weight_share": weight_share},
        hbm_note=HBM_NOTE,
        parsed_cost=parsed,
        per_collective={k: coll[k] for k in (*COLLECTIVE_OPS, "ops", "per_op_counts")},
        collective_note="modelled from the sharding rules (modelled_collectives), not read "
                        "from a compiled program",
        roofline=dict(terms.row(), mem_useful_ratio=useful_bytes / hbm if hbm else 0.0),
    )


def run_cell(
    arch: str,
    shape: str,
    mesh_name: str,
    *,
    verbose: bool = True,
    variant: dict | None = None,
    tag: str = "",
    cfg=None,
    cell: ShapeCell | None = None,
) -> dict:
    """One cell's record: ``status`` "ok", "skip" (with JAX's reason) or
    "error".  ``mesh_name`` is "single", "multi" or "DxM"; ``cfg`` and
    ``cell`` stand in for the arch's config and the named shape (tests run
    smoke configs at small shapes)."""
    cfg = cfg or get_config(arch)
    if variant:
        cfg = dataclasses.replace(cfg, **variant)
    cell = cell or SHAPES[shape]
    ok, reason = applicability(cfg, shape) if shape in SHAPES else (True, "")
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "skip", "reason": reason}
    record: dict = {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": _world(mesh_name)}
    if tag:
        record["tag"] = tag
    t0 = time.time()
    try:
        with fake_world(_world(mesh_name)):
            record.update(_cell_record(arch, shape, mesh_name, cfg, cell, _mesh(mesh_name)))
    except Exception as exc:  # a failure here is a bug in the system
        record.update(status="error", error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-4000:])
        return record
    record.update(status="ok", run_s=round(time.time() - t0, 2))
    if verbose:
        terms = record["roofline"]
        print(
            f"[{arch} × {shape} × {mesh_name}] run {record['run_s']:.1f}s | "
            f"{record['bytes_per_device'] / 2**30:.2f} GiB/device (fits 80 GiB: {record['fits']}) | "
            f"flops {terms['hlo_flops']:.3e} | hbm {terms['hlo_bytes']:.3e} B (upper) | "
            f"coll {terms['coll_bytes']:.3e} B | dominant={terms['dominant']} | "
            f"roofline_frac={terms['roofline_fraction']:.3f}",
            flush=True,
        )
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPE_ORDER)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list:
        for a in archs:
            cfg = get_config(a)
            for s in shapes:
                ok, reason = applicability(cfg, s)
                print(f"{a:18s} {s:12s} {'RUN' if ok else 'SKIP: ' + reason}")
        return

    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    failures = 0
    for a in archs:
        for s in shapes:
            for m in meshes:
                out = ARTIFACT_DIR / f"{a}__{s}__{m}.json"
                if out.exists() and not args.force:
                    cached = json.loads(out.read_text())
                    if cached.get("status") in ("ok", "skip"):
                        print(f"[{a} × {s} × {m}] cached: {cached['status']}", flush=True)
                        continue
                rec = run_cell(a, s, m)
                out.write_text(json.dumps(rec, indent=2, default=str))
                if rec["status"] == "error":
                    failures += 1
                    print(f"[{a} × {s} × {m}] ERROR: {rec['error']}", flush=True)
                elif rec["status"] == "skip":
                    print(f"[{a} × {s} × {m}] SKIP: {rec['reason']}", flush=True)
    print(f"dry-run complete; {failures} failures", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
