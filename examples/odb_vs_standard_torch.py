"""Compare all seven batching systems on one dataset (mini Table 1), on the
PyTorch port's schedules.

Every method builds its *real* schedule (real grouping, alignment and
padding, from ``repro_torch.data``); THE PAPER'S H20 COST MODEL turns the
schedules into indicative wall time.  It is a model of the paper's NVIDIA
H20 cluster, not a measurement of this card or of any run here: the
script runs no model, so ``--device`` only names the card the port would
use (checked as every entry point checks it).  The flow and the printout
of ``examples/odb_vs_standard.py``.

    PYTHONPATH=src python examples/odb_vs_standard_torch.py --dataset sharegpt4o
    PYTHONPATH=src python examples/odb_vs_standard_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence

from repro_torch.core import Group, OdbConfig
from repro_torch.core.metadata import step_metadata
from repro_torch.data import (
    LengthCache,
    bmt_schedule,
    get_dataset,
    gmt_schedule,
    hfg_schedule,
    odb_schedule,
    sorted_schedule,
    standard_schedule,
)
from repro_torch.device import resolve_device

# -----------------------------------------------------------------------------
# The paper's H20 step-cost model (a copy of ``benchmarks/common.py``'s; the
# port imports nothing of the JAX package's benchmarks).  A MODEL, not a
# measurement:
#
#     t_step = flops(padded area + attention) / (peak · MFU(useful tokens))
#              + max(0, t_comm - overlap_bwd) + t_fixed + dl_wait(D)
#
# MFU saturates with useful tokens per step; t_comm models the ZeRO-2
# gradient reduce over NVLink, overlapped with the backward; dl_wait models
# input-pipeline starvation hidden by the outstanding depth D, at the
# per-dataset host prep rates of the paper's App. I.
# -----------------------------------------------------------------------------

H20_PEAK = 148e12  # bf16 dense FLOP/s per H20 GPU
NVLINK_BW = 700e9  # effective all-reduce bytes/s
MFU_MAX = 0.42
X_HALF = 6144.0  # tokens/step at which MFU reaches half of max
T_FIXED = 0.035  # optimizer + launch + sync overhead (s)
COST_MODEL = "the paper's H20 cost model (a model of an H20 cluster, not a measurement of this card)"


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    n_params: float
    n_layers: int
    d_model: int

    @property
    def grad_bytes(self) -> float:
        return 2.0 * self.n_params  # bf16 grads


MODEL_8B = ModelProfile("qwen3vl-8b", 8.0e9, 36, 4096)

# Host preprocessing rates (samples/s/worker), from App. I cache-build rates.
PREP_RATE = {
    "ultrachat": 6700.0 / 4,
    "llava": 48.0,
    "sharegpt4o": 418.0 / 4,
    "mmmix": 200.0,
    "default": 500.0,
}


def step_flops(group: Group | None, model: ModelProfile, packed: bool = False) -> float:
    """Training FLOPs of one rank's batch: 6·N per padded token + attention."""
    if group is None:
        return 0.0
    if packed:
        area = group.real_tokens
        attn = sum(6.0 * model.n_layers * model.d_model * (s.length**2) for s in group.samples)
    else:
        area = group.padded_tokens
        attn = 6.0 * model.n_layers * model.d_model * group.size * (group.max_length**2)
    return 6.0 * model.n_params * area + attn


def step_time(step: Sequence[Group | None], model: ModelProfile, *, prep_rate: float = PREP_RATE["default"],
              num_workers: int = 4, depth: int = 1024, packed: bool = False) -> float:
    """Modelled wall time of one aligned step across W ranks (the slowest
    rank binds)."""
    flops = max(step_flops(g, model, packed) for g in step)
    useful = max((g.real_tokens if g else 0) for g in step)
    mfu = MFU_MAX * useful / (useful + X_HALF)
    compute = flops / (H20_PEAK * max(mfu, 1e-3))
    comm = model.grad_bytes * 2.0 / NVLINK_BW
    bwd_overlap = compute * 2.0 / 3.0
    samples = max((g.size if g else 0) for g in step)
    prep = samples / (prep_rate * num_workers)
    hidden = min(1.0, depth / max(samples * 4.0, 1.0))
    dl_wait = max(0.0, prep - compute) * (1.0 - hidden)
    return compute + max(0.0, comm - bwd_overlap) + T_FIXED + dl_wait


@dataclasses.dataclass
class ScheduleReport:
    method: str
    sam_per_s: float
    tok_per_s: float
    upd_per_epoch: int
    sam_per_upd: float
    tok_per_upd: float
    padding_pct: float
    wall_s: float


def evaluate_schedule(method: str, steps: list[list[Group | None]], model: ModelProfile, *,
                      prep_rate: float = PREP_RATE["default"], depth: int = 1024,
                      num_workers: int = 4, packed: bool = False) -> ScheduleReport:
    """The schedule's real counts, and its modelled time under the cost model."""
    total_time = 0.0
    samples = real_tokens = padded_tokens = 0
    for i, step in enumerate(steps):
        total_time += step_time(step, model, prep_rate=prep_rate, depth=depth,
                                num_workers=num_workers, packed=packed)
        md = step_metadata(i, step)
        samples += md.emitted_samples
        real_tokens += md.total_tokens
        padded_tokens += md.total_padded_tokens
    upd = len(steps)
    return ScheduleReport(
        method=method,
        sam_per_s=samples / total_time if total_time else 0.0,
        tok_per_s=real_tokens / total_time if total_time else 0.0,
        upd_per_epoch=upd,
        sam_per_upd=samples / upd if upd else 0.0,
        tok_per_upd=real_tokens / upd if upd else 0.0,
        padding_pct=100.0 * (1 - real_tokens / padded_tokens) if padded_tokens else 0.0,
        wall_s=total_time,
    )


def main(argv=None) -> str:
    """Build every schedule and print the table; returns the printout."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="sharegpt4o")
    ap.add_argument("--scale", type=float, default=0.03)
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--l-max", type=int, default=12288)
    ap.add_argument("--device", default=None, help="the CUDA card unless 'cpu' is given")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    lines: list[str] = []

    def say(line: str = "") -> None:
        print(line)
        lines.append(line)

    ds = get_dataset(args.dataset, scale=args.scale)
    lengths = ds.lengths()
    cache = LengthCache.build(ds)
    prep = PREP_RATE.get(args.dataset, PREP_RATE["default"])
    w = args.world

    reports = [
        evaluate_schedule("standard(bs=1)", standard_schedule(lengths, w, 1), MODEL_8B, prep_rate=prep),
        evaluate_schedule("sorted(bs=2)", sorted_schedule(lengths, w, 2), MODEL_8B, prep_rate=prep),
        evaluate_schedule("gmt-oracle*", gmt_schedule(cache, w, args.l_max), MODEL_8B, prep_rate=prep),
        evaluate_schedule("bmt-oracle*", bmt_schedule(cache, w, args.l_max), MODEL_8B, prep_rate=prep),
        evaluate_schedule("hfg-oracle*", hfg_schedule(cache, w, 2), MODEL_8B, prep_rate=prep),
    ]
    cfg = OdbConfig(l_max=args.l_max, buffer_size=1024, prefetch_factor=256, num_workers=4)
    steps, audit = odb_schedule(lengths, w, cfg)
    reports.append(evaluate_schedule("ODB (ours)", steps, MODEL_8B, prep_rate=prep, depth=cfg.depth))

    std = reports[0].sam_per_s
    say(f"\n{args.dataset} (N={len(lengths)}), W={w}, L_max={args.l_max}")
    say(f"sam/s and spd: {COST_MODEL}, for {MODEL_8B.name}")
    say(f"{'method':16s} {'sam/s':>8} {'spd':>6} {'pad%':>6} {'sam/upd':>8} {'upd/ep':>7}")
    for r in reports:
        say(
            f"{r.method:16s} {r.sam_per_s:>8.2f} {r.sam_per_s/std:>5.2f}x "
            f"{r.padding_pct:>6.2f} {r.sam_per_upd:>8.1f} {r.upd_per_epoch:>7}"
        )
    say("* offline oracle rows use a scalar length cache (construction excluded)")
    say(
        f"ODB cache build avoided; length-cache build took {cache.build_seconds:.2f}s host time "
        f"for {len(lengths)} samples (invalidated on any policy change)"
    )
    say(f"ODB audit: eta_identity={audit.eta_identity} eta_quota={audit.eta_quota}")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
