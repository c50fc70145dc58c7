"""Perf hillclimb: re-run a dry-run cell under an optimization
variant and report the roofline-term deltas against the baseline record.

    PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen3_0_6b:train_4k_packed \\
        --variant remat_dots

Variants (config-level levers, the JAX package's):
  headshard   attn_head_constraint=True   (uneven head sharding annotation)
  ce_bf16     logits_fp32=False           (bf16 logits + cross-entropy)
  sp          sequence_sharding=True      (sequence-parallel residual stream)
  sp_ce       sp + ce_bf16
  all         headshard + sp + ce_bf16
  remat_none  remat="none"                (no rematerialization)
  remat_dots  remat="dots"                (save matmul outputs only)

The port reads ``remat`` and ``logits_fp32``.  ``attn_head_constraint`` and
``sequence_sharding`` are GSPMD annotations with no effect of their own on
an eager program: a variant that sets them records them under
``"unmodelled"``, and their share of the deltas reads 0.  The baseline
record is run first when ``artifacts/dryrun_torch`` holds none.
"""

from __future__ import annotations

import argparse
import json

VARIANTS = {
    "headshard": {"attn_head_constraint": True},
    "ce_bf16": {"logits_fp32": False},
    "sp": {"sequence_sharding": True},
    "sp_ce": {"sequence_sharding": True, "logits_fp32": False},
    "all": {
        "attn_head_constraint": True,
        "sequence_sharding": True,
        "logits_fp32": False,
    },
    "sp_ce_dots": {
        "sequence_sharding": True,
        "logits_fp32": False,
        "remat": "dots",
    },
    "remat_none": {"remat": "none"},
    "remat_dots": {"remat": "dots"},
}
UNMODELLED = ("attn_head_constraint", "sequence_sharding")


def main() -> None:
    from repro_torch.launch.dryrun import ARTIFACT_DIR, run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", required=True, choices=sorted(VARIANTS))
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()

    arch, shape = args.cell.split(":")
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    base_path = ARTIFACT_DIR / f"{arch}__{shape}__{args.mesh}.json"
    base = json.loads(base_path.read_text()) if base_path.exists() else None
    if base is None or base.get("status") != "ok":
        base = run_cell(arch, shape, args.mesh)
        base_path.write_text(json.dumps(base, indent=2, default=str))

    variant = VARIANTS[args.variant]
    rec = run_cell(arch, shape, args.mesh, variant=variant, tag=args.variant)
    rec["unmodelled"] = [k for k in variant if k in UNMODELLED]
    out = ARTIFACT_DIR / f"{arch}__{shape}__{args.mesh}__{args.variant}.json"
    out.write_text(json.dumps(rec, indent=2, default=str))
    if rec["status"] != "ok":
        print(f"variant FAILED: {rec.get('error')}")
        raise SystemExit(1)

    if base.get("status") == "ok":
        b, v = base["roofline"], rec["roofline"]
        print(f"\n{arch} × {shape} × {args.mesh}: baseline → {args.variant}"
              + (f" (unmodelled: {', '.join(rec['unmodelled'])})" if rec["unmodelled"] else ""))
        for term in ("compute_s", "memory_s", "collective_s"):
            delta = (v[term] - b[term]) / b[term] * 100 if b[term] else float("nan")
            print(f"  {term:14s} {b[term]:.3e} → {v[term]:.3e}  ({delta:+.1f}%)")
        bt = max(b["compute_s"], b["memory_s"], b["collective_s"])
        vt = max(v["compute_s"], v["memory_s"], v["collective_s"])
        print(f"  bound_time     {bt:.3e} → {vt:.3e}  ({(vt-bt)/bt*100:+.1f}%)")
        print(f"  roofline_frac  {b['roofline_fraction']:.4f} → {v['roofline_fraction']:.4f}")
        print(f"  GiB/device     {base['bytes_per_device'] / 2**30:.1f} → "
              f"{rec['bytes_per_device'] / 2**30:.1f}")


if __name__ == "__main__":
    main()
