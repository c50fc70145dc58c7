"""The control and a planted fault of the correctness check, at a cell's own
size: the readings that set the upper side of each limit.

    python3 odb_bench/control.py --workload qwen3_0_6b.sharegpt4o --seeds 11 12 13

For each seed, the program's data path (host only) delivers the cell's
first steps; the float32 reference trains on them from the seed's weights
(the side every run compares with), and two stand-ins are put in the
program's place and compared with it exactly as a run compares the program:

  * ``fp8``: the same reference with every projection's inputs in fp8
    (e4m3, one scale per tensor), the precision below the configuration's
    bf16 that a later change might reach for;
  * ``half_batch``: the reference on half of each step's batch (the first
    ranks' rows), its loss the mean over the rest.

Each stand-in is judged against the cell's committed limits
(``limits/<cell>.json``) by the comparison a run uses: it is correct only
if every number is within its limit.  The command exits 1 if a stand-in
comes out correct on any seed.  A state left unchanged reads 1 on the
change and gradient gaps by definition and needs no run; an altered token
is an exact data fault.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def control_readings(name: str, config: dict, traffic: dict, seed: int, device) -> dict:
    """{variant: {number: reading}} for one seed."""
    from odb_bench import harness, weights
    from odb_bench.reference import data as ref_data

    cfg = harness.port_config(config)
    specs = harness.leaf_specs(cfg)
    records = harness.make_records(config, traffic, seed)
    loader = harness.make_loader(name, config, traffic, records, seed, cfg.vocab_size)
    checker = ref_data.DataCheck(records, traffic["pipeline"], traffic["cutoff"], seed, cfg.vocab_size)
    steps = []
    it = loader.streaming_epoch(0, finalize_audit=False)
    for i, ls in zip(range(harness.WARMUP_STEPS), it):
        ranks = [{k: getattr(b, k) for k in harness.ARRAYS} for b in ls.batches]
        md = ls.metadata
        steps.append(checker.step(i, ranks, md.samples_per_rank, md.tokens_per_rank)[1])
    it.close()
    family = importlib.import_module(f"odb_bench.reference.{config['run']['family']}")
    start = [w.cpu() for w in weights.make(specs, seed, device)]
    ref = harness.reference_readings(family, config, specs, start, device, steps)
    counted = harness.counted_leaves(ref["grad"])
    half = [[(r, t) for r, t in s if r < config["run"]["world"] // 2] for s in steps]
    out = {"data_faults": len(checker.faults)}
    for variant, samples, quant in (("fp8", steps, "fp8"), ("half_batch", half, None)):
        stand_in = harness.reference_readings(family, config, specs, start, device, samples, quant)
        out[variant] = harness.compare(stand_in, ref, counted)
    return out


def judged(readings: dict, limits: dict) -> dict:
    """{variant: correct} under the limits, as a run judges the program."""
    return {variant: all(v <= limits[k] for k, v in numbers.items() if k in limits)
            for variant, numbers in readings.items() if isinstance(numbers, dict)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from odb_bench import run

    if not torch.cuda.is_available():
        raise SystemExit("control: no CUDA device")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, config, traffic, _, _, limits = run.load_cell(manifest, args.workload)
    passed = []
    for seed in args.seeds:
        readings = control_readings(args.workload, config, traffic, seed, "cuda")
        correct = judged(readings, limits)
        print(json.dumps({"workload": args.workload, "seed": seed, **readings, "correct": correct}), flush=True)
        passed += [(seed, variant) for variant, ok in correct.items() if ok]
        torch.cuda.empty_cache()
    if passed:
        print(f"control: stand-ins came out correct: {passed}", file=sys.stderr)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
