"""Run one cell of the port's benchmark on this machine's card(s).

    python3 odb_bench/run.py --workload qwen3_0_6b.sharegpt4o --seed 12345 --seconds 30 --trace 0

Run from the root of a checkout.  The cell, its configuration and its
traffic are found by name from ``BENCHMARK.json``; the process re-runs
itself with ``PYTHONHASHSEED=0``.  Without a CUDA card (or with fewer than
the cell asks for) it fails and prints no result.  ``--trace 0`` prints the
end-to-end metrics, ``--trace 1`` the per-layer ones with the device's busy
time and a breakdown.  The last line of standard output is the result, a
JSON object; the last lines of standard error are the numbers that decided
``correct``, each beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import sys
import time

T0 = time.time()
HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(message: str, code: int = 2):
    print(f"[odb_bench] {message}", file=sys.stderr)
    raise SystemExit(code)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def load_cell(manifest: dict, workload: str):
    """(cell, configuration, traffic, window, per-layer readers, limits) by name."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    window = json.loads((HERE / "cells" / f"{workload}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    readers = {m["name"]: importlib.import_module(f"odb_bench.metrics.{m['name']}")
               for m in manifest["per_layer"] if workload in m.get("workloads", [workload])}
    return cell, config, traffic, window, readers, limits


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    if os.environ.get("PYTHONHASHSEED") != "0":
        sys.stdout.flush()
        env = {**os.environ, "PYTHONHASHSEED": "0", "ODB_BENCH_T0": repr(T0)}
        os.execve(sys.executable, [sys.executable, str(pathlib.Path(__file__).resolve()), *argv], env)
    t_start = float(os.environ.get("ODB_BENCH_T0", T0))
    build = ROOT / "build" / "odb_bench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    manifest_path = ROOT / "BENCHMARK.json"
    if not manifest_path.is_file() or not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"run from a checkout: no BENCHMARK.json or src/repro_torch under {ROOT}")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    manifest = json.loads(manifest_path.read_text())
    cell, config, traffic, window, readers, limits = load_cell(manifest, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    card = power_limit()
    print(f"[odb_bench] card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}", file=sys.stderr)

    from odb_bench import harness

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    out = harness.run_cell(args.workload, config, traffic, window, args.seed, args.seconds, bool(args.trace),
                           readers, limits, device="cuda", t_start=t_start, log=log)
    found = banned_modules()
    if found:
        fail(f"the process holds {found} once the window has closed", code=3)
    units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out["peak_bytes"], "power": card}
    if args.trace:
        device.update(busy_s=out["info"]["busy_s"], window_s=out["info"]["traced_window_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in out["metrics"].items()},
              "device": device}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for key, v in out["checks"].items():
        print(f"check {key} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()


if __name__ == "__main__":
    main()
