"""Serving launcher: continuous batching on the ODB admission core.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \
        --requests 24 --slots 8 --max-len 256 --l-max 1024

Runs on the CUDA card; ``--device cpu`` (with ``--smoke`` for the reduced
config) runs the same engine on the CPU, where attention takes its plain
path.  Weights are random, drawn from ``--seed``.  ``--mode static`` runs the
same steps in drain-before-refill mode for an A/B on the same request trace.
``--telemetry DIR`` writes metrics.json and trace.json at exit;
``--telemetry-port`` serves ``GET /metrics`` while the engine runs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, synth_request_trace


def main(argv=None):
    """Serve the trace; returns the engine (its requests and stats) and the
    wall seconds of the run, as ``_serve`` does."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-min", type=int, default=8)
    ap.add_argument("--prompt-max", type=int, default=96)
    ap.add_argument("--new-min", type=int, default=2)
    ap.add_argument("--new-max", type=int, default=48)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--l-max", type=int, default=1024)
    ap.add_argument("--lookahead", type=int, default=32)
    ap.add_argument("--mode", default="continuous", choices=("continuous", "static"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument(
        "--telemetry", default=None, metavar="DIR",
        help="enable the obs subsystem and write metrics.json / trace.json "
             "into DIR at exit (DESIGN.md §13)",
    )
    ap.add_argument(
        "--telemetry-port", type=int, default=None, metavar="PORT",
        help="serve a live Prometheus scrape endpoint (GET /metrics) from a "
             "daemon thread while serving (0 = ephemeral port)",
    )
    args = ap.parse_args(argv)

    reporter = obs.enable_telemetry(args.telemetry) if args.telemetry else None
    scrape = None
    if args.telemetry_port is not None:
        scrape = obs.start_scrape_server(args.telemetry_port)
        print(f"[serve] telemetry scrape: {scrape.url}")
    try:
        return _serve(args, reporter)
    finally:
        if scrape is not None:
            scrape.stop()


def _serve(args, reporter) -> tuple[ContinuousBatchingEngine, float]:

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    model = LM(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))

    engine = ContinuousBatchingEngine(
        model, params,
        ServeConfig(
            num_slots=args.slots, max_len=args.max_len, l_max=args.l_max,
            lookahead=args.lookahead, continuous=args.mode == "continuous",
        ),
        device=device,
    )
    trace = synth_request_trace(
        args.requests, vocab=cfg.vocab_size,
        prompt_min=args.prompt_min, prompt_max=args.prompt_max,
        new_min=args.new_min, new_max=args.new_max, seed=args.seed,
    )
    t0 = time.perf_counter()
    rids = [engine.submit(p, n) for p, n in trace]
    outputs = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    lat = np.array([engine.requests[r].latency_s for r in rids])
    ttft = np.array(
        [engine.requests[r].first_token_s - engine.requests[r].submitted_s for r in rids]
    )
    st = engine.stats
    print(
        f"arch={cfg.name} mode={args.mode} requests={args.requests} "
        f"slots={args.slots} l_max={args.l_max} device={device}"
    )
    print(
        f"tokens/s: {st.generated_tokens / wall:.1f}  "
        f"({st.generated_tokens} tokens in {wall:.2f}s, "
        f"{st.decode_steps} decode steps, occupancy "
        f"{100 * st.slot_decode_occupancy:.0f}%)"
    )
    print(
        f"latency p50/p99: {1e3 * np.percentile(lat, 50):.0f}/"
        f"{1e3 * np.percentile(lat, 99):.0f} ms; "
        f"ttft p50: {1e3 * np.percentile(ttft, 50):.0f} ms"
    )
    print(
        f"fixed shapes: decode ran at {engine.decode_traces} shape(s), prefill "
        f"buckets {dict(engine.prefill_traces)}"
    )
    print("generated ids[0]:", [int(t) for t in outputs[rids[0]]])
    if reporter is not None:
        paths = reporter.write(
            extra={"arch": cfg.name, "mode": args.mode, "requests": args.requests,
                   "slots": args.slots}
        )
        for kind, path in sorted(paths.items()):
            print(f"[serve] telemetry {kind}: {path}")
    return engine, wall


if __name__ == "__main__":
    main()
