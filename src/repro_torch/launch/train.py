"""Training launcher: ODB-fed training of one architecture on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \
        --layout packed --world 2 --l-max 4096 --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_130m \
        --layout dense --world 2 --l-max 4096 --checkpoint-dir ckpt

Runs on the CUDA card; ``--device cpu`` (with ``--smoke`` for the reduced
config) runs the same trainer on the CPU, where the flash route (an explicit
``--attn-impl flash``) takes the kernels' plain versions.  Weights are random,
drawn from seed 0, as the JAX launcher's are.  The data path is the JAX
launcher's default: the streaming executor with a prefetch thread
(``--no-prefetch`` runs it inline, ``--num-workers N`` moves layout building
into N worker processes, ``--device-put`` stages the step arrays on the card
from the producer); ``--eager`` takes the offline epoch instead.

The steps run inside the JAX launcher's restart loop: with
``--checkpoint-dir`` the trainer writes a checkpoint every
``CHECKPOINT_EVERY`` steps, and a crash restores the latest one and counts a
restart; an ``EpochAborted`` also writes its stream checkpoint to
``<dir>/stream_abort.json``.  Past ``--max-restarts``, or without a
checkpoint directory, the error is raised.

``--layout auto`` picks dense or packed from a short measured probe
(``launch/calibrate.py``); ``--attn-autotune`` picks the flash kernels'
block pair per shape from a measured probe (``kernels/autotune.py``);
``--hosts`` partitions the ranks over sharded admission windows;
``--round-deadline``/``--round-retries`` go into ``OdbConfig`` as in JAX: the
executor gathers in process, so a gather misses its deadline only under a
fault injector (``repro_torch.chaos.CollectiveInjector``, passed to
``loader.streaming_epoch(fault_injector=...)``; the launcher passes none, as
the JAX launcher does); ``--telemetry DIR`` writes metrics.json, trace.json and
rounds.json at exit and ``--telemetry-port`` serves ``GET /metrics`` while
the run goes on.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib

import torch

from repro_torch import obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.stream import EpochAborted
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CHECKPOINT_EVERY = 20  # steps between checkpoints, as in the JAX launcher


def _calibrate_layout(dataset, world: int, config: OdbConfig, steps: int,
                      bucket_spec: BucketSpec, device) -> str:
    """--layout auto: the measured dense-vs-packed probe."""
    from repro_torch.launch.calibrate import calibrate_layout

    cal = calibrate_layout(dataset, world, config, steps=steps, bucket_spec=bucket_spec,
                           device=device)
    for name, r in cal["results"].items():
        print(
            f"[train] calibrate {name}: {r['steps_per_s']:.2f} steps/s  "
            f"dev-pad {100 * r['device_padding_fraction']:.2f}%"
        )
    print(f"[train] layout auto -> {cal['layout']}")
    return cal["layout"]


def build(args) -> tuple[Trainer, OnlineDynamicLoader]:
    """The trainer and loader the flags describe (the model on its device);
    ``--layout auto`` runs its calibration probe here."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.input_embeds:
        # The JAX launcher fails inside its first step (KeyError: 'embeds').
        raise ValueError(f"{cfg.name} takes input embeddings: the data path makes token "
                         "batches only, so the launcher cannot train it (use LM.loss_sums on "
                         "an embeds batch)")
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl, attn_grid=args.attn_grid,
                              attn_autotune=args.attn_autotune)
    model = LM(cfg, device=device)
    dataset = get_dataset(args.dataset, scale=args.data_scale)
    odb_cfg = OdbConfig(
        l_max=args.l_max, buffer_size=args.buffer,
        prefetch_factor=args.prefetch, num_workers=4,
        join_mode=not args.non_join,
        round_deadline_s=args.round_deadline,
        round_retries=args.round_retries,
        max_quarantine=args.max_quarantine,
    )
    bucket_spec = BucketSpec(min_len=128, max_len=16384, max_count=1024)
    layout = args.layout
    if layout == "auto":
        layout = _calibrate_layout(dataset, args.world, odb_cfg, args.calibration_steps,
                                   bucket_spec, device)
    loader = OnlineDynamicLoader(
        dataset,
        world_size=args.world,
        config=odb_cfg,
        bucket_spec=bucket_spec,
        layout=layout,
        vocab_size=cfg.vocab_size,
        num_hosts=args.hosts,
    )
    trainer = Trainer(
        model, loader,
        OptimizerConfig(total_steps=max(args.steps, 100)),
        TrainerConfig(
            checkpoint_dir=args.checkpoint_dir, checkpoint_every=CHECKPOINT_EVERY,
            log_every=args.log_every, max_steps=args.steps,
            streaming=not args.eager, prefetch=not args.no_prefetch,
            prefetch_depth=args.prefetch_depth, lookahead=args.lookahead,
            device_put=args.device_put, num_workers=args.num_workers,
        ),
    )
    return trainer, loader


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--dataset", default="ultrachat")
    ap.add_argument("--data-scale", type=float, default=0.002)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--l-max", type=int, default=4096)
    ap.add_argument("--buffer", type=int, default=256)
    ap.add_argument("--prefetch", type=int, default=64)
    ap.add_argument("--non-join", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument(
        "--round-deadline", type=float, default=None, metavar="SECONDS",
        help="per-round collective delivery deadline (DESIGN.md §15), kept "
             "in OdbConfig as in JAX. This launcher's executor gathers in "
             "process, so a gather misses it only under a fault injector "
             "(repro_torch.chaos), which the launcher does not install. "
             "Default: off",
    )
    ap.add_argument(
        "--round-retries", type=int, default=2,
        help="gather retries before a missed --round-deadline aborts; like "
             "--round-deadline it bites only under a fault injector",
    )
    ap.add_argument(
        "--max-quarantine", type=int, default=0,
        help="per-epoch budget of samples whose online realization may fail "
             "and be quarantined (accounted component X, DESIGN.md §15) "
             "instead of crashing the epoch. Default 0 = strict",
    )
    ap.add_argument(
        "--eager", action="store_true",
        help="offline data path (full-epoch length realization) instead of "
             "the default streaming executor",
    )
    ap.add_argument(
        "--lookahead", type=int, default=None,
        help="admission-window bound on realized lengths in flight "
             "(default: full view multiset, reproducing the eager schedule)",
    )
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--prefetch-depth", type=int, default=2)
    ap.add_argument(
        "--device-put", action="store_true",
        help="stage the step arrays on the device from the prefetch producer "
             "(pinned copies on a CUDA stream of its own) so H2D hides under "
             "the train step",
    )
    ap.add_argument(
        "--num-workers", type=int, default=0,
        help="spawned realization worker processes staging steps through a "
             "shared-memory ring (DESIGN.md §14); 0 = in-process path. The "
             "delivered step stream is bit-identical either way",
    )
    ap.add_argument(
        "--layout", default="dense", choices=("dense", "packed", "auto"),
        help="batch layout: dense bucket padding, packed segment streams "
             "(DESIGN.md §10), or auto — a short measured calibration probe "
             "picks the faster layout for this dataset profile",
    )
    ap.add_argument(
        "--calibration-steps", type=int, default=6,
        help="measured steps per layout for --layout auto",
    )
    ap.add_argument(
        "--attn-impl", default="auto", choices=("auto", "xla", "flash"),
        help="training attention route: the plain blockwise path, the flash "
             "kernels, or auto (flash when packed on the card)",
    )
    ap.add_argument(
        "--attn-grid", default="auto", choices=("auto", "dense", "pruned"),
        help="flash kernel variant: dense walks every tile, pruned only the "
             "live tiles of the liveness tables; auto = pruned when packed on "
             "the card",
    )
    ap.add_argument(
        "--attn-autotune", action="store_true",
        help="pick the flash kernels' (block_q, block_kv) per shape cell "
             "from a short measured probe (cached under artifacts/autotune/)",
    )
    ap.add_argument(
        "--telemetry", default=None, metavar="DIR",
        help="enable the obs subsystem and write metrics.json / trace.json / "
             "rounds.json into DIR at exit (DESIGN.md §13)",
    )
    ap.add_argument(
        "--telemetry-port", type=int, default=None, metavar="PORT",
        help="serve a live Prometheus scrape endpoint (GET /metrics) from a "
             "daemon thread on this port while training (0 = ephemeral); "
             "independent of --telemetry's at-exit files",
    )
    ap.add_argument(
        "--hosts", type=int, default=1,
        help="multi-host lane (DESIGN.md §16): partition the DGAP ranks over "
             "this many sharded admission windows, each running its own "
             "cursor over its rank block; must not exceed --world",
    )
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def run(trainer: Trainer, args) -> tuple[dict, int]:
    """Train to ``args.steps`` inside the restart loop; returns the state
    and the step reached."""
    device = trainer.model.device
    restarts = 0
    while True:
        try:
            state, step = trainer.restore_or_init(torch.Generator(device=device).manual_seed(0))
            epoch = 0
            while step < args.steps:
                state, step = trainer.train_epoch(state, epoch=epoch, start_step=step)
                epoch += 1
            return state, step
        except EpochAborted as exc:  # degraded-mode closure (DESIGN.md §15.4)
            state = None  # the next attempt's state is built without this one beside it
            restarts += 1
            print(f"[train] epoch aborted ({exc.cause}); restart {restarts}/{args.max_restarts}")
            if exc.failed_ranks:
                print(f"[train] failed ranks: {exc.failed_ranks}")
            if args.checkpoint_dir:
                # The abort carries a valid stream checkpoint: kept beside
                # the model checkpoints, so a later run can continue the
                # same step sequence instead of replaying the epoch.
                abort_path = pathlib.Path(args.checkpoint_dir) / "stream_abort.json"
                exc.checkpoint().save(str(abort_path))
                print(f"[train] abort stream checkpoint: {abort_path}")
            if restarts > args.max_restarts or not args.checkpoint_dir:
                raise
        except Exception as exc:  # crash -> resume from the latest checkpoint
            state = None
            restarts += 1
            print(f"[train] crash ({type(exc).__name__}: {exc}); restart {restarts}")
            if restarts > args.max_restarts or not args.checkpoint_dir:
                raise


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    reporter = None
    if args.telemetry:
        # Before any instrumented object is built, so construction-time
        # cached instruments bind to live metrics.
        reporter = obs.enable_telemetry(args.telemetry)
    scrape = None
    if args.telemetry_port is not None:
        scrape = obs.start_scrape_server(args.telemetry_port)
        print(f"[train] telemetry scrape: {scrape.url}")
    try:
        trainer, loader = build(args)
        _, step = run(trainer, args)
        print(
            f"[train] layout={loader.layout.name} attn_impl={trainer.attn_impl} "
            f"attn_grid={trainer.attn_grid} device={trainer.model.device}"
        )
        for h in trainer.history[-10:]:
            print(Trainer.format_log_line(h))
        audit = loader.last_audit
        if audit:
            print(f"eta_identity={audit.eta_identity} eta_quota={audit.eta_quota}")
        if loader.last_prefetch_stats is not None:
            st = loader.last_prefetch_stats
            print(f"prefetch hit_rate={st.hit_rate:.2f} waits={st.wait_s:.3f}s")
        if loader.last_worker_stats is not None:
            ws = loader.last_worker_stats
            print(
                f"workers completed={ws.completed} shm={ws.shm_results} "
                f"inline={ws.inline_results} reexec={ws.reexecuted} "
                f"failures={ws.worker_failures} wait={ws.wait_s:.3f}s"
            )
        if reporter is not None:
            executor = loader.last_executor
            paths = reporter.write(
                round_audit=None if executor is None else executor.telemetry,
                extra={
                    "arch": trainer.model.cfg.name,
                    "layout": loader.layout.name,
                    "attn_impl": trainer.attn_impl,
                    "steps": step,
                },
            )
            for kind, path in sorted(paths.items()):
                print(f"[train] telemetry {kind}: {path}")
    finally:
        if scrape is not None:
            scrape.stop()


if __name__ == "__main__":
    main()
