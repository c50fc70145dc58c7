"""Training launcher: ODB-fed training of one architecture on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \
        --layout packed --world 2 --l-max 4096 --steps 3

Runs on the CUDA card; ``--device cpu`` (with ``--smoke`` for the reduced
config) runs the same trainer on the CPU, where the flash route (an explicit
``--attn-impl flash``) takes the kernels' plain versions.  Weights are random,
drawn from seed 0, as the JAX launcher's are.  The data path is the loader's
eager epoch, which yields the JAX launcher's default streaming step sequence.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def build(args) -> tuple[Trainer, OnlineDynamicLoader]:
    """The trainer and loader the flags describe (the model on its device)."""
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl, attn_grid=args.attn_grid)
    model = LM(cfg, device=device)
    dataset = get_dataset(args.dataset, scale=args.data_scale)
    odb_cfg = OdbConfig(
        l_max=args.l_max, buffer_size=args.buffer,
        prefetch_factor=args.prefetch, num_workers=4,
        join_mode=not args.non_join,
    )
    loader = OnlineDynamicLoader(
        dataset,
        world_size=args.world,
        config=odb_cfg,
        bucket_spec=BucketSpec(min_len=128, max_len=16384, max_count=1024),
        layout=args.layout,
        vocab_size=cfg.vocab_size,
    )
    trainer = Trainer(
        model, loader,
        OptimizerConfig(total_steps=max(args.steps, 100)),
        TrainerConfig(log_every=args.log_every, max_steps=args.steps),
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
    ap.add_argument(
        "--layout", default="dense", choices=("dense", "packed"),
        help="batch layout: dense bucket padding or packed segment streams",
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
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main() -> None:
    args = parser().parse_args()
    trainer, loader = build(args)
    device = trainer.model.device
    state = trainer.init_state(torch.Generator(device=device).manual_seed(0))
    step, epoch = 0, 0
    while step < args.steps:
        state, step = trainer.train_epoch(state, epoch=epoch, start_step=step)
        epoch += 1
    print(
        f"[train] layout={args.layout} attn_impl={trainer.attn_impl} "
        f"attn_grid={trainer.attn_grid} device={device}"
    )
    for h in trainer.history[-10:]:
        print(Trainer.format_log_line(h))
    audit = loader.last_audit
    if audit:
        print(f"eta_identity={audit.eta_identity} eta_quota={audit.eta_quota}")


if __name__ == "__main__":
    main()
