"""End-to-end training driver on the PyTorch port: ~100M-param LM with the
full ODB stack.

The production configuration (``--preset 100m``) trains a 100M decoder for
a few hundred aligned steps on the UltraChat length-distribution clone with
checkpointing and fault-tolerant resume, on the CUDA card.  ``--preset
smoke`` (the default) runs the identical pipeline at reduced width for a
fast demonstration; ``--device cpu`` runs it on the CPU.  The flow and the
printout of ``examples/train_100m.py``, on ``repro_torch``; the checkpoints
go under ``artifacts/`` (git-ignored), in the JAX package's format.

    PYTHONPATH=src python examples/train_100m_torch.py --preset smoke --device cpu
    PYTHONPATH=src python examples/train_100m_torch.py --preset 100m --steps 300
"""

import argparse

import torch

from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.models import LM
from repro_torch.models.config import ArchConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    # ~104M params: 12L, d=640, untied 32k vocab: the "train ~100M for a few
    # hundred steps" end-to-end configuration.
    "100m": ArchConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=640,
        vocab_size=32_000, n_heads=10, n_kv_heads=5, d_head=64, d_ff=2560,
        norm="rms", dtype="float32",
    ),
    "smoke": ArchConfig(
        name="lm-smoke", family="dense", n_layers=4, d_model=128,
        vocab_size=1024, n_heads=4, n_kv_heads=2, d_head=32, d_ff=512,
        norm="rms", dtype="float32",
    ),
}


def main(argv=None) -> str:
    """Train; prints and returns the printout."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="smoke")
    ap.add_argument("--dataset", default="ultrachat")
    ap.add_argument("--data-scale", type=float, default=0.002)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--l-max", type=int, default=4096)
    ap.add_argument("--checkpoint-dir", default="artifacts/train_100m_torch")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="the CUDA card unless 'cpu' is given")
    args = ap.parse_args(argv)
    lines: list[str] = []

    def say(line: str = "") -> None:
        print(line)
        lines.append(line)

    cfg = PRESETS[args.preset]
    model = LM(cfg, device=args.device)
    say(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    loader = OnlineDynamicLoader(
        get_dataset(args.dataset, scale=args.data_scale),
        world_size=args.world,
        config=OdbConfig(
            l_max=args.l_max, buffer_size=256, prefetch_factor=64, num_workers=4
        ),
        bucket_spec=BucketSpec(min_len=128, max_len=8192, max_count=512),
        vocab_size=cfg.vocab_size,
    )
    trainer = Trainer(
        model,
        loader,
        OptimizerConfig(lr=3e-4, total_steps=max(args.steps, 100)),
        TrainerConfig(
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=20,
            log_every=5,
            max_steps=args.steps,
        ),
    )
    generator = torch.Generator(device=model.device).manual_seed(0)
    state, start = (
        trainer.restore_or_init(generator)
        if args.resume
        else (trainer.init_state(generator), 0)
    )
    if start:
        say(f"resumed from step {start}")
    epoch = 0
    step = start
    while step < args.steps:
        state, step = trainer.train_epoch(state, epoch=epoch, start_step=step)
        epoch += 1
    for h in trainer.history:
        say(
            f"step {h['step']:>5}  loss {h['loss']:.4f}  "
            f"sam/s {h['sam_per_s']:.2f}  pad {100*h['padding']:.2f}%"
        )
    audit = loader.last_audit
    say(f"eta_identity={audit.eta_identity} eta_quota={audit.eta_quota}")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
