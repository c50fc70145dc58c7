"""Quickstart on the PyTorch port: ODB end to end on the card.

Builds a tiny decoder LM, wraps a synthetic high-CV dataset with the
OnlineDynamicLoader (ODB: online length observation + DGAP alignment), and
trains a few aligned steps, printing per-step metadata (emitted samples,
token counts, padding) and the terminal protocol audit (Theorems 1/2).
The flow and the printout of ``examples/quickstart.py``, on
``repro_torch``: the model runs on the CUDA card unless ``--device cpu``
is given.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --steps 2
"""

import argparse
import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import BucketSpec, OdbConfig
from repro_torch.data import OnlineDynamicLoader, get_dataset
from repro_torch.models import LM
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> str:
    """Run the quickstart; prints and returns its printout."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="the CUDA card unless 'cpu' is given")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    lines: list[str] = []

    def say(line: str = "") -> None:
        print(line)
        lines.append(line)

    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), vocab_size=512)
    model = LM(cfg, device=args.device)

    loader = OnlineDynamicLoader(
        get_dataset("longtail", scale=0.5),  # synthetic 90/10 long-tail (App. I)
        world_size=4,
        config=OdbConfig(l_max=2048, buffer_size=64, prefetch_factor=32, num_workers=4),
        # the JAX example's coarse bucket grid, so both see the same steps
        bucket_spec=BucketSpec(
            min_len=512, max_len=4096, align=512, max_count=64, use_midpoints=False
        ),
        vocab_size=cfg.vocab_size,
    )

    trainer = Trainer(
        model,
        loader,
        OptimizerConfig(lr=1e-3, total_steps=40),
        TrainerConfig(log_every=1, max_steps=args.steps),
    )
    state = trainer.init_state(torch.Generator(device=model.device).manual_seed(0))
    state, steps = trainer.train_epoch(state)

    say(f"\n{'step':>4} {'loss':>8} {'tokens':>8} {'sam/s':>8} {'pad%':>6}")
    for h in trainer.history:
        say(
            f"{h['step']:>4} {h['loss']:>8.4f} {h['tokens']:>8.0f} "
            f"{h['sam_per_s']:>8.2f} {100 * h['padding']:>5.1f}%"
        )
    audit = loader.last_audit
    say(
        f"\nprotocol audit: eta_identity={audit.eta_identity:.4f} "
        f"eta_quota={audit.eta_quota:.4f} rounds={audit.rounds} "
        f"(join mode, Theorem 1: both must be 0)"
    )
    acc = loader.accounting
    say(
        f"accounting: {acc.emitted_samples} samples, {acc.emitted_tokens} real tokens, "
        f"padding {100 * acc.padding_fraction:.2f}%"
    )
    say(f"device: {model.device}")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
