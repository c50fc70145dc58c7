"""``--layout auto``: a short measured dense-vs-packed probe for one run.

The port's copy of the two functions the JAX launcher takes from
``benchmarks/layout.py``.  :func:`measure_loader` realizes a few aligned
steps through a loader's layout and times the real train step
(``make_train_step``, the trainer's own) on the smoke config at vocab 512 on
the run's device; :func:`calibrate_layout` runs it for both layouts of the
launch dataset and keeps the faster one.  The probe model is small by
design: the decision is a relative ranking, not a throughput estimate.
"""

from __future__ import annotations

import dataclasses
import time

import torch


def measure_loader(loader, *, max_steps: int, vocab: int = 512, device=None) -> dict:
    """Measured steps/s and device padding for one prepared loader.

    Realizes up to ``max_steps`` aligned steps, warms the train step once
    per distinct global batch shape (on a copy of the state, so the timed
    pass starts from the same weights), then times one pass over the steps,
    closed by a synchronize on the card.
    """
    from repro_torch.configs import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import LM
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state, tree_map
    from repro_torch.train.trainer import assemble_model_batch, make_train_step

    device = resolve_device(device)
    steps = []
    for ls in loader.epoch(0):
        steps.append(ls)
        if len(steps) >= max_steps:
            break

    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), vocab_size=vocab)
    model = LM(cfg, device=device)
    opt_cfg = OptimizerConfig(total_steps=100)
    train_step = make_train_step(model, opt_cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    batches = [assemble_model_batch(ls, loader.layout, device) for ls in steps]
    shapes = {}
    for b in batches:
        shapes.setdefault(tuple(b["tokens"].shape), b)
    for b in shapes.values():
        train_step(tree_map(torch.clone, state), b)
    sync()

    t0 = time.perf_counter()
    metrics = None
    for b in batches:
        state, metrics = train_step(state, b)
    sync()
    wall = time.perf_counter() - t0

    acc = loader.accounting
    return {
        "layout": loader.layout.name,
        "steps": len(steps),
        "real_tokens": acc.emitted_tokens,
        "device_tokens": acc.device_tokens,
        "device_padding_fraction": acc.device_padding_fraction,
        "group_padding_fraction": acc.padding_fraction,
        "distinct_shapes": len(shapes),
        "wall_s": wall,
        "steps_per_s": len(steps) / wall if wall > 0 else 0.0,
        "tok_per_s": acc.emitted_tokens / wall if wall > 0 else 0.0,
        "final_loss": float(metrics["loss"]) if metrics is not None else None,
    }


def calibrate_layout(
    dataset,
    world: int,
    config,
    *,
    steps: int = 6,
    vocab: int = 512,
    bucket_spec=None,
    device=None,
) -> dict:
    """Pick dense vs packed for one run from a short measured probe.

    Runs a few real train steps of *this* dataset through each layout and
    keeps the one with the higher measured steps/s (a tie goes to the lower
    device-side padding).  The caller's bucket grid is passed through so
    the probe pads on the boundaries the real run will.  Returns
    ``{"layout": choice, "results": {...}}``.
    """
    from repro_torch.data import OnlineDynamicLoader

    results = {}
    for layout in ("dense", "packed"):
        loader = OnlineDynamicLoader(
            dataset,
            world_size=world,
            config=config,
            bucket_spec=bucket_spec,
            layout=layout,
            vocab_size=vocab,
        )
        results[layout] = measure_loader(loader, max_steps=steps, vocab=vocab, device=device)
    dense, packed = results["dense"], results["packed"]
    if packed["steps_per_s"] != dense["steps_per_s"]:
        choice = max(results, key=lambda k: results[k]["steps_per_s"])
    else:
        choice = min(results, key=lambda k: results[k]["device_padding_fraction"])
    return {"layout": choice, "results": results}
