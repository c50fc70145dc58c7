"""ODB-integrated trainer (paper §2.4 metadata contract + Eq. 2 scaling).

``Trainer`` consumes step-aligned per-rank ``DeviceBatch``es from
:class:`repro_torch.data.loader.OnlineDynamicLoader` (whatever batch layout
the loader was built with), stacks them into one global batch on the card,
and runs the train step: the global masked per-token mean loss, its gradient
through autograd (the flash kernels' backward included), and an in-place
AdamW update.  The global per-token mean is exactly the token-level scaled
objective: IDLE ranks contribute zero tokens (Eq. 2 with t_r = 0).

The data path is the loader's eager epoch, whose step sequence is the one
the JAX package's streaming executor delivers at its default lookahead.
Not ported yet: the streaming executor, prefetch, worker processes,
checkpoints and the per-rank ``dp_shardmap_step``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.core.layout import BatchLayout, global_batch_arrays
from repro_torch.data.loader import LoaderStep, OnlineDynamicLoader
from repro_torch.models.model import LM, shift_labels
from repro_torch.train.optimizer import (
    OptimizerConfig,
    adamw_update,
    init_opt_state,
    tree_leaves,
    tree_map,
)

__all__ = [
    "Trainer",
    "TrainerConfig",
    "assemble_model_batch",
    "make_train_step",
    "resolve_attn_grid",
    "resolve_attn_impl",
]


def resolve_attn_impl(cfg, *, packed: bool, device: torch.device) -> str:
    """Pin ``attn_impl="auto"`` to a concrete route for one training run:
    the flash kernels exactly when the layout packs segments into rows, the
    attention layout is GQA and the tensors lie on a CUDA device; the plain
    blockwise path otherwise.  An explicit choice is kept."""
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    if cfg.attn_kind != "gqa":
        return "xla"
    return "flash" if (packed and device.type == "cuda") else "xla"


def resolve_attn_grid(cfg, *, packed: bool, device: torch.device) -> str:
    """Pin ``attn_grid="auto"``: the pruned kernels exactly when the layout
    packs segments (the liveness tables are built from them) and the tensors
    lie on a CUDA device; dense otherwise.  An explicit "pruned" is kept
    whenever segments exist."""
    if not packed:
        return "dense"  # no segments -> nothing to build liveness from
    if cfg.attn_grid != "auto":
        return cfg.attn_grid
    return "pruned" if device.type == "cuda" else "dense"


def make_train_step(model: LM, opt_cfg: OptimizerConfig):
    """(state, batch) -> (state, metrics) — THE train step.

    Loss normalization: the global masked per-token mean.  The parameters
    and moments in ``state`` are updated in place.
    """

    def train_step(state, batch):
        params = state["params"]
        loss_sum, tokens = model.loss_sums(params, batch)
        loss = loss_sum / torch.clamp(tokens, min=1.0)
        leaves = tree_leaves(params)
        flat = torch.autograd.grad(loss, leaves)
        grad_of = {id(p): g for p, g in zip(leaves, flat)}
        grads = tree_map(lambda p: grad_of[id(p)], params)
        opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg)
        return state, {"loss": loss.detach(), "tokens": tokens, **opt_metrics}

    return train_step


def _timed_phase(span_name: str, metric: str, help: str, fn: Callable):
    """Run one step phase under a trace span + cumulative seconds counter."""
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    obs.counter(metric, help=help, unit="seconds").inc(dt)
    obs.default_tracer().complete(span_name, t0, dt, cat="train")
    return out


def assemble_model_batch(loader_step: LoaderStep, layout: BatchLayout, device) -> dict:
    """Turn one aligned LoaderStep into the step's batch dict on ``device``.

    The packed layout threads positions/segments through to the model
    (segment-aware attention masking + segment-aware label shift); the dense
    layout keeps the lean three-array contract.
    """
    host = _timed_phase(
        "train/pad", "train_pad_seconds_total",
        "host-side batch padding/assembly time",
        lambda: global_batch_arrays(loader_step.batches, layout),
    )
    arrays = _timed_phase(
        "train/device_put", "train_device_put_seconds_total",
        "host-to-device transfer dispatch time",
        lambda: {k: torch.from_numpy(v).to(device) for k, v in host.items()},
    )
    tokens = arrays["tokens"]
    if layout.needs_segments:
        segments = arrays["segments"]
        labels, mask = shift_labels(tokens, arrays["loss_mask"], segments=segments)
        return {
            "tokens": tokens,
            "positions": arrays["positions"],
            "segments": segments,
            "labels": labels,
            "loss_mask": mask,
        }
    labels, mask = shift_labels(tokens, arrays["loss_mask"])
    return {"tokens": tokens, "labels": labels, "loss_mask": mask}


@dataclasses.dataclass
class TrainerConfig:
    log_every: int = 10
    max_steps: int | None = None


class Trainer:
    """End-to-end ODB training driver on the model's device."""

    def __init__(
        self,
        model: LM,
        loader: OnlineDynamicLoader,
        opt_cfg: OptimizerConfig | None = None,
        cfg: TrainerConfig | None = None,
    ):
        self.model = model
        self.loader = loader
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.cfg = cfg or TrainerConfig()
        self._train_step = None
        self.history: list[dict] = []
        self.attn_impl: str | None = None  # resolved at _build_step
        self.attn_grid: str | None = None  # resolved at _build_step

    def _build_step(self):
        # Pin the "auto" kernel route against the loader's layout and the
        # model's device, so the route is a recorded property of the run.
        packed = self.loader.layout.needs_segments
        device = self.model.device
        self.attn_impl = resolve_attn_impl(self.model.cfg, packed=packed, device=device)
        self.attn_grid = resolve_attn_grid(self.model.cfg, packed=packed, device=device)
        # The LM holds the weights, so the pin rewrites its config in place
        # (the JAX package rebuilds its stateless model instead).
        self.model.cfg = dataclasses.replace(
            self.model.cfg, attn_impl=self.attn_impl, attn_grid=self.attn_grid
        )
        self._train_step = make_train_step(self.model, self.opt_cfg)

    def init_state(self, generator: torch.Generator | None = None) -> dict:
        params = self.model.init(generator)
        return {"params": params, "opt": init_opt_state(params, self.opt_cfg)}

    def train_epoch(self, state: dict, epoch: int = 0, start_step: int = 0):
        if self._train_step is None:
            self._build_step()
        step_idx = start_step
        t0 = time.perf_counter()
        emitted = 0
        tokens_seen = 0
        tracer = obs.default_tracer()
        m_steps = obs.counter("train_steps_total", help="optimizer steps run")
        m_tokens = obs.counter("train_tokens_total", help="real tokens trained on")
        m_step_dur = obs.histogram(
            "train_step_duration_seconds",
            help="wall time of one full train step (realize+pad+put+compute)",
            unit="seconds",
        )
        step_iter = iter(self.loader.epoch(epoch))
        while True:
            step_t0 = time.perf_counter()
            # Realize: pull the next aligned step out of the data path
            # (admission + protocol rounds + layout).
            loader_step = _timed_phase(
                "train/realize", "train_realize_seconds_total",
                "data-path time to the next aligned step",
                lambda: next(step_iter, None),
            )
            if loader_step is None:
                break
            batch = assemble_model_batch(loader_step, self.loader.layout, self.model.device)

            def _compute():
                new_state, metrics = self._train_step(state, batch)
                if tracer.enabled and self.model.device.type == "cuda":
                    # Kernels run asynchronously: without a sync the span
                    # would end at enqueue time.  Only sync when tracing.
                    torch.cuda.synchronize(self.model.device)
                return new_state, metrics

            state, metrics = _timed_phase(
                "train/compute", "train_compute_seconds_total",
                "train_step time (dispatch; synced when tracing)",
                _compute,
            )
            step_idx += 1
            emitted += loader_step.metadata.emitted_samples
            tokens_seen += loader_step.metadata.total_tokens
            step_dt = time.perf_counter() - step_t0
            m_steps.inc()
            m_tokens.inc(loader_step.metadata.total_tokens)
            m_step_dur.observe(step_dt)
            tracer.complete("train/step", step_t0, step_dt, cat="train", step=step_idx)
            if step_idx % self.cfg.log_every == 0:
                dt = time.perf_counter() - t0
                rec = self._publish_log_record(
                    metrics, loader_step, step_idx, emitted, tokens_seen, dt
                )
                self.history.append(rec)
            if self.cfg.max_steps and step_idx >= self.cfg.max_steps:
                break
        return state, step_idx

    def _publish_log_record(
        self, metrics, loader_step, step_idx: int, emitted: int,
        tokens_seen: int, dt: float,
    ) -> dict:
        """Publish step metrics to the registry and return the log record
        (one value set feeds the gauges, ``self.history`` and the stdout
        line of :meth:`format_log_line`)."""
        values = {
            "train_loss": float(metrics["loss"]),
            "train_step_tokens": float(metrics["tokens"]),
            "train_grad_norm": float(metrics["grad_norm"]),
            "train_samples_per_second": emitted / dt if dt > 0 else 0.0,
            "train_tokens_per_second": tokens_seen / dt if dt > 0 else 0.0,
            "train_batch_padding": loader_step.metadata.padding_fraction,
            "train_device_padding": (
                1.0 - loader_step.metadata.total_tokens / loader_step.device_tokens
                if loader_step.device_tokens
                else 0.0
            ),
        }
        reg = obs.default_registry()
        for name, value in values.items():
            reg.gauge(name).set(value)
        return {
            "step": step_idx,
            "loss": values["train_loss"],
            "tokens": values["train_step_tokens"],
            "grad_norm": values["train_grad_norm"],
            "emitted_samples": emitted,
            "sam_per_s": values["train_samples_per_second"],
            "padding": values["train_batch_padding"],
            "device_padding": values["train_device_padding"],
        }

    @staticmethod
    def format_log_line(rec: dict) -> str:
        """Render one history record (the stdout view of the same snapshot)."""
        return (
            f"step {rec['step']:>6}  loss {rec['loss']:.4f}  "
            f"tokens {rec['tokens']:>8.0f}  grad_norm {rec['grad_norm']:.3f}  "
            f"sam/s {rec['sam_per_s']:.1f}  pad {rec['padding']:.3f}  "
            f"dev_pad {rec['device_padding']:.3f}"
        )
