"""ODB-integrated trainer (paper §2.4 metadata contract + Eq. 2 scaling).

``Trainer`` consumes step-aligned per-rank ``DeviceBatch``es from
:class:`repro_torch.data.loader.OnlineDynamicLoader` (whatever batch layout
the loader was built with), stacks them into one global batch on the card,
and runs the train step: the global masked per-token mean loss, its gradient
through autograd (the flash kernels' backward included), and an in-place
AdamW update.  The global per-token mean is exactly the token-level scaled
objective: IDLE ranks contribute zero tokens (Eq. 2 with t_r = 0).

The data path is the loader's streaming epoch by default (bounded
admission window, prefetch thread, optional worker processes and staging of
the step arrays on the card), as in the JAX package; ``streaming=False``
takes the eager epoch, which delivers the same step sequence at the default
lookahead.  Both families train: the SSM layers' SSD runs K7 forward and the
plain chunked form's gradient backward (``kernels/ops.ssd_chunked_scan``).

With ``checkpoint_dir`` set, ``train_epoch`` writes a model checkpoint every
``checkpoint_every`` steps (``train/checkpoint.py``, the JAX package's
format) and :meth:`Trainer.restore_or_init` resumes from the latest one, as
in the JAX package: the step counter and the optimizer state resume, and the
epoch's data is replayed from its start.

:func:`dp_step` is the per-rank data-parallel step (one process per rank
over ``torch.distributed``), the counterpart of the JAX package's
``dp_shardmap_step``: Eq. 2 prescaling of each rank's loss, one gradient
all-reduce, optionally bf16 with error feedback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.core.layout import BatchLayout, global_batch_arrays
from repro_torch.core.loss_scaling import prescaled_loss
from repro_torch.data.loader import LoaderStep, OnlineDynamicLoader, StagedArrays
from repro_torch.models.attention import warm_flash_blocks
from repro_torch.models.model import LM, shift_labels
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import (
    all_reduce_compressed,
    all_reduce_sum,
    init_error_state,
)
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
    "dp_step",
    "make_train_step",
    "resolve_attn_grid",
    "resolve_attn_impl",
    "staged_arrays",
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


def _warmer(model: LM):
    """Warm the measured block schedule once per new step shape, outside
    autograd, so the checkpointed forward finds it in the cache."""
    seen = set()

    def warm(batch):
        shape = (tuple(batch["tokens"].shape), "segments" in batch)
        if model.cfg.attn_autotune and shape not in seen:
            warm_flash_blocks(model.cfg, batch, model.dtype)
            seen.add(shape)

    return warm


def _grads(loss, params):
    leaves = tree_leaves(params)
    grad_of = {id(p): g for p, g in zip(leaves, torch.autograd.grad(loss, leaves))}
    return tree_map(lambda p: grad_of[id(p)], params)


def make_train_step(model: LM, opt_cfg: OptimizerConfig):
    """(state, batch) -> (state, metrics) — THE train step.

    Loss normalization: the global masked per-token mean.  The parameters
    and moments in ``state`` are updated in place.
    """
    warm = _warmer(model)

    def train_step(state, batch):
        warm(batch)
        params = state["params"]
        loss_sum, tokens = model.loss_sums(params, batch)
        loss = loss_sum / torch.clamp(tokens, min=1.0)
        opt_metrics = adamw_update(params, _grads(loss, params), state["opt"], opt_cfg)
        return state, {"loss": loss.detach(), "tokens": tokens, **opt_metrics}

    return train_step


def dp_step(
    model: LM,
    opt_cfg: OptimizerConfig,
    *,
    loss_mode: str = "exact_token",
    compress_grads: bool = False,
):
    """Per-rank data-parallel step over the default process group (one
    process per rank).

    Returns ``(step, init_error_state)``; ``step(state, batch, err) ->
    (state, metrics, err)``.  Every process holds the replicated state and
    its own contiguous block of the global batch's rows (the JAX step's
    ``P("data", None)``), as the three arrays ``tokens``, ``labels`` and
    ``loss_mask``.  Token and sample counts are summed over the ranks, each
    rank prescales its loss sum by Eq. 2 (:func:`prescaled_loss`), and the
    reported loss is the mean of the prescaled losses over the ranks.
    Backward runs on this rank's term ``scaled_r / W`` alone, then one
    all-reduce sums the gradients (in fp32, or bf16 with error feedback when
    ``compress_grads``), so the reduced gradient is the gradient of the
    global per-token mean, the loss the step reports; the in-place AdamW
    follows.  ``metrics["tokens"]`` is the global token count.

    The JAX ``dp_shardmap_step`` differentiates ``psum(scaled) / W`` inside
    ``shard_map(check_vma=False)``, where the transpose of ``psum`` is
    ``psum``, and then sums the gradients again: its gradient is ``W`` times
    the gradient of the loss it reports.  The port follows the intent the
    JAX code states (local gradients hold ∂(scaled_r / W)), not that factor.
    """
    import torch.distributed as dist

    world = dist.get_world_size()
    warm = _warmer(model)

    def step(state, batch, err):
        warm(batch)
        params = state["params"]
        loss_sum, tokens = model.loss_sums(params, batch)
        samples = batch["loss_mask"].float().amax(dim=1).sum()
        counts = torch.stack([tokens.detach().float(), samples])
        dist.all_reduce(counts)
        global_tokens = counts[0].clone()
        t_tok, n_tot = counts.clamp(min=1.0).unbind()
        scaled = prescaled_loss(loss_sum, tokens, t_tok, world, loss_mode,
                                local_samples=samples, global_samples=n_tot)
        grads = _grads(scaled / world, params)
        loss = scaled.detach().clone()
        loss_work = dist.all_reduce(loss, async_op=True)
        if compress_grads:
            grads, err = all_reduce_compressed(grads, err)
        else:
            grads = all_reduce_sum(grads)
        opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg)
        loss_work.wait()
        return state, {"loss": loss / world, "tokens": global_tokens, **opt_metrics}, err

    return step, init_error_state


def _timed_phase(span_name: str, metric: str, help: str, fn: Callable):
    """Run one step phase under a trace span + cumulative seconds counter."""
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    obs.counter(metric, help=help, unit="seconds").inc(dt)
    obs.default_tracer().complete(span_name, t0, dt, cat="train")
    return out


def staged_arrays(staged: StagedArrays, device) -> dict:
    """The arrays the loader staged, made safe to read on ``device``'s
    current stream: it waits on the copies' event, and each tensor is
    recorded on it so the caching allocator does not hand the staging
    stream's blocks out again while this step still reads them."""
    device = torch.device(device)
    arrays = staged.arrays
    if any(t.device.type != device.type for t in arrays.values()):
        raise ValueError(f"step arrays were staged on another device than {device}")
    if staged.event is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(staged.event)
        for t in arrays.values():
            t.record_stream(stream)
    return arrays


def assemble_model_batch(loader_step: LoaderStep, layout: BatchLayout, device) -> dict:
    """Turn one aligned LoaderStep into the step's batch dict on ``device``.

    Uses the arrays staged by the loader (``device_put``) when present,
    otherwise assembles from host numpy and copies.  The packed layout
    threads positions/segments through to the model (segment-aware attention
    masking + segment-aware label shift); the dense layout keeps the lean
    three-array contract.
    """
    if loader_step.device is not None:
        arrays = staged_arrays(loader_step.device, device)
    else:
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
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
    max_steps: int | None = None
    # Data path selection (DESIGN.md §9): the streaming executor admits views
    # through a bounded-lookahead window and overlaps data-side work with the
    # train step via a background prefetcher; eager is the offline reference.
    streaming: bool = True
    prefetch: bool = True
    prefetch_depth: int = 2
    lookahead: int | None = None
    # Stage the step arrays on the model's device from the prefetch producer
    # (pinned copies on a CUDA stream of its own), so H2D hides under the step.
    device_put: bool = False
    # Multi-process realization workers (DESIGN.md §14): 0 keeps layout
    # realization in-process; > 0 spawns that many worker processes staging
    # steps through a shared-memory ring (bit-identical step stream).
    num_workers: int = 0


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

    def restore_or_init(self, generator: torch.Generator | None = None) -> tuple[dict, int]:
        """A fresh state and step 0, or, when ``checkpoint_dir`` holds a
        checkpoint, the latest readable one copied into the fresh state's
        tensors and its step."""
        state = self.init_state(generator)
        if self.cfg.checkpoint_dir and ckpt.latest_step(self.cfg.checkpoint_dir) is not None:
            return state, ckpt.restore_checkpoint(self.cfg.checkpoint_dir, state, cfg=self.model.cfg)
        return state, 0

    def _epoch_steps(self, epoch: int):
        """Pick the data path: streaming (default, overlapped) or eager."""
        if self.cfg.streaming:
            return self.loader.streaming_epoch(
                epoch,
                lookahead=self.cfg.lookahead,
                prefetch=self.cfg.prefetch,
                prefetch_depth=self.cfg.prefetch_depth,
                device_put=self.cfg.device_put,
                num_workers=self.cfg.num_workers,
                device=self.model.device,
            )
        return self.loader.epoch(
            epoch, device_put=self.cfg.device_put, device=self.model.device
        )

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
        step_iter = self._epoch_steps(epoch)
        try:
            while True:
                step_t0 = time.perf_counter()
                # Realize: pull the next aligned step out of the data path
                # (admission + protocol rounds + layout, or a prefetch dequeue).
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
                if self.cfg.checkpoint_dir and step_idx % self.cfg.checkpoint_every == 0:
                    ckpt.save_checkpoint(
                        self.cfg.checkpoint_dir, step_idx, state, cfg=self.model.cfg,
                        keep=self.cfg.keep_checkpoints,
                    )
                if self.cfg.max_steps and step_idx >= self.cfg.max_steps:
                    break
        finally:
            # Stop the data path now, not at garbage collection: closing the
            # generator joins the prefetch thread (which holds a CUDA stream),
            # rolls back its staged tail, stops the workers and, after a
            # max_steps break, drains the data-side schedule so ``last_audit``
            # covers the whole epoch.
            step_iter.close()
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
