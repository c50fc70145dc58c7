"""Cost of one local program, counted as it runs (on the meta device it
allocates and computes nothing): the port's counterpart of the JAX
package's ``roofline/hlo_cost.analyze``, which reads a compiled module.

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  matrix products (and convolutions and attention ops): 2·M·N·K per
  product, as ``hlo_cost`` counts dots and ignores elementwise work.
* ``hbm_bytes``: the bytes of the inputs and outputs of every aten op the
  program dispatches (views excepted).  An eager program fuses nothing, so
  this is an upper bound on the traffic a fused program would make.
* ``peak_bytes``: the peak of the live bytes of the storages the program
  allocates, less those it hands on: the storages still alive when the
  program first writes into ``state`` (a train step's gradients, when the
  optimizer starts), or when it returns (a serve step's outputs).

The counts after the first write into ``state`` are also kept apart
(``update_flops``, ``update_bytes``): the optimizer's work, which scales
with the weights a device holds rather than with its rows.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


@dataclasses.dataclass
class Cost:
    flops: float
    hbm_bytes: float
    peak_bytes: int
    update_flops: float
    update_bytes: float
    ops: int

    def scaled(self, other: "Cost", k: float) -> "Cost":
        """``self + k·(other - self)``, field by field (depth extrapolation)."""
        return Cost(**{f.name: type(getattr(self, f.name))(
            getattr(self, f.name) + k * (getattr(other, f.name) - getattr(self, f.name)))
            for f in dataclasses.fields(self)})


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _writes(func, args, kwargs):
    """The tensors an op writes into (its mutable arguments)."""
    schema = func._schema
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        yield from (t for t in tree_leaves(value) if isinstance(t, torch.Tensor))


class _Traffic(TorchDispatchMode):
    def __init__(self, flop_counter: FlopCounterMode, state_keys: set[int]):
        super().__init__()
        self.flop_counter = flop_counter
        self.state_keys = state_keys
        self.clock = 0
        self.hbm = 0.0
        self.boundary: int | None = None
        self.boundary_flops = 0.0
        self.boundary_bytes = 0.0
        self.records: list[list] = []  # [birth, death, bytes] per storage made
        self.live: dict[int, list] = {}  # storage key -> its record

    def _died(self, key: int) -> None:
        self.live.pop(key)[1] = self.clock

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.boundary is None and self.state_keys and func._schema.is_mutable:
            if any(_storage_key(t) in self.state_keys for t in _writes(func, args, kwargs)):
                self.boundary = self.clock
                self.boundary_flops = self.flop_counter.get_total_flops()
                self.boundary_bytes = self.hbm
        out = func(*args, **kwargs)
        inputs = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outputs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.hbm += sum(t.nbytes for t in inputs) + sum(t.nbytes for t in outputs)
        seen = {_storage_key(t) for t in inputs}
        for t in outputs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in seen or key in self.live:
                continue
            self.live[key] = record = [self.clock, None, storage.nbytes()]
            self.records.append(record)
            weakref.finalize(storage, self._died, key)
        self.clock += 1
        return out

    def peak(self, end: int) -> int:
        """Peak live bytes of the storages not alive at the boundary."""
        cut = end if self.boundary is None else self.boundary
        events = []
        for birth, death, nbytes in self.records:
            if death is None or death > cut:
                continue  # handed on: gradients, outputs
            events += [(birth, nbytes), (death, -nbytes)]
        live = best = 0
        for _, delta in sorted(events, key=lambda e: (e[0], e[1])):
            live += delta
            best = max(best, live)
        return best


def count(fn, *args, state=()) -> Cost:
    """Run ``fn(*args)`` once under the counters; ``state`` are the tensors
    whose first write starts the update phase (the weights of a train
    step)."""
    state_keys = {_storage_key(t) for t in state}
    with FlopCounterMode(display=False) as flops:
        traffic = _Traffic(flops, state_keys)
        with traffic:
            out = fn(*args)
            end = traffic.clock
            traffic.clock += 1  # what dies from here on was handed on
            del out
            gc.collect()
    total_flops = float(flops.get_total_flops())
    if traffic.boundary is None:
        update_flops = update_bytes = 0.0
    else:
        update_flops = total_flops - traffic.boundary_flops
        update_bytes = traffic.hbm - traffic.boundary_bytes
    return Cost(flops=total_flops, hbm_bytes=traffic.hbm, peak_bytes=traffic.peak(end),
                update_flops=update_flops, update_bytes=update_bytes, ops=end)
