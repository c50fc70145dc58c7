"""Measured (block_q, block_kv) schedules for the flash kernels (DESIGN.md §11).

The flash kernels' tile shape is a throughput knob: the best (block_q,
block_kv) pair per *shape cell* (B, S, H, KV, D, dtype, causal, packed?,
grid) depends on the live-tile census and on how many blocks the card keeps
in flight, so it is picked from a short measured probe rather than a table.
Results are cached per process and persisted under
``artifacts/autotune/attn_blocks_cuda.json``, the port's own file: a
schedule measured for the TPU is never served to the card.  The cache keys
are the JAX package's strings for the same arguments (the backend is "gpu"
for a CUDA device, "cpu" for the CPU, and the dtype is written by its JAX
name).

The probe times forward + backward through ``kernels/ops.flash_attention``
at each candidate, on inputs drawn from ``torch.Generator(device)`` seeded
with 0, after one warm-up call per candidate (so the kernels' first build is
not in the clock), over several windows of a few calls each; on the card
with CUDA events, on the CPU (the kernels' plain versions) with the host
clock.  The JAX probe takes the fastest mean of two calls; here a candidate
replaces the heuristic pair only when its median window beats the
heuristic's by more than the windows' spread, since the candidates' gaps on
the card can sit inside the noise of two calls.  Unlike the JAX probe, which skips a
candidate that raises (a tile that does not fit VMEM), a candidate that
raises here is a bug and the error propagates: the CUDA kernels take every
candidate (block_q, block_kv ≤ 128 dividing S).

The probe runs its own autograd graph, so it must not run inside another
one's recording: ``models/attention.py`` reads the cache under grad mode and
probes only outside it; the trainer warms each new step shape before the
forward.  When autotuning is off (``ArchConfig.attn_autotune = False``, the
default) the heuristic schedule is used: the largest block ≤ 128 dividing S.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import time

import torch

from repro_torch import obs
from repro_torch.kernels.flash_attention import select_block

DEFAULT_CACHE_PATH = pathlib.Path("artifacts") / "autotune" / "attn_blocks_cuda.json"
WINDOWS = 5  # timed windows per candidate
CALLS_PER_WINDOW = 3  # forward+backward calls per window

# One in-process schedule per cache file, so an explicit cache_path (tests,
# side experiments) never bleeds into — or is served from — the default pool.
_CACHES: dict[str, dict[str, tuple[int, int]]] = {}


def heuristic_blocks(s: int) -> tuple[int, int]:
    """Probe-free default: square blocks at the largest divisor ≤ 128."""
    b = select_block(s, 128)
    return b, b


def candidate_blocks(s: int) -> list[tuple[int, int]]:
    """Candidate (block_q, block_kv) pairs — exact divisors of S only,
    capped at 128 (the kernels' ``select_block`` cap: larger requests would
    alias the 128 schedule and pollute the persisted cache)."""
    divs = [d for d in (128, 64, 32) if d <= s and s % d == 0]
    if not divs:
        divs = [select_block(s, 128)]
    return sorted({(bq, bk) for bq in divs for bk in divs})


def shape_key(
    b: int, s: int, h: int, kv: int, d: int,
    *, dtype=torch.float32, causal: bool = True, has_segments: bool = False,
    grid: str = "dense", device="cuda",
) -> str:
    """The JAX package's key for one shape cell.  Keyed by grid variant: a
    schedule measured on one grid is never served to the other."""
    backend = "gpu" if torch.device(device).type == "cuda" else "cpu"
    dtype_name = str(dtype).removeprefix("torch.")
    return (
        f"{backend}/b{b}s{s}h{h}kv{kv}d{d}"
        f"/{dtype_name}/causal{int(causal)}/seg{int(has_segments)}"
        f"/grid.{grid}"
    )


def _cache_path(cache_path) -> pathlib.Path:
    return pathlib.Path(cache_path) if cache_path is not None else DEFAULT_CACHE_PATH


def _load_cache(path: pathlib.Path) -> dict[str, tuple[int, int]]:
    cache = _CACHES.get(str(path))
    if cache is not None:
        return cache
    cache = _CACHES.setdefault(str(path), {})
    try:
        stored = json.loads(path.read_text())
    except (OSError, ValueError):
        return cache
    for key, pair in stored.items():
        cache.setdefault(key, (int(pair[0]), int(pair[1])))
    return cache


def _persist_cache(path: pathlib.Path, cache: dict[str, tuple[int, int]]) -> None:
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps({k: list(v) for k, v in sorted(cache.items())}, indent=1))
        os.replace(tmp, path)
    except OSError:  # read-only checkout: keep the in-process cache only
        pass


def cached_schedule(cache_path: str | os.PathLike | None = None) -> dict[str, tuple[int, int]]:
    """Snapshot of one cache file's measured schedule."""
    return dict(_load_cache(_cache_path(cache_path)))


def lookup_blocks(key: str, cache_path: str | os.PathLike | None = None) -> tuple[int, int] | None:
    """The cached pair for ``key``, or None; counts nothing and never probes."""
    return _load_cache(_cache_path(cache_path)).get(key)


def _probe_segments(b: int, s: int, device) -> torch.Tensor:
    """Synthetic packed rows: a few segments plus a padding tail, so the
    probe exercises the segment-masked (tile-skipping) kernels."""
    seg = torch.zeros((b, s), dtype=torch.int32)
    cuts = [0, s // 3, (2 * s) // 3, s - s // 8]
    for j in range(len(cuts) - 1):
        seg[:, cuts[j]:cuts[j + 1]] = j + 1
    return seg.to(device)


def _time_windows(run, device: torch.device) -> list[float]:
    """Seconds per call of ``run`` in each of ``WINDOWS`` timed windows of
    ``CALLS_PER_WINDOW`` calls, after one warm-up call."""
    run()
    if device.type != "cuda":
        out = []
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            for _ in range(CALLS_PER_WINDOW):
                run()
            out.append((time.perf_counter() - t0) / CALLS_PER_WINDOW)
        return out
    events = []
    for _ in range(WINDOWS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS_PER_WINDOW):
            run()
        stop.record()
        events.append((start, stop))
    events[-1][1].synchronize()
    return [start.elapsed_time(stop) / 1e3 / CALLS_PER_WINDOW for start, stop in events]


def pick_blocks(windows: dict[tuple[int, int], list[float]], s: int) -> tuple[int, int]:
    """The pair with the lowest median window, unless the heuristic pair is
    among the candidates and that pair's lead over it is no larger than the
    spread (slowest less fastest window) of either: a pick inside the probe's
    own noise would make the persisted schedule a coin toss."""
    medians = {pair: statistics.median(ts) for pair, ts in windows.items()}
    best = min(medians, key=medians.get)
    base = heuristic_blocks(s)
    if base in windows and best != base:
        spread = max(max(windows[p]) - min(windows[p]) for p in (best, base))
        if medians[base] - medians[best] <= spread:
            return base
    return best


def autotune_blocks(
    b: int, s: int, h: int, kv: int, d: int,
    *,
    dtype=torch.float32,
    causal: bool = True,
    has_segments: bool = False,
    cache_path: str | os.PathLike | None = None,
    grid: str = "dense",
    device=None,
) -> tuple[int, int]:
    """Measured (block_q, block_kv) for one shape cell, cached on disk.

    ``device`` defaults to the CUDA card.  The probe runs forward + backward
    on ``min(b, 2)`` rows (tile timing is row-independent, so the full train
    batch need not be materialized), ``WINDOWS`` timed windows per
    candidate, and picks by :func:`pick_blocks`; the last probe's windows,
    medians and pick are in :data:`LAST_PROBE`.
    """
    from repro_torch.device import resolve_device
    from repro_torch.kernels.ops import flash_attention  # late: avoid an import cycle

    device = resolve_device(device)
    path = _cache_path(cache_path)
    cache = _load_cache(path)
    key = shape_key(b, s, h, kv, d, dtype=dtype, causal=causal, has_segments=has_segments,
                    grid=grid, device=device)
    if key in cache:
        obs.counter(
            "kernel_autotune_cache_hits_total",
            help="autotune shape cells served from cache",
        ).inc()
        return cache[key]
    obs.counter(
        "kernel_autotune_cache_misses_total",
        help="autotune shape cells that ran the measured probe",
    ).inc()
    probe_t0 = time.perf_counter()

    pb = min(b, 2)
    gen = torch.Generator(device).manual_seed(0)
    q, k, v = (torch.randn((pb, s, n, d), generator=gen, device=device).to(dtype)
               for n in (h, kv, kv))
    seg = _probe_segments(pb, s, device) if has_segments else None

    times: dict[tuple[int, int], list[float]] = {}
    for bq, bk in candidate_blocks(s):
        def run(bq=bq, bk=bk):
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                out = flash_attention(*qkv, seg, causal, bq, bk, grid)
                torch.autograd.grad(out.float().square().sum(), qkv)

        times[(bq, bk)] = _time_windows(run, device)
    best = pick_blocks(times, s)
    LAST_PROBE.clear()
    LAST_PROBE.update(key=key, windows=times,
                      seconds={pair: statistics.median(ts) for pair, ts in times.items()},
                      best=best)
    cache[key] = best
    _persist_cache(path, cache)
    obs.default_tracer().complete(
        "kernels/autotune", probe_t0, time.perf_counter() - probe_t0,
        cat="kernels", key=key, block_q=best[0], block_kv=best[1],
    )
    return best


# The last probe's key, seconds per call in each window and their median per
# candidate, and pick (a report, not state the schedule reads).
LAST_PROBE: dict = {}
