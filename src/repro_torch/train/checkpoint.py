"""Model checkpoints: atomic, keep-k, restored in place, in the JAX package's format.

The counterpart of ``repro.train.checkpoint``, with its scheme:

  * atomic: the arrays go to ``step_XXXXXXXX.tmp.npz`` and are renamed to
    ``step_XXXXXXXX.npz``; the manifest goes to ``latest.tmp.json`` and is
    renamed to ``latest.json`` (``step``, ``keys``, ``time``, ``extra``), so
    a crash mid-write never corrupts the latest checkpoint;
  * keep-k rotation, and a corrupt-latest fallback through the rotation with
    a ``RuntimeWarning``; an explicit ``step=`` never falls back, and a shape
    mismatch is a hard error on every path;
  * the JAX tree's keys: the state is flattened in the JAX layout and order
    (dict keys sorted, list items by index, the layers stacked unit by unit
    under ``stack/sub{j}`` and a dense prefix under ``prefix/{i}/sub0``,
    ``bridge.jax_layout``), paths joined by ``/``, and an
    npz member name replaces ``/`` with ``__SEP__``: ``params/...``,
    ``opt/m/...``, ``opt/v/...``, ``opt/step``.  A checkpoint written by one
    package restores in the other.

Leaves keep their dtypes.  A bf16 leaf is written as its raw bits in a
two-byte void (``<V2``), byte for byte as ``np.savez`` writes ml_dtypes'
bfloat16 in the JAX package, and read back by viewing the bits as
``torch.bfloat16`` (the JAX package's own restore cannot cast such an
array).  Files whose name ends in ``.tmp.npz`` are never rotated or
restored: they are writes that did not finish.

Unlike the JAX package, which builds a new state, :func:`restore_checkpoint`
copies into the tensors of the state it is given, so the card never holds
two copies of the weights and moments.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
import warnings
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.bridge import jax_layout

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]

# Failure modes a torn/corrupt npz can present as, depending on where the
# damage landed (zip directory, member header, stored bytes, missing key).
_CORRUPT_ERRORS = (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile, zlib.error)

_SEP = "__SEP__"
_BF16_DESCR = "<V2"  # how numpy's npy header names ml_dtypes' bfloat16


def _flatten(state: Any, cfg) -> list[tuple[str, Any]]:
    """(key, leaf) in the JAX tree's order; a leaf is a tensor, or the list
    of per-unit tensors that the JAX layout stacks on a leading axis (a
    list of dicts, ``prefix``, is walked with index keys)."""
    out: list[tuple[str, Any]] = []

    def walk(node, path: tuple) -> None:
        if isinstance(node, dict):
            if "layers" in node:  # a model-shaped tree: params, or an AdamW moment
                if cfg is None:
                    raise ValueError(f"{'/'.join(path) or 'state'} is a model tree: pass its cfg")
                node = jax_layout(node, cfg)
            for key in sorted(node):
                walk(node[key], path + (key,))
        elif isinstance(node, list) and node and isinstance(node[0], dict):
            for i, item in enumerate(node):  # the JAX layout's ``prefix`` list
                walk(item, path + (str(i),))
        else:
            out.append(("/".join(path), node))

    walk(state, ())
    return out


def _leaf_shape(leaf) -> tuple:
    return (len(leaf), *leaf[0].shape) if isinstance(leaf, list) else tuple(leaf.shape)


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of a leaf in its own dtype (bf16 as raw two-byte voids)."""
    if isinstance(leaf, list):
        t = torch.stack([u.detach().cpu() for u in leaf])
    else:
        t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _write_npz(path: pathlib.Path, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez`` (stored members, zip64) with bf16's header as JAX writes it."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in arrays.items():
            header = np.lib.format.header_data_from_array_1_0(arr)
            if arr.dtype.kind == "V":
                header["descr"] = _BF16_DESCR
            with zf.open(key.replace("/", _SEP) + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, header)
                f.write(arr.reshape(-1).view(np.uint8).data)


def _checkpoints(directory: pathlib.Path) -> list[pathlib.Path]:
    return sorted(p for p in directory.glob("step_*.npz") if not p.name.endswith(".tmp.npz"))


def save_checkpoint(
    directory: str | os.PathLike,
    step: int,
    state: Any,
    *,
    cfg=None,
    keep: int = 3,
    extra: dict | None = None,
) -> pathlib.Path:
    """Write ``state``, a tree of dicts and tensors, as checkpoint ``step``
    and keep the newest ``keep``.  A model-shaped subtree (the trainer's
    params and AdamW moments) is written in the JAX layout of ``cfg``, the
    model's ArchConfig."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = _flatten(state, cfg)
    tmp = directory / f"step_{step:08d}.tmp.npz"
    final = directory / f"step_{step:08d}.npz"
    _write_npz(tmp, {key: _to_numpy(leaf) for key, leaf in flat})
    os.replace(tmp, final)
    manifest = {"step": step, "keys": [k for k, _ in flat], "time": time.time(),
                "extra": extra or {}}
    mtmp = directory / "latest.tmp.json"
    mtmp.write_text(json.dumps(manifest))
    os.replace(mtmp, directory / "latest.json")
    for old in _checkpoints(directory)[:-keep]:
        old.unlink(missing_ok=True)
    return final


def latest_step(directory: str | os.PathLike) -> int | None:
    mf = pathlib.Path(directory) / "latest.json"
    if not mf.exists():
        return None
    try:
        return int(json.loads(mf.read_text())["step"])
    except (ValueError, KeyError, json.JSONDecodeError):
        return None


def _read_arrays(path: pathlib.Path, keys: list[str]) -> dict[str, np.ndarray]:
    """Every array of a checkpoint, read in full: npz loading is lazy, so a
    torn member only fails when it is read, inside the caller's guard."""
    with np.load(path) as data:
        return {k: np.asarray(data[k.replace("/", _SEP)]) for k in keys}


def restore_checkpoint(
    directory: str | os.PathLike,
    state: Any,
    *,
    cfg=None,
    step: int | None = None,
) -> int:
    """Copy checkpoint ``step`` (the latest readable one when None) into the
    tensors of ``state``, which gives the structure and the shapes; returns
    the step restored.  Every array is read and every shape checked before
    the first tensor is written."""
    directory = pathlib.Path(directory)
    flat = _flatten(state, cfg)
    keys = [k for k, _ in flat]
    if step is not None:
        data = _read_arrays(directory / f"step_{step:08d}.npz", keys)
    else:
        candidates: list[pathlib.Path] = []
        pointed = latest_step(directory)
        if pointed is not None:
            candidates.append(directory / f"step_{pointed:08d}.npz")
        candidates += [p for p in reversed(_checkpoints(directory)) if p not in candidates]
        if not candidates:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        data = None
        for path in candidates:
            try:
                data = _read_arrays(path, keys)
            except _CORRUPT_ERRORS as exc:
                warnings.warn(
                    f"checkpoint {path.name} unreadable ({type(exc).__name__}: {exc}); "
                    "falling back to the previous keep-k checkpoint",
                    RuntimeWarning, stacklevel=2,
                )
                continue
            step = int(path.stem.split("_")[1])
            break
        if data is None:
            raise FileNotFoundError(f"no readable checkpoint in {directory} "
                                    f"(tried {[p.name for p in candidates]})")
    for key, leaf in flat:
        if tuple(data[key].shape) != _leaf_shape(leaf):
            raise ValueError(f"checkpoint/{key}: shape {data[key].shape} != expected {_leaf_shape(leaf)}")
    with torch.no_grad():
        for key, leaf in flat:
            src = _to_tensor(data[key])
            for i, t in enumerate(leaf if isinstance(leaf, list) else [leaf]):
                t.copy_(src[i] if isinstance(leaf, list) else src)
    return step
