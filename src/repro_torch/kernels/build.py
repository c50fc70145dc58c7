"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each source is compiled into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), for ``sm_90a``, into
``build/repro_torch/`` at the root of the checkout.  The library name carries
a hash of the source, of every shared header (``csrc/*.cuh``, which a source
includes) and of the flags, so an edited source or header is rebuilt and an
unchanged one is loaded from the earlier build, with the ``nvcc``/``ptxas``
log kept beside it.  Nothing is built at import: the first kernel launch (or
:func:`build_all`) does it.  Every wrapper launches through :func:`launch`:
pointers, the stream, the return code and the counts in one place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

import torch

from repro_torch import obs

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_fwd", "flash_bwd", "ssd_scan", "adamw", "mla_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_int, _c_float, _c_int64, _ptr = ctypes.c_int, ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p
# (argtypes, restype) of every exported function, by library.
SIGNATURES = {
    "flash_fwd": {
        "flash_fwd_dense": (
            [_c_int, _c_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr]
            + [_c_int] * 8 + [_c_float, _ptr],
            _c_int,
        ),
        "flash_fwd_pruned": (
            [_c_int, _c_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr]
            + [_c_int] * 8 + [_c_float, _ptr],
            _c_int,
        ),
        "flash_error_string": ([_c_int], ctypes.c_char_p),
    },
    "flash_bwd": {
        # (dtype, device, q, k, v, seg, [tables,] dout, lse, delta, outputs...,
        #  B, S, H, KV, D, bq, bkv, causal, scale, stream)
        "flash_bwd_dq_dense": ([_c_int, _c_int] + [_ptr] * 8 + [_c_int] * 8 + [_c_float, _ptr], _c_int),
        "flash_bwd_dq_pruned": ([_c_int, _c_int] + [_ptr] * 10 + [_c_int] * 8 + [_c_float, _ptr], _c_int),
        "flash_bwd_dkv_dense": ([_c_int, _c_int] + [_ptr] * 9 + [_c_int] * 8 + [_c_float, _ptr], _c_int),
        "flash_bwd_dkv_pruned": ([_c_int, _c_int] + [_ptr] * 11 + [_c_int] * 8 + [_c_float, _ptr], _c_int),
        "flash_error_string": ([_c_int], ctypes.c_char_p),
    },
    "ssd_scan": {
        # (dtype, device, x, adt, dt, b, c, init_state, y, final_state,
        #  states, decay, scores (the bf16 route's scratch),
        #  B, S, H, P, N, chunk, x/b/c batch and row strides, stream)
        "ssd_scan_fwd": ([_c_int, _c_int] + [_ptr] * 11 + [_c_int] * 12 + [_ptr], _c_int),
        "ssd_error_string": ([_c_int], ctypes.c_char_p),
    },
    "adamw": {
        # (g dtype, device, host table, leaves, blocks, chunk, partials, stream)
        "adamw_sqnorm": ([_c_int, _c_int, _ptr, _c_int, _c_int, _c_int64, _ptr, _ptr], _c_int),
        # (device, partials, count, step, scalars, host constants, stream)
        "adamw_finish": ([_c_int, _ptr, _c_int, _ptr, _ptr, _ptr, _ptr], _c_int),
        # (p, g, m dtypes, device, host table, leaves, blocks, chunk, scalars, host constants, stream)
        "adamw_update": ([_c_int] * 4 + [_ptr, _c_int, _c_int, _c_int64, _ptr, _ptr, _ptr], _c_int),
        "adamw_error_string": ([_c_int], ctypes.c_char_p),
    },
    "mla_attention": {
        # (device, q, k_nope, k_rope, v, seg, row tables, out, lse, B, S, H, bq, bkv, causal, scale, stream)
        "mla_fwd": ([_c_int] + [_ptr] * 9 + [_c_int] * 6 + [_c_float, _ptr], _c_int),
        # (device, q, k_nope, k_rope, v, seg, row tables, dout, lse, delta, dq, B, S, H, bq, bkv, causal,
        #  scale, stream)
        "mla_bwd_dq": ([_c_int] + [_ptr] * 11 + [_c_int] * 6 + [_c_float, _ptr], _c_int),
        # (device, q, k_nope, k_rope, v, seg, column tables, dout, lse, delta, dk_nope, dk_rope per head,
        #  dv, B, S, H, bq, bkv, causal, scale, stream)
        "mla_bwd_dkv": ([_c_int] + [_ptr] * 13 + [_c_int] * 6 + [_c_float, _ptr], _c_int),
        "mla_error_string": ([_c_int], ctypes.c_char_p),
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name -> nvcc/ptxas output of the library's build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: cannot build the CUDA kernels")


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, pathlib.Path]:
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = {}
    for name, path in paths.items():
        if path.exists():
            log = path.with_suffix(".log")
            if name not in BUILD_LOGS and log.exists():
                BUILD_LOGS[name] = log.read_text()
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in running.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        paths[name].with_suffix(".log").write_text(log)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def ptxas_spills(log: str) -> dict[str, int]:
    """Spill bytes (stores plus loads) of every function in a ``ptxas -v``
    log, by mangled name."""
    spills, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1].strip()
        elif name is not None and "spill stores" in line:
            spills[name] = sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
            name = None
    return spills


def load_library(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its C signatures declared."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        for fn_name, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib.error_string = next(getattr(lib, fn) for fn in SIGNATURES[name] if fn.endswith("_error_string"))
        _LOADED[name] = lib
    return lib


def launch_arg(arg):
    """A launch argument as the C interface takes it: a tensor as its device
    address, None as a null pointer, anything else as it is."""
    if isinstance(arg, torch.Tensor):
        return ctypes.c_void_p(arg.data_ptr())
    return ctypes.c_void_p(0) if arg is None else arg


def launch(lib, fn: str, *args, device, launches: dict, name: str | None = None,
           counter: tuple[str, str] | None = None) -> None:
    """``lib.fn(*args, stream)`` on the current stream of the CUDA ``device``,
    each argument through :func:`launch_arg`.  A non-zero return raises
    ``"{name}: CUDA error {rc} ({msg})"`` with the library's message and
    counts nothing; else ``launches[name]`` (``name`` defaults to ``fn``)
    and, where ``counter`` gives one as ``(name, help)``, that registry
    counter go up by one."""
    name = name or fn
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    rc = getattr(lib, fn)(*map(launch_arg, args), stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({lib.error_string(rc).decode()})")
    launches[name] += 1
    if counter is not None:
        obs.counter(counter[0], help=counter[1]).inc()
