"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each source is compiled into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), for ``sm_90a``, into
``build/repro_torch/`` at the root of the checkout.  The library name carries
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded from the earlier build.  Nothing is built at import:
the first kernel launch (or :func:`build_all`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_fwd", "flash_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_int, _c_float, _ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
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
}

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name -> nvcc/ptxas output of this process's build


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
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, pathlib.Path]:
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = {}
    for name, path in paths.items():
        if path.exists():
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
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The built library ``name`` with its C signatures declared."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        for fn_name, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LOADED[name] = lib
    return lib
