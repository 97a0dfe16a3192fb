"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own, for ``sm_90a`` (Hopper), into a
shared library with a plain C interface: ``build/kernels/lib<name>.so`` at
the root of the source tree, a directory that ``.gitignore`` lists.  A
library is built at the first CUDA call that needs it, or up front by
:func:`build` — never while a module is imported, so the CPU-only test
environment, which has no ``nvcc``, imports every module freely.

Every C entry point takes pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
nonzero code into an exception, because a refused launch never runs and
``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

__all__ = ["KERNELS", "BUILD_DIR", "build", "cuda_device", "sm_count",
           "symbol", "function", "check", "launches"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("rgcsr_spmv", "rgcsr_spmm", "ell_spmv", "paged_attention")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_DTYPE_TAGS = {"torch.float32": "f32", "torch.bfloat16": "bf16"}

# Kernel launches per kernel, counted by each launcher where it launches
# (never for the plain versions); read and reset through repro_torch.kernels.
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, object] = {}
_sm_counts: Dict[int, int] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = _library_path(name)
    if not out.exists():
        return True
    sources = [CSRC / f"{name}.cu", CSRC / "common.cuh"]
    return out.stat().st_mtime < max(s.stat().st_mtime for s in sources)


def build(names: Iterable[str] = KERNELS, *, force: bool = False
          ) -> Dict[str, str]:
    """Compile the named kernels, all ``nvcc`` processes at once.

    Returns the compiler's output per kernel (``-Xptxas -v`` prints each
    kernel's registers, shared memory and spills).  Raises if any build
    fails.  Up-to-date libraries are not rebuilt unless ``force``.
    """
    names = [n for n in names if force or _stale(n)]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def _library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def cuda_device(name: str, tensors):
    """Where kernel ``name`` runs for these tensors: ``None`` when all lie on
    the CPU (the caller then runs its plain version), else the one CUDA
    device they share.  Anything else raises — a CUDA tensor never falls
    back to the plain version."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return None
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: all tensors must be on one CUDA device "
                         f"(or all on the CPU), got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return next(iter(devices))


def sm_count(dev) -> int:
    """Streaming multiprocessors of CUDA device ``dev``, asked once."""
    n = _sm_counts.get(dev.index)
    if n is None:
        import torch
        n = _sm_counts[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def symbol(name: str, value_dtype, x_dtype) -> str:
    """C entry point of kernel ``name`` for values and x of these dtypes."""
    tags = [_DTYPE_TAGS.get(str(dt)) for dt in (value_dtype, x_dtype)]
    if None in tags:
        raise ValueError(f"{name}: the kernels take float32 or bfloat16 "
                         f"values and x, got {value_dtype} and {x_dtype}")
    return f"{name}_{tags[0]}_{tags[1]}"


def function(name: str, symbol: str, argtypes: Sequence):
    """The C entry point ``symbol`` of kernel library ``name``, with its
    argument types declared (pointers as ``c_void_p`` — ctypes would cut an
    undeclared pointer to 32 bits)."""
    key = (name, symbol)
    fn = _functions.get(key)
    if fn is None:
        fn = getattr(_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch of kernel ``name`` returned a CUDA error."""
    if err != 0:
        msg = _library(name).error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
