"""Kernel runtime: device resolution, per-kernel launch counters, and the
nvcc build + ctypes loader for the hand-written CUDA kernels.

Dispatch rule (every `ops.py` wrapper): the device of the tensor picks
the implementation. A CPU tensor takes the plain PyTorch version in the
kernel's `ref.py`; a CUDA tensor launches the CUDA kernel or raises.
There is no fallback from one to the other.

Build: each `csrc/*.cu` source compiles on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <name>.cu

into `build/repro_torch/` at the repository root, cached by a hash of
the source and the flags. `build_all()` starts one nvcc per source at
once. The libraries have a plain C interface (pointers and the stream as
`void*`, each function returns `cudaGetLastError()`), loaded with
`ctypes` — no PyTorch headers, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("quant_pack", "wire_agg", "flash_attention", "flash_attention_bwd",
           "rglru_scan", "pso_update")

# launches of each CUDA kernel since the last reset_counts(); a wrapper
# adds one exactly where it launches its kernel (plain versions on CPU
# tensors never count)
_COUNTS: Counter = Counter()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's choice, else the
    first CUDA card. With no card and no explicit device this raises —
    the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda", 0)


def note_launch(name: str) -> None:
    _COUNTS[name] += 1


def counts() -> dict[str, int]:
    return dict(_COUNTS)


def reset_counts() -> None:
    _COUNTS.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start_build(name: str) -> Optional[tuple[subprocess.Popen, Path, Path]]:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builds agree


def build_all(names=SOURCES) -> None:
    """Compile every missing kernel library, one nvcc per source, all
    started together."""
    jobs = [_start_build(n) for n in names]
    for job in jobs:
        _finish_build(job)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish_build(_start_build(name))
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launcher (a
    refused launch never runs and synchronize() would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def require(t: torch.Tensor, dtype: torch.dtype, shape: tuple, what: str,
            device: torch.device) -> None:
    """Wrapper-side argument check before a pointer crosses into C."""
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
