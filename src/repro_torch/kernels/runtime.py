"""Kernel runtime: device resolution, per-kernel launch counters, the obs
dispatch hook, and the nvcc build + ctypes loader for the hand-written
CUDA kernels.

Dispatch rule (every `ops.py` wrapper): the device of the tensor picks
the implementation. A CPU tensor takes the plain PyTorch version in the
kernel's `ref.py`; a CUDA tensor launches the CUDA kernel or raises.
There is no fallback from one to the other.

Build: each `csrc/*.cu` source compiles on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <name>.cu

into `build/repro_torch/` at the repository root, cached by a hash of
the source, every shared header (`csrc/*.cuh`) and the flags.
`build_all()` starts one nvcc per source at once. The libraries have a
plain C interface (pointers and the stream as `void*`, each function
returns `cudaGetLastError()`), loaded with `ctypes` — no PyTorch
headers, so a build takes seconds.

Operators: every launch site is an operator of the `repro_torch`
namespace (`register_op`, PyTorch's low-level `torch.library.Library`
registration: a dispatcher call and no Python layer of its own), so the
dispatcher picks the implementation by the device (a plain CUDA tensor
with no dispatch mode active skips the dispatcher for the one it would
pick, `direct`): the CUDA one is the
kernel's `ctypes` launch (which counts it in `note_launch`), the CPU one
the plain version, and the fake one gives the outputs' shapes, dtypes
and strides only (FakeTensorMode, meta tensors: no launch, no count),
the part a Pallas call's abstract evaluation plays in the reference.
Each operator's cost (`op_cost`: operations and the bytes it must move,
each input read once and each output written once) is defined once,
beside it; `torch.utils.flop_counter` reads its operations, the cost
model (`launch/op_costmodel.py`) both, and chip_smoke.py's bound column
the same definition.
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
from typing import Callable, Optional

import torch

# the wrappers' KernelEvent hook, re-exported beside note_launch
from repro_torch.obs.trace import note_dispatch  # noqa: F401

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("quant_pack", "wire_agg", "flash_attention", "flash_attention_bwd",
           "rglru_scan", "rglru_scan_bwd", "pso_update", "worker_conv")

# launches of each CUDA kernel since the last reset_counts(); a wrapper
# adds one exactly where it launches its kernel (plain versions on CPU
# tensors never count)
_COUNTS: Counter = Counter()
# the same, keyed by (name, C) for the wire kernels, whose leading dim is
# the worker count: one kernel runs at C workers on the uplink and at 1
# on the downlink, and a reader can tell those launches apart
_BY_WORKERS: Counter = Counter()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


# the kernels' operators: repro_torch::<name>
LIB = torch.library.Library("repro_torch", "DEF")
# OpOverload -> cost(*args) -> (operations, bytes)
_COSTS: dict = {}


def register_op(name: str, schema: str, *, cuda: Callable, cpu: Callable,
                fake: Callable, cost: Callable):
    """Define the operator repro_torch::<name><schema> with a CUDA
    implementation (the kernel's launch), a CPU one (the plain version),
    a fake one (output shapes, dtypes and strides; it launches and
    counts nothing) and `cost(*args) -> (operations, bytes)` from the
    arguments' shapes, which `torch.utils.flop_counter` also reads.
    Returns the operator's overload, which the wrappers call."""
    from torch.utils.flop_counter import register_flop_formula
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=LIB)
    op = getattr(torch.ops.repro_torch, name)
    register_flop_formula(op, get_raw=True)(
        lambda *args, out_val=None, **kwargs: cost(*args, **kwargs)[0])
    _COSTS[op.default] = cost
    return op.default


def direct(t: torch.Tensor) -> bool:
    """Whether a wrapper calls its operator's CUDA implementation itself:
    t is a plain CUDA tensor and no dispatch mode (a fake tensor mode, the
    cost model) is active, so the dispatcher would pick that
    implementation anyway. Letting the dispatcher call a Python kernel
    costs several µs a call on the card's host (chip_smoke.py phase 40
    measures it; PERF.md §6), more than a small kernel's eager call may
    grow by; everything else (CPU, meta and fake tensors, any mode) goes
    through the operator."""
    return (type(t) is torch.Tensor and t.is_cuda
            and not torch._C._len_torch_dispatch_stack())


def op_cost(op, *args, **kwargs) -> Optional[tuple[int, int]]:
    """(operations, bytes) of one call of a kernel operator, from its
    arguments' shapes; None for any other operator."""
    cost = _COSTS.get(op)
    return None if cost is None else cost(*args, **kwargs)


def require_cuda(t: torch.Tensor) -> None:
    """A kernel launches on CUDA tensors only (the dispatcher sends it
    nothing else; a direct call on another device raises)."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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


def note_launch(name: str, workers: Optional[int] = None) -> None:
    _COUNTS[name] += 1
    if workers is not None:
        _BY_WORKERS[(name, workers)] += 1


def counts() -> dict[str, int]:
    return dict(_COUNTS)


def counts_by_workers() -> dict[str, dict[int, int]]:
    """{name: {C: launches}} of the launches that named their worker
    count, since the last reset_counts()."""
    out: dict[str, dict[int, int]] = {}
    for (name, c), n in sorted(_BY_WORKERS.items()):
        out.setdefault(name, {})[c] = n
    return out


def reset_counts() -> None:
    _COUNTS.clear()
    _BY_WORKERS.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, of every
    header a source may include and of the flags: a changed header
    builds anew rather than reusing a stale library."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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
