"""Wrapper for the fused PSO update kernel (paper Eq. 8) over one
stacked leaf of the swarm state:

    v' = c0 v + c1 (wl - w) + c2 (wg - w) + d     (clipped to +-clip)
    w' = w + v'

with per-worker coefficients. This is the LocalUpdate of
`core/swarm_dist`: one launch per leaf per round for all W workers.

The launch is the operator repro_torch::pso_update
(`runtime.register_op`): the dispatcher sends a CPU tensor to the plain
version (ref.py), a CUDA tensor to csrc/pso_update.cu (or raises), a
fake tensor to the shape rule. The
kernel takes the leaf flat, (W, n), with wg (n,) broadcast over the
workers, so no padding to blocks is needed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import runtime
from repro_torch.sharding import boundary
from repro_torch.sharding.rules import is_dtensor
from repro_torch.kernels.pso_update.ref import pso_update_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = runtime.library("pso_update")
    if lib.pu_pso_update.argtypes is None:
        lib.pu_pso_update.argtypes = [_P] * 8 + [_I, _L, _I, _I, _P]
        lib.pu_pso_update.restype = _I
    return lib


def _pso_cuda(coefs, w, v, wl, wg, d):
    runtime.require_cuda(w)
    if w.dtype not in _DTYPES:
        raise ValueError(f"pso_update: dtype {w.dtype} not f32/bf16")
    W, leaf = w.shape[0], tuple(w.shape[1:])
    dev = w.device
    runtime.require(coefs, torch.float32, (W, 4), "pso_update coefs", dev)
    for name, t in (("w", w), ("v", v), ("wl", wl), ("d", d)):
        runtime.require(t, w.dtype, (W,) + leaf, f"pso_update {name}", dev)
    runtime.require(wg, w.dtype, leaf, "pso_update wg", dev)
    w_out, v_out = torch.empty_like(w), torch.empty_like(v)
    n = wg.numel()
    if W * n == 0:
        return w_out, v_out
    # 16-byte vectors when every worker's row starts on a 16-byte boundary
    vec = 16 // w.element_size()
    ptrs = (w, v, wl, wg, d, w_out, v_out)
    if n % vec or any(t.data_ptr() % 16 for t in ptrs):
        vec = 1
    err = _lib().pu_pso_update(
        coefs.data_ptr(), *(t.data_ptr() for t in ptrs), W, n,
        _DTYPES[w.dtype], vec, runtime.stream_ptr(w))
    runtime.check(err, "pso_update")
    runtime.note_launch("pso_update")
    return w_out, v_out


def _pso_fake(coefs, w, v, wl, wg, d):
    if w.dtype not in _DTYPES:
        raise ValueError(f"pso_update: dtype {w.dtype} not f32/bf16")
    return torch.empty_like(w), torch.empty_like(v)


def _pso_cost(coefs, w, v, wl, wg, d):
    """8 operations an element of the W stacked leaves; w, v, wl, d in,
    w', v' out, wg once, the (W, 4) coefficients."""
    n = w.numel()
    return 8 * n, w.element_size() * (6 * n + wg.numel()) + 16 * w.shape[0]


PSO_UPDATE = runtime.register_op(
    "pso_update",
    "(Tensor coefs, Tensor w, Tensor v, Tensor wl, Tensor wg, Tensor d) "
    "-> (Tensor, Tensor)",
    cuda=_pso_cuda, cpu=pso_update_ref, fake=_pso_fake, cost=_pso_cost)


def pso_update(coefs: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
               wl: torch.Tensor, wg: torch.Tensor, d: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """coefs (W, 4) f32 rows (c0, c1, c2, clip), clip <= 0 = no clip;
    w, v, wl, d (W, *leaf) and wg (*leaf), all f32 or all bf16.
    Returns new (w', v') tensors in the leaf dtype. DTensor inputs run
    on each rank's shards (`sharding.boundary.pso`)."""
    if any(is_dtensor(t) for t in (coefs, w, v, wl, wg, d)):
        return boundary.pso(pso_update, coefs, w, v, wl, wg, d)
    fn = _pso_cuda if runtime.direct(w) else PSO_UPDATE
    return fn(coefs, w, v, wl, wg, d)
