"""Per-rank cost model of one step, counted from the ops a rank
dispatches (the JAX package's `launch/hlo_costmodel.py`).

The reference re-derives FLOPs, HBM bytes and collective bytes from the
compiled per-device HLO text, multiplying each `while` body by its trip
count (XLA's own `cost_analysis()` visits a scan body once). The port
has no HLO and compiles nothing: eager PyTorch runs every op it
dispatches, and the port's layer, micro-batch and worker loops are
Python loops that dispatch every iteration's ops, so there is no loop
body to multiply and no trip count to recover. The counts here are the
sums over the dispatched ops.

`OpCostModel` is a `TorchDispatchMode` that counts, for this rank:

- only calls on plain (local) tensors. A call whose arguments are
  DTensors carries the global shapes: the mode passes it down
  (`NotImplemented`) to DTensor, which runs it on the local shards and
  issues its collectives, and those calls are counted. DTensor's
  sharding propagation runs each new op once more on fake tensors of the
  global shapes, under a fake mode of its own: calls on another fake
  mode's tensors are not counted either. (`FlopCounterMode` over
  DTensors counts the global work: a product row-sharded over 4 ranks
  four times over.)
- FLOPs: `torch.utils.flop_counter`'s formulas (matrix products,
  convolutions) and the kernels' operators' own (`runtime.register_op`:
  flash 4 hd a visited pair forward, 10 hd backward). Elementwise ops
  count none, as the reference counts dots only.
- HBM bytes: operand plus result bytes of every op that returns a
  tensor, views and aliases excepted (they move nothing); a kernel
  operator's bytes are its own definition (`runtime.op_cost`). Eager
  PyTorch fuses nothing, so every such op is the analogue of the
  reference's top-level materializing instruction.
- collectives: per kind, under the reference's five names, with their
  operand (payload) bytes and counts; a group of one rank moves nothing
  and is not counted.
- memory: the bytes of live storages over the step, the arguments'
  apart; the peak, and at the peak the temporaries' bytes by the port
  function that made them.
- an op table of (issuing port function, op, calls, flops, bytes,
  collective bytes) for `launch/profile.py`.

Under fake tensors a value read back to the host (`.item()`, a tensor
used as an index) has no data: the mode answers 0 (False), and counts
each such read by its issuing function (`data_dependent`), so a record
shows where the trace took a placeholder branch.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          is_traceable_wrapper_subclass)
from torch.utils._pytree import tree_leaves as _leaves

from repro_torch.kernels import runtime

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# op name (without namespace and overload) -> the reference's kind; the
# functional collectives (`_c10d_functional`, DTensor's) and c10d's own
_KIND = {}
for _k, _names in {
        "all-gather": ("all_gather_into_tensor",
                       "all_gather_into_tensor_coalesced", "allgather_",
                       "_allgather_base_", "allgather_coalesced_",
                       "allgather_into_tensor_coalesced_"),
        "all-reduce": ("all_reduce", "all_reduce_coalesced", "allreduce_",
                       "allreduce_coalesced_"),
        "reduce-scatter": ("reduce_scatter_tensor",
                           "reduce_scatter_tensor_coalesced",
                           "reduce_scatter_", "_reduce_scatter_base_",
                           "reduce_scatter_tensor_coalesced_"),
        "all-to-all": ("all_to_all_single", "alltoall_", "alltoall_base_"),
        "collective-permute": ("broadcast", "broadcast_", "send", "recv_",
                               "gather_", "scatter_")}.items():
    for _n in _names:
        _KIND[_n] = _k
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# ops that move no bytes though they return a tensor
# ops that return their input: waiting on a collective's output, eager
# collectives' autograd wrapper of it
_IDENTITY = {"wait_tensor", "_wrap_tensor_autograd"}
_NO_BYTES = {"detach", "alias", "lift_fresh", "_unsafe_view",
             "empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "set_", "resize_"}
_HERE = __file__
_PORT = "repro_torch"
_PROPAGATION = "_sharding_prop.py"


def _issuer() -> Optional[str]:
    """The innermost port function on this thread's Python stack
    ("module/file.py:function"), "(autograd)" where none is (a backward
    run by autograd's engine); None inside DTensor's sharding
    propagation, whose calls on global-shape stand-ins are no rank's
    work."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.endswith(_PROPAGATION):
            return None
        if _PORT in name and name != _HERE:
            return (name.split(_PORT + "/", 1)[-1] + ":"
                    + f.f_code.co_name)
        f = f.f_back
    return "(autograd)"


def _tensors(x, out: list) -> list:
    """The tensors in an op's arguments or result (lists, tuples and
    dicts of them), appended to `out` (an op's arguments are shallow: no
    pytree walk on every dispatch)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args, kwargs) -> Optional[int]:
    """The process group's size of a collective's call (a group object,
    or a functional collective's group name)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if hasattr(a, "size") and not torch.is_tensor(a) and callable(
                getattr(a, "size", None)):
            try:
                return int(a.size())
            except (TypeError, RuntimeError):
                continue
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return int(_resolve_process_group(a).size())
            except (ValueError, RuntimeError, KeyError):
                continue
    return None


def _payload(func, args, kwargs) -> int:
    """A collective's operand bytes (the reference's payload): the
    tensors of every argument that is not an output."""
    total = 0
    for spec, a in zip(func._schema.arguments, list(args) + [
            kwargs.get(s.name) for s in func._schema.arguments[len(args):]]):
        if spec.name.startswith("output") or a is None:
            continue
        total += sum(_tensor_bytes(t) for t in _tensors(a, []))
    return total


class OpCostModel(TorchDispatchMode):
    """Counts what this rank dispatches while it is entered (see the
    module doc). `fake_mode` is the FakeTensorMode the traced tensors
    belong to (None for real tensors): tensors of any other fake mode are
    DTensor's sharding propagation and are not counted."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0
        self.hbm_bytes = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_count = {k: 0 for k in COLLECTIVES}
        self.table: dict[tuple[str, str], list] = defaultdict(
            lambda: [0, 0, 0, 0])
        self.data_dependent: dict[str, int] = defaultdict(int)
        self.arguments: dict[str, int] = defaultdict(int)
        self._arg_storages: set[int] = set()
        self._keep: list = []       # storages standing for an argument's
        # storage id -> [bytes, issuing function, storages sharing it]
        self._records: dict[int, list] = {}
        self._refs: dict[int, Any] = {}
        self._live_by_fn: dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0
        self.peak_by_fn: dict[str, int] = {}

    # -- memory ----------------------------------------------------------
    def add_arguments(self, tree, label: str) -> None:
        """Count the storages of `tree`'s tensors (DTensors by their
        local shard) as the step's arguments, under `label`; a storage
        shared by two leaves counts once."""
        for t in _leaves(tree):
            if not torch.is_tensor(t):
                continue
            t = t.to_local() if hasattr(t, "to_local") else t
            st = t.untyped_storage()
            if id(st) in self._arg_storages:
                continue
            self._arg_storages.add(id(st))
            self.arguments[label] += st.nbytes()

    def _track(self, t: torch.Tensor, fn: str, like=None) -> None:
        """Count t's storage as live until it is freed; `like`, a tensor
        t stands for (an identity op's input, whose output a fake tensor
        puts in storage of its own), shares its record, so the bytes
        count once while either storage lives."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._arg_storages or key in self._records:
            return
        if like is not None:
            other = id(like.untyped_storage())
            if other in self._arg_storages:
                self._arg_storages.add(key)
                self._keep.append(st)
                return
            rec = self._records.get(other)
            if rec is None:
                return
        else:
            rec = [st.nbytes(), fn, 0]
            self._live_by_fn[fn] += rec[0]
            self.live += rec[0]
            if self.live > self.peak:
                self.peak = self.live
                self.peak_by_fn = {k: v for k, v in self._live_by_fn.items()
                                   if v}
        rec[2] += 1
        self._records[key] = rec
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._free(key))

    def _free(self, key: int) -> None:
        rec = self._records.pop(key)
        self._refs.pop(key, None)
        rec[2] -= 1
        if rec[2] == 0:
            self._live_by_fn[rec[1]] -= rec[0]
            self.live -= rec[0]

    def output_bytes(self, tree) -> int:
        """Bytes of the distinct storages of `tree`'s tensors that are
        not arguments (what the step returns anew)."""
        seen, total = set(), 0
        for t in _leaves(tree):
            if not torch.is_tensor(t):
                continue
            t = t.to_local() if hasattr(t, "to_local") else t
            st = t.untyped_storage()
            if id(st) in seen or id(st) in self._arg_storages:
                continue
            seen.add(id(st))
            total += st.nbytes()
        return total

    # -- dispatch --------------------------------------------------------
    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode
                   is not self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(kwargs, _tensors(args, []))
        if any(is_traceable_wrapper_subclass(t) for t in ins):
            return NotImplemented
        if (func is torch.ops.aten._local_scalar_dense.default
                and self.fake_mode is not None and not self._foreign(ins)
                and isinstance(args[0], torch._subclasses.FakeTensor)):
            self.data_dependent[_issuer() or "(propagation)"] += 1
            x = args[0]
            return (False if x.dtype == torch.bool
                    else 0.0 if x.dtype.is_floating_point else 0)
        out = func(*args, **kwargs)
        outs = _tensors(out, [])
        fn = _issuer()
        if fn is None or self._foreign(ins) or self._foreign(outs):
            return out
        self._count(func, args, kwargs, ins, outs, fn)
        return out

    def _count(self, func, args, kwargs, ins, outs, fn: str) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        kind = _KIND.get(name) if ns in _NAMESPACES else None
        if not outs and kind is None:
            return          # metadata (a device, a size, a host read)
        if name in _IDENTITY:
            # the collective's output itself, which a fake tensor gives
            # a storage of its own
            for t in outs:
                self._track(t, fn, like=ins[0])
            return
        flops = nbytes = coll = 0
        size = None
        if kind is not None:
            size = _group_size(args, kwargs)
            if size != 1:
                coll = _payload(func, args, kwargs)
                self.coll_bytes[kind] += coll
                self.coll_count[kind] += 1
                nbytes = coll + sum(_tensor_bytes(t) for t in outs)
        else:
            cost = runtime.op_cost(func, *args, **kwargs)
            if cost is not None:
                flops, nbytes = cost
            else:
                from torch.utils.flop_counter import flop_registry
                formula = flop_registry.get(func._overloadpacket)
                if formula is not None:
                    flops = int(formula(*args, **kwargs, out_val=(
                        outs[0] if len(outs) == 1 else tuple(outs))))
                if outs and not func.is_view and name not in _NO_BYTES:
                    nbytes = (sum(_tensor_bytes(t) for t in ins)
                              + sum(_tensor_bytes(t) for t in outs))
        if not func.is_view:
            # a fresh storage (a view's, or an in-place op's, is its
            # input's; one the step did not make predates it)
            have = {id(t.untyped_storage()) for t in ins}
            for t in outs:
                if id(t.untyped_storage()) not in have:
                    self._track(t, fn)
        if kind is not None and size == 1:
            return                  # a group of one rank: no collective
        self.flops += flops
        self.hbm_bytes += nbytes
        row = self.table[(fn, f"{ns}.{name}")]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        row[3] += coll

    # -- results ---------------------------------------------------------
    def collectives(self) -> dict:
        """The reference's collective summary keys."""
        return {"by_kind_bytes": dict(self.coll_bytes),
                "by_kind_count": dict(self.coll_count),
                "total_bytes": int(sum(self.coll_bytes.values()))}

    def op_table(self) -> list[dict]:
        """[{fn, op, calls, flops, bytes, coll_bytes}], by issuing port
        function and op."""
        return [{"fn": fn, "op": op, "calls": r[0], "flops": r[1],
                 "bytes": r[2], "coll_bytes": r[3]}
                for (fn, op), r in sorted(self.table.items())]

    def summary(self, outputs=None) -> dict:
        """Totals: flops, hbm_bytes, collectives, memory (argument,
        output and temp bytes, and the peak of live bytes; temp = peak -
        arguments - outputs, floored at 0), the peak's breakdown, the
        data-dependent reads."""
        arg = int(sum(self.arguments.values()))
        out = self.output_bytes(outputs) if outputs is not None else 0
        peak = arg + self.peak
        return {
            "flops": int(self.flops), "hbm_bytes": int(self.hbm_bytes),
            "collectives": self.collectives(),
            "memory": {"argument_bytes": arg, "output_bytes": out,
                       "temp_bytes": max(0, peak - arg - out),
                       "peak_bytes": peak},
            "peak_breakdown": {
                "arguments": dict(self.arguments),
                "temporaries": dict(sorted(self.peak_by_fn.items(),
                                           key=lambda kv: -kv[1]))},
            "data_dependent": dict(self.data_dependent)}


def count_step(fn, args: tuple, *, parts: Optional[list] = None,
               fake_mode=None):
    """Run `fn(*args)` under an OpCostModel (inside `fake_mode`, entered
    by the caller, when the args are its fake tensors) and return (the
    step's result, the model): any step, real or fake, on any mesh.
    `parts` [(label, tree)] names the arguments' pieces for the memory
    breakdown (default: arg0, arg1, ... for each argument)."""
    cm = OpCostModel(fake_mode)
    for label, tree in (parts if parts is not None else
                        [(f"arg{i}", a) for i, a in enumerate(args)]):
        cm.add_arguments(tree, label)
    with cm:
        out = fn(*args)
    return out, cm


def summary_from_table(rows: list[dict]) -> dict:
    """flops, hbm_bytes and the collective summary from a saved op table
    (`OpCostModel.op_table`), with no re-trace."""
    coll_b = {k: 0 for k in COLLECTIVES}
    coll_c = {k: 0 for k in COLLECTIVES}
    for r in rows:
        ns, name = r["op"].split(".", 1)
        kind = _KIND.get(name) if ns in _NAMESPACES else None
        if kind is not None:
            coll_b[kind] += r["coll_bytes"]
            coll_c[kind] += r["calls"]
    return {"flops": int(sum(r["flops"] for r in rows)),
            "hbm_bytes": int(sum(r["bytes"] for r in rows)),
            "collectives": {"by_kind_bytes": coll_b, "by_kind_count": coll_c,
                            "total_bytes": int(sum(coll_b.values()))}}
