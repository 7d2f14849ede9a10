"""Op cost census: FLOPs / memory / collective bytes, per device.

The port has no compiled HLO to read, so where the reference walks the
optimized HLO text (``repro.roofline.hlo_cost``) this module watches the
ops themselves: ``OpCounter`` is a ``TorchDispatchMode`` that sees every
aten op a step runs, eagerly, at the shapes one device computes.  Above a
DTensor an op shows its *global* shape; the counter declines those ops
(``NotImplemented``), so DTensor runs them and the counter sees the local
ops on each shard and the collectives that move data between shards, the
per-device program the reference's SPMD module describes.  Eager
execution runs every layer's ops, so no loop scaling is needed.

Conventions (XLA's cost analysis, which ``flops_of_jaxpr`` reads):

* flops            — 2·M·N·K for every matmul-like op (mm, bmm, addmm,
                     baddbmm, addbmm, mv, dot); one per output element
                     for elementwise arithmetic (ops tagged ``pointwise``);
                     input elements minus output elements for a reduction.
                     Transcendentals (exp, log, sqrt, tanh, ...) are
                     counted apart and not in flops.
* collective bytes — output-shape bytes of all-gather / all-reduce /
                     reduce-scatter / all-to-all (the functional
                     collectives, ``_c10d_functional``), per device.
* memory bytes     — each op's tensor operands plus its outputs: an
                     HBM-traffic upper bound that counts a value once for
                     every op that reads it, as the reference's does.
                     Views, which move no data, count nothing.

DTensor works out each op's global output shape by running it once on
fake tensors of the global shape (its sharding propagation); those runs
count nothing.  Ops on the meta device count as any other (the dry run
holds its shards there: shapes and dtypes, no storage).
``OpCounter`` also keeps the peak of live bytes of the tensors created
inside it (by storage, so a view adds nothing), which the dry run adds to
the arguments' bytes for its per-device memory figure.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# _c10d_functional op name (overload packet) -> collective kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_MATMUL_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot", "mv", "addmv"}
_REDUCTION_OPS = {"sum", "mean", "prod", "amax", "amin", "max", "min", "argmax",
                  "argmin", "logsumexp", "norm", "linalg_vector_norm", "any", "all",
                  "var", "std", "cumsum", "cumprod", "_softmax", "_log_softmax"}
_TRANSCENDENTAL_OPS = {"exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt",
                       "rsqrt", "tanh", "sigmoid", "sin", "cos", "tan", "asin", "acos",
                       "atan", "atan2", "sinh", "cosh", "erf", "erfc", "erfinv", "pow",
                       "silu", "gelu", "softplus", "logit", "reciprocal"}
# data movement, which XLA counts as no flops (copy, broadcast fills)
_COPY_OPS = {"clone", "copy", "fill", "zero", "lift_fresh", "full_like", "zeros_like",
             "ones_like"}


@dataclasses.dataclass
class OpCost:
    flops: float
    mem_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, float]
    transcendentals: float = 0.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _matmul_flops(name: str, args, out) -> float:
    """2 x output elements x contracted size."""
    if name in ("mm", "matmul", "dot", "mv"):
        a = args[0]
    elif name in ("addmm", "addmv"):
        a = args[1]
    elif name == "bmm":
        a = args[0]
    else:  # baddbmm, addbmm
        a = args[1]
    k = a.shape[-1] if a.dim() else 1
    outs = out if isinstance(out, torch.Tensor) else out[0]
    return 2.0 * _numel(outs.shape) * k


def tensors_in(args, kwargs) -> list:
    """The tensors among an op's arguments (an aten op nests them at most
    one list deep)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _in_sharding_propagation() -> bool:
    """Whether this op runs inside DTensor's output-shape propagation."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        frame = frame.f_back
    return False


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside it; ``cost()`` gives the ``OpCost``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.transcendentals = 0.0
        self.mem_bytes = 0.0
        self.coll_by_kind: Dict[str, float] = {k: 0.0 for k in _COLLECTIVE_KINDS}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet()

    def cost(self) -> OpCost:
        by_kind = dict(self.coll_by_kind)
        return OpCost(self.flops, self.mem_bytes, float(sum(by_kind.values())), by_kind,
                      self.transcendentals)

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        nbytes = st.nbytes()
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = tensors_in(args, kwargs)
        if any(type(a).__name__ == "DTensor" for a in tensors):
            return NotImplemented  # DTensor runs it; its local ops come back here
        out = func(*args, **kwargs)
        outs = tensors_in(out if isinstance(out, (list, tuple)) else (out,), {})
        if (any(t.device.type == "meta" or type(t).__name__ == "FakeTensor"
                for t in tensors + outs) and _in_sharding_propagation()):
            return out
        namespace = func.namespace
        name = func.overloadpacket.__name__
        if namespace == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                nbytes = sum(_nbytes(o) for o in outs)
                self.coll_by_kind[kind] += nbytes
                self.mem_bytes += 2 * nbytes
                self.ops += 1
            return out
        if namespace != "aten" or func.is_view:
            return out
        self.ops += 1
        for o in outs:
            self._track(o)
        base = name.rstrip("_")
        if base in _MATMUL_OPS:
            self.flops += _matmul_flops(base, args, out)
        elif base in _REDUCTION_OPS:
            n_in = _numel(tensors[0].shape) if tensors else 0
            n_out = _numel(outs[0].shape) if outs else 0
            if base in ("_softmax", "_log_softmax"):
                self.transcendentals += n_in
                self.flops += 3 * n_in  # max, subtract, sum (and a divide)
            else:
                self.flops += max(n_in - n_out, 0)
        elif base in _TRANSCENDENTAL_OPS:
            self.transcendentals += sum(_numel(o.shape) for o in outs)
        elif torch.Tag.pointwise in func.tags and base not in _COPY_OPS:
            self.flops += sum(_numel(o.shape) for o in outs)
        self.mem_bytes += sum(_nbytes(a) for a in tensors) + sum(_nbytes(o) for o in outs)
        return out


def op_cost(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCost)``: the call's result and its
    census."""
    with OpCounter() as counter:
        result = fn(*args, **kwargs)
    return result, counter.cost()
