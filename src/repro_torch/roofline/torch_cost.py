"""Count a step's flops, device bytes and collective bytes as it runs
eagerly (the port of :mod:`repro.roofline.hlo_cost`, which walks HLO).

The port has no HLO: its steps run op by op.  :func:`count_torch` runs a
callable under a ``TorchDispatchMode`` that sees every ATen op the
callable dispatches, forward and backward alike, so a Python loop of 13
steps is counted 13 times with no trip-count parsing:

* **flops** — matmul-family ops at 2·MACs, by the formulas
  ``torch.utils.flop_counter`` registers (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, convolutions, fused attention); elementwise arithmetic at
  one flop an output element and reduces at one an input element, as the
  reference's walker counts its ``_ELEMENTWISE`` and ``reduce`` ops;
  transcendentals (``exp``, ``tanh``, ``rsqrt``, ...) at one flop and one
  transcendental an output element.  An ATen op that HLO spells as
  several (``silu`` = logistic × x, ``_softmax``, ``gelu``, ``addcmul``)
  counts the elementwise ops the reference's walker would see for it.
* **HBM bytes** — each op's tensor operands read once and results written
  once.  Views, metadata and allocation ops count 0, as ``bitcast`` and
  ``tuple`` do in the reference.  Eager ops are not fused, so this is the
  traffic of the unfused step: never less than the reference's
  post-fusion count, and equal to it for a single op.
* **collectives** — each c10d op (``all_reduce``, ``all_gather``,
  ``reduce_scatter``, ``all_to_all``, ``broadcast``, ``recv``) priced by
  :mod:`repro_torch.roofline.collectives`' ring model with its group's
  size.

**DTensors.**  On a mesh (the sharded train step, the dry run) the
counter sees what one rank does: an op on DTensors is left to DTensor
(the mode declines it), which redistributes the operands and runs the
local op, and that local op and the collectives of the redistribution are
what is counted.  The ops DTensor's sharding propagation runs on fake
tensors to infer shapes are not counted.

**Memory.**  ``peak_bytes`` is the most bytes held at once by the
storages created during the call (each counted once, from its creation to
its release; on ``meta`` tensors too): the call's temporaries, the
reference's ``temp_size_in_bytes``.

Blind spot: the port's hand-written CUDA kernels launch through
``ctypes`` (:mod:`repro_torch.kernels._launch`), under the dispatcher, so
a dispatch mode never sees them, and their work is missing from the
count.  No LM step launches one (the models' attention is plain
PyTorch), so LM steps are counted whole; the solver is priced
analytically instead (:func:`repro_torch.roofline.model.solver_terms`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.collectives import wire_bytes

__all__ = ["CostWalk", "count_torch", "counting"]


@dataclasses.dataclass
class CostWalk:
    flops: float = 0.0
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    collective_count: float = 0.0
    wire_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0


#: (flops, transcendentals) per output element, by ATen op name (an
#: in-place variant's trailing ``_`` dropped).  One HLO op each: the
#: reference's ``_ELEMENTWISE`` and ``_TRANSCENDENTAL``.
_PER_OUT: Dict[str, Tuple[int, int]] = {
    **dict.fromkeys((
        "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs",
        "neg", "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and",
        "logical_or", "logical_xor", "logical_not", "bitwise_and",
        "bitwise_or", "bitwise_xor", "bitwise_not", "remainder", "fmod",
        "clamp", "clamp_min", "clamp_max", "floor", "ceil", "round",
        "trunc", "sign", "atan2", "reciprocal", "masked_fill", "relu",
        "__and__", "__or__", "__xor__", "__lshift__", "__rshift__",
        "threshold_backward", "isnan", "isinf", "isfinite"),
        (1, 0)),
    **dict.fromkeys((
        "exp", "exp2", "log", "log2", "log10", "tanh", "rsqrt", "sqrt",
        "sigmoid", "sin", "cos", "expm1", "log1p", "erf", "cbrt"), (1, 1)),
    # several HLO ops an ATen op
    "addcmul": (2, 0), "addcdiv": (2, 0), "lerp": (3, 0),
    "silu": (2, 1),                      # x · logistic(x)
    "gelu": (8, 1),                      # tanh form: x³, affine, tanh, ...
    "tanh_backward": (3, 0), "sigmoid_backward": (3, 0),
    "silu_backward": (5, 1), "gelu_backward": (14, 1),
    "_softmax": (3, 1),                  # and 2 reduces over the input
    "_log_softmax": (3, 1),
    "_softmax_backward_data": (2, 0),    # and a reduce
    "_log_softmax_backward_data": (3, 1),
}
#: (flops per input element) of reduces; softmax's reduces ride here too
_PER_IN: Dict[str, int] = {
    **dict.fromkeys(("sum", "mean", "amax", "amin", "prod", "any", "all",
                     "argmax", "argmin", "cumsum", "cumprod", "logsumexp",
                     "nansum"), 1),
    "linalg_vector_norm": 2, "norm": 2, "var": 3, "var_mean": 3,
    "std": 3, "_softmax": 2, "_log_softmax": 2,
    "_softmax_backward_data": 1, "_log_softmax_backward_data": 1,
}
#: ops that move no bytes: views are caught by ``is_view``
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
             "is_same_size", "set", "resize", "_unsafe_view",
             "_reshape_alias", "resolve_conj", "resolve_neg", "wait_tensor"}
#: ops whose first operand is written, not read
_WRITE_ONLY = {"fill", "zero", "copy", "normal", "uniform", "random",
               "bernoulli", "exponential"}
#: c10d ops, by the reference's HLO kind name
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "all_reduce": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "all_gather_into_tensor": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "reduce_scatter_tensor": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "all_to_all_single": "all-to-all",
         "broadcast_": "broadcast", "recv_": "collective-permute"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _base(name: str) -> str:
    """``aten::add_`` -> ``add``: the op without namespace or in-place
    suffix."""
    name = name.split("::")[-1]
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def _group_size(op: str, args) -> int:
    """The size of the process group a c10d op runs on.  Every eager
    collective carries its group (a boxed ``ProcessGroup``, or a group
    name for the functional ops), so one that cannot be read is an error,
    not a group of 1 that would price the collective at 0 wire bytes."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, str):          # functional collectives: a name
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            try:
                return _resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                continue                # the reduce op's name, not a group
    raise ValueError(f"{op}: cannot read the process group its "
                     "collective runs on")


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        self._dtensor, self._fake = DTensor, FakeTensor
        self.walk = CostWalk()
        self._live = 0
        self._refs: Dict[int, weakref.ref] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(t, self._dtensor) for t in flat):
            return NotImplemented     # DTensor runs it; its local ops count
        out = func(*args, **kwargs)
        if any(isinstance(t, self._fake) for t in flat + _tensors(out)):
            return out                # sharding propagation's shape pass
        self._count(func, args, kwargs, out)
        self._track(flat, out)
        return out

    def _track(self, flat, out):
        """Add each storage ``out`` creates (not an input's: a view, an
        in-place op) to the live bytes until it is released."""
        ins = {t.untyped_storage()._cdata for t in flat
               if isinstance(t, torch.Tensor)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._refs or key in ins:
                continue
            n = st.nbytes()
            self._live += n
            self.walk.peak_bytes = max(self.walk.peak_bytes, self._live)
            self._refs[key] = weakref.ref(st, self._release(key, n))

    def _release(self, key: int, n: int):
        def cb(_):
            self._live -= n
            self._refs.pop(key, None)
        return cb

    def _count(self, func, args, kwargs, out):
        w = self.walk
        full = func._schema.name
        ns, _, op = full.partition("::")
        if ns in ("c10d", "_c10d_functional"):
            kind = _C10D.get(op)
            if kind is None:
                return
            # c10d's in-place ops write their first argument; the
            # functional ones return the result
            rb = _nbytes(_tensors(out if ns == "_c10d_functional"
                                  else args[0]))
            g = _group_size(full, args)
            wb = wire_bytes("all-gather" if kind == "broadcast" else kind,
                            rb, g)
            w.wire_bytes += wb
            w.collective_count += 1
            w.wire_by_kind[kind] = w.wire_by_kind.get(kind, 0) + wb
            w.hbm_bytes += 2 * rb           # the result read and written
            return
        name = _base(full)
        outs = _tensors(out)
        # ---------- flops ----------
        packet = func.overloadpacket
        if packet in flop_registry:
            w.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        else:
            n_out = sum(t.numel() for t in outs)
            if name == "pow":
                e = args[1] if len(args) > 1 else kwargs.get("exponent")
                per = (1, 0) if (isinstance(e, (int, float))
                                 and float(e).is_integer()) else (1, 1)
            else:
                per = _PER_OUT.get(name)
            if per is not None:
                w.flops += per[0] * n_out
                w.transcendentals += per[1] * n_out
            if name in _PER_IN and args and isinstance(args[0],
                                                       torch.Tensor):
                w.flops += _PER_IN[name] * args[0].numel()
        # ---------- bytes ----------
        if func.is_view or name in _NO_BYTES:
            return
        reads = _tensors((args, {k: v for k, v in kwargs.items()
                                 if k != "out"}))
        if name in _WRITE_ONLY and args and isinstance(args[0],
                                                       torch.Tensor):
            reads = reads[1:]
        w.hbm_bytes += _nbytes(reads) + _nbytes(outs)


def count_torch(fn, *args, **kw) -> CostWalk:
    """Run ``fn(*args, **kw)`` once and return what it dispatched: flops,
    transcendentals, device bytes and collective wire bytes per device.
    The call does its real work; time it elsewhere."""
    with counting() as walk:
        fn(*args, **kw)
    return walk


@contextlib.contextmanager
def counting():
    """:func:`count_torch` as a context: yields the :class:`CostWalk` the
    block's ops are added to as they run (``copy.deepcopy`` it to read a
    phase)."""
    with _Counter() as mode:
        yield mode.walk
