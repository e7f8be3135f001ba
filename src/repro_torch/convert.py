"""Carry packed operands, solver state and LM parameters across from numpy.

The JAX package's stacked operands (``StackedRowEll`` / ``StackedSell`` /
``StackedEllpack``), its single-system operators and matrices
(``BellOperator`` / ``BellMatrix``, ``PallasEllOperator`` /
``EllpackMatrix``) and its solver states (``BatchedVMState``,
``CGState``) are plain containers of arrays; :func:`numpy.asarray` turns
every array in them into host numpy.  These helpers read such objects by
attribute — importing nothing from the JAX package — and return what the
port's solvers, runners and steppers consume, so one packed operand or
one mid-flight state can be fed to both packages.

The LM side: :func:`lm_params_to_torch` turns the reference's
``init_params`` pytree (nested dicts of arrays, each stack's layers —
``layers``, or the encoder-decoder's ``enc_layers`` and ``dec_layers`` —
on a leading ``L`` axis) into the port's module of the config's family
(:func:`~repro_torch.models.api.model_class`), and
:func:`lm_cache_to_torch` a reference cache (``{name: AttnCache |
SSMCache | array}``) into the port's; :func:`lm_params_from_torch`
carries the port's parameters back as the reference's tree of numpy
arrays.

The training side: :func:`adamw_state_to_torch` and
:func:`cggn_state_to_torch` carry optimizer states across.  A flat
parameter-space vector (the CGGN diagonal, a probe) is ordered by the
reference's ravel of its tree (leaves by sorted key path, the layers
stacked), by the port's :func:`~repro_torch.core.gn.flatten_like` of the
module (``named_parameters`` order, layer by layer);
:func:`lm_flat_to_torch` and :func:`lm_flat_from_torch` permute between
the two.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.operators import BellOperator
from repro_torch.core.phases import CGState
from repro_torch.core.precision import BF16_CARRIER, get_scheme
from repro_torch.core.vm import BatchedVMState
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.ops import EllKernelOperator
from repro_torch.kernels.spmv import sell_table
from repro_torch.models.api import model_class
from repro_torch.models.attention import AttnCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import SSMCache
from repro_torch.sparse.bell import BellMatrix
from repro_torch.sparse.ellpack import EllpackMatrix
from repro_torch.train.cggn import CGGNState
from repro_torch.train.optim import AdamWState

__all__ = ["stacked_to_torch", "vm_state_to_torch", "vm_state_to_numpy",
           "operator_to_torch", "cg_state_to_torch", "load_tree",
           "lm_params_to_torch", "lm_cache_to_torch", "lm_params_from_torch",
           "lm_flat_to_torch", "lm_flat_from_torch", "adamw_state_to_torch",
           "cggn_state_to_torch"]


def _host_vals(a) -> np.ndarray:
    """Host values as the port holds them: the reference's bfloat16
    arrays (``dtype.name == "bfloat16"``, ``ml_dtypes``, which the port
    does not import) as their ``uint16`` bits."""
    a = np.asarray(a)
    return a.view(BF16_CARRIER) if a.dtype.name == "bfloat16" else a


def _vals_to_torch(a, device, scheme) -> torch.Tensor:
    a = _host_vals(a)
    if scheme is not None:
        dtype = scheme.matrix_dtype
    else:
        dtype = torch.bfloat16 if a.dtype == BF16_CARRIER else None
    return to_device(a, device, dtype)


def stacked_to_torch(stacked, *, scheme=None, device=None) -> tuple:
    """The matvec operand tuple of a stacked bag.

    * sliced-ELL (has ``iperm``): ``(cols, vals, iperm, table)``, ``iperm``
      as int64 for ``torch.gather``, ``table`` the kernel's
      :class:`~repro_torch.kernels.spmv.SellTable`: per lane from the
      port's ``lane_widths``, shared (every lane at the stored widths) for
      a stacked bag without them, as the reference's;
    * row-ELL (has ``cols``): ``(cols, vals)``;
    * ELLPACK (has ``tile_cols``): ``(tile_cols, vals, local_cols)``, the
      values cast to ``scheme.matrix_dtype`` (the ELLPACK stacker keeps
      them at the CSR's dtype).

    Values at bf16 — the reference's ``bfloat16`` arrays or the port's
    ``uint16`` bits — arrive as ``torch.bfloat16`` bit for bit; with
    ``scheme`` every layout's values are cast to ``scheme.matrix_dtype``.
    """
    device = resolve_device(device)
    scheme = None if scheme is None else get_scheme(scheme)
    if hasattr(stacked, "iperm"):
        lane_widths = getattr(stacked, "lane_widths", None)
        return (to_device(stacked.cols, device),
                _vals_to_torch(stacked.vals, device, scheme),
                to_device(stacked.iperm, device, torch.int64),
                sell_table(stacked.groups, device=device,
                           lane_widths=lane_widths,
                           slice_rows=stacked.slice_rows))
    if hasattr(stacked, "tile_cols"):
        return (to_device(stacked.tile_cols, device),
                _vals_to_torch(stacked.vals, device, scheme),
                to_device(stacked.local_cols, device))
    return (to_device(stacked.cols, device),
            _vals_to_torch(stacked.vals, device, scheme))


def vm_state_to_torch(state, *, device=None) -> BatchedVMState:
    """A port :class:`~repro_torch.core.vm.BatchedVMState` from any object
    with the VM state's fields (``k it status mem queues sregs active
    trace``) holding arrays."""
    device = resolve_device(device)
    return BatchedVMState(*(to_device(getattr(state, f), device)
                            for f in BatchedVMState._fields))


def vm_state_to_numpy(state: BatchedVMState) -> dict:
    """Host snapshot ``{field: np.ndarray}`` of a port VM state."""
    return {f: getattr(state, f).to("cpu", copy=True).numpy()
            for f in BatchedVMState._fields}


def operator_to_torch(obj, *, scheme=None, diag=None, device=None):
    """The port's single-system operator from a banked-ELL or ELLPACK
    operand read by attribute.

    * an operator (has ``diag`` and ``scheme``: the reference's
      ``BellOperator`` / ``PallasEllOperator``) keeps its arrays, its
      values at its scheme's matrix dtype and its diag;
    * a matrix (``BellMatrix`` / ``EllpackMatrix``) needs ``scheme`` and
      ``diag``.

    Banked ELL (has ``local_rows``) becomes a
    :class:`~repro_torch.core.operators.BellOperator` (``backend="xla"``),
    ELLPACK an :class:`~repro_torch.kernels.ops.EllKernelOperator`
    (``backend="pallas"``).
    """
    if hasattr(obj, "scheme") and hasattr(obj, "diag"):
        scheme = obj.scheme.name if scheme is None else scheme
        diag = obj.diag if diag is None else diag
        shape = (obj.n, obj.n)
    elif scheme is None or diag is None:
        raise ValueError("a matrix operand needs scheme= and diag=")
    else:
        shape = tuple(obj.shape)
    scheme = get_scheme(scheme)
    diag = np.asarray(diag)
    common = dict(tile_cols=np.asarray(obj.tile_cols),
                  vals=_host_vals(obj.vals),
                  local_cols=np.asarray(obj.local_cols), shape=shape,
                  block_rows=obj.block_rows, col_tile=obj.col_tile,
                  nnz=obj.nnz)
    if hasattr(obj, "local_rows"):
        m = BellMatrix(local_rows=np.asarray(obj.local_rows), **common)
        return BellOperator.from_bell(m, scheme, diag, device)
    return EllKernelOperator.from_ellpack(EllpackMatrix(**common), scheme,
                                          diag, device)


def cg_state_to_torch(state, *, device=None) -> CGState:
    """A port :class:`~repro_torch.core.phases.CGState` from any object
    with the single-system state's fields (``i x r p rz rr trace``)."""
    device = resolve_device(device)
    return CGState(*(to_device(getattr(state, f), device)
                     for f in CGState._fields))


def _flatten(tree, prefix=""):
    """``(dotted path, leaf)`` of a nested dict, keys sorted at every level
    (the reference's ravel order)."""
    for key in sorted(tree):
        val = tree[key]
        if hasattr(val, "items"):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield prefix + key, val


def load_tree(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a parameter tree of the reference (nested dicts of arrays; or
    flat, with dotted keys) into ``module``: each path is a ``state_dict``
    key.  Strict: a missing or extra key or a wrong shape raises."""
    module.load_state_dict({k: to_device(v, "cpu")
                            for k, v in _flatten(tree)}, strict=True)
    return module


def _stacks(cfg: ModelConfig) -> dict:
    """The reference's stacked top-level keys and their layer counts."""
    if cfg.encoder is not None:
        return {"enc_layers": cfg.encoder.n_layers,
                "dec_layers": cfg.n_layers}
    return {"layers": cfg.n_layers}


def _lm_state(tree, cfg: ModelConfig) -> dict:
    """``{port name: array}`` from a reference LM tree: a leaf
    ``<stack>.<path>`` of shape ``[L, ...]`` (``layers``, ``enc_layers``,
    ``dec_layers``) becomes ``<stack>.<l>.<path>`` for every layer ``l``;
    every other path (``embed``, ``ln_f``, ``enc_ln``, the hybrid's
    unstacked ``shared.*``) is its own key."""
    stacks = _stacks(cfg)
    state = {}
    for name, a in _flatten(tree):
        top, _, rest = name.partition(".")
        if top in stacks:
            stacked = np.asarray(a)
            state.update((f"{top}.{l}.{rest}", stacked[l])
                         for l in range(stacks[top]))
        else:
            state[name] = a
    return state


def lm_params_to_torch(params, cfg: ModelConfig, *,
                       device=None) -> torch.nn.Module:
    """The port's LM with the reference's parameter values
    (:func:`_lm_state`'s names)."""
    return load_tree(model_class(cfg)(cfg, device=resolve_device(device)),
                     _lm_state(params, cfg))


def _host(t) -> np.ndarray:
    """A tensor as host numpy; bf16 as its ``uint16`` bits (the port's
    carrier)."""
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_CARRIER)
    return t.numpy()


def _port_names(cfg: ModelConfig) -> list:
    """``(name, shape)`` of the port's LM parameters, in module order."""
    return [(n, p.shape) for n, p in
            model_class(cfg)(cfg, device="meta").named_parameters()]


def _ref_leaves(cfg: ModelConfig) -> list:
    """The reference's LM leaves in its ravel order (dict keys sorted at
    every level): ``(path, stacked shape, port names)``, the port names of
    a stacked leaf in layer order."""
    stacks = _stacks(cfg)
    leaves = {}
    for name, shape in _port_names(cfg):
        top, _, rest = name.partition(".")
        if top in stacks:
            rest = rest.split(".", 1)[1]
            leaf = leaves.setdefault((top, *rest.split(".")),
                                     [(stacks[top], *shape), []])
            leaf[1].append(name)
        else:
            leaves[tuple(name.split("."))] = [tuple(shape), [name]]
    return sorted(leaves.items())


def lm_params_from_torch(params, cfg: ModelConfig) -> dict:
    """The reference's LM tree (nested dicts of numpy arrays, each stack's
    layers on a leading ``L`` axis) from the port's module or a
    ``{name: tensor}`` dict of its names."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    stacks = _stacks(cfg)
    tree = {}
    for path, (_, names) in _ref_leaves(cfg):
        arrs = [_host(params[n]) for n in names]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrs) if path[0] in stacks else arrs[0]
    return tree


def lm_flat_to_torch(flat, cfg: ModelConfig, *, device=None) -> torch.Tensor:
    """A parameter-space vector in the reference's ravel order, reordered
    as the port's ``flatten_like`` of the module (same values)."""
    flat = np.asarray(flat)
    stacks = _stacks(cfg)
    pieces, ofs = {}, 0
    for path, (shape, names) in _ref_leaves(cfg):
        size = int(np.prod(shape))
        block = flat[ofs:ofs + size].reshape(shape)
        ofs += size
        pieces.update(zip(names, block) if path[0] in stacks
                      else [(names[0], block)])
    return to_device(np.concatenate([pieces[n].ravel()
                                     for n, _ in _port_names(cfg)]),
                     resolve_device(device))


def lm_flat_from_torch(flat: torch.Tensor, cfg: ModelConfig) -> np.ndarray:
    """The reverse of :func:`lm_flat_to_torch`: a port-ordered vector as
    numpy in the reference's ravel order."""
    names = _port_names(cfg)
    parts = torch.split(flat.detach(), [int(np.prod(sh)) for _, sh in names])
    tree = lm_params_from_torch({n: part.view(sh) for (n, sh), part in
                                 zip(names, parts)}, cfg)
    return np.concatenate([np.ravel(a) for _, a in _flatten(tree)])


def _moments(tree, cfg, device) -> dict:
    named = _lm_state(tree, cfg) if cfg is not None else dict(_flatten(tree))
    return {n: to_device(a, device) for n, a in named.items()}


def adamw_state_to_torch(state, cfg: ModelConfig = None, *,
                         device=None) -> AdamWState:
    """The port's :class:`~repro_torch.train.optim.AdamWState` from the
    reference's (read by attribute: ``step``, ``m``, ``v``).  With ``cfg``
    the moments are an LM tree and take the module's names
    (``layers.<l>.…``, ``enc_layers.<l>.…``, ``dec_layers.<l>.…``);
    without, a tree's leaves take their key paths joined with ``"."``
    (:func:`~repro_torch.core.gn.param_dict`'s names).
    bf16 moments arrive bit for bit; the step stays on the host."""
    dev = resolve_device(device)
    return AdamWState(step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32),
                      m=_moments(state.m, cfg, dev),
                      v=_moments(state.v, cfg, dev))


def cggn_state_to_torch(state, cfg: ModelConfig = None, *,
                        device=None) -> CGGNState:
    """The port's :class:`~repro_torch.train.cggn.CGGNState` from the
    reference's (``step``, ``key``, ``diag``).  A JAX key has no torch
    counterpart: its words are taken as the probes' seed
    (``PRNGKey(s)`` → ``s`` for ``0 ≤ s < 2³²``).  With ``cfg`` the
    diagonal is an LM's and is reordered as the module's
    (:func:`lm_flat_to_torch`)."""
    dev = resolve_device(device)
    words = np.asarray(state.key, dtype=np.uint64).ravel()
    seed = int(sum(int(w) << (32 * i) for i, w in enumerate(words[::-1])))
    diag = lm_flat_to_torch(state.diag, cfg, device=dev) if cfg is not None \
        else to_device(state.diag, dev)
    return CGGNState(step=int(np.asarray(state.step)), seed=seed, diag=diag)


def lm_cache_to_torch(cache, *, device=None) -> dict:
    """The port's stacked caches from the reference's (``{name: AttnCache
    | SSMCache | array}``, read by attribute: ``k``, ``v``, ``ring``, or
    ``conv``, ``ssm``; a bare array — the encoder-decoder's ``cross_k`` /
    ``cross_v`` — stays a bare tensor); bf16 leaves arrive bit for bit."""
    dev = resolve_device(device)

    def one(c):
        if hasattr(c, "conv"):
            return SSMCache(to_device(c.conv, dev), to_device(c.ssm, dev))
        if hasattr(c, "ring"):
            return AttnCache(to_device(c.k, dev), to_device(c.v, dev),
                             bool(c.ring))
        return to_device(c, dev)

    return {name: one(c) for name, c in cache.items()}
