"""Flash attention (forward) for Hopper, beside its plain PyTorch version.

:func:`flash_attention` replaces ``repro/kernels/flash_attn.py::
flash_attention`` (the Pallas kernel, body ``_kernel``): online-softmax
attention on the head-major layout ``[BH, S, D]`` with a causal and/or
sliding-window mask, whose scores and softmax statistics never leave the
chip.  :func:`_route` picks one of four kernels by shape and dtype,
before the launch and never on a failure:

* ``"wgmma"`` — bf16 whose head dim is a multiple of 8 and whose base
  pointers are 16-byte aligned (``csrc/flash_attn_sm90.cu``): TMA loads
  of 64 × 64 boxes through 3-D tensor maps into a shared-memory ring, a
  producer warpgroup (one thread issues the loads) and two consumer
  warpgroups of 64 query rows that take turns on the tensor cores
  (``wgmma``), so one's softmax runs under the other's products.  TMA
  takes only 16-byte row strides and bases, hence the condition; every
  model's head dim (64, 128, 256) takes this route.
* ``"mma_sync"`` — the other bf16 shapes (D = 20, a view that starts
  off a 16-byte boundary; ``csrc/flash_attn.cu``): ``mma.sync`` m16n8k16
  in 8 warps of 16 query rows, ``cp.async`` (or element-wise) loads.
* ``"tf32x3"`` — fp32 whose head dim is a multiple of 4 and whose base
  pointers are 16-byte aligned, outside :data:`_LARGE_LOGIT_CARVE_OUT_D`
  (``csrc/flash_attn_tf32.cu``): each fp32 product as three TF32 products
  on ``wgmma`` (``x = hi + lo``, both rounded to tf32; ``lo·hi + hi·lo +
  hi·hi``), after a pre-pass that writes K and Vᵀ, split, as the wgmma
  operands' shared-memory images into scratch this wrapper allocates;
  16-byte loads take only 16-byte rows and bases, hence the condition.
  Every model's head dim takes this route.
* ``"fp32"`` — the other fp32 inputs (D = 42, a view that starts off a
  16-byte boundary, and the carve-out's D ≤ 32; ``csrc/flash_attn.cu``):
  fp32 FMAs on the CUDA cores, q·k summed over D one column after
  another.

Both bf16 kernels take q·k of bf16 values in fp32 (exact) and carry p to
16 bits in two bf16 passes (``p_hi = bf16(p)``, ``p_lo = bf16(p −
p_hi)``), so their output is within one bf16 ulp of the plain version's.

It keeps the reference's signature and contract: ``S`` must be a multiple
of ``min(block_q, S)`` and ``T`` of ``min(block_k, T)``, so a call valid in
one package is valid in the other.  The CUDA kernels pick their own tiles
and mask their own ragged edges; ``block_q``/``block_k`` only check the
contract.  GQA stays outside: the caller repeats the kv heads.

Parity with the plain version is held to a tolerance, not bit for bit: the
kernels sum the softmax over K tiles in another order than a plain masked
softmax, the bf16 kernels carry p to 16 bits, not 24, and ``"tf32x3"``
drops each product's ``lo·lo`` term (about 2⁻²² of it).

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel of its route or raises.  :data:`LAUNCHES`
counts the launches, in all (``"flash_attention"``) and by route
(``"flash_attention[<route>]"``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels._launch import (I, LL, P, check_cuda, function,
                                         on_cpu, raise_on_error)

__all__ = ["flash_attention", "flash_attention_plain", "LAUNCHES",
           "reset_launches", "MAX_HEAD_DIM", "ROUTES"]

_NEG = -1e30

#: Largest head dim the kernel takes (gemma3's 256).
MAX_HEAD_DIM = 256

#: The kernels :func:`_route` picks from.
ROUTES = ("wgmma", "mma_sync", "tf32x3", "fp32")

#: Kernel launches since the last :func:`reset_launches`: all, and by route.
LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                            **{f"flash_attention[{r}]": 0 for r in ROUTES}}

_DTYPES = (torch.float32, torch.bfloat16)

#: fp32 head dims at or below this keep the CUDA-core kernel: a carve-out
#: for the reference test's ×30-logit case (D = 32), not a property of the
#: head dim.  At logits near 10³ that case's 1e-4 gate holds only for q·k
#: summed in the plain version's order; ``"tf32x3"`` misses it on some
#: inputs, and so do a fourth TF32 pass, lo kept at fp32 and fp32 FMAs
#: summed in reverse (``tests/test_torch_flash_attn.py::
#: test_tf32x3_large_logits_are_order_sensitive``).  A larger head dim
#: with such logits takes ``"tf32x3"`` and misses that gate the same way.
_LARGE_LOGIT_CARVE_OUT_D = 32


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these inputs, from their dtype, head dim and
    base pointers alone: on 16-byte aligned bases, ``"wgmma"`` for bf16
    with D a multiple of 8 (TMA's row strides) and ``"tf32x3"`` for fp32
    with D a multiple of 4 (16-byte rows) outside the carve-out
    :data:`_LARGE_LOGIT_CARVE_OUT_D`; else ``"mma_sync"`` for bf16 and
    ``"fp32"`` for fp32."""
    d = q.shape[-1]
    bf16 = all(t.dtype == torch.bfloat16 for t in (q, k, v))
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    if bf16:
        return "wgmma" if aligned and d % 8 == 0 else "mma_sync"
    carved_out = d <= _LARGE_LOGIT_CARVE_OUT_D
    return "tf32x3" if aligned and d % 4 == 0 and not carved_out else "fp32"


def _tf32_tiles(bh: int, t: int, d: int) -> int:
    """fp32 elements of the ``"tf32x3"`` route's scratch: a 32 KB slot
    image (hi and lo of 64 keys × 64 columns) for each 64-key tile, each
    of K and Vᵀ, and each 64-column chunk of D rounded up to 64, 128 or
    256 (``csrc/flash_attn_tf32.cu``'s ``tile_floats``)."""
    dp = 64 if d <= 64 else 128 if d <= 128 else 256
    return bh * -(-t // 64) * 2 * (dp // 64) * 8192


def _check(q, k, v, block_q: int, block_k: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be [BH, S|T, D]")
    bh, s, d = q.shape
    if k.shape[0] != bh or v.shape != k.shape or k.shape[2] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "match (repeat the kv heads before the call)")
    t = k.shape[1]
    bq, bk = min(block_q, s), min(block_k, t)
    if s % bq or t % bk:
        raise ValueError(f"flash_attention: pad seq to block multiples "
                         f"(S={s}, block_q={bq}; T={t}, block_k={bk})")


def _mask(s: int, t: int, causal: bool, window: Optional[int], device):
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window=None,
                          block_q: int = 128, block_k: int = 512
                          ) -> torch.Tensor:
    """The reference's oracle ``kernels/ref.py::mha_ref``: plain masked
    softmax attention with fp32 scores and softmax, cast to ``q.dtype``.
    The score tensor is updated in place to halve its peak memory."""
    _check(q, k, v, block_q, block_k)
    s, t = q.shape[1], k.shape[1]
    scores = torch.einsum("bsd,btd->bst", q.float(), k.float())
    scores.mul_(q.shape[-1] ** -0.5)
    if causal or window is not None:
        scores.masked_fill_(~_mask(s, t, causal, window, q.device), _NEG)
    w = torch.softmax(scores, dim=-1)
    del scores
    return torch.einsum("bst,btd->bsd", w, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, block_q: int = 128,
                    block_k: int = 512) -> torch.Tensor:
    """q [BH, S, D], k/v [BH, T, D] -> [BH, S, D] at ``q.dtype`` (fp32 or
    bf16 in and out; fp32 scores and statistics, ``scale = D ** -0.5``).
    ``window``: sliding-window width (a key j is live for query i when
    ``j > i − window``); positions of q and k both count from 0."""
    if on_cpu("flash_attention", q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k)
    _check(q, k, v, block_q, block_k)
    _check_kernel(q, k, v, window, _DTYPES)
    return _launch(_route(q, k, v), q, k, v, torch.empty_like(q), causal,
                   window)


def _check_kernel(q, k, v, window, dtypes) -> None:
    """What the CUDA kernels take beyond the reference's contract."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in dtypes:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{dtypes}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {q.shape[2]} > "
                         f"{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    check_cuda("flash_attention", q.device, q=q, k=k, v=v)


def _launch(route: str, q, k, v, out, causal, window) -> torch.Tensor:
    """One launch of ``route``'s kernel; ``out`` is q's dtype, or fp32 for
    bf16 inputs (the bf16 kernels before their output rounding)."""
    bh, s, d = q.shape
    t = k.shape[1]
    if route == "tf32x3":
        # the pre-pass's split K and V^T
        n = _tf32_tiles(bh, t, d)
        tiles = torch.empty(n, dtype=torch.float32, device=q.device)
        lib, name = "flash_attn_tf32", "repro_flash_attention_tf32"
        head, types = (tiles.data_ptr(), n), [P, LL]
    else:
        # the mma.sync and fp32 kernels' entry: 0 fp32, 1 bf16, 2 bf16 in
        # and fp32 out; the wgmma kernel's: 1 fp32 out
        wide = out.dtype != q.dtype
        if route == "wgmma":
            lib, name = "flash_attn_sm90", "repro_flash_attention_sm90"
            code = int(wide)
        else:
            lib, name = "flash_attn", "repro_flash_attention"
            code = 0 if route == "fp32" else 2 if wide else 1
        head, types = (code,), [I]
    fn = function(lib, name, types + [P, P, P, P, I, I, I, I, I, LL, P])
    # a negative width reads as "no window", taken in 64 bits (gemma3's
    # global layers pass 2**24)
    with torch.cuda.device(q.device):
        err = fn(*head, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), bh, s, t, d, int(causal),
                 -1 if window is None else int(window),
                 torch.cuda.current_stream().cuda_stream)
    raise_on_error(lib, "flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention[{route}]"] += 1
    return out


def _flash_attention_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window=None
                          ) -> torch.Tensor:
    """The bf16 kernel's fp32 output before its rounding to bf16 (bf16 q,
    k, v in, fp32 out): a check of the tensor-core arithmetic against the
    plain version on the widened inputs, at the fp32 tolerance.  Not a
    path of the model; on the CPU, the plain version on widened inputs."""
    return _flash_attention_route(q, k, v, None, causal=causal,
                                  window=window, wide=True)


def _flash_attention_route(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, route: Optional[str], *,
                           causal: bool = True, window=None,
                           wide: bool = False) -> torch.Tensor:
    """:func:`flash_attention` through a route forced by the caller
    (``None``: :func:`_route`'s), to hold and time two kernels of one dtype
    on the same inputs; ``wide``: bf16 in, fp32 out.  A route that cannot
    take the inputs raises: ``"wgmma"`` and ``"tf32x3"`` only where
    :func:`_route` picks them, ``"mma_sync"`` for any bf16 inputs,
    ``"fp32"`` for any fp32 ones.  Not a path of the model; on the CPU, the
    plain version (on widened inputs when ``wide``), and nothing is
    launched."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"flash_attention: route {route!r} not in {ROUTES}")
    if on_cpu("flash_attention", q):
        if wide:
            q, k, v = q.float(), k.float(), v.float()
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=q.shape[1], block_k=k.shape[1])
    _check(q, k, v, q.shape[1], k.shape[1])
    _check_kernel(q, k, v, window, (torch.bfloat16,) if wide else _DTYPES)
    picked = _route(q, k, v)
    route = picked if route is None else route
    if route != picked and (route, picked) not in (("mma_sync", "wgmma"),
                                                   ("fp32", "tf32x3")):
        raise ValueError(f"flash_attention: route {route!r} does not take "
                         f"these inputs ({q.dtype}, D = {q.shape[2]}; "
                         f"_route picks {picked!r})")
    dtype = torch.float32 if wide else q.dtype
    return _launch(route, q, k, v,
                   torch.empty(q.shape, dtype=dtype, device=q.device),
                   causal, window)
