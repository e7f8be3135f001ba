"""Flash attention (forward) for Hopper, beside its plain PyTorch version.

:func:`flash_attention` replaces ``repro/kernels/flash_attn.py::
flash_attention`` (the Pallas kernel, body ``_kernel``): online-softmax
attention on the head-major layout ``[BH, S, D]`` with a causal and/or
sliding-window mask, whose scores and softmax statistics never leave the
chip.  The kernels are in ``csrc/flash_attn.cu``, one per input dtype:

* bf16 runs on the tensor cores (``mma.sync`` m16n8k16, fp32
  accumulation): 8 warps of 16 query rows a block, Q and a two-stage
  ``cp.async`` ring of 64-key K/V tiles at bf16 in shared memory, the
  16 × D fp32 accumulator in registers.  q·k is exact in fp32 for bf16
  inputs; p·v takes p to 16 bits in two bf16 passes
  (``p_hi = bf16(p)``, ``p_lo = bf16(p − p_hi)``), so its output is
  within one bf16 ulp of the plain version's.  D is zero-padded to a
  power of two in shared memory.
* fp32 stays on the CUDA cores (fp32 FMAs): its inputs cannot take the
  bf16 tensor cores without rounding.

It keeps the reference's signature and contract: ``S`` must be a multiple
of ``min(block_q, S)`` and ``T`` of ``min(block_k, T)``, so a call valid in
one package is valid in the other.  The CUDA kernels pick their own tiles
and mask their own ragged edges; ``block_q``/``block_k`` only check the
contract.  GQA stays outside: the caller repeats the kv heads.

Parity with the plain version is held to a tolerance, not bit for bit: the
kernels sum the softmax over K tiles in another order than a plain masked
softmax, and the bf16 kernel carries p to 16 bits, not 24.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  :data:`LAUNCHES` counts the
launches.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels._launch import (I, LL, P, check_cuda, function,
                                         on_cpu, raise_on_error)

__all__ = ["flash_attention", "flash_attention_plain", "LAUNCHES",
           "reset_launches", "MAX_HEAD_DIM"]

_NEG = -1e30

#: Largest head dim the kernel takes (gemma3's 256).
MAX_HEAD_DIM = 256

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the C entry's private code for bf16 in, fp32 out
_BF16_IN_FP32_OUT = 2


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


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
    _check_kernel(q, k, v, window, tuple(_DTYPE_CODE))
    return _launch(_DTYPE_CODE[q.dtype], q, k, v, torch.empty_like(q),
                   causal, window)


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


def _launch(code: int, q, k, v, out, causal, window) -> torch.Tensor:
    bh, s, d = q.shape
    fn = function("flash_attn", "repro_flash_attention",
                  [I, P, P, P, P, I, I, I, I, I, LL, P])
    # the kernel reads a negative width as "no window", and takes it in 64
    # bits (gemma3's global layers pass 2**24)
    with torch.cuda.device(q.device):
        err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), bh, s, k.shape[1], d, int(causal),
                 -1 if window is None else int(window),
                 torch.cuda.current_stream().cuda_stream)
    raise_on_error("flash_attn", "flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return out


def _flash_attention_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window=None
                          ) -> torch.Tensor:
    """The bf16 kernel's fp32 output before its rounding to bf16 (bf16 q,
    k, v in, fp32 out): a check of the tensor-core arithmetic against the
    plain version on the widened inputs, at the fp32 tolerance.  Not a
    path of the model; on the CPU, the plain version on widened inputs."""
    if on_cpu("flash_attention", q):
        return flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
    _check(q, k, v, q.shape[1], k.shape[1])
    _check_kernel(q, k, v, window, (torch.bfloat16,))
    return _launch(_BF16_IN_FP32_OUT, q, k, v,
                   torch.empty(q.shape, dtype=torch.float32, device=q.device),
                   causal, window)
