"""Elementary layers — the port of :mod:`repro.models.layers`.

Layers that hold weights are ``nn.Module``s whose attribute names are the
reference's parameter keys (``Dense.w``/``.b``, ``RMSNorm.g``,
``Embedding.e``, ``MLP.wi``/``.wg``/``.wo``), so the JAX parameter pytree
maps onto ``state_dict`` keys one for one (:mod:`repro_torch.convert`).
The modules hold parameters only: each computation is a plain function
under the reference's name (:func:`dense`, :func:`rmsnorm`, :func:`embed`,
:func:`mlp`, ...) taking the module as ``p``, where the reference takes
its parameter dict.

Dense weights are kept ``[d_in, d_out]`` as in JAX.  Compute runs at the
config's dtype (bf16 on the card) with fp32 parameters; norm statistics and
logits are fp32.  Parameters are created with ``requires_grad=False``, so
serving builds no autograd graph; the trainer (:mod:`repro_torch.train`)
turns gradients on for its step, and the GGN operator works on detached
tensors through ``torch.func``.
:meth:`reset_parameters` draws from an explicit ``torch.Generator`` the
reference's truncated normal (±2σ) at the reference's scales.

On a mesh the table is sharded on vocab, and :func:`embed` looks tokens
up vocab-parallel (:func:`_embed_vocab_parallel`) in place of DTensor's
rule for the index, whose backward fails on torch 2.11.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.hints import (even, is_dtensor, local_offset,
                                           per_channel)

__all__ = ["Dense", "RMSNorm", "LayerNorm", "Embedding", "MLP", "MLPGelu",
           "dense", "rmsnorm", "layernorm", "norm", "make_norm", "embed",
           "unembed", "mlp", "mlp_gelu", "ffn", "rope_freqs", "apply_rope",
           "draw_parameters"]


def _param(*shape, device=None) -> nn.Parameter:
    """An fp32 parameter (every config's ``param_dtype``), not drawn."""
    return nn.Parameter(torch.empty(shape, device=device,
                                    dtype=torch.float32),
                        requires_grad=False)


def _truncated_normal_(t: torch.Tensor, scale: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """The reference's ``_tn``: a standard normal truncated to [−2, 2],
    times ``scale``, drawn in place."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def draw_parameters(model: nn.Module,
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every parameter of ``model`` in place (each module's
    :meth:`reset_parameters`) from ``generator`` (default: seed 0 on the
    model's device), and return the model."""
    if generator is None:
        dev = next(model.parameters()).device
        generator = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
    return model


# --------------------------------------------------------------------- dense
class Dense(nn.Module):
    """``y = x @ w (+ b)``; ``w`` is ``[d_in, d_out]``, drawn at scale
    ``d_in ** -0.5`` (every scale the reference passes equals that)."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 device=None):
        super().__init__()
        self.w = _param(d_in, d_out, device=device)
        self.b = _param(d_out, device=device) if bias else None

    def reset_parameters(self, generator=None) -> None:
        _truncated_normal_(self.w, self.w.shape[0] ** -0.5, generator)
        if self.b is not None:
            self.b.zero_()


def dense(p: Dense, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    dt = compute_dtype or x.dtype
    y = even(x.to(dt) @ p.w.to(dt))
    if p.b is not None:
        y = y + per_channel(p.b.to(dt), y)
    return y


# ----------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.g = _param(d, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.g.fill_(1.0)


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.g = _param(d, device=device)
        self.b = _param(d, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.g.fill_(1.0)
        self.b.zero_()


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()                                  # norm stats in fp32
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(dt) * p.g.to(dt)


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * p.g.to(dt) + p.b.to(dt)


def norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm for a :class:`LayerNorm` (the reference: iff the params
    have a bias), else RMSNorm."""
    return layernorm(p, x, eps) if isinstance(p, LayerNorm) \
        else rmsnorm(p, x, eps)


def make_norm(d: int, kind: str = "rms", *, device=None) -> nn.Module:
    return LayerNorm(d, device=device) if kind == "ln" \
        else RMSNorm(d, device=device)


# ----------------------------------------------------------------- embedding
class Embedding(nn.Module):
    """Token table ``e [vocab, d]`` (scale 1.0), tied with the unembedding."""

    def __init__(self, vocab: int, d: int, *, device=None):
        super().__init__()
        self.e = _param(vocab, d, device=device)

    def reset_parameters(self, generator=None) -> None:
        _truncated_normal_(self.e, 1.0, generator)


def embed(p: Embedding, tokens: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    if is_dtensor(p.e):
        return _embed_vocab_parallel(p.e, tokens, compute_dtype)
    return p.e[tokens].to(compute_dtype)


def _embed_vocab_parallel(e, tokens, compute_dtype):
    """The lookup on a table sharded on vocab: each rank looks up the
    tokens of its block of the vocabulary (the others read 0), and the
    result is the sum over those ranks (``Partial``), reduced at the next
    layout change.  Per rank it is the unsharded lookup on its shard, the
    same ops in the backward; DTensor's own rule for this index's backward
    fails on torch 2.11.  A table the mesh does not shard on vocab (a
    vocab the model axis does not divide) is whole on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = e.device_mesh
    tok = tokens if isinstance(tokens, DTensor) else DTensor.from_local(
        tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    vocab = [p.is_shard(0) for p in e.placements]
    # tokens keep their own sharding off the vocab's mesh dims
    tok = tok.redistribute(mesh, [Replicate() if v else p for v, p in
                                  zip(vocab, tok.placements)])
    # the table's gradient: its vocab shard; a sum over the mesh dims that
    # split the tokens; whole where every rank reads all of them
    loc = e.to_local(grad_placements=[
        Shard(0) if v else Partial() if p.is_shard() else Replicate()
        for v, p in zip(vocab, tok.placements)])
    idx = tok.to_local() - local_offset(e, 0)
    inside = (idx >= 0) & (idx < loc.shape[0])
    out = torch.where(inside[..., None],
                      loc[idx.clamp(0, loc.shape[0] - 1)], 0.0)
    return DTensor.from_local(
        out.to(compute_dtype), mesh,
        [Partial() if v else p for v, p in zip(vocab, tok.placements)],
        run_check=False)


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in fp32 (loss numerics)."""
    return x.float() @ p.e.float().T


# ---------------------------------------------------------------------- mlp
class MLP(nn.Module):
    """SwiGLU: ``wo(silu(wg x) * wi x)``."""

    def __init__(self, d: int, f: int, *, device=None):
        super().__init__()
        self.wi = Dense(d, f, device=device)
        self.wg = Dense(d, f, device=device)
        self.wo = Dense(f, d, device=device)


class MLPGelu(nn.Module):
    """2-matrix GELU MLP (whisper-style), with biases."""

    def __init__(self, d: int, f: int, *, device=None):
        super().__init__()
        self.wi = Dense(d, f, bias=True, device=device)
        self.wo = Dense(f, d, bias=True, device=device)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(p.wg, x)) * dense(p.wi, x)
    return dense(p.wo, h)


def mlp_gelu(p: MLPGelu, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return dense(p.wo, F.gelu(dense(p.wi, x), approximate="tanh"))


def ffn(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU for an :class:`MLP` (the reference: iff the params have a gate
    matrix), else the GELU MLP."""
    return mlp(p, x) if isinstance(p, MLP) else mlp_gelu(p, x)


# --------------------------------------------------------------------- rope
def rope_freqs(positions: torch.Tensor, head_dim: int,
               theta: float = 10_000.0):
    """cos/sin tables for ``positions`` (any shape) -> (*pos, head_dim/2)."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    inv = 1.0 / (theta ** (ar / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [..., S, H, D]; cos/sin: [..., S, D/2] (broadcast over heads);
    the half-split rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)               # add head axis
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
