"""Batched decode engine — slot-based continuous batching; the port of
:mod:`repro.serve.engine`.

A fixed pool of ``batch_slots`` request slots decodes in lock-step (one
:func:`~repro_torch.models.api.decode_step` per tick); slots are *ragged*:
each carries its own position, so a new request can join mid-flight.
Admission prefills the prompt into the slot's cache token by token through
a batch-1 view (the reference's ``lax.scan`` of decode steps; the other
slots are untouched), then the slot joins the shared tick.  Every family
the models port serves through it (dense, MoE, SSM, hybrid,
encoder-decoder).  An encoder-decoder request brings its frame
embeddings (``audio_embeds``): admission encodes them at batch 1 and
writes the slot's cross K/V (:func:`~repro_torch.models.encdec
.prefill_cross`) before the prompt's prefill.

The prefill starts from the slot's current content, as the reference's
does: for attention that is harmless (the positions are rewritten), but a
reused slot's SSM state (conv taps, recurrent state) is the finished
request's, advanced by every tick since, and the new request continues
from it (a reference fault, kept: ROADMAP C).  Frozen slots take part in
every tick, so in a MoE tick their tokens route and count against the
experts' capacity (the group is all ``batch_slots``), as in the reference.

Sampling: greedy, or temperature sampling from a ``torch.Generator`` seeded
with ``EngineConfig.seed`` (the same seed gives the same tokens; the draws
differ from the reference's ``jax.random``, so only greedy output is
comparable across the packages).  EOS or ``max_new`` frees the slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models.api import decode_step, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import dtype_of
from repro_torch.serve.kv_cache import slot_insert, slot_view

__all__ = ["EngineConfig", "DecodeEngine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch_slots: int = 8
    max_len: int = 1024
    temperature: float = 0.0          # 0 = greedy
    eos_token: int = -1               # -1: never
    cache_dtype: str = "bfloat16"
    seed: int = 0
    device: Optional[str] = None      # None = "cuda"


class DecodeEngine:
    def __init__(self, cfg: ModelConfig, params: torch.nn.Module,
                 ecfg: EngineConfig):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = resolve_device(ecfg.device)
        on = {p.device for p in params.parameters()}
        if any(d.type != self.device.type for d in on):
            raise ValueError(f"parameters on {sorted(map(str, on))}, engine "
                             f"on {self.device}")
        B = ecfg.batch_slots
        self.cache = init_cache(cfg, B, ecfg.max_len,
                                dtype=dtype_of(ecfg.cache_dtype),
                                device=self.device)
        self.pos = np.zeros(B, np.int32)
        self.active = np.zeros(B, bool)
        self.tokens = np.zeros(B, np.int32)
        self.outputs: List[List[int]] = [[] for _ in range(B)]
        self.max_new = np.zeros(B, np.int32)
        self.generated = np.zeros(B, np.int32)
        self.generator = torch.Generator(self.device).manual_seed(ecfg.seed)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, torch.int64)

    # ------------------------------------------------------------ device
    def _tick(self, tokens, pos, active):
        logits, self.cache = decode_step(self.params, self.cfg, self.cache,
                                         tokens, pos)
        if self.ecfg.temperature > 0.0:
            probs = torch.softmax(logits / self.ecfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        # Frozen slots keep their token and position; their cache row at
        # that position is rewritten by every tick — harmless, branch-free.
        nxt = torch.where(active, nxt, tokens)
        new_pos = torch.where(active, pos + 1, pos)
        return nxt, new_pos

    def _prefill(self, slot_cache, prompt: torch.Tensor):
        """Decode the prompt token by token into ``slot_cache`` (batch 1);
        returns the position after it and the last logits [vocab]."""
        positions = torch.arange(prompt.shape[0], device=self.device)
        logits = None
        for p in range(prompt.shape[0]):
            logits, slot_cache = decode_step(self.params, self.cfg,
                                             slot_cache, prompt[p:p + 1],
                                             positions[p])
        return slot_cache, prompt.shape[0], logits[0]

    # ------------------------------------------------------------ public
    def add_request(self, prompt: List[int], max_new: int = 32,
                    audio_embeds: Optional[torch.Tensor] = None,
                    patch_embeds=None) -> int:
        """Admit a request into a free slot; returns the slot id.  An
        encoder-decoder config needs ``audio_embeds`` [n_ctx, d_model].
        ``patch_embeds`` is accepted and ignored, as the reference's engine
        ignores it: decoding reads tokens only."""
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            raise RuntimeError("no free slots")
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        s = int(free[0])
        slot = slot_view(self.cache, s)
        if self.cfg.encoder is not None:
            if audio_embeds is None:
                raise ValueError(f"{self.cfg.name}: an audio arch needs "
                                 "audio_embeds")
            enc = encdec.encode(self.params, self.cfg,
                                audio_embeds[None].to(self.device))
            ck, cv = encdec.prefill_cross(self.params, self.cfg, enc)
            slot["cross_k"].copy_(ck)           # cast to the cache dtype
            slot["cross_v"].copy_(cv)
        slot, pos, logits = self._prefill(
            slot, self._dev(np.asarray(prompt, np.int64)))
        self.cache = slot_insert(self.cache, slot, s)
        self.pos[s] = pos
        first = int(torch.argmax(logits))
        self.tokens[s] = first
        self.outputs[s] = [first]
        self.active[s] = True
        self.max_new[s] = max_new
        self.generated[s] = 1
        return s

    def step(self) -> Dict[int, int]:
        """One synchronized decode tick; returns {slot: new_token}."""
        if not self.active.any():
            return {}
        nxt, new_pos = self._tick(self._dev(self.tokens), self._dev(self.pos),
                                  torch.from_numpy(self.active).to(
                                      self.device))
        nxt = nxt.cpu().numpy().astype(np.int32)
        self.pos = new_pos.cpu().numpy().astype(np.int32)
        out = {}
        for s in np.flatnonzero(self.active):
            t = int(nxt[s])
            self.tokens[s] = t
            self.outputs[s].append(t)
            self.generated[s] += 1
            out[int(s)] = t
            done = (t == self.ecfg.eos_token
                    or self.generated[s] >= self.max_new[s]
                    or self.pos[s] >= self.ecfg.max_len - 1)
            if done:
                self.active[s] = False
        return out

    def run_to_completion(self, max_ticks: int = 10_000):
        ticks = 0
        while self.active.any() and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.outputs
