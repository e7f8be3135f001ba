"""Serving launcher — batched decode over the slot engine (the port of
:mod:`repro.launch.serve`, plus ``--device``).

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --full --requests 6 --max-new 24
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --device cpu                  # the reduced config on the CPU

Every family serves: dense, MoE (``granite-moe-1b-a400m``), SSM
(``mamba2-780m``), hybrid (``zamba2-1.2b``) and encoder-decoder
(``whisper-base``: each request is admitted with zero frame embeddings
``[n_ctx, d_model]``, as the reference's launcher does).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import DecodeEngine, EngineConfig, bytes_per_slot


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    print(f"arch={cfg.name}  cache bytes/slot@{args.max_len}: "
          f"{bytes_per_slot(cfg, args.max_len):,}")

    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         device=dev)
    eng = DecodeEngine(cfg, params, EngineConfig(
        batch_slots=args.slots, max_len=args.max_len,
        temperature=args.temperature, cache_dtype="float32", seed=args.seed,
        device=str(dev)))

    rng = np.random.default_rng(args.seed)
    pending = [list(rng.integers(1, cfg.vocab, size=rng.integers(3, 10)))
               for _ in range(args.requests)]
    done, t0, ticks = [], time.monotonic(), 0
    audio = None
    if cfg.encoder is not None:
        audio = torch.zeros((cfg.encoder.n_ctx, cfg.d_model), device=dev)

    while pending or eng.active.any():
        while pending and (~eng.active).any():
            prompt = pending.pop()
            s = eng.add_request([int(t) for t in prompt],
                                max_new=args.max_new, audio_embeds=audio)
            print(f"  admitted slot {s} (prompt {len(prompt)} tokens)")
        out = eng.step()
        ticks += 1
        for s in list(out):
            if not eng.active[s]:
                done.append((s, eng.outputs[s]))
                print(f"  slot {s} done: {len(eng.outputs[s])} tokens")
    dt = time.monotonic() - t0
    total = sum(len(o) for _, o in done)
    print(f"{len(done)} requests, {total} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s, {ticks} ticks) on {dev}")


if __name__ == "__main__":
    main()
