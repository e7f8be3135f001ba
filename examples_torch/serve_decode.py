"""Batched serving demo on the PyTorch/CUDA port — slot engine with
ragged request admission.

Runs the mamba2 family (O(1) decode state) and a SWA dense family side by
side, admitting requests mid-flight.

    PYTHONPATH=src python examples_torch/serve_decode.py               # the card
    PYTHONPATH=src python examples_torch/serve_decode.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import count_params, init_params
from repro_torch.serve import DecodeEngine, EngineConfig, bytes_per_slot


def demo(arch: str, n_requests: int = 6, max_new: int = 32,
         device=None) -> dict:
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    print(f"\n=== {arch} (reduced: {count_params(params) / 1e6:.1f}M) ===")
    print(f"cache bytes/slot @512 ctx: {bytes_per_slot(cfg, 512):,}")

    # temperature sampling draws from the engine's generator, seeded with
    # EngineConfig.seed (0) as the reference seeds its key
    eng = DecodeEngine(cfg, params, EngineConfig(
        batch_slots=4, max_len=512, temperature=0.7, cache_dtype="float32",
        device=str(dev)))
    rng = np.random.default_rng(0)
    pending = [[int(t) for t in rng.integers(1, cfg.vocab, size=k)]
               for k in rng.integers(4, 12, size=n_requests)]

    t0 = time.monotonic()
    tokens_out = 0
    while pending or eng.active.any():
        while pending and (~eng.active).any():
            eng.add_request(pending.pop(), max_new=max_new)
        tokens_out += len(eng.step())
    dt = time.monotonic() - t0
    print(f"{n_requests} requests, {tokens_out} decode ticks in {dt:.2f}s "
          f"({tokens_out / max(dt, 1e-9):.1f} batched-tok/s)")
    for i, out in enumerate(eng.outputs[:2]):
        print(f"  slot {i} sample: {out[:10]}...")
    return {"arch": arch, "requests": n_requests, "tokens": tokens_out,
            "seconds": dt, "outputs": [list(o) for o in eng.outputs]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    return [demo("mamba2-780m", device=dev),
            demo("h2o-danube-3-4b", device=dev)]


if __name__ == "__main__":
    main()
