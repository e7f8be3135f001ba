"""End-to-end LM training on the PyTorch/CUDA port — AdamW first,
then the CGGN optimizer whose inner loop IS the paper's JPCG solver
(matrix-free Gauss–Newton).

Trains a ~100M-param gemma3-family model for a few hundred steps on the
synthetic Markov stream; loss drops visibly under both optimizers.

    PYTHONPATH=src python examples_torch/train_lm_cggn.py [--steps 200]
    PYTHONPATH=src python examples_torch/train_lm_cggn.py --size 25m \
        --steps 20 --cggn-steps 4 --device cpu
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.train import cggn_lm_step
from repro_torch.models import count_params, init_params
from repro_torch.train import (AdamWConfig, CGGNConfig, DataConfig,
                               SyntheticLM, Trainer, TrainerConfig,
                               adamw_init, cggn_init, make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--cggn-steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", choices=["100m", "25m"], default="100m",
                    help="~100M is the deliverable scale (takes a while "
                         "on CPU); 25m for a quick demo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # gemma3-family config reduced from the 1B.
    if args.size == "100m":
        cfg = dataclasses.replace(
            get_config("gemma3-1b"), name="gemma3-100m", n_layers=6,
            d_model=512, n_heads=8, n_kv_heads=2, d_ff=1536, head_dim=64,
            vocab=8192, sliding_window=128, dtype="float32", remat=False)
    else:
        cfg = dataclasses.replace(
            get_config("gemma3-1b"), name="gemma3-25m", n_layers=4,
            d_model=256, n_heads=4, n_kv_heads=1, d_ff=768, head_dim=64,
            vocab=4096, sliding_window=128, dtype="float32", remat=False)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    print(f"model: {cfg.name}, {count_params(params) / 1e6:.1f}M params")

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                  global_batch=args.batch, source="markov"),
                       device=dev)

    # ---------------- phase 1: AdamW ----------------
    opt = AdamWConfig(lr=3e-3)
    step_fn = make_train_step(cfg, opt=opt, microbatches=2, device=dev)
    trainer = Trainer(cfg, data, step_fn, params, adamw_init(params, opt),
                      TrainerConfig(total_steps=args.steps, ckpt_every=100,
                                    ckpt_dir=os.path.join(
                                        tempfile.gettempdir(),
                                        "ex_cggn_ckpt"),
                                    log_every=25))
    log = trainer.run()
    print(f"AdamW: loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}")

    # ---------------- phase 2: CGGN (JPCG inner solver) ----------------
    params = trainer.params
    ccfg = CGGNConfig(lr=0.5, damping=0.1, cg_iters=10, scheme="tpu_fp32",
                      max_delta_norm=2.0)
    state = cggn_init(params, 1)
    print(f"\nCGGN fine-tune: each step solves (G+λI)δ=-g with "
          f"{ccfg.cg_iters}-iteration JPCG (scheme={ccfg.scheme})")
    cggn = []
    for step in range(args.cggn_steps):
        # the GGN's logits and loss on this batch, the gradient, and the
        # JPCG solve: repro_torch.launch.train.lm_ggn_fns / cggn_update
        params, state, m = cggn_lm_step(params, state,
                                        data.batch_at(10_000 + step), ccfg)
        cggn.append({k: float(m[k]) for k in ("loss", "delta_norm")})
        if step % 5 == 0 or step == args.cggn_steps - 1:
            print(f"  cggn step {step:3d}  loss {float(m['loss']):.4f}  "
                  f"|δ| {float(m['delta_norm']):.3f}")
    return {"adamw": log, "cggn": cggn}


if __name__ == "__main__":
    main()
