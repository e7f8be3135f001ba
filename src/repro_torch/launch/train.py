"""Training launcher — ``--arch <id> --optimizer adamw|cggn`` (the port of
:mod:`repro.launch.train`, plus ``--device``).

The reduced config by default; ``--full`` selects the published one.  The
dense, MoE, SSM and hybrid families train (``--arch granite-moe-1b-a400m
--optimizer cggn``, ``--arch mamba2-780m``, ...).  The encoder-decoder
family (``--arch whisper-base``) raises before any work, as the
reference's launcher does (a ``KeyError``): ``SyntheticLM`` makes no
``audio_embeds``.  whisper trains through ``make_train_step`` / ``Trainer``
and :func:`cggn_lm_step` on batches that carry them.

Example::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --device cpu --optimizer cggn --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --full --steps 20 --seq-len 128 --batch 8     # on the card
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
from torch.func import functional_call, grad_and_value

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.train import (AdamWConfig, CGGNConfig, DataConfig,
                               SyntheticLM, Trainer, TrainerConfig,
                               adamw_init, cggn_init, cggn_update,
                               make_train_step)

__all__ = ["main", "cggn_lm_step", "lm_ggn_fns", "CGGN_CONFIG"]

#: the launcher's CGGN settings (the reference's)
CGGN_CONFIG = CGGNConfig(cg_iters=8, scheme="tpu_fp32", lr=1.0)


def lm_ggn_fns(params, batch):
    """``(logits_fn, loss_logits)`` of the LM ``params`` on ``batch``: the
    model run through ``functional_call`` on a ``{name: tensor}`` dict,
    with the batch's frontend embeddings as the reference's
    ``forward_logits(p, cfg, batch)`` takes them (``patch_embeds``, or an
    encoder-decoder's ``audio_embeds``), and the mean next-token cross
    entropy in the logits (the GGN's factorization,
    :func:`repro_torch.core.gn.make_ggn_matvec`)."""
    labels = batch["labels"]
    extra = batch["audio_embeds"] if params.cfg.encoder is not None \
        else batch.get("patch_embeds")
    args = (batch["tokens"], extra)

    def logits_fn(p):
        return functional_call(params, p, args)

    def loss_logits(lg):
        lse = torch.logsumexp(lg, dim=-1)
        picked = torch.gather(lg, -1, labels[..., None])[..., 0]
        return (lse - picked).mean()

    return logits_fn, loss_logits


def cggn_lm_step(params, state, batch, ccfg: CGGNConfig = CGGN_CONFIG):
    """One CGGN update of the LM ``params`` (updated in place) on
    ``batch``.  Returns ``(params, state, metrics)``."""
    logits_fn, loss_logits = lm_ggn_fns(params, batch)

    def vag(p):
        g, loss = grad_and_value(lambda q: loss_logits(logits_fn(q)))(p)
        return loss, g

    return cggn_update(params, state, loss_logits_fn=loss_logits,
                       logits_fn=logits_fn, loss_value_and_grad=vag,
                       cfg=ccfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--optimizer", choices=["adamw", "cggn"],
                    default="adamw")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the reduced one")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.encoder is not None:
        raise ValueError(
            f"{cfg.name}: the synthetic data gives no audio_embeds, so the "
            "launcher cannot train the encoder-decoder family; neither can "
            "the reference's (a KeyError: ROADMAP C).  Train it through "
            "make_train_step / Trainer or cggn_lm_step on batches that "
            "carry audio_embeds")
    if not args.full:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} family={cfg.family} "
          f"~{cfg.param_count() / 1e6:.1f}M params on {dev}")

    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed),
                         device=dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                  global_batch=args.batch, seed=args.seed),
                       device=dev)

    if args.optimizer == "adamw":
        opt = AdamWConfig(lr=args.lr)
        step_fn = make_train_step(cfg, opt=opt,
                                  microbatches=args.microbatches, device=dev)
        trainer = Trainer(cfg, data, step_fn, params,
                          adamw_init(params, opt),
                          TrainerConfig(total_steps=args.steps,
                                        ckpt_every=args.ckpt_every,
                                        ckpt_dir=args.ckpt_dir),
                          torch.Generator().manual_seed(args.seed))
        log = trainer.run()
    else:
        state = cggn_init(params, args.seed)
        log = []
        for step in range(args.steps):
            params, state, m = cggn_lm_step(params, state,
                                            data.batch_at(step))
            log.append({"step": step, "loss": float(m["loss"])})
            if step % 5 == 0:
                print(f"step {step:4d}  loss {float(m['loss']):.4f}  "
                      f"|δ| {float(m['delta_norm']):.3f}  "
                      f"CG {m['cg_iters']} iterations")

    print(f"final loss: {log[-1]['loss']:.4f}")
    return log


if __name__ == "__main__":
    main()
