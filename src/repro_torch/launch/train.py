"""Training launcher (port of ``repro.launch.train``).

  * ``--reduced``: a reduced variant of any arch, fp32, on the synthetic
    LM;
  * without it: the published config (its dtype included).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --reduced --steps 200 --batch 8 --seq 128 --ckpt /tmp/ckpt.npz \
      [--device cpu]

The checkpoint is the flat ``.npz`` both packages read
(``repro_torch.training.checkpoint``). On a card, attention and SSM
layers differentiate through their backward kernels, a published config
in its own dtype (bf16: the flash kernels take it; the SSM path computes
its SSD step in fp32, as JAX does), with AdamW's moments in fp32.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config, reduced
from repro_torch.data import lm_batches
from repro_torch.launch import require_device
from repro_torch.training import save_checkpoint, train
from repro_torch.training.optimizer import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, layers=args.layers, d_model=args.d_model,
                      vocab=args.vocab)
        cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("frontend-stub archs: use examples/ drivers")
    device = require_device(args.device)

    batches = lm_batches(cfg.vocab_size, args.batch, args.seq,
                         args.steps, seed=args.seed)
    params, losses = train(cfg, batches, steps=args.steps,
                           opt_cfg=AdamWConfig(lr=args.lr), seed=args.seed,
                           device=device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print("saved", args.ckpt)


if __name__ == "__main__":
    main()
