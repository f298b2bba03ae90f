"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

Reduced config by default (``--full`` for the published widths), on the
card unless ``--device`` names another, as ``repro.launch.train`` runs it.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DataConfig, batches_for_model
from repro_torch.models.model import Model
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="full config (published widths); default reduced")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = Model(cfg)
    print(f"{cfg.name}: {model.param_count()/1e6:.1f}M params on {args.device}")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    opt = adamw(cosine_with_warmup(args.lr, max(args.steps // 10, 1), args.steps))
    return train(model, opt, batches_for_model(cfg, dc), args.steps,
                 log_every=max(args.steps // 10, 1),
                 ckpt_dir=args.ckpt_dir or None,
                 ckpt_every=args.steps if args.ckpt_dir else 0,
                 device=args.device)


if __name__ == "__main__":
    main()
