"""Training driver on the PyTorch port: data pipeline -> AdamW -> checkpoints
-> eval (``examples/train_small.py`` on ``repro_torch``).

Default is a ~12M-param model for a few hundred steps; ``--size 100m``
selects the ~100M configuration. Loss drops toward the synthetic corpus'
conditional entropy, demonstrating the full substrate end-to-end on
``--device``.

Run:  PYTHONPATH=src python examples/train_small_torch.py [--steps 300] [--size 12m]
      [--device cpu]
"""

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batches_for_model
from repro_torch.models.model import Model
from repro_torch.optim import adamw, cosine_with_warmup
from repro_torch.train import train
from repro_torch.train.step import make_eval_step

SIZES = {
    # name -> (layers, d_model, heads, kv, d_ff, vocab)
    "12m": (4, 256, 4, 2, 1024, 8192),
    "100m": (12, 768, 12, 4, 3072, 32768),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", choices=SIZES, default="12m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--device", default="cuda", help="where the model trains (cuda or cpu)")
    args = ap.parse_args()

    L, D, H, KV, FF, V = SIZES[args.size]
    cfg = dataclasses.replace(
        get_config("yi-9b"), name=f"dense-{args.size}", num_layers=L,
        d_model=D, num_heads=H, num_kv_heads=KV, head_dim=D // H,
        d_ff=FF, vocab_size=V)
    model = Model(cfg)
    print(f"model: {cfg.name}, {model.param_count()/1e6:.1f}M params, on {args.device}")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    opt = adamw(cosine_with_warmup(1e-3, 20, args.steps))
    params, opt_state, hist = train(
        model, opt, batches_for_model(cfg, dc), args.steps,
        log_every=max(args.steps // 10, 1),
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 2, 1), device=args.device)

    eval_step = make_eval_step(model)
    batch = {k: torch.from_numpy(v).to(args.device)
             for k, v in next(batches_for_model(cfg, dc)).items()}
    m = eval_step(params, batch)
    print(f"\nfinal eval: nll {float(m['nll']):.4f}  ppl {float(m['ppl']):.2f}")
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
          f"({args.steps} steps); checkpoints in {args.ckpt_dir}")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5, "training failed to learn"


if __name__ == "__main__":
    main()
