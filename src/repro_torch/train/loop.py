"""Training loop: data -> step -> logging -> checkpoints, as
``repro.train.loop``; batches move to ``device`` (the card by default)."""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import save_checkpoint
from repro_torch.models.model import Model
from repro_torch.optim.adamw import Optimizer
from repro_torch.train.step import make_train_step


def train(
    model: Model,
    optimizer: Optimizer,
    batches: Iterator[Dict[str, np.ndarray]],
    num_steps: int,
    *,
    params=None,
    log_every: int = 20,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    remat: bool = True,
    log_fn: Callable[[str], None] = print,
    device="cuda",
):
    """Runs ``num_steps`` steps; without ``params``, initialises them on
    ``device`` from a generator seeded 0. Returns (params, opt_state,
    history), one history entry per logged step."""
    if params is None:
        params, _ = model.init(device=device)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, optimizer, remat=remat)

    history = []
    t0 = time.perf_counter()
    tokens_seen = 0
    for step in range(1, num_steps + 1):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(batches).items()}
        tokens_seen += batch["tokens"].numel()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == num_steps or step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            m.update(step=step, tok_per_s=tokens_seen / max(dt, 1e-9))
            history.append(m)
            log_fn(f"step {step:5d}  loss {m['loss']:.4f}  nll {m['nll']:.4f}  "
                   f"gnorm {m['grad_norm']:.2f}  lr {m['lr']:.2e}  "
                   f"tok/s {m['tok_per_s']:.0f}")
        if ckpt_dir and ckpt_every and step % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step, params, opt_state)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, num_steps, params, opt_state)
    return params, opt_state, history
