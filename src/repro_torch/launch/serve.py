"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Reduced model, AMP4EC-scheduled batched serving on the simulated edge
cluster, on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.cluster import make_paper_cluster
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = Model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params, _ = model.init(gen, device=args.device)
    cluster = make_paper_cluster()
    engine = ServingEngine(cfg, params, cluster, max_batch=args.max_batch,
                           device=args.device)
    reqs = [Request(i, np.arange(1, args.prompt_len + 1, dtype=np.int32),
                    args.new_tokens) for i in range(args.requests)]
    m = engine.serve(reqs)
    for k, v in m.items():
        if k != "scheduler":
            print(f"{k}: {v}")
    return m


if __name__ == "__main__":
    main()
