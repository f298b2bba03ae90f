"""The entries a traffic mix can drive, one module each, found by the
mix's ``entry`` (``portbench/entries/<entry>.py``), and what they share.

An entry module has ``build(cfg_file, model_cfg=None)``, which makes the
program's model of a configuration file once in a process (``model_cfg``,
where given, in place of the one the file states), and ``Entry(model, cfg_file, mix, family, seed,
device)``, which makes its weights from the seed and drives the model:
``warm()``, ``window(seconds)``, ``trace_segment()``, ``run_sample()``,
``free()`` and ``readings(family, quant=None)`` (see ``prefill.py``).

Inputs come from the seed: call i's inputs from the ``numpy`` generator
(seed, i), whatever the window reaches; the warm-up draws from its own
stream, and so does the sample that the check compares, drawn before the
window starts.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import bench, weights

#: the stream of the warm-up's inputs and of the sample's draws
WARM_STREAM, SAMPLE_STREAM = 1 << 40, 1 << 41


def rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *keys])


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return float(v[max(0, -(-95 * len(v) // 100) - 1)])


def decoder(cfg_file: dict, model_cfg=None):
    """The program's decoder model (``Model``) of the configuration file,
    its ``ModelConfig`` checked against the file (``bench.model_config``)."""
    from repro_torch.models.model import Model

    return Model(model_cfg or bench.model_config(cfg_file))


def decoder_weights(model, family, seed: int, device) -> dict:
    """The model's parameter tree (names and shapes from its meta init),
    drawn from ``seed`` at the family's scales."""
    return weights.make(model.init(device="meta")[0], seed, device, family.init_scale)
