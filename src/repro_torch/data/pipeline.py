"""Synthetic deterministic data pipeline.

Training data for the end-to-end examples: a seeded order-2 Markov "language"
over the model vocabulary whose statistics a model can actually learn (loss
decreases measurably within a few hundred steps); no external dataset is
read. Batches are yielded as numpy and moved to the device by the train loop.

A copy of ``repro.data.pipeline`` (numpy only, so the port imports no JAX):
the same seeds give byte-identical batches in both packages.

Also provides the modality-frontend STUBS for the audio/vlm families:
deterministic frame/patch embeddings of the right shape (the carve-out —
we implement the language backbone, not the ViT/conv codec).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 32          # out-degree of the Markov chain


class MarkovCorpus:
    """Bigram Markov chain with sharply Zipfian transitions — low enough
    conditional entropy (~1.5 nats) that a model visibly learns it within a
    few hundred steps."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, B = cfg.vocab_size, min(cfg.branching, cfg.vocab_size)
        self.successors = rng.integers(0, V, size=(V, B), dtype=np.int64)
        probs = 1.0 / np.arange(1, B + 1) ** 2.0
        self.probs = probs / probs.sum()

    def sample_batch(self, rng: np.random.Generator, batch: int, length: int) -> np.ndarray:
        V = self.cfg.vocab_size
        out = np.empty((batch, length), dtype=np.int32)
        b = rng.integers(0, V, size=batch)
        B = self.successors.shape[1]
        for t in range(length):
            choice = rng.choice(B, size=batch, p=self.probs)
            nxt = self.successors[b, choice]
            out[:, t] = nxt
            b = nxt
        return out


def token_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {"tokens": (B, S+1) int32} batches."""
    corpus = MarkovCorpus(cfg)
    rng = np.random.default_rng(cfg.seed + 1)
    while True:
        yield {"tokens": corpus.sample_batch(rng, cfg.global_batch, cfg.seq_len + 1)}


def frontend_stub(kind: str, batch: int, num_tokens: int, d_model: int,
                  seed: int = 0) -> np.ndarray:
    """Precomputed frame/patch embeddings (audio conv codec / ViT stub)."""
    rng = np.random.default_rng(seed + (17 if kind == "audio" else 29))
    return (rng.standard_normal((batch, num_tokens, d_model)) * 0.02).astype(np.float32)


def batches_for_model(cfg, data_cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Batches matching a ModelConfig's modality (adds frames/images stubs)."""
    it = token_batches(data_cfg)
    step = 0
    for batch in it:
        if cfg.family == "audio":
            batch["frames"] = frontend_stub("audio", data_cfg.global_batch,
                                            cfg.num_frames, cfg.d_model, seed=step)
        if cfg.family == "vlm":
            batch["images"] = frontend_stub("vlm", data_cfg.global_batch,
                                            cfg.num_image_tokens, cfg.d_model, seed=step)
        yield batch
        step += 1
