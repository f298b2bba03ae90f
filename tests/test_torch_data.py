"""The port's copy of the data pipeline gives the reference's batches byte
for byte, and keeps its properties (``tests/test_system.py``'s Markov
corpus checks, ported)."""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import batches_for_model as ref_batches_for_model
from repro.data import frontend_stub as ref_frontend_stub
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batches_for_model, frontend_stub, token_batches
from repro_torch.data.pipeline import MarkovCorpus


def _same(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-medium", "llama-3.2-vision-90b"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_batches_equal_reference_byte_for_byte(arch, seed):
    """Tokens for every family, plus the audio frames and the VLM image
    stubs, over three consecutive batches."""
    dc = dict(vocab_size=97, seq_len=12, global_batch=3, seed=seed)
    ours = batches_for_model(get_config(arch).reduced(), DataConfig(**dc))
    theirs = ref_batches_for_model(ref_get_config(arch).reduced(), RefDataConfig(**dc))
    for _ in range(3):
        got, want = next(ours), next(theirs)
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])


@pytest.mark.parametrize("kind", ["audio", "vlm"])
def test_frontend_stub_equals_reference(kind):
    for seed in (0, 5):
        _same(frontend_stub(kind, 2, 7, 16, seed=seed), ref_frontend_stub(kind, 2, 7, 16,
                                                                          seed=seed))


def test_markov_corpus_determinism():
    dc = DataConfig(vocab_size=64, seq_len=16, global_batch=4, seed=3)
    a = next(token_batches(dc))["tokens"]
    b = next(token_batches(dc))["tokens"]
    np.testing.assert_array_equal(a, b)
    c = next(token_batches(dataclasses.replace(dc, seed=4)))["tokens"]
    assert not np.array_equal(a, c)


def test_markov_corpus_is_learnable_structure():
    dc = DataConfig(vocab_size=64, seq_len=256, global_batch=2, seed=0)
    corpus = MarkovCorpus(dc)
    toks = corpus.sample_batch(np.random.default_rng(0), 2, 256)
    # successors constrained to the table: every bigram must be a valid edge
    for b in range(2):
        for t in range(1, 256):
            prev, nxt = toks[b, t - 1], toks[b, t]
            assert nxt in corpus.successors[prev]
