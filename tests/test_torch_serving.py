"""The port's serving engine against the reference's on the same converted
fp32 parameters, for a reduced model of each family (dense qwen2.5-3b,
SSM mamba2-130m, hybrid recurrentgemma-9b, MoE deepseek-v2-236b with MLA and
kimi-k2-1t-a32b with GQA, audio whisper-medium, whose engine runs the
encoder over the frontend stub's frames for each group, and VLM
llama-3.2-vision-90b at 4 layers with its cross-layer gate at 0.5, since
the initial 0 would hide the cross layers): identical greedy tokens,
identical node per request, and an identical metrics dict (the simulated
clock, NSA scoring and FLOP charge are the same code and the same parameter
count). Mirrors ``tests/test_system.py``'s serving checks."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.core.cluster import make_paper_cluster as ref_make_paper_cluster
from repro.models.model import Model as RefModel
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefServingEngine
from repro_torch.configs import get_config
from repro_torch.core.cluster import make_paper_cluster
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine
from repro_torch.utils.params import from_jax


def _requests(cls):
    # two prompt lengths, so that the batcher forms several groups
    return ([cls(i, np.arange(3, 11, dtype=np.int32), 6) for i in range(10)]
            + [cls(10 + i, np.arange(5, 10, dtype=np.int32), 4) for i in range(3)])


ARCHS = ["qwen2.5-3b", "mamba2-130m", "recurrentgemma-9b", "deepseek-v2-236b",
         "kimi-k2-1t-a32b", "whisper-medium", "llama-3.2-vision-90b"]
#: config changes for the comparison: two VLM super-blocks
CHANGES = {"llama-3.2-vision-90b": {"num_layers": 4}}


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    changes = {"dtype": "float32", **CHANGES.get(request.param, {})}
    ref_cfg = dataclasses.replace(ref_get_config(request.param).reduced(), **changes)
    cfg = dataclasses.replace(get_config(request.param).reduced(), **changes)
    ref_params, _ = RefModel(ref_cfg).init(jax.random.PRNGKey(5))
    # the VLM's gate at 0.5 (init 0, tanh(0) = 0, would hide the cross layers)
    ref_params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.full_like(a, 0.5) if path[-1].key == "gate" else a, ref_params)
    ref_reqs, reqs = _requests(RefRequest), _requests(Request)
    ref_metrics = RefServingEngine(ref_cfg, ref_params, ref_make_paper_cluster(),
                                   max_batch=4).serve(ref_reqs)
    metrics = ServingEngine(cfg, from_jax(ref_params, device="cpu"), make_paper_cluster(),
                            max_batch=4, device="cpu").serve(reqs)
    return ref_reqs, ref_metrics, reqs, metrics


def test_same_tokens_and_nodes(served):
    ref_reqs, _, reqs, _ = served
    for r_ref, r in zip(ref_reqs, reqs):
        assert r.output.shape == (r.max_new_tokens,)
        np.testing.assert_array_equal(r.output, r_ref.output)
        assert r.node_id == r_ref.node_id
        assert (r.ttft_ms, r.finish_ms) == (r_ref.ttft_ms, r_ref.finish_ms)


def test_same_metrics(served):
    _, ref_metrics, _, metrics = served
    assert metrics == ref_metrics
    assert metrics["num_requests"] == 13
    assert len(metrics["requests_per_node"]) >= 2   # NSA spread the batches
    assert metrics["tokens_per_s"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_cpu(capsys, arch):
    m = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2", "--prompt-len", "3",
                    "--new-tokens", "2", "--max-batch", "1"])
    assert m["num_requests"] == 2
    assert "tokens_per_s" in capsys.readouterr().out
