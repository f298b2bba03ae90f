"""The port's dry run (``repro_torch.launch.dryrun``) and roofline reader
(``repro_torch.launch.roofline``) against the reference's
(``repro.launch.dryrun``, ``repro.launch.roofline``): the pure functions
for every arch and input shape, the abstract parameter and optimizer-state
trees, a roofline row; then ``dryrun_one`` on reduced configs, each family
on a fake (2, 2) mesh, and a one-rank count held against the FLOPs written
out from the config.

Importing the reference's dry run sets ``XLA_FLAGS`` for 512 host devices;
the flag is put back at once, before any JAX backend reads it."""

import dataclasses
import functools
import os

import jax
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import roofline as REF_ROOF
from repro.models.model import Model as RefModel
from repro.optim.adamw import opt_state_specs as ref_opt_state_specs
from repro.utils import params as REF_PARAMS
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as ROOF
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState, opt_state_specs
from repro_torch.utils.params import ParamBuilder, abstract_stack, tree_leaves

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as REF  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

CASES = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]


@functools.lru_cache(maxsize=None)
def param_totals(arch):
    """(the port's parameter count, the reference's), from abstract trees."""
    ref = REF_PARAMS.count_params(RefModel(ref_get_config(arch)).init(abstract=True)[0])
    return Model(get_config(arch)).param_count(), ref


def test_input_shapes_are_the_references():
    assert INPUT_SHAPES == REF_SHAPES and ARCH_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("arch,shape", CASES)
def test_active_param_count_matches_reference(arch, shape):
    total, ref_total = param_totals(arch)
    assert total == ref_total
    assert D.active_param_count(get_config(arch), total) == REF.active_param_count(
        ref_get_config(arch), total)


@pytest.mark.parametrize("arch,shape", CASES)
def test_model_flops_and_rules_overrides_match_reference(arch, shape):
    total, _ = param_totals(arch)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert D.model_flops(cfg, shape, total) == REF.model_flops(ref_cfg, shape, total)
    for opts in ((), ("seqpar", "ep2d", "fsdp"), ("no_kvseq_shard", "zero1", "smblock")):
        assert D.rules_overrides(cfg, shape, opts) == REF.rules_overrides(ref_cfg, shape, opts)


@pytest.mark.parametrize("arch,shape", CASES)
def test_refined_model_flops_match_reference(arch, shape):
    total, _ = param_totals(arch)
    r = dict(arch=arch, shape=shape, params_total=total,
             params_active=D.active_param_count(get_config(arch), total))
    assert ROOF.refined_model_flops(r) == REF_ROOF.refined_model_flops(r)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_depth_variants_match_reference(arch):
    got, want = D.depth_variants(get_config(arch)), REF.depth_variants(ref_get_config(arch))
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    assert got[2:] == want[2:]


@pytest.mark.parametrize("arch,shape", CASES)
def test_input_specs_match_reference(arch, shape):
    got = Model(get_config(arch)).input_specs(shape)
    want = RefModel(ref_get_config(arch)).input_specs(shape)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k


def _tree(tree):
    """{path: (shape, dtype name)} of a parameter tree (either framework)."""
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in tree for p, v in _tree(tree[k]).items()}
    return {"": (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def test_abstract_stack_and_opt_state_specs_match_reference():
    from repro.models import layers as REF_L
    from repro_torch.models import layers as L

    cfg, ref_cfg = get_config("qwen2.5-3b"), ref_get_config("qwen2.5-3b")
    b = ParamBuilder(None, dtype=torch.bfloat16, device="meta")
    L.init_attention(b, "attn", cfg)
    L.init_mlp(b, "ffn", cfg)
    rb = REF_PARAMS.ParamBuilder(None, dtype=jax.numpy.bfloat16, abstract=True)
    REF_L.init_attention(rb, "attn", ref_cfg)
    REF_L.init_mlp(rb, "ffn", ref_cfg)
    params, specs = abstract_stack(*b.build(), 36)
    ref_params, ref_specs = REF_PARAMS.abstract_stack(*rb.build(), 36)
    assert _tree(params) == _tree(ref_params) and specs == ref_specs
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    got, want = opt_state_specs(specs), ref_opt_state_specs(ref_specs)
    assert isinstance(got, AdamWState) and got._fields == want._fields
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_init_matches_reference(arch):
    """The meta-device parameter and spec trees of every arch at full size
    against the reference's abstract init."""
    params, specs = Model(get_config(arch)).init(device="meta")
    ref_params, ref_specs = RefModel(ref_get_config(arch)).init(abstract=True)
    assert _tree(params) == _tree(ref_params)
    assert specs == ref_specs


RECORD = dict(arch="deepseek-v2-236b", shape="decode_32k", multi_pod=False, chips=256,
              status="ok", params_total=235_741_434_880, params_active=21_375_418_880,
              flops_per_device=4.2e10, memory=dict(total_gb=12.345),
              roofline=dict(compute_s=4.2e-5, memory_s=3.1e-3, collective_s=-1e-6,
                            dominant="memory_s"))


@pytest.mark.parametrize("record", [RECORD, dict(arch="whisper-medium", shape="long_500k",
                                                 status="skipped", reason="no 500k context")],
                         ids=["ok", "skipped"])
def test_fmt_row_matches_reference(record):
    got, want = ROOF.fmt_row(record), REF_ROOF.fmt_row(record)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "lever"} == {
        k: v for k, v in want.items() if k != "lever"}
    assert set(ROOF.LEVERS) == set(REF_ROOF.LEVERS)


# ---------------------------------------------------------------------------
# traces on reduced configs
# ---------------------------------------------------------------------------

def reduced(arch, **changes):
    cfg = get_config(arch).reduced()
    if cfg.family == "audio":       # the decoder's learned positions cover the shapes
        changes.setdefault("max_positions", 32768)
    return dataclasses.replace(cfg, **changes)


@pytest.fixture(scope="module")
def mesh():
    from torch.distributed.device_mesh import init_device_mesh

    with D.fake_process_group(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


#: (arch, shape) of the mesh cases: every family, the dense one in each kind
MESH_CASES = [("qwen2.5-3b", "train_4k"), ("qwen2.5-3b", "prefill_32k"),
              ("qwen2.5-3b", "decode_32k"), ("deepseek-v2-236b", "decode_32k"),
              ("mamba2-130m", "decode_32k"), ("recurrentgemma-9b", "decode_32k"),
              ("whisper-medium", "decode_32k"), ("llama-3.2-vision-90b", "decode_32k")]


@pytest.mark.parametrize("arch,shape", MESH_CASES)
def test_dryrun_one_on_a_fake_mesh(mesh, arch, shape):
    """Each family on the mesh; the 4 ranks together count at least the
    single device's FLOPs (nothing the mesh runs goes uncounted) and at most
    a quarter more (the work the rules leave replicated: small here)."""
    r = D.dryrun_one(arch, shape, cfg=reduced(arch), mesh=mesh, accounting="rolled",
                     verbose=False)
    one = D.dryrun_one(arch, shape, cfg=reduced(arch), mesh=None, accounting="rolled",
                       verbose=False)
    assert r["status"] == "ok" and r["chips"] == 4 and r["compile_s"] is None
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert one["flops_per_device"] <= 4 * r["flops_per_device"] <= 1.25 * one["flops_per_device"]
    assert r["collective_bytes_per_device"] > 0 and sum(r["collective_counts"].values()) > 0
    m = r["memory"]
    assert m["argument_bytes"] > 0 and m["code_bytes"] == 0
    assert m["total_gb"] == round((m["argument_bytes"] + m["temp_bytes"]
                                   + m["output_bytes"]) / 2**30, 3)
    assert r["hlo_ops"]["fusion"] > 0
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")


def test_extrapolated_flops_equal_the_full_depth_trace(mesh):
    """Eager counts every layer: for the dense family the reference's
    two-shallow-trace extrapolation gives the full-depth trace's FLOPs."""
    r = D.dryrun_one("qwen2.5-3b", "decode_32k", cfg=reduced("qwen2.5-3b", num_layers=3),
                     mesh=mesh, verbose=False)
    ex = r["extrapolation"]
    assert ex["units"] == (2, 4, 3) and ex["flops"][0] < ex["flops"][1]
    assert r["flops_per_device"] == pytest.approx(ex["flops_rolled_body_once"], rel=1e-9)


def test_one_rank_prefill_flops_are_the_matmuls():
    """No mesh: the count is the weights' matmuls over the tokens, the
    attention's score and value products over the whole S x S square (the
    plain attention computes it, as the reference's XLA count does), and
    the head at the last position."""
    cfg = reduced("qwen2.5-3b")
    r = D.dryrun_one("qwen2.5-3b", "prefill_32k", cfg=cfg, mesh=None, accounting="rolled",
                     verbose=False)
    B, S = INPUT_SHAPES["prefill_32k"]["global_batch"], INPUT_SHAPES["prefill_32k"]["seq_len"]
    T, D_, H, Hkv, hd, F = (B * S, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim_, cfg.d_ff)
    per_layer = (2 * T * D_ * H * hd + 2 * 2 * T * D_ * Hkv * hd + 2 * T * H * hd * D_
                 + 3 * 2 * T * D_ * F + 2 * 2 * B * H * S * S * hd)
    want = cfg.num_layers * per_layer + 2 * B * D_ * cfg.padded_vocab
    assert r["chips"] == 1 and r["collective_bytes_per_device"] == 0
    assert r["flops_per_device"] == want
    assert r["memory"]["argument_bytes"] == (
        sum(t.numel() * t.element_size() for t in tree_leaves(Model(cfg).init(device="meta")[0]))
        + B * S * 4)


def test_one_rank_hybrid_decode_flops_are_the_products():
    """No mesh, one decode step of the hybrid: every weight's product over
    the batch's tokens (the recurrent block's five, its depthwise conv's
    taps, the MLP's two, the attention's four and the head), and the local
    attention's score and value products over its window. The untied
    embedding table is looked up, not multiplied, so the reference's
    ``model_flops`` (2 x parameters x tokens, the table included) exceeds
    the count: the full-size record's useful ratio above 1."""
    cfg = reduced("recurrentgemma-9b")
    r = D.dryrun_one("recurrentgemma-9b", "decode_32k", cfg=cfg, mesh=None,
                     accounting="rolled", verbose=False)
    B, S = INPUT_SHAPES["decode_32k"]["global_batch"], INPUT_SHAPES["decode_32k"]["seq_len"]
    D_, W, F, H, Hkv, hd = (cfg.d_model, cfg.lru_width or cfg.d_model, cfg.d_ff,
                            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    L = min(S, cfg.local_window)
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.num_layers)]
    rec = 2 * B * (2 * D_ * W + 2 * W * W + W * D_) + 2 * B * 4 * W
    attn = 2 * B * (2 * D_ * H * hd + 2 * D_ * Hkv * hd) + 2 * 2 * B * H * L * hd
    mlp = 2 * B * 2 * D_ * F
    want = (kinds.count("rec") * rec + kinds.count("attn") * attn + cfg.num_layers * mlp
            + 2 * B * D_ * cfg.padded_vocab)
    assert cfg.act == "gelu" and not cfg.tie_embeddings and set(kinds) == {"rec", "attn"}
    assert r["flops_per_device"] == want
    assert r["flops_per_device"] < r["model_flops"]
    assert r["model_flops"] - 2 * B * cfg.padded_vocab * D_ < r["flops_per_device"]


def test_heads_that_do_not_divide_the_model_axis(mesh):
    """Query heads that do not divide the model axis (qwen2-7b's 28 over 16
    at full size; here 6 over 4) trace: the projection's block is gathered
    before it is split into heads (GSPMD would reshard)."""
    from torch.distributed.device_mesh import init_device_mesh

    wide = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    r = D.dryrun_one("qwen2-7b", "decode_32k",
                     cfg=reduced("qwen2-7b", num_heads=6, num_kv_heads=2), mesh=wide,
                     accounting="rolled", verbose=False)
    assert r["status"] == "ok" and r["flops_per_device"] > 0


#: reduced configs with the head layouts of the published ones that the
#: default reduction loses: whisper-medium's as many kv heads as query heads,
#: mamba2-130m's SSM heads that the model axis does not divide (24 over 16;
#: here 3 over 2) while it divides the channels; and the most FLOPs the four
#: ranks may count, over the one device's
LAYOUT_CASES = {
    "whisper-medium": (dict(num_kv_heads=4), 1.25),
    # the SSD scan runs replicated over the model axis: up to twice
    "mamba2-130m": (dict(d_model=48, num_layers=1, ssm_chunk=1024), 2.0),
}


@pytest.mark.parametrize("arch", list(LAYOUT_CASES))
def test_training_with_the_published_head_layout(mesh, arch):
    """train_4k on the fake (2, 2) mesh. whisper-medium: the self and cross
    attentions' backward gathers the K, V and Q gradients over the heads
    before the head split's backward views them (``sharding._Redistribute``);
    mamba2-130m: the heads are split and merged whole (``layers.split_heads``,
    ``merge_heads``)."""
    changes, most = LAYOUT_CASES[arch]
    cfg = reduced(arch, **changes)
    if arch == "whisper-medium":
        assert cfg.num_kv_heads == cfg.num_heads
    else:
        from repro_torch.models.ssm import ssm_dims

        d_inner, heads, _, _ = ssm_dims(cfg)
        assert heads % 2 and d_inner % 2 == 0
    r = D.dryrun_one(arch, "train_4k", cfg=cfg, mesh=mesh, accounting="rolled", verbose=False)
    one = D.dryrun_one(arch, "train_4k", cfg=cfg, mesh=None, accounting="rolled", verbose=False)
    assert r["status"] == "ok" and r["chips"] == 4
    assert one["flops_per_device"] <= 4 * r["flops_per_device"] <= most * one["flops_per_device"]
    assert r["collective_bytes_per_device"] > 0 and sum(r["collective_counts"].values()) > 0


#: each of the reference's ``--opt`` values on the arch and shape where it acts
OPT_CASES = [("deepseek-v2-236b", "decode_32k", "ep2d"),
             ("deepseek-v2-236b", "decode_32k", "moe2d"),
             ("deepseek-v2-236b", "train_4k", "fsdp,ep2d")] + [
    ("qwen2.5-3b", "train_4k", o)
    for o in ("smblock", "seqpar", "fsdp", "zero1", "remat_outputs", "remat_none")] + [
    ("qwen2.5-3b", "decode_32k", o) for o in ("kv_int8", "no_kvseq_shard")]


@pytest.fixture
def traced_collectives(monkeypatch):
    """The collective records of each trace ``dryrun_one`` accounts, in order."""
    seen = []
    collective_bytes = D.collective_bytes

    def spy(records):
        seen.append(list(records))
        return collective_bytes(seen[-1])

    monkeypatch.setattr(D, "collective_bytes", spy)
    return seen


@pytest.mark.parametrize("arch,shape,opt", OPT_CASES)
def test_each_option_traces(mesh, traced_collectives, arch, shape, opt):
    """Each option traces on the fake (2, 2) mesh with the record's keys;
    under ``ep2d`` the MoE's all-reduce spans both mesh axes (a group of all
    4 ranks), under the default rules and ``moe2d`` no collective does."""
    opts = tuple(opt.split(","))
    r = D.dryrun_one(arch, shape, cfg=reduced(arch), mesh=mesh, opts=opts,
                     accounting="rolled", verbose=False)
    assert r["status"] == "ok" and r["opts"] == list(opts)
    assert r["flops_per_device"] > 0 and r["collective_counts"]["all-reduce"] > 0
    both = [c for c in traced_collectives[0] if c.group_size == 4]
    if "ep2d" in opts:
        assert {c.kind for c in both} == {"all-reduce"}
    else:
        assert not both


def test_ep2d_keeps_the_expert_axes_that_divide_the_experts(mesh, traced_collectives):
    """2D expert parallelism with experts that the two axes together do not
    divide (deepseek-v2's 160 and kimi-k2's 384 over 16 x 16 ranks; here 6
    over 2 x 2): the experts go over "data" alone, as their stacks are
    placed, and the MoE's all-reduce spans that axis (2 ranks)."""
    r = D.dryrun_one("deepseek-v2-236b", "decode_32k",
                     cfg=reduced("deepseek-v2-236b", num_experts=6), mesh=mesh, opts=("ep2d",),
                     accounting="rolled", verbose=False)
    assert r["status"] == "ok"
    assert not [c for c in traced_collectives[0] if c.group_size == 4]


def test_axis_group_over_two_axes_under_the_fake_mode(mesh):
    """A group over ("data", "model") is built from the mesh's rank list
    while the dry run's fake and counting modes are on, and a ``psum`` over
    both axes records one all-reduce of all 4 ranks."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.utils.sharding import axis_group, psum

    fresh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    counter = D.StepCount()
    with FakeTensorMode() as fake:
        x = torch.empty(8, 4)
    with fake, counter:
        group = axis_group(fresh, ("data", "model"))
        psum(x, fresh, ("data", "model"))
    assert dist.get_process_group_ranks(group) == [0, 1, 2, 3]
    assert counter.collectives == [D.Collective("all-reduce", (8, 4), "f32", 4)]
