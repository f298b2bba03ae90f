"""The port's logical sharding rules (``repro_torch.utils.sharding``) and
meshes (``repro_torch.launch.mesh``) against the reference's
(``repro.utils.sharding``): ``to_spec`` spec for spec for every logical axis
of ``DEFAULT_RULES`` on the production meshes' shapes, (16, 16) and (2, 16,
16) with "pod", with and without each override the dry run uses
(``src/repro/launch/dryrun.py:56-68``); ``safe_sharding_tree`` on shapes
that do and do not divide; ``shard`` and ``spec_tree`` without rules; each
rank's block under a spec, by the shard_map cut and by DTensor placements,
against JAX's tile assignment, on 4 gloo ranks; and the production meshes
under a fake process group of 256 and 512 ranks.

The reference's ``logical_rules`` needs a mesh of devices (an
``AbstractMesh`` cannot be entered), so the reference's rules are set in
its thread-local directly; nothing of ``src/repro`` changes.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as RefAbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding
from jax.sharding import PartitionSpec as RefP

from repro.utils import sharding as REF
from repro_torch.launch import mesh as MESH
from repro_torch.utils import sharding as S

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: the dry run's rule overrides (src/repro/launch/dryrun.py:56-68)
OVERRIDES = {"none": {}, "kv_seq": {"kv_seq": ("model",)}, "seq": {"seq": ("model",)},
             "experts": {"experts": ("data", "model")}, "fsdp": {"fsdp": ("data",)}}
#: every logical axis alone, then combinations: duplicate mesh axes (the
#: later one dropped), an axis no rule names, and the model's own tuples
AXES = [(a,) for a in REF.DEFAULT_RULES] + [
    ("batch", "seq", "heads"), ("heads", "ff"), ("batch", "batch"), ("vocab", "embed"),
    ("batch", "kv_heads", "kv_seq", None), ("layers", "batch", "kv_heads", "kv_seq", None),
    ("experts", None, None), ("fsdp", "experts"), ("batch", "experts"), ("ff", "fsdp"),
    ("not_an_axis",), (None, None), ("layers", "heads", "head_dim"), ("seq", "kv_seq")]


@contextlib.contextmanager
def both_rules(mesh_name, overrides):
    """The same rules active in both packages, on abstract meshes."""
    shape, names = MESHES[mesh_name]
    rules = dict(REF.DEFAULT_RULES)
    if "pod" in names:
        rules["batch"] = ("pod", "data")
    rules.update(overrides)
    prev = getattr(REF._state, "rules", None)
    REF._state.rules = REF.LogicalRules(RefAbstractMesh(shape, names), rules)
    try:
        with S.logical_rules(S.AbstractMesh(shape, names), overrides) as port:
            assert port.rules == REF._state.rules.rules
            yield REF._state.rules, port
    finally:
        REF._state.rules = prev


@pytest.mark.parametrize("overrides", list(OVERRIDES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_to_spec_matches_reference(mesh_name, overrides):
    with both_rules(mesh_name, OVERRIDES[overrides]) as (ref, port):
        for axes in AXES:
            assert tuple(port.to_spec(axes)) == tuple(ref.to_spec(axes)), axes
            assert tuple(S.spec_tree({"a": [axes]})["a"][0]) == tuple(
                REF.spec_tree({"a": [axes]})["a"][0]), axes
            assert tuple(S.sharding_tree({"a": axes})["a"].spec) == tuple(
                REF.sharding_tree({"a": axes})["a"].spec), axes


#: (shape, logical axes): dimensions that divide the mesh axes, and ones
#: that do not (a tuple entry keeps the axes that still divide, in order)
SAFE_CASES = [((32, 48), ("batch", "heads")), ((5, 7), ("batch", "heads")),
              ((2, 16), ("batch", "ff")), ((48, 8), ("heads", "ff")),
              ((24, 7), ("heads", "vocab")), ((64, 32, 6), ("experts", "fsdp", None)),
              ((4, 2, 16, 8), ("layers", "batch", "kv_heads", "kv_seq"))]


@pytest.mark.parametrize("overrides", ["none", "experts", "fsdp", "kv_seq"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_safe_sharding_tree_matches_reference(mesh_name, overrides):
    args = {"p": [torch.empty(shape, device="meta") for shape, _ in SAFE_CASES]}
    ref_args = {"p": [jax.ShapeDtypeStruct(shape, jnp.float32) for shape, _ in SAFE_CASES]}
    axes = {"p": [a for _, a in SAFE_CASES]}
    with both_rules(mesh_name, OVERRIDES[overrides]):
        got = S.safe_sharding_tree(args, axes)["p"]
        want = REF.safe_sharding_tree(ref_args, axes)["p"]
    for g, w, (shape, a) in zip(got, want, SAFE_CASES):
        assert tuple(g.spec) == tuple(w.spec), (shape, a, g.spec, w.spec)


def test_shard_is_a_noop_without_rules_and_on_a_plain_tensor():
    x = torch.zeros(4, 4)
    assert S.current_rules() is None
    assert S.shard(x, "batch", None) is x
    assert S.spec_tree({"w": (None, "heads")}) == {"w": S.P()}
    with S.logical_rules(S.AbstractMesh((2, 2), ("data", "model"))):
        assert S.shard(x, "batch", "heads") is x      # a rank's own block
    assert S.current_rules() is None


def test_logical_rules_nest_and_restore():
    """As the reference's: "pod" makes batch ("pod", "data"), overrides win,
    and leaving a region restores the rules outside it."""
    with S.logical_rules(S.AbstractMesh((2, 16, 16), ("pod", "data", "model"))) as outer:
        assert outer.rules["batch"] == ("pod", "data")
        with S.logical_rules(S.AbstractMesh((16, 16), ("data", "model")),
                             {"batch": None}) as inner:
            assert S.current_rules() is inner and inner.rules["batch"] is None
        assert S.current_rules() is outer
    assert S.current_rules() is None


def test_placements():
    """One placement per mesh dimension; a dimension split over two axes in
    the mesh's order is Shard on both; another order is refused (DTensor
    would split it in the mesh's order, JAX in the spec's)."""
    from torch.distributed.tensor import Replicate, Shard

    m3 = S.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert S.placements(S.P(("pod", "data"), None, "model"), m3) == (Shard(0), Shard(0),
                                                                    Shard(2))
    assert S.placements(S.P(None, "data"), m3) == (Replicate(), Shard(1), Replicate())
    assert S.placements(S.P(), m3) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        S.placements(S.P(("data", "pod")), m3)


def jax_block(x, shape, names, spec, rank):
    """Rank ``rank``'s block of ``x`` under ``spec`` by JAX's tile assignment
    on an abstract mesh (device i of the mesh = the i-th in row-major order,
    as ``init_device_mesh`` numbers its ranks)."""
    hlo = RefNamedSharding(RefAbstractMesh(shape, names), RefP(*spec))._to_xla_hlo_sharding(
        x.ndim)
    if hlo.is_replicated():
        return x
    dims = hlo.tile_assignment_dimensions()
    pos = np.argwhere(np.asarray(hlo.tile_assignment_devices()).reshape(dims) == rank)[0]
    for d in range(x.ndim):
        n = x.shape[d] // dims[d]
        x = np.take(x, np.arange(pos[d] * n, (pos[d] + 1) * n), axis=d)
    return x


@pytest.fixture(scope="module")
def rank_blocks(tmp_path_factory):
    from torch_gloo_ranks import Ranks

    d = tmp_path_factory.mktemp("sharding_ranks")
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    np.savez(d / "in.npz", x=x)
    return x, Ranks("sharding", d).results()


def test_local_blocks_match_jax(rank_blocks):
    """On 4 gloo ranks, for each spec on a (2, 2) ("data", "model") and a
    (2, 2, 1) ("pod", "data", "model") mesh: the shard_map cut
    (``local_block``) and, where the spec's tuples follow the mesh's order,
    ``distribute_tensor`` with ``placements``, give each rank JAX's block,
    as does ``shard`` of a replicated DTensor under the default rules;
    ``make_host_mesh`` under gloo is a (2, 2) CPU mesh."""
    from torch_gloo_ranks import PLACEMENT_CASES

    x, ranks = rank_blocks
    dtensor_cases = 0
    for rank, out in enumerate(ranks):
        assert tuple(out["host_shape"]) == (2, 2) and str(out["host_device"]) == "cpu"
        # shard(): a DTensor redistributed to the rules' placements, a plain
        # tensor (a rank's own block) unchanged
        np.testing.assert_array_equal(out["shard_dtensor"], jax_block(
            x, (2, 2), ("data", "model"), ("data", "model"), rank))
        assert bool(out["shard_plain_is_x"])
        for m, (shape, names, specs) in enumerate(PLACEMENT_CASES):
            assert tuple(out[f"coords{m}"]) == np.unravel_index(rank, shape)
            for c, spec in enumerate(specs):
                want = jax_block(x, shape, names, spec, rank)
                np.testing.assert_array_equal(out[f"block{m}_{c}"], want, err_msg=str(spec))
                in_order = all(list(e) == sorted(e, key=names.index) for e in spec
                               if isinstance(e, tuple))
                assert (f"dtensor{m}_{c}" in out) == in_order, spec
                if in_order:
                    np.testing.assert_array_equal(out[f"dtensor{m}_{c}"], want, str(spec))
                    dtensor_cases += 1
    assert dtensor_cases == 4 * 9


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks in this process, torn down on
    the way out so that no other test sees it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_under_a_fake_group(multi_pod):
    with fake_group(512 if multi_pod else 256):
        mesh = MESH.make_production_mesh(multi_pod=multi_pod)
        assert mesh.device_type == "cpu"
        if multi_pod:
            assert tuple(mesh.shape) == (2, 16, 16)
            assert mesh.mesh_dim_names == ("pod", "data", "model")
        else:
            assert tuple(mesh.shape) == (16, 16)
            assert mesh.mesh_dim_names == ("data", "model")
            host = MESH.make_host_mesh(model_parallel=16)
            assert tuple(host.shape) == (16, 16) and host.mesh_dim_names == ("data", "model")
        with S.logical_rules(mesh):
            assert tuple(S.current_rules().to_spec(("batch", "seq", "heads"))) == (
                (("pod", "data") if multi_pod else "data"), None, "model")
    assert not dist.is_initialized()


@pytest.mark.parametrize("heads", [8, 6])
def test_shard_drops_the_axes_that_do_not_divide(heads):
    """``shard`` of a DTensor on a (1, 4) mesh: "heads" over "model" where 4
    divides them, else replicated (a block must divide exactly)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_group(4):
        mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.zeros(2, heads, 8), mesh, [Replicate(), Replicate()],
                               run_check=False)
        with S.logical_rules(mesh):
            y = S.shard(x, "batch", "heads", None)
        assert y.placements[1] == (Shard(1) if heads % 4 == 0 else Replicate())
        assert tuple(y.shape) == (2, heads, 8)


def test_mesh_needs_a_group_and_follows_its_backend(monkeypatch):
    """No process group: an error, not a mesh. NCCL gives a CUDA mesh, gloo
    a CPU one; another backend is refused rather than given a CPU mesh."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        MESH.make_host_mesh()
    monkeypatch.setattr(MESH.dist, "is_initialized", lambda: True)
    for backend, want in (("nccl", "cuda"), ("gloo", "cpu"), ("cpu:gloo,cuda:nccl", "cuda")):
        monkeypatch.setattr(MESH.dist, "get_backend", lambda b=backend: b)
        assert MESH._device_type() == want
    monkeypatch.setattr(MESH.dist, "get_backend", lambda: "mpi")
    with pytest.raises(ValueError, match="mpi"):
        MESH._device_type()


@pytest.fixture(scope="module")
def dtensor_runs(tmp_path_factory):
    """The reference's parameters, inputs and outputs without a mesh, and
    the ranks' results on DTensors (``torch_gloo_ranks.job_dtensor``)."""
    from repro.configs import get_config as ref_get_config
    from repro.models.model import Model as RefModel
    from torch_gloo_ranks import DECODE_STEPS, DTENSOR_ARCHS, Ranks, dtensor_changes, flatten

    d = tmp_path_factory.mktemp("dtensor_ranks")
    rng = np.random.default_rng(0)
    models, params, arrays = {}, {}, {}
    for name, arch in DTENSOR_ARCHS.items():
        models[name] = RefModel(dataclasses.replace(ref_get_config(arch).reduced(),
                                                    **dtensor_changes(name)))
        params[name], _ = models[name].init(jax.random.PRNGKey(0))
        arrays.update({k: np.asarray(v) for k, v in flatten(params[name], f"{name}/p/").items()})
        arrays[f"{name}/tokens"] = rng.integers(0, models[name].cfg.vocab_size, (2, 16),
                                                dtype=np.int32)
    cfg = models["qwen"].cfg
    arrays["qwen/grad_tokens"] = rng.integers(0, cfg.vocab_size, (2, 17), dtype=np.int32)
    arrays["qwen/decode_tokens"] = rng.integers(0, cfg.vocab_size, (2, DECODE_STEPS),
                                                dtype=np.int32)
    for name in ("whisper", "whisper_mha"):
        wcfg = models[name].cfg
        arrays[f"{name}/frames"] = rng.standard_normal(
            (2, wcfg.num_frames, wcfg.d_model)).astype(np.float32)
    arrays["whisper_mha/grad_tokens"] = rng.integers(0, wcfg.vocab_size, (2, 17), dtype=np.int32)
    np.savez(d / "in.npz", **arrays)
    ranks = Ranks("dtensor", d)

    want = {}
    for name, keys in (("qwen", ["tokens"]), ("mamba", ["tokens"]),
                       ("whisper", ["tokens", "frames"]), ("whisper_mha", ["tokens", "frames"])):
        logits, _, cache = jax.jit(lambda p, b, m=models[name]: m.forward(p, b, mode="prefill"))(
            params[name], {k: jnp.asarray(arrays[f"{name}/{k}"]) for k in keys})
        want[f"{name}/logits"] = np.asarray(logits)
        if name == "qwen":
            want["qwen/k0"] = np.asarray(cache["kv"][0][0])
        if name == "mamba":
            want["mamba/ssm"] = np.asarray(cache["ssm_states"]["ssm"])
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: models["qwen"].loss_fn(p, {"tokens": jnp.asarray(arrays["qwen/grad_tokens"])},
                                         remat=False), has_aux=True))(params["qwen"])
    want["qwen/loss"] = float(loss)
    want["grads"] = {k: np.asarray(v) for k, v in flatten(grads).items()}
    batch = {k: jnp.asarray(arrays[f"whisper_mha/{a}"])
             for k, a in (("tokens", "grad_tokens"), ("frames", "frames"))}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: models["whisper_mha"].loss_fn(p, batch, remat=False), has_aux=True))(
            params["whisper_mha"])
    want["whisper_mha/loss"] = float(loss)
    want["whisper_mha/grads"] = {k: np.asarray(v) for k, v in flatten(grads).items()}
    cache, _ = models["qwen"].init_cache(2, DECODE_STEPS * 2)
    step = jax.jit(models["qwen"].decode_step)
    for t in range(DECODE_STEPS):
        logits, cache = step(params["qwen"], jnp.asarray(arrays["qwen/decode_tokens"][:, t]),
                             cache)
        want[f"decode/logits{t}"] = np.asarray(logits)
    return want, ranks.results()


#: the reference's bound for a sharded forward (tests/test_moe_sharded.py:90-91)
SHARDED_TOL = 5e-4


def test_dtensor_prefill_and_grads_match_reference(dtensor_runs):
    """On 4 gloo ranks, a (2, 2) mesh: reduced qwen2.5-3b (fp32) prefill on
    DTensor parameters placed by their logical axes, the model's shard calls
    in place, against the reference's forward without a mesh within
    SHARDED_TOL; ``loss_fn`` on (2, 17) tokens: the loss within SHARDED_TOL,
    each gradient leaf within 1e-4 of the leaf's largest reference gradient
    (as ``test_torch_smblock``)."""
    want, ranks = dtensor_runs
    for out in ranks:
        for key in ("qwen/logits", "qwen/k0"):
            np.testing.assert_allclose(out[key], want[key], rtol=SHARDED_TOL, atol=SHARDED_TOL)
        assert abs(float(out["qwen/loss"]) - want["qwen/loss"]) < SHARDED_TOL
        grads = want["grads"]
        assert {k.removeprefix("qwen/grad/") for k in out if k.startswith("qwen/grad/")} == set(
            grads)
        for k, g in grads.items():
            err = np.max(np.abs(out[f"qwen/grad/{k}"] - g)) / max(np.max(np.abs(g)), 1e-30)
            assert err < 1e-4, (k, err)


def test_dtensor_decode_with_a_sequence_sharded_cache_matches_reference(dtensor_runs):
    """Decode steps from an empty cache whose sequence is sharded over
    "model" ({"kv_seq": ("model",)}): each rank's softmax over its block of
    the cache, completed across the blocks, against the reference's steps."""
    from torch_gloo_ranks import DECODE_STEPS

    want, ranks = dtensor_runs
    for out in ranks:
        assert "Shard(dim=3)" in str(out["decode/cache_k"])
        for t in range(DECODE_STEPS):
            np.testing.assert_allclose(out[f"decode/logits{t}"], want[f"decode/logits{t}"],
                                       rtol=SHARDED_TOL, atol=SHARDED_TOL)


@pytest.mark.parametrize("key", ["mamba/logits", "mamba/ssm", "whisper/logits"])
def test_dtensor_ssd_and_cross_attention_match_reference(dtensor_runs, key):
    """The SSD scan (reduced mamba2-130m) and cross attention over frames
    (reduced whisper-medium) run rank by rank on heads: prefill logits and
    the SSD's final states against the reference's."""
    want, ranks = dtensor_runs
    for out in ranks:
        np.testing.assert_allclose(out[key], want[key], rtol=SHARDED_TOL, atol=SHARDED_TOL)


def test_dtensor_whisper_with_as_many_kv_heads_as_heads_matches_reference(dtensor_runs):
    """Reduced whisper-medium with its published head layout (kv heads =
    query heads, so that the kv heads are split over "model" as the query
    heads): prefill logits and ``loss_fn``'s loss within SHARDED_TOL of the
    reference's, each gradient leaf within 1e-4 of the leaf's largest
    reference gradient (the self and cross attentions' backward gathers the
    K, V and Q gradients over the heads before the head split's backward)."""
    want, ranks = dtensor_runs
    grads = want["whisper_mha/grads"]
    for out in ranks:
        np.testing.assert_allclose(out["whisper_mha/logits"], want["whisper_mha/logits"],
                                   rtol=SHARDED_TOL, atol=SHARDED_TOL)
        assert abs(float(out["whisper_mha/loss"]) - want["whisper_mha/loss"]) < SHARDED_TOL
        assert {k.removeprefix("whisper_mha/grad/") for k in out
                if k.startswith("whisper_mha/grad/")} == set(grads)
        for k, g in grads.items():
            err = np.max(np.abs(out[f"whisper_mha/grad/{k}"] - g)) / max(np.max(np.abs(g)),
                                                                         1e-30)
            assert err < 1e-4, (k, err)
