"""The per-rank half of the port's multi-rank tests
(``tests/test_torch_{sharding,moe,smblock}.py``).

``Ranks(job, tmp_path)`` starts one Python process of this file, which
imports the port once and forks ``WORLD`` ranks from it, each a gloo rank
on the CPU (rendezvous through a ``file://`` store in ``tmp_path``, so
parallel test workers never share a port). Each rank runs ``JOBS[job]`` on
the inputs the test wrote to ``tmp_path / "in.npz"``, saves what it found to
``tmp_path / f"out{rank}.npz"`` and writes its log to
``tmp_path / f"rank{rank}.log"``. The ranks import neither JAX nor the
reference package: the test computes the reference values in its own
process, while the ranks run.

As a script: ``python tests/torch_gloo_ranks.py JOB WORLD DIR``.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4

#: the reference test's reduced kimi-k2 (tests/test_moe_sharded.py:24-27)
MOE_CHANGES = dict(dtype="float32", d_model=64, num_experts=8, top_k=2, d_ff_expert=32,
                   num_shared_experts=1, capacity_factor=16.0)
#: the reference test's reduced qwen2-7b (tests/test_moe_sharded.py:73-75)
SMBLOCK_CHANGES = dict(dtype="float32", num_heads=4, num_kv_heads=2, head_dim=32,
                       d_model=128, d_ff=256)
#: the DTensor job's reduced configs, by name, and their changes
DTENSOR_ARCHS = {"qwen": "qwen2.5-3b", "mamba": "mamba2-130m", "whisper": "whisper-medium",
                 "whisper_mha": "whisper-medium"}
DTENSOR_CHANGES = dict(dtype="float32")
#: whisper-medium's published head layout (as many kv heads as query heads)
DTENSOR_ARCH_CHANGES = {"whisper_mha": dict(num_kv_heads=4)}
#: the DTensor job's decode steps (its cache holds twice as many)
DECODE_STEPS = 4
#: MoE cases: (name, rule overrides, impl)
MOE_CASES = (("default", {}, "auto"),
             ("experts_data_model", {"experts": ("data", "model")}, "auto"),
             ("2d", {"fsdp": ("data",)}, "2d"))
#: the sharding job's cases: (mesh shape, mesh axis names, specs of an (8, 8) x);
#: a spec is a tuple of entries (None, an axis, or a tuple of axes)
PLACEMENT_CASES = (
    ((2, 2), ("data", "model"),
     ((None, None), ("data", None), (None, "model"), ("data", "model"), ("model", "data"),
      (("data", "model"), None), (None, ("model", "data")))),
    ((2, 2, 1), ("pod", "data", "model"),
     ((("pod", "data"), None), (("data", "pod"), "model"), ("data", ("pod", "model")),
      (None, ("pod", "data")))),
)


def dtensor_changes(name: str) -> dict:
    """The changes to the reduced config of the DTensor job's ``name``."""
    return {**DTENSOR_CHANGES, **DTENSOR_ARCH_CHANGES.get(name, {})}


def flatten(tree, prefix="") -> dict:
    """{"a/b": leaf} of a tree of nested dicts, each path under ``prefix``."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flatten(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


class Ranks:
    """The ranks of one job on the inputs already in ``tmp_path``;
    ``results()`` waits for them and returns each rank's saved arrays. The
    process that forks them is the leader of a session of its own, so that
    on a failure or at the deadline the whole session is killed and no rank
    outlives the test."""

    def __init__(self, job: str, tmp_path: pathlib.Path, timeout: float = 240.0):
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
        self.dir, self.deadline = tmp_path, time.monotonic() + timeout
        self.log = open(tmp_path / "ranks.log", "w")
        self.proc = subprocess.Popen([sys.executable, __file__, job, str(WORLD), str(tmp_path)],
                                     env=env, stdout=self.log, stderr=subprocess.STDOUT,
                                     start_new_session=True)

    def results(self) -> list:
        try:
            self.proc.wait(timeout=max(0.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()
            self.log.close()
        logs = [self.dir / f"rank{r}.log" for r in range(WORLD)]
        assert self.proc.returncode == 0, "\n".join(
            [f"ranks exited {self.proc.returncode}: {(self.dir / 'ranks.log').read_text()}"]
            + [f"rank {r}: {log.read_text()[-3000:]}" for r, log in enumerate(logs)
               if log.exists()])
        return [dict(np.load(self.dir / f"out{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# jobs (run in the ranks)
# ---------------------------------------------------------------------------

def _tensors(flat: dict, prefix: str) -> dict:
    import torch

    return unflatten({k[len(prefix):]: torch.from_numpy(v.copy()) for k, v in flat.items()
                      if k.startswith(prefix)})


def job_sharding(rank: int, d: pathlib.Path) -> dict:
    """Each rank's block of ``x`` under every case's spec: by ``local_block``
    (the shard_map cut) and, where DTensor can split in that order, by
    ``distribute_tensor`` with ``placements``; a replicated DTensor through
    ``shard`` under the default rules; plus the meshes' coordinates."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.sharding import P, local_block, logical_rules, placements, shard

    x = torch.from_numpy(np.load(d / "in.npz")["x"])
    out = {}
    host = make_host_mesh(model_parallel=2)
    out["host_shape"] = np.array(host.shape)
    out["host_device"] = np.array(host.device_type)
    with logical_rules(host):     # batch -> "data", heads -> "model"
        whole = distribute_tensor(x, host, [Replicate(), Replicate()])
        out["shard_dtensor"] = shard(whole, "batch", "heads").to_local().numpy()
        out["shard_plain_is_x"] = np.array(shard(x, "batch", "heads") is x)
    for m, (shape, names, specs) in enumerate(PLACEMENT_CASES):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        out[f"coords{m}"] = np.array([mesh.get_local_rank(n) for n in names])
        for c, spec in enumerate(specs):
            spec = P(*spec)
            out[f"block{m}_{c}"] = local_block(x, spec, mesh).numpy()
            try:
                dt = distribute_tensor(x, mesh, placements(spec, mesh))
            except ValueError:
                continue
            out[f"dtensor{m}_{c}"] = dt.to_local().numpy()
    return out


def job_moe(rank: int, d: pathlib.Path) -> dict:
    """The port's ``apply_moe`` on a (2, 2) ("data", "model") mesh in each of
    MOE_CASES, with d/d(params, x) of sum(y * w) + mean(aux); and off the
    mesh."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.utils.sharding import logical_rules

    flat = dict(np.load(d / "in.npz"))
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(), **MOE_CHANGES)
    x0, w = torch.from_numpy(flat["x"]), torch.from_numpy(flat["w"])
    mesh = make_host_mesh(model_parallel=2)
    out = {}
    y, aux = MOE.apply_moe(_tensors(flat, "p/"), x0, cfg)
    out["offmesh/y"], out["offmesh/aux"] = y.numpy(), aux.numpy()
    for name, overrides, impl in MOE_CASES:
        p = {k: v.requires_grad_() for k, v in _tensors(flat, "p/").items()}
        x = x0.clone().requires_grad_()
        with logical_rules(mesh, overrides):
            y, aux = MOE.apply_moe(p, x, cfg, impl=impl)
        (torch.sum(y * w) + aux.mean()).backward()
        out[f"{name}/y"], out[f"{name}/aux"] = y.detach().numpy(), aux.detach().numpy()
        out[f"{name}/grad/x"] = x.grad.numpy()
        out.update({f"{name}/grad/{k}": v.grad.numpy() for k, v in p.items()})
    return out


def job_smblock(rank: int, d: pathlib.Path) -> dict:
    """The port's ``Model.forward`` (train) with ``block_impl="shardmap"``
    under {"seq": ("model",)} on (2, 2) and (1, 4) meshes, with the gradients
    of ``loss_fn`` (remat off and on); and the dispatch's fallbacks to the
    plain block, each against the port's own forward without rules, with
    the shardmap blocks run counted."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import smblock as SMB
    from repro_torch.models.model import Model
    from repro_torch.utils.sharding import logical_rules

    flat = dict(np.load(d / "in.npz"))
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), **SMBLOCK_CHANGES)
    calls = []
    inner = SMB.dense_block_shardmap

    def counted(*args, **kw):
        calls.append(1)
        return inner(*args, **kw)

    SMB.dense_block_shardmap = counted
    out = {}
    seq = {"seq": ("model",)}
    for mp in (2, 4):
        mesh = make_host_mesh(model_parallel=mp)
        model = Model(cfg)
        model.block_impl = "shardmap"
        params = _tensors(flat, "p/")
        tokens = torch.from_numpy(flat["tokens"])
        calls.clear()
        with logical_rules(mesh, seq):
            logits, _, _ = model.forward(params, {"tokens": tokens}, mode="train")
        out[f"mp{mp}/logits"] = logits.numpy()
        out[f"mp{mp}/calls"] = np.array(len(calls))
        for remat in (False, True):
            params = {k: v.requires_grad_() for k, v in flatten(_tensors(flat, "p/")).items()}
            with logical_rules(mesh, seq):
                loss, _ = model.loss_fn(unflatten(params), {"tokens": torch.from_numpy(
                    flat["grad_tokens"])}, remat=remat)
            loss.backward()
            out[f"mp{mp}/remat{int(remat)}/loss"] = loss.detach().numpy()
            out.update({f"mp{mp}/remat{int(remat)}/grad/{k}": v.grad.numpy()
                        for k, v in params.items()})

    # the fallbacks: each against the same model's forward without rules
    mesh = make_host_mesh(model_parallel=4)
    g = torch.Generator().manual_seed(0)
    fallbacks = {
        "seq30": (cfg, 30, "train"),
        "prefill": (cfg, 32, "prefill"),
        "moe": (dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(),
                                    dtype="float32", capacity_factor=16.0), 32, "train"),
        "mla": (dataclasses.replace(get_config("deepseek-v2-236b").reduced(),
                                    dtype="float32", capacity_factor=16.0), 32, "train"),
    }
    for name, (fcfg, S, mode) in fallbacks.items():
        model = Model(fcfg)
        params, _ = model.init(torch.Generator().manual_seed(1), device="cpu")
        tokens = torch.randint(0, fcfg.vocab_size, (2, S), generator=g, dtype=torch.int32)
        want, _, _ = model.forward(params, {"tokens": tokens}, mode=mode)
        model.block_impl = "shardmap"
        calls.clear()
        with logical_rules(mesh, seq):
            got, _, _ = model.forward(params, {"tokens": tokens}, mode=mode)
        out[f"fallback/{name}/got"], out[f"fallback/{name}/want"] = got.numpy(), want.numpy()
        out[f"fallback/{name}/calls"] = np.array(len(calls))
        out[f"fallback/{name}/dense_first"] = np.array(model._n_dense_first)
    return out


def _placed(tree, axes, mesh):
    """``tree``'s whole tensors as DTensors at the active rules' placements
    for their logical ``axes`` (``safe_sharding_tree``), as the dry run
    places its arguments."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.utils.sharding import _map_axes, safe_sharding_tree

    return _map_axes(lambda s, t: distribute_tensor(t, mesh, s.placements),
                     safe_sharding_tree(tree, axes), tree,
                     is_leaf=lambda s: hasattr(s, "placements"))


def job_dtensor(rank: int, d: pathlib.Path) -> dict:
    """The port's model on DTensors on a (2, 2) ("data", "model") mesh, as
    the dry run places them (``_placed``), each rank's ops through the
    per-rank paths of ``kernels/ops.py`` and ``models/layers.py``; every
    result gathered whole. Reduced fp32 configs (``DTENSOR_ARCHS``):
    qwen2.5-3b prefill (last logits, the first layer's K) and ``loss_fn``'s
    loss and gradients (remat off), then ``DECODE_STEPS`` decode steps from
    an empty cache under {"kv_seq": ("model",)} (the cache's sequence over
    "model"); mamba2-130m prefill (the SSD scan, its final states);
    whisper-medium prefill over frames (cross attention), and with as many
    kv heads as query heads its prefill, loss and gradients."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.utils.params import tree_leaves, tree_map
    from repro_torch.utils.sharding import logical_rules

    flat = dict(np.load(d / "in.npz"))
    mesh = make_host_mesh(model_parallel=2)
    models = {k: Model(dataclasses.replace(get_config(a).reduced(), **dtensor_changes(k)))
              for k, a in DTENSOR_ARCHS.items()}
    specs = {k: m.init(device="meta")[1] for k, m in models.items()}
    out = {}

    def batch_of(name, keys):
        arrays = {k: torch.from_numpy(flat[f"{name}/{k}"]) for k in keys}
        return _placed(arrays, {k: ("batch",) + (None,) * (a.dim() - 1)
                                for k, a in arrays.items()}, mesh)

    with logical_rules(mesh), implicit_replication():
        params = {k: _placed(_tensors(flat, f"{k}/p/"), specs[k], mesh) for k in models}
        with torch.no_grad():
            logits, _, cache = models["qwen"].forward(params["qwen"], batch_of("qwen", ["tokens"]),
                                                      mode="prefill")
            out["qwen/logits"] = logits.full_tensor().numpy()
            out["qwen/k0"] = cache["kv"][0][0].full_tensor().numpy()
            logits, _, cache = models["mamba"].forward(
                params["mamba"], batch_of("mamba", ["tokens"]), mode="prefill")
            out["mamba/logits"] = logits.full_tensor().numpy()
            out["mamba/ssm"] = cache["ssm_states"]["ssm"].full_tensor().numpy()
            for name in ("whisper", "whisper_mha"):
                logits, _, _ = models[name].forward(
                    params[name], batch_of(name, ["tokens", "frames"]), mode="prefill")
                out[f"{name}/logits"] = logits.full_tensor().numpy()

        def loss_and_grads(name, batch):
            inputs = tree_map(lambda t: t.detach().requires_grad_(), params[name])
            loss, _ = models[name].loss_fn(inputs, batch, remat=False)
            grads = iter([g.full_tensor().numpy()
                          for g in torch.autograd.grad(loss, tree_leaves(inputs))])
            out[f"{name}/loss"] = loss.detach().full_tensor().numpy()
            out.update({f"{name}/grad/{k}": v for k, v in flatten(tree_map(
                lambda _: next(grads), params[name])).items()})

        loss_and_grads("qwen", {"tokens": batch_of("qwen", ["grad_tokens"])["grad_tokens"]})
        batch = batch_of("whisper_mha", ["grad_tokens", "frames"])
        loss_and_grads("whisper_mha", {"tokens": batch["grad_tokens"], "frames": batch["frames"]})
    with logical_rules(mesh, {"kv_seq": ("model",)}), implicit_replication(), torch.no_grad():
        model = models["qwen"]
        cache, cspecs = model.init_cache(2, DECODE_STEPS * 2, device="cpu")
        cache = _placed(cache, cspecs, mesh)
        out["decode/cache_k"] = np.array(str(cache["k"].placements))
        steps = batch_of("qwen", ["decode_tokens"])["decode_tokens"]
        for t in range(DECODE_STEPS):
            logits, cache = model.decode_step(params["qwen"], steps[:, t], cache)
            out[f"decode/logits{t}"] = logits.full_tensor().numpy()
    return out


JOBS = {"sharding": job_sharding, "moe": job_moe, "smblock": job_smblock,
        "dtensor": job_dtensor}


def _rank(job: str, rank: int, world: int, d: pathlib.Path) -> None:
    import torch.distributed as dist

    log = os.open(d / f"rank{rank}.log", os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(log, 1)
    os.dup2(log, 2)
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}", rank=rank,
                            world_size=world)
    try:
        out = JOBS[job](rank, d)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(d / f"out{rank}.npz", **out)


def main(job: str, world: int, d: pathlib.Path) -> None:
    """Import the port once, then fork the ranks; a rank that fails stops
    the others at once (they would wait in a collective)."""
    sys.modules["jax"] = None         # the ranks run the port alone
    sys.modules["repro"] = None
    import torch
    import torch.distributed.tensor  # noqa: F401

    if job == "smblock":
        import torch._dynamo  # noqa: F401  (the first checkpointed call imports it)

    import repro_torch.launch.mesh  # noqa: F401
    import repro_torch.models.model  # noqa: F401
    import repro_torch.utils.sharding  # noqa: F401

    torch.set_num_threads(1)
    fork = multiprocessing.get_context("fork")
    procs = [fork.Process(target=_rank, args=(job, r, world, d)) for r in range(world)]
    for p in procs:
        p.start()
    while any(p.is_alive() for p in procs) and not any(p.exitcode for p in procs):
        time.sleep(0.02)
    for p in procs:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    print("rank exit codes:", codes)
    sys.exit(0 if codes == [0] * world else 1)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), pathlib.Path(sys.argv[3]))
