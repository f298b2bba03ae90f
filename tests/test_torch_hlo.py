"""The dry run's accounting (``repro_torch.utils.hlo`` and the counting
layer of ``repro_torch.launch.dryrun``) against the reference's HLO
arithmetic (``repro.utils.hlo``), and the per-rank counts on a fake 4-rank
(2, 2) mesh: a sharded matmul counts the rank's share, a Shard(0) ->
Shard(1) redistribution is one all-to-all, and a column- then row-parallel
MLP one all-reduce of twice its output."""

import contextlib

import pytest
import torch
import torch.distributed as dist

from repro.utils import hlo as REF
from repro_torch.launch import dryrun as D
from repro_torch.utils import hlo as H
from test_utils import SAMPLE_HLO

#: SAMPLE_HLO's collectives as the trace records them (result shapes)
SAMPLE_RECORDS = [H.Collective("all-reduce", (8, 128), "bf16", 4),
                  H.Collective("all-gather", (64, 128), "f32", 8),
                  H.Collective("reduce-scatter", (2, 128), "f32", 32),
                  H.Collective("collective-permute", (8, 128), "bf16", 2)]


def test_collective_bytes_match_the_reference_on_sample_hlo():
    total, by_kind, counts = H.collective_bytes(SAMPLE_RECORDS)
    ref_total, ref_by_kind, ref_counts = REF.collective_bytes(SAMPLE_HLO)
    assert total == ref_total
    assert by_kind == ref_by_kind
    assert counts == ref_counts
    assert H._WIRE_FACTOR == REF._WIRE_FACTOR and H._DTYPE_BYTES == REF._DTYPE_BYTES


def test_op_histogram_table():
    ops = [H.Op("aten.mm"), H.Op("aten.view", launch=False), H.Op("aten.empty", launch=False),
           H.Op("_c10d_functional.all_reduce"), H.Op("c10d._allgather_base_"),
           H.Op("_dtensor.shard_dim_alltoall"), H.Op("aten.index_put"),
           H.Op("aten.scatter_add"), H.Op("aten.slice_scatter"),
           H.Op("aten.copy_", into_view=True), H.Op("aten.copy_"),
           H.Op("kernel.flash_attention")]
    assert H.op_histogram(ops) == {"fusion": 9, "all-reduce": 1, "all-gather": 1,
                                   "all-to-all": 1, "scatter": 2, "dynamic-update-slice": 2,
                                   "custom-call": 1}
    assert set(H.COLLECTIVE_OPS.values()) == set(H._WIRE_FACTOR)


@contextlib.contextmanager
def mesh_2x2():
    from torch.distributed.device_mesh import init_device_mesh

    with D.fake_process_group(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    assert not dist.is_initialized()


def dtensor(mesh, shape, placements, dtype=torch.float32):
    """A DTensor of ``shape`` under ``placements``: rank 0's block, new."""
    from torch.distributed.tensor import DTensor, Shard

    local = list(shape)
    for p, n in zip(placements, mesh.shape):
        if isinstance(p, Shard):
            local[p.dim] //= n
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def count_on_mesh(fn, args):
    """``count_step``'s layer on DTensors already placed (no rules)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    counter = D.StepCount()
    with FakeTensorMode() as fake:
        dargs = [a() for a in args]
    with fake, counter, D._dtensor_hooks(counter):
        out = fn(*dargs)
    return counter, out


def test_sharded_matmul_counts_the_ranks_share():
    from torch.distributed.tensor import Replicate, Shard

    with mesh_2x2() as mesh:
        x = lambda: dtensor(mesh, (64, 128), (Replicate(), Replicate()))  # noqa: E731
        # the weight's columns over all 4 ranks (both mesh axes)
        col = lambda: dtensor(mesh, (128, 256), (Shard(1), Shard(1)))  # noqa: E731
        rep = lambda: dtensor(mesh, (128, 256), (Replicate(), Replicate()))  # noqa: E731
        counter, out = count_on_mesh(lambda a, w: a @ w, [x, col])
        assert counter.flops == 2 * 64 * 128 * 256 / 4 == 1_048_576
        assert tuple(out.to_local().shape) == (64, 64) and not counter.collectives
        counter, _ = count_on_mesh(lambda a, w: a @ w, [x, rep])
        assert counter.flops == 2 * 64 * 128 * 256 == 4_194_304


def test_shard_to_shard_is_one_all_to_all():
    from torch.distributed.tensor import Replicate, Shard

    with mesh_2x2() as mesh:
        x = lambda: dtensor(mesh, (64, 128), (Replicate(), Shard(0)))  # noqa: E731
        counter, out = count_on_mesh(
            lambda a: a.redistribute(mesh, (Replicate(), Shard(1))), [x])
        assert tuple(out.to_local().shape) == (64, 64)
        assert counter.collectives == [H.Collective("all-to-all", (64, 64), "f32", 2)]
        total, by_kind, counts = H.collective_bytes(counter.collectives)
        assert total == by_kind["all-to-all"] == 64 * 64 * 4 and counts == {"all-to-all": 1}
        assert H.op_histogram(counter.ops).get("all-gather", 0) == 0


def test_column_then_row_parallel_mlp_is_one_all_reduce():
    from torch.distributed.tensor import Replicate, Shard

    with mesh_2x2() as mesh:
        x = lambda: dtensor(mesh, (32, 64), (Replicate(), Replicate()))  # noqa: E731
        w1 = lambda: dtensor(mesh, (64, 256), (Replicate(), Shard(1)))  # noqa: E731
        w2 = lambda: dtensor(mesh, (256, 64), (Replicate(), Shard(0)))  # noqa: E731

        def mlp(a, up, down):
            return (torch.relu(a @ up) @ down).redistribute(mesh, (Replicate(), Replicate()))

        counter, out = count_on_mesh(mlp, [x, w1, w2])
        assert tuple(out.to_local().shape) == (32, 64)
        total, by_kind, counts = H.collective_bytes(counter.collectives)
        assert counts == {"all-reduce": 1}
        assert total == by_kind["all-reduce"] == 2 * 32 * 64 * 4
        assert counter.collectives[0].group_size == 2
        assert counter.flops == 2 * 32 * 64 * 128 * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_argument_and_peak_bytes_off_the_mesh(dtype):
    """A single-device step: the arguments' bytes exactly, the output's, and
    the peak of the temporaries above both (``total_gb`` is the peak)."""
    n = 256
    size = torch.tensor([], dtype=dtype).element_size()

    def step(a, b):
        h = a @ b              # n x n, freed before the return
        return (h @ b).sum(0)  # one row

    meta = lambda: torch.empty((n, n), dtype=dtype, device="meta")  # noqa: E731
    c = D.count_step(step, (meta(), meta()))
    assert c["memory"]["argument_bytes"] == 2 * n * n * size
    assert c["memory"]["output_bytes"] == n * size
    assert c["memory"]["temp_bytes"] == 2 * n * n * size     # h and h @ b live together
    assert c["flops"] == 2 * (2 * n ** 3)
    assert c["bytes"] == (3 * n * n + 3 * n * n + n * n + n) * size


def test_check_hooks_holds_on_this_torch(monkeypatch):
    """The dry run's own check of its DTensor hooks passes on a (2, 2) mesh,
    and fails when the all-to-all hook is undone."""
    from torch.distributed.tensor import placement_types

    original, hooks = placement_types.shard_dim_alltoall, D._dtensor_hooks

    @contextlib.contextmanager
    def without_alltoall(counter):
        with hooks(counter):
            patched = placement_types.shard_dim_alltoall
            placement_types.shard_dim_alltoall = original
            try:
                yield
            finally:
                placement_types.shard_dim_alltoall = patched

    with mesh_2x2() as mesh:
        D.check_hooks(mesh)
        monkeypatch.setattr(D, "_dtensor_hooks", without_alltoall)
        with pytest.raises(RuntimeError, match="hooks do not hold"):
            D.check_hooks(mesh)
