"""Mesh construction over the ranks of the process group.

Functions, never module-level constants: importing this module touches no
process group and no device. Call ``torch.distributed.init_process_group``
first; the mesh's device type follows the group's backend (``cuda`` under
NCCL, ``cpu`` under gloo or a fake group), so a group that asked for NCCL
never gets a CPU mesh.
"""

from __future__ import annotations

import torch.distributed as dist


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group first")
    backend = str(dist.get_backend())
    if "nccl" in backend:
        return "cuda"
    if "gloo" in backend or backend == "fake":
        return "cpu"
    raise ValueError(f"no mesh device type for process-group backend {backend!r}")


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single pod (256 ranks) or 2x16x16 (2 pods, 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(_device_type(), shape, axes)


def make_host_mesh(model_parallel: int = 1):
    """("data", "model") mesh over every rank of the process group."""
    device_type = _device_type()
    n = dist.get_world_size()
    assert n % model_parallel == 0, (n, model_parallel)
    return _mesh(device_type, (n // model_parallel, model_parallel), ("data", "model"))
