"""Mesh construction: the reference's ``launch/mesh.py`` on a torch
``DeviceMesh``.

Functions, not module-level constants: importing this module starts no
process group. ``make_host_mesh`` starts a world-1 group itself when none
exists (NCCL on the card, gloo on the CPU, over a ``TCPStore`` on
127.0.0.1), so one process needs no ``torchrun``; ``make_production_mesh``
lays the reference's (16, 16) or (2, 16, 16) mesh over a ``torchrun``
world and raises, as the reference does, when the world is smaller.
"""
from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

# Datasheet figures of the card the port targets, for bounds and rooflines
PEAK_FLOPS_BF16 = 989e12   # NVIDIA H100 80GB HBM3, 700 W: dense bf16 tensor-core FLOP/s
PEAK_FLOPS_FP32 = 67e12    # NVIDIA H100 80GB HBM3, 700 W: fp32 CUDA-core FLOP/s
HBM_BW = 3.35e12           # NVIDIA H100 80GB HBM3, 700 W: HBM3 bytes/s
NVLINK_BW = 450e9          # NVIDIA H100 80GB HBM3, 700 W: NVLink 4 bytes/s each way


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world_one(device_type: str) -> None:
    """A world-1 process group on this process, unless one exists: NCCL
    for ``"cuda"``, gloo for ``"cpu"``."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    store = dist.TCPStore("127.0.0.1", _free_port(), 1, is_master=True)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def make_host_mesh(device: str | torch.device = "cuda") -> DeviceMesh:
    """A 1x1 ("data", "model") mesh on one device (the card unless the
    caller asks for the CPU); starts a world-1 group when none exists."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    start_world_one(dev.type)
    if dist.get_world_size() != 1:
        raise RuntimeError("make_host_mesh is the one-device mesh; the "
                           f"world has {dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def make_mesh(shape, axis_names, device: str | torch.device = "cuda"
              ) -> DeviceMesh:
    """A mesh of ``shape`` over the started world's ranks, row-major; on
    the card each rank takes the device of its rank on its host."""
    kind = resolve_device(device).type
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(kind, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """The reference's production mesh, (16, 16) ("data", "model") or
    (2, 16, 16) ("pod", "data", "model"), over a ``torchrun`` world of at
    least that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world}: launch with "
            f"torchrun --nproc-per-node ... so that the world has {n}")
    return make_mesh(shape, axes, device)
