"""Mesh construction over ``torch.distributed``.

The PyTorch counterpart of ``repro.launch.mesh``: ``make_mesh`` builds a
``DeviceMesh`` over the default process group, which the caller has
initialised (``torch.distributed.init_process_group`` with its own address,
world size and rank: nothing on the card's machine announces a cluster).
It is a function, so importing this module touches no device and no group.

The backend is the caller's: NCCL for one rank per card; gloo where ranks
share a card (gloo stages CUDA tensors through host memory).  A ``"cuda"``
mesh over a gloo default group keeps gloo for its axis groups.

Meshes of the reference's production layouts:

* single pod : (16, 16)            axes ("data", "model")
* multi-pod  : (2, 16, 16)         axes ("pod", "data", "model")
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.analyze import H100_SXM

__all__ = ["make_production_mesh", "make_mesh", "HW"]


class HW:
    """Figures of the port's card, an NVIDIA H100 SXM at 700 W
    (``core.analyze.H100_SXM`` and NVIDIA's data sheet), under the
    reference's names; the reference holds a TPU v5e's here."""
    PEAK_FLOPS = 989e12                         # bf16 FLOP/s, dense
    HBM_BW = H100_SXM.mem_bandwidth_gbs * 1e9   # bytes/s
    ICI_BW = 450e9               # NVLink bytes/s per card, each way
    HBM_BYTES = 80 * 10 ** 9
    VMEM_BYTES = 232_448         # shared memory one block can use


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes, *, device_type=None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the first
    ``prod(shape)`` ranks of the default process group, in rank order
    (so ranks rise along every axis).  Every rank of the group calls it.
    ``device_type`` defaults to ``"cuda"`` when a card is present."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs an initialised default process group "
            f"(torch.distributed.init_process_group with its address, "
            f"world size and rank) of at least {n} ranks")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but the default process group "
            f"has only {world}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)
