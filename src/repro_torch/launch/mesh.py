"""Production meshes (the reference's ``repro/launch/mesh.py``).

Single pod: 16 x 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model").

Defined as functions, so importing this module touches no device and
no process group.  Each builds a ``DeviceMesh`` with
``init_device_mesh`` over the default process group, which the caller
starts (``torch.distributed.init_process_group`` with its own store,
rank and world size: nothing tells a program of a cluster), on the card
unless the caller passes ``device_type="cpu"``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.sharding import Mesh


def _device_mesh(device_type: str, shape, axes) -> Mesh:
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' to build the mesh on the host")
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(device_type, shape, axes)


def make_host_mesh(*, data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> Mesh:
    """A small mesh over however many ranks the process group has, the
    sizes clamped to the world size as the reference clamps them to its
    device count."""
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return _device_mesh(device_type, (data, model), ("data", "model"))
