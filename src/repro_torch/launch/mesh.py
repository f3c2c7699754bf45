"""Device meshes (the port of ``repro.launch.mesh``) over
``torch.distributed``.

The reference runs one controller over many devices; the port runs SPMD,
one process a rank, each holding its own shards. A mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the process
group with named dimensions ``("data", "model")``, or ``("pod", "data",
"model")`` for two pods. :func:`init_distributed` joins (or makes) the
process group: NCCL on the GPU, gloo on the CPU. The functions build
nothing at import.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def init_distributed(device) -> int:
    """Join the process group this process belongs to and return its rank.
    The group comes from the usual ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT`` environment (``torchrun`` sets it);
    without it, a one-rank group on a free local port. The backend is
    NCCL for a CUDA ``device``, gloo for the CPU. An existing group is
    kept. A CUDA rank takes ``cuda:LOCAL_RANK`` as its current device."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return dist.get_rank()
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{_free_port()}", rank=0, world_size=1)
    return dist.get_rank()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_device_type(device=None) -> str:
    """``cuda`` where the process group is NCCL, else ``cpu``."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The 16 x 16 ``("data", "model")`` pod mesh, or 2 x 16 x 16 with
    ``"pod"`` first (``mesh.py:12-15``). The process group must hold 256
    (512) ranks: a real one, or the dry-run's fake group."""
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh needs a "
                         f"world size of {need}; the process group has "
                         f"{have}")
    return init_device_mesh(mesh_device_type(device), shape,
                            mesh_dim_names=names)


def make_host_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks that exist; ``model_parallel``
    falls back to 1 where it does not divide the world (``mesh.py:
    18-22``)."""
    n = dist.get_world_size()
    mp = model_parallel if n % model_parallel == 0 else 1
    return init_device_mesh(mesh_device_type(device), (n // mp, mp),
                            mesh_dim_names=("data", "model"))


def mesh_axis_names(mesh):
    """The names of a mesh's dimensions: a DeviceMesh's, or a JAX-style
    stand-in's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_sizes(mesh) -> dict:
    """{dimension name: size}."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh_axis_names(mesh), tuple(shape)))


def data_axes(mesh) -> tuple:
    """The dimensions the batch shards over: pod and data
    (``mesh.py:25-27``)."""
    return tuple(a for a in mesh_axis_names(mesh) if a in ("pod", "data"))
