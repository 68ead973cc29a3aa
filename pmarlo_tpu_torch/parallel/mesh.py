"""Mesh construction helpers and the collectives the port joins blocks with.

Port of ``pmarlo_tpu/parallel/mesh.py``. JAX's mesh is single-controller:
one process sees every device and ``shard_map`` / ``psum`` place the
blocks. PyTorch is multi-controller: one process a rank, started by the
caller (``torchrun``, ``torch.multiprocessing`` with a ``FileStore``), and
a mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group whose dimension name is JAX's axis name
(``"replica"``, ``"shard"``, ``"cells"``). Each rank computes its block;
explicit collectives join the blocks.

Every collective here is an ``all_reduce`` (or a ``broadcast``): NCCL takes
them on a multi-GPU node, and gloo takes them on CUDA tensors where ranks
share one card (NCCL refuses two ranks on one device). An all-gather is an
``all_reduce`` SUM of a zero-filled buffer into which each rank writes its
own block (adding zeros is exact). The backend is whatever the caller
initialised; a collective that fails, fails the call.

Departures from JAX, settled in ROADMAP.md: a mesh is the whole world
(``n_devices`` must equal the world size; JAX takes the first n devices),
and ``shard_replicas`` returns this rank's block as a plain tensor (JAX
returns a global sharded array).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .._device import default_device


def _world(n_devices: Optional[int]) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "no process group is initialised: start the ranks first "
            "(torchrun, or torch.distributed.init_process_group with a store)")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"requested {n_devices} devices, the process group has {world} ranks: "
            "a mesh spans the whole world")
    return world


def replica_mesh(n_devices: Optional[int] = None, axis: str = "replica", *,
                 device_type: Optional[str] = None):
    """1-D mesh over the replica axis (REMD sharding): every rank of the
    default process group, rank r on ``cuda:{r % device_count}`` (or the
    CPU with ``device_type="cpu"``; ``None``: ``default_device()``)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = _world(n_devices)
    device_type = device_type or default_device().type
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device_type, torch.arange(world), mesh_dim_names=(axis,))


def data_mesh(n_devices: Optional[int] = None, axis: str = "shard", *,
              device_type: Optional[str] = None):
    """1-D mesh over the shard/data axis (estimation sharding)."""
    return replica_mesh(n_devices, axis=axis, device_type=device_type)


def check_mesh(mesh, axis: Optional[str] = None) -> str:
    """The axis name of a 1-D ``DeviceMesh``; raises on anything else, or
    when ``axis`` is not its dimension's name."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got {type(mesh)!r}")
    if mesh.ndim != 1:
        raise ValueError(f"the port's meshes are 1-D, got {mesh.ndim} dimensions")
    name = (mesh.mesh_dim_names or (None,))[0]
    if axis is not None and name != axis:
        raise ValueError(f"mesh axis is {name!r}, not {axis!r}")
    return name


def rank_device(mesh) -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return torch.device(mesh.device_type)


def mesh_block(n: int, mesh, what: str = "the leading axis") -> Tuple[int, int]:
    """``(lo, hi)``: this rank's rows ``[r n / size, (r + 1) n / size)`` of
    ``n``; raises ``ValueError`` when ``size`` does not divide ``n``."""
    size = mesh.size()
    if n % size != 0:
        raise ValueError(f"{what} ({n}) does not divide over the {size}-rank mesh")
    per = n // size
    r = mesh.get_local_rank()
    return r * per, (r + 1) * per


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the mesh's ranks, in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return t


def broadcast_first(t: torch.Tensor, mesh) -> torch.Tensor:
    """The first rank's ``t`` on every rank, in place."""
    dist.broadcast(t, src=int(mesh.mesh.flatten()[0]), group=mesh.get_group())
    return t


#: dtypes every backend sums; others go through int32 or float32
_SUMMABLE = (torch.float32, torch.float64, torch.int32, torch.int64)


def gather_blocks(local: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The ranks' equal blocks concatenated along ``dim`` in rank order, on
    every rank: an ``all_reduce`` SUM of a zero buffer holding this rank's
    block at its offset."""
    dtype = local.dtype
    work = local if dtype in _SUMMABLE else local.to(
        torch.float32 if local.is_floating_point() else torch.int32)
    dim = dim % local.dim()
    shape = list(local.shape)
    per = shape[dim]
    shape[dim] = per * mesh.size()
    buf = torch.zeros(shape, dtype=work.dtype, device=local.device)
    r = mesh.get_local_rank()
    buf.narrow(dim, r * per, per).copy_(work)
    return all_reduce_sum(buf, mesh).to(dtype)


def shard_replicas(tensor, mesh, axis: str = "replica") -> torch.Tensor:
    """This rank's block of ``tensor``'s leading axis, on this rank's
    device (JAX: the global array placed with that axis split)."""
    check_mesh(mesh, axis)
    t = torch.as_tensor(tensor)
    lo, hi = mesh_block(int(t.shape[0]), mesh)
    return t[lo:hi].to(rank_device(mesh))


__all__ = ["replica_mesh", "data_mesh", "shard_replicas"]
