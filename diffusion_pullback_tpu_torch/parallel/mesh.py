"""The device mesh: a named torch.distributed DeviceMesh over the ranks of
a run.

Counterpart of diffusion_pullback_tpu/parallel/mesh.py. Where the JAX
package builds a `jax.sharding.Mesh` over the devices of one process and
lets GSPMD insert the collectives, a torch run is one process per device
(torchrun), and the mesh names the subgroups that the port's explicit
collectives (collectives.py) run over: 'dp' (sweeps, the training batch),
'probe' (the pullback's probes), 'sp' (ring attention), 'tp' (Megatron
weights), 'fsdp' (training's parameter shards). The backend follows the
device: NCCL on CUDA, gloo on the CPU; a failed NCCL init raises and never
falls back to gloo.

One departure: the JAX ``make_mesh`` takes a device prefix when an explicit
shape covers fewer devices than the host has; a torch run starts exactly
the ranks of its mesh, so here such a shape raises.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist


def mesh_shape_for(n_devices: int, axes: Sequence[str]) -> Dict[str, int]:
    """Factor ``n_devices`` across ``axes``, biggest factor to the first axis.

    E.g. 8 devices over ('dp', 'probe') → {'dp': 4, 'probe': 2}; a single
    device maps every axis to 1.
    """
    shape = {a: 1 for a in axes}
    remaining = n_devices
    for i, a in enumerate(axes):
        if i == len(axes) - 1:
            shape[a] = remaining
            break
        # peel off the largest power-of-two factor that leaves room
        f = 1
        while remaining % 2 == 0 and remaining // 2 >= 1 and f < int(
            math.isqrt(n_devices)
        ) + 1:
            f *= 2
            remaining //= 2
        shape[a] = f
    assert math.prod(shape.values()) == n_devices, shape
    return shape


def world_size() -> int:
    """Ranks of this run: the process group's, else torchrun's WORLD_SIZE
    (1 for a plain process)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device) -> None:
    """Join the process group of a torchrun launch (env://) with the
    device's backend, the rank's card current on CUDA. An existing group
    must have that backend."""
    want = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != want:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                               f"a {torch.device(device).type} mesh needs {want}")
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(want)


def make_mesh(axes: Sequence[str] = ("dp",), shape: Optional[Dict[str, int]] = None,
              device="cuda"):
    """A DeviceMesh named ``axes`` over every rank of the run, on
    ``device``'s type. With no ``shape`` the ranks are factored over
    ``axes`` by `mesh_shape_for`; a shape must cover the world exactly."""
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    init_distributed(device)
    world = dist.get_world_size()
    if shape is None:
        shape = mesh_shape_for(world, axes)
    dims = tuple(int(shape[a]) for a in axes)
    if math.prod(dims) != world:
        raise ValueError(
            f"mesh shape {dict(zip(axes, dims))} does not cover {world} ranks: a "
            f"torch run starts the ranks of its mesh (torchrun --nproc_per_node "
            f"{math.prod(dims)})")
    return init_device_mesh(device.type, dims, mesh_dim_names=tuple(axes))


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()


def axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh``; 1 when the mesh is None or lacks it."""
    names = axis_names(mesh)
    return mesh.size(names.index(axis)) if axis in names else 1


def mesh_shape(mesh) -> Dict[str, int]:
    return {a: axis_size(mesh, a) for a in axis_names(mesh)}


def axis_group(mesh, axis: str):
    """The process group of this rank along ``axis``."""
    return mesh.get_group(axis)


# ---- the run's writer --------------------------------------------------------

def is_writer() -> bool:
    """True on the rank that writes a run's files (rank 0; every process
    of a run without a process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def agreed(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (a decision that must take every
    rank down the same branch, such as a cache hit that rank 0 sees first);
    ``flag`` itself without a process group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return bool(flag)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(bool(flag))], device=dev)
    dist.broadcast(t, src=0)
    return bool(t.item())
