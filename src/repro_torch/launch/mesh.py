"""Mesh construction on `torch.distributed.device_mesh`, the counterpart
of `repro.launch.mesh`, with the same shapes and axis names.  Functions
only: importing this module touches no device and no process group.

A mesh needs a process group.  `make_host_mesh` and `make_node_mesh(1)`
start a one-rank group when none exists; a larger mesh needs the world
its caller started (`torch.distributed.init_process_group` with an
address, its world size and its rank), and raises when the world's size
differs from the mesh's.  The dry run (`launch.dryrun`) starts its own
world of 256 or 512 ranks in one process on torch's fake backend
(`start_fake_world`), whose collectives return at once and move nothing:
over meta tensors that is all a step's shapes, layouts and counts need.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

DEFAULT_DEVICE = "cuda"


def _ensure_group(device_type: str, size: int) -> None:
    import torch.distributed as dist
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a mesh of {size} ranks needs a process group: start one "
                f"with torch.distributed.init_process_group")
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != size:
        raise RuntimeError(f"a mesh of {size} ranks in a world of "
                           f"{dist.get_world_size()}")


def start_fake_world(size: int) -> None:
    """A world of `size` ranks in this one process, this process rank 0,
    on the fake backend (`torch.testing._internal.distributed.fake_pg`):
    no second process, no device, no network.  A fake world of another
    size is replaced; a real one raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running; the dry "
                               "run needs a process of its own")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device: str = DEFAULT_DEVICE,
              ranks: Optional[Sequence[int]] = None):
    """A DeviceMesh of `shape`, axes `names`, over every rank of the
    world, or over `ranks` (the world's ranks it spans, row-major: a
    shrunk fleet, see `training.train_loop.remesh_state`; every rank of
    the world calls it, and a rank outside it holds no block); device
    "cuda" (the card, one rank a card or several ranks on one) unless
    the caller asks for "cpu"."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    device_type = device.split(":")[0]
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a card; pass "
                           "device='cpu' for a CPU mesh")
    if ranks is None:
        _ensure_group(device_type, math.prod(shape))
        return init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(names))
    if len(ranks) != math.prod(shape):
        raise ValueError(f"{len(ranks)} ranks for a mesh of {tuple(shape)}")
    return DeviceMesh(device_type,
                      torch.tensor(list(ranks)).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = DEFAULT_DEVICE):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks for the multi-pod
    run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_node_mesh(n_chips: int, device: str = DEFAULT_DEVICE):
    """Per-backend-node mesh (TP within one heterogeneous serving node)."""
    return make_mesh((n_chips,), ("model",), device)


def make_host_mesh(device: str = DEFAULT_DEVICE):
    """Single-rank mesh for smoke tests / tiny serving replicas."""
    return make_mesh((1,), ("model",), device)
