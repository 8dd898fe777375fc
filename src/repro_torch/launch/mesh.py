"""Device meshes: the production meshes and the one-rank test mesh, as
`torch.distributed` DeviceMeshes with the reference's axis names.

One satellite pod is a 16 x 16 mesh (256 chips: "data" x "model");
multi-pod adds the leading "pod" axis, whose hop is the FSO
inter-satellite link.

The process group is set up explicitly, never by accident:
  - "nccl" for a mesh on the card (and never a CPU group in its place:
    asking for a card mesh without a card raises);
  - "gloo" for a mesh on the CPU;
  - "fake" for the dry run: rank 0 of a production mesh runs its own
    program while collectives are recorded but not moved.
A one-rank group uses an in-process store (`dist.HashStore()`); several
ranks take their rank, world size and address from the environment
`torchrun` sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).  A mesh
whose size is not the world size raises, naming both.

Functions only: importing this module touches no process group.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

PRODUCTION_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def backend_for(device_type: str) -> str:
    if device_type == "cuda":
        return "nccl"
    if device_type == "cpu":
        return "gloo"
    raise ValueError(f"no mesh backend for device type {device_type!r}")


def init_process_group(device_type: str = "cuda", *, fake: bool = False,
                       world_size: int | None = None, rank: int | None = None,
                       init_method: str | None = None):
    """Set up this process's default group, once.  `fake` makes the dry
    run's fake group of `world_size` ranks (this process is `rank`, by
    default 0).  Otherwise the backend follows the device type; the rank
    and world size come from the arguments, else from torchrun's
    environment, else one rank on an in-process store.  An existing group
    of another backend raises."""
    backend = "fake" if fake else backend_for(device_type)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"a {have!r} process group is already set "
                               f"up; this mesh needs {backend!r}")
        return
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on the card needs CUDA, and none is "
                           "available (no CPU group stands in for it)")
    env = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if env and not fake \
            else 1
    if rank is None:
        rank = int(os.environ["RANK"]) if env and not fake else 0
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    if fake:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size)
    elif init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size)
    elif world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world_size)


def make_mesh(shape, axes=None, device_type: str = "cuda"):
    """A DeviceMesh of `shape` over the current group's ranks, named
    `axes` (by rank: ("data", "model") or ("pod", "data", "model"))."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(shape)
    axes = tuple(axes or AXES[len(shape)])
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"rank")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} has {math.prod(shape)} ranks but "
                         f"the process group has {world}")
    if dist.get_backend() == "nccl" and device_type != "cuda":
        raise ValueError("an nccl group makes meshes on the card")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, shape=None,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod" in front;
    `shape` overrides the split (same axes).  Needs a group of the
    mesh's size: torchrun's ranks, or the dry run's fake group."""
    if shape is None:
        shape = PRODUCTION_SHAPES["multi" if multi_pod else "single"]
    return make_mesh(shape, AXES[3] if multi_pod else AXES[2], device_type)


def make_test_mesh(n_devices: int | None = None, device_type: str = "cuda"):
    """(1, n, 1) ("pod", "data", "model") over the group's ranks (one rank
    unless torchrun started more)."""
    n = n_devices or dist.get_world_size()
    return make_mesh((1, n, 1), AXES[3], device_type)


def mesh_for(kind: str, device_type: str = "cuda"):
    """The launcher's --mesh {none,test,single,multi}: sets up the
    process group for `device_type` and returns the mesh (None for
    "none").  "single" and "multi" need torchrun's 256 / 512 ranks; with
    fewer they raise, naming both sizes."""
    if kind == "none":
        return None
    if kind not in ("test", "single", "multi"):
        raise ValueError(f"unknown mesh kind {kind!r}")
    init_process_group(device_type)
    if kind == "test":
        return make_test_mesh(device_type=device_type)
    return make_production_mesh(multi_pod=kind == "multi",
                                device_type=device_type)


def destroy():
    """Tear down this process's group (tests and one-shot launchers)."""
    if dist.is_initialized():
        dist.destroy_process_group()
