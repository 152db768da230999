"""Mesh construction (reference ``repro.launch.mesh``) over
``torch.distributed``: functions only — importing this module touches no
process group.

A mesh is ``init_device_mesh(device_type, shape, mesh_dim_names=...)`` over
the default process group, one process per mesh position.  The group
comes from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``); without one, a mesh of size 1 starts a world of one in
this process.  NCCL is the backend for ``cuda`` and gloo for ``cpu``; a
caller may name gloo for ``cuda`` (several processes sharing one card,
which NCCL refuses).  A mesh whose size is not the world's raises, with the
``torchrun`` line that gives it one (the reference's ``XLA_FLAGS`` hint).

``backend="fake"`` is the dry run's world (the reference's
``--xla_force_host_platform_device_count``): one process stands for rank
0 of a world of the mesh's size over ``FakeStore``, whose collectives
return at once without moving data, so a step over the mesh can be traced
on fake tensors for one rank.  A fake world of another size is torn down
and started anew; real worlds are never touched.
"""
from __future__ import annotations

import math
import os
from typing import Optional

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _world(size: int, device_type: str, backend: Optional[str]):
    """The default process group, started if it is not: from ``torchrun``'s
    environment, or in process for a mesh of size 1.  Raises if its size is
    not ``size``."""
    import torch.distributed as dist

    backend = backend or BACKENDS[device_type]
    if backend == "fake":
        _fake_world(size)
        return
    hint = (f"a mesh of {size} devices needs a world of {size} processes: "
            f"launch with torchrun --nproc_per_node {size} (one process per "
            "mesh position)")
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if int(os.environ["WORLD_SIZE"]) != size:
                raise ValueError(f"{hint}; this world has "
                                 f"{os.environ['WORLD_SIZE']}")
            dist.init_process_group(backend, init_method="env://")
        elif size == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise ValueError(f"{hint}; no process group is running and "
                             "torchrun's environment is not set")
    if dist.get_world_size() != size:
        raise ValueError(f"{hint}; this world has {dist.get_world_size()}")


def _fake_world(size: int) -> None:
    """Rank 0 of a fake world of ``size`` ranks, started in process (a fake
    world of another size is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError("a fake mesh needs this process's own world; "
                             f"a {dist.get_backend()} world is running")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _make_mesh(shape: tuple, axes: tuple, device_type: str,
               backend: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, "
                         f"got {device_type!r}")
    _world(math.prod(shape), device_type, backend)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda",
                         backend: Optional[str] = None):
    """Single pod: 256 devices as (data=16, model=16).  Multi-pod: 2 pods
    of 256 as (pod=2, data=16, model=16); the 'pod' axis carries pod-level
    DisPFL clients.  ``backend="fake"``: on a fake world (the dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type, backend)


def make_test_mesh(data: int = 2, model: int = 2, pods: int = 0,
                   device_type: str = "cuda", backend: Optional[str] = None):
    """A small (data, model) or (pod, data, model) mesh; the world must
    have ``data * model * max(pods, 1)`` processes."""
    if pods:
        return _make_mesh((pods, data, model), ("pod", "data", "model"),
                          device_type, backend)
    return _make_mesh((data, model), ("data", "model"), device_type, backend)


def client_capacity(mesh) -> int:
    """Max stacked clients the mesh hosts (product of client axes)."""
    from repro_torch.sharding.rules import axis_sizes

    sizes = axis_sizes(mesh)
    return sizes["data"] * sizes.get("pod", 1)
