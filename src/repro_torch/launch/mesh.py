"""Meshes: the port of ``repro.launch.mesh``, on ``torch.distributed``.

Axes, as in the reference:
  pod   : outer pure-DP axis; only the gradient all-reduce crosses it
  data  : DP + FSDP (ZeRO-3 parameter and optimizer-state sharding)
  model : TP (heads / ffn), EP (experts), SP (long sequences)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those dim
names over an initialized process group.  ``make_production_mesh`` needs
a world of exactly 256 (16 x 16) or 512 (2 x 16 x 16) ranks and raises
under any other; it never builds a smaller mesh in its place.
``make_host_mesh`` builds ``(1, world)``, and where no process group
exists it makes a world-size-1 group itself (NCCL on ``cuda``, gloo on
``cpu``) on an in-process store, reading no environment variable.
``fake_world(n)`` makes a world of n ranks on torch's fake backend (no
communication; collectives return at once), the dry run's stand-in for a
real cluster.  A process group belongs to the whole process, so
``destroy_group`` destroys the group this module made (and only that
one): tests and ``chip_smoke.py`` call it, so no group outlives its user.

Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import device as device_mod

# the process group this module made, or None
_owned = None


def _world() -> Optional[int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def _device_type(device) -> str:
    return device_mod.resolve(device).type


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production mesh's shape and dim names."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(multi_pod: bool = False, device=None) -> DeviceMesh:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model"),
    over an initialized process group of exactly that many ranks."""
    shape, axes = production_shape(multi_pod)
    need = math.prod(shape)
    world = _world()
    if world != need:
        found = "no process group" if world is None \
            else f"a world of {world} rank(s)"
        raise RuntimeError(
            f"the production mesh {'x'.join(map(str, shape))} needs a world "
            f"of {need} ranks; found {found} (launch it under "
            f"{need} ranks, e.g. torchrun --nnodes ... --nproc-per-node ...)")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """(1, world) over ("data", "model"): the whole world on the model
    axis.  Without a process group, a world-size-1 group is made first
    (``destroy_group`` takes it down)."""
    global _owned
    dev_type = _device_type(device)
    if _world() is None:
        backend = "nccl" if dev_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        _owned = dist.group.WORLD
    return init_device_mesh(dev_type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0) -> Iterator[None]:
    """For the length of the block, a world of ``world_size`` ranks on
    torch's fake backend, as rank ``rank``: collectives return at once and
    move nothing, so a mesh of any size can be built and a step traced on
    one host."""
    global _owned
    if _world() is not None:
        raise RuntimeError("a process group already exists; destroy it "
                           "before making a fake world")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    _owned = dist.group.WORLD
    try:
        yield
    finally:
        destroy_group()


def destroy_group() -> None:
    """Destroys the process group this module made; a no-op where it made
    none (or it is already gone)."""
    global _owned
    if _owned is not None and dist.is_initialized() \
            and dist.group.WORLD is _owned:
        dist.destroy_process_group()
    _owned = None


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_degree(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)
