"""Production meshes (single-pod 16x16, multi-pod 2x16x16) as
``torch.distributed`` device meshes.

Defined as functions, never module-level meshes, so importing this module
touches no process group.  Every mesh is built over the process group that
exists.  The production meshes need 256 or 512 ranks: the dry run builds
them in one process under :func:`fake_world`, a fake process group of that
size whose collectives return at once, as the JAX dry run forces 512 host
devices before its first JAX call.

Axes: ``data`` carries DP (and FSDP parameter storage), ``model`` carries
TP/EP, ``pod`` is an outer pure-DP axis (gradient reduction crosses pods;
parameters are stored FSDP within a pod), ``host`` is the simulated
multi-host lane's outer DP axis.
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist


def _production(multi_pod: bool) -> tuple[tuple[int, ...], tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def production_world(multi_pod: bool = False) -> int:
    """Ranks of the production mesh: 256, or 512 with ``multi_pod``."""
    return math.prod(_production(multi_pod)[0])


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks in this process (rank 0):
    meshes of any size build over it, and the local program runs without
    peers.  Destroyed on exit.  Refuses when a process group exists: the
    group is process-global."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already; the fake world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one (or enter fake_world) first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 ``("data", "model")`` (256 ranks) or 2x16x16 ``("pod", "data",
    "model")`` (512 ranks)."""
    return _mesh(*_production(multi_pod))


def make_host_mesh(model_parallel: int = 1):
    """``(world / model_parallel, model_parallel)`` over the process group."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"world {n} not divisible by model_parallel={model_parallel}")
    return _mesh((n // model_parallel, model_parallel), ("data", "model"))


def make_sim_multihost_mesh(num_hosts: int, model_parallel: int = 1):
    """A mesh with an explicit outer ``host`` DP axis: each host owns a
    contiguous block of ranks, matching the contiguous rank-block partition
    ``ShardedWindow`` uses."""
    n = dist.get_world_size()
    if num_hosts < 1 or n % (num_hosts * model_parallel) != 0:
        raise ValueError(
            f"device count {n} not divisible by hosts={num_hosts} x model_parallel={model_parallel}"
        )
    return _mesh((num_hosts, n // (num_hosts * model_parallel), model_parallel),
                 ("host", "data", "model"))


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "host", "data") if a in mesh.mesh_dim_names)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in dp_axes(mesh))


def tp_size(mesh) -> int:
    return mesh_shape(mesh).get("model", 1)


def dp_index(mesh) -> int:
    """This rank's position over the DP axes, outer axis first."""
    shape, coord = mesh_shape(mesh), dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = 0
    for a in dp_axes(mesh):
        index = index * shape[a] + coord[a]
    return index
