"""Device mesh, rendezvous and data-rank helpers (mirrors
``ufvideo_tpu/parallel/mesh.py``).

One process drives one card. The mesh keeps the JAX package's axis names:

  - ``data``:   data parallelism (the batch is split; parameters replicated)
  - ``fsdp``:   ZeRO-style sharding of parameters, gradients and moments
                (the batch is split over this axis too)
  - ``tensor``: tensor parallelism inside attention and the MLP
  - ``pipe``:   pipeline stages, present only when ``pp > 1``

``create_mesh`` lays the ranks out as JAX lays out devices: process-major,
``data`` outermost, so rank ``r`` of a (data, fsdp, tensor) mesh sits at
``(r // (F·T), r // T % F, r % T)``. The backend is NCCL for the card and
gloo only when the caller asks for the CPU; a world larger than the cards
this host can see raises under NCCL, naming both numbers, and never falls
back to gloo.
"""

from __future__ import annotations

import math
import os
import socket
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
PIPE_AXIS = "pipe"
AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
AXIS_NAMES_PP = (DATA_AXIS, PIPE_AXIS, FSDP_AXIS, TENSOR_AXIS)


class P(tuple):
    """A partition spec (the JAX ``PartitionSpec``'s role): one entry a
    dimension, each None, an axis name or a tuple of axis names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# the batch dimension is split over both data-parallel axes
BATCH_SPEC = P((DATA_AXIS, FSDP_AXIS))


def backend_for(device: str) -> str:
    """NCCL for the card, gloo for the CPU."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def check_world_fits(local_world: int, device: str) -> None:
    """One process a card: a node cannot hold more NCCL ranks than it has
    visible cards."""
    if torch.device(device).type == "cpu":
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_world > cards:
        raise RuntimeError(
            f"a world of {local_world} rank(s) on this host needs {local_world} cards, "
            f"but {cards} visible card(s) were found; NCCL puts one rank on each card "
            "(ask for the CPU and gloo with device='cpu')")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env_world() -> Optional[Tuple[int, int, int, str]]:
    """(world, rank, local world, init method) from the environment, or None.
    The JAX package's variables come first, then torchrun's."""
    env = os.environ
    if env.get("UFVIDEO_NUM_PROCESSES"):
        world = int(env["UFVIDEO_NUM_PROCESSES"])
        rank = int(env["UFVIDEO_PROCESS_ID"])
        local = int(env.get("LOCAL_WORLD_SIZE", world))
        return world, rank, local, f"tcp://{env['UFVIDEO_COORDINATOR']}"
    if (env.get("WORLD_SIZE") and env.get("MASTER_ADDR")) or env.get("UFVIDEO_DIST_AUTO") == "1":
        # torchrun's (or a cluster launcher's) RANK / WORLD_SIZE /
        # MASTER_ADDR / MASTER_PORT; RANK / WORLD_SIZE alone name a rank
        # with no rendezvous (eval's chunking reads them itself)
        world = int(env.get("WORLD_SIZE", "1"))
        rank = int(env.get("RANK", "0"))
        local = int(env.get("LOCAL_WORLD_SIZE", world))
        return world, rank, local, "env://"
    return None


def local_rank() -> int:
    """This process's card on its host (torchrun's LOCAL_RANK; else the
    rank modulo the visible cards)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank % max(torch.cuda.device_count(), 1)


def _init(backend: str, init_method: str, world: int, rank: int) -> None:
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def maybe_initialize_distributed(device: str = "cuda", backend: Optional[str] = None) -> bool:
    """The rendezvous of a multi-process run, from the environment:

      UFVIDEO_NUM_PROCESSES=W UFVIDEO_PROCESS_ID=i UFVIDEO_COORDINATOR=host:port
                                     → the JAX package's variables
      RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT (torchrun)
      UFVIDEO_DIST_AUTO=1            → the launcher's env:// variables
      (none set)                     → nothing, one process

    ``backend`` defaults to NCCL for the card and gloo for ``device='cpu'``
    (eval passes gloo: it needs rank identity only). Returns True when this
    process is one of several; safe to call more than once."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    found = _env_world()
    if found is None:
        return False
    world, rank, local, init_method = found
    backend = backend or backend_for(device)
    if backend == "nccl":
        check_world_fits(local, "cuda")
    _init(backend, init_method, world, rank)
    return world > 1


def ensure_process_group(device: str = "cuda") -> None:
    """A one-process group on a free localhost port when none exists, so a
    one-card run takes the same sharded path as a run over many."""
    if dist.is_initialized():
        return
    backend = backend_for(device)
    if backend == "nccl":
        check_world_fits(1, "cuda")
    _init(backend, f"tcp://127.0.0.1:{_free_port()}", 1, 0)


def _resolve(sizes: Sequence[int], n: int) -> list:
    """Sizes with the -1 axis (if any) taking the ranks the others leave;
    it takes at least 1, so a mesh too large for the world shows as such."""
    sizes = list(sizes)
    n_fixed = int(math.prod(s for s in sizes if s != -1))
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        sizes[sizes.index(-1)] = max(n // n_fixed, 1)
    return sizes


def mesh_layout(dp: int = 1, fsdp: int = -1, tp: int = 1, *, pp: int = 1,
                world: Optional[int] = None, device: str = "cuda"):
    """(axis names, sizes) of the mesh over ``world`` ranks (default: the
    process group's, or the rendezvous the environment names, or 1). A
    layout that does not cover the world raises, naming both: a launcher
    checks this before it joins the rendezvous."""
    if world is None:
        found = _env_world()
        world = (dist.get_world_size() if dist.is_initialized()
                 else found[0] if found else 1)
    names = AXIS_NAMES_PP if pp != 1 else AXIS_NAMES
    sizes = _resolve([dp, pp, fsdp, tp] if pp != 1 else [dp, fsdp, tp], world)
    if int(math.prod(sizes)) != world:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        layout = ", ".join(f"{a} {s}" for a, s in zip(names, sizes))
        where = ("the CPU" if torch.device(device).type == "cpu"
                 else f"{cards} visible card(s)")
        raise ValueError(f"mesh ({layout}) needs {int(math.prod(sizes))} ranks; this run "
                         f"has a world of {world} over {where}")
    return names, tuple(sizes)


def create_mesh(dp: int = 1, fsdp: int = -1, tp: int = 1, *, pp: int = 1,
                device: str = "cuda"):
    """A (data, fsdp, tensor) ``DeviceMesh`` over every rank of the world, or
    (data, pipe, fsdp, tensor) when ``pp > 1``; an axis of -1 takes the rest.
    Starts a one-process group when none exists."""
    from torch.distributed.device_mesh import init_device_mesh

    names, sizes = mesh_layout(dp, fsdp, tp, pp=pp, device=device,
                               world=dist.get_world_size() if dist.is_initialized() else 1)
    ensure_process_group(device)
    return init_device_mesh(torch.device(device).type, sizes, mesh_dim_names=names)


def single_device_mesh(device: str = "cuda"):
    return create_mesh(1, 1, 1, device=device)


class MeshShape:
    """Axis sizes without ranks (``mesh.shape`` of a JAX mesh): the
    partition arithmetic of ``partition.py`` at any layout, on any host."""

    def __init__(self, dp: int = 1, fsdp: int = 1, tp: int = 1, pp: int = 1):
        names = AXIS_NAMES_PP if pp != 1 else AXIS_NAMES
        sizes = (dp, pp, fsdp, tp) if pp != 1 else (dp, fsdp, tp)
        self.shape: Dict[str, int] = dict(zip(names, sizes))

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh`` or a ``MeshShape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_coordinate(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(index, size) of this rank over ``axes`` flattened in mesh order:
    the data rank over ("data", "fsdp") is the row block this rank feeds."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index, size = 0, 1
    for a in axes:
        index = index * sizes[a] + coord[a]
        size *= sizes[a]
    return index, size


def spec_axes(spec: Optional[P]) -> Tuple[str, ...]:
    """The mesh axes that split dimension 0 of a batch spec."""
    axes = spec[0] if spec else ()
    return (axes,) if isinstance(axes, str) else tuple(axes or ())


def local_batch_size(global_batch: int, mesh) -> int:
    sizes = axis_sizes(mesh)
    dp = sizes[DATA_AXIS] * sizes[FSDP_AXIS]
    assert global_batch % dp == 0, (global_batch, dp)
    return global_batch // dp
