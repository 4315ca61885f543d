"""Device meshes over ``torch.distributed`` process groups.

The counterpart of ``repro.launch.mesh``. The reference builds a JAX mesh
over the devices of one controller; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
current process group, one rank per device:

  * ``make_host_mesh(shape, axes, device)`` — a small mesh (tests, one
    card): NCCL ranks for ``device="cuda"``, gloo ranks for ``"cpu"``;
  * ``make_production_mesh(multi_pod)`` — the reference's production
    shapes and axis names: (16, 16) over ("data", "model"), and
    (2, 16, 16) over ("pod", "data", "model"), where "pod" is a pure
    data-parallel axis across pods.

The caller opens the process group (``torch.distributed.init_process_group``
with its own address, world size and rank); ``open_local_group`` opens a
one-rank group through an in-memory store, without a port, for one card
or one CPU process. ``open_fake_group`` opens a group of any size in
which this process is one rank and every collective returns at once
without sending or writing anything: the dry run traces rank 0 of a
production mesh on it.

The hardware figures are the NVIDIA H100 SXM data sheet's (NVIDIA H100
80GB HBM3, 700 W), the figures ``PERF.md`` bounds the kernels with.
``HBM_BYTES`` is read from the card when one is present. A production
mesh of H100s is HGX/DGX H100 nodes of ``GPUS_PER_NODE`` cards: NVLink
within a node, one InfiniBand port per card between nodes (the NVIDIA
DGX H100 data sheet), with ranks numbered node by node.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

# NVIDIA H100 80GB HBM3, 700 W (H100 SXM data sheet): dense BF16 on the
# tensor cores and HBM3 bandwidth, per card
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
# the data sheet's memory; ``HBM_BYTES`` is the present card's own
HBM_BYTES_DATASHEET = 80 * 2 ** 30
# NVLink 4 (H100 SXM data sheet): 900 GB/s per GPU bidirectional, 450 GB/s
# each way; a ring collective's time is its bytes over the per-direction
# figure (the dry run's collective term)
NVLINK_BW_BIDIRECTIONAL = 900e9
NVLINK_BW_PER_DIRECTION = 450e9
# NVIDIA DGX H100 data sheet: 8 H100 SXM GPUs a node on NVLink, and per
# GPU one 400 Gb/s NDR ConnectX-7 InfiniBand port between nodes, 50 GB/s
# each way
GPUS_PER_NODE = 8
IB_BW_PER_DIRECTION = 50e9

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def __getattr__(name: str):
    if name == "HBM_BYTES":
        if torch.cuda.is_available():
            return torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory
        return HBM_BYTES_DATASHEET
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def open_local_group(device="cuda") -> str:
    """Open a one-rank default process group on an in-memory store (no
    port, no environment variables): NCCL for ``device="cuda"``, gloo for
    ``"cpu"``. A group that is already open is kept if it has one rank
    and that backend. Returns the backend."""
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if dist.is_initialized():
        if dist.get_world_size() != 1 or dist.get_backend() != backend:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks on "
                f"{dist.get_backend()} is already open; open_local_group "
                f"wants one rank on {backend}")
        return backend
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return backend


def open_fake_group(world_size: int, rank: int = 0) -> str:
    """Open a default process group of ``world_size`` ranks in which this
    process is ``rank`` and the others are never started: the "fake"
    backend of ``torch.testing._internal.distributed.fake_pg`` on a
    ``FakeStore``. Its collectives return at once, send nothing and
    leave their outputs unwritten, so a rank's program runs (on fake or
    real tensors) with every shape it would have on the full mesh. A
    group that is already open is kept if it is a fake one of that size;
    any other raises. Returns the backend."""
    from torch.testing._internal.distributed import fake_pg
    if dist.is_initialized():
        if (dist.get_world_size() != world_size
                or dist.get_backend() != "fake"
                or dist.get_rank() != rank):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks on "
                f"{dist.get_backend()} is already open; open_fake_group "
                f"wants rank {rank} of {world_size} on fake")
        return "fake"
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=rank,
                            world_size=world_size)
    return "fake"


def _mesh(device, shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    dev = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group is open: call "
            "torch.distributed.init_process_group (or "
            "repro_torch.launch.mesh.open_local_group for one rank) first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    backend = dist.get_backend()
    if backend not in (BACKENDS[dev.type], "fake"):
        raise ValueError(f"a {dev.type} mesh needs a {BACKENDS[dev.type]} "
                         f"process group; this one is {backend}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_host_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes: Tuple[str, ...] = ("data", "model"),
                   device="cuda") -> DeviceMesh:
    """A mesh of ``shape`` over the current process group's ranks (one
    rank per device; world size = prod(shape))."""
    return _mesh(device, shape, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The reference's production mesh: (16, 16) ("data", "model") on 256
    ranks, or (2, 16, 16) ("pod", "data", "model") on 512 (a real group
    of that size, or ``open_fake_group``'s)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)
