"""Nearest-centroid assignment: the CUDA kernel's wrapper and its plain
version.

    codes[n] = argmin_k (||c_k||^2 - 2 x_n . c_k)       (first index on ties)

The counterpart of ``repro.kernels.kmeans_assign`` (the Pallas kernel
``kmeans_assign_pallas``). ``||x_n||^2`` is constant per row, so it is left
out, as the TPU kernel leaves it out. The kernel is
``csrc/kmeans_assign.cu``. ``launches`` counts its launches in this process.
"""
from __future__ import annotations

import functools
import threading

import torch

from repro_torch.kernels import _build

launches = 0
_count_lock = threading.Lock()

_MAX_SMEM = 232448
_CHUNK_STEP = 64  # the kernel's centroids per pass


def kmeans_assign_plain(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (N, D), centroids (K, D)
    -> (N,) int32. ``torch.argmin`` returns the first index on ties."""
    x = x.float()
    c = centroids.float()
    c2 = (c * c).sum(dim=-1)
    dist = torch.addmm(c2, x, c.t(), beta=1.0, alpha=-2.0)    # c2 - 2 x.c
    return torch.argmin(dist, dim=-1).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _chunk(lib, d: int, k: int) -> int:
    """Centroids held in shared memory at once: all of K (rounded up to the
    kernel's pass width) when they fit, else the largest multiple that
    does."""
    full = -(-k // _CHUNK_STEP) * _CHUNK_STEP
    kc = full
    while kc > 0 and lib.hpc_kmeans_assign_smem_bytes(d, kc) > _MAX_SMEM:
        kc -= _CHUNK_STEP
    if kc == 0:
        raise ValueError(f"kmeans_assign_cuda: D={d} leaves no room for a "
                         f"{_CHUNK_STEP}-centroid chunk in shared memory")
    return kc


def kmeans_assign_cuda(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: x (N, D) and
    centroids (K, D), float32, contiguous, on one CUDA device -> (N,)
    int32. Raises on anything else."""
    global launches
    if x.device.type != "cuda" or centroids.device != x.device:
        raise ValueError(f"kmeans_assign_cuda needs x and centroids on one "
                         f"CUDA device, got {x.device} and {centroids.device}")
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError("x and centroids must be float32")
    if x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(f"expected x (N, D) and centroids (K, D), got "
                         f"{tuple(x.shape)} and {tuple(centroids.shape)}")
    if not (x.is_contiguous() and centroids.is_contiguous()):
        raise ValueError("x and centroids must be contiguous")
    n, d = x.shape
    k = centroids.shape[0]
    if k == 0:
        raise ValueError("kmeans_assign_cuda needs at least one centroid")
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    lib = _build.library()
    kc = _chunk(lib, d, k)
    n_tiles = -(-n // 64)
    grid = min(n_tiles, _sm_count(x.device.index
                                  if x.device.index is not None
                                  else torch.cuda.current_device()))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.hpc_kmeans_assign(x.data_ptr(), centroids.data_ptr(),
                                out.data_ptr(), n, d, k, kc, grid, stream)
    _build.check(err, "kmeans_assign kernel launch")
    with _count_lock:
        launches += 1
    return out
