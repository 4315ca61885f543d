"""Nearest-centroid assignment: the CUDA kernel's wrapper and its plain
version.

    codes[n] = argmin_k (||c_k||^2 - 2 x_n . c_k)       (first index on ties)

The counterpart of ``repro.kernels.kmeans_assign`` (the Pallas kernel
``kmeans_assign_pallas``). ``||x_n||^2`` is constant per row, so it is left
out, as the TPU kernel leaves it out. The kernel is
``csrc/kmeans_assign.cu``: the product runs on the tensor cores in 3xTF32
(a split-precision f32 product, within a few f32 ulps of f32 FMAs), so its
codes agree with the plain version's except at near-ties. ``launches``
counts its launches in this process and ``launch_shapes`` maps each
distinct launch's ``hpc_kmeans_assign_geometry`` arguments to its geometry
(``kernels.vmem``); under a ``FakeTensorMode`` nothing is launched
(``vmem.fake_launch``).
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build, vmem

launches = 0
launch_shapes: dict = {}
_count_lock = threading.Lock()


def launch_cost(n: int, d: int, k: int):
    """(FLOPs, bytes) of one launch: the (N, K) product's 2 N K D; x, the
    codebook and the codes once each."""
    return 2.0 * n * k * d, float(n * d * 4 + k * d * 4 + n * 4)


def kmeans_assign_plain(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (N, D), centroids (K, D)
    -> (N,) int32. ``torch.argmin`` returns the first index on ties."""
    x = x.float()
    c = centroids.float()
    c2 = (c * c).sum(dim=-1)
    dist = torch.addmm(c2, x, c.t(), beta=1.0, alpha=-2.0)    # c2 - 2 x.c
    return torch.argmin(dist, dim=-1).to(torch.int32)


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
    fake = vmem.is_fake(x)
    sms = vmem.sm_count(x.device)
    geom = vmem.kmeans_assign_geometry(n, d, k, sms)
    key = (n, d, k, sms)
    cost = launch_cost(n, d, k)
    if fake:
        return vmem.fake_launch(geom, x.device, {"args": key}, *cost,
                                outputs=(((n,), torch.int32),))
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    if geom is None:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.hpc_kmeans_assign(x.data_ptr(), centroids.data_ptr(),
                                out.data_ptr(), n, d, k, sms, stream)
    _build.check(err, "kmeans_assign kernel launch")
    with _count_lock:
        launches += 1
        launch_shapes.setdefault(key, geom)
    vmem.record_launch(geom, {"args": key}, *cost)
    return out
