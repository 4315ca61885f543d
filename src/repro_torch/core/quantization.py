"""K-Means quantization of patch embeddings (HPC-ColPali §III-B), in PyTorch.

The counterpart of ``repro.core.quantization`` (codebook training v2):
k-means++ seeding, Lloyd steps with empty-cluster repair, best-iterate
tracking, best-of-``n_restarts`` fitting and a mini-batch Lloyd mode.
Random draws come from a ``torch.Generator`` on the data's device, passed
where the reference passes PRNG keys; torch cannot replay ``jax.random``,
so the two fits agree in quality (inertia), not bit for bit.

The Lloyd and mini-batch E-steps are plain torch (``pairwise_sq_dists`` +
``argmin``), as the reference keeps them outside Pallas. Corpus
quantization (``quantize``) goes through ``kernels.ops.kmeans_assign``:
the CUDA kernel for CUDA tensors. Centroid sums use ``index_add_``; on the
card its atomics add in an order that changes from run to run, so a fit
there is reproducible only up to float rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    """Configuration for codebook training."""

    k: int = 256            # number of centroids (paper: 128 / 256 / 512)
    iters: int = 25         # Lloyd iterations
    seed_batch: int = 4096  # k-means++ seeding subsample; 0 = all of x
    n_restarts: int = 8     # independent fits; lowest final inertia wins
    minibatch: int = 0      # 0 = full-batch Lloyd; else per-step sample size
    dtype: torch.dtype = torch.float32

    @property
    def bits(self) -> int:
        """b = ceil(log2 K) — bits per code in binary mode (paper §III-D)."""
        return max(1, math.ceil(math.log2(self.k)))

    @property
    def code_dtype(self) -> torch.dtype:
        return torch.uint8 if self.k <= 256 else torch.uint16


def pairwise_sq_dists(x: Tensor, c: Tensor) -> Tensor:
    """||x_i - c_k||^2 for x (N, D), c (K, D) -> (N, K), clamped at zero
    (the matmul form cancels to small negatives near a centroid)."""
    x2 = (x * x).sum(dim=-1, keepdim=True)
    c2 = (c * c).sum(dim=-1)
    return torch.clamp(x2 - 2.0 * (x @ c.t()) + c2[None, :], min=0.0)


def assign(x: Tensor, centroids: Tensor) -> Tensor:
    """Nearest-centroid assignment (full clamped distance) -> codes (N,)."""
    return torch.argmin(pairwise_sq_dists(x, centroids), dim=-1)


def decode(codes: Tensor, centroids: Tensor) -> Tensor:
    """codes (…,) -> reconstructed embeddings (…, D) by centroid gather."""
    return centroids[codes.to(torch.int64)]


def _kmeans_pp_init(gen: torch.Generator, x: Tensor, k: int) -> Tensor:
    """k-means++ seeding on a (N, D) sample; no host syncs in the loop."""
    n = x.shape[0]
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    centroids = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centroids[0] = x[first][0]
    d2 = pairwise_sq_dists(x, x[first])[:, 0]
    for i in range(1, k):
        # the next seed with probability proportional to squared distance
        idx = torch.multinomial(torch.clamp(d2, min=1e-30), 1, generator=gen)
        c_new = x[idx]                                        # (1, D)
        centroids[i] = c_new[0]
        d2 = torch.minimum(d2, pairwise_sq_dists(x, c_new)[:, 0])
    return centroids


def _repair_dead_centroids(x: Tensor, centroids: Tensor, counts: Tensor,
                           min_d2: Tensor) -> Tensor:
    """Re-seed zero-count centroids on the farthest points: the r-th dead
    centroid (in index order) moves to the point with the r-th largest
    distance to its assigned centroid."""
    kk = min(centroids.shape[0], x.shape[0])
    # stable: equal distances keep the lowest index first, as lax.top_k
    far_idx = torch.sort(min_d2, descending=True, stable=True).indices[:kk]
    dead = counts <= 0
    rank = torch.clamp(torch.cumsum(dead.to(torch.int64), 0) - 1, 0, kk - 1)
    repl = x[far_idx[rank]]
    return torch.where(dead[:, None], repl, centroids)


def _cluster_sums(x: Tensor, codes: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, codes, x)
    counts = torch.zeros((k,), dtype=x.dtype, device=x.device)
    counts.index_add_(0, codes, torch.ones_like(codes, dtype=x.dtype))
    return sums, counts


def _lloyd_step(x: Tensor, centroids: Tensor) -> Tuple[Tensor, Tensor]:
    """One Lloyd iteration with empty-cluster repair -> (new centroids,
    inertia of x against the *input* centroids)."""
    d2 = pairwise_sq_dists(x, centroids)
    codes = torch.argmin(d2, dim=-1)
    min_d2 = d2.gather(1, codes[:, None])[:, 0]
    inertia = min_d2.mean()
    sums, counts = _cluster_sums(x, codes, centroids.shape[0])
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp(counts[:, None], min=1.0), centroids)
    return _repair_dead_centroids(x, new, counts, min_d2), inertia


def _inertia(x: Tensor, centroids: Tensor) -> Tensor:
    """Mean squared distance of x to its nearest centroid."""
    return pairwise_sq_dists(x, centroids).amin(dim=-1).mean()


def kmeans_refine(x: Tensor, centroids0: Tensor, iters: int
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Run ``iters`` Lloyd steps from ``centroids0`` and return the
    lowest-inertia iterate seen (Lloyd with repair is not monotone):
    (best_centroids, per-iteration inertia (iters,), best_inertia)."""
    c = centroids0
    best_c = centroids0
    best_i = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    inertias = []
    for _ in range(iters):
        new_c, inertia = _lloyd_step(x, c)
        better = inertia < best_i
        best_c = torch.where(better, c, best_c)
        best_i = torch.where(better, inertia, best_i)
        inertias.append(inertia)
        c = new_c
    last_i = _inertia(x, c)
    better = last_i < best_i
    best_c = torch.where(better, c, best_c)
    best_i = torch.where(better, last_i, best_i)
    stacked = (torch.stack(inertias) if inertias
               else torch.zeros((0,), dtype=x.dtype, device=x.device))
    return best_c, stacked, best_i


def _minibatch_refine(gen: torch.Generator, x: Tensor, centroids0: Tensor,
                      iters: int, batch: int) -> Tuple[Tensor, Tensor]:
    """Mini-batch Lloyd (Sculley): per-step sample with replacement, each
    centroid moves toward its batch mean at rate n_batch / n_cumulative;
    never-hit centroids re-seed on the batch's farthest points."""
    n = x.shape[0]
    k = centroids0.shape[0]
    c = centroids0
    cum = torch.zeros((k,), dtype=x.dtype, device=x.device)
    inertias = []
    for _ in range(iters):
        idx = torch.randint(0, n, (batch,), generator=gen, device=x.device)
        xb = x[idx]
        d2 = pairwise_sq_dists(xb, c)
        codes = torch.argmin(d2, dim=-1)
        min_d2 = d2.gather(1, codes[:, None])[:, 0]
        sums, cnts = _cluster_sums(xb, codes, k)
        cum = cum + cnts
        target = sums / torch.clamp(cnts[:, None], min=1.0)
        eta = (cnts / torch.clamp(cum, min=1.0))[:, None]
        c = torch.where(cnts[:, None] > 0, c + eta * (target - c), c)
        c = _repair_dead_centroids(xb, c, cum, min_d2)
        inertias.append(min_d2.mean())
    stacked = (torch.stack(inertias) if inertias
               else torch.zeros((0,), dtype=x.dtype, device=x.device))
    return c, stacked


def seed_centroids(gen: torch.Generator, x: Tensor,
                   config: KMeansConfig) -> Tensor:
    """k-means++ seeds for one restart, on a ``seed_batch`` subsample drawn
    without replacement (or on all of x)."""
    n = x.shape[0]
    m = min(config.seed_batch if config.seed_batch > 0 else n, n)
    if m < n:
        sel = torch.randperm(n, generator=gen, device=x.device)[:m]
        x = x[sel]
    return _kmeans_pp_init(gen, x, config.k)


def _fit_single(gen: torch.Generator, x: Tensor, config: KMeansConfig,
                eval_idx: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """One seeded fit -> (centroids, per-iter inertia, final inertia)."""
    n = x.shape[0]
    centroids0 = seed_centroids(gen, x, config)
    if config.minibatch and config.minibatch < n:
        c, inertias = _minibatch_refine(gen, x, centroids0, config.iters,
                                        config.minibatch)
        # restart selection estimates inertia on one eval batch: the full
        # (N, K) E-step is what mini-batch mode exists to avoid
        if eval_idx is None:
            eval_idx = torch.randint(0, n, (config.minibatch,), generator=gen,
                                     device=x.device)
        return c, inertias, _inertia(x[eval_idx], c)
    return kmeans_refine(x, centroids0, config.iters)


def kmeans_fit(gen: torch.Generator, x: Tensor, config: KMeansConfig
               ) -> Tuple[Tensor, Tensor]:
    """Train a K-Means codebook on x (N, D): ``config.n_restarts`` seeded
    fits in sequence, the one with the lowest final inertia wins.

    Returns (centroids (K, D), per-iteration inertia (iters,)).
    """
    x = x.to(config.dtype)
    n = x.shape[0]
    eval_idx = None
    if config.minibatch and config.minibatch < n:
        # one eval batch shared by every restart, so selection compares
        # like with like
        eval_idx = torch.randint(0, n, (config.minibatch,), generator=gen,
                                 device=x.device)
    fits = [_fit_single(gen, x, config, eval_idx)
            for _ in range(max(1, config.n_restarts))]
    best = int(torch.argmin(torch.stack([f[2] for f in fits])))
    return fits[best][0], fits[best][1]


def quantize(x: Tensor, centroids: Tensor, code_dtype=torch.uint8, *,
             impl: str = "auto") -> Tensor:
    """Quantize embeddings (…, M, D) -> codes (…, M) of ``code_dtype``.

    The assignment goes through ``kernels.ops.kmeans_assign``: with
    ``impl="auto"`` the CUDA kernel for CUDA tensors and its plain version
    (the kernel's ``c2 - 2 x.c`` form) for CPU tensors.
    """
    flat = x.reshape(-1, x.shape[-1])
    codes = kernel_ops.kmeans_assign(flat, centroids, impl=impl)
    return codes.to(code_dtype).reshape(x.shape[:-1])


def quantization_error(x: Tensor, centroids: Tensor) -> Tensor:
    """Mean squared reconstruction error of the codebook on x (N, D)."""
    return _inertia(x, centroids)
