"""Helpers for the PyTorch port's parity tests: inputs are made with numpy
from a seed, handed to the JAX package and to the port, and compared."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.parity import topk_mismatches

# The suite runs several pytest-xdist workers per host: torch's default
# intra-op pool (a thread per core in every worker) oversubscribes the
# cores and makes the port's many small ops several times slower.
torch.set_num_threads(1)


def to_torch(*arrays):
    """numpy arrays -> CPU tensors (contiguous copies of the same values)."""
    return tuple(torch.from_numpy(np.array(a, copy=True)) for a in arrays)


def assert_topk_match(got_s, got_i, want_s, want_i, tol=1e-4):
    """Scores within atol = rtol = tol; ids equal outside near-ties."""
    got_s, got_i = np.asarray(got_s), np.asarray(got_i)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    assert got_i.shape == want_i.shape
    np.testing.assert_allclose(got_s, want_s, atol=tol, rtol=tol)
    bad = topk_mismatches(got_i, got_s, want_i, want_s, tol)
    assert not bad, f"ids differ outside near-ties at {bad}"


def code_gaps(x, codebook, codes_a, codes_b):
    """|d(a) - d(b)| in float64 for rows whose codes differ, with
    d(k) = ||c_k||^2 - 2 x.c_k (the assignment's distance up to ||x||^2)."""
    x = np.asarray(x, np.float64).reshape(-1, codebook.shape[-1])
    c = np.asarray(codebook, np.float64)
    a = np.asarray(codes_a).reshape(-1).astype(np.int64)
    b = np.asarray(codes_b).reshape(-1).astype(np.int64)
    rows = np.nonzero(a != b)[0]
    c2 = (c * c).sum(-1)
    da = c2[a[rows]] - 2.0 * (x[rows] * c[a[rows]]).sum(-1)
    db = c2[b[rows]] - 2.0 * (x[rows] * c[b[rows]]).sum(-1)
    return np.abs(da - db)
