"""The plain PyTorch versions of the four kernels, under the reference's
names.

The counterpart of ``repro.kernels.ref`` (the oracles every Pallas kernel
is held to): each name here is the plain version that the CUDA kernel of
the same name is held to. They take the reference's arguments, in its
order, and extend them to per-query pools. One difference in type:
``hamming_maxsim`` returns int32 where the reference returns the same
integers as float32, and masks a document with no valid patch as
``li.binary_maxsim`` does (caveat C4 in ROADMAP.md).
"""
from __future__ import annotations

from repro_torch.kernels.hamming import hamming_maxsim_plain as hamming_maxsim  # noqa: F401
from repro_torch.kernels.kmeans_assign import kmeans_assign_plain as kmeans_assign  # noqa: F401
from repro_torch.kernels.maxsim import maxsim_plain as maxsim  # noqa: F401
from repro_torch.kernels.quantized_maxsim import (  # noqa: F401
    NEG_INF,
    quantized_maxsim_plain as quantized_maxsim,
)
