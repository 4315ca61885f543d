"""The least time a search's work needs on one H100, from its shapes.

Frozen copies of the port's cost arithmetic, so that a later change to
the program cannot move the yardstick:

  * ``bound`` and ``gemm_bounds``: ``chip_smoke.py:584-601`` (``_bound``,
    ``_gemm_bounds``), unchanged.
  * ``qmaxsim_cost``, ``hamming_cost`` and ``maxsim_cost``: the counts of
    ``chip_smoke.py:655-701`` (``_qmaxsim_cost``, ``_hamming_cost``,
    ``_maxsim_cost``), taken from counts instead of tensors. Each input
    byte is read once and each output byte written once.

What counts as an operation differs from chip_smoke.py in one place. A
lookup kernel (ADC, Hamming) scores a page from the set of codes it
holds, so the work these inputs need is one lookup per valid query patch
and page: ``ops``. chip_smoke.py counted one per valid query patch and
valid doc slot (``slot_ops``), which a kernel that reads each page's code
set once beats. Both kernels have such an algorithm:

  * Hamming (the port's ``hamming_maxsim`` since it was redesigned): the
    page's code set as 2**bits flags, the exact distance transform over
    them once a page, then one table lookup per query patch. On an H100
    it already reads about 150% of a per-slot bound.
  * ADC: sort each query patch's row of the (B, Mq, K) table once a
    search (B * Mq * K log K compares, no work per page). Hold each
    page's code set as a K-bit mask, built from its codes as they are
    read (md bit sets a page, shared by every query). The page's best
    score for a query patch is then the first code, in that patch's
    order, that the mask holds: (K + 1) / (s + 1) bit tests expected for
    a page of s distinct codes, about 4 at K = 256 and the flat cell's
    window of 64 codes, against md = 615 lookups a slot count charges.
    A search's work is then about md + 4 * B * Mq per page, near the
    ``ops`` count of B * Mq, and about 100x under ``slot_ops``.

So a per-slot count is not the least work, and a share of it could pass
100%. ``slot_ops`` is kept and printed beside the metric on an earlier
line, never divided into a time. A float MaxSim product has no such
shortcut: 2 * D FLOPs per valid query patch and valid doc slot.

Peaks: the H100 SXM data sheet at 700 W (f32 outside the tensor cores,
dense TF32, HBM3).
"""
from __future__ import annotations

import dataclasses

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# 3xTF32 issues three TF32 products per f32 product
PEAK_TF32_FLOPS = 495e12


def bound(n_bytes: float, n_ops: float, ops_per_s: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_HBM_BYTES
    t_ops = n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gemm_bounds(n_bytes: float, flops: float):
    """The bounds of a kernel whose operations are f32 products:
    (bound_ms, bound_by, f32_fma_bound_ms, tf32x3_bound_ms), where
    ``bound_ms`` is the larger of the bytes bound and the smaller of the
    two compute bounds."""
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_f32 = flops / PEAK_F32_FLOPS * 1e3
    t_x3 = 3.0 * flops / PEAK_TF32_FLOPS * 1e3
    t_ops = min(t_f32, t_x3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_f32, t_x3)


@dataclasses.dataclass(frozen=True)
class Cost:
    """One kernel call's work: bytes, operations, the rate its
    operations run at, and the per-slot count (lookup kernels only)."""

    n_bytes: float
    ops: float
    gemm: bool = False
    slot_ops: float = 0.0

    def least_ms(self) -> float:
        if self.gemm:
            return gemm_bounds(self.n_bytes, self.ops)[0]
        return bound(self.n_bytes, self.ops)[0]


def qmaxsim_cost(*, b: int, mq: int, k: int, pages: int, md: int,
                 code_bytes: int, mask_bytes: int, out_bytes: int,
                 pairs: float, slot_pairs: float) -> Cost:
    """quantized_maxsim reading ``pages`` pages of ``md`` slots: the (B,
    Mq, K) table, the query weights, the codes and mask, the output.
    ``pairs``: valid query patches x the pages each query scores (the
    operations); ``slot_pairs``: valid query patches x the valid slots
    each query scores."""
    n_bytes = (b * mq * k * 4 + b * mq * 4
               + pages * md * (code_bytes + mask_bytes) + out_bytes)
    return Cost(n_bytes, float(pairs), False, float(slot_pairs))


def hamming_cost(*, b: int, mq: int, pages: int, md: int, code_bytes: int,
                 mask_bytes: int, out_bytes: int, pairs: float,
                 slot_pairs: float) -> Cost:
    """hamming_maxsim reading ``pages`` pages: query codes and weights, the
    codes and mask, the output; ``pairs`` and ``slot_pairs`` as for
    ``qmaxsim_cost``."""
    n_bytes = (2 * b * mq * 4 + pages * md * (code_bytes + mask_bytes)
               + out_bytes)
    return Cost(n_bytes, float(pairs), False, float(slot_pairs))


def maxsim_cost(*, b: int, mq: int, d: int, q_valid_slots: int,
                read_pages: int, md: int, mask_bytes: int,
                out_bytes: int) -> Cost:
    """maxsim: the queries, weights, the pages read (each distinct page
    once: pass the fewest that must be read), the output; 2 * D FLOPs per
    valid query patch and valid doc slot it scores (``q_valid_slots``:
    the sum over queries of valid patches x valid slots scored)."""
    n_bytes = (b * mq * d * 4 + b * mq * 4
               + read_pages * md * (d * 4 + mask_bytes) + out_bytes)
    return Cost(n_bytes, 2.0 * d * q_valid_slots, True)


def assign_cost(*, rows: int, d: int, k: int) -> Cost:
    """kmeans_assign of ``rows`` vectors against K centroids: the rows,
    the codebook and the codes; 2 * D FLOPs per row and centroid."""
    return Cost(rows * d * 4 + k * d * 4 + rows * 4, 2.0 * d * k * rows,
                True)
