"""Kinds of configuration: how the inputs of a configuration are made,
how the port's index is built from them, the work each search needs, and
the kernel launches each search is expected to make.

A configuration file (``configs/<name>.json``) names its kind under
``"kind"``; the kind's module here is found by that name and has:

  inputs(cfg, seed, device)          -> the inputs both sides get
  system(cfg, inp)                   -> (Retriever, RetrieverState)
  costs(cfg, inp, b, q_valid)        -> {kernel: roofline.Cost} of a search
  launches(cfg, b, sms)              -> {kernel: launches} of a search
  reference(cfg, inp, device, tf32)  -> the plain reference, ready to search

``q_valid`` lists the valid query patches of each row of the batch (0 for
the rows the server pads). Kernel names are the port's kernel modules.
"""
from __future__ import annotations

import math

# the streaming scan's merge cap and the kernels' longest range, frozen
# from src/repro_torch/core/scan.py (MAX_CANDIDATES) and
# src/repro_torch/kernels/{quantized_maxsim,hamming}.py (MAX_RANGE,
# MIN_RANGE, BLOCKS_PER_SM, launch_range_len)
MAX_CANDIDATES = 1 << 22
MAX_RANGE = 256
MIN_RANGE = 2
# queries a block of the shared-corpus Hamming sweep takes at most
HAMMING_QUERIES_PER_BLOCK = 32


def keep_count(cfg) -> int:
    """Doc-side top-p's kept patches: ceil(M p / 100), at least one."""
    return max(1, min(cfg["n_patches"],
                      math.ceil(cfg["n_patches"] * cfg["p"] / 100.0)))


def range_len(blocks_per_range: int, n: int, want_blocks: int) -> int:
    """The longest power-of-two range in [MIN_RANGE, MAX_RANGE] whose
    launch still has ``want_blocks`` blocks."""
    r = MAX_RANGE
    while r > MIN_RANGE and blocks_per_range * -(-n // r) < want_blocks:
        r //= 2
    return r


def sweep_launches(b: int, n: int, k: int, r: int) -> int:
    """Launches of a sweep over n positions in ranges of r: one per chunk
    of whole ranges whose (B x ranges x min(k, r)) lists fit the merge
    cap."""
    chunk = r * max(1, MAX_CANDIDATES // (b * min(k, r)))
    return math.ceil(n / chunk)


def qmaxsim_launches(b: int, n: int, k: int, sms: int) -> int:
    return sweep_launches(b, n, k, range_len(b, n, sms))


def hamming_launches(b: int, n: int, k: int, sms: int) -> int:
    groups = -(-b // HAMMING_QUERIES_PER_BLOCK)
    return sweep_launches(b, n, k, range_len(groups, n, 2 * sms))
