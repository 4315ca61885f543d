"""The benchmark's inputs, drawn on the device from ``--seed``.

Both sides get these inputs: the port builds its index from them and the
plain reference works out again everything the port derives from them.
Two rules, each a frozen copy of a generator in the port:

  * ``window_codes``: the rule of ``chip_smoke.py:3696-3719`` (the
    serve_query cell): unit-norm centroids, and each page's codes drawn
    from a window of ``window`` consecutive codebook entries.
  * ``PageCorpus``: the rule of
    ``src/repro_torch/data/synthetic.py:54-112`` (``make_retrieval_corpus``:
    topic banks of patch prototypes, salient patches shared within a
    group of near-duplicates, background patches from any bank, noise,
    L2 normalisation, salience 0.8-1.0 on salient and 0-0.2 on background
    patches; a query is a target page's salient patches plus noise). Here
    the pages are drawn a chunk at a time, each chunk from a generator of
    its own, so a corpus larger than the card is drawn again bit for bit
    whenever it is needed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# draws of this many pages at a time bound the int64 temporaries of
# ``window_codes`` (chip_smoke.py draws 2**18 pages a step)
CODE_CHUNK = 1 << 18


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``stream`` of ``seed``: streams are
    independent, and any whole seed (a large one too) is taken."""
    mixed = (int(seed) * 1_000_003 + int(stream) * 7_919 + 1) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def unit_rows(gen: torch.Generator, n: int, d: int, device) -> Tensor:
    """(n, d) float32 rows drawn from a normal and scaled to unit norm."""
    x = torch.randn((n, d), generator=gen, device=device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def window_codes(gen: torch.Generator, n: int, m: int, k: int, window: int,
                 device) -> Tensor:
    """(n, m) uint8 codes: a page's codes are ``base + offset (mod k)``,
    its base uniform over the codebook and each offset uniform over
    ``window`` entries."""
    if k > 256:
        raise ValueError("window_codes draws uint8 codes (k <= 256)")
    codes = torch.empty((n, m), dtype=torch.uint8, device=device)
    for start in range(0, n, CODE_CHUNK):
        t = min(CODE_CHUNK, n - start)
        base = torch.randint(0, k, (t, 1), generator=gen, device=device)
        off = torch.randint(0, window, (t, m), generator=gen, device=device)
        codes[start:start + t] = ((base + off) % k).to(torch.uint8)
    return codes


@dataclasses.dataclass(frozen=True)
class CorpusRule:
    """``CorpusSpec``'s knobs (``synthetic.py:41-51``) at a config's
    widths."""

    n_docs: int
    n_patches: int
    n_q_patches: int
    dim: int
    n_topics: int = 32
    patches_per_topic: int = 64
    noise: float = 0.25
    salient_frac: float = 0.5
    dup_per_doc: int = 3

    @property
    def n_sal(self) -> int:
        return max(1, int(self.n_patches * self.salient_frac))


class PageCorpus:
    """Pages, salience and queries of ``make_retrieval_corpus``'s rule,
    drawn a chunk of ``chunk_docs`` pages at a time.

    The topic banks and each near-duplicate group's prototype picks are
    drawn once (stream 0); chunk c's noise and background picks come from
    stream c + 1, so ``chunk(c)`` gives the same pages every time.
    """

    def __init__(self, rule: CorpusRule, seed: int, device,
                 chunk_docs: int):
        self.rule, self.seed, self.device = rule, int(seed), device
        self.chunk_docs = int(chunk_docs)
        gen = generator(seed, device, 0)
        r = rule
        t_centers = torch.randn((r.n_topics, r.dim), generator=gen,
                                device=device)
        self.banks = t_centers[:, None, :] + 0.7 * torch.randn(
            (r.n_topics, r.patches_per_topic, r.dim), generator=gen,
            device=device)
        n_groups = r.n_docs // (1 + r.dup_per_doc) + 1
        self.proto_idx = torch.randint(
            0, r.patches_per_topic, (n_groups, r.n_sal), generator=gen,
            device=device).to(torch.int16)
        self.gen0 = gen                 # queries and codebook draw on

    @property
    def n_chunks(self) -> int:
        return -(-self.rule.n_docs // self.chunk_docs)

    def chunk(self, c: int) -> Tuple[int, Tensor, Tensor]:
        """(first page, patches (t, M, D) float32 unit rows, salience (t,
        M) float32) of chunk ``c``."""
        r, dev = self.rule, self.device
        start = c * self.chunk_docs
        t = min(self.chunk_docs, r.n_docs - start)
        gen = generator(self.seed, dev, c + 1)
        doc = torch.arange(start, start + t, device=dev)
        group = doc // (1 + r.dup_per_doc)
        topic = group % r.n_topics
        n_sal, m = r.n_sal, r.n_patches
        patches = torch.empty((t, m, r.dim), device=dev)
        patches[:, :n_sal] = self.banks[topic[:, None],
                                        self.proto_idx[group].long()]
        bg_topic = torch.randint(0, r.n_topics, (t, m - n_sal), generator=gen,
                                 device=dev)
        bg_proto = torch.randint(0, r.patches_per_topic, (t, m - n_sal),
                                 generator=gen, device=dev)
        patches[:, n_sal:] = self.banks[bg_topic, bg_proto]
        patches.add_(torch.randn(patches.shape, generator=gen, device=dev),
                     alpha=r.noise)
        patches.div_(torch.linalg.vector_norm(patches, dim=-1, keepdim=True))
        sal = torch.cat([
            0.8 + 0.2 * torch.rand((t, n_sal), generator=gen, device=dev),
            0.2 * torch.rand((t, m - n_sal), generator=gen, device=dev)],
            dim=1)
        return start, patches, sal

    def chunks(self) -> Iterator[Tuple[int, Tensor, Tensor]]:
        for c in range(self.n_chunks):
            yield self.chunk(c)

    def codebook(self, k: int) -> Tensor:
        """(k, D) unit-norm centroids: ``k`` of the bank prototypes,
        without replacement, scaled to unit norm (a codebook made from the
        seed, not fit)."""
        r = self.rule
        flat = self.banks.reshape(-1, r.dim)
        if k > flat.shape[0]:
            raise ValueError(f"k={k} exceeds the {flat.shape[0]} prototypes")
        pick = torch.randperm(flat.shape[0], generator=self.gen0,
                              device=self.device)[:k]
        cb = flat[pick]
        return cb / torch.linalg.vector_norm(cb, dim=-1, keepdim=True)

    def queries(self, n_queries: int) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
        """(Q, Mq, D) float32, (Q, Mq) bool, (Q, Mq) float32 host arrays:
        query i is ``n_q_patches`` of page ``i (1 + dup) mod N``'s salient
        patches plus noise, at unit norm; every patch valid."""
        r, dev = self.rule, self.device
        gen = self.gen0
        target = (torch.arange(n_queries, device=dev)
                  * (1 + r.dup_per_doc)) % r.n_docs
        pick = torch.randint(0, r.n_sal, (n_queries, r.n_q_patches),
                             generator=gen, device=dev)
        noise = torch.randn((n_queries, r.n_q_patches, r.dim), generator=gen,
                            device=dev)
        sal = 0.5 + 0.5 * torch.rand((n_queries, r.n_q_patches),
                                     generator=gen, device=dev)
        q = torch.empty((n_queries, r.n_q_patches, r.dim), device=dev)
        # the target pages' own patches: draw each chunk that holds one
        for c in torch.unique(target // self.chunk_docs).tolist():
            start, patches, _ = self.chunk(int(c))
            sel = (target // self.chunk_docs) == c
            rows = (target[sel] - start).long()
            q[sel] = patches[rows[:, None], pick[sel]]
            del patches
        q = q + r.noise * noise
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        mask = torch.ones((n_queries, r.n_q_patches), dtype=torch.bool)
        return (q.cpu().numpy(), mask.numpy(), sal.cpu().numpy())
