"""RAG integration (paper §V-C / Table V): HPC-ColPali as the retriever for
a generator LM, with exactly measurable hallucination.

The counterpart of ``repro.core.rag`` (its serving half). The synthetic
legal corpus (``data/synthetic.make_fact_corpus``) gives every document an
explicit fact set. The pipeline:

  query -> HPC-ColPali retrieval (top-k docs) -> prompt
  [doc_1 facts .. doc_k facts, QUERY, probe, SEP] -> greedy decode of
  ``max_answer`` tokens (prefill + cached decode steps) -> fact ids.

Metrics (the reference's definitions):
  hallucination rate — fraction of generated facts NOT in the retrieved
    context;
  ROUGE-L — LCS-based F1 between the generated fact sequence and the gold
    doc's fact set;
  answer accuracy — every gold fact generated;
  latency — retrieval + generation wall-clock per query; on the card each
    clock stops on a ``torch.cuda.synchronize``.

``rag_pipeline`` is ``rag_metrics`` over ``retrieve_and_generate``, whose
``RAGRun`` keeps the retrieved ids, the prompts and the generated tokens.
``make_rag_train_batch`` is the generator's supervised batch (the gold
doc among distractors in the context, the answer its facts).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.retrieval.base import Query, RetrieverState
from repro_torch.retrieval.config import HPCConfig
from repro_torch.retrieval.retriever import Retriever

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RAGConfig:
    retriever: HPCConfig = dataclasses.field(default_factory=HPCConfig)
    top_k_docs: int = 2
    facts_per_doc: int = 4
    fact0: int = 3               # first fact-token id (vocab layout)
    sep: int = 1
    max_answer: int = 4


def build_prompt(doc_tokens: Tensor, query_tokens: Tensor, cfg: RAGConfig,
                 prompt_len: int) -> Tensor:
    """Retrieved docs' tokens (B, k, Ld) + query tokens (B, Lq) ->
    prompt (B, prompt_len): each doc's fact prefix (facts_per_doc + SEP),
    then the query, right-padded with zeros."""
    b, k, _ = doc_tokens.shape
    keep = cfg.facts_per_doc + 1
    ctx = doc_tokens[:, :, :keep].reshape(b, k * keep)
    prompt = torch.cat([ctx, query_tokens.to(ctx.dtype)], dim=1)
    pad = prompt_len - prompt.shape[1]
    if pad < 0:
        raise ValueError(f"prompt of {prompt.shape[1]} tokens exceeds "
                         f"prompt_len={prompt_len}")
    return torch.nn.functional.pad(prompt, (0, pad))


def greedy_generate(model: T.Transformer, prompt: Tensor, max_new: int,
                    prompt_len: int) -> Tensor:
    """Greedy decode ``max_new`` tokens after the prompt (B, prompt_len):
    prefill, then cached decode steps; argmax takes the first maximum, as
    ``jnp.argmax`` does. Returns (B, max_new) int32."""
    logits, cache = T.prefill(model, prompt, max_len=prompt_len + max_new)
    outs = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for i in range(max_new):
        outs.append(tok)
        if i == max_new - 1:
            break
        logits, cache = T.decode_step(model, tok, cache, prompt_len + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.stack(outs, dim=1)


def extract_facts(tokens: np.ndarray, fact0: int, n_facts: int) -> List[set]:
    """Token rows -> sets of fact ids (non-fact tokens ignored)."""
    return [{int(t) - fact0 for t in row if fact0 <= int(t) < fact0 + n_facts}
            for row in tokens]


def hallucination_rate(generated: Sequence[set],
                       context_facts: Sequence[set]) -> float:
    """Fraction of generated facts unsupported by the retrieved context."""
    total, bad = 0, 0
    for gen, ctx in zip(generated, context_facts):
        for f in gen:
            total += 1
            bad += f not in ctx
    return bad / max(total, 1)


def rouge_l(gen: Sequence[int], ref: Sequence[int]) -> float:
    """ROUGE-L F1 on token sequences."""
    g, r = list(gen), list(ref)
    if not g or not r:
        return 0.0
    dp = np.zeros((len(g) + 1, len(r) + 1), np.int32)
    for i in range(1, len(g) + 1):
        for j in range(1, len(r) + 1):
            dp[i, j] = (dp[i - 1, j - 1] + 1 if g[i - 1] == r[j - 1]
                        else max(dp[i - 1, j], dp[i, j - 1]))
    lcs = dp[-1, -1]
    prec, rec = lcs / len(g), lcs / len(r)
    return 0.0 if lcs == 0 else 2 * prec * rec / (prec + rec)


class RAGRun(NamedTuple):
    """What one retrieve-and-generate pass produced and how long it took."""

    ids: Tensor          # (B, top_k_docs) retrieved doc ids, clamped >= 0
    prompt: Tensor       # (B, prompt_len) int
    tokens: np.ndarray   # (B, max_answer) int32 generated, on the host
    retrieve_s: float
    generate_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def retrieve_and_generate(index: RetrieverState, model: T.Transformer,
                          corpus, rag_cfg: RAGConfig,
                          queries_slice: slice = slice(None), *,
                          device="cuda") -> RAGRun:
    """Retrieve the top ``rag_cfg.top_k_docs`` docs of each query of the
    fact corpus over ``index``, build the prompts and decode greedily with
    ``model``; ``index``, ``model`` and ``corpus`` live on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    q_emb = corpus.query_patches[queries_slice].to(dev)
    q_mask = corpus.query_mask[queries_slice].to(dev)
    q_sal = corpus.query_salience[queries_slice].to(dev)
    q_tok = corpus.query_tokens[queries_slice].to(dev)

    _sync(dev)
    t0 = time.perf_counter()
    _, ids = Retriever(rag_cfg.retriever).search(
        index, Query(q_emb, q_mask, q_sal), k=rag_cfg.top_k_docs)
    ids = torch.clamp(ids, min=0)
    _sync(dev)
    t_retrieve = time.perf_counter() - t0

    doc_toks = corpus.doc_tokens.to(dev)[ids.long()]          # (B, k, Ld)
    prompt_len = rag_cfg.top_k_docs * (rag_cfg.facts_per_doc + 1) \
        + q_tok.shape[1]
    prompt = build_prompt(doc_toks, q_tok, rag_cfg, prompt_len)

    t1 = time.perf_counter()
    gen = greedy_generate(model, prompt, rag_cfg.max_answer, prompt_len)
    _sync(dev)
    t_generate = time.perf_counter() - t1
    gen = gen.cpu().numpy()
    return RAGRun(ids, prompt, gen, t_retrieve, t_generate)


def rag_metrics(run: RAGRun, corpus, rag_cfg: RAGConfig, n_facts_vocab: int,
                queries_slice: slice = slice(None)) -> Dict[str, float]:
    """The Table V row of a ``RAGRun``: ROUGE-L, hallucination, answer
    accuracy and the per-query latencies in ms."""
    gold_facts = corpus.gold_facts[queries_slice].cpu().numpy()
    ids = run.ids.cpu().numpy()
    ctx_facts = corpus.doc_facts.cpu().numpy()[ids]            # (B, k, F)
    ctx_sets = [set(row.ravel().tolist()) for row in ctx_facts]
    gen_sets = extract_facts(run.tokens, rag_cfg.fact0, n_facts_vocab)
    halluc = hallucination_rate(gen_sets, ctx_sets)
    rouges = [rouge_l(sorted(g), sorted(set(ref.tolist())))
              for g, ref in zip(gen_sets, gold_facts)]
    correct = np.mean([set(ref.tolist()) <= g
                       for g, ref in zip(gen_sets, gold_facts)])
    b = run.tokens.shape[0]
    return {
        "rouge_l": float(np.mean(rouges)),
        "hallucination": float(halluc),
        "answer_acc": float(correct),
        "latency_ms": (run.retrieve_s + run.generate_s) * 1e3 / b,
        "retrieve_ms": run.retrieve_s * 1e3 / b,
        "generate_ms": run.generate_s * 1e3 / b,
    }


def rag_pipeline(index: RetrieverState, model: T.Transformer, corpus,
                 rag_cfg: RAGConfig, n_facts_vocab: int,
                 queries_slice: slice = slice(None), *, device="cuda"
                 ) -> Dict[str, float]:
    """Run retrieval + generation over the fact corpus; return the Table V
    row (the reference's ``rag_pipeline``; the generator's config is the
    model's own)."""
    run = retrieve_and_generate(index, model, corpus, rag_cfg, queries_slice,
                                device=device)
    return rag_metrics(run, corpus, rag_cfg, n_facts_vocab, queries_slice)


def make_rag_train_batch(generator: torch.Generator, corpus,
                         vocab: Dict[str, int], rag_cfg: RAGConfig,
                         batch: int, seq_len: int, n_docs: int
                         ) -> Dict[str, Tensor]:
    """Supervised RAG fine-tuning batch, on the corpus's device (the
    generator's too): prompt (the gold doc and ``top_k_docs - 1`` random
    distractors in a random order, then QUERY, a probe fact of the gold
    doc, SEP) -> answer = the gold doc's facts. The reference's
    ``make_rag_train_batch`` drawn from ``generator``. Returns int32
    ``tokens`` and ``targets`` (B, seq_len); targets are -1 outside the
    answer's positions."""
    dev = corpus.doc_tokens.device
    k = rag_cfg.top_k_docs
    fpd = rag_cfg.facts_per_doc

    def randint(high, *shape):
        return torch.randint(0, high, shape, generator=generator,
                             device=dev)

    gold = randint(n_docs, batch)
    distract = randint(n_docs, batch, k - 1)
    docs = torch.cat([gold[:, None], distract], dim=1)
    # the gold doc's position in the context: a random permutation per row
    perm = torch.argsort(torch.rand((batch, k), generator=generator,
                                    device=dev), dim=1)
    docs = torch.take_along_dim(docs, perm, dim=1)
    doc_toks = corpus.doc_tokens[docs]

    probe_slot = randint(fpd, batch)
    probe = corpus.doc_facts[gold, probe_slot] + vocab["fact0"]
    q_tok = torch.zeros((batch, 4), dtype=torch.int32, device=dev)
    q_tok[:, 0] = vocab["query"]
    q_tok[:, 1] = probe
    q_tok[:, 2] = vocab["sep"]

    prompt_len = k * (fpd + 1) + 4
    prompt = build_prompt(doc_toks, q_tok, rag_cfg, prompt_len)
    answer = corpus.doc_facts[gold] + vocab["fact0"]        # (B, F)
    full = torch.cat([prompt, answer.to(prompt.dtype)], dim=1)
    pad = seq_len + 1 - full.shape[1]
    if pad < 0:
        raise ValueError(f"seq_len={seq_len} is shorter than the prompt "
                         f"and answer ({full.shape[1] - 1} tokens)")
    full = torch.nn.functional.pad(full, (0, pad))
    tokens, targets = full[:, :-1], full[:, 1:]
    pos = torch.arange(seq_len, device=dev)[None, :]
    is_answer = (pos >= prompt_len - 1) & (pos < prompt_len - 1 + fpd)
    targets = torch.where(is_answer, targets, -1)
    return {"tokens": tokens.to(torch.int32),
            "targets": targets.to(torch.int32)}
