"""The plain references, the check's numbers and the trace arithmetic
against hand-worked tiny cases."""
from __future__ import annotations

import json
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from portbench import check, corpus, trace
from portbench.reference import BINARY_MASKED, lower, presence
from portbench.reference.cascade import (CascadeReference, nearest,
                                         popcount_table)
from portbench.reference.encoded_flat import EncoderReference, fp8
from portbench.reference.flat import FlatReference


def _flat_case():
    # 3 centroids in 2-D; the query's patches (1, 0) and (0, 1)
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.6, 0.8]])
    codes = torch.tensor([[0, 1], [2, 2], [1, 0], [2, 1]],
                         dtype=torch.uint8)
    mask = torch.tensor([[True, True], [True, False], [True, True],
                         [True, False]])
    full = torch.tensor([[0, 1, 2], [2, 2, 2], [1, 0, 0], [2, 1, 1]],
                        dtype=torch.uint8)
    full_mask = torch.tensor([[True, True, True], [True, True, True],
                              [True, True, True], [True, True, False]])
    q = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])
    qm = torch.tensor([[True, True]])
    return cb, codes, mask, full, full_mask, q, qm


def test_flat_reference_by_hand():
    cb, codes, mask, full, full_mask, q, qm = _flat_case()
    ref = FlatReference(cb, codes, mask, full, full_mask, rerank=3,
                        top_k=2)
    # table rows: q0 -> (1, 0, .6), q1 -> (0, 1, .8)
    # ADC over kept codes: page 0 {0, 1}: 1 + 1 = 2; page 1 {2}: 1.4;
    # page 2 {1, 0}: 2 (ties page 0: page 0 first); page 3 {2}: 1.4
    # -> rerank pool pages 0, 2, 1 (page 1 before page 3 on the tie)
    # full codes: page 0 {0,1,2}: 2; page 2 {1,0}: 2; page 1 {2}: 1.4
    s, i = ref.search(q, qm)
    assert i.tolist() == [[0, 2]]
    assert s[0].tolist() == pytest.approx([2.0, 2.0])
    ex = ref.exact(q, qm, torch.tensor([[1, 3]]))
    # page 3's full codes {2, 1} (the third slot masked): .6 + max(.8, 1)
    assert ex[0].tolist() == pytest.approx([1.4, 1.6])


def test_flat_reference_masked_query_patch_counts_nothing():
    cb, codes, mask, full, full_mask, q, _ = _flat_case()
    ref = FlatReference(cb, codes, mask, full, full_mask, rerank=4,
                        top_k=4)
    s, i = ref.search(q, torch.tensor([[True, False]]))
    # only q0 = (1, 0): pages 0 and 2 hold code 0 (1.0), 1 and 3 code 2
    assert i.tolist() == [[0, 2, 1, 3]]
    assert s[0].tolist() == pytest.approx([1.0, 1.0, 0.6, 0.6])


def test_presence_ignores_masked_slots():
    codes = torch.tensor([[3, 1, 1], [0, 2, 3]])
    mask = torch.tensor([[True, True, False], [False, False, True]])
    assert presence(codes, mask, 4).tolist() == [
        [False, True, False, True], [False, False, False, True]]


def test_popcount_table_and_nearest():
    t = popcount_table(3, "cpu")
    assert t[0b101, 0b101] == 3 and t[0b000, 0b111] == 0
    assert t[0b110, 0b100] == 2
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    x = torch.tensor([[0.9, 0.1], [0.2, 0.8], [-0.5, -0.4], [0.5, 0.5]])
    # the last row is equidistant from 0 and 1: the lower index
    assert nearest(x, cb, False).tolist() == [0, 1, 2, 0]


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, 3.0 + 2.0 ** -11])
    assert lower(x, False).tolist() == x.tolist()
    assert lower(x, True).tolist() == [1.0, 1.0 + 2.0 ** -10, 3.0]


def test_fp8_rounding():
    # scale 1 (the largest magnitude is e4m3's 448): 3 mantissa bits, so
    # steps of 1/8 in [1, 2), ties to even; 2**-9 is the least subnormal
    x = torch.tensor([448.0, 1.06, 1.07, 1.1875, 2.0 ** -9, 2.0 ** -11])
    assert fp8(x, (0,)).tolist() == [448.0, 1.0, 1.125, 1.25, 2.0 ** -9,
                                     0.0]
    # a slice's scale is its own: the same values at 1/64 of the size
    rows = torch.stack([x, x / 64])
    assert torch.equal(fp8(rows, (1,))[1], fp8(x, (0,)) / 64)


def test_encoder_numbers_by_hand():
    """k of S queries' embeddings pushed past ``enc_tol``: ``enc_miss`` is
    k / S, ``enc_err`` the median, and the verdict follows the limit."""
    gen = torch.Generator().manual_seed(5)
    ref = torch.randn((8, 6, 4), generator=gen)
    mask = torch.arange(6)[None] < torch.tensor([[6], [5], [4], [3], [6],
                                                 [2], [6], [4]])
    served = ref.clone()
    served[:, :, 0] += 1e-4
    for j in (1, 6):                     # k = 2 of S = 8
        served[j, 0] += 0.5
    served[~mask] = 7.0                  # padded rows are not compared
    errs = [check.rel_error(served[j], ref[j], mask[j]) for j in range(8)]
    assert all(e < 1e-3 for j, e in enumerate(errs) if j not in (1, 6))
    assert errs[1] > 0.05 and errs[6] > 0.05
    v = check.encoder_numbers(errs, enc_tol=0.01)
    assert v["enc_miss"] == 2 / 8
    assert v["enc_err"] == pytest.approx(float(np.median(errs)))
    assert not check.verdict(v, {"enc_err": 0.01, "enc_miss": 0.2})
    assert check.verdict(v, {"enc_err": 0.01, "enc_miss": 0.25})
    # a query none of whose instances was found counts as a miss
    assert check.encoder_numbers([0.0, check.NOT_SERVED], 0.01)[
        "enc_miss"] == 0.5


@pytest.mark.parametrize("adtype", ["float32", "bfloat16"])
def test_encoder_reference_against_the_port_on_the_cpu(adtype):
    """The port's ColPali query encoder and the reference on the same
    drawn weights: float32 agrees to rounding; bfloat16 activations stay
    several times under the control, whose products' inputs are rounded
    one step lower (TF32 for float32, float8 e4m3 for bfloat16)."""
    from portbench.kinds import encoded_flat
    from portbench.tests import _tiny
    cfg = json.loads(json.dumps(_tiny.TINY_CONFIGS["tiny-qenc"]))
    cfg["encoder"]["backbone"]["activation_dtype"] = adtype
    inp = types.SimpleNamespace(seed=11, device=torch.device("cpu"),
                                pool=None)
    encode = encoded_flat.encoder(cfg, inp)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, 128, (4, 8), generator=gen)
    mask = torch.arange(8)[None] < torch.tensor([[8], [5], [3], [8]])
    served, m, sal = encode(tokens, mask)
    assert m is mask and sal.shape == (4, 8)
    w = encoded_flat.draw_weights(cfg, 11, "cpu")
    ref = EncoderReference(cfg["encoder"], w).encode(tokens, mask)
    low = EncoderReference(cfg["encoder"], w, lower=True).encode(tokens,
                                                                 mask)
    err = max(check.rel_error(served[j], ref[j], mask[j]) for j in range(4))
    ctl = min(check.rel_error(low[j], ref[j], mask[j]) for j in range(4))
    assert (served[~mask] == 0).all()
    if adtype == "float32":
        assert err < 1e-5 and ctl > 1e-4
    else:
        assert 1e-4 < err < 0.05 and ctl > 3 * err


def _tiny_pages():
    rule = corpus.CorpusRule(n_docs=6, n_patches=4, n_q_patches=2, dim=2,
                             n_topics=1, patches_per_topic=2)
    pages = types.SimpleNamespace(rule=rule)
    x = torch.tensor([
        [[1, 0], [0, 1], [1, 0], [0, 1]],
        [[0, 1], [0, 1], [0, 1], [0, 1]],
        [[1, 0], [1, 0], [1, 0], [1, 0]],
        [[-1, 0], [-1, 0], [1, 0], [0, 1]],
        [[0, -1], [0, -1], [0, -1], [-1, 0]],
        [[1, 0], [0, 1], [0, -1], [-1, 0]]], dtype=torch.float32)
    sal = torch.tensor([[4, 3, 2, 1]] * 5 + [[1, 2, 3, 4]],
                       dtype=torch.float32)
    pages.chunks = lambda: iter([(0, x[:4], sal[:4]), (4, x[4:], sal[4:])])
    return pages, x


def test_cascade_reference_by_hand():
    pages, x = _tiny_pages()
    cb = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    ref = CascadeReference(pages, cb, p=50.0, p1=4, p2=2, top_k=1, bits=2)
    # top-50% by salience: pages 0-4 keep patches 0, 1; page 5 keeps 3, 2
    assert ref.codes.tolist() == [[0, 1], [1, 1], [0, 0], [2, 2], [3, 3],
                                  [2, 3]]
    q = torch.tensor([[[1.0, 0.0], [0.0, 1.0]]])
    s, i = ref.search(q, torch.tensor([[True, True]]))
    # query codes 0, 1. Hamming (2 - popcount): page 0 {0, 1}: 2 + 2 = 4;
    # page 1 {1}: 1 + 2 = 3; page 2 {0}: 2 + 1 = 3; page 3 {2}: 1 + 0 = 1;
    # page 4 {3}: 0 + 1 = 1; page 5 {2, 3}: 1 + 1 = 2 -> pool 0, 1, 2, 5
    # ADC: page 0: 2; page 1: 0 + 1 = 1; page 2: 1 + 0 = 1; page 5: 0 -> 0, 1
    # float over kept patches: page 0: 2
    assert i.tolist() == [[0]] and s[0].tolist() == pytest.approx([2.0])
    assert ref.exact(q, torch.tensor([[True, True]]),
                     torch.tensor([[5, 2]]))[0].tolist() == pytest.approx(
        [0.0, 1.0])


def test_check_numbers_by_hand():
    answers = [
        (np.array([2.0, 1.0]), np.array([3, 1])),      # sound
        (np.array([2.0, 0.9]), np.array([3, 2])),      # misses rank 2
        (np.array([2.0, 1.0]), np.array([3, 3])),      # an id twice
        None,                                          # never came
        (np.array([2.0, np.nan]), np.array([3, 1])),   # not finite
        (np.array([2.0, 1.0]), np.array([3, 9])),      # outside the corpus
    ]
    ref = np.array([[2.0, 1.0]] * 6)
    exact = np.array([[2.0, 1.0], [2.0, 0.9], [0, 0], [0, 0], [0, 0],
                      [0, 0]])
    v, errs = check.numbers(answers, ref, exact, lost=1, top_k=2, n_docs=5)
    assert v["bad_answers"] == 4 and v["lost"] == 1
    assert v["score_err"] == 0.0
    # of the two well-formed answers, one misses rank 2 by 0.1
    assert v["rank_miss"] == 0.5
    assert errs[1] == (0.0, pytest.approx(0.1)) and errs[2] is None
    exact[1, 1] = 0.8
    v, _ = check.numbers(answers, ref, exact, 0, 2, 5)
    assert v["score_err"] == pytest.approx(0.125)
    # a gap within RANK_TOL is no miss
    near = [(np.array([2.0, 1.0 - 0.5 * check.RANK_TOL]), np.array([3, 1]))]
    assert check.numbers(near, ref[:1], ref[:1], 0, 2, 5)[0]["rank_miss"] == 0
    assert not check.verdict(v, {"lost": 0, "bad_answers": 0})
    assert check.verdict({"a": 1.0}, {"a": 1.0})


def test_binary_masked_page_scores_the_masked_value():
    codes = torch.tensor([[1, 1]])
    mask = torch.tensor([[False, False]])
    from portbench.reference import set_max
    out = set_max(torch.tensor([[[3, 5]]], dtype=torch.int32),
                  presence(codes, mask, 2), BINARY_MASKED)
    assert out.tolist() == [[[BINARY_MASKED]]]


def test_trace_summary_by_hand():
    device = [("void qmaxsim_kernel<unsigned char, 2, true>(Params, int)",
               0.0, 40.0),
              ("void qmaxsim_kernel<unsigned char, 2, true>(Params, int)",
               30.0, 60.0),
              ("Memcpy DtoH (Device -> Pageable)", 70.0, 80.0),
              ("void maxsim_kernel(Params)", 90.0, 130.0)]
    host = [("pb.search", 55.0, 75.0), ("pb.client", 60.0, 90.0),
            ("pb.stage", 85.0, 88.0)]
    s = trace.summarize(device, host, (10.0, 110.0))
    assert s.window_s == pytest.approx(100e-6)
    # busy: [10, 60] + [70, 80] + [90, 110] = 80 us
    assert s.busy_s == pytest.approx(80e-6)
    # each op's clipped time, summed: 30 + 30 us
    assert s.kernel_s["qmaxsim_kernel"] == pytest.approx(60e-6)
    assert s.kernel_s["maxsim_kernel"] == pytest.approx(20e-6)
    assert s.device_ops[0][0] == "qmaxsim_kernel"
    # idle [60, 70]: search; [80, 90]: stage 85-88, client the rest
    gaps = dict(s.idle_gaps)
    assert gaps["pb.search"] == pytest.approx(10e-6)
    assert gaps["pb.stage"] == pytest.approx(3e-6)
    assert gaps["pb.client"] == pytest.approx(7e-6)
    assert trace.summarize([], host, (0.0, 1.0)) is None


def test_host_spans_join_the_trace_on_the_cpu():
    spans = trace.HostSpans()
    p = trace.Profiler()
    p.start()
    done = []

    def work():
        with spans("pb.search"):
            done.append(torch.ones(10).sum())

    # a span on another thread, as the server's executor threads open it
    with ThreadPoolExecutor(1) as pool:
        pool.submit(work).result()
    p.stop()
    device, window = p.events()
    assert device == [] and window is not None and window[1] > window[0]
    host = spans.in_trace(p.t_open, window[0])
    assert [h[0] for h in host] == ["pb.search"]
    assert window[0] <= host[0][1] <= host[0][2] <= window[1]


def test_kernel_names():
    assert trace.kernel_name("void (anonymous namespace)::qmaxsim_kernel<"
                             "unsigned char, 2, true>(Params, int)") == \
        "qmaxsim_kernel"
    assert trace.kernel_name(
        "void at::native::elementwise_kernel<128, 2, at::native::"
        "gpu_kernel_impl_nocast<at::native::(anonymous namespace)::"
        "where_kernel_impl(at::TensorIterator&)>(int)") == \
        "at::native::elementwise_kernel[where]"
    assert trace.kernel_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH (Device -> Pageable)"


def test_page_corpus_chunks_are_drawn_again_alike():
    rule = corpus.CorpusRule(n_docs=40, n_patches=8, n_q_patches=3, dim=4)
    a = corpus.PageCorpus(rule, 5, "cpu", chunk_docs=16)
    b = corpus.PageCorpus(rule, 5, "cpu", chunk_docs=16)
    for (sa, xa, ta), (sb, xb, tb) in zip(a.chunks(), b.chunks()):
        assert sa == sb and torch.equal(xa, xb) and torch.equal(ta, tb)
    assert a.chunk(2)[1].shape == (8, 8, 4)
    x = a.chunk(0)[1]
    assert torch.allclose(torch.linalg.vector_norm(x, dim=-1),
                          torch.ones(16, 8))
    q, qm, qs = a.queries(5)
    assert q.shape == (5, 3, 4) and qm.all() and (qs >= 0.5).all()
    assert np.array_equal(q, b.queries(5)[0])
