"""Launch geometry of the four CUDA kernels and PAL01-PAL04
(``repro_torch.kernels.vmem``, ``repro_torch.analysis.pallas_check``).

  * the registered sites (the reference's, at this kernel's parameters,
    and the main path's) are clean against the sm_90 budget with the
    checked-in register table;
  * planted geometries make each rule fire: shared memory over 232,448 B
    (PAL01), a non-divisible block where one is required (PAL02), a grid
    that misses or doubles a range (PAL03), a float16 output (PAL04);
  * ``check_divisible`` raises ValueError, as the reference's;
  * under a ``FakeTensorMode`` each wrapper returns empty outputs of the
    shapes and dtypes its geometry declares, records the launch and
    counts none.

The card holds the Python geometry equal to each source's
``hpc_*_geometry`` export (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 14). Tolerance: exact.
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import pallas_check as pc
from repro_torch.kernels import vmem


def _codes(findings):
    return sorted({f.code for f in findings})


def test_registered_sites_are_clean():
    regs = pc.register_table()
    assert set(regs) == {"hamming_maxsim", "kmeans_assign", "maxsim",
                         "quantized_maxsim"}
    assert pc.check_all(registers=regs) == []
    names = [s.name for s in pc.kernel_sites()]
    assert len(names) == len(set(names))
    # the reference's nine sites, at this kernel's parameters
    for ref in ("qmaxsim_manifest", "qmaxsim_serving", "qmaxsim_k512",
                "maxsim_manifest", "maxsim_serving", "hamming_manifest",
                "hamming_serving", "kmeans_assign_default",
                "kmeans_assign_k512"):
        assert ref in names


@pytest.mark.parametrize("site", [s.name for s in pc.kernel_sites()])
def test_site_geometry_fits_and_covers(site):
    s = next(x for x in pc.kernel_sites() if x.name == site)
    g = s.geometry(vmem.Budget())
    assert g is not None
    assert 0 <= g.smem <= vmem.MAX_SMEM
    assert g.threads * pc.register_table()[pc._SOURCES[g.kernel]] \
        <= vmem.REGS_PER_SM
    assert tuple(dt for _, dt in g.outputs) == s.out_dtypes
    counts = pc.coverage_counts(g)
    assert counts.min() == 1 and counts.max() == 1
    name, args = s.c_call
    assert name.startswith("hpc_") and name.endswith("_geometry")


def _site(name):
    return next(x for x in pc.kernel_sites() if x.name == name)


def test_pal01_fires_on_shared_memory_and_registers():
    g = _site("qmaxsim_k512").geometry(vmem.Budget())
    big = dataclasses.replace(g, smem=vmem.MAX_SMEM + 16)
    f = pc.check_geometry(big, "planted", (torch.float32,))
    assert _codes(f) == ["PAL01"]
    assert str(vmem.MAX_SMEM) in f[0].msg and f[0].path.endswith(
        "quantized_maxsim.cu")
    # 256 threads x 257 registers > an SM's 65,536 (and > 255 a thread)
    f = pc.check_geometry(g, "planted", (torch.float32,),
                          registers={"quantized_maxsim": 257})
    assert _codes(f) == ["PAL01"] and len(f) == 2
    # a card with less shared memory than the geometry asks
    small = dataclasses.replace(vmem.Budget(), smem=g.smem - 1)
    assert _codes(pc.check_site(_site("qmaxsim_k512"), budget=small)) == \
        ["PAL01"]


def test_pal01_fires_when_the_launcher_refuses():
    # K = 4096 with Mq = 32: the tables of one query need 526 KB
    site = pc.qmaxsim_site("planted_huge_k", b=8, mq=32, k=4096, n=256,
                           md=128)
    f = pc.check_site(site, registers={})
    assert _codes(f) == ["PAL01"] and "shared memory" in f[0].msg


def test_pal02_fires_where_a_block_must_divide():
    g = _site("hamming_manifest").geometry(vmem.Budget())
    assert g.divisible == ()          # every launcher masks its ragged edge
    planted = dataclasses.replace(g, divisible=(("N", 1000, 256),))
    f = pc.check_geometry(planted, "planted", (torch.int32,))
    assert _codes(f) == ["PAL02"] and "1000" in f[0].msg
    ok = dataclasses.replace(g, divisible=(("N", 1024, 256),))
    assert pc.check_geometry(ok, "planted", (torch.int32,)) == []


def test_pal03_fires_on_a_missed_or_doubled_range():
    g = _site("hamming_manifest").geometry(vmem.Budget())
    short = dataclasses.replace(g, grid=(g.grid[0] - 1, g.grid[1]))
    f = pc.check_geometry(short, "planted", (torch.int32,))
    assert _codes(f) == ["PAL03"] and "never written" in f[0].msg
    # a persistent walk with a stride below its grid doubles a range
    m = _site("maxsim_manifest").geometry(vmem.Budget())
    f = pc.check_geometry(dataclasses.replace(m, step=m.grid[0] - 1),
                          "planted", (torch.float32,))
    assert _codes(f) == ["PAL03"] and "written 2 times" in f[0].msg
    k = _site("kmeans_assign_default").geometry(vmem.Budget())
    f = pc.check_geometry(dataclasses.replace(k, step=k.grid[0] // 2),
                          "planted", (torch.int32,))
    assert _codes(f) == ["PAL03"] and "multi-written" in f[0].msg
    # the per-range top-k: one list per (query, range)
    t = _site("qmaxsim_flat_sweep").geometry(vmem.Budget())
    f = pc.check_geometry(dataclasses.replace(t, grid=(t.grid[0], 1)),
                          "planted", (torch.float32, torch.int32))
    assert _codes(f) == ["PAL03"] and "list" in f[0].msg


def test_pal04_fires_on_a_float16_output():
    g = _site("maxsim_serving").geometry(vmem.Budget())
    planted = dataclasses.replace(
        g, outputs=((g.outputs[0][0], torch.float16),))
    f = pc.check_geometry(planted, "planted", (torch.float32,))
    assert _codes(f) == ["PAL04"] and "float16" in f[0].msg


def test_check_divisible_raises_value_error():
    vmem.check_divisible(1024, 256, kernel="k")
    with pytest.raises(ValueError, match="not divisible"):
        vmem.check_divisible(1000, 256, kernel="k")
    with pytest.raises(ValueError, match="positive"):
        vmem.check_divisible(1000, 0, kernel="k")
    with pytest.raises(ValueError, match="a block may use"):
        vmem.check_smem(vmem.MAX_SMEM + 1, kernel="k", detail="planted")


@pytest.mark.parametrize("b,n", [(1, 1), (3, 5), (8, 256), (8, 257),
                                 (64, 4_194_304)])
def test_hamming_geometry_covers_every_doc_once(b, n):
    from repro_torch.kernels import hamming
    r = hamming.launch_range_len(b, 32, n, 8, "cpu")
    g = vmem.hamming_geometry(b, 32, n, 615, 8, 0, r, 0)
    qpb = min(b, 32)
    assert g.grid == (-(-n // r), -(-b // qpb)) and g.threads == 256
    assert g.smem == vmem.hamming_smem_bytes(32, 8, r, qpb, False)
    if b * n <= 1 << 16:
        c = pc.coverage_counts(g)
        assert c.min() == 1 and c.max() == 1
    assert vmem.hamming_geometry(0, 32, n, 615, 8, 0, r, 0) is None
    with pytest.raises(ValueError):
        vmem.hamming_geometry(b, 32, n, 615, 17, 0, r, 0)


@pytest.mark.parametrize("n,d,k,sms,want", [
    # (rows per tile, n tiles per warp, codebook chunk, ring slots)
    (16_777_216, 128, 256, 132, (64, 8, 256, 2)),    # the build
    (256, 128, 256, 132, (32, 4, 256, 2)),           # a batch's query rows
    (16384, 128, 64, 132, (64, 8, 256, 2)),          # ivf routing at K=64
    (1024, 16, 32, 132, (64, 1, 32, 2)),             # K <= 32
])
def test_kmeans_geometry_picks_the_launchers_configuration(n, d, k, sms,
                                                           want):
    g = vmem.kmeans_assign_geometry(n, d, k, sms)
    assert g.config == want
    assert g.grid[0] == min(-(-n // want[0]), sms)
    assert g.smem <= vmem.MAX_SMEM
    c = pc.coverage_counts(g)
    assert c.min() == 1 and c.max() == 1


def test_maxsim_and_qmaxsim_refusals():
    with pytest.raises(ValueError, match="no configuration fits"):
        vmem.maxsim_geometry(0, 8, 257, 100, 16, 128, 8, 132)  # Mq > 256
    with pytest.raises(ValueError):
        vmem.qmaxsim_geometry(1, 8, 32, 256, 1000, 615, False, 128, 129, 2)
    assert vmem.qmaxsim_geometry(1, 8, 32, 256, 0, 615, False, 128, 10, 2) \
        is None
    # four queries a block on the shared corpus, one on per-query pools;
    # more (range, group) pairs than SMs: SMs // groups blocks a group
    g = vmem.qmaxsim_geometry(1, 8, 32, 256, 16384, 615, False, 256, 32, 4)
    assert g.config[0] == 4 and g.grid == (64, 2)
    g = vmem.qmaxsim_geometry(1, 8, 32, 256, 16384, 615, True, 256, 32, 4)
    assert g.config[0] == 1 and g.grid == (16, 8) and g.step == 16


@pytest.mark.parametrize("case,args,want", [
    # (grid, threads, shared bytes, (queries a block, body: 1 the code set,
    #  0 per slot, ranges a block walks, 0), step)
    ("flat sweep", (1, 8, 32, 256, 16384, 615, False, 256, 32, 4),
     ((64, 2), 512, 177152, (4, 1, 1, 0), 0)),
    ("flat cell launch", (1, 8, 32, 256, 4194304, 616, False, 256, 32, 4),
     ((66, 2), 512, 177152, (4, 1, 249, 0), 66)),
    ("flat cell launch on 114 SMs",
     (1, 8, 32, 256, 4194304, 616, False, 256, 32, 4, 114),
     ((57, 2), 512, 177152, (4, 1, 288, 0), 57)),
    ("flat sweep, 2 queries a block at most",
     (1, 8, 32, 256, 16384, 615, False, 256, 32, 2),
     ((33, 4), 512, 109056, (2, 1, 2, 0), 33)),
    ("rerank pools", (1, 8, 32, 256, 32, 1024, True, 2, 2, 4),
     ((16, 8), 512, 74000, (1, 1, 1, 0), 0)),
    ("serving block", (1, 8, 32, 256, 256, 128, False, 8, 0, 4),
     ((32, 2), 512, 173184, (4, 1, 1, 0), 0)),
    ("serve cell launch", (1, 64, 32, 256, 131072, 616, False, 256, 128, 4),
     ((8, 16), 512, 177152, (4, 1, 64, 0), 8)),
    ("K 64 pools", (1, 8, 32, 64, 4096, 615, True, 64, 32, 4),
     ((16, 8), 512, 49664, (1, 1, 4, 0), 16)),
    ("K 256 uint16 codes", (2, 8, 32, 256, 16384, 615, False, 256, 32, 4),
     ((64, 2), 512, 177152, (4, 1, 1, 0), 0)),
    ("K 512 uint16", (2, 8, 32, 512, 256, 128, False, 8, 0, 4),
     ((32, 4), 256, 140864, (2, 0, 1, 0), 0)),
    ("K 512 pools", (2, 8, 32, 512, 1024, 615, True, 32, 32, 4),
     ((32, 8), 256, 105856, (1, 0, 1, 0), 0)),
])
def test_qmaxsim_geometry_reports_its_body(case, args, want):
    """The code-set body for K <= 256, whatever the code width, the
    per-slot body above (``config[1]``, the export's out[5]): its block
    (16 warps and up to 4 queries, or 8 and 2), shared bytes (the tables,
    a half-warp's 256 flags and 256 offsets; the per-slot body's code rows
    grow with Md), and the ranges a block walks when the pairs outnumber
    the SMs (the per-slot grid is one range a block)."""
    g = vmem.qmaxsim_geometry(*args)
    assert (g.grid, g.threads, g.smem, g.config, g.step) == want
    assert g.config[1] == vmem.qmaxsim_body(args[3])
    cb, _, mq, k, _, md, _, r = args[:8]
    assert g.smem == vmem.qmaxsim_smem_bytes(cb, mq, k, md, r, g.config[0])
    if g.config[1]:             # the set's shared bytes do not grow with Md
        longer = (*args[:5], 4 * args[5], *args[6:])
        assert vmem.qmaxsim_geometry(*longer).smem == g.smem
    if g.grid[0] * g.grid[1] <= 1 << 16:
        c = pc.coverage_counts(g)
        assert c.min() == 1 and c.max() == 1


# --- the shape contract under fake tensors -----------------------------------------

def _fake_launches(fn):
    from repro_torch.kernels import hamming, kmeans_assign, maxsim
    from repro_torch.kernels import quantized_maxsim as qm
    mods = (hamming, kmeans_assign, maxsim, qm)
    before = [m.launches for m in mods]
    seen = []
    vmem._recorders.append(lambda g, shapes, fl, nb: seen.append((g, fl,
                                                                 nb)))
    try:
        with FakeTensorMode():
            out = fn()
    finally:
        vmem._recorders.pop()
    assert [m.launches for m in mods] == before     # nothing launched
    return out, seen


@pytest.mark.parametrize("kernel", ["quantized_maxsim", "quantized_topk",
                                    "maxsim", "maxsim_rows", "hamming",
                                    "kmeans_assign"])
def test_fake_launch_returns_the_declared_outputs(kernel):
    from repro_torch.kernels import hamming, kmeans_assign, maxsim
    from repro_torch.kernels import quantized_maxsim as qm
    dev = "cuda"

    def run():
        if kernel in ("quantized_maxsim", "quantized_topk"):
            t = torch.empty(8, 32, 256, device=dev)
            m = torch.empty(8, 32, device=dev)
            c = torch.empty(1000, 615, dtype=torch.uint8, device=dev)
            dm = torch.empty(1000, 615, dtype=torch.bool, device=dev)
            if kernel == "quantized_maxsim":
                return qm.quantized_maxsim_cuda(t, m, c, dm)
            return qm.quantized_maxsim_topk_cuda(t, m, c, dm, None, k=10)
        if kernel.startswith("maxsim"):
            q = torch.empty(8, 32, 128, device=dev)
            m = torch.empty(8, 32, device=dev)
            docs = torch.empty(100, 64, 128, device=dev)
            dm = torch.empty(100, 64, dtype=torch.bool, device=dev)
            rows = torch.empty(8, 48, dtype=torch.int32, device=dev) \
                if kernel == "maxsim_rows" else None
            return maxsim.maxsim_cuda(q, m, docs, dm, rows=rows)
        if kernel == "hamming":
            qc = torch.empty(8, 32, dtype=torch.int32, device=dev)
            c = torch.empty(300, 615, dtype=torch.uint16, device=dev)
            dm = torch.empty(300, 615, dtype=torch.bool, device=dev)
            return hamming.hamming_maxsim_cuda(qc, qc, c, dm, 8)
        x = torch.empty(5000, 128, device=dev)
        c = torch.empty(256, 128, device=dev)
        return kmeans_assign.kmeans_assign_cuda(x, c)

    out, seen = _fake_launches(run)
    outs = out if isinstance(out, tuple) else (out,)
    assert len(seen) == 1
    g, flops, nbytes = seen[0]
    assert tuple((tuple(t.shape), t.dtype) for t in outs) == tuple(
        (tuple(s), dt) for s, dt in g.outputs)
    assert all(t.device.type == "cuda" for t in outs)
    assert flops > 0 and nbytes > 0
    want = {"quantized_maxsim": ((8, 1000),),
            "quantized_topk": ((8, 32, 10), (8, 32, 10)),
            "maxsim": ((8, 100),), "maxsim_rows": ((8, 48),),
            "hamming": ((8, 300),), "kmeans_assign": ((5000,),)}[kernel]
    assert tuple(tuple(t.shape) for t in outs) == want


def test_real_cpu_tensors_never_take_the_fake_path():
    from repro_torch.kernels import maxsim
    q = torch.zeros(2, 4, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        maxsim.maxsim_cuda(q, torch.ones(2, 4), torch.zeros(3, 5, 16),
                           torch.ones(3, 5, dtype=torch.bool))
