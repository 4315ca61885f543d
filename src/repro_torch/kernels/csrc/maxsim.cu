// Float MaxSim late interaction for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/maxsim.py, maxsim_pallas (body
// _maxsim_kernel), the TPU kernel of the cascade's stage 3 (the exact
// rerank of the p2 survivors) and of the float_flat scan.
//
//   out[b, n] = sum_i qm[b, i] * max_{j : dm[n, j] != 0} <q[b, i], d[n, j]>
//
// in f32 through 3xTF32 on the tensor cores (tf32x3.cuh: within a few f32
// ulps of an f32 FMA chain). A masked patch counts as -1e30, so an
// all-masked document scores sum_i qm[b, i] * -1e30, finite.
//
// Three layouts: a shared corpus (N, Md, D), every query against every
// document; per-query pools (B, P, Md, D) through a batch stride; and
// candidate rows: a corpus of N positions with rows (B, P) of int32 corpus
// positions, each read through its id, so the cascade's stage 3 makes no
// (B, P, Md, D) copy. The rows' corpus is a segment table: up to
// kMaxSegments tensors (cap_s, Md, D) with their masks, position r lying
// in the last segment whose start is <= r, at r - start. A monolithic
// corpus is the one-entry table; a segmented live index (appended
// segments of several capacities) is read in place, with no gather. A -1
// slot scores -1e30 (the scan's sentinel for an empty slot); an id >= N
// is never read and scores NaN.
//
// What bounds it on the H100: stage 3 (B=8, Mq=32, D=128, 64 candidates x
// Md=615 per query) reads 161 MB of float patches for 2.58 GFLOP: 48 us
// at 3.35 TB/s, 15.6 us for 3xTF32 at 495 TFLOP/s, so bytes. One
// shared-corpus block of float_flat (256 docs for all 8 queries) is 10.3
// GFLOP against 80.6 MB: 62 us for 3xTF32 (154 us in f32 FMAs), 24 us of
// bytes, so operations.
//
// Design: document patches are the M side of mma.sync m16n8k8 (16-row
// tiles, the ragged Md masked) and query patches the N side (8-row tiles;
// Mq 5 or 40 padded with zero rows and left out of the sum), in 3xTF32
// (tf32x3.cuh). A block holds a group of whole queries in shared memory
// and streams its documents' patches in chunks through a two-slot ring of
// cp.async copies (rows padded and swizzled as tf32x3.cuh says), the next
// chunk loading while this one computes; a third slot measured no faster.
// Each warp owns one 32-row query chunk (4 n tiles) and MT m
// tiles of each document chunk; it folds its valid patches into a running
// max per query row in the accumulator layout, with the mask prefetched
// into registers one chunk ahead. At a document's end a shuffle max over
// the 8 row groups, a max across the warps that share a query chunk, the
// products qm * max in parallel, and one thread per query summing them in
// ascending query order give the score.
//
// Shared corpus: one block serves every query of its group (up to 8
// query chunks: B * Mq <= 256 query rows in one group at Mq = 32), so each
// document is read from device memory once; the (B, doc) grid of the
// earlier design read it once per query, through L2 (8 x 80.6 MB per
// float_flat block), and its time is measured beside this one
// (max_qpb = 1). Its 256 query rows stay f32 and each B fragment is split
// as it is loaded. Per-query pools and candidate rows: one query per block
// (grid.y = B), 8 warps on 8 m tiles of a 128-patch chunk, and the query's
// rows split into hi and lo once, in shared memory, beside the ring. Both
// grids are persistent (no more blocks than fit on the card at once), each
// block walking its documents with the ring running on across them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQChunk = 32;           // query rows per warp: 4 n tiles
constexpr float kNegInf = -1e30f;
constexpr int kMaxDynamicSmem = 232448;
constexpr int kMaxSegments = 32;      // entries of the rows' segment table

enum Layout { kShared = 0, kPerQuery = 1, kRows = 2 };

struct Params {
  const float* q;          // (B, Mq, D)
  const float* qm;         // (B, Mq)
  const float* docs;       // (N, Md, D) or (B, P, Md, D)
  const uint8_t* d_mask;   // (N, Md) or (B, P, Md)
  const int32_t* rows;     // (B, P) with batch stride rows_bstride
  float* out;              // (B, n_out)
  int b, mq, n_out, md, d, n_corpus;
  long long docs_bstride, mask_bstride, rows_bstride;
  int layout;
  // the rows layout's corpus: segment s holds positions seg_start[s] ..
  // seg_start[s + 1] - 1 (the last up to n_corpus); starts ascend
  int n_seg;
  const float* seg_docs[kMaxSegments];     // (cap_s, Md, D)
  const uint8_t* seg_mask[kMaxSegments];   // (cap_s, Md)
  int seg_start[kMaxSegments];
  int qpb;      // queries per block
  int mg;       // warps along the patches (kWarps / query chunks per block)
  int stages;   // chunks in the ring (1 or 2)
  bool vec;
};

struct Doc {
  const float* p;
  const uint8_t* m;
};

// A position in a block's stream of document chunks: its i-th document
// (i == n_docs: the stream has ended) and chunk c of it.
struct Item {
  int i, c;
};

// PRE: the block's query rows are split into hi and lo once, in shared
// memory (when both fit beside the ring); else each B fragment is split as
// it is loaded.
template <int MT, bool PRE>
__global__ void __launch_bounds__(kThreads, 1) maxsim_kernel(const Params p) {
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_width(p.d);
  const int qcn = (p.mq + kQChunk - 1) / kQChunk;   // chunks per query
  const int qg_max = p.qpb * qcn;                    // chunks per block
  const int qrows = qg_max * kQChunk;
  const int cr = p.mg * MT * 16;                     // patches per chunk
  float* s_q = smem;                                 // (qrows, dp): f32/hi
  float* s_ql = s_q + (size_t)qrows * dp;            // (qrows, dp) if PRE
  float* s_d = s_ql + (PRE ? (size_t)qrows * dp : 0);  // (stages, cr, dp)
  float* s_max = s_d + (size_t)p.stages * cr * dp;   // (mg, qrows)
  float* s_val = s_max + (size_t)p.mg * qrows;       // (qrows,)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b0 = blockIdx.y * p.qpb;
  const int nq = min(p.qpb, p.b - b0);
  const int wq = warp % qg_max;          // this warp's query chunk
  const int wg = warp / qg_max;          // ... and patch group
  const bool active = wg < p.mg && wq < nq * qcn;
  const int n_chunks = (p.md + cr - 1) / cr;

  // the block's documents: columns blockIdx.x + i * gridDim.x of out
  const int n_docs = p.n_out > (int)blockIdx.x
      ? (p.n_out - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  auto col_of = [&](int i) { return (int)blockIdx.x + i * (int)gridDim.x; };
  auto id_of = [&](int i) {
    return __ldg(p.rows + (long long)b0 * p.rows_bstride + col_of(i));
  };
  auto doc_of = [&](int i) {
    long long pos = col_of(i);
    const float* base = p.docs;
    const uint8_t* mbase = p.d_mask;
    if (p.layout == kRows) {
      // the segment of position pos: a select over the whole table with
      // constant indices, so the table stays in the parameter bank
      pos = id_of(i);
      int start = 0;
      base = p.seg_docs[0];
      mbase = p.seg_mask[0];
#pragma unroll
      for (int s = 1; s < kMaxSegments; ++s)
        if (s < p.n_seg && pos >= p.seg_start[s]) {
          base = p.seg_docs[s];
          mbase = p.seg_mask[s];
          start = p.seg_start[s];
        }
      pos -= start;
    } else if (p.layout == kPerQuery) {
      base += b0 * p.docs_bstride;
      mbase += b0 * p.mask_bstride;
    }
    return Doc{base + pos * p.md * p.d, mbase + pos * p.md};
  };
  auto next_valid = [&](int i) {  // the first document >= i that is read
    if (p.layout == kRows)
      for (; i < n_docs; ++i) {
        const int id = id_of(i);
        if (id >= 0 && id < p.n_corpus) break;
      }
    return i < n_docs ? i : n_docs;
  };
  auto next = [&](Item it) {
    return it.c + 1 < n_chunks ? Item{it.i, it.c + 1}
                               : Item{next_valid(it.i + 1), 0};
  };

  // empty slots (-1e30) and ids past the corpus (NaN) are written here and
  // skipped by the stream
  if (p.layout == kRows) {
    for (int i = threadIdx.x; i < n_docs; i += kThreads) {
      const int id = id_of(i);
      if (id < 0 || id >= p.n_corpus)
        p.out[(long long)b0 * p.n_out + col_of(i)] = id < 0 ? kNegInf : NAN;
    }
  }
  Item cur{next_valid(0), 0};
  if (cur.i >= n_docs) return;

  // the block's query rows: chunk w holds rows (w % qcn) * 32 .. of query
  // b0 + w / qcn; rows past Mq or past the group are zeros
  for (int w = 0; w < qg_max; ++w) {
    const int qb = b0 + w / qcn;
    const int i0 = (w % qcn) * kQChunk;
    const int rows = w < nq * qcn ? min(kQChunk, p.mq - i0) : 0;
    stage_rows<kThreads>(s_q + (size_t)w * kQChunk * dp,
                         rows ? p.q + ((long long)qb * p.mq + i0) * p.d : p.q,
                         kQChunk, rows, p.d, dp, p.vec);
  }

  // mask bytes of this thread's patch rows (wg*MT*16 + mt*16 + g, + 8) of
  // a chunk, loaded from a clamped position and kept as loaded, tested only
  // where the next chunk uses them, so the loads stay in flight across the
  // compute of this chunk (a test here would wait for them)
  auto row_of = [&](int chunk, int mt, int h) {
    return chunk * cr + wg * MT * 16 + mt * 16 + h * 8 + g;
  };
  // a document's base pointers are found once per document (doc_d: the
  // document of the chunk being staged), not once per chunk: the rows
  // layout's segment lookup is a select over the whole table
  auto load_mask = [&](const Doc& doc, int c, int (&m)[MT][2]) {
    if (!active) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        m[mt][h] = __ldg(doc.m + min(row_of(c, mt, h), p.md - 1));
  };
  auto stage_chunk = [&](const Doc& doc, int c, int slot) {
    const int j0 = c * cr;
    stage_rows<kThreads>(s_d + (size_t)slot * cr * dp,
                         doc.p + (long long)j0 * p.d, cr, p.md - j0, p.d, dp,
                         p.vec);
  };

  Doc doc_d = doc_of(cur.i);
  stage_chunk(doc_d, cur.c, 0);
  cp_async_commit();
  int m_cur[MT][2], m_next[MT][2] = {};
  load_mask(doc_d, cur.c, m_next);

  float run[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) run[nt][0] = run[nt][1] = kNegInf;
  // every row this thread reads is g mod 8: one swizzle for all
  const int sw = swizzle(g, dp);

  for (int k = 0;; ++k) {
    const Item nxt = next(cur);
    const bool more = nxt.i < n_docs;
    cp_async_wait_all();
    __syncthreads();  // chunk k is in; the other slot is free
    if (PRE && k == 0) {  // the query rows, split once
      uint32_t* hi = reinterpret_cast<uint32_t*>(s_q);
      uint32_t* lo = reinterpret_cast<uint32_t*>(s_ql);
      for (int e = threadIdx.x; e < qrows * dp; e += kThreads)
        split(s_q[e], hi[e], lo[e]);
      __syncthreads();
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      m_cur[mt][0] = m_next[mt][0];
      m_cur[mt][1] = m_next[mt][1];
    }
    if (more && nxt.i != cur.i) doc_d = doc_of(nxt.i);
    if (more) load_mask(doc_d, nxt.c, m_next);
    if (p.stages == 2 && more) {
      stage_chunk(doc_d, nxt.c, (k + 1) & 1);
      cp_async_commit();
    }

    if (active) {
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      const int slot = p.stages == 2 ? k & 1 : 0;
      const float* ap = s_d + ((size_t)slot * cr + wg * MT * 16 + g) * dp
                        + 4 * t;
      const size_t bq = (size_t)(wq * kQChunk + g) * dp + 4 * t;
      for (int d0 = 0; d0 < dp; d0 += 16) {
        const int col = d0 ^ sw;
        float4 av[MT][2], bv[4], bl[4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          av[mt][0] = *reinterpret_cast<const float4*>(
              ap + (size_t)(mt * 16) * dp + col);
          av[mt][1] = *reinterpret_cast<const float4*>(
              ap + (size_t)(mt * 16 + 8) * dp + col);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          bv[nt] = *reinterpret_cast<const float4*>(
              s_q + bq + (size_t)(nt * 8) * dp + col);
          if (PRE)
            bl[nt] = *reinterpret_cast<const float4*>(
                s_ql + bq + (size_t)(nt * 8) * dp + col);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t a_hi[MT][4], a_lo[MT][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            split_a(h ? hi2(av[mt][0]) : lo2(av[mt][0]),
                    h ? hi2(av[mt][1]) : lo2(av[mt][1]), a_hi[mt], a_lo[mt]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float2 v = h ? hi2(bv[nt]) : lo2(bv[nt]);
            if (PRE) {
              const float2 w = h ? hi2(bl[nt]) : lo2(bl[nt]);
              b_hi[nt][0] = __float_as_uint(v.x);
              b_hi[nt][1] = __float_as_uint(v.y);
              b_lo[nt][0] = __float_as_uint(w.x);
              b_lo[nt][1] = __float_as_uint(w.y);
            } else {
              split_b(v, b_hi[nt], b_lo[nt]);
            }
          }
          mma3_tiles<MT, 4>(acc, a_hi, a_lo, b_hi, b_lo);
        }
      }
      // acc[mt][nt]: patch rows g (e 0, 1) and g + 8 (e 2, 3), query
      // columns 2t and 2t + 1 of n tile nt
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row_of(cur.c, mt, h) < p.md && m_cur[mt][h] != 0) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              run[nt][0] = fmaxf(run[nt][0], acc[mt][nt][2 * h]);
              run[nt][1] = fmaxf(run[nt][1], acc[mt][nt][2 * h + 1]);
            }
          }
    }

    if (cur.c == n_chunks - 1) {  // the document's last chunk: its scores
      if (active) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v = run[nt][j];
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
            if (g == 0)
              s_max[(size_t)wg * qrows + wq * kQChunk + nt * 8 + 2 * t + j] = v;
            run[nt][j] = kNegInf;
          }
      }
      __syncthreads();
      // qm * max per query row in parallel, then one thread per query sums
      // them in ascending order
      for (int r = threadIdx.x; r < nq * p.mq; r += kThreads) {
        const int qb = r / p.mq;
        const int i = r - qb * p.mq;
        const int row = (qb * qcn + i / kQChunk) * kQChunk + i % kQChunk;
        float m = s_max[row];
        for (int w = 1; w < p.mg; ++w)
          m = fmaxf(m, s_max[(size_t)w * qrows + row]);
        s_val[r] = p.qm[(long long)b0 * p.mq + r] * m;
      }
      __syncthreads();
      if (threadIdx.x < nq) {
        const float* v = s_val + threadIdx.x * p.mq;
        float total = 0.f;
        for (int i = 0; i < p.mq; ++i) total += v[i];
        p.out[(long long)(b0 + threadIdx.x) * p.n_out + col_of(cur.i)] =
            total;
      }
    }

    if (p.stages == 1 && more) {
      __syncthreads();  // everyone is done with the slot
      stage_chunk(doc_d, nxt.c, 0);
      cp_async_commit();
    }
    if (!more) break;
    cur = nxt;
  }
}

template <int MT, bool PRE>
cudaError_t launch(const Params& prm, dim3 grid, long long smem,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      maxsim_kernel<MT, PRE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (attr != cudaSuccess) return attr;
  maxsim_kernel<MT, PRE><<<grid, kThreads, (size_t)smem, stream>>>(prm);
  return cudaGetLastError();
}

// m tiles per warp: 4 / (warps along the patches), at least 1, so a chunk
// is 64 patches (128 with all 8 warps on one query chunk)
int m_tiles(int mg) { return mg >= 4 ? 1 : 4 / mg; }

long long smem_bytes(int d, int qpb, int qcn, int mg, int stages, bool pre) {
  const long long dp = tf32x3::padded_width(d);
  const long long qrows = (long long)qpb * qcn * kQChunk;
  const long long cr = (long long)mg * m_tiles(mg) * 16;
  return ((pre ? 2 : 1) * qrows * dp + stages * cr * dp + mg * qrows +
          qrows) * (long long)sizeof(float);
}

struct Config {
  int qpb, mg, stages;
  bool pre;
  long long smem;
};

// Queries per block, query split and ring depth: for the shared corpus as
// many whole queries as 8 warps hold (one 32-row query chunk each, at most
// max_qpb), per-query layouts one query; then the query split once when
// it fits, and the deeper ring (2 chunks, else 1) that fits; then fewer
// queries. Returns false when nothing fits.
bool choose(int layout, int b, int mq, int d, int max_qpb, Config* cfg) {
  const int qcn = (mq + kQChunk - 1) / kQChunk;
  if (qcn > kWarps || max_qpb < 1) return false;
  int top = layout == kShared ? (kWarps / qcn < b ? kWarps / qcn : b) : 1;
  if (top > max_qpb) top = max_qpb;
  for (int q = top; q >= 1; --q) {
    const int m = kWarps / (q * qcn);
    for (int pre = 1; pre >= 0; --pre)
      for (int st = 2; st >= 1; --st) {
        const long long s = smem_bytes(d, q, qcn, m, st, pre);
        if (s <= kMaxDynamicSmem) {
          *cfg = Config{q, m, st, pre != 0, s};
          return true;
        }
      }
  }
  return false;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch in this layout and shape, or -1 when
// none fits (Mq > 256, or D too wide).
long long hpc_maxsim_smem_bytes(int layout, int b, int mq, int d) {
  Config cfg;
  if (b <= 0 || mq <= 0 || d <= 0 || !choose(layout, b, mq, d, kWarps, &cfg))
    return -1;
  return cfg.smem;
}

// The launch hpc_maxsim makes at these shapes: out[0..7] = grid.x, grid.y,
// threads per block, dynamic shared bytes, queries per block, warps along
// the patches, ring slots, whether the query rows are split once. Returns
// 0, or -1 when it launches nothing or refuses them.
int hpc_maxsim_geometry(int layout, int b, int mq, int n_out, int md, int d,
                        int max_qpb, int sm_count, long long* out) {
  Config cfg;
  if (b <= 0 || n_out <= 0 || mq <= 0 || md <= 0 || sm_count <= 0 ||
      layout < 0 || layout > 2 || !choose(layout, b, mq, d, max_qpb, &cfg))
    return -1;
  const int groups = (b + cfg.qpb - 1) / cfg.qpb;
  int per_group = sm_count / groups;
  if (per_group < 1) per_group = 1;
  if (groups > 65535) return -1;
  const long long v[8] = {n_out < per_group ? n_out : per_group, groups,
                          kThreads, cfg.smem, cfg.qpb, cfg.mg, cfg.stages,
                          cfg.pre ? 1 : 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// Returns a cudaError_t (0 on success). q (B, Mq, D) f32 contiguous, qm
// (B, Mq) f32, masks 1 byte per patch, out (B, n_out) f32. layout 0:
// docs (N, Md, D), n_out = N; 1: docs (B, P, Md, D) with batch strides
// (elements), n_out = P; 2: rows (B, P) int32 with batch stride
// rows_bstride, n_out = P, into the n_seg-entry segment table (seg_docs,
// seg_mask, ascending seg_start from 0; 1 <= n_seg <= 32) of n_corpus
// positions; docs and d_mask are not read. Needs Md >= 1. max_qpb caps
// the queries a block serves on the shared corpus (1 gives the (B, doc)
// grid of the earlier design, kept for timing beside it).
int hpc_maxsim(const float* q, const float* qm, const float* docs,
               const uint8_t* d_mask, const int32_t* rows, float* out,
               int layout, int b, int mq, int n_out, int md, int d,
               int n_corpus, long long docs_bstride, long long mask_bstride,
               long long rows_bstride, int n_seg,
               const float* const* seg_docs, const uint8_t* const* seg_mask,
               const int* seg_start, int max_qpb, int sm_count,
               void* stream) {
  if (b <= 0 || n_out <= 0) return 0;
  Config cfg;
  if (mq <= 0 || md <= 0 || sm_count <= 0 || layout < 0 || layout > 2 ||
      (layout == kRows &&
       (rows == nullptr || n_seg < 1 || n_seg > kMaxSegments ||
        seg_start == nullptr || seg_start[0] != 0)) ||
      !choose(layout, b, mq, d, max_qpb, &cfg))
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = d % 4 == 0 && docs_bstride % 4 == 0 &&
             reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (layout == kRows) {
    for (int s = 0; s < n_seg; ++s)
      vec = vec && reinterpret_cast<uintptr_t>(seg_docs[s]) % 16 == 0;
  } else {
    vec = vec && reinterpret_cast<uintptr_t>(docs) % 16 == 0;
  }
  Params prm{};
  prm.q = q;
  prm.qm = qm;
  prm.docs = docs;
  prm.d_mask = d_mask;
  prm.rows = rows;
  prm.out = out;
  prm.b = b;
  prm.mq = mq;
  prm.n_out = n_out;
  prm.md = md;
  prm.d = d;
  prm.n_corpus = n_corpus;
  prm.docs_bstride = docs_bstride;
  prm.mask_bstride = mask_bstride;
  prm.rows_bstride = rows_bstride;
  prm.layout = layout;
  prm.n_seg = layout == kRows ? n_seg : 0;
  for (int s = 0; s < prm.n_seg; ++s) {
    prm.seg_docs[s] = seg_docs[s];
    prm.seg_mask[s] = seg_mask[s];
    prm.seg_start[s] = seg_start[s];
  }
  prm.qpb = cfg.qpb;
  prm.mg = cfg.mg;
  prm.stages = cfg.stages;
  prm.vec = vec;
  // persistent: at most one block per SM in all (shared memory allows no
  // second)
  const int groups = (b + cfg.qpb - 1) / cfg.qpb;
  int per_group = sm_count / groups;
  if (per_group < 1) per_group = 1;
  const dim3 grid(n_out < per_group ? n_out : per_group, groups);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mt = m_tiles(cfg.mg);
  cudaError_t err;
  if (cfg.pre)
    err = mt == 4 ? launch<4, true>(prm, grid, cfg.smem, s)
        : mt == 2 ? launch<2, true>(prm, grid, cfg.smem, s)
                  : launch<1, true>(prm, grid, cfg.smem, s);
  else
    err = mt == 4 ? launch<4, false>(prm, grid, cfg.smem, s)
        : mt == 2 ? launch<2, false>(prm, grid, cfg.smem, s)
                  : launch<1, false>(prm, grid, cfg.smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
