// Fused ADC MaxSim with a per-range top-k, for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: src/repro/kernels/quantized_maxsim.py, quantized_maxsim_pallas
// (body _qmaxsim_kernel), the TPU kernel that scores every query of the
// flat scan, of the facade rerank and of the cascade's stage 2.
//
//   out[b, n] = sum_i qm[b, i] * max_{j : dm[n, j] != 0} T[b, i, codes[n, j]]
//
// with T = Q C^T the (B, Mq, K) query x centroid table. A masked patch, and
// a code >= K, counts as -1e30, so an all-masked document scores
// sum_i qm[b, i] * -1e30.
//
// What bounds it on the H100: shared-memory load wavefronts. Every masked
// max-lookup reads one table value, and the SM's shared memory serves one
// 128-byte wavefront, 32 four-byte loads, per clock. A 16384-doc x 8-query
// sweep at Md=615, Mq=32 is 2.58e9 lookups, 8.06e7 wavefronts of 32:
// 0.309 ms over 132 SMs at 1980 MHz. The bytes (10 MB of codes, 10 MB of
// mask, read once) would take 6 us and the f32 max/FMA work less. On the
// card the loop is held by the instructions it issues per lookup as much
// as by that rate (PERF.md), so the design cuts both.
//
// Design, and how it reaches that bound:
// - The table is staged in shared memory transposed, (K + 1, 32) per chunk
//   of 32 query patches. One document goes to a half-warp, and lane l of
//   it owns query patches 2l and 2l + 1. The half-warp walks the
//   document's patches; its lanes get the same code c as a broadcast and
//   read T[c][2l : 2l + 2] with one 8-byte load: 16 lanes x 8 bytes, one
//   table row, no bank conflict. A load instruction thus serves 64
//   lookups (two documents) in two wavefronts, and each address add two.
// - Row K holds -1e30. Masked slots and codes >= K are mapped to it when
//   the codes are staged, so the inner loop has no branch: each code is an
//   address add, a shared load and two maxes, in independent max chains.
// - On the shared corpus a block takes two queries (they read the same
//   codes): their tables are interleaved row by row, (K + 1, 2, 32), so one
//   staged code and one address serve both lookups, the second at an
//   immediate offset. That saves the code staging, the broadcast and the
//   address add of every second lookup. Per-query pools take one query a
//   block.
// - Each half-warp stages its document's codes from device memory as
//   16-byte vectors, coalesced, and writes them to its own shared row as
//   byte offsets into the table. A 16-byte code word goes to int4 slots
//   p * Wp + w (part p of word w), so the lanes' stores fall on consecutive
//   slots without conflict; the order of the lookups does not matter to a
//   max. The row is read back four offsets per broadcast load. The mask is
//   read the same way and overwrites the masked slots with the sentinel.
// - Mq > 32 loops over chunks of 32 query patches and adds the chunks'
//   partials in order; for Mq < 32 the idle patches have q_mask 0.
// - The sweep: a block scores a contiguous range of R positions (grid
//   (ranges, query groups)), sets slots with valid = 0 to -1e30 (the
//   scan's NEG_INF), and writes each query's top min(k, R) of the range as
//   (score, position) pairs ordered by score descending, then position
//   ascending. Each thread ranks one slot exactly,
//   #(s_j > s_i) + #(s_j == s_i, j < i), so the stable order needs no
//   sort. An invalid slot keeps its score and gets position -1; a range
//   shorter than k is padded with (-inf, -1). The caller picks R from the
//   shape and merges the ranges' lists once: one launch per sweep, not one
//   per block of documents. The scores-only entry writes the (B, N)
//   scores from the same scoring core.
//
// Codes (uint8, or uint16 for K > 256) and the 1-byte mask are read as
// stored. Strides give both layouts: batch stride 0 for the shared corpus
// (N, Md), P*Md (or a pool slice's own) for per-query pools (B, P, Md).
// No TMA and no persistence yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHalves = 2 * kWarps;            // one document per half-warp
constexpr int kMaxRange = 256;
constexpr float kNegInf = -1e30f;
constexpr int kScratch = 32 * 33;              // padded transpose tile
constexpr int kMaxDynamicSmem = 232448;        // 227 KB, the most a block may use

// Geometry of one half-warp's staged code row for codes of type CodeT: a 16-byte
// word holds kPer codes, split into kParts int4 slots of 4 byte offsets.
template <typename CodeT>
struct RowGeom {
  static constexpr int kPer = 16 / sizeof(CodeT);
  static constexpr int kParts = kPer / 4;
  // words a document's codes can touch, whatever their alignment, rounded
  // up to an even count so the inner loop reads slots in pairs
  static __host__ __device__ int words(int md) {
    const int w = (md + 2 * kPer - 2) / kPer;
    return w + (w & 1);
  }
  static __host__ __device__ int row_ints(int md) { return kPer * words(md); }
};

struct Params {
  const float* table;
  const float* q_mask;
  const void* codes;
  const uint8_t* d_mask;
  const uint8_t* valid;  // null: every slot valid
  float* out_s;          // topk: (B, ranges, top_k); scores: (B, N)
  int* out_p;            // topk: (B, ranges, top_k)
  int mq, k, n, md, n_chunks, range_len, top_k;
  long long codes_bstride, mask_bstride, valid_bstride;
};

// Element t of a 16-byte word holding elements of type T, read with shifts
// (t is a constant after unrolling, so no local-memory copy of the word).
template <typename T>
__device__ __forceinline__ int elem(const uint4& v, int t) {
  constexpr int kPerWord = 4 / sizeof(T);
  constexpr int kBits = 8 * sizeof(T);
  const int i = t / kPerWord;
  const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  return static_cast<int>((w >> (kBits * (t % kPerWord))) &
                          ((1u << kBits) - 1u));
}

__device__ __forceinline__ bool has_zero_byte(uint32_t x) {
  return ((x - 0x01010101u) & ~x & 0x80808080u) != 0u;
}

__device__ __forceinline__ float lookup(const char* tab, int off) {
  return *reinterpret_cast<const float*>(tab + off);
}

// kQ queries per block share every staged code: their tables are
// interleaved row by row, (K + 1, kQ, 32) per chunk, so one byte offset
// serves all kQ lookups of a code (the others at immediate offsets).
template <typename CodeT, int kQ, bool kTopK>
__global__ void __launch_bounds__(kThreads, 4 / kQ)
qmaxsim_kernel(const Params p, int b_count) {
  using G = RowGeom<CodeT>;
  extern __shared__ __align__(16) float smem[];
  const int k = p.k;
  const int row_floats = kQ * 32;                  // one table row, kQ queries
  const int chunk_floats = (k + 1) * row_floats;
  float* s_tab = smem;                             // (n_chunks, K+1, kQ, 32)
  float* s_qm = s_tab + (size_t)p.n_chunks * chunk_floats;  // (kQ, n_chunks*32)
  int* s_rows = reinterpret_cast<int*>(s_qm + kQ * p.n_chunks * 32);
  const int row_ints = G::row_ints(p.md);
  const int rows_ints = max(kHalves * row_ints, kScratch);
  float* s_score = reinterpret_cast<float*>(s_rows + rows_ints);  // (kQ, R)

  const int b0 = blockIdx.y * kQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // -- stage T[b0 + q] transposed, through a padded 32 x 33 tile ----------
  float* scratch = reinterpret_cast<float*>(s_rows);
  for (int q = 0; q < kQ; ++q) {
    const bool live = b0 + q < b_count;
    const float* tab_b = p.table + (size_t)(live ? b0 + q : 0) * p.mq * k;
    for (int ch = 0; ch < p.n_chunks; ++ch) {
      float* dst = s_tab + (size_t)ch * chunk_floats + q * 32;
      for (int c0 = 0; c0 < k; c0 += 32) {
        for (int r = warp; r < 32; r += kWarps) {  // r: query patch of the chunk
          const int i = ch * 32 + r, c = c0 + lane;
          scratch[r * 33 + lane] = (live && i < p.mq && c < k)
                                       ? tab_b[(size_t)i * k + c] : 0.f;
        }
        __syncthreads();
        for (int r = warp; r < 32; r += kWarps) {  // r: code of the tile
          if (c0 + r < k)
            dst[(size_t)(c0 + r) * row_floats + lane] = scratch[lane * 33 + r];
        }
        __syncthreads();
      }
      if (threadIdx.x < 32) dst[(size_t)k * row_floats + threadIdx.x] = kNegInf;
    }
    for (int t = threadIdx.x; t < p.n_chunks * 32; t += kThreads)
      s_qm[q * p.n_chunks * 32 + t] =
          live && t < p.mq ? p.q_mask[(size_t)(b0 + q) * p.mq + t] : 0.f;
  }
  __syncthreads();

  // -- score the range, one document per half-warp at a time --------------
  // Lane l of a half-warp owns query patches 2l and 2l + 1 and reads both
  // with one 8-byte load: a load instruction serves 64 lookups of two
  // documents, and each staged code's address add serves two lookups.
  const int row_bytes = row_floats * (int)sizeof(float);
  const int sentinel = k * row_bytes;          // byte offset of row K
  const int wp = G::words(p.md);
  const int half = threadIdx.x >> 4;           // 0 .. kHalves - 1
  const int hl = threadIdx.x & 15;             // lane within the half-warp
  const unsigned hmask = 0xffffu << (threadIdx.x & 16);
  int* row = s_rows + (size_t)half * row_ints;
  int4* row4 = reinterpret_cast<int4*>(row);
  const int r0 = blockIdx.x * p.range_len;
  const int len = min(p.range_len, p.n - r0);
  // kQ > 1 only for the shared layout (batch strides 0)
  const CodeT* codes_b = static_cast<const CodeT*>(p.codes) + b0 * p.codes_bstride;
  const uint8_t* mask_b = p.d_mask + b0 * p.mask_bstride;

  for (int d = half; d < len; d += kHalves) {
    const long long doc = (long long)r0 + d;
    // codes: aligned 16-byte words covering the row; out-of-row elements
    // and codes >= K become the sentinel
    const uintptr_t ca = reinterpret_cast<uintptr_t>(codes_b + doc * p.md);
    const int head = static_cast<int>((ca & 15u) / sizeof(CodeT));
    const uint4* cw = reinterpret_cast<const uint4*>(ca - (ca & 15u));
    const int c_words = (head + p.md + G::kPer - 1) / G::kPer;
    for (int w = hl; w < wp; w += 16) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (w < c_words) v = __ldg(cw + w);
      int off[G::kPer];
#pragma unroll
      for (int t = 0; t < G::kPer; ++t) {
        const int j = w * G::kPer + t - head;
        const int c = elem<CodeT>(v, t);
        off[t] = (j >= 0 && j < p.md && c < k) ? c * row_bytes : sentinel;
      }
#pragma unroll
      for (int q = 0; q < G::kParts; ++q)
        row4[q * wp + w] = make_int4(off[4 * q], off[4 * q + 1],
                                     off[4 * q + 2], off[4 * q + 3]);
    }
    __syncwarp(hmask);
    // mask: a zero byte sends its slot to the sentinel row
    const uintptr_t ma = reinterpret_cast<uintptr_t>(mask_b + doc * p.md);
    const int m_head = static_cast<int>(ma & 15u);
    const uint4* mw = reinterpret_cast<const uint4*>(ma - (ma & 15u));
    const int m_words = (m_head + p.md + 15) / 16;
    for (int w = hl; w < m_words; w += 16) {
      const uint4 v = __ldg(mw + w);
      if (!(has_zero_byte(v.x) || has_zero_byte(v.y) || has_zero_byte(v.z) ||
            has_zero_byte(v.w)))
        continue;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int j = w * 16 + t - m_head;
        if (j >= 0 && j < p.md && elem<uint8_t>(v, t) == 0) {
          const int qq = j + head;
          const int cw_i = qq / G::kPer, ct = qq % G::kPer;
          row[((ct >> 2) * wp + cw_i) * 4 + (ct & 3)] = sentinel;
        }
      }
    }
    __syncwarp(hmask);

    // lookups: for each code, kQ 8-byte loads at one address (immediate
    // offsets), into independent max chains
    constexpr int kChains = 4 / kQ;
    const int n_slots = G::kParts * wp;        // even
    float acc[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] = 0.f;
    for (int ch = 0; ch < p.n_chunks; ++ch) {
      const char* tab = reinterpret_cast<const char*>(
          s_tab + (size_t)ch * chunk_floats + 2 * hl);
      float2 m[kQ][kChains];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int t = 0; t < kChains; ++t) m[q][t] = make_float2(kNegInf, kNegInf);
#pragma unroll 2
      for (int s = 0; s < n_slots; s += 2) {
        const int4 a = row4[s];
        const int4 c = row4[s + 1];
        const int o[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float2* at = reinterpret_cast<const float2*>(tab + o[t]);
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const float2 v = at[q * 16];
            float2& mm = m[q][t % kChains];
            mm.x = fmaxf(mm.x, v.x);
            mm.y = fmaxf(mm.y, v.y);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        float2 mx = m[q][0];
#pragma unroll
        for (int t = 1; t < kChains; ++t) {
          mx.x = fmaxf(mx.x, m[q][t].x);
          mx.y = fmaxf(mx.y, m[q][t].y);
        }
        const float2 w = *reinterpret_cast<const float2*>(
            s_qm + q * p.n_chunks * 32 + ch * 32 + 2 * hl);
        acc[q] += w.x * mx.x + w.y * mx.y;
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      float a = acc[q];
      for (int o = 8; o > 0; o >>= 1) a += __shfl_xor_sync(hmask, a, o);
      const int b = b0 + q;
      if (hl == 0 && b < b_count) {
        if (kTopK) {
          const bool ok = p.valid == nullptr ||
                          p.valid[b * p.valid_bstride + doc] != 0;
          s_score[q * p.range_len + d] = ok ? a : kNegInf;
        } else {
          p.out_s[(size_t)b * p.n + doc] = a;
        }
      }
    }
    __syncwarp(hmask);  // the next document overwrites this half's row
  }
  if (!kTopK) return;

  // -- each query's top min(k, R) of the range, score descending then
  //    position ascending
  __syncthreads();
  for (int q = 0; q < kQ; ++q) {
    const int b = b0 + q;
    if (b >= b_count) break;                   // uniform
    const float* sc = s_score + q * p.range_len;
    const size_t list = ((size_t)b * gridDim.x + blockIdx.x) * p.top_k;
    float* os = p.out_s + list;
    int* op = p.out_p + list;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float si = sc[i];
      int rank = 0;
      for (int j = 0; j < len; ++j) {
        const float sj = sc[j];
        rank += (sj > si) || (sj == si && j < i);
      }
      if (rank < p.top_k) {
        const long long pos = (long long)r0 + i;
        const bool ok = p.valid == nullptr ||
                        p.valid[b * p.valid_bstride + pos] != 0;
        os[rank] = si;
        op[rank] = ok ? static_cast<int>(pos) : -1;
      }
    }
    for (int i = len + threadIdx.x; i < p.top_k; i += kThreads) {
      os[i] = -__int_as_float(0x7f800000);
      op[i] = -1;
    }
  }
}

template <typename CodeT>
long long smem_bytes(int mq, int k, int md, int range_len, int q) {
  const long long chunks = (mq + 31) / 32;
  long long rows = (long long)kHalves * RowGeom<CodeT>::row_ints(md);
  if (rows < kScratch) rows = kScratch;
  return (q * chunks * (k + 1) * 32 + q * chunks * 32 + rows +
          (long long)q * range_len) * (long long)sizeof(float);
}

long long smem_for(int code_bytes, int mq, int k, int md, int range_len,
                   int q) {
  if (code_bytes == 1) return smem_bytes<uint8_t>(mq, k, md, range_len, q);
  if (code_bytes == 2) return smem_bytes<uint16_t>(mq, k, md, range_len, q);
  return -1;
}

template <typename CodeT, int kQ, bool kTopK>
int launch(const Params& p, int b, size_t smem, cudaStream_t stream) {
  // once per process (thread-safe static init); raising the cap only
  // permits larger launches, each launch still asks for what it needs
  static const cudaError_t status = cudaFuncSetAttribute(
      qmaxsim_kernel<CodeT, kQ, kTopK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid((p.n + p.range_len - 1) / p.range_len, (b + kQ - 1) / kQ);
  qmaxsim_kernel<CodeT, kQ, kTopK><<<grid, kThreads, smem, stream>>>(p, b);
  return static_cast<int>(cudaGetLastError());
}

// Queries a block takes: two for the shared corpus (they read the same
// codes) when their tables fit and max_q allows, else one.
int queries_per_block(const Params& p, int code_bytes, int b, int max_q) {
  if (max_q < 2 || b < 2 || p.codes_bstride != 0 || p.mask_bstride != 0)
    return 1;
  return smem_for(code_bytes, p.mq, p.k, p.md, p.range_len, 2) <=
                 kMaxDynamicSmem ? 2 : 1;
}

template <bool kTopK>
int dispatch(const Params& p, int code_bytes, int b, int max_q,
             cudaStream_t stream) {
  if (b <= 0 || p.n <= 0) return 0;
  if (code_bytes != 1 && code_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int q = queries_per_block(p, code_bytes, b, max_q);
  const long long smem = smem_for(code_bytes, p.mq, p.k, p.md, p.range_len, q);
  if (smem > kMaxDynamicSmem || b > 65535 || p.mq <= 0 ||
      p.k <= 0 || p.md <= 0 || p.range_len <= 0 || p.range_len > kMaxRange ||
      (kTopK && (p.top_k <= 0 || p.top_k > p.range_len)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1)
    return q == 2 ? launch<uint8_t, 2, kTopK>(p, b, (size_t)smem, stream)
                  : launch<uint8_t, 1, kTopK>(p, b, (size_t)smem, stream);
  return q == 2 ? launch<uint16_t, 2, kTopK>(p, b, (size_t)smem, stream)
                : launch<uint16_t, 1, kTopK>(p, b, (size_t)smem, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (-1 for a bad code width); the
// wrapper checks it first.
long long hpc_qmaxsim_smem_bytes(int code_bytes, int mq, int k, int md,
                                 int range_len) {
  return smem_for(code_bytes, mq, k, md, range_len, 1);
}

// Scores only: out (B, N). Returns a cudaError_t (0 on success).
// code_bytes is 1 (uint8 codes) or 2 (uint16 codes); strides in elements.
int hpc_qmaxsim(const float* table, const float* q_mask, const void* codes,
                int code_bytes, const uint8_t* d_mask, float* out, int b,
                int mq, int k, int n, int md, long long codes_bstride,
                long long mask_bstride, int range_len, void* stream) {
  const Params p{table, q_mask, codes, d_mask, nullptr, out, nullptr,
                 mq, k, n, md, (mq + 31) / 32, range_len, 0,
                 codes_bstride, mask_bstride, 0};
  return dispatch<false>(p, code_bytes, b, 2,
                         static_cast<cudaStream_t>(stream));
}

// Per-range top-k: out_s/out_p (B, ceil(N / range_len), top_k), top_k <=
// range_len. valid (null = all valid) is indexed valid[b * valid_bstride + n].
// max_q (1 or 2) caps the queries a block takes on the shared corpus.
int hpc_qmaxsim_topk(const float* table, const float* q_mask,
                     const void* codes, int code_bytes, const uint8_t* d_mask,
                     const uint8_t* valid, long long valid_bstride,
                     float* out_s, int* out_p, int b, int mq, int k, int n,
                     int md, long long codes_bstride, long long mask_bstride,
                     int range_len, int top_k, int max_q, void* stream) {
  const Params p{table, q_mask, codes, d_mask, valid, out_s, out_p,
                 mq, k, n, md, (mq + 31) / 32, range_len, top_k,
                 codes_bstride, mask_bstride, valid_bstride};
  return dispatch<true>(p, code_bytes, b, max_q,
                        static_cast<cudaStream_t>(stream));
}

// The launch hpc_qmaxsim (top_k = 0, max_q 2) or hpc_qmaxsim_topk makes at
// these shapes, per_query != 0 for pools (a nonzero batch stride):
// out[0..7] = grid.x, grid.y, threads per block, dynamic shared bytes,
// queries per block, 0, 0, 0. Returns 0, or -1 when it launches nothing or
// refuses them.
int hpc_qmaxsim_geometry(int code_bytes, int b, int mq, int k, int n, int md,
                         int per_query, int range_len, int top_k, int max_q,
                         long long* out) {
  const Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, mq, k, n, md, (mq + 31) / 32, range_len, top_k,
                 per_query ? 1LL : 0LL, per_query ? 1LL : 0LL, 0};
  if (b <= 0 || n <= 0 || (code_bytes != 1 && code_bytes != 2)) return -1;
  const int q = queries_per_block(p, code_bytes, b, max_q);
  const long long smem = smem_for(code_bytes, mq, k, md, range_len, q);
  if (smem > kMaxDynamicSmem || b > 65535 || mq <= 0 || k <= 0 || md <= 0 ||
      range_len <= 0 || range_len > kMaxRange ||
      (top_k != 0 && (top_k < 0 || top_k > range_len)))
    return -1;
  const long long v[8] = {(n + range_len - 1) / range_len, (b + q - 1) / q,
                          kThreads, smem, q, 0, 0, 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

const char* hpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
