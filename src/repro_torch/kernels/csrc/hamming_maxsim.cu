// Binary (Hamming) MaxSim with a per-range top-k, for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: src/repro/kernels/hamming.py, hamming_maxsim_pallas (body
// _hamming_kernel), the TPU kernel of the cascade's stage 1, the
// prefilter over every document.
//
//   out[b, n] = sum_i qw[b, i] * max_{j : dm[n, j] != 0}
//                   (bits - popc((q[b, i] ^ codes[n, j]) & (2^bits - 1)))
//
// in int32 throughout. A document with no valid patch takes the int32
// -(2^20) for every query patch, so it scores sum_i qw[b, i] * -(2^20):
// the reference's jnp path (li.binary_maxsim). The TPU kernel instead
// accumulates in f32 with -1e30 masking and the scan clamps that to the
// int32 minimum; the two differ only for all-masked documents (ROADMAP
// caveat C4). Every other score is a small integer (|s| <= bits * Mq), so
// this kernel and its plain version agree bit for bit.
//
// The function of one document is that of its code set: with S the set of
// its valid codes (masked to `bits`), the max over its patches is
// bits - d(q, S), d the Hamming distance to the nearest member of S. So a
// document's score needs one pass over its codes and, per query patch,
// one lookup in the distance table of S; no popcount per (query patch,
// document patch) pair.
//
// What bounds it on the H100: the bytes. The cascade's stage-1 sweep
// (B=8, Mq=32, 16384 documents x Md=615 uint16 codes and a bool mask) reads
// 30.2 MB once: 9.0 us at 3.35 TB/s. Its operations (a flag per valid
// slot, the distance transform's 2^bits x bits min-adds a document, a
// lookup per query patch and document) are 4.8e7 at bits = 8: 2.9 us at
// 64 integer results per clock per SM, 132 SMs, 1980 MHz. On the card the
// sweep takes about three times the bytes bound (PERF.md); a warp issues
// some 500 instructions a document (the loads and flag stores, the
// transform's 40 shuffles, the lookups and warp sums), which is where the
// rest of the time is likely to go. The design before this one spent a
// popcount per pair, 4.0e7 per 256-document block, and read every
// document once per query in one launch per block: 1.29 ms a sweep.
//
// Design:
// - One launch per sweep: a block scores a contiguous range of R
//   positions (grid (ranges, query groups)) for up to 32 queries of the
//   shared corpus at once (their codes and weights staged in shared
//   memory), so each document is read from device memory once per launch;
//   per-query pools (B, P, Md) take one query a block through the batch
//   stride. One warp scores one document at a time.
// - The table body (bits <= 10): the warp marks the document's valid codes
//   in a per-warp byte array of 2^bits flags (coalesced reads of codes and
//   mask as stored; plain stores, a repeated code writes the same flag).
//   Lane l then holds the flags of codes r*32 + l, r < 2^bits / 32, as
//   distances (0 in S, far outside) and runs the exact Hamming distance
//   transform, one pass per code bit: d(c) = min(d(c), d(c ^ 2^i) + 1) (the
//   metric is a sum over bits, so one pass per bit is exact). Bits 0-4
//   flip the lane (a shuffle), bits 5 and up flip the register (a swap in
//   registers). The distances go to a per-warp byte table, and each query
//   patch is one shared load: qw * (bits - dist[q]), or -(2^20) when S is
//   empty, summed by one warp reduction per query.
// - The popcount body (bits 11-16, where the table would take 64 and more
//   registers a lane): per query, each lane walks the document's patches
//   with stride 32 and keeps the minimum popcount for 32 query patches in
//   registers; a transposing butterfly (31 shuffles) leaves lane l with
//   query patch l's minimum. The document is read from device memory once;
//   the later queries find it in L1. Which body runs is decided by `bits`
//   alone.
// - The top k of each range: each query's scores of the range go to shared
//   memory (a slot with valid = 0 scores the int32 minimum); each thread
//   ranks one (query, slot) exactly, #(s_j > s_i) + #(s_j == s_i, j < i),
//   so the lists come out ordered by score descending, then position
//   ascending, with no sort; an invalid slot gets position -1 and a range
//   shorter than k is padded with (int32 minimum, -1). The caller merges the
//   ranges' lists once: one launch and one merge per sweep, not one per
//   block of documents. The scores-only entry writes (B, N) scores from
//   the same bodies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRange = 256;
constexpr int kMaxQueries = 32;    // queries of the shared corpus a block takes
constexpr int kTableMaxBits = 10;  // above: the popcount body
constexpr int kMasked = -(1 << 20);
constexpr int kInvalid = -2147483647 - 1;  // the int32 minimum
constexpr int kFar = 1 << 10;      // above any Hamming distance
constexpr int kNone = 64;          // above any 32-bit popcount
constexpr int kMaxDynamicSmem = 232448;  // 227 KB, the most a block may use
constexpr int kUnroll = 8;         // patches a lane loads at once
constexpr int kQueryUnroll = 4;    // queries a warp scores at once

struct Params {
  const int32_t* q_codes;  // (B, Mq)
  const int32_t* q_w;      // (B, Mq)
  const void* codes;
  const uint8_t* d_mask;
  const uint8_t* valid;    // null: every slot valid
  int32_t* out_s;          // topk: (B, ranges, top_k); scores: (B, N)
  int32_t* out_p;          // topk: (B, ranges, top_k)
  int b, mq, n, md, bits, range_len, top_k, qpb;
  long long codes_bstride, mask_bstride, valid_bstride;
};

// registers a lane holds of the distance table (2^bits codes over 32
// lanes), 0 for the popcount body
int table_regs(int bits) {
  if (bits > kTableMaxBits) return 0;
  return bits <= 5 ? 1 : 1 << (bits - 5);
}

long long smem_bytes(int mq, int bits, int range_len, int qpb, bool topk) {
  const int regs = table_regs(bits);
  return (long long)qpb * mq * 8 + (topk ? (long long)qpb * range_len * 4 : 0)
         + (long long)kWarps * 2 * 32 * regs;
}

// Queries a block takes: one for per-query pools, else up to kMaxQueries
// whose codes, weights and range scores fit at the longest range; 0 if
// not even one does.
int queries_per_block(int b, int mq, int bits, bool per_query) {
  if (per_query) return smem_bytes(mq, bits, kMaxRange, 1, true) <=
                        kMaxDynamicSmem ? 1 : 0;
  int q = b < kMaxQueries ? b : kMaxQueries;
  while (q > 0 && smem_bytes(mq, bits, kMaxRange, q, true) > kMaxDynamicSmem)
    --q;
  return q;
}

// One butterfly step: lanes with bit W set keep the upper half of their
// W-value window and send the lower half, so after W = 16, 8, 4, 2, 1 lane
// l holds the minimum over all lanes of entry l.
template <int W>
__device__ __forceinline__ void min_step(int (&v)[32], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int send = upper ? v[k] : v[k + W];
    const int keep = upper ? v[k + W] : v[k];
    const int recv = __shfl_xor_sync(0xffffffffu, send, W);
    v[k] = min(keep, recv);
  }
}

template <typename CodeT, int kRegs, bool kTopK>
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_q = reinterpret_cast<int*>(smem);            // (qpb, Mq) codes
  int* s_w = s_q + p.qpb * p.mq;                      // (qpb, Mq) weights
  int* s_score = s_w + p.qpb * p.mq;                  // (qpb, R), top-k only
  unsigned char* s_tab = reinterpret_cast<unsigned char*>(
      s_score + (kTopK ? p.qpb * p.range_len : 0));   // (warps, 2, 32 kRegs)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.y * p.qpb;
  const int nq = min(p.qpb, p.b - b0);
  const uint32_t cmask = (1u << p.bits) - 1u;

  for (int t = threadIdx.x; t < p.qpb * p.mq; t += kThreads) {
    const bool live = t < nq * p.mq;
    const long long at = (long long)b0 * p.mq + t;
    s_q[t] = live ? static_cast<int>(static_cast<uint32_t>(p.q_codes[at]) &
                                     cmask) : 0;
    s_w[t] = live ? p.q_w[at] : 0;
  }
  // the code flags start clear; each document clears the flags it read
  for (int t = threadIdx.x; t < kWarps * 2 * 32 * kRegs; t += kThreads)
    s_tab[t] = 0;
  __syncthreads();

  const int r0 = blockIdx.x * p.range_len;
  const int len = min(p.range_len, p.n - r0);
  // the batch strides are 0 for the shared corpus; a per-query pool's
  // block takes one query, b0
  const CodeT* codes_b = static_cast<const CodeT*>(p.codes) +
                         (long long)b0 * p.codes_bstride;
  const uint8_t* mask_b = p.d_mask + (long long)b0 * p.mask_bstride;

  for (int d = warp; d < len; d += kWarps) {
    const long long doc = (long long)r0 + d;
    const CodeT* c_row = codes_b + doc * p.md;
    const uint8_t* m_row = mask_b + doc * p.md;
    auto emit = [&](int q, int score) {
      if (lane != 0) return;
      if constexpr (kTopK)
        s_score[q * p.range_len + d] = score;
      else
        p.out_s[(long long)(b0 + q) * p.n + doc] = score;
    };

    if constexpr (kRegs > 0) {
      unsigned char* present = s_tab + warp * 2 * 32 * kRegs;
      unsigned char* dist = present + 32 * kRegs;
      // kUnroll patches a lane in flight: the loads of a round are issued
      // before any flag is stored, so a document costs ceil(Md / 256)
      // memory round trips, not ceil(Md / 32)
      for (int j0 = lane; j0 < p.md; j0 += 32 * kUnroll) {
        uint32_t code[kUnroll];
        uint8_t valid[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + 32 * u;
          code[u] = j < p.md ? static_cast<uint32_t>(__ldg(c_row + j)) : 0u;
          valid[u] = j < p.md ? __ldg(m_row + j) : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (valid[u] != 0) present[code[u] & cmask] = 1;
      }
      __syncwarp();
      int dd[kRegs];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {   // read and clear this lane's flags
        const bool in = present[r * 32 + lane] != 0;
        dd[r] = in ? 0 : kFar;
        any |= in;
        present[r * 32 + lane] = 0;
      }
      any = __any_sync(0xffffffffu, any);
      // code bits 0-4: the lane; a code past 2^bits (bits < 5) is never
      // looked up and flips only with its like
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        if (i < p.bits) {
#pragma unroll
          for (int r = 0; r < kRegs; ++r) {
            const int o = __shfl_xor_sync(0xffffffffu, dd[r], 1 << i);
            dd[r] = min(dd[r], o + 1);
          }
        }
      }
      // code bits 5 and up: the register
#pragma unroll
      for (int s = 1; s < kRegs; s <<= 1) {
#pragma unroll
        for (int r = 0; r < kRegs; ++r) {
          if ((r & s) == 0) {
            const int a = dd[r], c = dd[r | s];
            dd[r] = min(a, c + 1);
            dd[r | s] = min(c, a + 1);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRegs; ++r)
        dist[r * 32 + lane] = static_cast<unsigned char>(min(dd[r], 255));
      __syncwarp();
      // kQueryUnroll queries at a time: their lookups and warp sums are
      // independent, so their latencies overlap
      for (int q0 = 0; q0 < nq; q0 += kQueryUnroll) {
        int acc[kQueryUnroll];
#pragma unroll
        for (int u = 0; u < kQueryUnroll; ++u) {
          acc[u] = 0;
          if (q0 + u < nq) {
            const int* qc = s_q + (q0 + u) * p.mq;
            const int* qw = s_w + (q0 + u) * p.mq;
            for (int i = lane; i < p.mq; i += 32)
              acc[u] += qw[i] * (any ? p.bits - static_cast<int>(dist[qc[i]])
                                     : kMasked);
          }
        }
#pragma unroll
        for (int u = 0; u < kQueryUnroll; ++u) {
          const int sum = __reduce_add_sync(0xffffffffu, acc[u]);
          if (q0 + u < nq) emit(q0 + u, sum);
        }
      }
    } else {
      for (int q = 0; q < nq; ++q) {
        const int* qc = s_q + q * p.mq;
        const int* qw = s_w + q * p.mq;
        int acc = 0;
        for (int i0 = 0; i0 < p.mq; i0 += 32) {
          // every lane holds the chunk's query codes; past Mq they are 0
          // and weigh 0
          uint32_t qv[32];
#pragma unroll
          for (int k = 0; k < 32; ++k)
            qv[k] = i0 + k < p.mq ? static_cast<uint32_t>(qc[i0 + k]) : 0u;
          int best[32];
#pragma unroll
          for (int k = 0; k < 32; ++k) best[k] = kNone;
          for (int j = lane; j < p.md; j += 32) {
            if (m_row[j] == 0) continue;
            const uint32_t dv = static_cast<uint32_t>(c_row[j]) & cmask;
#pragma unroll
            for (int k = 0; k < 32; ++k)
              best[k] = min(best[k], __popc(qv[k] ^ dv));
          }
          min_step<16>(best, lane);
          min_step<8>(best, lane);
          min_step<4>(best, lane);
          min_step<2>(best, lane);
          min_step<1>(best, lane);
          const int i = i0 + lane;
          const int sim = best[0] == kNone ? kMasked : p.bits - best[0];
          acc += i < p.mq ? qw[i] * sim : 0;
        }
        emit(q, __reduce_add_sync(0xffffffffu, acc));
      }
    }
    __syncwarp();  // the next document rewrites this warp's tables
  }
  if constexpr (!kTopK) return;

  // -- each query's top min(k, R) of the range, score descending then
  //    position ascending: a thread a (query, slot); a slot with valid = 0
  //    scores the int32 minimum first
  __syncthreads();
  if (p.valid != nullptr) {
    for (int t = threadIdx.x; t < nq * len; t += kThreads) {
      const int q = t / len;
      const int i = t - q * len;
      if (p.valid[(long long)(b0 + q) * p.valid_bstride + r0 + i] == 0)
        s_score[q * p.range_len + i] = kInvalid;
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < nq * len; t += kThreads) {
    const int q = t / len;
    const int i = t - q * len;
    const long long b = b0 + q;
    const int* sc = s_score + q * p.range_len;
    const int si = sc[i];
    int rank = 0;
    for (int j = 0; j < len; ++j) {
      const int sj = sc[j];
      rank += (sj > si) || (sj == si && j < i);
    }
    if (rank < p.top_k) {
      const size_t list = ((size_t)b * gridDim.x + blockIdx.x) * p.top_k;
      const long long pos = (long long)r0 + i;
      const bool ok = p.valid == nullptr ||
                      p.valid[b * p.valid_bstride + pos] != 0;
      p.out_s[list + rank] = si;
      p.out_p[list + rank] = ok ? static_cast<int>(pos) : -1;
    }
  }
  const int pad = p.top_k - len;                 // a range shorter than k
  for (int t = threadIdx.x; t < nq * pad; t += kThreads) {
    const int q = t / pad;
    const size_t at = ((size_t)(b0 + q) * gridDim.x + blockIdx.x) * p.top_k +
                      len + (t - q * pad);
    p.out_s[at] = kInvalid;
    p.out_p[at] = -1;
  }
}

template <typename CodeT, int kRegs, bool kTopK>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  // once per process (thread-safe static init); raising the cap only
  // permits larger launches, each launch still asks for what it needs
  static const cudaError_t status = cudaFuncSetAttribute(
      hamming_kernel<CodeT, kRegs, kTopK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid((p.n + p.range_len - 1) / p.range_len,
                  (p.b + p.qpb - 1) / p.qpb);
  hamming_kernel<CodeT, kRegs, kTopK><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT, bool kTopK>
int by_bits(const Params& p, size_t smem, cudaStream_t stream) {
  switch (table_regs(p.bits)) {
    case 1: return launch<CodeT, 1, kTopK>(p, smem, stream);
    case 2: return launch<CodeT, 2, kTopK>(p, smem, stream);
    case 4: return launch<CodeT, 4, kTopK>(p, smem, stream);
    case 8: return launch<CodeT, 8, kTopK>(p, smem, stream);
    case 16: return launch<CodeT, 16, kTopK>(p, smem, stream);
    case 32: return launch<CodeT, 32, kTopK>(p, smem, stream);
    default: return launch<CodeT, 0, kTopK>(p, smem, stream);
  }
}

// The launch's queries per block and shared bytes; false when refused.
bool plan(int b, int mq, int n, int md, int bits, bool per_query,
          int range_len, int top_k, int* qpb, long long* smem) {
  if (b <= 0 || n <= 0 || b > 65535 || mq <= 0 || md < 0 || bits < 1 ||
      bits > 16 || range_len <= 0 || range_len > kMaxRange || top_k < 0 ||
      top_k > range_len)
    return false;
  *qpb = queries_per_block(b, mq, bits, per_query);
  if (*qpb <= 0) return false;
  *smem = smem_bytes(mq, bits, range_len, *qpb, top_k > 0);
  return *smem <= kMaxDynamicSmem;
}

template <bool kTopK>
int dispatch(Params p, int code_bytes, cudaStream_t stream) {
  if (p.b <= 0 || p.n <= 0) return 0;
  long long smem = 0;
  const bool per_query = p.codes_bstride != 0 || p.mask_bstride != 0;
  if ((code_bytes != 1 && code_bytes != 2) ||
      (kTopK && p.top_k <= 0) ||
      !plan(p.b, p.mq, p.n, p.md, p.bits, per_query, p.range_len,
            kTopK ? p.top_k : 0, &p.qpb, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes == 1) return by_bits<uint8_t, kTopK>(p, (size_t)smem, stream);
  return by_bits<uint16_t, kTopK>(p, (size_t)smem, stream);
}

}  // namespace

extern "C" {

// The launch hpc_hamming_maxsim (top_k = 0) or hpc_hamming_maxsim_topk
// makes at these shapes, per_query != 0 for pools (a nonzero batch
// stride): out[0..7] = grid.x, grid.y, threads per block, dynamic shared
// bytes, queries per block, table registers a lane (0: the popcount
// body), 0, 0. Returns 0, or -1 when it launches nothing or refuses them.
int hpc_hamming_geometry(int b, int mq, int n, int md, int bits,
                         int per_query, int range_len, int top_k,
                         long long* out) {
  int qpb = 0;
  long long smem = 0;
  if (!plan(b, mq, n, md, bits, per_query != 0, range_len, top_k, &qpb,
            &smem))
    return -1;
  const long long v[8] = {(n + range_len - 1) / range_len,
                          (b + qpb - 1) / qpb, kThreads, smem, qpb,
                          table_regs(bits), 0, 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// Scores only: out (B, N) int32. Returns a cudaError_t (0 on success).
// q_codes and q_w are (B, Mq) int32; code_bytes is 1 (uint8 codes) or 2
// (uint16); d_mask is 1 byte per patch; strides are in elements; a block
// scores range_len positions.
int hpc_hamming_maxsim(const int32_t* q_codes, const int32_t* q_w,
                       const void* codes, int code_bytes,
                       const uint8_t* d_mask, int32_t* out, int b, int mq,
                       int n, int md, int bits, long long codes_bstride,
                       long long mask_bstride, int range_len, void* stream) {
  const Params p{q_codes, q_w, codes, d_mask, nullptr, out, nullptr,
                 b, mq, n, md, bits, range_len, 0, 0,
                 codes_bstride, mask_bstride, 0};
  return dispatch<false>(p, code_bytes, static_cast<cudaStream_t>(stream));
}

// Per-range top-k: out_s/out_p (B, ceil(N / range_len), top_k) int32,
// top_k <= range_len. valid (null = all valid) is indexed
// valid[b * valid_bstride + n].
int hpc_hamming_maxsim_topk(const int32_t* q_codes, const int32_t* q_w,
                            const void* codes, int code_bytes,
                            const uint8_t* d_mask, const uint8_t* valid,
                            long long valid_bstride, int32_t* out_s,
                            int32_t* out_p, int b, int mq, int n, int md,
                            int bits, long long codes_bstride,
                            long long mask_bstride, int range_len,
                            int top_k, void* stream) {
  const Params p{q_codes, q_w, codes, d_mask, valid, out_s, out_p,
                 b, mq, n, md, bits, range_len, top_k, 0,
                 codes_bstride, mask_bstride, valid_bstride};
  return dispatch<true>(p, code_bytes, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
