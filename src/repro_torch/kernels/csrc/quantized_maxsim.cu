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
// The function of one document is that of its code set: a patch's max over
// the document's valid slots is the max over its distinct valid codes (a
// max over a multiset is the max over its members). So for K <= 256 the
// kernel builds each document's set once, as its codes are read, and does
// one table lookup per query patch and distinct code, not per slot: about
// 64 lookups a patch on a page drawn from a window of 64 codebook entries,
// against 615 slots. Each patch max is the same float whichever order or
// multiplicity the lookups come in, and the sum over patches is taken in
// the same order in both bodies, so the two give the same scores bit for
// bit. Which body runs is decided by K alone: K > 256 (uint16 codes, whose
// flags would not fit, and whose pages can hold nearly as many distinct
// codes as slots) keeps the per-slot body.
//
// What bounds it on the H100 (132 SMs at 1980 MHz; PERF.md section 6):
// shared-memory wavefronts. The SM's shared memory serves one 128-byte
// wavefront per clock, and a lookup of one code for 32 query patches is
// one (16 lanes x 8 bytes). A 16384-doc x 8-query sweep at Md=615, Mq=32
// with 64 distinct codes a page is 8.4e6 lookup wavefronts: 32 us. The
// set's build adds, per document and group of queries, the code and mask
// words (10 MB each a sweep, 6 us of bytes a read), 16 predicated byte
// stores a 16-byte word (about 40 a document over 16 lanes, a few
// wavefronts each: random flags share banks), 16 list stores a lane and a
// few shuffles; the top-k epilogue ranks each slot of a range against the
// range's other slots. On the card the sweep takes 67 us at 64 distinct
// codes a page and 167 us at 233; the per-slot body took 0.42 ms against
// its own bound of 2.58e9 lookups (0.309 ms). Over 262,144 pages the
// lookups ran within 11% of their bound, the build took about a quarter
// of the time and the staging and epilogue about a fifth.
//
// Design:
// - The table is staged in shared memory transposed, (K + 1, 32) per chunk
//   of 32 query patches. One document goes to a half-warp, and lane l of
//   it owns query patches 2l and 2l + 1. The half-warp walks a list of
//   byte offsets into the table (the document's distinct codes, or its
//   slots); its lanes get the same offset as a broadcast and read
//   T[c][2l : 2l + 2] with one 8-byte load: 16 lanes x 8 bytes, one table
//   row, no bank conflict. A load instruction thus serves 64 lookups (two
//   documents) in two wavefronts, and each address add two. Lane l of a
//   warp stages query patch l's row, 16 bytes at a time where K % 4 == 0,
//   and writes its column: a warp's stores fall on 32 banks.
// - Row K holds -1e30. Padding, masked slots and codes >= K are mapped to
//   it, so the inner loop has no branch: each offset is an address add, a
//   shared load and two maxes, in independent max chains.
// - On the shared corpus a block takes several queries (they read the
//   same codes): their tables are interleaved row by row, (K + 1, kQ, 32),
//   so one offset serves all kQ lookups, the others at immediate offsets,
//   and one set build serves kQ queries. The code-set body takes up to 4
//   (a 132 KB table at K = 256, Mq = 32) in blocks of 16 warps, so each
//   SM holds one block of 32 documents in flight, and the codes of a
//   flat batch of 8 are read twice, not four times; the per-slot body
//   takes up to 2 in blocks of 8 warps. Per-query pools take one a block.
// - The code-set body (K <= 256): each half-warp reads its document's codes
//   and mask as stored, three 16-byte words of each a lane in flight at
//   once (the mask word at the same position as the code word when their
//   alignments agree, else the mask byte by byte). For an aligned word a
//   16-bit mask of its valid bytes (mask nonzero, code below K, inside the
//   row) is formed with byte-wise word operations, and a byte flag is
//   stored per valid code into the half-warp's own 256 flags in shared
//   memory. A plain store is enough: a repeated code writes the same flag.
//   Lane l then loads flags 16l .. 16l + 15 as one 16-byte word, clears
//   them for the next document, and turns them into a 16-bit set; a
//   prefix sum over the half-warp (four shuffles) places each lane's codes
//   in the half-warp's list, in code order, as byte offsets into the
//   table, padded with the sentinel row to a multiple of 8. The lookup loop
//   walks that list, eight offsets per two broadcast loads; every lane of
//   the half-warp walks the same list, so the loop has no divergence. An
//   empty set (an all-masked page, or only codes >= K) leaves every max at
//   -1e30.
// - The per-slot body (K > 256): each half-warp stages its document's codes
//   as 16-byte vectors, coalesced, and writes them to its own shared row as
//   byte offsets into the table. A 16-byte code word goes to int4 slots
//   p * Wp + w (part p of word w), so the lanes' stores fall on consecutive
//   slots without conflict; the order of the lookups does not matter to a
//   max. The mask is read the same way and overwrites the masked slots
//   with the sentinel. The row is then walked like the set's list.
// - Mq > 32 loops over chunks of 32 query patches and adds the chunks'
//   partials in order; for Mq < 32 the idle patches have q_mask 0.
// - The sweep: a block scores contiguous ranges of R positions (grid
//   (ranges, query groups)), sets slots with valid = 0 to -1e30 (the
//   scan's NEG_INF), and writes each query's top min(k, R) of each range
//   as (score, position) pairs ordered by score descending, then position
//   ascending. Each thread ranks one (query, slot) exactly,
//   #(s_j > s_i) + #(s_j == s_i, j < i), reading the scores four at a
//   time (those before the slot count when >= s_i, those after when
//   > s_i), so the stable order needs no sort. An invalid slot keeps its
//   score and gets position -1; a range shorter than k is padded with
//   (-inf, -1). A code-set launch with more (range, group) pairs than the
//   card has SMs (the caller's sm_count, as maxsim and kmeans_assign take
//   theirs: the one argument the C interface gained with the code-set
//   body) takes floor(SMs / groups) blocks a group, each walking
//   ranges x, x + grid.x, ...: its table is staged once, the groups of a
//   range read its codes at about the same time (the second read from L2),
//   and no second wave waits on the first. (One block fills an SM: the
//   body's 16 warps at about 90 registers a thread take its register file.)
//   The caller merges the ranges' lists once: one launch per sweep, not one
//   per block of documents. The scores-only entry writes the (B, N)
//   scores from the same scoring core.
//
// Codes (uint8, or uint16 for K > 256) and the 1-byte mask are read as
// stored. Strides give both layouts: batch stride 0 for the shared corpus
// (N, Md), P*Md (or a pool slice's own) for per-query pools (B, P, Md).
// No TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRange = 256;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDynamicSmem = 232448;        // 227 KB, the most a block may use
// The code-set body: K <= kSetMaxK; a half-warp holds kSetMaxK byte flags
// and a list of up to kSetMaxK offsets (kSetRowInts ints); a lane reads
// kSetWords 16-byte words of codes (and of mask) before it stores a flag.
constexpr int kSetMaxK = 256;
constexpr int kSetRowInts = kSetMaxK / 4 + kSetMaxK;
constexpr int kSetWords = 3;

__host__ __device__ constexpr bool code_set_body(int k) { return k <= kSetMaxK; }

// A block's shape by body: the code-set body takes 16 warps and up to four
// queries of the shared corpus, the per-slot body 8 warps and up to two.
template <bool kSet>
struct Shape {
  static constexpr int kWarps = kSet ? 16 : 8;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kHalves = 2 * kWarps;     // one document per half-warp
  static constexpr int kMaxQ = kSet ? 4 : 2;
};

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

// The top bits of a word's four bytes as four bits.
__device__ __forceinline__ uint32_t top_bits(uint32_t t) {
  t &= 0x80808080u;
  return ((t >> 7) | (t >> 14) | (t >> 21) | (t >> 28)) & 0xfu;
}

// A bit per nonzero byte of a word.
__device__ __forceinline__ uint32_t nonzero_bits(uint32_t x) {
  return top_bits(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x);
}

// kQ queries per block share every staged code: their tables are
// interleaved row by row, (K + 1, kQ, 32) per chunk, so one byte offset
// serves all kQ lookups of a code (the others at immediate offsets).
// kSet: the code-set body (K <= kSetMaxK), else the per-slot body. A block
// scores the ranges blockIdx.x, blockIdx.x + gridDim.x, ... in turn.
template <typename CodeT, int kQ, bool kTopK, bool kSet>
__global__ void __launch_bounds__(Shape<kSet>::kThreads,
                                  kSet ? 1 : 4 / kQ)
qmaxsim_kernel(const Params p, int b_count) {
  using G = RowGeom<CodeT>;
  constexpr int kWarps = Shape<kSet>::kWarps;
  constexpr int kThreads = Shape<kSet>::kThreads;
  constexpr int kHalves = Shape<kSet>::kHalves;
  extern __shared__ __align__(16) float smem[];
  const int k = p.k;
  const int row_floats = kQ * 32;                  // one table row, kQ queries
  const int chunk_floats = (k + 1) * row_floats;
  float* s_tab = smem;                             // (n_chunks, K+1, kQ, 32)
  float* s_qm = s_tab + (size_t)p.n_chunks * chunk_floats;  // (kQ, n_chunks*32)
  int* s_rows = reinterpret_cast<int*>(s_qm + kQ * p.n_chunks * 32);
  const int row_ints = kSet ? kSetRowInts : G::row_ints(p.md);
  const int r_stride = (p.range_len + 3) & ~3;
  float* s_score = reinterpret_cast<float*>(s_rows + kHalves * row_ints);
                                                   // (kQ, r_stride)

  const int b0 = blockIdx.y * kQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // -- stage T[b0 + q] transposed: lane l holds query patch l of a chunk
  //    and writes its column, so a warp's stores fall on 32 banks; its
  //    loads take 16 bytes of a table row at a time where K allows
  for (int q = 0; q < kQ; ++q) {
    const bool live = b0 + q < b_count;
    const float* tab_b = p.table + (size_t)(live ? b0 + q : 0) * p.mq * k;
    for (int ch = 0; ch < p.n_chunks; ++ch) {
      float* dst = s_tab + (size_t)ch * chunk_floats + q * 32 + lane;
      const int i = ch * 32 + lane;
      const bool ok = live && i < p.mq;
      const float* src = tab_b + (size_t)(ok ? i : 0) * k;
      if ((k & 3) == 0) {
        const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
        for (int c = 4 * warp; c < k; c += 4 * kWarps) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) x = __ldg(src4 + c / 4);
          dst[(size_t)(c + 0) * row_floats] = x.x;
          dst[(size_t)(c + 1) * row_floats] = x.y;
          dst[(size_t)(c + 2) * row_floats] = x.z;
          dst[(size_t)(c + 3) * row_floats] = x.w;
        }
      } else {
        for (int c = warp; c < k; c += kWarps)
          dst[(size_t)c * row_floats] = ok ? __ldg(src + c) : 0.f;
      }
      if (warp == 0) dst[(size_t)k * row_floats] = kNegInf;
    }
    for (int t = threadIdx.x; t < p.n_chunks * 32; t += kThreads)
      s_qm[q * p.n_chunks * 32 + t] =
          live && t < p.mq ? p.q_mask[(size_t)(b0 + q) * p.mq + t] : 0.f;
  }
  // the code flags start clear; each document clears the flags it read
  if (kSet) {
    for (int t = threadIdx.x; t < kHalves * kSetMaxK / 4; t += kThreads)
      s_rows[(t / (kSetMaxK / 4)) * kSetRowInts + t % (kSetMaxK / 4)] = 0;
  }
  __syncthreads();

  // -- score each range, one document per half-warp at a time -------------
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
  // kQ > 1 only for the shared layout (batch strides 0)
  const CodeT* codes_b = static_cast<const CodeT*>(p.codes) + b0 * p.codes_bstride;
  const uint8_t* mask_b = p.d_mask + b0 * p.mask_bstride;
  const int n_ranges = (p.n + p.range_len - 1) / p.range_len;

  for (int rg = blockIdx.x; rg < n_ranges; rg += gridDim.x) {
    const int r0 = rg * p.range_len;
    const int len = min(p.range_len, p.n - r0);
    for (int d = half; d < len; d += kHalves) {
      const long long doc = (long long)r0 + d;
      const uintptr_t ca = reinterpret_cast<uintptr_t>(codes_b + doc * p.md);
      const int head = static_cast<int>((ca & 15u) / sizeof(CodeT));
      const uint4* cw = reinterpret_cast<const uint4*>(ca - (ca & 15u));
      const int c_words = (head + p.md + G::kPer - 1) / G::kPer;
      const uint8_t* m_row = mask_b + doc * p.md;
      const uintptr_t ma = reinterpret_cast<uintptr_t>(m_row);
      const int m_head = static_cast<int>(ma & 15u);
      const uint4* mw = reinterpret_cast<const uint4*>(ma - (ma & 15u));
      int n_slots;                             // int4 slots to walk, even
      if constexpr (kSet) {
        // flags of the valid codes: kSetWords words of codes (and the mask
        // words at the same positions, when their alignments agree) in
        // flight a lane before any flag is stored
        unsigned char* flags = reinterpret_cast<unsigned char*>(row);
        const bool aligned = sizeof(CodeT) == 1 && m_head == head;
        for (int w0 = hl; w0 < c_words; w0 += 16 * kSetWords) {
          uint4 v[kSetWords], mv[kSetWords];
#pragma unroll
          for (int u = 0; u < kSetWords; ++u) {
            const int w = w0 + 16 * u;
            v[u] = mv[u] = make_uint4(0u, 0u, 0u, 0u);
            if (w < c_words) {
              v[u] = __ldg(cw + w);
              if (aligned) mv[u] = __ldg(mw + w);
            }
          }
#pragma unroll
          for (int u = 0; u < kSetWords; ++u) {
            const int j0 = (w0 + 16 * u) * G::kPer - head;  // word's first slot
            if (aligned) {
              // a bit per valid byte: mask nonzero, code below K, in the row
              uint32_t live = nonzero_bits(mv[u].x) |
                              (nonzero_bits(mv[u].y) << 4) |
                              (nonzero_bits(mv[u].z) << 8) |
                              (nonzero_bits(mv[u].w) << 12);
              if (k < 256) {
                const uint32_t ks = static_cast<uint32_t>(k) * 0x01010101u;
                live &= top_bits(__vcmpltu4(v[u].x, ks)) |
                        (top_bits(__vcmpltu4(v[u].y, ks)) << 4) |
                        (top_bits(__vcmpltu4(v[u].z, ks)) << 8) |
                        (top_bits(__vcmpltu4(v[u].w, ks)) << 12);
              }
              const int lo = max(0, -j0), hi = min(16, p.md - j0);
              live = hi > lo ? live & ((0xffffu >> (16 - (hi - lo))) << lo)
                             : 0u;
#pragma unroll
              for (int t = 0; t < 16; ++t)
                if ((live >> t) & 1u) flags[elem<uint8_t>(v[u], t)] = 1;
            } else {
#pragma unroll
              for (int t = 0; t < G::kPer; ++t) {
                const int j = j0 + t;
                const int c = elem<CodeT>(v[u], t);
                if (j >= 0 && j < p.md && c < k && __ldg(m_row + j) != 0)
                  flags[c] = 1;
              }
            }
          }
        }
        __syncwarp(hmask);
        // lane hl reads (and clears) the flags of codes 16 hl .. 16 hl + 15;
        // a prefix sum over the half-warp places its codes in the list
        uint4* f4 = reinterpret_cast<uint4*>(flags);
        const uint4 f = f4[hl];
        f4[hl] = make_uint4(0u, 0u, 0u, 0u);
        const uint32_t bits = nonzero_bits(f.x) | (nonzero_bits(f.y) << 4) |
                              (nonzero_bits(f.z) << 8) |
                              (nonzero_bits(f.w) << 12);
        const int cnt = __popc(bits);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) {
          const int u = __shfl_up_sync(hmask, incl, o, 16);
          if (hl >= o) incl += u;
        }
        const int total = __shfl_sync(hmask, incl, 15, 16);
        int* list = row + kSetMaxK / 4;
        int at = incl - cnt;
#pragma unroll
        for (int t = 0; t < 16; ++t)
          if ((bits >> t) & 1u) list[at++] = (16 * hl + t) * row_bytes;
        const int padded = (total + 7) & ~7;
        if (total + hl < padded) list[total + hl] = sentinel;
        n_slots = padded / 4;
      } else {
        // codes: aligned 16-byte words covering the row; out-of-row
        // elements and codes >= K become the sentinel
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
        const int m_words = (m_head + p.md + 15) / 16;
        for (int w = hl; w < m_words; w += 16) {
          const uint4 v = __ldg(mw + w);
          if (!(has_zero_byte(v.x) || has_zero_byte(v.y) ||
                has_zero_byte(v.z) || has_zero_byte(v.w)))
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
        n_slots = G::kParts * wp;
      }
      __syncwarp(hmask);
      const int4* slots =
          kSet ? reinterpret_cast<const int4*>(row + kSetMaxK / 4) : row4;

      // lookups: for each offset, kQ 8-byte loads at one address (immediate
      // offsets), into independent max chains
      constexpr int kChains = 4 / kQ > 0 ? 4 / kQ : 1;
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
          for (int t = 0; t < kChains; ++t)
            m[q][t] = make_float2(kNegInf, kNegInf);
#pragma unroll 2
        for (int s = 0; s < n_slots; s += 2) {
          const int4 a = slots[s];
          const int4 c = slots[s + 1];
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
            s_score[q * r_stride + d] = ok ? a : kNegInf;
          } else {
            p.out_s[(size_t)b * p.n + doc] = a;
          }
        }
      }
      __syncwarp(hmask);  // the next document overwrites this half's row
    }
    if (!kTopK) continue;

    // -- each query's top min(k, R) of the range, score descending then
    //    position ascending: a thread a (query, slot), its rank
    //    #(s_j > s_i) + #(s_j == s_i, j < i), so the stable order needs no
    //    sort; the scores are read four at a time, those before the slot
    //    counted when >= s_i and those after when > s_i
    __syncthreads();
    for (int t = threadIdx.x; t < kQ * len; t += kThreads) {
      const int q = t / len;
      const int i = t - q * len;
      const int b = b0 + q;
      if (b >= b_count) continue;
      const float* sc = s_score + q * r_stride;
      const float4* sc4 = reinterpret_cast<const float4*>(sc);
      const float si = sc[i];
      const int i4 = i >> 2, n4 = len >> 2;
      int rank = 0;
      for (int j4 = 0; j4 < i4; ++j4) {
        const float4 v = sc4[j4];
        rank += (v.x >= si) + (v.y >= si) + (v.z >= si) + (v.w >= si);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {            // the word holding slot i
        const int j = 4 * i4 + e;
        if (j < len && j != i) rank += j < i ? sc[j] >= si : sc[j] > si;
      }
      for (int j4 = i4 + 1; j4 < n4; ++j4) {
        const float4 v = sc4[j4];
        rank += (v.x > si) + (v.y > si) + (v.z > si) + (v.w > si);
      }
      for (int j = max(4 * n4, 4 * i4 + 4); j < len; ++j) rank += sc[j] > si;
      if (rank < p.top_k) {
        const size_t list = ((size_t)b * n_ranges + rg) * p.top_k;
        const long long pos = (long long)r0 + i;
        const bool ok = p.valid == nullptr ||
                        p.valid[b * p.valid_bstride + pos] != 0;
        p.out_s[list + rank] = si;
        p.out_p[list + rank] = ok ? static_cast<int>(pos) : -1;
      }
    }
    const int pad = p.top_k - len;             // a range shorter than k
    for (int t = threadIdx.x; t < kQ * max(pad, 0); t += kThreads) {
      const int q = t / pad;
      const int b = b0 + q;
      if (b >= b_count) continue;
      const size_t list = ((size_t)b * n_ranges + rg) * p.top_k + len +
                          (t - q * pad);
      p.out_s[list] = -__int_as_float(0x7f800000);
      p.out_p[list] = -1;
    }
    __syncthreads();                           // the next range's scores
  }
}

template <typename CodeT>
long long smem_bytes(int mq, int k, int md, int range_len, int q) {
  const long long chunks = (mq + 31) / 32;
  const bool set = code_set_body(k);
  const long long rows =
      (long long)(set ? Shape<true>::kHalves : Shape<false>::kHalves) *
      (set ? kSetRowInts : RowGeom<CodeT>::row_ints(md));
  return (q * chunks * (k + 1) * 32 + q * chunks * 32 + rows +
          (long long)q * ((range_len + 3) & ~3)) * (long long)sizeof(float);
}

long long smem_for(int code_bytes, int mq, int k, int md, int range_len,
                   int q) {
  if (code_bytes == 1) return smem_bytes<uint8_t>(mq, k, md, range_len, q);
  if (code_bytes == 2) return smem_bytes<uint16_t>(mq, k, md, range_len, q);
  return -1;
}

// Queries a block takes: on the shared corpus (where they read the same
// codes) the most of the body's 4 or 2 that B, max_q and the shared memory
// allow; one on per-query pools.
int queries_per_block(const Params& p, int code_bytes, int b, int max_q) {
  if (p.codes_bstride != 0 || p.mask_bstride != 0) return 1;
  int q = code_set_body(p.k) ? Shape<true>::kMaxQ : Shape<false>::kMaxQ;
  while (q > 1 && (q > max_q || q / 2 >= b ||
                   smem_for(code_bytes, p.mq, p.k, p.md, p.range_len, q) >
                       kMaxDynamicSmem))
    q /= 2;
  return q;
}

// The grid: (ranges, query groups), except that a code-set launch of more
// (range, group) pairs than the card has SMs takes floor(SMs / groups)
// blocks a group (at least 1), each walking its ranges in turn: its table
// is staged once, the groups of a range read its codes at about the same
// time, and no second wave of blocks waits on the first (one block an SM:
// its 16 warps' registers fill the SM).
int grid_x(const Params& p, int b, int q, int sms) {
  const long long ranges = (p.n + p.range_len - 1) / p.range_len;
  const long long groups = (b + q - 1) / q;
  if (!code_set_body(p.k) || sms <= 0 || ranges * groups <= sms)
    return static_cast<int>(ranges);
  return static_cast<int>(sms / groups > 0 ? sms / groups : 1);
}

template <typename CodeT, int kQ, bool kTopK, bool kSet>
int launch(const Params& p, int b, int gx, size_t smem, cudaStream_t stream) {
  // once per process (thread-safe static init); raising the cap only
  // permits larger launches, each launch still asks for what it needs
  static const cudaError_t status = cudaFuncSetAttribute(
      qmaxsim_kernel<CodeT, kQ, kTopK, kSet>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(gx, (b + kQ - 1) / kQ);
  qmaxsim_kernel<CodeT, kQ, kTopK, kSet>
      <<<grid, Shape<kSet>::kThreads, smem, stream>>>(p, b);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT, bool kTopK>
int launch_typed(const Params& p, int b, int q, int gx, size_t smem,
                 cudaStream_t stream) {
  if (code_set_body(p.k)) {
    if (q == 4) return launch<CodeT, 4, kTopK, true>(p, b, gx, smem, stream);
    if (q == 2) return launch<CodeT, 2, kTopK, true>(p, b, gx, smem, stream);
    return launch<CodeT, 1, kTopK, true>(p, b, gx, smem, stream);
  }
  if (q == 2) return launch<CodeT, 2, kTopK, false>(p, b, gx, smem, stream);
  return launch<CodeT, 1, kTopK, false>(p, b, gx, smem, stream);
}

template <bool kTopK>
int dispatch(const Params& p, int code_bytes, int b, int max_q, int sm_count,
             cudaStream_t stream) {
  if (b <= 0 || p.n <= 0) return 0;
  if (code_bytes != 1 && code_bytes != 2) return static_cast<int>(cudaErrorInvalidValue);
  const int q = queries_per_block(p, code_bytes, b, max_q);
  const long long smem = smem_for(code_bytes, p.mq, p.k, p.md, p.range_len, q);
  if (smem > kMaxDynamicSmem || b > 65535 || p.mq <= 0 ||
      p.k <= 0 || p.md <= 0 || p.range_len <= 0 || p.range_len > kMaxRange ||
      (kTopK && (p.top_k <= 0 || p.top_k > p.range_len)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gx = grid_x(p, b, q, sm_count);
  if (code_bytes == 1)
    return launch_typed<uint8_t, kTopK>(p, b, q, gx, (size_t)smem, stream);
  return launch_typed<uint16_t, kTopK>(p, b, q, gx, (size_t)smem, stream);
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
// sm_count: the card's SMs, which cap the code-set body's grid.
int hpc_qmaxsim(const float* table, const float* q_mask, const void* codes,
                int code_bytes, const uint8_t* d_mask, float* out, int b,
                int mq, int k, int n, int md, long long codes_bstride,
                long long mask_bstride, int range_len, int sm_count,
                void* stream) {
  const Params p{table, q_mask, codes, d_mask, nullptr, out, nullptr,
                 mq, k, n, md, (mq + 31) / 32, range_len, 0,
                 codes_bstride, mask_bstride, 0};
  return dispatch<false>(p, code_bytes, b, 4, sm_count,
                         static_cast<cudaStream_t>(stream));
}

// Per-range top-k: out_s/out_p (B, ceil(N / range_len), top_k), top_k <=
// range_len. valid (null = all valid) is indexed valid[b * valid_bstride + n].
// max_q (1, 2 or 4) caps the queries a block takes on the shared corpus.
int hpc_qmaxsim_topk(const float* table, const float* q_mask,
                     const void* codes, int code_bytes, const uint8_t* d_mask,
                     const uint8_t* valid, long long valid_bstride,
                     float* out_s, int* out_p, int b, int mq, int k, int n,
                     int md, long long codes_bstride, long long mask_bstride,
                     int range_len, int top_k, int max_q, int sm_count,
                     void* stream) {
  const Params p{table, q_mask, codes, d_mask, valid, out_s, out_p,
                 mq, k, n, md, (mq + 31) / 32, range_len, top_k,
                 codes_bstride, mask_bstride, valid_bstride};
  return dispatch<true>(p, code_bytes, b, max_q, sm_count,
                        static_cast<cudaStream_t>(stream));
}

// The launch hpc_qmaxsim (top_k = 0, max_q 4) or hpc_qmaxsim_topk makes at
// these shapes on a card of sm_count SMs, per_query != 0 for pools (a nonzero
// batch stride): out[0..7] = grid.x, grid.y, threads per block, dynamic
// shared bytes, queries per block, the body (1 the code set, 0 per slot),
// ranges a block walks at most, 0. Returns 0, or -1 when it launches
// nothing or refuses them.
int hpc_qmaxsim_geometry(int code_bytes, int b, int mq, int k, int n, int md,
                         int per_query, int range_len, int top_k, int max_q,
                         int sm_count, long long* out) {
  const Params p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr, mq, k, n, md, (mq + 31) / 32, range_len, top_k,
                 per_query ? 1LL : 0LL, per_query ? 1LL : 0LL, 0};
  if (b <= 0 || n <= 0 || (code_bytes != 1 && code_bytes != 2)) return -1;
  if (mq <= 0 || k <= 0 || md <= 0 || range_len <= 0 ||
      range_len > kMaxRange)
    return -1;
  const int q = queries_per_block(p, code_bytes, b, max_q);
  const long long smem = smem_for(code_bytes, mq, k, md, range_len, q);
  if (smem > kMaxDynamicSmem || b > 65535 ||
      (top_k != 0 && (top_k < 0 || top_k > range_len)))
    return -1;
  const int gx = grid_x(p, b, q, sm_count);
  const long long ranges = (n + range_len - 1) / range_len;
  const long long v[8] = {gx, (b + q - 1) / q,
                          code_set_body(k) ? Shape<true>::kThreads
                                           : Shape<false>::kThreads,
                          smem, q, code_set_body(k) ? 1 : 0,
                          (ranges + gx - 1) / gx, 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

const char* hpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
