// Binary (Hamming) MaxSim for Hopper (sm_90a), plain C interface for ctypes.
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
// What bounds it on the H100: the popcounts. One stage-1 block of the
// cascade (B=8, Mq=32, 256 docs x Md=615) is 4.0e7 popcounts against
// 0.3 MB of codes and mask. The popcount rate is 16 per clock per SM
// (CUDA C++ Programming Guide, arithmetic-instruction throughput, cc 9.0),
// ~4.2e12/s on an H100 SXM at 1980 MHz: ~9.6 us per block, where the
// bytes alone would take ~0.1 us.
//
// Design: the grid is (doc tiles, B); one warp scores one document for one
// query. The warp keeps the query's codes (masked to `bits`) in registers,
// 32 query patches at a time; each lane walks the document's patches with
// stride 32 (Md needs no alignment: the ragged tail is the loop bound),
// reads each code as stored (uint8 or uint16) with its bool mask, and keeps
// the minimum popcount per query patch. A transposing butterfly (31
// shuffles) then leaves lane l with the minimum over the warp for query
// patch l; lanes turn it into bits - min (or -(2^20) if nothing was valid),
// weight it and a 5-step shuffle sum finishes the score. Strides give both
// layouts: batch stride 0 for the shared corpus (N, Md), P*Md for per-query
// pools (B, P, Md). Right and simple first: no shared-memory popcount
// table, one launch per scan block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;        // documents per block
constexpr int kQChunk = 32;      // query patches per pass (one per lane)
constexpr int kNone = 64;        // above any 32-bit popcount
constexpr int kMasked = -(1 << 20);

// One butterfly step: lanes with bit W set keep the upper half of their
// W-value window and send the lower half, so after W = 16, 8, 4, 2, 1 lane
// l holds the minimum over all lanes of entry l.
template <int W>
__device__ __forceinline__ void min_step(int (&v)[kQChunk], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int send = upper ? v[k] : v[k + W];
    const int keep = upper ? v[k + W] : v[k];
    const int recv = __shfl_xor_sync(0xffffffffu, send, W);
    v[k] = min(keep, recv);
  }
}

template <typename CodeT>
__global__ void __launch_bounds__(kWarps * 32)
hamming_kernel(const int32_t* __restrict__ q_codes,
               const int32_t* __restrict__ q_w,
               const CodeT* __restrict__ codes,
               const uint8_t* __restrict__ d_mask, int32_t* __restrict__ out,
               int mq, int n, int md, int bits, long long codes_bstride,
               long long mask_bstride) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int doc = blockIdx.x * kWarps + warp;
  if (doc >= n) return;  // uniform across the warp; no block barrier below

  const uint32_t cmask = (1u << bits) - 1u;
  const CodeT* c_row = codes + b * codes_bstride + (long long)doc * md;
  const uint8_t* m_row = d_mask + b * mask_bstride + (long long)doc * md;
  const int32_t* qc_b = q_codes + (long long)b * mq;
  const int32_t* qw_b = q_w + (long long)b * mq;

  int acc = 0;
  for (int i0 = 0; i0 < mq; i0 += kQChunk) {
    // every lane holds the chunk's query codes; past Mq they are 0 and
    // weigh 0
    uint32_t qv[kQChunk];
#pragma unroll
    for (int k = 0; k < kQChunk; ++k)
      qv[k] = i0 + k < mq ? static_cast<uint32_t>(qc_b[i0 + k]) & cmask : 0u;
    int best[kQChunk];
#pragma unroll
    for (int k = 0; k < kQChunk; ++k) best[k] = kNone;
    for (int j = lane; j < md; j += 32) {
      if (m_row[j] == 0) continue;
      const uint32_t d = static_cast<uint32_t>(c_row[j]) & cmask;
#pragma unroll
      for (int k = 0; k < kQChunk; ++k)
        best[k] = min(best[k], __popc(qv[k] ^ d));
    }
    min_step<16>(best, lane);
    min_step<8>(best, lane);
    min_step<4>(best, lane);
    min_step<2>(best, lane);
    min_step<1>(best, lane);
    const int i = i0 + lane;
    const int sim = best[0] == kNone ? kMasked : bits - best[0];
    int term = i < mq ? qw_b[i] * sim : 0;
    for (int off = 16; off > 0; off >>= 1)
      term += __shfl_xor_sync(0xffffffffu, term, off);
    acc += term;
  }
  if (lane == 0) out[(long long)b * n + doc] = acc;
}

template <typename CodeT>
int launch(const int32_t* q_codes, const int32_t* q_w, const void* codes,
           const uint8_t* d_mask, int32_t* out, int b, int mq, int n, int md,
           int bits, long long codes_bstride, long long mask_bstride,
           cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  hamming_kernel<CodeT><<<grid, kWarps * 32, 0, stream>>>(
      q_codes, q_w, static_cast<const CodeT*>(codes), d_mask, out, mq, n, md,
      bits, codes_bstride, mask_bstride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch hpc_hamming_maxsim makes at these shapes: out[0..7] = grid.x,
// grid.y, threads per block, dynamic shared bytes, documents per block,
// 0, 0, 0. Returns 0, or -1 when it launches nothing or refuses them.
int hpc_hamming_geometry(int b, int n, int bits, long long* out) {
  if (b <= 0 || n <= 0 || bits < 1 || bits > 16 || b > 65535) return -1;
  const long long v[8] = {(n + kWarps - 1) / kWarps, b, kWarps * 32, 0,
                          kWarps, 0, 0, 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// Returns a cudaError_t (0 on success). q_codes and q_w are (B, Mq) int32;
// code_bytes is 1 (uint8 codes) or 2 (uint16); d_mask is 1 byte per patch;
// out is (B, N) int32; strides are in elements.
int hpc_hamming_maxsim(const int32_t* q_codes, const int32_t* q_w,
                       const void* codes, int code_bytes,
                       const uint8_t* d_mask, int32_t* out, int b, int mq,
                       int n, int md, int bits, long long codes_bstride,
                       long long mask_bstride, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (bits < 1 || bits > 16 || mq < 0 || md < 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(q_codes, q_w, codes, d_mask, out, b, mq, n, md,
                           bits, codes_bstride, mask_bstride, s);
  if (code_bytes == 2)
    return launch<uint16_t>(q_codes, q_w, codes, d_mask, out, b, mq, n, md,
                            bits, codes_bstride, mask_bstride, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
