// Fused ADC MaxSim for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/quantized_maxsim.py, quantized_maxsim_pallas
// (body _qmaxsim_kernel), the TPU kernel that scores every query of the
// flat scan and of the rerank.
//
//   out[b, n] = sum_i qm[b, i] * max_{j : dm[n, j] != 0} T[b, i, codes[n, j]]
//
// with T = Q C^T the (B, Mq, K) query x centroid table. A masked patch
// counts as -1e30, so an all-masked document scores sum_i qm[b, i] * -1e30.
//
// What bounds it on the H100: the masked max-lookups. One scan block of
// the main path (B=8, Mq=32, 256 docs x Md=615) is 4.0e7 lookups against
// 0.6 MB of codes, mask and table. Each lookup is one shared-memory load,
// and shared memory serves 32 loads per clock per SM (~8.4e12/s on an
// H100 SXM), which bounds a block at ~4.8 us; the f32 ALU rate (67
// TFLOP/s) would allow ~0.6 us and the bytes ~0.2 us.
//
// Design: the TPU kernel expands the codes into a one-hot matrix and runs
// the lookup on the MXU. Here the lookup is a direct gather from the table
// held in shared memory (Mq*K*4 B = 32 KB at Mq=32, K=256). The grid is
// (doc tiles, B); each block stages T[b] and qm[b] once, and each warp
// scores one document at a time: it stages the document's codes in shared
// memory (masked or out-of-range codes become -1), then for every query
// patch takes a lane-strided masked max and a shuffle max over the warp;
// every lane accumulates qm * max in query-patch order. Codes and mask are
// read as stored (uint8 or uint16 codes, 1-byte mask), never widened in
// device memory. Strides give both layouts: batch stride 0 for the shared
// corpus (N, Md), P*Md for per-query pools (B, P, Md). The ragged last
// tile is masked in the kernel. Right and simple first: no TMA, no
// persistence, one launch per scan block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kDocsPerWarp = 2;
constexpr int kDocsPerBlock = kWarps * kDocsPerWarp;
constexpr float kNegInf = -1e30f;
constexpr int kMaxDynamicSmem = 232448;  // 227 KB, the most a block may use

template <typename CodeT>
__global__ void __launch_bounds__(kWarps * 32)
qmaxsim_kernel(const float* __restrict__ table, const float* __restrict__ q_mask,
               const CodeT* __restrict__ codes,
               const uint8_t* __restrict__ d_mask, float* __restrict__ out,
               int mq, int k, int n, int md, long long codes_bstride,
               long long mask_bstride) {
  extern __shared__ float smem[];
  float* s_tab = smem;                                   // (mq, k)
  float* s_qm = s_tab + (size_t)mq * k;                  // (mq,)
  int* s_codes = reinterpret_cast<int*>(s_qm + mq);      // (kWarps, md)

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float* tab_b = table + (size_t)b * mq * k;
  for (int t = threadIdx.x; t < mq * k; t += blockDim.x) s_tab[t] = tab_b[t];
  for (int t = threadIdx.x; t < mq; t += blockDim.x)
    s_qm[t] = q_mask[(size_t)b * mq + t];
  __syncthreads();

  int* row = s_codes + (size_t)warp * md;
  const CodeT* codes_b = codes + b * codes_bstride;
  const uint8_t* mask_b = d_mask + b * mask_bstride;
  for (int r = 0; r < kDocsPerWarp; ++r) {
    const int doc = blockIdx.x * kDocsPerBlock + r * kWarps + warp;
    if (doc >= n) break;  // uniform across the warp
    const CodeT* c_row = codes_b + (size_t)doc * md;
    const uint8_t* m_row = mask_b + (size_t)doc * md;
    for (int j = lane; j < md; j += 32) {
      const int c = static_cast<int>(c_row[j]);
      row[j] = (m_row[j] != 0 && c < k) ? c : -1;
    }
    __syncwarp();
    float acc = 0.f;
    for (int i = 0; i < mq; ++i) {
      const float* t_row = s_tab + (size_t)i * k;
      float m = kNegInf;
      for (int j = lane; j < md; j += 32) {
        const int c = row[j];
        if (c >= 0) m = fmaxf(m, t_row[c]);
      }
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      acc += s_qm[i] * m;
    }
    if (lane == 0) out[(size_t)b * n + doc] = acc;
    __syncwarp();  // the next document overwrites this warp's code row
  }
}

template <typename CodeT>
cudaError_t allow_large_smem() {
  // once per process (thread-safe static init); raising the cap only
  // permits larger launches, each launch still asks for what it needs
  static const cudaError_t status = cudaFuncSetAttribute(
      qmaxsim_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  return status;
}

template <typename CodeT>
int launch(const float* table, const float* q_mask, const void* codes,
           const uint8_t* d_mask, float* out, int b, int mq, int k, int n,
           int md, long long codes_bstride, long long mask_bstride,
           size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_large_smem<CodeT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kDocsPerBlock - 1) / kDocsPerBlock, b);
  qmaxsim_kernel<CodeT><<<grid, kWarps * 32, smem, stream>>>(
      table, q_mask, static_cast<const CodeT*>(codes), d_mask, out, mq, k, n,
      md, codes_bstride, mask_bstride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper checks it first.
long long hpc_qmaxsim_smem_bytes(int mq, int k, int md) {
  return ((long long)mq * k + mq) * (long long)sizeof(float) +
         (long long)kWarps * md * (long long)sizeof(int);
}

// Returns a cudaError_t (0 on success). code_bytes is 1 (uint8 codes) or
// 2 (uint16 codes); strides are in elements.
int hpc_qmaxsim(const float* table, const float* q_mask, const void* codes,
                int code_bytes, const uint8_t* d_mask, float* out, int b,
                int mq, int k, int n, int md, long long codes_bstride,
                long long mask_bstride, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const long long smem = hpc_qmaxsim_smem_bytes(mq, k, md);
  if (smem > kMaxDynamicSmem || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    return launch<uint8_t>(table, q_mask, codes, d_mask, out, b, mq, k, n, md,
                           codes_bstride, mask_bstride, (size_t)smem, s);
  if (code_bytes == 2)
    return launch<uint16_t>(table, q_mask, codes, d_mask, out, b, mq, k, n,
                            md, codes_bstride, mask_bstride, (size_t)smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* hpc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
