// Nearest-centroid assignment (the K-means E-step) for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: src/repro/kernels/kmeans_assign.py, kmeans_assign_pallas
// (body _assign_kernel), the TPU kernel that quantizes the corpus.
//
//   codes[n] = argmin_k (||c_k||^2 - 2 x_n . c_k)     (first index on ties)
//
// What bounds it on the H100: f32 arithmetic. Quantizing the main path's
// corpus (16,777,216 x 128 against K=256) is 1.1e12 FLOP and 8.6 GB read:
// 16.4 ms at the 67 TFLOP/s f32 rate, 2.6 ms at 3.35 TB/s. It is a GEMM
// with an argmin epilogue, so the design is an SGEMM-style register tile
// that never writes the (N, K) distance matrix to device memory.
//
// Design: one block per SM (the grid is at most the SM count) walks the
// 64-row tiles of x. The codebook sits in dynamic shared memory, stored
// transposed (D rows of K centroids) with ||c||^2 beside it; at K=256,
// D=128 it takes 128 KB and is loaded once per block. A larger K is
// processed in chunks that fit, reloaded per row tile, with a running
// best per row. Each row tile is staged transposed (D x 64). 256 threads
// form a 16 x 16 grid; each thread owns 4 rows x 4 centroids of every
// 64-centroid pass and runs 16 FMAs per two 16-byte shared loads. The
// epilogue forms c2 - 2 x.c with one FMA, keeps a per-row best scanning
// centroids in ascending order with a strict '<', and a shuffle reduction
// over the 16 threads that share a row picks the lowest distance, the
// lowest index on ties. No tensor cores (wgmma would need TF32 or bf16 and
// move codes off the f32 reference), no TMA: right and simple first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBM = 64;        // rows per tile
constexpr int kBK = 64;        // centroids per pass of the thread grid
constexpr int kTM = 4;         // rows per thread
constexpr int kTN = 4;         // centroids per thread per pass
constexpr int kPad = 4;        // keeps float4 alignment, spreads banks
constexpr int kMaxDynamicSmem = 232448;

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int32_t* __restrict__ out, long long n, int d, int k,
                     int kc) {
  extern __shared__ float smem[];
  const int kcp = kc + kPad;
  const int xsp = kBM + kPad;
  float* s_c = smem;                        // (d, kcp) codebook chunk, transposed
  float* s_c2 = s_c + (size_t)d * kcp;      // (kc,) ||c||^2 of the chunk
  float* s_x = s_c2 + kc;                   // (d, xsp) row tile, transposed

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long n_tiles = (n + kBM - 1) / kBM;
  const int n_chunks = (k + kc - 1) / kc;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kBM;
    __syncthreads();  // the previous tile is done with s_x
    for (int t = threadIdx.x; t < kBM * d; t += kThreads) {
      const int r = t / d;
      const int dd = t - r * d;
      const long long row = row0 + r;
      s_x[dd * xsp + r] = row < n ? x[row * d + dd] : 0.f;
    }

    float best[kTM];
    int best_k[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      best[i] = INFINITY;
      best_k[i] = 0;
    }

    for (int ch = 0; ch < n_chunks; ++ch) {
      const int k0 = ch * kc;
      const int kn = min(kc, k - k0);
      if (n_chunks > 1 || tile == blockIdx.x) {
        __syncthreads();  // nobody still reads the previous chunk
        for (int t = threadIdx.x; t < kc * d; t += kThreads) {
          const int kk = t / d;
          const int dd = t - kk * d;
          s_c[dd * kcp + kk] =
              kk < kn ? c[(long long)(k0 + kk) * d + dd] : 0.f;
        }
        __syncthreads();
        for (int kk = threadIdx.x; kk < kc; kk += kThreads) {
          float s = 0.f;
          for (int dd = 0; dd < d; ++dd) {
            const float v = s_c[dd * kcp + kk];
            s = fmaf(v, v, s);
          }
          s_c2[kk] = s;
        }
      }
      __syncthreads();

      for (int kb = 0; kb < kn; kb += kBK) {
        float acc[kTM][kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
        const float* xp = s_x + ty * kTM;
        const float* cp = s_c + kb + tx * kTN;
#pragma unroll 8
        for (int dd = 0; dd < d; ++dd) {
          const float4 xv = *reinterpret_cast<const float4*>(xp + dd * xsp);
          const float4 cv = *reinterpret_cast<const float4*>(cp + dd * kcp);
          const float xr[kTM] = {xv.x, xv.y, xv.z, xv.w};
          const float cr[kTN] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(xr[i], cr[j], acc[i][j]);
        }
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int kk = kb + tx * kTN + j;
          if (kk < kn) {
            const float c2 = s_c2[kk];
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
              const float dist = fmaf(-2.f, acc[i][j], c2);
              if (dist < best[i]) {
                best[i] = dist;
                best_k[i] = k0 + kk;
              }
            }
          }
        }
      }
    }

    // the 16 threads of a row group are lanes 0-15 or 16-31 of one warp
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float v = best[i];
      int id = best_k[i];
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oid = __shfl_xor_sync(0xffffffffu, id, off);
        if (ov < v || (ov == v && oid < id)) {
          v = ov;
          id = oid;
        }
      }
      const long long row = row0 + ty * kTM + i;
      if (tx == 0 && row < n) out[row] = id;
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory for a codebook chunk of kc centroids of width d.
long long hpc_kmeans_assign_smem_bytes(int d, int kc) {
  return ((long long)d * (kc + kPad) + kc + (long long)d * (kBM + kPad)) *
         (long long)sizeof(float);
}

// Returns a cudaError_t (0 on success). kc is the codebook chunk held in
// shared memory, a positive multiple of 64; grid is the number of blocks.
int hpc_kmeans_assign(const float* x, const float* c, int32_t* out,
                      long long n, int d, int k, int kc, int grid,
                      void* stream) {
  if (n <= 0) return 0;
  const long long smem = hpc_kmeans_assign_smem_bytes(d, kc);
  if (d <= 0 || k <= 0 || kc <= 0 || kc % kBK != 0 || grid <= 0 ||
      smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kmeans_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kmeans_assign_kernel<<<grid, kThreads, (size_t)smem,
                         static_cast<cudaStream_t>(stream)>>>(x, c, out, n, d,
                                                              k, kc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
