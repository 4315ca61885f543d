// Float MaxSim late interaction for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: src/repro/kernels/maxsim.py, maxsim_pallas (body
// _maxsim_kernel), the TPU kernel of the cascade's stage 3 (the exact
// rerank of the p2 survivors) and of the float_flat scan.
//
//   out[b, n] = sum_i qm[b, i] * max_{j : dm[n, j] != 0} <q[b, i], d[n, j]>
//
// in f32, with every dot product a chain of f32 FMAs (no TF32). A masked
// patch counts as -1e30, so an all-masked document scores
// sum_i qm[b, i] * -1e30, finite.
//
// What bounds it on the H100: the cascade's stage 3 (B=8, Mq=32, D=128,
// 64 candidates x Md=615 per query) is 2.58 GFLOP against 161 MB of
// gathered float patches: 48 us at 3.35 TB/s, 38.5 us at the 67 TFLOP/s f32
// rate, so bytes. One shared-corpus block of float_flat (256 docs for all
// 8 queries) is 10.3 GFLOP against 80.6 MB: 154 us, so operations.
//
// Design: the TPU kernel runs one (Mq, D) x (T*Md, D)^T matmul per tile on
// the MXU. Here each block owns one query b and walks documents; the grid
// is (B, doc slots), with b the fastest index so the B blocks that read one
// shared-corpus document run together and share it through L2. A block
// stages 32 query rows in shared memory, then streams the document's
// patches through shared memory 128 at a time, with the chunk's mask
// beside them; rows are padded to a multiple of 4 floats with zeros (which
// add nothing to a dot product) plus 4 floats of skew. Its 256 threads form
// an 8 x 32 grid: warp w owns query rows 4w..4w+3, lane l owns patches
// l, l+32, l+64, l+96, so the lanes' 16-byte loads fall in distinct banks.
// Per 4 elements of D a thread makes eight 16-byte shared loads and 64 FMAs
// (a 4 x 4 register tile, each dot product summed in ascending D). After
// each chunk a thread folds its valid patches into a running max per
// query row; a shuffle max over the warp's lanes and a per-warp partial sum
// in shared memory give the score. The ragged last chunk is masked in the
// kernel; Mq beyond 32 loops over query chunks and adds each chunk's
// partial sum in order. Strides give both layouts: batch stride 0 for the
// shared corpus (N, Md, D), P*Md*D for per-query pools (B, P, Md, D). Right
// and simple first: no tensor cores (they would need TF32 or bf16 and move
// scores off the f32 reference), no TMA, no double buffering.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // 8 warps x 32 lanes
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 4;                   // query rows per thread
constexpr int kTN = 4;                   // patches per thread
constexpr int kQRows = kWarps * kTM;     // 32 query rows per pass
constexpr int kChunk = 32 * kTN;         // 128 patches per chunk
constexpr int kSkew = 4;                 // floats after each padded row
constexpr float kNegInf = -1e30f;
constexpr int kMaxDynamicSmem = 232448;
constexpr int kMaxDocSlots = 65535;      // grid.y limit

// Copy `rows` rows of width d (row r at src + r * d, zero when r >= valid)
// into shared rows of stride `stride` padded with zeros to dp = d rounded
// up to 4. `vec` says d % 4 == 0 and src is 16-byte aligned.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int valid, int d,
                                           int dp, int stride, bool vec) {
  const int d4 = dp >> 2;
  if (vec) {
    for (int t = threadIdx.x; t < rows * d4; t += kThreads) {
      const int r = t / d4;
      const int c = (t - r * d4) << 2;
      const float4 v = r < valid
          ? *reinterpret_cast<const float4*>(src + (long long)r * d + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + r * stride + c) = v;
    }
  } else {
    for (int t = threadIdx.x; t < rows * dp; t += kThreads) {
      const int r = t / dp;
      const int c = t - r * dp;
      dst[r * stride + c] = r < valid && c < d ? src[(long long)r * d + c]
                                               : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const float* __restrict__ q, const float* __restrict__ qm,
              const float* __restrict__ docs,
              const uint8_t* __restrict__ d_mask, float* __restrict__ out,
              int mq, int n, int md, int d, long long docs_bstride,
              long long mask_bstride, bool vec) {
  extern __shared__ float smem[];
  const int dp = (d + 3) & ~3;
  const int stride = dp + kSkew;
  float* s_q = smem;                                // (kQRows, stride)
  float* s_d = s_q + kQRows * stride;               // (kChunk, stride)
  float* s_part = s_d + kChunk * stride;            // (kWarps,)
  int* s_valid = reinterpret_cast<int*>(s_part + kWarps);  // (kChunk,)

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* q_b = q + (long long)b * mq * d;
  const float* qm_b = qm + (long long)b * mq;
  const float* docs_b = docs + b * docs_bstride;
  const uint8_t* mask_b = d_mask + b * mask_bstride;

  for (int i0 = 0; i0 < mq; i0 += kQRows) {
    __syncthreads();  // nobody still reads the previous query chunk
    stage_rows(s_q, q_b + (long long)i0 * d, kQRows, mq - i0, d, dp, stride,
               vec);
    for (int doc = blockIdx.y; doc < n; doc += gridDim.y) {
      const float* doc_p = docs_b + (long long)doc * md * d;
      const uint8_t* doc_m = mask_b + (long long)doc * md;
      float run[kTM];
#pragma unroll
      for (int ii = 0; ii < kTM; ++ii) run[ii] = kNegInf;

      for (int c0 = 0; c0 < md; c0 += kChunk) {
        __syncthreads();  // the previous chunk (and s_part) is done with
        stage_rows(s_d, doc_p + (long long)c0 * d, kChunk, md - c0, d, dp,
                   stride, vec);
        for (int p = threadIdx.x; p < kChunk; p += kThreads)
          s_valid[p] = c0 + p < md && doc_m[c0 + p] != 0;
        __syncthreads();

        float acc[kTM][kTN];
#pragma unroll
        for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
          for (int jj = 0; jj < kTN; ++jj) acc[ii][jj] = 0.f;
        const float* qp = s_q + warp * kTM * stride;
        const float* dpt = s_d + lane * stride;
        for (int c = 0; c < dp; c += 4) {
          float4 qv[kTM], dv[kTN];
#pragma unroll
          for (int ii = 0; ii < kTM; ++ii)
            qv[ii] = *reinterpret_cast<const float4*>(qp + ii * stride + c);
#pragma unroll
          for (int jj = 0; jj < kTN; ++jj)
            dv[jj] = *reinterpret_cast<const float4*>(
                dpt + jj * 32 * stride + c);
#pragma unroll
          for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
            for (int jj = 0; jj < kTN; ++jj) {
              float a = acc[ii][jj];
              a = fmaf(qv[ii].x, dv[jj].x, a);
              a = fmaf(qv[ii].y, dv[jj].y, a);
              a = fmaf(qv[ii].z, dv[jj].z, a);
              acc[ii][jj] = fmaf(qv[ii].w, dv[jj].w, a);
            }
        }
#pragma unroll
        for (int jj = 0; jj < kTN; ++jj) {
          if (s_valid[lane + jj * 32]) {
#pragma unroll
            for (int ii = 0; ii < kTM; ++ii)
              run[ii] = fmaxf(run[ii], acc[ii][jj]);
          }
        }
      }

      // max over the warp's lanes (patches), then this warp's rows' sum
      float part = 0.f;
#pragma unroll
      for (int ii = 0; ii < kTM; ++ii) {
        float m = run[ii];
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        const int row = i0 + warp * kTM + ii;
        if (row < mq) part += qm_b[row] * m;
      }
      if (lane == 0) s_part[warp] = part;
      __syncthreads();
      if (threadIdx.x == 0) {
        float total = 0.f;
        for (int w = 0; w < kWarps; ++w) total += s_part[w];
        float* o = out + (long long)b * n + doc;
        *o = i0 == 0 ? total : *o + total;
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at width d.
long long hpc_maxsim_smem_bytes(int d) {
  const long long stride = ((d + 3) & ~3) + kSkew;
  return ((kQRows + kChunk) * stride + kWarps) * (long long)sizeof(float) +
         (long long)kChunk * (long long)sizeof(int);
}

// Returns a cudaError_t (0 on success). q is (B, Mq, D) f32 and contiguous,
// qm (B, Mq) f32, docs (N, Md, D) or (B, P, Md, D) f32 with the given batch
// stride, d_mask 1 byte per patch, out (B, N) f32; strides are in elements.
// Needs Mq >= 1 and Md >= 1.
int hpc_maxsim(const float* q, const float* qm, const float* docs,
               const uint8_t* d_mask, float* out, int b, int mq, int n,
               int md, int d, long long docs_bstride, long long mask_bstride,
               void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const long long smem = hpc_maxsim_smem_bytes(d);
  if (d <= 0 || mq <= 0 || md <= 0 || smem > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec = d % 4 == 0 && docs_bstride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(docs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid(b, n < kMaxDocSlots ? n : kMaxDocSlots);
  maxsim_kernel<<<grid, kThreads, (size_t)smem,
                  static_cast<cudaStream_t>(stream)>>>(
      q, qm, docs, d_mask, out, mq, n, md, d, docs_bstride, mask_bstride,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
