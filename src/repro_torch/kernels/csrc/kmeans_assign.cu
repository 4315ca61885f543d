// Nearest-centroid assignment (the K-means E-step) for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: src/repro/kernels/kmeans_assign.py, kmeans_assign_pallas
// (body _assign_kernel), the TPU kernel that quantizes the corpus.
//
//   codes[n] = argmin_k (||c_k||^2 - 2 x_n . c_k)     (first index on ties)
//
// What bounds it on the H100: quantizing the main path's corpus
// (16,777,216 x 128 against K=256) is 1.1e12 FLOP and 8.6 GB read: 2.6 ms
// at 3.35 TB/s, 6.7 ms for the three TF32 products of 3xTF32 at 495
// TFLOP/s, 16.4 ms in f32 FMAs at 67 TFLOP/s. It is a GEMM with an argmin
// epilogue, so the design runs the product on the tensor cores and never
// writes the (N, K) distance matrix to device memory.
//
// Design: a persistent grid (at most one block per SM, and no more blocks
// than tiles) walks row tiles of x. The codebook stays resident in dynamic
// shared memory in f32 (rows padded and swizzled as tf32x3.cuh says), with
// ||c||^2 beside it, computed once per block in f32 FMAs over ascending D
// from device memory. x tiles arrive through a two-slot ring of cp.async
// 16-byte copies: the next tile loads while this one computes. Each of the
// 8 warps owns 32 rows (2 m tiles) x NT n tiles of 8 centroids and runs
// mma.sync m16n8k8 in 3xTF32 (tf32x3.cuh). The build takes 64-row tiles
// (2 warps along the rows x 4 along the centroids, NT = 8); a launch with
// fewer 64-row tiles than SMs, like a cascade batch's 256 query rows, takes
// 32-row tiles (8 warps along the centroids, NT = 4) to spread over twice
// the SMs, since one tile's 6144 products on one SM set its time. The
// codebook is split into hi and lo as each B fragment is loaded (and the x
// tile as each A fragment is) rather than once: hi and lo of the whole
// codebook would fill shared memory with no room for the x ring, and hi
// and lo of 128-centroid halves would mean reloading a half per tile or a
// second pass over x (8.6 GB more read at the build's shape); each B
// fragment serves the warp's 2 m tiles, so the split costs about one
// instruction per product. The epilogue forms c2 - 2 x.c with one FMA,
// keeps a per-row best over ascending k with a strict '<', then takes the
// lowest distance (lowest index on ties) across the 4 lanes that share a
// row and across the warps along the centroids through shared memory. A K
// that does not fit is taken in chunks, reloaded per tile; D is padded to
// a multiple of 16 with zeros, which add nothing to a product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDynamicSmem = 232448;

// WM warps along the rows (32 rows each: a tile is WM * 32 rows) and
// 8 / WM along the centroids, each with NT n tiles of 8 centroids.
template <int NT, int WM>
__global__ void __launch_bounds__(kThreads, 1)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int32_t* __restrict__ out, long long n, int d, int k,
                     int kc, int stages, bool vec) {
  constexpr int kWarpsN = kWarps / WM;
  constexpr int kBM = WM * 32;             // rows per tile
  constexpr int kPass = kWarpsN * NT * 8;  // centroids per pass of the block
  using namespace tf32x3;
  extern __shared__ __align__(16) float smem[];
  const int dp = padded_width(d);
  float* s_c = smem;                                   // (kc, dp)
  float* s_c2 = s_c + (size_t)kc * dp;                 // (kc,)
  float* s_x = s_c2 + kc;                              // (stages, kBM, dp)
  float* s_bd = s_x + (size_t)stages * kBM * dp;       // (kBM, kWarpsN)
  int* s_bk = reinterpret_cast<int*>(s_bd + kBM * kWarpsN);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const long long n_tiles = (n + kBM - 1) / kBM;
  const int n_chunks = (k + kc - 1) / kc;

  auto stage_chunk = [&](int ch) {  // codebook rows [ch*kc, ch*kc + kc)
    const int k0 = ch * kc;
    stage_rows<kThreads>(s_c, c + (long long)k0 * d, kc, k - k0, d, dp,
                         vec);
  };
  // ||c||^2 in ascending D, +inf past K; read from device memory (L2),
  // where a thread's row is contiguous, not from the staged rows, whose
  // same column sits in one bank for every row; 8 loads in flight at once
  auto norms = [&](int ch) {
    const int k0 = ch * kc;
    for (int kk = threadIdx.x; kk < kc; kk += kThreads) {
      float s = INFINITY;
      if (k0 + kk < k) {
        s = 0.f;
        const float* row = c + (long long)(k0 + kk) * d;
        int dd = 0;
        if (vec) {
          for (; dd + 32 <= d; dd += 32) {
            float4 v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              v[u] = __ldg(reinterpret_cast<const float4*>(row + dd) + u);
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              s = fmaf(v[u].x, v[u].x, s);
              s = fmaf(v[u].y, v[u].y, s);
              s = fmaf(v[u].z, v[u].z, s);
              s = fmaf(v[u].w, v[u].w, s);
            }
          }
        }
        for (; dd < d; ++dd) s = fmaf(row[dd], row[dd], s);
      }
      s_c2[kk] = s;
    }
  };
  auto stage_tile = [&](long long tile, int slot) {
    const long long row0 = tile * kBM;
    stage_rows<kThreads>(s_x + (size_t)slot * kBM * dp, x + row0 * d, kBM,
                         n - row0, d, dp, vec);
  };

  long long tile = blockIdx.x;
  if (tile >= n_tiles) return;
  if (n_chunks == 1) stage_chunk(0);
  stage_tile(tile, 0);
  cp_async_commit();
  if (n_chunks == 1) norms(0);  // while the copies land

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int slot = stages == 2 ? (it & 1) : 0;
    const long long next = tile + gridDim.x;
    cp_async_wait_all();
    __syncthreads();  // this tile (and a resident codebook) is in; the
                      // other slot is free
    if (stages == 2 && next < n_tiles) {
      stage_tile(next, slot ^ 1);
      cp_async_commit();
    }
    const float* xs = s_x + (size_t)slot * kBM * dp;

    float best[4];
    int best_k[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      best[r] = INFINITY;
      best_k[r] = 0;
    }

    for (int ch = 0; ch < n_chunks; ++ch) {
      if (n_chunks > 1) {
        __syncthreads();  // nobody still reads the previous chunk
        stage_chunk(ch);
        cp_async_commit();
        norms(ch);
        cp_async_wait_all();
        __syncthreads();
      }
      const int k0 = ch * kc;
      for (int pb = 0; pb < kc && k0 + pb < k; pb += kPass) {
        float acc[2][NT][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        // every row this thread reads is g mod 8: one swizzle for all
        const int sw = swizzle(g, dp);
        const float* ap = xs + (size_t)(wm * 32 + g) * dp + 4 * t;
        const float* bp = s_c + (size_t)(pb + wn * NT * 8 + g) * dp + 4 * t;
        for (int d0 = 0; d0 < dp; d0 += 16) {
          const int col = d0 ^ sw;
          float4 av[2][2], bv[NT];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            av[mt][0] = *reinterpret_cast<const float4*>(
                ap + (size_t)(mt * 16) * dp + col);
            av[mt][1] = *reinterpret_cast<const float4*>(
                ap + (size_t)(mt * 16 + 8) * dp + col);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            bv[nt] = *reinterpret_cast<const float4*>(
                bp + (size_t)(nt * 8) * dp + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t a_hi[2][4], a_lo[2][4], b_hi[NT][2], b_lo[NT][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              split_a(h ? hi2(av[mt][0]) : lo2(av[mt][0]),
                      h ? hi2(av[mt][1]) : lo2(av[mt][1]), a_hi[mt], a_lo[mt]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              split_b(h ? hi2(bv[nt]) : lo2(bv[nt]), b_hi[nt], b_lo[nt]);
            mma3_tiles<2, NT>(acc, a_hi, a_lo, b_hi, b_lo);
          }
        }
        // rows (mt, half) = wm*32 + mt*16 + half*8 + g; centroids in
        // ascending order: n tile, then column 2t, 2t + 1
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kk = pb + wn * NT * 8 + nt * 8 + 2 * t + j;
            const float c2 = s_c2[kk];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int r = mt * 2 + half;
                const float dist = fmaf(-2.f, acc[mt][nt][half * 2 + j], c2);
                if (dist < best[r]) {
                  best[r] = dist;
                  best_k[r] = k0 + kk;
                }
              }
          }
      }
    }

    // lowest distance, then lowest index: across the row's 4 lanes, then
    // across the 4 warps along k
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = best[r];
      int id = best_k[r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oid = __shfl_xor_sync(0xffffffffu, id, off);
        if (ov < v || (ov == v && oid < id)) {
          v = ov;
          id = oid;
        }
      }
      if (t == 0) {
        const int row = wm * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
        s_bd[row * kWarpsN + wn] = v;
        s_bk[row * kWarpsN + wn] = id;
      }
    }
    __syncthreads();
    if (threadIdx.x < kBM) {
      const int row = threadIdx.x;
      float v = s_bd[row * kWarpsN];
      int id = s_bk[row * kWarpsN];
      for (int w = 1; w < kWarpsN; ++w) {
        const float ov = s_bd[row * kWarpsN + w];
        const int oid = s_bk[row * kWarpsN + w];
        if (ov < v || (ov == v && oid < id)) {
          v = ov;
          id = oid;
        }
      }
      const long long grow = tile * kBM + row;
      if (grow < n) out[grow] = id;
    }
    if (stages == 1 && next < n_tiles) {
      __syncthreads();  // everyone is done with the slot
      stage_tile(next, 0);
      cp_async_commit();
    }
  }
}

long long smem_bytes(int d, int kc, int stages, int wm) {
  const long long dp = tf32x3::padded_width(d);
  return ((long long)kc * dp + kc + (long long)stages * wm * 32 * dp +
          2LL * kThreads) * (long long)sizeof(float);
}

struct Config {
  int nt;      // n tiles per warp
  int wm;      // warps along the rows
  int kc;      // codebook chunk held in shared memory
  int stages;  // x tiles in the ring
  long long smem;
};

// The first configuration that fits, with the largest codebook chunk:
//   32-row tiles of 256-centroid passes (8 warps along k) when 64-row
//   tiles would leave SMs idle, so a cascade batch's 256 query rows take
//   8 SMs and not 4;
//   64-row tiles of 256-centroid passes (the build);
//   64-row tiles of 32-centroid passes (K <= 32, or a D too wide for a
//   256-centroid chunk), with two ring slots, then with one.
bool choose(int d, int k, long long n, int sm_count, Config* cfg) {
  struct Shape {
    int nt, wm, stages;
  };
  const Shape shapes[4] = {{4, 1, 2}, {8, 2, 2}, {1, 2, 2}, {1, 2, 1}};
  for (const Shape& sh : shapes) {
    const int pass = kWarps / sh.wm * sh.nt * 8;
    if (sh.nt > 1 && k <= 32) continue;
    if (sh.wm == 1 && (n + 63) / 64 >= sm_count) continue;
    const int full = (k + pass - 1) / pass * pass;
    for (int kc = full; kc >= pass; kc -= pass) {
      const long long smem = smem_bytes(d, kc, sh.stages, sh.wm);
      if (smem <= kMaxDynamicSmem) {
        *cfg = Config{sh.nt, sh.wm, kc, sh.stages, smem};
        return true;
      }
    }
  }
  return false;
}

template <int NT, int WM>
cudaError_t launch(const float* x, const float* c, int32_t* out, long long n,
                   int d, int k, const Config& cfg, int sm_count,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      kmeans_assign_kernel<NT, WM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (attr != cudaSuccess) return attr;
  const long long n_tiles = (n + WM * 32 - 1) / (WM * 32);
  const int grid = (int)(n_tiles < sm_count ? n_tiles : sm_count);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  kmeans_assign_kernel<NT, WM><<<grid, kThreads, (size_t)cfg.smem, stream>>>(
      x, c, out, n, d, k, cfg.kc, cfg.stages, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the build-sized launch takes at this (D, K), or
// -1 when no configuration fits in a block's 227 KB.
long long hpc_kmeans_assign_smem_bytes(int d, int k) {
  Config cfg;
  if (d <= 0 || k <= 0 || !choose(d, k, 1LL << 40, 1, &cfg)) return -1;
  return cfg.smem;
}

// The launch hpc_kmeans_assign makes at these shapes: out[0..7] = grid.x,
// grid.y, threads per block, dynamic shared bytes, rows per tile, n tiles
// per warp, codebook chunk, ring slots. Returns 0, or -1 when it launches
// nothing or refuses them.
int hpc_kmeans_assign_geometry(long long n, int d, int k, int sm_count,
                               long long* out) {
  Config cfg;
  if (n <= 0 || d <= 0 || k <= 0 || sm_count <= 0 ||
      !choose(d, k, n, sm_count, &cfg))
    return -1;
  const long long n_tiles = (n + cfg.wm * 32 - 1) / (cfg.wm * 32);
  const long long v[8] = {n_tiles < sm_count ? n_tiles : sm_count, 1,
                          kThreads, cfg.smem, cfg.wm * 32, cfg.nt, cfg.kc,
                          cfg.stages};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// Returns a cudaError_t (0 on success). x (N, D) and c (K, D) f32 and
// contiguous, out (N,) int32; sm_count caps the persistent grid.
int hpc_kmeans_assign(const float* x, const float* c, int32_t* out,
                      long long n, int d, int k, int sm_count, void* stream) {
  if (n <= 0) return 0;
  Config cfg;
  if (d <= 0 || k <= 0 || sm_count <= 0 || !choose(d, k, n, sm_count, &cfg))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cfg.wm == 1)
    err = launch<4, 1>(x, c, out, n, d, k, cfg, sm_count, s);
  else if (cfg.nt == 8)
    err = launch<8, 2>(x, c, out, n, d, k, cfg, sm_count, s);
  else
    err = launch<1, 2>(x, c, out, n, d, k, cfg, sm_count, s);
  return static_cast<int>(err);
}

}  // extern "C"
