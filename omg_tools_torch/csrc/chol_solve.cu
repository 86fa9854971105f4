// Batched small SPD solves for the ALM Newton step, written for Hopper
// (sm_90a).  Built by omg_tools_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces the two lane-batched Pallas TPU kernels of
// omg_tools_tpu/ops/pallas_kernels.py:
//   K1 _chol_solve_kernel        (psd_solve:        H dx = g)
//   K2 _chol_solve_multi_kernel  (psd_solve_multi:  H X = G, r columns)
// K1 is the r = 1 case of the one kernel below.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3, 67 TFLOP/s f32 without
// tensor cores; nvidia-smi names that part "NVIDIA H100 80GB HBM3").
// Main-path shapes of the p2p_holonomic rollout at B = 4096 scenarios:
//   K2: N = 4096 * 5 tail blocks, n = 33, r = 27.  It must read the lower
//       triangle of H (46 MB) and G (73 MB) and write X (73 MB): about
//       192 MB, ~57 us at the memory rate.  Its arithmetic, n^3/3 + 2 n^2 r
//       per system, is about 1.45 GFLOP, ~22 us at the f32 rate:
//       memory-bound.
//   K1: N = 4096, n = 26, r = 1: about 6.6 MB, ~2 us at the memory rate,
//       so a launch (a few us) and the serial pivot chain bound it.
//
// Design.  The TPU kernel puts 128 systems side by side in the vector
// lanes and keeps the factor in VMEM.  Here one warp owns one system:
// its matrix and right-hand-side panel sit in shared memory (n = 33,
// r = 27 is about 8 KB), several warps share a block, and the factor never
// goes back to device memory -- only X is written.
//   - Cholesky: right-looking, column by column; the lanes of the warp
//     take the rows of the trailing update.  Only the lower triangle is
//     read from device memory and updated.
//   - Substitutions: lanes over the right-hand-side columns; for r = 1
//     the lanes split each row's dot product and reduce with shuffles.
//   - No padding: the systems are exactly n x n; a ragged last block just
//     has idle warps.  The shared-memory row stride is n rounded up to an
//     odd number so that lanes walking down a column hit distinct banks.
//   - A non-positive pivot gives rsqrt of a negative number or of zero,
//     so the output is non-finite (NaN), as in the TPU kernel; the ALM's
//     per-lane non-finite fallback relies on that.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void chol_solve_kernel(const float* __restrict__ H,
                                  const float* __restrict__ G,
                                  float* __restrict__ X,
                                  int N, int n, int r, int ldl) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long sys = (long long)blockIdx.x * warps + warp;
  if (sys >= N) return;  // whole warp leaves; only warp-level syncs below

  float* L = smem + (size_t)warp * (n * ldl + n * r);
  float* Z = L + n * ldl;  // (n, r) row-major, becomes X in place
  const float* Hs = H + sys * n * n;
  const float* Gs = G + sys * n * r;
  float* Xs = X + sys * n * r;

  // stage the lower triangle of H and the whole panel G
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n;
    const int k = e - i * n;
    if (k <= i) L[i * ldl + k] = Hs[e];
  }
  for (int e = lane; e < n * r; e += 32) Z[e] = Gs[e];
  __syncwarp();

  // right-looking Cholesky, L overwrites the lower triangle
  for (int j = 0; j < n; ++j) {
    const float inv = rsqrtf(L[j * ldl + j]);
    __syncwarp();
    for (int i = j + lane; i < n; i += 32) L[i * ldl + j] *= inv;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float lij = L[i * ldl + j];
      for (int k = j + 1; k <= i; ++k) L[i * ldl + k] -= lij * L[k * ldl + j];
    }
    __syncwarp();
  }

  if (r == 1) {
    // forward L z = g, then backward L' x = z; lanes split each dot product
    for (int i = 0; i < n; ++i) {
      float part = 0.f;
      for (int k = lane; k < i; k += 32) part += L[i * ldl + k] * Z[k];
      part = warp_sum(part);
      if (lane == 0) Z[i] = (Z[i] - part) / L[i * ldl + i];
      __syncwarp();
    }
    for (int i = n - 1; i >= 0; --i) {
      float part = 0.f;
      for (int k = i + 1 + lane; k < n; k += 32) part += L[k * ldl + i] * Z[k];
      part = warp_sum(part);
      if (lane == 0) Z[i] = (Z[i] - part) / L[i * ldl + i];
      __syncwarp();
    }
  } else {
    // each lane owns whole right-hand-side columns: no cross-lane traffic
    for (int c = lane; c < r; c += 32) {
      for (int i = 0; i < n; ++i) {
        float acc = 0.f;
        for (int k = 0; k < i; ++k) acc += L[i * ldl + k] * Z[k * r + c];
        Z[i * r + c] = (Z[i * r + c] - acc) / L[i * ldl + i];
      }
      for (int i = n - 1; i >= 0; --i) {
        float acc = 0.f;
        for (int k = i + 1; k < n; ++k) acc += L[k * ldl + i] * Z[k * r + c];
        Z[i * r + c] = (Z[i * r + c] - acc) / L[i * ldl + i];
      }
    }
  }
  __syncwarp();
  for (int e = lane; e < n * r; e += 32) Xs[e] = Z[e];
}

constexpr int kMaxSmem = 232448;       // 227 KB: a block's limit on sm_90
constexpr int kDefaultSmem = 48 * 1024;

int launch(const float* H, const float* G, float* X, int N, int n, int r,
           cudaStream_t stream) {
  // an empty batch is the caller's to skip: it launches nothing
  if (N <= 0 || n <= 0 || r <= 0) return (int)cudaErrorInvalidValue;
  const int ldl = n | 1;  // odd stride: conflict-free column walks
  const size_t per_sys = sizeof(float) * (size_t)(n * ldl + n * r);
  if (per_sys > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int warps = (int)(kDefaultSmem / per_sys);
  warps = warps < 1 ? 1 : (warps > 4 ? 4 : warps);
  const size_t smem = per_sys * warps;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (N + warps - 1) / warps;
  chol_solve_kernel<<<blocks, 32 * warps, smem, stream>>>(H, G, X, N, n, r,
                                                         ldl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: dx[b] = H[b]^-1 g[b];  H (N, n, n), g and dx (N, n), row-major f32.
int omg_psd_solve_f32(const float* H, const float* g, float* dx, int N, int n,
                      void* stream) {
  return launch(H, g, dx, N, n, 1, (cudaStream_t)stream);
}

// K2: X[b] = H[b]^-1 G[b];  H (N, n, n), G and X (N, n, r), row-major f32.
int omg_psd_solve_multi_f32(const float* H, const float* G, float* X, int N,
                            int n, int r, void* stream) {
  return launch(H, G, X, N, n, r, (cudaStream_t)stream);
}

}  // extern "C"
