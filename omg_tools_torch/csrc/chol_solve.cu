// Batched small SPD solves for the ALM Newton step, written for Hopper
// (sm_90a).  Built by omg_tools_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces the two lane-batched Pallas TPU kernels of
// omg_tools_tpu/ops/pallas_kernels.py:
//   K1 _chol_solve_kernel        (psd_solve:        H dx = g)
//   K2 _chol_solve_multi_kernel  (psd_solve_multi:  H X = G, r columns)
// Both compute X[b] = H[b]^-1 G[b] for SPD H (N, n, n), reading only the
// lower triangle of H; a non-positive pivot makes that system's output
// non-finite (rsqrt of a non-positive number), never an error, and leaves
// every other system alone: the ALM's per-lane fallback reads it.
//
// What bounds them on an H100 SXM (3.35 TB/s HBM3, 67 TFLOP/s f32 without
// tensor cores; nvidia-smi names that part "NVIDIA H100 80GB HBM3") at the
// compact-arrow path's shapes (B = 4096 scenarios):
//   K2: N = 20,480 tail blocks, n = 33, r = 27.  It must read the lower
//       triangle of H (46 MB) and G (73 MB) and write X (73 MB): 192 MB,
//       57 us at the memory rate; its n^3/3 + 2 n^2 r multiply-adds are
//       22 us at the f32 rate.  Bytes bound it on paper.  In practice one
//       warp's solve is a chain of ~100 dependent steps (33 pivots, then
//       33 rows each way), each a few hundred cycles of shared-memory,
//       shuffle and rsqrt latency, and the card holds ~16 such warps an
//       SM: the chains, not the bytes, set the time.
//   K1: N = 4,096, n = 26, r = 1: 6.6 MB, 2 us at the memory rate.  The
//       launch and one system's chain of 26 pivots bound it, provided all
//       4,096 warps are resident at once.
//
// Design: short steps in the chain, no serial reductions, and every
// system of K1 resident in one wave.
//   - One warp solves one system at a time, in a persistent loop over
//     systems; a block holds up to four warps.  When a warp walks more
//     than one system, the next one's lower triangle is copied into a
//     second shared-memory stage with cp.async while the current one is
//     solved; otherwise one stage, so that more warps fit.  The copies are
//     element-wide (4 or 8 bytes), so a tensor whose data pointer is only
//     element-aligned (a slice H[1:]) is taken as it is; a row's copies
//     are consecutive, so they coalesce.  Rows sit in shared memory at an
//     odd number of 16-byte units, so that eight lanes reading 16 bytes of
//     eight rows hit distinct banks.
//   - Cholesky in the left-looking (Crout) order, unrolled: at pivot j
//     each lane's row takes its dot product with row j, read from shared
//     memory as 16-byte broadcasts, four partial sums.  In the 32-row
//     class (K1) each lane keeps its row in registers (factor_reg): one
//     shared load per four FMAs.  In the larger classes (K2) a second
//     register row would spill, so the rows stay in shared memory
//     (factor_smem); lane l owns rows l and l + 32, and a lane whose first
//     row is done takes its second, so at n = 33 row 32 costs no second
//     pass after pivot 0 (wrapping it onto lane 0 throughout would double
//     the warp's work a pivot); the sums over the columns finished before
//     pivot j are taken while pivot j is, so the chain from pivot to pivot
//     is shuffle, rsqrt, multiply, shuffle, FMA.
//   - r = 1 (K1): g rides along as an augmented row [H; g'], so the Crout
//     sweep leaves L^-1 g in that row (its lane is idle otherwise at
//     n < 32): the forward substitution costs nothing and its 26 warp
//     reductions are gone.  The backward substitution runs column by
//     column: x_i by shuffle, one FMA a lane.
//   - r > 1 (K2): each lane keeps one right-hand-side column in registers
//     (passes of 32 columns when r > 32), loaded from G; both
//     substitutions read L's rows as 16-byte broadcasts, one shared load
//     per four FMAs; X is written row by row, consecutive lanes on
//     consecutive addresses.
//   - Size classes, not shapes: NMAX = 32, 48 or 64 rows (n, plus the
//     augmented row when r = 1) bound the unrolled loops and register
//     arrays; n and r are run-time values within a class.
//   - float32 in every class; float64 in the 64-row class.  Full-precision
//     FMAs only, no tensor cores in float32 (no TF32): these Newton
//     systems are ill-conditioned.
// Larger systems take the tiled variants, one kernel (chol_tile_kernel):
// `block` (variant 0), one CTA of 256 threads a system, and `global`
// (variant 1), a thread-block cluster of P = 2..8 CTAs a system, for
// systems whose tiles exceed one CTA's shared memory (float64 above 215
// rows, float32 above 315: the warehouse's 395, systems of 262 in
// float64).  They replace a one-warp Crout kernel (a run-time dot product
// a row and two warp barriers a pivot: ~n^2/2 dependent steps on one warp)
// and a global-workspace kernel (three block barriers a column, the
// trailing triangle through L2 every panel), both slower than
// cholesky_ex + cholesky_solve on one system.
//   What bounds them: on one system (the closed loops' Newton step, 85-395
//   rows) the chain of n pivots, each an rsqrt and its broadcast, and the
//   n steps of the backward substitution, with the trailing update and
//   the panel solve between tiles; on wide batches (1,024-4,096 systems
//   of 85-190 rows, float32) the FMAs and the shared-memory reads of the
//   trailing update, with enough CTAs resident to hide each one's chain.
//   The bytes (the lower triangle once) bound neither.
//   The design:
//   - Columns in tiles of 32 (the last ragged); tile j holds rows j 32 ..
//     m - 1 (m = n + r: G' rides along as r augmented rows, so the
//     factorization leaves (L^-1 G)' in them) column-major, at a stride of
//     an odd number of 16-byte units: only the lower triangle is stored
//     (151 float32 rows: 64 KB, 3 CTAs an SM).  Tiles are loaded with
//     cp.async, tile 0 apart, so that its factor starts while the others
//     arrive.  A CTA walks one system; the hardware keeps 2-8 CTAs an SM
//     resident, which overlaps one's load with the others' work (a second
//     stage a CTA would halve them).
//   - Right-looking by tiles, a barrier a tile step, none a pivot: one
//     warp factors the diagonal block in registers (a lane a row; the
//     pivots' chain in registers, L's column broadcast through shared
//     memory), all warps solve the panel below it (a thread a row), then
//     update the trailing tiles: float32 in 4 x 4 register items of FMAs,
//     float64 in 8 x 8 items on the FP64 tensor cores (mma.sync m8n8k4:
//     IEEE float64 fused multiply-adds, twice the FP64 FMA rate).  The
//     owner of the next tile updates it first and factors it (warp 0)
//     while the other warps update the rest.
//   - global: the tiles, largest first, go to the least-loaded CTA of the
//     cluster; the owner of a panel factors it and releases it with a
//     split cluster barrier (arrive after the factor, wait before the
//     read), the others copy it from its shared memory (DSMEM) and update
//     their own tiles: one cluster barrier a panel, no global workspace.
//     The launch checks with cudaOccupancyMaxActiveClusters that the
//     cluster fits and refuses it otherwise (beyond 8 CTAs: ~439 float64,
//     ~691 float32 rows).
//   - Backward substitution by tiles, last first: the owner solves the
//     diagonal block, a warp a right-hand side (a lane a column, x_i by
//     shuffle), then every CTA takes x off the z of its earlier tiles.
//   - float32 on one CTA refines once: the residual G - H X in float64
//     (H's lower triangle read again from device memory) into the
//     augmented rows, its forward substitution by tiles, the backward
//     again, X += d.  The bench scene's dense Newton systems lose up to
//     ~1e-2 of x to float32 rounding in any Cholesky (the library's too),
//     enough to move a rollout's lane at an active-set decision; one step
//     leaves a few roundings of X, as a float64 solve of the same float32
//     system would.  float64, and the global variant (no float32 path),
//     do not refine.
//   - float64 CTAs get 255 registers (one CTA an SM: these are single
//     systems); float32 ones 85 (three an SM: wide batches).
// The variant is chosen by the caller (omg_tools_torch/ops/psd_kernels.py
// variant()); the entry point checks that it fits and returns
// cudaErrorInvalidValue, launching nothing, when it does not.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;              // warps a block, class variants
constexpr int kMaxSmem = 232448;       // 227 KB: a block's limit on sm_90
constexpr int kDefaultSmem = 48 * 1024;

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int W = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int W = 2; };

__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsq(double x) { return rsqrt(x); }

__device__ __forceinline__ float at(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}
__device__ __forceinline__ double at(const double2& v, int c) {
  return c == 0 ? v.x : v.y;
}

// Row stride in elements: a whole number of 16-byte units, and an odd
// one, so that eight lanes reading 16 bytes from eight rows hit distinct
// banks.
__host__ __device__ __forceinline__ int row_stride(int n, int W) {
  int ld = (n + W - 1) / W * W;
  if ((ld / W) % 2 == 0) ld += W;
  return ld;
}
__host__ __device__ __forceinline__ int round_up(int n, int W) {
  return (n + W - 1) / W * W;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(static_cast<int>(sizeof(T))));
}
// one element, or a zero where `take` is false (no source byte read)
template <typename T>
__device__ __forceinline__ void cp_async_or_zero(T* dst, const T* src,
                                                 bool take) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(static_cast<int>(sizeof(T))),
               "r"(take ? static_cast<int>(sizeof(T)) : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <typename T>
__device__ __forceinline__ T sum_parts(const T (&a)[4]) {
  return (a[0] + a[1]) + (a[2] + a[3]);
}
template <typename T>
__device__ __forceinline__ T sum_parts(const T (&a)[2]) {
  return a[0] + a[1];
}

// Li[col] minus row i's dot product with row j over their first kend
// entries, both read from shared memory as 16-byte vectors (row j as a
// broadcast), four partial sums; unrolled, so kend must be a constant
// after unrolling.
template <typename T>
__device__ __forceinline__ T row_dot(const T* Li, const T* Lj, int kend,
                                     int col) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::W;
  T acc[W];
#pragma unroll
  for (int c = 0; c < W; ++c) acc[c] = T(0);
#pragma unroll
  for (int k = 0; k + W <= kend; k += W) {
    const V a = *reinterpret_cast<const V*>(Li + k);
    const V b = *reinterpret_cast<const V*>(Lj + k);
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = fma(at(a, c), at(b, c), acc[c]);
  }
  T t = Li[col];
#pragma unroll
  for (int k = kend / W * W; k < kend; ++k) t = fma(-Li[k], Lj[k], t);
  return t - sum_parts(acc);
}

// A row's first n entries (16-byte loads; the row stride covers n rounded
// up to whole vectors) into registers, zeros beyond.
template <typename T, int CNT>
__device__ __forceinline__ void load_row(T (&a)[CNT], const T* row, int n) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::W;
#pragma unroll
  for (int k = 0; k < CNT; k += W) {
    if (k < n) {
      const V v = *reinterpret_cast<const V*>(row + k);
#pragma unroll
      for (int c = 0; c < W; ++c) a[k + c] = at(v, c);
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) a[k + c] = T(0);
    }
  }
}

// Cholesky in the left-looking (Crout) order, in place, of the m rows of
// S (m = n, or n + 1 with the augmented row g'), unrolled to NMAX rows;
// writes L's lower triangle (and the augmented row's L^-1 g) and
// dinv[j] = 1 / L[j][j].
//
// Rows: in the classes above 32 rows lane l owns rows l and l + 32; at
// pivot j a lane whose first row is finished (l < j) takes its second, so
// while at most 32 rows are left every lane works on one row a pivot, and
// a second pass runs only while more are left (j < m - 32: at m = 33 only
// at j = 0).
//
// Pipelining: s_i(j+1) = A[i][j+1] - sum_{k<j+1} L[i][k] L[j+1][k].  All
// but the last term read columns finished before pivot j, so each lane
// sums them from shared memory while pivot j is taken, and adds the last
// term, L[i][j] (its own, in a register) times L[j+1][j] (one shuffle),
// after.  The chain from pivot to pivot is shuffle, rsqrt, multiply,
// shuffle, FMA: no shared-memory round trip in it.
template <typename T, int NMAX>
__device__ __forceinline__ void factor_smem(T* S, T* dinv, int n, int m,
                                            int ld, int lane) {
  constexpr bool TWO = NMAX > 32;
  const int i2 = lane + 32;
  T s1 = lane < m ? S[lane * ld] : T(0);            // s for pivot 0
  T s2 = TWO && i2 < m ? S[i2 * ld] : T(0);
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j >= n) break;
    const int r1 = (!TWO || lane >= j) ? lane : i2;  // this pivot's rows
    const bool on1 = r1 >= j && r1 < m;
    const bool on2 = TWO && j < m - 32 && lane >= j && i2 < m;
    // the next pivot's rows and their sums over the finished columns
    const int q1 = (!TWO || lane >= j + 1) ? lane : i2;
    const bool next1 = j + 1 < n && q1 >= j + 1 && q1 < m;
    const bool next2 = TWO && j + 1 < n && j + 1 < m - 32 &&
                       lane >= j + 1 && i2 < m;
    const T* Ln = S + (j + 1) * ld;
    T p1 = T(0), p2 = T(0);
    if (next1) p1 = row_dot(S + q1 * ld, Ln, j, j + 1);
    if (next2) p2 = row_dot(S + i2 * ld, Ln, j, j + 1);
    // pivot j
    const T d = __shfl_sync(kFull, s1, j & 31);
    const T inv = rsq(d);
    const T l1 = s1 * inv, l2 = s2 * inv;
    if (on1 && r1 > j) S[r1 * ld + j] = l1;
    if (on2) S[i2 * ld + j] = l2;
    if (lane == (j & 31)) {
      S[j * ld + j] = d * inv;
      dinv[j] = inv;
    }
    // the last term of the next pivot's sums; L[j+1][j] is a first-pass
    // value (row j + 1 is lane (j + 1) % 32's row at pivot j)
    const T lnj = __shfl_sync(kFull, l1, (j + 1) & 31);
    s1 = fma(-(q1 == r1 ? l1 : l2), lnj, p1);
    s2 = fma(-l2, lnj, p2);
    __syncwarp();
  }
}

// The 32-row class: the same Crout order with each lane's row in
// registers (a[]): at pivot j the row takes its dot product with row j,
// which comes from shared memory as 16-byte broadcasts -- one shared load
// per four FMAs, none for the lane's own row.  Each new L[i][j] goes to
// the lane's register and to S, where row i is read as a broadcast at
// pivot i.  (In the larger classes a second register row spills, so they
// keep their rows in shared memory: factor_smem.)
template <typename T>
__device__ __forceinline__ void factor_reg(T* S, T* dinv, int n, int m,
                                           int ld, int lane) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::W;
  T a[32];
  load_row(a, S + (lane < m ? lane : 0) * ld, n);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j >= n) break;
    const T* Lj = S + j * ld;
    T acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = T(0);
#pragma unroll
    for (int k = 0; k < j; k += W) {
      const V v = *reinterpret_cast<const V*>(Lj + k);
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (k + c < j) acc[c] = fma(a[k + c], at(v, c), acc[c]);
    }
    const T s = a[j] - sum_parts(acc);
    const T d = __shfl_sync(kFull, s, j);
    const T inv = rsq(d);
    const T l = s * inv;
    a[j] = l;
    if (lane > j && lane < m) S[lane * ld + j] = l;
    if (lane == j) {
      S[j * ld + j] = d * inv;
      dinv[j] = inv;
    }
    __syncwarp();
  }
}

// r = 1: x = L'^-1 z, z = L^-1 g being the augmented row n of S; lane l
// keeps z[l] and z[l + 32]; x_i goes to every lane by shuffle, and each
// lane takes x_i's multiple of L[i][k] off its own entries.  Writes x.
template <typename T, int RPL>
__device__ __forceinline__ void backward_one(const T* S, const T* dinv,
                                             T* x, int n, int ld, int lane) {
  T z[RPL];
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int k = lane + 32 * q;
    z[q] = k < n ? S[n * ld + k] : T(0);
  }
#pragma unroll 1
  for (int i = n - 1; i >= 0; --i) {
    const T zi = (RPL == 1 || i < 32) ? z[0] : z[RPL - 1];
    const T xi = __shfl_sync(kFull, zi, i & 31) * dinv[i];
    const T* Li = S + i * ld;
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int k = lane + 32 * q;
      if (k < i) z[q] = fma(-Li[k], xi, z[q]);
      else if (k == i) z[q] = xi;
    }
  }
#pragma unroll
  for (int q = 0; q < RPL; ++q) {
    const int k = lane + 32 * q;
    if (k < n) x[k] = z[q];
  }
}

// r > 1: z <- L'^-1 L^-1 z, this lane's column in registers.
template <typename T, int NMAX>
__device__ __forceinline__ void subst_cols(const T* S, const T* dinv,
                                           T (&z)[NMAX], int n, int ld) {
  using V = typename Vec<T>::type;
  constexpr int W = Vec<T>::W;
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    if (i >= n) break;
    const T* Li = S + i * ld;
    T acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = T(0);
#pragma unroll
    for (int k = 0; k + W <= i; k += W) {
      const V l = *reinterpret_cast<const V*>(Li + k);
#pragma unroll
      for (int c = 0; c < W; ++c) acc[c] = fma(at(l, c), z[k + c], acc[c]);
    }
    T t = z[i];
#pragma unroll
    for (int k = i / W * W; k < i; ++k) t = fma(-Li[k], z[k], t);
    z[i] = (t - sum_parts(acc)) * dinv[i];
  }
#pragma unroll
  for (int i = NMAX - 1; i >= 0; --i) {
    if (i >= n) continue;
    const T* Li = S + i * ld;
    const T xi = z[i] * dinv[i];
    z[i] = xi;
#pragma unroll
    for (int k = 0; k + W <= i; k += W) {
      const V l = *reinterpret_cast<const V*>(Li + k);
#pragma unroll
      for (int c = 0; c < W; ++c) z[k + c] = fma(-at(l, c), xi, z[k + c]);
    }
#pragma unroll
    for (int k = i / W * W; k < i; ++k) z[k] = fma(-Li[k], xi, z[k]);
  }
}

// Class variants: a warp walks systems in a persistent loop.  A stage
// holds the lower triangle of one system's H in rows of stride ld (for
// r = 1 with g as row n); with two stages the next system is copied in
// while this one is solved.
template <typename T, int NMAX, bool ONE>
__global__ void __launch_bounds__(32 * kWarps, ONE ? 8 : 4)
chol_warp_kernel(const T* __restrict__ H, const T* __restrict__ G,
                 T* __restrict__ X, int N, int n, int r, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int W = Vec<T>::W;
  constexpr int RPL = NMAX > 32 ? 2 : 1;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = ONE ? n + 1 : n;
  const int ld = row_stride(n, W);
  const int len = m * ld;
  T* base = reinterpret_cast<T*>(smem_raw) +
            static_cast<size_t>(warp) * (stages * len + NMAX);
  T* dinv = base + stages * len;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  long long sys = static_cast<long long>(blockIdx.x) * warps + warp;
  if (sys >= N) return;  // whole warp leaves; only warp-level syncs below
  const long long nn = static_cast<long long>(n) * n;
  const long long nr = static_cast<long long>(n) * r;
  auto fill = [&](T* S, long long s) {
    const T* Hs = H + s * nn;
    for (int i = 0; i < n; ++i)
      for (int k = lane; k <= i; k += 32)
        cp_async(S + i * ld + k, Hs + static_cast<size_t>(i) * n + k);
    if (ONE)
      for (int k = lane; k < n; k += 32) cp_async(S + n * ld + k, G + s * n + k);
  };
  if (stages == 2) {
    fill(base, sys);
    cp_commit();
  }
  int cur = 0;
  for (; sys < N; sys += stride) {
    T* S = base + cur * len;
    if (stages == 2) {
      const long long nxt = sys + stride;
      if (nxt < N) fill(base + (cur ^ 1) * len, nxt);
      cp_commit();
      cp_wait_prev();
    } else {
      fill(S, sys);
      cp_commit();
      cp_wait_all();
    }
    __syncwarp();
    if constexpr (NMAX > 32) factor_smem<T, NMAX>(S, dinv, n, m, ld, lane);
    else factor_reg(S, dinv, n, m, ld, lane);
    if constexpr (ONE) {
      backward_one<T, RPL>(S, dinv, X + sys * n, n, ld, lane);
    } else {
      const T* Gs = G + sys * nr;
      T* Xs = X + sys * nr;
      for (int c = lane; c - lane < r; c += 32) {
        T z[NMAX];
#pragma unroll
        for (int i = 0; i < NMAX; ++i)
          if (i < n) z[i] = c < r ? Gs[static_cast<size_t>(i) * r + c] : T(0);
        subst_cols<T, NMAX>(S, dinv, z, n, ld);
        if (c < r) {
#pragma unroll
          for (int i = 0; i < NMAX; ++i)
            if (i < n) Xs[static_cast<size_t>(i) * r + c] = z[i];
        }
      }
    }
    __syncwarp();  // before this stage is refilled
    if (stages == 2) cur ^= 1;
  }
}

// Tiled variants (block: one CTA a system; global: a cluster of P CTAs a
// system), one kernel for both.  m = n + r rows: the lower triangle of H,
// then the r rows of G' (augmented rows).  The columns are cut into tiles
// of kTB; tile j holds columns j kTB .. j kTB + w_j - 1 (w_j = kTB but for
// the last) of rows j kTB .. m - 1, column-major at a stride ld_j of
// whole 16-byte units, an odd number of them (a column of 4 rows is one
// or two 16-byte vectors, and a warp's vectors along a row of tiles hit
// distinct banks).  Each tile lives in the shared memory of the CTA that
// owns it (tile_map: the tiles, largest first, to the least-loaded CTA).
constexpr int kTB = 32;                // columns a tile
constexpr int kTileThreads = 256;      // threads a CTA
constexpr int kSLD = kTB + 4;          // the diagonal block's scratch stride
constexpr int kMaxCluster = 8;         // CTAs a cluster (portable limit)
constexpr int kMaxTiles = 64;          // n <= 2,048

template <typename T>
__host__ __device__ __forceinline__ int tile_ld(int m, int j) {
  constexpr int W = 16 / static_cast<int>(sizeof(T));   // elements a vector
  int ld = round_up(m - j * kTB, 4);
  if ((ld / W) % 2 == 0) ld += W;
  return ld;
}

// owner[j], off[j]: the CTA that holds tile j and the tile's offset in its
// storage (elements); returns the largest storage of one CTA.
template <typename T>
__host__ __device__ inline int tile_map(int n, int m, int P, int* owner,
                                        int* off) {
  int load[kMaxCluster];
  for (int p = 0; p < P; ++p) load[p] = 0;
  int most = 0;
  const int nt = (n + kTB - 1) / kTB;
  for (int j = 0; j < nt; ++j) {
    int q = 0;
    for (int p = 1; p < P; ++p)
      if (load[p] < load[q]) q = p;
    owner[j] = q;
    off[j] = load[q];
    load[q] += kTB * tile_ld<T>(m, j);
    if (load[q] > most) most = load[q];
  }
  return most;
}

// Shared elements of one CTA: its tiles, a copy of a remote panel (P > 1),
// the diagonal block's scratch, the inverse pivots, x of one tile.
__host__ __device__ inline size_t tile_elems(int n, int r, int P, int most) {
  const int m = n + r;
  const size_t panel =
      P > 1 && m > kTB ? static_cast<size_t>(kTB) * round_up(m - kTB, 4) : 0;
  return static_cast<size_t>(most) + panel + kTB * kSLD + round_up(n, 4) +
         static_cast<size_t>(kTB) * r;
}

template <typename T>
size_t tile_smem(int n, int r, int P) {
  int owner[kMaxTiles], off[kMaxTiles];
  const int most = tile_map<T>(n, n + r, P, owner, off);
  return sizeof(T) * tile_elems(n, r, P, most);
}

// 4 consecutive elements from 16-byte aligned shared memory, and back
template <typename T> struct Four { T v[4]; };
__device__ __forceinline__ Four<float> ld4(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return {{a.x, a.y, a.z, a.w}};
}
__device__ __forceinline__ Four<double> ld4(const double* p) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  return {{a.x, a.y, b.x, b.y}};
}
__device__ __forceinline__ void st4(float* p, const Four<float>& f) {
  *reinterpret_cast<float4*>(p) = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
}
__device__ __forceinline__ void st4(double* p, const Four<double>& f) {
  *reinterpret_cast<double2*>(p) = make_double2(f.v[0], f.v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(f.v[2], f.v[3]);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of p (this CTA's shared memory) in CTA `rank`'s, as a
// generic pointer (distributed shared memory)
template <typename T>
__device__ __forceinline__ const T* remote(const T* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<const T*>(out);
}

// The diagonal block of a tile (w columns, rows 0 .. w - 1 of A), factored
// by one warp, no block barrier: lane i holds row i in registers,
// right-looking.  At pivot j each lane writes its L[i][j] to column j of
// the scratch S (at S + j kSLD) and takes L[t][j] for t > j from it as
// 16-byte broadcasts (four a load, where shuffles take one each).  The
// pivots' chain stays in registers: lane i keeps its diagonal entry apart
// (``diag``, updated by its own L[i][j]^2), so pivot j + 1 is one shuffle
// after pivot j's rsqrt, with no shared-memory round trip in between.
// Writes L back to A (lower part) and 1 / L[j][j] to dinv[j]; S keeps L's
// columns for the panel solve.
template <typename T>
__device__ __forceinline__ void factor_diag(T* A, int ld, int w, T* S,
                                            T* dinv, int lane) {
  T a[kTB];
  T diag = T(0);
#pragma unroll
  for (int t = 0; t < kTB; ++t) {
    a[t] = (t <= lane && lane < w) ? A[t * ld + lane] : T(0);
    if (t == lane) diag = a[t];
  }
#pragma unroll
  for (int j = 0; j < kTB; ++j) {
    if (j >= w) break;
    const T inv = rsq(__shfl_sync(kFull, diag, j));
    a[j] *= inv;
    diag = fma(-a[j], a[j], diag);
    if (lane == j) dinv[j] = inv;
    S[j * kSLD + lane] = a[j];
    __syncwarp();
#pragma unroll
    for (int g = (j + 1) / 4; g < kTB / 4; ++g) {
      const Four<T> l = ld4(S + j * kSLD + 4 * g);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * g + q > j) a[4 * g + q] = fma(-a[j], l.v[q], a[4 * g + q]);
    }
  }
#pragma unroll
  for (int t = 0; t < kTB; ++t)
    if (t <= lane && lane < w) A[t * ld + lane] = a[t];
  __syncwarp();
}

// The rows of a tile below its diagonal block (rows w .. len - 1 of A):
// L[i][:] = A[i][:] L_kk'^-1, a thread a row in registers, L_kk from the
// scratch as 16-byte broadcasts.
template <typename T>
__device__ __forceinline__ void panel_solve(T* A, int ld, int w, int len,
                                            const T* S, const T* dinv,
                                            int t_id, int nth) {
  for (int i = w + t_id; i < len; i += nth) {
    T a[kTB];
#pragma unroll
    for (int t = 0; t < kTB; ++t) a[t] = t < w ? A[t * ld + i] : T(0);
#pragma unroll
    for (int t = 0; t < kTB; ++t) {
      if (t >= w) break;
      a[t] *= dinv[t];
#pragma unroll
      for (int g = (t + 1) / 4; g < kTB / 4; ++g) {
        const Four<T> l = ld4(S + t * kSLD + 4 * g);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (4 * g + q > t) a[4 * g + q] = fma(-a[t], l.v[q], a[4 * g + q]);
      }
    }
#pragma unroll
    for (int t = 0; t < kTB; ++t)
      if (t < w) A[t * ld + i] = a[t];
  }
}

// The trailing update with panel k (rows (k + 1) kTB .. m - 1 of its L
// columns, at Pp, stride pld) of this CTA's tiles jlo <= j < jhi: A_j -=
// Pk Pk' on the lower triangle.  float32: items of 4 rows x 4 columns, a
// thread an item (threads t_id of nth), the 4 x 4 sums in registers, FMAs
// only.
template <typename T>
__device__ __forceinline__ void update_tiles_fma(
    T* base, const int* owner, const int* off, int rank, int m, int n, int k,
    int jlo, int jhi, const T* Pp, int pld, int t_id, int nth) {
  int j = jlo, start = 0;
  for (int e = t_id;; e += nth) {
    int R = 0, cbs = 0;
    for (; j < jhi; ++j) {       // the own tile that holds item e
      if (owner[j] != rank) continue;
      R = (m - j * kTB + 3) / 4;
      const int w = n - j * kTB < kTB ? n - j * kTB : kTB;
      cbs = (w + 3) / 4;
      if (e < start + R * cbs) break;
      start += R * cbs;
    }
    if (j >= jhi) return;
    const int le = e - start;
    const int cb = le / R, rb = le % R;
    if (rb < cb) continue;       // above the diagonal
    const int rel = (j - k - 1) * kTB;   // tile j's first row in the panel
    T acc[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = T(0);
#pragma unroll 4
    for (int t = 0; t < kTB; ++t) {
      const Four<T> a = ld4(Pp + t * pld + rel + 4 * rb);
      const Four<T> b = ld4(Pp + t * pld + rel + 4 * cb);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fma(a.v[x], b.v[y], acc[x][y]);
    }
    T* A = base + off[j];
    const int ld = tile_ld<T>(m, j);
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      T* col = A + (4 * cb + y) * ld + 4 * rb;
      Four<T> v = ld4(col);
#pragma unroll
      for (int x = 0; x < 4; ++x) v.v[x] -= acc[x][y];
      st4(col, v);
    }
  }
}


// float64: the same update on the FP64 tensor cores (IEEE float64 fused
// multiply-adds, mma.sync m8n8k4): items of 8 rows x 8 columns, a warp an
// item (warps t_id / 32 of nth / 32), 8 steps of 4 columns of the panel.
// Fragments: lane l holds A[l / 4][l % 4] (a panel row), B[l % 4][l / 4]
// (a panel row for a column) and C[l / 4][2 (l % 4) + {0, 1}].  Rows
// beyond the panel's or the tile's stored rows are read as zeros and not
// written.
__device__ __forceinline__ void dmma(double& c0, double& c1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c0), "+d"(c1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ void update_tiles_mma(
    double* base, const int* owner, const int* off, int rank, int m, int n,
    int k, int jlo, int jhi, const double* Pp, int pld, int t_id, int nth) {
  const int lane = t_id & 31, g = lane >> 2, tg = lane & 3;
  const int prows = round_up(m - (k + 1) * kTB, 4);   // the panel's rows
  int j = jlo, start = 0;
  for (int e = t_id >> 5;; e += nth >> 5) {
    int R = 0, cbs = 0;
    for (; j < jhi; ++j) {       // the own tile that holds item e
      if (owner[j] != rank) continue;
      R = (m - j * kTB + 7) / 8;
      const int w = n - j * kTB < kTB ? n - j * kTB : kTB;
      cbs = (w + 7) / 8;
      if (e < start + R * cbs) break;
      start += R * cbs;
    }
    if (j >= jhi) return;
    const int le = e - start;
    const int cb = le / R, rb = le % R;
    if (rb < cb) continue;       // above the diagonal
    const int rel = (j - k - 1) * kTB;   // tile j's first row in the panel
    const int pa = rel + 8 * rb + g, pb = rel + 8 * cb + g;
    double c0 = 0.0, c1 = 0.0;
#pragma unroll
    for (int t = 0; t < kTB; t += 4) {
      const double* col = Pp + (t + tg) * pld;
      dmma(c0, c1, pa < prows ? col[pa] : 0.0, pb < prows ? col[pb] : 0.0);
    }
    const int row = 8 * rb + g;
    if (row < round_up(m - j * kTB, 4)) {
      double* A = base + off[j];
      const int ld = tile_ld<double>(m, j);
      A[(8 * cb + 2 * tg) * ld + row] -= c0;
      A[(8 * cb + 2 * tg + 1) * ld + row] -= c1;
    }
  }
}

template <typename T>
__device__ __forceinline__ void update_tiles(
    T* base, const int* owner, const int* off, int rank, int m, int n, int k,
    int jlo, int jhi, const T* Pp, int pld, int t_id, int nth) {
  if constexpr (sizeof(T) == 8)
    update_tiles_mma(base, owner, off, rank, m, n, k, jlo, jhi, Pp, pld,
                     t_id, nth);
  else
    update_tiles_fma(base, owner, off, rank, m, n, k, jlo, jhi, Pp, pld,
                     t_id, nth);
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, sizeof(T) == 4 ? 3 : 1)
chol_tile_kernel(const T* __restrict__ H, const T* __restrict__ G,
                 T* __restrict__ X, int n, int r, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int owner[kMaxTiles], off[kMaxTiles], most_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = P > 1 ? static_cast<int>(cluster_rank()) : 0;
  const long long sys = blockIdx.x / P;
  const int m = n + r;
  const int nt = (n + kTB - 1) / kTB;
  if (tid == 0) most_s = tile_map<T>(n, m, P, owner, off);
  __syncthreads();
  T* base = reinterpret_cast<T*>(smem_raw);
  const int ldb = round_up(m - kTB, 4);
  T* buf = base + most_s;
  T* S = buf + (P > 1 && m > kTB ? kTB * ldb : 0);
  T* dinv = S + kTB * kSLD;
  T* xb = dinv + round_up(n, 4);
  const T* Hs = H + sys * static_cast<long long>(n) * n;
  const T* Gs = G + sys * static_cast<long long>(n) * r;
  auto width = [&](int j) { return n - j * kTB < kTB ? n - j * kTB : kTB; };

  // this CTA's tiles, by cp.async (all of a tile's copies in flight at
  // once): a lane a column (a row's 32 columns are one coalesced read), a
  // warp a group of 4 rows; H's lower triangle, then G' as rows n .. m - 1,
  // zeros elsewhere (copies of no source byte)
  for (int j = 0; j < nt; ++j) {
    if (owner[j] != rank) continue;
    T* A = base + off[j];
    const int c0 = j * kTB, ld = tile_ld<T>(m, j), w = width(j);
    const int c = c0 + lane;
    for (int g = warp; 4 * g < m - c0; g += kTileThreads / 32) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = c0 + 4 * g + q;
        const T* src = Hs;
        bool take = false;
        if (lane < w && i < n && i >= c) {
          src = Hs + static_cast<long long>(i) * n + c;
          take = true;
        } else if (lane < w && i >= n && i < m) {
          src = Gs + static_cast<long long>(c) * r + (i - n);
          take = true;
        }
        cp_async_or_zero(A + lane * ld + 4 * g + q, src, take);
      }
    }
    if (j == 0) cp_commit();     // tile 0 apart: its factor starts first
  }
  cp_commit();
  if (owner[0] == rank) cp_wait_prev(); else cp_wait_all();
  __syncthreads();

  // factorization, right-looking by tiles; the owner of tile k + 1 updates
  // it first and factors it (warp 0 the diagonal block while the other
  // warps update the rest of its tiles), then releases it to the cluster
  if (owner[0] == rank) {
    if (warp == 0) factor_diag(base, tile_ld<T>(m, 0), width(0), S, dinv, lane);
    __syncthreads();
    panel_solve(base, tile_ld<T>(m, 0), width(0), m, S, dinv, tid,
                kTileThreads);
  }
  cp_wait_all();
  __syncthreads();
  if (P > 1) cluster_arrive();
  for (int k = 0; k + 1 < nt; ++k) {
    if (P > 1) cluster_wait();   // panel k is out
    bool mine = false;           // any own tile right of k?
    for (int j = k + 1; j < nt; ++j) mine |= owner[j] == rank;
    const T* Pp;
    int pld;
    if (owner[k] == rank) {
      Pp = base + off[k] + kTB;
      pld = tile_ld<T>(m, k);
    } else {
      // copy panel k from its owner, column by column, 16 bytes a thread
      const int len4 = round_up(m - (k + 1) * kTB, 4);
      if (mine) {
        const T* src = remote(base + off[k] + kTB, owner[k]);
        const int ldk = tile_ld<T>(m, k);
        for (int e = tid; e < kTB * (len4 / 4); e += kTileThreads) {
          const int t = e / (len4 / 4), i = 4 * (e % (len4 / 4));
          st4(buf + t * ldb + i, ld4(src + t * ldk + i));
        }
      }
      __syncthreads();
      Pp = buf;
      pld = ldb;
    }
    const int c1 = (k + 1) * kTB;
    if (owner[k + 1] == rank) {
      T* A = base + off[k + 1];
      const int ld = tile_ld<T>(m, k + 1), w = width(k + 1);
      update_tiles(base, owner, off, rank, m, n, k, k + 1, k + 2, Pp, pld,
                   tid, kTileThreads);
      __syncthreads();
      if (warp == 0)
        factor_diag(A, ld, w, S, dinv + c1, lane);
      else
        update_tiles(base, owner, off, rank, m, n, k, k + 2, nt, Pp, pld,
                     tid - 32, kTileThreads - 32);
      __syncthreads();
      panel_solve(A, ld, w, m - c1, S, dinv + c1, tid, kTileThreads);
      __syncthreads();
      if (P > 1) cluster_arrive();
    } else {
      if (P > 1) cluster_arrive();
      update_tiles(base, owner, off, rank, m, n, k, k + 1, nt, Pp, pld, tid,
                   kTileThreads);
      __syncthreads();
    }
  }
  if (P > 1) cluster_wait();

  // backward substitution by tiles, last first: the owner of tile jt
  // solves its diagonal block, L_jj' x_j = z_j (a warp a right-hand side,
  // a lane a column's z, x_i by shuffle; x over z in the augmented rows
  // and in xb); every CTA then takes x_j off the z of its tiles left of jt
  auto backward = [&]() {
    for (int jt = nt - 1; jt >= 0; --jt) {
      const int c0 = jt * kTB, w = width(jt), ldj = tile_ld<T>(m, jt);
      if (owner[jt] == rank) {
        T* A = base + off[jt];
        for (int q = warp; q < r; q += kTileThreads / 32) {
          T z = lane < w ? A[lane * ldj + (n - c0) + q] : T(0);
          for (int i = w - 1; i >= 0; --i) {
            const T xi = __shfl_sync(kFull, z, i) * dinv[c0 + i];
            if (lane < i) z = fma(-A[lane * ldj + i], xi, z);
            else if (lane == i) z = xi;
          }
          if (lane < w) {
            A[lane * ldj + (n - c0) + q] = z;
            xb[q * kTB + lane] = z;
          }
          if (lane >= w) xb[q * kTB + lane] = T(0);
        }
      }
      __syncthreads();
      if (jt == 0) break;
      if (P > 1) cluster_sync();   // x_jt is out
      bool mine = false;
      for (int j = 0; j < jt; ++j) mine |= owner[j] == rank;
      if (mine) {
        if (owner[jt] != rank) {
          const T* A = remote(base + off[jt], owner[jt]);
          for (int e = tid; e < r * kTB; e += kTileThreads) {
            const int q = e / kTB, i = e % kTB;
            xb[e] = i < w ? A[i * ldj + (n - c0) + q] : T(0);
          }
          __syncthreads();
        }
        // z[q][c] -= L[c0 + i][c] x[q][i] over this CTA's columns c < c0: a
        // thread a (column, right-hand side), column fastest, i < w only
        // (rows beyond are z or padding)
        int j = 0, start = 0;
        for (int e = tid;; e += kTileThreads) {
          for (; j < jt; ++j) {
            if (owner[j] != rank) continue;
            if (e < start + kTB * r) break;
            start += kTB * r;
          }
          if (j >= jt) break;
          const int c = (e - start) % kTB, q = (e - start) / kTB;
          T* A2 = base + off[j];
          const int ld2 = tile_ld<T>(m, j);
          const T* Lc = A2 + c * ld2 + (c0 - j * kTB);
          const T* xq = xb + q * kTB;
          T acc[4] = {T(0), T(0), T(0), T(0)};
          for (int i = 0; i < w; i += 4) {
            const Four<T> l = ld4(Lc + i);
            const Four<T> x = ld4(xq + i);
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[u] = fma(l.v[u], x.v[u], acc[u]);
          }
          A2[c * ld2 + (n - j * kTB) + q] -= (acc[0] + acc[1]) + (acc[2] + acc[3]);
        }
      }
      __syncthreads();
    }
  };
  // X from the augmented rows of this CTA's tiles (or, refining, X += d)
  T* Xs = X + sys * static_cast<long long>(n) * r;
  auto store_x = [&](bool add) {
    for (int j = 0; j < nt; ++j) {
      if (owner[j] != rank) continue;
      const T* A = base + off[j];
      const int c0 = j * kTB, w = width(j), ld = tile_ld<T>(m, j);
      for (int e = tid; e < w * r; e += kTileThreads) {
        const int c = e / r, q = e % r;
        T* x = Xs + static_cast<long long>(c0 + c) * r + q;
        const T v = A[c * ld + (n - c0) + q];
        *x = add ? *x + v : v;
      }
    }
  };
  backward();
  store_x(false);
  if constexpr (sizeof(T) == 4) {
    if (P == 1) {
      // one step of refinement (float32, one CTA): the residual
      // G - H X in float64 from H's lower triangle in device memory, into
      // the augmented rows; its forward substitution by tiles (the
      // factorization did G's along the way); the backward again; X += d
      __syncthreads();           // X is out
      for (int e = tid; e < n * r; e += kTileThreads) {
        const int i = e % n, q = e / n;
        const T* Hi = Hs + static_cast<long long>(i) * n;
        const T* xq = Xs + q;
        double acc = static_cast<double>(Gs[static_cast<long long>(i) * r + q]);
        for (int j = 0; j <= i; ++j)
          acc -= static_cast<double>(Hi[j]) * static_cast<double>(xq[j * r]);
        for (int j = i + 1; j < n; ++j)
          acc -= static_cast<double>(Hs[static_cast<long long>(j) * n + i]) *
                 static_cast<double>(xq[j * r]);
        const int t = i / kTB, c0 = t * kTB;
        base[off[t] + (i - c0) * tile_ld<T>(m, t) + (n - c0) + q] =
            static_cast<T>(acc);
      }
      __syncthreads();
      // forward by tiles, first first: L_kk z_k = r_k (a warp a right-hand
      // side, a lane a row, z_i by shuffle), then r_c -= L[c][k] z_k for
      // the rows c of the later tiles (a thread a (row, right-hand side))
      for (int k = 0; k < nt; ++k) {
        const int c0 = k * kTB, w = width(k), ld = tile_ld<T>(m, k);
        T* A = base + off[k];
        for (int q = warp; q < r; q += kTileThreads / 32) {
          T z = lane < w ? A[lane * ld + (n - c0) + q] : T(0);
          for (int i = 0; i < w; ++i) {
            const T zi = __shfl_sync(kFull, z, i) * dinv[c0 + i];
            if (lane > i) z = fma(-A[i * ld + lane], zi, z);
            else if (lane == i) z = zi;
          }
          if (lane < w) A[lane * ld + (n - c0) + q] = z;
          xb[q * kTB + lane] = lane < w ? z : T(0);
        }
        __syncthreads();
        const int c1 = c0 + kTB, len = n - c1;
        for (int e = tid; e < len * r; e += kTileThreads) {
          const int c = c1 + e % len, q = e / len;
          const T* Lc = A + (c - c0);
          const T* zq = xb + q * kTB;
          T acc[4] = {T(0), T(0), T(0), T(0)};
          for (int i = 0; i < w; i += 4) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              acc[u] = fma(Lc[(i + u) * ld], zq[i + u], acc[u]);
          }
          const int t = c / kTB, d0 = t * kTB;
          base[off[t] + (c - d0) * tile_ld<T>(m, t) + (n - d0) + q] -=
              (acc[0] + acc[1]) + (acc[2] + acc[3]);
        }
        __syncthreads();
      }
      backward();
      store_x(true);
    }
  }
  if (P > 1) cluster_sync();     // no CTA leaves while its tiles are read
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Blocks of up to kWarps warps, as many as fit the card at once; a warp
// then walks N / (resident warps) systems, with two stages when that is
// more than one.
template <typename T, int NMAX>
int launch_warp(const T* H, const T* G, T* X, int N, int n, int r,
                cudaStream_t stream) {
  constexpr int W = Vec<T>::W;
  const bool one = r == 1;
  const int m = one ? n + 1 : n;
  if (m > NMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t len = static_cast<size_t>(m) * row_stride(n, W);
  auto kernel = one ? chol_warp_kernel<T, NMAX, true>
                    : chol_warp_kernel<T, NMAX, false>;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  for (int stages = 1; stages <= 2; ++stages) {
    const size_t per_warp = sizeof(T) * (stages * len + NMAX);
    int warps = static_cast<int>(kMaxSmem / per_warp);
    if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
    warps = warps > kWarps ? kWarps : warps;
    const size_t smem = per_warp * warps;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess)
      return static_cast<int>(err);
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, 32 * warps, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long want = (static_cast<long long>(N) + warps - 1) / warps;
    const long long fit = static_cast<long long>(per_sm) * sms;
    if (want > fit && stages == 1) continue;   // warps walk: two stages
    const int blocks = static_cast<int>(want < fit ? want : fit);
    kernel<<<blocks, 32 * warps, smem, stream>>>(H, G, X, N, n, r, stages);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tiled variants: block (variant 0) in one CTA, global (variant 1) in
// the smallest cluster of 2 .. kMaxCluster CTAs whose shares fit.  Refuses
// (cudaErrorInvalidValue, nothing launched) what does not fit: a block
// variant beyond one CTA's shared memory, a global one beyond a cluster's,
// or a cluster the card cannot hold (cudaOccupancyMaxActiveClusters).
constexpr int kTileSmem = kMaxSmem - 1024;   // static tables kept aside

template <typename T>
int launch_tiles(const T* H, const T* G, T* X, int N, int n, int r,
                 int variant, cudaStream_t stream) {
  if (n > kMaxTiles * kTB || (variant != 0 && variant != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int P = 1;
  if (variant == 1)
    for (P = 2; P <= kMaxCluster; ++P)
      if (tile_smem<T>(n, r, P) <= static_cast<size_t>(kTileSmem)) break;
  const size_t smem = tile_smem<T>(n, r, P);
  if (P > kMaxCluster || smem > static_cast<size_t>(kTileSmem) ||
      static_cast<long long>(N) * P > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = chol_tile_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P == 1) {
    kernel<<<N, kTileThreads, smem, stream>>>(H, G, X, n, r, 1);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N * P));
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((err = cudaLaunchKernelEx(&cfg, kernel, H, G, X, n, r, P)) !=
      cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// variant: the class (32, 48 or 64 rows; float64 has 64 only), 0 for the
// block variant, 1 for the global one.
template <typename T>
int launch(const T* H, const T* G, T* X, int N, int n, int r, int variant,
           void* stream) {
  // an empty batch is the caller's to skip: it launches nothing
  if (N <= 0 || n <= 0 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0 || variant == 1)
    return launch_tiles(H, G, X, N, n, r, variant, st);
  if (variant == 64) return launch_warp<T, 64>(H, G, X, N, n, r, st);
  if constexpr (sizeof(T) == 4) {
    if (variant == 32) return launch_warp<T, 32>(H, G, X, N, n, r, st);
    if (variant == 48) return launch_warp<T, 48>(H, G, X, N, n, r, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each library carries one element type, so that the unrolled classes of
// the two build in parallel: this file the float32 one, chol_solve_f64.cu
// (which includes this file with OMG_CHOL_F64 defined) the float64 one.
extern "C" {

#ifndef OMG_CHOL_F64
// X[b] = H[b]^-1 G[b]: H (N, n, n), G and X (N, n, r), row-major; r = 1 is
// K1 (psd_solve), r > 1 K2 (psd_solve_multi).  Returns a cudaError_t.
int omg_chol_solve_f32(const float* H, const float* G, float* X, int N, int n,
                       int r, int variant, void* stream) {
  return launch(H, G, X, N, n, r, variant, stream);
}
#else
int omg_chol_solve_f64(const double* H, const double* G, double* X, int N,
                       int n, int r, int variant, void* stream) {
  return launch(H, G, X, N, n, r, variant, stream);
}
#endif

}  // extern "C"
