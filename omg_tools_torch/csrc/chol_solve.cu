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
//     arrays; n and r are run-time values within a class.  Larger systems
//     take a block variant (one system a block, the same Crout order in
//     run-time loops over shared memory); K1 at n = 151 (the dense and
//     generic ALM modes) is its shape.  A system too large for a block's
//     shared memory is refused.
//   - float32 in every class; float64 (right, not fast) in the 64-row class
//     and the block variant.  Full-precision FMAs only, no tensor cores:
//     these Newton systems are ill-conditioned.
//   - Systems too large for a block's shared memory (float64 above ~168
//     rows: the scheduler's two-frame local problems, 178-186 rows; the
//     central formation, 262; the free-time warehouse, 395) take the
//     global variant (chol_global_kernel, its own entry point
//     omg_chol_solve_ws_*): one block of 256 threads a system, factored
//     in place in a global-memory workspace the caller provides (at most
//     1.25 MB a system, which the 50 MB L2 holds) by a right-looking
//     blocked Cholesky over panels of 32 columns.  Each panel is staged in
//     shared memory (rows at an odd stride of 33 elements), factored there
//     column by column, written back, and the trailing lower triangle is
//     updated from it (a warp a row, lanes along the row, the row's 32
//     panel entries in registers).  The right-hand sides ride along as r
//     augmented rows [H; G'], so the factorization leaves (L^-1 G)' in
//     them; the backward substitution then runs column by column over
//     shared memory.  Simple and right, not fast: one block walks every
//     pivot of its system.
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

// Block variant: one warp a block and a system a block, for systems above
// the classes: the same Crout Cholesky in run-time loops over shared
// memory, g as the augmented row for r = 1; for r > 1 the panel sits in
// shared memory and lanes own its columns.
template <typename T, bool ONE>
__global__ void __launch_bounds__(32)
chol_block_kernel(const T* __restrict__ H, const T* __restrict__ G,
                  T* __restrict__ X, int N, int n, int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int W = Vec<T>::W;
  const int lane = threadIdx.x;
  const int m = ONE ? n + 1 : n;
  const int ld = row_stride(n, W);
  T* S = reinterpret_cast<T*>(smem_raw);
  T* dinv = S + m * ld;
  T* Z = dinv + round_up(n, W);
  const long long sys = blockIdx.x;
  const T* Hs = H + sys * n * n;
  for (int i = 0; i < n; ++i)
    for (int k = lane; k <= i; k += 32) S[i * ld + k] = Hs[i * n + k];
  if constexpr (ONE) {
    for (int k = lane; k < n; k += 32) S[n * ld + k] = G[sys * n + k];
  } else {
    for (int e = lane; e < n * r; e += 32) Z[e] = G[sys * n * r + e];
  }
  __syncwarp();
  // Crout, as the classes do, in run-time loops: each lane's rows take
  // their dot products with row j, then the pivot scales them
  for (int j = 0; j < n; ++j) {
    const T* Lj = S + j * ld;
    for (int i = j + lane; i < m; i += 32)
      S[i * ld + j] = row_dot(S + i * ld, Lj, j, j);
    __syncwarp();
    const T d = Lj[j];
    const T inv = rsq(d);
    __syncwarp();
    for (int i = j + 1 + lane; i < m; i += 32) S[i * ld + j] *= inv;
    if (lane == 0) {
      S[j * ld + j] = d * inv;
      dinv[j] = inv;
    }
    __syncwarp();
  }
  if constexpr (ONE) {
    T* z = S + n * ld;
    for (int i = n - 1; i >= 0; --i) {
      const T xi = z[i] * dinv[i];
      __syncwarp();
      for (int k = lane; k < i; k += 32) z[k] = fma(-S[i * ld + k], xi, z[k]);
      if (lane == 0) z[i] = xi;
      __syncwarp();
    }
    for (int k = lane; k < n; k += 32) X[sys * n + k] = z[k];
  } else {
    for (int c = lane; c < r; c += 32) {
      for (int i = 0; i < n; ++i) {
        T t = Z[i * r + c];
        for (int k = 0; k < i; ++k) t = fma(-S[i * ld + k], Z[k * r + c], t);
        Z[i * r + c] = t * dinv[i];
      }
      for (int i = n - 1; i >= 0; --i) {
        const T xi = Z[i * r + c] * dinv[i];
        Z[i * r + c] = xi;
        for (int k = 0; k < i; ++k)
          Z[k * r + c] = fma(-S[i * ld + k], xi, Z[k * r + c]);
      }
    }
    __syncwarp();
    for (int e = lane; e < n * r; e += 32) X[sys * n * r + e] = Z[e];
  }
}

// Global variant: one block a system, factored in place in W, m = n + r
// rows of n (the lower triangle of H, then the r rows of G'), row-major.
constexpr int kPanel = 32;             // columns a panel
constexpr int kPanelLd = kPanel + 1;   // a staged panel row's stride
constexpr int kPanelThreads = 256;     // threads a block

template <typename T>
__global__ void __launch_bounds__(kPanelThreads)
chol_global_kernel(const T* __restrict__ H, const T* __restrict__ G,
                   T* __restrict__ X, T* __restrict__ Wk, int N, int n,
                   int r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = nt >> 5;
  const int m = n + r;
  const long long sys = blockIdx.x;
  T* A = Wk + sys * static_cast<long long>(m) * n;
  const T* Hs = H + sys * static_cast<long long>(n) * n;
  const T* Gs = G + sys * static_cast<long long>(n) * r;
  T* P = reinterpret_cast<T*>(smem_raw);  // a panel; later the z columns
  const size_t p_len =
      static_cast<size_t>(m) * kPanelLd > static_cast<size_t>(r) * n
          ? static_cast<size_t>(m) * kPanelLd
          : static_cast<size_t>(r) * n;
  T* dinv = P + p_len;
  // the workspace: H's lower triangle, then G' as rows n .. m - 1
  for (int i = warp; i < n; i += warps)
    for (int k = lane; k <= i; k += 32)
      A[static_cast<size_t>(i) * n + k] = Hs[static_cast<size_t>(i) * n + k];
  for (int e = tid; e < n * r; e += nt)
    A[static_cast<size_t>(n + e % r) * n + e / r] = Gs[e];
  __syncthreads();
  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int nb = n - k0 < kPanel ? n - k0 : kPanel;
    const int rows = m - k0;
    // stage the panel: rows k0 .. m - 1, columns k0 .. k0 + nb - 1 (the
    // lower triangle of its diagonal block)
    for (int e = tid; e < rows * nb; e += nt) {
      const int i = e / nb, t = e % nb;
      if (t <= i)
        P[i * kPanelLd + t] = A[static_cast<size_t>(k0 + i) * n + k0 + t];
    }
    __syncthreads();
    // factor it column by column
    for (int j = 0; j < nb; ++j) {
      const T d = P[j * kPanelLd + j];
      const T inv = rsq(d);
      __syncthreads();  // every thread has read the pivot
      for (int i = j + 1 + tid; i < rows; i += nt) P[i * kPanelLd + j] *= inv;
      if (tid == 0) {
        P[j * kPanelLd + j] = d * inv;
        dinv[k0 + j] = inv;
      }
      __syncthreads();
      const int w = nb - j - 1;  // the panel's columns right of j
      if (w > 0) {
        for (int e = tid; e < (rows - j - 1) * w; e += nt) {
          const int i = j + 1 + e / w, t = j + 1 + e % w;
          if (t <= i)
            P[i * kPanelLd + t] =
                fma(-P[i * kPanelLd + j], P[t * kPanelLd + j],
                    P[i * kPanelLd + t]);
        }
      }
      __syncthreads();
    }
    // the panel's columns of L back to the workspace
    for (int e = tid; e < rows * nb; e += nt) {
      const int i = e / nb, t = e % nb;
      if (t <= i)
        A[static_cast<size_t>(k0 + i) * n + k0 + t] = P[i * kPanelLd + t];
    }
    // the trailing lower triangle, and the augmented rows: A[i][c] -=
    // L[i][panel] . L[c][panel] for c in k0 + nb .. min(i, n - 1); a warp
    // a row, its panel entries in registers, lanes along the row
    const int k1 = k0 + nb;
    for (int i = k1 + warp; i < m; i += warps) {
      T a[kPanel];
#pragma unroll
      for (int t = 0; t < kPanel; ++t)
        a[t] = t < nb ? P[(i - k0) * kPanelLd + t] : T(0);
      const int cend = i < n - 1 ? i : n - 1;
      for (int c = k1 + lane; c <= cend; c += 32) {
        const T* Pc = P + (c - k0) * kPanelLd;
        T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
        for (int t = 0; t < kPanel; ++t)
          if (t < nb) acc[t & 3] = fma(a[t], Pc[t], acc[t & 3]);
        T* dst = A + static_cast<size_t>(i) * n + c;
        *dst -= sum_parts(acc);
      }
    }
    __syncthreads();  // the workspace's updates before the next panel
  }
  // backward substitution: z_q = (L^-1 G)'[q] from the augmented rows,
  // x = L'^-1 z column by column, x_i written as it is found
  T* Z = P;
  for (int e = tid; e < r * n; e += nt)
    Z[e] = A[static_cast<size_t>(n) * n + e];
  __syncthreads();
  T* Xs = X + sys * static_cast<long long>(n) * r;
  for (int i = n - 1; i >= 0; --i) {
    const T di = dinv[i];
    const T* Li = A + static_cast<size_t>(i) * n;
    for (int e = tid; e < r * i; e += nt) {
      const int q = e / i, k = e % i;
      Z[q * n + k] = fma(-Li[k], Z[q * n + i] * di, Z[q * n + k]);
    }
    for (int q = tid; q < r; q += nt)
      Xs[static_cast<size_t>(i) * r + q] = Z[q * n + i] * di;
    __syncthreads();
  }
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

template <typename T>
int launch_block(const T* H, const T* G, T* X, int N, int n, int r,
                 cudaStream_t stream) {
  constexpr int W = Vec<T>::W;
  const bool one = r == 1;
  const int m = one ? n + 1 : n;
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(m) * row_stride(n, W) +
                   round_up(n, W) + (one ? 0 : static_cast<size_t>(n) * r));
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = one ? chol_block_kernel<T, true> : chol_block_kernel<T, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<N, 32, smem, stream>>>(H, G, X, N, n, r);
  return static_cast<int>(cudaGetLastError());
}

// The global variant's shared bytes: a staged panel of all m = n + r rows
// (or the r z columns, if larger) and the n inverse pivots.
template <typename T>
size_t global_smem(int n, int r) {
  const size_t m = static_cast<size_t>(n) + r;
  const size_t panel = m * kPanelLd;
  const size_t zs = static_cast<size_t>(r) * n;
  return sizeof(T) * ((panel > zs ? panel : zs) + n);
}

template <typename T>
int launch_global(const T* H, const T* G, T* X, T* W, int N, int n, int r,
                  void* stream) {
  if (N <= 0 || n <= 0 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = global_smem<T>(n, r);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = chol_global_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<N, kPanelThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      H, G, X, W, N, n, r);
  return static_cast<int>(cudaGetLastError());
}

// variant: the class (32, 48 or 64 rows; float64 has 64 only), or 0 for
// the block variant.
template <typename T>
int launch(const T* H, const T* G, T* X, int N, int n, int r, int variant,
           void* stream) {
  // an empty batch is the caller's to skip: it launches nothing
  if (N <= 0 || n <= 0 || r <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0) return launch_block(H, G, X, N, n, r, st);
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
// The global variant: the same X, factored in W, a workspace of
// N (n + r) n elements.
int omg_chol_solve_ws_f32(const float* H, const float* G, float* X, float* W,
                          int N, int n, int r, void* stream) {
  return launch_global(H, G, X, W, N, n, r, stream);
}
#else
int omg_chol_solve_f64(const double* H, const double* G, double* X, int N,
                       int n, int r, int variant, void* stream) {
  return launch(H, G, X, N, n, r, variant, stream);
}
int omg_chol_solve_ws_f64(const double* H, const double* G, double* X,
                          double* W, int N, int n, int r, void* stream) {
  return launch_global(H, G, X, W, N, n, r, stream);
}
#endif

}  // extern "C"
