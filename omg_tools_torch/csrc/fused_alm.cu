// K3: the fused ALM inner loop, written for Hopper (sm_90a).  Built by
// omg_tools_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel of omg_tools_tpu/ops/fused_alm.py:297
// (make_fused_kernel -> kern): n_inner ALM inner Newton iterations per
// lane in one launch.  Each iteration: g(x) and the multiplier estimate per
// constraint family; the block-arrow Gauss-Newton assembly (head S, tail
// blocks D, panels [C' | r_b | w]); the ridge; the tail Cholesky factors,
// Y = L^-1 [C' | r_b] and the Schur complement onto the head; the head
// solve and back-substitution; the non-finite fallback and max_step cap;
// the exact-quadratic Armijo search.  omg_tools_torch/ops/fused_alm.py
// holds the plan (FusedPlan.descriptor, FusedPlan.phase_tables) and the
// plain PyTorch version (fused_inner_plain) with the same arithmetic.
//
// What bounds it on an H100 SXM (67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s HBM3, 50 MB L2; nvidia-smi names that part "NVIDIA H100 80GB
// HBM3").  For the bench plan (n = 151 variables, m = 671 rows, 21
// families, head 26, tail blocks 3 x 33 + 2 x 13) the function needs about
// 157 K multiply-adds a lane and iteration: 123 K in the dense
// factorizations and solves of the assembled tail blocks, panels and head,
// 34 K in the products with the plan's tables counted at their non-zeros
// (they are sparse: 0.45 % of Q, 7-15 % of A, under 1 % of P) and with the
// symmetric Gauss-Newton products at their lower triangle.  At B = 4096
// and 8 iterations that is ~11.9 GFLOP, ~0.18 ms at the f32 rate, against
// ~28.6 MB of lane state and tables, ~8.5 us at the memory rate:
// operations bound it (chip_smoke.py's k3_work).  This kernel runs every
// table product dense, ~2.1 M multiply-adds a lane and iteration, most of
// them in the three 41 x 59 x 59 Q contractions (Q x and Q dx, once each).
// TF32 is not used: the JAX package pins full-f32 products for these
// ill-conditioned Newton systems.
//
// Design.  One thread block (256 threads) owns one lane for the whole
// launch; the n_inner loop runs inside the kernel.
//   - The lane's working set lives in dynamic shared memory: x, dx, the
//     gradient, the rows' g / y / d / J dx / d'Q d, the head S, the tail
//     blocks D and their panels, and one family's J (74 KB with the
//     descriptor for the bench plan, so three blocks fit on an SM).  Only x, g and the
//     gradient norm go back to device memory.
//   - The shared tables (1.19 MB per phase for the bench plan) do not fit
//     in shared memory; they stay in device memory, resident in L2, and are
//     read through the read-only path.  The descriptor (~4 KB) is copied
//     into shared memory at the start.
//   - Threads spread over a family's (row, column) entries for the Q
//     contractions, over rows for g and J, over columns for J'y, over
//     (row, column) pairs for the Gauss-Newton blocks, and write each pair
//     straight into its target (S, C' pre-transposed, or D): within one
//     family every pair has its own target, so no atomics; families run
//     one after the other.  The (block, head) mirror pairs are skipped.
//   - The tail blocks are factored concurrently, one warp each (right-
//     looking Cholesky, lanes over the rows of the trailing update, then
//     lanes over the panel's columns), as in csrc/chol_solve.cu.  The
//     Schur complement spreads threads over the head's (row, column)
//     entries; warp 0 factors the head.
//   - A block serves one lane, so every lane reads every table row from
//     L2, and the table products run dense: the first design is simple,
//     not fast (PERF.md has its time against the bound; a later PR may let
//     a block serve several lanes so that each table row is read once for
//     all of them, and skip the tables' zeros).
//   - A non-positive pivot gives rsqrt of a non-positive number, so dx is
//     non-finite and the fallback turns it into a gradient step, as in the
//     TPU kernel; the line search takes the first acceptable candidate.

#include <cuda_runtime.h>

namespace {

// descriptor layout, shared with omg_tools_torch/ops/fused_alm.py
constexpr int kMagic = 0x4B33;
constexpr int kHeader = 16;
constexpr int kFam = 48;
constexpr int kMaxBlocks = 16, kMaxRuns = 4, kMaxSegs = 4, kMaxQ = 12;
constexpr int kMaxCands = 16;
enum { H_MAGIC, H_N, H_M, H_NV, H_H0, H_H, H_NB, H_NF, H_C0, H_C1, H_GF,
       H_PLEN, H_JBUF, H_FAM0, H_LEN };
enum { F_KIND, F_ROW, F_MF, F_NF, F_NRUNS, F_NSEGS, F_NQ, F_A, F_TA, F_Q,
       F_P, F_RUNS = 12, F_SEGS = 20, F_QPOS = 36 };
enum { KIND_CONST = 0, KIND_PARAM = 1, KIND_QUAD = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;       // 227 KB: a block's limit on sm_90
constexpr int kDefaultSmem = 48 * 1024;

struct Opts {
  float max_step, gn_rel, delta;
  int n_cands;
  float cand[kMaxCands];       // step lengths a
  float cand_sq[kMaxCands];    // a * a
  float armijo_a[kMaxCands];   // armijo * a
};

// float offsets into the block's dynamic shared memory
struct Layout {
  int desc, x, dx, grad, xf, df, pv, lor, cv, gv, y, dw, jd, qd, S, rt, jbuf,
      red, total;
  int D[kMaxBlocks], M[kMaxBlocks];
};

bool make_layout(const int* d, Layout* L) {
  int o = 0;
  auto take = [&o](int count) {
    const int at = o;
    o += (count + 3) & ~3;
    return at;
  };
  const int n = d[H_N], m = d[H_M], h = d[H_H], nb = d[H_NB];
  L->desc = take(d[H_LEN]);
  L->x = take(n);
  L->dx = take(n);
  L->grad = take(n);
  L->xf = take(n);
  L->df = take(n);
  L->pv = take(d[H_NV]);
  L->lor = take(m);
  L->cv = take(m);
  L->gv = take(m);
  L->y = take(m);
  L->dw = take(m);
  L->jd = take(m);
  L->qd = take(m);
  L->S = take(h * h);
  L->rt = take(h);
  for (int bi = 0; bi < nb; ++bi) {
    const int sz = d[kHeader + 2 * bi + 1];
    L->D[bi] = take(sz * sz);
    L->M[bi] = take(sz * (h + 2));
  }
  L->jbuf = take(d[H_JBUF]);
  L->red = take(kWarps);
  L->total = o;
  return (size_t)o * sizeof(float) <= (size_t)kMaxSmem;
}

// Everything the kernel indexes with must be in range.
bool valid_plan(const int* d) {
  if (d[H_MAGIC] != kMagic) return false;
  const int n = d[H_N], m = d[H_M], nv = d[H_NV], h0 = d[H_H0], h = d[H_H];
  const int nb = d[H_NB], nf = d[H_NF];
  const long long plen = d[H_PLEN];
  if (n <= 0 || m <= 0 || nv < 0 || h <= 0 || h0 < 0 || h0 + h > n)
    return false;
  // a table at float offset `off` of `count` floats lies in the phase buffer
  auto fits = [plen](long long off, long long count) {
    return off >= 0 && off + count <= plen;
  };
  if (!fits(d[H_C0], m) || !fits(d[H_C1], (long long)m * nv) ||
      !fits(d[H_GF], n))
    return false;
  if (nb < 0 || nb > kMaxBlocks || nf <= 0) return false;
  if (d[H_FAM0] != kHeader + 3 * nb || d[H_LEN] != d[H_FAM0] + kFam * nf)
    return false;
  int covered = h;
  for (int bi = 0; bi < nb; ++bi) {
    const int s = d[kHeader + 2 * bi], sz = d[kHeader + 2 * bi + 1];
    const int o = d[kHeader + 2 * nb + bi];
    if (sz <= 0 || s < 0 || s + sz > n || o < 0 || o >= nb) return false;
    covered += sz;
  }
  if (covered != n) return false;
  int rows = 0;
  for (int fi = 0; fi < nf; ++fi) {
    const int* f = d + d[H_FAM0] + kFam * fi;
    const int mf = f[F_MF], nfc = f[F_NF];
    if (f[F_KIND] < KIND_CONST || f[F_KIND] > KIND_QUAD) return false;
    if (f[F_ROW] != rows || mf <= 0 || nfc <= 0) return false;
    rows += mf;
    if (f[F_NRUNS] < 1 || f[F_NRUNS] > kMaxRuns || f[F_NSEGS] < 1 ||
        f[F_NSEGS] > kMaxSegs || f[F_NQ] < 0 || f[F_NQ] > kMaxQ)
      return false;
    if (f[F_KIND] != KIND_CONST && mf * nfc > d[H_JBUF]) return false;
    if ((f[F_KIND] == KIND_CONST) != (f[F_P] >= 0)) return false;
    if ((f[F_KIND] == KIND_QUAD) != (f[F_Q] >= 0)) return false;
    if ((f[F_TA] >= 0) != (f[F_NQ] > 0)) return false;
    const long long mn = (long long)mf * nfc;
    if (!fits(f[F_A], mn) || (f[F_TA] >= 0 && !fits(f[F_TA], mn * f[F_NQ])) ||
        (f[F_Q] >= 0 && !fits(f[F_Q], mn * nfc)) ||
        (f[F_P] >= 0 && !fits(f[F_P], mn * nfc)))
      return false;
    int cols = 0;
    for (int k = 0; k < f[F_NRUNS]; ++k) {
      const int s = f[F_RUNS + 2 * k], z = f[F_RUNS + 2 * k + 1];
      if (s < 0 || z <= 0 || s + z > n) return false;
      cols += z;
    }
    if (cols != nfc) return false;
    int segcols = 0;
    for (int k = 0; k < f[F_NSEGS]; ++k) {
      const int* g = f + F_SEGS + 4 * k;
      const int oa = g[0], sa = g[1], ta = g[2], pa = g[3];
      if (oa != segcols || sa <= 0 || ta < -1 || ta >= nb || pa < 0)
        return false;
      const int span = ta < 0 ? h : d[kHeader + 2 * ta + 1];
      if (pa + sa > span) return false;
      segcols += sa;
    }
    if (segcols != nfc) return false;
    for (int k = 0; k < f[F_NQ]; ++k)
      if (f[F_QPOS + k] < 0 || f[F_QPOS + k] >= nv) return false;
  }
  return rows == m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool finite(float v) {
  return fabsf(v) <= 3.402823466e38f;  // false for inf and NaN
}

// max that propagates NaN, as jnp.max / torch.amax do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide sum / max; every thread gets the result (fixed order).
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < kWarps; ++w) s = nan_max(s, red[w]);
  __syncthreads();
  return s;
}

// variable index of a family's local column j (its runs, in order)
__device__ __forceinline__ int gidx(const int* f, int j) {
  for (int k = 0; k < f[F_NRUNS]; ++k) {
    const int z = f[F_RUNS + 2 * k + 1];
    if (j < z) return f[F_RUNS + 2 * k] + j;
    j -= z;
  }
  return -1;
}

// the arrow target (-1: head, else tail block) and local offset of column j
__device__ __forceinline__ void target(const int* f, int j, int& t, int& p) {
  for (int k = 0; k < f[F_NSEGS]; ++k) {
    const int* g = f + F_SEGS + 4 * k;
    if (j >= g[0] && j < g[0] + g[1]) {
      t = g[2];
      p = g[3] + j - g[0];
      return;
    }
  }
  t = -2;
  p = 0;
}

// A of a family at (r, j): A0 + TA pq for param rows
__device__ __forceinline__ float fam_a(const float* __restrict__ A,
                                       const float* __restrict__ TA,
                                       const int* f, const float* pv, int e) {
  float a = __ldg(A + e);
  if (TA != nullptr) {
    const int nq = f[F_NQ];
    float t = 0.f;
    for (int q = 0; q < nq; ++q)
      t += __ldg(TA + (size_t)e * nq + q) * pv[f[F_QPOS + q]];
    a += t;
  }
  return a;
}

// In-place right-looking Cholesky of the (n, n) matrix at L (row stride
// ld) by one warp; the lower triangle holds the factor.
__device__ void warp_chol(float* L, int n, int ld, int lane) {
  for (int j = 0; j < n; ++j) {
    const float inv = rsqrtf(L[j * ld + j]);
    __syncwarp();
    for (int i = j + lane; i < n; i += 32) L[i * ld + j] *= inv;
    __syncwarp();
    for (int i = j + 1 + lane; i < n; i += 32) {
      const float lij = L[i * ld + j];
      for (int k = j + 1; k <= i; ++k) L[i * ld + k] -= lij * L[k * ld + j];
    }
    __syncwarp();
  }
}

// In place P <- L^-1 P for the first ncols columns of P (row stride ldp);
// lanes own whole columns.
__device__ void warp_fwd_panel(const float* L, int n, int ld, float* P,
                               int ldp, int ncols, int lane) {
  for (int c = lane; c < ncols; c += 32) {
    for (int i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int k = 0; k < i; ++k) acc += L[i * ld + k] * P[k * ldp + c];
      P[i * ldp + c] = (P[i * ldp + c] - acc) / L[i * ld + i];
    }
  }
  __syncwarp();
}

// In place v <- L^-1 v (forward) or L'^-1 v (backward), v with stride ldv;
// the lanes split each row's dot product.
__device__ void warp_fwd_col(const float* L, int n, int ld, float* v, int ldv,
                             int lane) {
  for (int i = 0; i < n; ++i) {
    float p = 0.f;
    for (int k = lane; k < i; k += 32) p += L[i * ld + k] * v[k * ldv];
    p = warp_sum(p);
    const float vi = (v[i * ldv] - p) / L[i * ld + i];
    __syncwarp();
    if (lane == 0) v[i * ldv] = vi;
    __syncwarp();
  }
}

__device__ void warp_bwd_col(const float* L, int n, int ld, float* v, int ldv,
                             int lane) {
  for (int i = n - 1; i >= 0; --i) {
    float p = 0.f;
    for (int k = i + 1 + lane; k < n; k += 32) p += L[k * ld + i] * v[k * ldv];
    p = warp_sum(p);
    const float vi = (v[i * ldv] - p) / L[i * ld + i];
    __syncwarp();
    if (lane == 0) v[i * ldv] = vi;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
fused_alm_kernel(const int* __restrict__ desc, const float* __restrict__ tab,
                 const float* __restrict__ lb, const float* __restrict__ ub,
                 const float* __restrict__ x_in, const float* __restrict__ lam,
                 const float* __restrict__ rho_in,
                 const float* __restrict__ pv_in, float* __restrict__ x_out,
                 float* __restrict__ gv_out, float* __restrict__ stat_out,
                 int n_inner, Layout L, Opts opt) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;

  int* d = reinterpret_cast<int*>(sm + L.desc);
  {
    const int len = __ldg(desc + H_LEN);
    for (int e = tid; e < len; e += kThreads) d[e] = __ldg(desc + e);
  }
  __syncthreads();
  const int n = d[H_N], m = d[H_M], nv = d[H_NV], h0 = d[H_H0], h = d[H_H];
  const int nb = d[H_NB], nfam = d[H_NF], hp = h + 2;
  const int* blk = d + kHeader;          // (start, size) per tail block
  const int* order = blk + 2 * nb;       // Schur subtraction order
  const int* fam0 = d + d[H_FAM0];
  float* x = sm + L.x;
  float* dx = sm + L.dx;
  float* grad = sm + L.grad;
  float* xf = sm + L.xf;
  float* df = sm + L.df;
  float* pv = sm + L.pv;
  float* lor = sm + L.lor;
  float* cv = sm + L.cv;
  float* gv = sm + L.gv;
  float* y = sm + L.y;
  float* dw = sm + L.dw;
  float* jd = sm + L.jd;
  float* qd = sm + L.qd;
  float* S = sm + L.S;
  float* rt = sm + L.rt;
  float* J = sm + L.jbuf;
  float* red = sm + L.red;
  const float* c0 = tab + d[H_C0];
  const float* C1 = tab + d[H_C1];
  const float* gf = tab + d[H_GF];

  // -- lane state; resolved constants c = c0 + C1 pv --------------------
  const float rho = rho_in[b];
  for (int e = tid; e < n; e += kThreads) x[e] = x_in[b * n + e];
  for (int e = tid; e < nv; e += kThreads) pv[e] = pv_in[b * nv + e];
  for (int e = tid; e < m; e += kThreads) lor[e] = lam[b * m + e] / rho;
  __syncthreads();
  for (int r = tid; r < m; r += kThreads) {
    float s = 0.f;
    for (int q = 0; q < nv; ++q) s += __ldg(C1 + (size_t)r * nv + q) * pv[q];
    cv[r] = __ldg(c0 + r) + s;
  }
  __syncthreads();

  float stat = 0.f;
  for (int it = 0; it < n_inner; ++it) {
    // -- clear the arrow system; the gradient starts at gf ---------------
    for (int e = tid; e < h * h; e += kThreads) S[e] = 0.f;
    for (int bi = 0; bi < nb; ++bi) {
      const int sz = blk[2 * bi + 1];
      float* Db = sm + L.D[bi];
      float* Mb = sm + L.M[bi];
      for (int e = tid; e < sz * sz; e += kThreads) Db[e] = 0.f;
      for (int e = tid; e < sz * hp; e += kThreads) Mb[e] = 0.f;
    }
    for (int e = tid; e < n; e += kThreads) grad[e] = __ldg(gf + e);
    __syncthreads();

    // -- per family: g, multiplier estimate, J, J'y and J' diag(d) J ------
    for (int fi = 0; fi < nfam; ++fi) {
      const int* f = fam0 + kFam * fi;
      const int kind = f[F_KIND], r0 = f[F_ROW], mf = f[F_MF], nfc = f[F_NF];
      const float* A = tab + f[F_A];
      const float* TA = f[F_TA] >= 0 ? tab + f[F_TA] : nullptr;
      const float* Q = f[F_Q] >= 0 ? tab + f[F_Q] : nullptr;
      const float* P = f[F_P] >= 0 ? tab + f[F_P] : nullptr;
      for (int j = tid; j < nfc; j += kThreads) xf[j] = x[gidx(f, j)];
      __syncthreads();
      if (Q != nullptr) {                  // t1 = Q x_f, into J
        for (int e = tid; e < mf * nfc; e += kThreads) {
          const float* q = Q + (size_t)e * nfc;
          float s = 0.f;
          for (int k = 0; k < nfc; ++k) s += __ldg(q + k) * xf[k];
          J[e] = s;
        }
        __syncthreads();
      }
      for (int r = tid; r < mf; r += kThreads) {
        float s = 0.f;
        for (int j = 0; j < nfc; ++j) {
          const int e = r * nfc + j;
          const float a = kind == KIND_CONST ? __ldg(A + e)
                                             : fam_a(A, TA, f, pv, e);
          if (Q != nullptr) {              // g = c + (A + Q x) x
            const float t1 = J[e];
            s += (a + t1) * xf[j];
            J[e] = a + 2.f * t1;
          } else {
            s += a * xf[j];
            if (kind != KIND_CONST) J[e] = a;
          }
        }
        const int row = r0 + r;
        const float g = cv[row] + s;
        const float rr = g + lor[row];
        const float pr = fminf(fmaxf(rr, __ldg(lb + row)), __ldg(ub + row));
        const float yv = rho * (rr - pr);
        gv[row] = g;
        y[row] = yv;
        dw[row] = fabsf(yv) > 0.f ? rho : 0.f;
      }
      __syncthreads();
      // gradient: g_f = J' y
      for (int j = tid; j < nfc; j += kThreads) {
        float s = 0.f;
        if (kind == KIND_CONST)
          for (int k = 0; k < mf; ++k) s += __ldg(A + k * nfc + j) * y[r0 + k];
        else
          for (int k = 0; k < mf; ++k) s += J[k * nfc + j] * y[r0 + k];
        grad[gidx(f, j)] += s;
      }
      // Gauss-Newton blocks, each pair straight into its target
      for (int e = tid; e < nfc * nfc; e += kThreads) {
        const int r = e / nfc, c = e - r * nfc;
        int ta, pa, tb, pb;
        target(f, r, ta, pa);
        target(f, c, tb, pb);
        if (ta >= 0 && tb < 0) continue;   // mirror of a (head, block) pair
        // C' is kept pre-transposed: its entry is H[c, r]
        const bool cprime = ta < 0 && tb >= 0;
        const int u = cprime ? c : r, v = cprime ? r : c;
        float hv = 0.f;
        if (kind == KIND_CONST) {
          const float* p = P + (size_t)(u * nfc + v) * mf;
          for (int k = 0; k < mf; ++k) hv += __ldg(p + k) * dw[r0 + k];
        } else {
          for (int k = 0; k < mf; ++k)
            hv += (J[k * nfc + u] * dw[r0 + k]) * J[k * nfc + v];
        }
        float* dst;
        if (ta < 0 && tb < 0)
          dst = S + pa * h + pb;
        else if (cprime)
          dst = sm + L.M[tb] + pb * hp + pa;
        else
          dst = sm + L.D[ta] + pa * blk[2 * ta + 1] + pb;
        *dst += hv;
      }
      __syncthreads();
    }

    // -- right-hand sides; ridge ------------------------------------------
    for (int i = tid; i < h; i += kThreads) rt[i] = grad[h0 + i];
    float dm = 0.f;
    for (int i = tid; i < h; i += kThreads) dm = nan_max(dm, fabsf(S[i * h + i]));
    for (int bi = 0; bi < nb; ++bi) {
      const int s0 = blk[2 * bi], sz = blk[2 * bi + 1];
      const float* Db = sm + L.D[bi];
      float* Mb = sm + L.M[bi];
      for (int i = tid; i < sz; i += kThreads) {
        Mb[i * hp + h] = grad[s0 + i];
        dm = nan_max(dm, fabsf(Db[i * sz + i]));
      }
    }
    dm = block_max(dm, red);
    const float ridge = opt.gn_rel * nan_max(dm, 1.f) + opt.delta;
    for (int i = tid; i < h; i += kThreads) S[i * h + i] += ridge;
    for (int bi = 0; bi < nb; ++bi) {
      const int sz = blk[2 * bi + 1];
      float* Db = sm + L.D[bi];
      for (int i = tid; i < sz; i += kThreads) Db[i * sz + i] += ridge;
    }
    __syncthreads();

    // -- tail blocks, one warp each: L_D, Y = L_D^-1 [C' | r_b] ----------
    for (int bi = warp; bi < nb; bi += kWarps) {
      const int sz = blk[2 * bi + 1];
      float* Db = sm + L.D[bi];
      warp_chol(Db, sz, sz, lane);
      warp_fwd_panel(Db, sz, sz, sm + L.M[bi], hp, h + 1, lane);
    }
    __syncthreads();

    // -- Schur complement: S - sum Y'Y, r_h - sum Y' r_b ------------------
    for (int e = tid; e < h * (h + 1); e += kThreads) {
      const int r = e / (h + 1), c = e - r * (h + 1);
      float v = c < h ? S[r * h + c] : rt[r];
      for (int o = 0; o < nb; ++o) {
        const int bi = order[o], sz = blk[2 * bi + 1];
        const float* Y = sm + L.M[bi];
        float g = 0.f;
        for (int k = 0; k < sz; ++k) g += Y[k * hp + r] * Y[k * hp + c];
        v -= g;
      }
      if (c < h) S[r * h + c] = v; else rt[r] = v;
    }
    __syncthreads();

    // -- head solve (warp 0) -----------------------------------------------
    if (warp == 0) {
      warp_chol(S, h, h, lane);
      warp_fwd_col(S, h, h, rt, 1, lane);
      warp_bwd_col(S, h, h, rt, 1, lane);
    }
    __syncthreads();

    // -- tail back-substitution: L_D' \ (Y r_b - Y C' dx_h), one warp each
    for (int bi = warp; bi < nb; bi += kWarps) {
      const int sz = blk[2 * bi + 1];
      float* Y = sm + L.M[bi];
      for (int i = lane; i < sz; i += 32) {
        float s = 0.f;
        for (int c = 0; c < h; ++c) s += Y[i * hp + c] * rt[c];
        Y[i * hp + h + 1] = Y[i * hp + h] - s;
      }
      __syncwarp();
      warp_bwd_col(sm + L.D[bi], sz, sz, Y + h + 1, hp, lane);
    }
    __syncthreads();
    for (int i = tid; i < h; i += kThreads) dx[h0 + i] = -rt[i];
    for (int bi = 0; bi < nb; ++bi) {
      const int s0 = blk[2 * bi], sz = blk[2 * bi + 1];
      const float* Y = sm + L.M[bi];
      for (int i = tid; i < sz; i += kThreads) dx[s0 + i] = -Y[i * hp + h + 1];
    }
    __syncthreads();

    // -- non-finite fallback, trust region --------------------------------
    float gsq = 0.f;
    int fin = 1;
    for (int e = tid; e < n; e += kThreads) {
      gsq += grad[e] * grad[e];
      fin &= finite(dx[e]) ? 1 : 0;
    }
    fin = __syncthreads_and(fin);
    const float gnorm = sqrtf(block_sum(gsq, red));
    float am = 0.f, gm = 0.f;
    for (int e = tid; e < n; e += kThreads) {
      const float v = fin ? dx[e] : -grad[e] / fmaxf(gnorm, 1.f);
      dx[e] = v;
      am = nan_max(am, fabsf(v));
      gm = nan_max(gm, fabsf(grad[e]));
    }
    am = block_max(am, red);
    stat = block_max(gm, red);
    const float cap = fminf(1.f, opt.max_step / fmaxf(am, 1e-12f));
    float sl = 0.f, dfo = 0.f;
    for (int e = tid; e < n; e += kThreads) {
      const float v = dx[e] * cap;
      dx[e] = v;
      sl += grad[e] * v;
      dfo += __ldg(gf + e) * v;
    }
    const float slope = block_sum(sl, red);
    const float df_obj = block_sum(dfo, red);

    // -- line-search directions: J dx and dx'Q dx per row -----------------
    for (int fi = 0; fi < nfam; ++fi) {
      const int* f = fam0 + kFam * fi;
      const int kind = f[F_KIND], r0 = f[F_ROW], mf = f[F_MF], nfc = f[F_NF];
      const float* A = tab + f[F_A];
      const float* TA = f[F_TA] >= 0 ? tab + f[F_TA] : nullptr;
      const float* Q = f[F_Q] >= 0 ? tab + f[F_Q] : nullptr;
      for (int j = tid; j < nfc; j += kThreads) {
        const int g = gidx(f, j);
        xf[j] = x[g];
        df[j] = dx[g];
      }
      __syncthreads();
      if (Q != nullptr) {                  // t2 = Q dx_f, into J
        for (int e = tid; e < mf * nfc; e += kThreads) {
          const float* q = Q + (size_t)e * nfc;
          float s = 0.f;
          for (int k = 0; k < nfc; ++k) s += __ldg(q + k) * df[k];
          J[e] = s;
        }
        __syncthreads();
      }
      for (int r = tid; r < mf; r += kThreads) {
        float s = 0.f, sq = 0.f;
        for (int j = 0; j < nfc; ++j) {
          const int e = r * nfc + j;
          const float a = kind == KIND_CONST ? __ldg(A + e)
                                             : fam_a(A, TA, f, pv, e);
          if (Q != nullptr) {              // J dx = A dx + 2 x'Q dx
            const float t2 = J[e];
            s += a * df[j] + 2.f * xf[j] * t2;
            sq += t2 * df[j];
          } else {
            s += a * df[j];
          }
        }
        jd[r0 + r] = s;
        qd[r0 + r] = sq;
      }
      __syncthreads();
    }

    // -- exact-quadratic Armijo search: the first acceptable candidate ----
    float part[kMaxCands + 1];
#pragma unroll
    for (int c = 0; c <= kMaxCands; ++c) part[c] = 0.f;
    for (int r = tid; r < m; r += kThreads) {
      const float lo = __ldg(lb + r), hi = __ldg(ub + r);
      const float g = gv[r], l = lor[r], jr = jd[r], qr = qd[r];
      {
        const float rr = g + l;
        const float t = rr - fminf(fmaxf(rr, lo), hi);
        part[0] += t * t;
      }
#pragma unroll
      for (int c = 0; c < kMaxCands; ++c) {
        if (c < opt.n_cands) {
          const float rr = (g + opt.cand[c] * jr + opt.cand_sq[c] * qr) + l;
          const float t = rr - fminf(fmaxf(rr, lo), hi);
          part[c + 1] += t * t;
        }
      }
    }
    const float m0 = 0.5f * rho * block_sum(part[0], red);
    float alpha = 0.f;
    bool found = false;
#pragma unroll
    for (int c = 0; c < kMaxCands; ++c) {
      if (c < opt.n_cands) {
        const float mv = opt.cand[c] * df_obj
            + 0.5f * rho * block_sum(part[c + 1], red);
        const bool ok = finite(mv) && mv <= m0 + opt.armijo_a[c] * slope;
        if (ok && !found) {
          alpha = opt.cand[c];
          found = true;
        }
      }
    }

    for (int e = tid; e < n; e += kThreads) x[e] += alpha * dx[e];
    if (it == n_inner - 1) {
      for (int r = tid; r < m; r += kThreads)
        gv_out[b * m + r] = gv[r] + alpha * jd[r] + (alpha * alpha) * qd[r];
    }
    __syncthreads();
  }
  for (int e = tid; e < n; e += kThreads) x_out[b * n + e] = x[e];
  if (tid == 0) stat_out[b] = stat;
}

}  // namespace

extern "C" {

// The descriptor layout this file reads, in the order of LAYOUT in
// omg_tools_torch/ops/fused_alm.py, which checks it before its first
// launch.  Writes min(n, 11) values and returns how many it wrote.
int omg_fused_layout(int* out, int n) {
  const int v[] = {kMagic, kHeader, kFam, kMaxRuns, kMaxSegs, kMaxQ, H_LEN,
                   F_P, F_RUNS, F_SEGS, F_QPOS};
  const int k = n < 11 ? n : 11;
  for (int i = 0; i < k; ++i) out[i] = v[i];
  return k;
}

// K3: n_inner fused ALM inner iterations for B lanes.
//   desc_host / desc_dev: the plan's int32 descriptor on the host (read here
//     to check the plan and lay out shared memory) and on the device;
//   tables: one phase's flat f32 tables; lb, ub (m,) scaled, compact order;
//   x (B, n), lam (B, m), rho (B,), pv (B, n_v): the lane state;
//   opts: float64 [armijo, max_step, gn_delta_rel, delta, cand_0, ...];
//   x_out (B, n), gv_out (B, m), stat_out (B,).
// Returns cudaErrorInvalidValue, launching nothing, for a plan, width or
// option list the kernel cannot take.
int omg_fused_inner_f32(const int* desc_host, const int* desc_dev,
                        const float* tables, const float* lb, const float* ub,
                        const float* x, const float* lam, const float* rho,
                        const float* pv, const double* opts, int n_cands,
                        float* x_out, float* gv_out, float* stat_out, int B,
                        int n_inner, void* stream) {
  if (B <= 0 || n_inner <= 0 || n_cands <= 0 || n_cands > kMaxCands)
    return (int)cudaErrorInvalidValue;
  if (!valid_plan(desc_host)) return (int)cudaErrorInvalidValue;
  Layout L;
  if (!make_layout(desc_host, &L)) return (int)cudaErrorInvalidValue;
  Opts o;
  const double armijo = opts[0];
  o.max_step = (float)opts[1];
  o.gn_rel = (float)opts[2];
  o.delta = (float)opts[3];
  o.n_cands = n_cands;
  for (int c = 0; c < kMaxCands; ++c) {
    const double a = c < n_cands ? opts[4 + c] : 0.0;
    o.cand[c] = (float)a;
    o.cand_sq[c] = (float)(a * a);
    o.armijo_a[c] = (float)(armijo * a);
  }
  const size_t smem = sizeof(float) * (size_t)L.total;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_alm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_alm_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      desc_dev, tables, lb, ub, x, lam, rho, pv, x_out, gv_out, stat_out,
      n_inner, L, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
