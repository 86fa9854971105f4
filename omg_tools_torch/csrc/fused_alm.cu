// K3: the fused ALM inner loop, written for Hopper (sm_90a).  Built by
// omg_tools_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel of omg_tools_tpu/ops/fused_alm.py:297
// (make_fused_kernel -> kern): n_inner ALM inner Newton iterations per
// lane in one launch.  Each iteration: g(x), J and the multiplier estimate
// per row; the block-arrow Gauss-Newton assembly (head S, tail blocks D,
// panels [C' | r_b]); the ridge; the tail Cholesky factors,
// Y = L^-1 [C' | r_b] and the Schur complement onto the head; the head
// solve and back-substitution; the non-finite fallback and max_step cap;
// the exact-quadratic Armijo search (the first acceptable candidate).
// omg_tools_torch/ops/fused_alm.py holds the plan, its compressed encoding
// (FusedPlan.descriptor, FusedPlan.phase_values) and the plain PyTorch
// version (fused_inner_plain), which reads the dense tables instead.
//
// What bounds it on an H100 SXM (67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s HBM3, 50 MB L2; nvidia-smi names that part "NVIDIA H100 80GB
// HBM3").  For the bench plan (n = 151 variables, m = 671 rows, 21
// families, head 26, tail blocks 3 x 33 + 2 x 13) the function needs
// about 157 K multiply-adds a lane and iteration: 123 K in the dense
// factorizations and solves of the assembled tail blocks, panels and
// head, 34 K in the products with the plan's tables at their non-zeros
// and the Gauss-Newton products over J's pattern.  At B = 4096 and 8
// iterations that is ~11.9 GFLOP, ~0.18 ms at the f32 rate, against
// ~28.6 MB of lane state and tables: operations bound it (chip_smoke.py's
// k3_work).  The first version of this kernel read every dense table
// entry, zeros included (~1.2 M loads a lane and iteration, > 99 % of them
// zeros, strided across threads) from L2, and L2 traffic set its pace.
// TF32 is not used: the JAX package pins full-f32 products for these
// ill-conditioned Newton systems.
//
// Design.
//   - Compressed tables.  The kernel never receives the dense tables: one
//     int32 descriptor (phase-independent) and one float buffer per phase
//     hold J's row patterns with A0, the TA and Q sub-lists, C1, c0, gf and
//     the Gauss-Newton contribution lists: 9,012 non-zero values at the
//     bench plan (13,176 floats with the slices' padding), against the
//     298,160 floats of a phase's dense tables.
//     Every list is sliced: items in slices of 32, entry j of item i at
//     off[i] + 32 j, so a warp's threads read consecutive words from L2
//     (the lists, ~290 KB with their indices, are read where they lie;
//     shared memory holds the lanes).  The C entry point checks every
//     index against the plan's bounds before a launch.
//   - Gauss-Newton over J's pattern.  J is formed per row at its non-zeros
//     (A0 + TA pq + 2 Q x) into the lane's shared memory; each entry of
//     S, D (lower triangles) and C' that some row reaches has its own list
//     of (u, v) J-position pairs, summed by one thread in a fixed order,
//     so the assembly needs no atomics and one barrier for all families.
//   - Several lanes per block.  A block of 256 threads serves L lanes
//     (the wrapper picks L from B and the shared memory: 2 at B = 4096,
//     two blocks an SM; 1 at the rescue's 128 lanes, so that the launch
//     still spreads over the SMs; at most kMaxLanes = 2, since three or
//     four lanes a block ran slower than two at the bench plan, which
//     sizes the per-lane register arrays).  Row, entry and target phases spread
//     threads over the items and loop over the lanes; the per-lane serial
//     phases (ridge, tail-block and head factorizations, substitutions,
//     fallback and line-search reductions) run one warp per (lane, block)
//     or per lane, warp-synchronously; ten block barriers an iteration.
//     The factorizations keep a column in registers and broadcast by
//     shuffle, so a column's updates are independent of each other.
//   - The lane's working set (50 KB at the bench plan): x, dx, gradient,
//     pv, the rows' g, y (later J dx) and dx'Q dx, J at its positions, S
//     and D as packed lower triangles, the panels and a few scalars.
//     Multipliers over rho and the constants c = c0 + C1 pv are formed
//     where they are read.
//   - A non-positive pivot gives rsqrt of a non-positive number, so dx is
//     non-finite and the fallback turns it into a gradient step, as in the
//     TPU kernel.

#include <cuda_runtime.h>

namespace {

// descriptor layout, shared with omg_tools_torch/ops/fused_alm.py
constexpr int kMagic = 0x4B34;
constexpr int kHeader = 48;
constexpr int kSlice = 32;
constexpr int kMaxBlocks = 16;
constexpr int kMaxLanes = 2;
constexpr int kMaxCands = 16;
constexpr int kMaxJ = 65536;
constexpr int kMaxSize = 64;            // head and tail blocks (column solves)
constexpr int kLaneScalars = 8;
constexpr int kPhases = 10;             // P1-P10 of an iteration
enum { H_MAGIC, H_N, H_M, H_NV, H_H0, H_H, H_NB, H_NJ, H_ARROW, H_VLEN,
       H_LEN, H_STAGE, H_NGN, H_NQ, H_NT, H_NC, H_NGR, H_NGE,
       V_A, V_Q, V_T, V_C, V_C0, V_GF,
       O_ROFF, O_RLEN, O_COFF, O_CLEN, O_CIDX,
       O_COL, O_QOFF, O_QLEN, O_QIDX, O_TOFF, O_TLEN, O_TIDX,
       O_GROFF, O_GRLEN, O_GRENT, O_GRROW,
       O_GNOFF, O_GNLEN, O_GNDST, O_GNENT, O_GNROW, H_END };
enum { B_START, B_SIZE, B_D, B_M, B_REC };
static_assert(H_END <= kHeader, "header fields overflow the header");
// lane scalars
enum { S_RHO, S_SLOPE, S_DF, S_STAT };

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

__host__ __device__ __forceinline__ int r4(int c) { return (c + 3) & ~3; }
__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// float offsets into one lane's region of shared memory (the order of
// FusedPlan.lane_floats)
struct Lane {
  int x, dx, grad, pv, gv, y, qd, J, ar, sc, total;
};

Lane lane_layout(const int* d) {
  Lane L;
  int o = 0;
  auto take = [&o](int count) {
    const int at = o;
    o += r4(count);
    return at;
  };
  const int n = d[H_N], m = d[H_M];
  L.x = take(n);
  L.dx = take(n);
  L.grad = take(n);
  L.pv = take(d[H_NV]);
  L.gv = take(m);
  L.y = take(m);
  L.qd = take(m);
  L.J = take(d[H_NJ]);
  L.ar = take(d[H_ARROW]);
  L.sc = take(kLaneScalars);
  L.total = o;
  return L;
}

// Everything the kernel indexes with must be in range.
bool valid_plan(const int* d) {
  if (d[H_MAGIC] != kMagic) return false;
  const int n = d[H_N], m = d[H_M], nv = d[H_NV], h0 = d[H_H0], h = d[H_H];
  const int nb = d[H_NB], nJ = d[H_NJ], len = d[H_LEN], vlen = d[H_VLEN];
  if (n <= 0 || m <= 0 || nv < 0 || h <= 0 || h > kMaxSize || h0 < 0 ||
      h0 + h > n ||
      nb < 0 || nb > kMaxBlocks || nJ < 0 || nJ > kMaxJ || len < kHeader ||
      vlen < 0)
    return false;
  if (d[H_STAGE] != kHeader + (B_REC + 1) * nb || d[H_STAGE] > len)
    return false;
  for (int k = H_NGN; k <= H_NGE; ++k)
    if (d[k] < 0) return false;
  // the arrow region as FusedPlan lays it out; the tail blocks and the
  // head tile the variables
  int arrow = r4(tri(h)) + r4(h), covered = h;
  unsigned used = 0;
  for (int bi = 0; bi < nb; ++bi) {
    const int* b = d + kHeader + B_REC * bi;
    const int s = b[B_START], sz = b[B_SIZE];
    if (sz <= 0 || sz > kMaxSize || s < 0 || s + sz > n) return false;
    if ((s < h0 + h && h0 < s + sz)) return false;
    if (b[B_D] != arrow) return false;
    arrow += r4(tri(sz));
    if (b[B_M] != arrow) return false;
    arrow += r4(sz * (h + 2));
    covered += sz;
    const int o = d[kHeader + B_REC * nb + bi];
    if (o < 0 || o >= nb || (used >> o & 1u)) return false;
    used |= 1u << o;
  }
  if (covered != n || arrow != d[H_ARROW]) return false;
  // the arrays lie in the descriptor, the value sections in the values
  auto in = [](long long off, long long count, long long size) {
    return off >= 0 && count >= 0 && off + count <= size;
  };
  const int nq = d[H_NQ], nt = d[H_NT], nc = d[H_NC], ngr = d[H_NGR];
  const int ngn = d[H_NGN], nge = d[H_NGE];
  const struct { int field, count; } arrays[] = {
      {O_ROFF, m}, {O_RLEN, m}, {O_COFF, m}, {O_CLEN, m}, {O_CIDX, nc},
      {O_COL, nJ}, {O_QOFF, nJ}, {O_QLEN, nJ}, {O_QIDX, nq}, {O_TOFF, nJ},
      {O_TLEN, nJ}, {O_TIDX, nt}, {O_GROFF, n}, {O_GRLEN, n},
      {O_GRENT, ngr}, {O_GRROW, ngr}, {O_GNOFF, ngn}, {O_GNLEN, ngn},
      {O_GNDST, ngn}, {O_GNENT, nge}, {O_GNROW, nge}};
  for (const auto& a : arrays)
    if (d[a.field] < d[H_STAGE] || !in(d[a.field], a.count, len))
      return false;
  const struct { int field, count; } values[] = {
      {V_A, nJ}, {V_Q, nq}, {V_T, nt}, {V_C, nc}, {V_C0, m}, {V_GF, n}};
  for (const auto& v : values)
    if (!in(d[v.field], v.count, vlen)) return false;
  // sliced lists: entry j of item i at off[i] + 32 j, inside its space
  auto lists = [&](int o_off, int o_len, int items, int space) {
    for (int i = 0; i < items; ++i) {
      const long long off = d[d[o_off] + i], cnt = d[d[o_len] + i];
      if (cnt < 0 || off < 0) return false;
      if (cnt > 0 && off + (long long)kSlice * (cnt - 1) >= space)
        return false;
    }
    return true;
  };
  if (!lists(O_ROFF, O_RLEN, m, nJ) || !lists(O_COFF, O_CLEN, m, nc) ||
      !lists(O_QOFF, O_QLEN, nJ, nq) || !lists(O_TOFF, O_TLEN, nJ, nt) ||
      !lists(O_GROFF, O_GRLEN, n, ngr) || !lists(O_GNOFF, O_GNLEN, ngn, nge))
    return false;
  auto all_below = [&](int field, int count, int bound) {
    for (int i = 0; i < count; ++i) {
      const int v = d[d[field] + i];
      if (v < 0 || v >= bound) return false;
    }
    return true;
  };
  if (!all_below(O_CIDX, nc, nv > 0 ? nv : 1) ||
      !all_below(O_COL, nJ, n) || !all_below(O_QIDX, nq, n) ||
      !all_below(O_TIDX, nt, nv > 0 ? nv : 1) ||
      !all_below(O_GRENT, ngr, nJ > 0 ? nJ : 1) ||
      !all_below(O_GRROW, ngr, m) || !all_below(O_GNROW, nge, m) ||
      !all_below(O_GNDST, ngn, d[H_ARROW]))
    return false;
  if ((nc > 0 || nt > 0) && nv == 0) return false;
  for (int i = 0; i < nge; ++i) {
    const unsigned e = (unsigned)d[d[O_GNENT] + i];
    if ((int)(e & 0xffffu) >= nJ || (int)(e >> 16) >= nJ) return false;
  }
  return true;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
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

// In-place right-looking Cholesky of the (n, n) matrix held as a packed
// lower triangle (row i at tri(i)) by one warp.  For each column j the
// lanes own the trailing columns k = j + 1 + lane, hold L[k, j] in a
// register and walk the rows, taking L[i, j] by shuffle: the updates of a
// column are independent, so they pipeline (n <= 33; a larger n walks the
// rows per lane instead).
__device__ __forceinline__ void warp_chol(float* L, int n, int lane) {
  for (int j = 0; j < n; ++j) {
    const float inv = rsqrtf(L[tri(j) + j]);
    __syncwarp();
    for (int i = j + lane; i < n; i += 32) L[tri(i) + j] *= inv;
    __syncwarp();
    const int rem = n - j - 1;
    if (rem <= 32) {
      const int k = j + 1 + lane;
      const float ck = lane < rem ? L[tri(k) + j] : 0.f;
      int i = j + 1;
      for (; i + 3 < n; i += 4) {            // four rows' loads in flight
        float l[4], a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          l[u] = __shfl_sync(0xffffffffu, ck, i + u - j - 1);
          a[u] = k <= i + u ? L[tri(i + u) + k] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (k <= i + u) L[tri(i + u) + k] = a[u] - l[u] * ck;
      }
      for (; i < n; ++i) {
        const float lij = __shfl_sync(0xffffffffu, ck, i - j - 1);
        if (k <= i) L[tri(i) + k] -= lij * ck;
      }
    } else {
      for (int i = j + 1 + lane; i < n; i += 32) {
        float* Li = L + tri(i);
        const float lij = Li[j];
        for (int k = j + 1; k <= i; ++k) Li[k] -= lij * L[tri(k) + j];
      }
    }
    __syncwarp();
  }
}

// In place P <- L^-1 P for the first ncols columns of P (row stride ldp),
// L packed; lanes own whole columns.
__device__ __forceinline__ void warp_fwd_panel(const float* L, int n,
                                               float* P, int ldp, int ncols,
                                               int lane) {
  for (int c = lane; c < ncols; c += 32) {
    for (int i = 0; i < n; ++i) {
      const float* Li = L + tri(i);
      float acc = 0.f;
      for (int k = 0; k < i; ++k) acc += Li[k] * P[k * ldp + c];
      P[i * ldp + c] = (P[i * ldp + c] - acc) / Li[i];
    }
  }
  __syncwarp();
}

// In place v <- L^-1 v (forward) or L'^-1 v (backward), L packed, v with
// stride ldv, n <= 64: lane t keeps v[t] and v[t + 32] in registers; each
// solved entry is broadcast by shuffle and subtracted from the rest.
__device__ __forceinline__ void warp_fwd_col(const float* L, int n, float* v,
                                             int ldv, int lane) {
  const int t1 = lane + 32;
  float v0 = lane < n ? v[lane * ldv] : 0.f;
  float v1 = t1 < n ? v[t1 * ldv] : 0.f;
  for (int i = 0; i < n; ++i) {
    const float vi =
        __shfl_sync(0xffffffffu, i < 32 ? v0 : v1, i & 31) / L[tri(i) + i];
    if (lane == (i & 31)) {
      if (i < 32) v0 = vi; else v1 = vi;
    }
    if (lane > i && lane < n) v0 -= L[tri(lane) + i] * vi;
    if (t1 > i && t1 < n) v1 -= L[tri(t1) + i] * vi;
  }
  __syncwarp();
  if (lane < n) v[lane * ldv] = v0;
  if (t1 < n) v[t1 * ldv] = v1;
  __syncwarp();
}

__device__ __forceinline__ void warp_bwd_col(const float* L, int n, float* v,
                                             int ldv, int lane) {
  const int t1 = lane + 32;
  float v0 = lane < n ? v[lane * ldv] : 0.f;
  float v1 = t1 < n ? v[t1 * ldv] : 0.f;
  for (int i = n - 1; i >= 0; --i) {
    const float* Li = L + tri(i);
    const float vi =
        __shfl_sync(0xffffffffu, i < 32 ? v0 : v1, i & 31) / Li[i];
    if (lane == (i & 31)) {
      if (i < 32) v0 = vi; else v1 = vi;
    }
    if (lane < i) v0 -= Li[lane] * vi;
    if (t1 < i) v1 -= Li[t1] * vi;
  }
  __syncwarp();
  if (lane < n) v[lane * ldv] = v0;
  if (t1 < n) v[t1 * ldv] = v1;
  __syncwarp();
}

// Optional profile: a block's time in one phase (barrier to barrier),
// summed over blocks and iterations into clocks[phase].
__device__ __forceinline__ void mark(unsigned long long* clocks, int phase,
                                     int tid, long long& t0) {
  if (clocks != nullptr && tid == 0) {
    const long long t1 = clock64();
    atomicAdd(clocks + phase, (unsigned long long)(t1 - t0));
    t0 = t1;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_alm_kernel(const int* __restrict__ desc, const float* __restrict__ vals,
                 const float* __restrict__ lb, const float* __restrict__ ub,
                 const float* __restrict__ x_in, const float* __restrict__ lam,
                 const float* __restrict__ rho_in,
                 const float* __restrict__ pv_in, float* __restrict__ x_out,
                 float* __restrict__ gv_out, float* __restrict__ stat_out,
                 long long B, int n_inner, int lanes, Lane LL, Opts opt,
                 unsigned long long* __restrict__ clocks) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* hd = reinterpret_cast<int*>(sm);
  {
    const int stage = __ldg(desc + H_STAGE);
    for (int e = tid; e < stage; e += kThreads) hd[e] = __ldg(desc + e);
  }
  __syncthreads();
  const int n = hd[H_N], m = hd[H_M], nv = hd[H_NV], h0 = hd[H_H0];
  const int h = hd[H_H], nb = hd[H_NB], arrow = hd[H_ARROW];
  const int ngn = hd[H_NGN], hp = h + 2;
  const int* blk = hd + kHeader;          // tail-block records
  const int* order = blk + B_REC * nb;    // Schur subtraction order
  const long long b0 = (long long)blockIdx.x * lanes;
  const int nl = (int)(B - b0 < lanes ? B - b0 : lanes);
  float* lanes0 = sm + r4(hd[H_STAGE]);   // lane l's region at l * lt
  const int lt = LL.total;

  // the compressed tables (L2): index arrays and this phase's values
  const int* roff = desc + hd[O_ROFF];
  const int* rlen = desc + hd[O_RLEN];
  const int* coff = desc + hd[O_COFF];
  const int* clen = desc + hd[O_CLEN];
  const int* cidx = desc + hd[O_CIDX];
  const int* col = desc + hd[O_COL];
  const int* qoff = desc + hd[O_QOFF];
  const int* qlen = desc + hd[O_QLEN];
  const int* qidx = desc + hd[O_QIDX];
  const int* toff = desc + hd[O_TOFF];
  const int* tlen = desc + hd[O_TLEN];
  const int* tidx = desc + hd[O_TIDX];
  const int* groff = desc + hd[O_GROFF];
  const int* grlen = desc + hd[O_GRLEN];
  const int* grent = desc + hd[O_GRENT];
  const int* grrow = desc + hd[O_GRROW];
  const int* gnoff = desc + hd[O_GNOFF];
  const int* gnlen = desc + hd[O_GNLEN];
  const int* gndst = desc + hd[O_GNDST];
  const int* gnent = desc + hd[O_GNENT];
  const int* gnrow = desc + hd[O_GNROW];
  const float* VA = vals + hd[V_A];
  const float* VQ = vals + hd[V_Q];
  const float* VT = vals + hd[V_T];
  const float* VC = vals + hd[V_C];
  const float* c0 = vals + hd[V_C0];
  const float* gf = vals + hd[V_GF];


  // -- lane state -----------------------------------------------------------
  for (int l = 0; l < nl; ++l) {
    float* L = lanes0 + l * lt;
    const long long b = b0 + l;
    for (int e = tid; e < n; e += kThreads) L[LL.x + e] = x_in[b * n + e];
    for (int e = tid; e < nv; e += kThreads) L[LL.pv + e] = pv_in[b * nv + e];
    if (tid == 0) L[LL.sc + S_RHO] = rho_in[b];
  }
  __syncthreads();
  float rho[kMaxLanes];
#pragma unroll
  for (int l = 0; l < kMaxLanes; ++l)
    rho[l] = l < nl ? (lanes0 + l * lt)[LL.sc + S_RHO] : 1.f;

  // The table-driven phases (P1, P2, P9) read each index entry once for all
  // of the block's lanes: the `#pragma unroll` loops over kMaxLanes with
  // `l < nl` keep the per-lane sums in registers.
  long long t0 = clock64();   // the phase clocks' last mark
  for (int it = 0; it < n_inner; ++it) {
    // -- P1, rows: J at its positions, g, y; clear the arrow region -------
    for (int l = 0; l < nl; ++l)
      for (int e = tid; e < arrow; e += kThreads)
        (lanes0 + l * lt)[LL.ar + e] = 0.f;
    for (int r = tid; r < m; r += kThreads) {
      const int ro = __ldg(roff + r), rl = __ldg(rlen + r);
      float s[kMaxLanes], cs[kMaxLanes];
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) s[l] = cs[l] = 0.f;
      for (int j = 0; j < rl; ++j) {
        const int p = ro + kSlice * j;
        const float a0 = __ldg(VA + p);
        const int c = __ldg(col + p);
        const int tl = __ldg(tlen + p), to = __ldg(toff + p);
        const int ql = __ldg(qlen + p), qo = __ldg(qoff + p);
        float ta[kMaxLanes], t1[kMaxLanes];
#pragma unroll
        for (int l = 0; l < kMaxLanes; ++l) ta[l] = t1[l] = 0.f;
        for (int q = 0; q < tl; ++q) {       // TA pq
          const int e = to + kSlice * q;
          const float w = __ldg(VT + e);
          const int k = LL.pv + __ldg(tidx + e);
#pragma unroll
          for (int l = 0; l < kMaxLanes; ++l)
            if (l < nl) ta[l] += w * (lanes0 + l * lt)[k];
        }
        for (int q = 0; q < ql; ++q) {       // Q x
          const int e = qo + kSlice * q;
          const float w = __ldg(VQ + e);
          const int k = LL.x + __ldg(qidx + e);
#pragma unroll
          for (int l = 0; l < kMaxLanes; ++l)
            if (l < nl) t1[l] += w * (lanes0 + l * lt)[k];
        }
        // A = A0 + TA pq; J = A + 2 Q x; g += (A + Q x) x
#pragma unroll
        for (int l = 0; l < kMaxLanes; ++l) {
          if (l < nl) {
            float* L = lanes0 + l * lt;
            const float a = a0 + ta[l];
            s[l] += (a + t1[l]) * L[LL.x + c];
            L[LL.J + p] = a + 2.f * t1[l];
          }
        }
      }
      const int co = __ldg(coff + r), cl = __ldg(clen + r);
      for (int q = 0; q < cl; ++q) {         // c = c0 + C1 pv
        const int e = co + kSlice * q;
        const float w = __ldg(VC + e);
        const int k = LL.pv + __ldg(cidx + e);
#pragma unroll
        for (int l = 0; l < kMaxLanes; ++l)
          if (l < nl) cs[l] += w * (lanes0 + l * lt)[k];
      }
      const float c0r = __ldg(c0 + r), lo = __ldg(lb + r), hi = __ldg(ub + r);
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) {
        if (l < nl) {
          float* L = lanes0 + l * lt;
          const float g = (c0r + cs[l]) + s[l];
          const float rr = g + lam[(b0 + l) * m + r] / rho[l];
          L[LL.gv + r] = g;
          L[LL.y + r] = rho[l] * (rr - fminf(fmaxf(rr, lo), hi));
        }
      }
    }
    __syncthreads();
    mark(clocks, 0, tid, t0);

    // -- P2, targets: gradient gf + J'y; S, D, C' from the pair lists -----
    for (int v = tid; v < n; v += kThreads) {
      const int go = __ldg(groff + v), gl = __ldg(grlen + v);
      float s[kMaxLanes];
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) s[l] = 0.f;
#pragma unroll 4
      for (int j = 0; j < gl; ++j) {
        const int e = go + kSlice * j;
        const int p = LL.J + __ldg(grent + e), r = LL.y + __ldg(grrow + e);
#pragma unroll
        for (int l = 0; l < kMaxLanes; ++l)
          if (l < nl) s[l] += (lanes0 + l * lt)[p] * (lanes0 + l * lt)[r];
      }
      const float g0 = __ldg(gf + v);
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l)
        if (l < nl) (lanes0 + l * lt)[LL.grad + v] = g0 + s[l];
    }
    for (int t = tid; t < ngn; t += kThreads) {
      const int go = __ldg(gnoff + t), gl = __ldg(gnlen + t);
      float hv[kMaxLanes];
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) hv[l] = 0.f;
#pragma unroll 4
      for (int j = 0; j < gl; ++j) {
        const int e = go + kSlice * j;
        const unsigned uv = (unsigned)__ldg(gnent + e);
        const int r = LL.y + __ldg(gnrow + e);
        const int u = LL.J + (int)(uv & 0xffffu), v = LL.J + (int)(uv >> 16);
#pragma unroll
        for (int l = 0; l < kMaxLanes; ++l) {
          if (l < nl) {
            const float* L = lanes0 + l * lt;
            const float d = fabsf(L[r]) > 0.f ? rho[l] : 0.f;
            hv[l] += (L[u] * d) * L[v];
          }
        }
      }
      const int dst = LL.ar + __ldg(gndst + t);
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l)
        if (l < nl) (lanes0 + l * lt)[dst] = hv[l];
    }
    __syncthreads();
    mark(clocks, 1, tid, t0);

    // -- P3, a warp per lane: ridge; right-hand sides ----------------------
    for (int l = warp; l < nl; l += kWarps) {
      float* L = lanes0 + l * lt;
      float* S = L + LL.ar;
      float* rt = S + r4(tri(h));
      const float* grad = L + LL.grad;
      float dm = 0.f;
      for (int i = lane; i < h; i += 32) {
        rt[i] = grad[h0 + i];
        dm = nan_max(dm, fabsf(S[tri(i) + i]));
      }
      for (int bi = 0; bi < nb; ++bi) {
        const int s0 = blk[B_REC * bi + B_START], sz = blk[B_REC * bi + B_SIZE];
        const float* Db = L + LL.ar + blk[B_REC * bi + B_D];
        float* Mb = L + LL.ar + blk[B_REC * bi + B_M];
        for (int i = lane; i < sz; i += 32) {
          Mb[i * hp + h] = grad[s0 + i];
          dm = nan_max(dm, fabsf(Db[tri(i) + i]));
        }
      }
      dm = warp_max(dm);
      const float ridge = opt.gn_rel * nan_max(dm, 1.f) + opt.delta;
      for (int i = lane; i < h; i += 32) S[tri(i) + i] += ridge;
      for (int bi = 0; bi < nb; ++bi) {
        const int sz = blk[B_REC * bi + B_SIZE];
        float* Db = L + LL.ar + blk[B_REC * bi + B_D];
        for (int i = lane; i < sz; i += 32) Db[tri(i) + i] += ridge;
      }
    }
    __syncthreads();
    mark(clocks, 2, tid, t0);

    // -- P4, a warp per (lane, tail block): L_D, Y = L_D^-1 [C' | r_b] ----
    for (int jb = warp; jb < nl * nb; jb += kWarps) {
      const int l = jb % nl, bi = jb / nl;
      float* A = lanes0 + l * lt + LL.ar;
      const int sz = blk[B_REC * bi + B_SIZE];
      float* Db = A + blk[B_REC * bi + B_D];
      warp_chol(Db, sz, lane);
      warp_fwd_panel(Db, sz, A + blk[B_REC * bi + B_M], hp, h + 1, lane);
    }
    __syncthreads();
    mark(clocks, 3, tid, t0);

    // -- P5, Schur complement: S - sum Y'Y (lower), r_h - sum Y' r_b -------
    for (int l = 0; l < nl; ++l) {
      float* A = lanes0 + l * lt + LL.ar;
      float* rt = A + r4(tri(h));
      for (int e = tid; e < h * (h + 1); e += kThreads) {
        const int r = e / (h + 1), c = e - r * (h + 1);
        if (c < h && c > r) continue;
        float v = c < h ? A[tri(r) + c] : rt[r];
        for (int o = 0; o < nb; ++o) {
          const int bi = order[o], sz = blk[B_REC * bi + B_SIZE];
          const float* Y = A + blk[B_REC * bi + B_M];
          float g = 0.f;
          for (int k = 0; k < sz; ++k) g += Y[k * hp + r] * Y[k * hp + c];
          v -= g;
        }
        if (c < h) A[tri(r) + c] = v; else rt[r] = v;
      }
    }
    __syncthreads();
    mark(clocks, 4, tid, t0);

    // -- P6, a warp per lane: the head solve --------------------------------
    for (int l = warp; l < nl; l += kWarps) {
      float* S = lanes0 + l * lt + LL.ar;
      float* rt = S + r4(tri(h));
      warp_chol(S, h, lane);
      warp_fwd_col(S, h, rt, 1, lane);
      warp_bwd_col(S, h, rt, 1, lane);
    }
    __syncthreads();
    mark(clocks, 5, tid, t0);

    // -- P7, a warp per (lane, tail block): L_D' \ (Y r_b - Y C' dx_h) -----
    for (int jb = warp; jb < nl * nb; jb += kWarps) {
      const int l = jb % nl, bi = jb / nl;
      float* L = lanes0 + l * lt;
      const float* rt = L + LL.ar + r4(tri(h));
      const int s0 = blk[B_REC * bi + B_START], sz = blk[B_REC * bi + B_SIZE];
      float* Y = L + LL.ar + blk[B_REC * bi + B_M];
      for (int i = lane; i < sz; i += 32) {
        float s = 0.f;
        for (int c = 0; c < h; ++c) s += Y[i * hp + c] * rt[c];
        Y[i * hp + h + 1] = Y[i * hp + h] - s;
      }
      __syncwarp();
      warp_bwd_col(L + LL.ar + blk[B_REC * bi + B_D], sz, Y + h + 1, hp, lane);
      for (int i = lane; i < sz; i += 32)
        L[LL.dx + s0 + i] = -Y[i * hp + h + 1];
    }
    __syncthreads();
    mark(clocks, 6, tid, t0);

    // -- P8, a warp per lane: non-finite fallback, trust region ------------
    for (int l = warp; l < nl; l += kWarps) {
      float* L = lanes0 + l * lt;
      float* dx = L + LL.dx;
      const float* grad = L + LL.grad;
      const float* rt = L + LL.ar + r4(tri(h));
      for (int i = lane; i < h; i += 32) dx[h0 + i] = -rt[i];
      __syncwarp();
      float gsq = 0.f;
      bool fin = true;
      for (int e = lane; e < n; e += 32) {
        gsq += grad[e] * grad[e];
        fin = fin && finite(dx[e]);
      }
      fin = __all_sync(0xffffffffu, fin);
      const float gnorm = sqrtf(warp_sum(gsq));
      float am = 0.f, gm = 0.f;
      for (int e = lane; e < n; e += 32) {
        const float v = fin ? dx[e] : -grad[e] / fmaxf(gnorm, 1.f);
        dx[e] = v;
        am = nan_max(am, fabsf(v));
        gm = nan_max(gm, fabsf(grad[e]));
      }
      am = warp_max(am);
      gm = warp_max(gm);
      const float cap = fminf(1.f, opt.max_step / fmaxf(am, 1e-12f));
      float sl = 0.f, dfo = 0.f;
      for (int e = lane; e < n; e += 32) {
        const float v = dx[e] * cap;
        dx[e] = v;
        sl += grad[e] * v;
        dfo += __ldg(gf + e) * v;
      }
      sl = warp_sum(sl);
      dfo = warp_sum(dfo);
      if (lane == 0) {
        L[LL.sc + S_SLOPE] = sl;
        L[LL.sc + S_DF] = dfo;
        L[LL.sc + S_STAT] = gm;
      }
    }
    __syncthreads();
    mark(clocks, 7, tid, t0);

    // -- P9, rows: J dx (into y) and dx'Q dx ------------------------------
    for (int r = tid; r < m; r += kThreads) {
      const int ro = __ldg(roff + r), rl = __ldg(rlen + r);
      float jd[kMaxLanes], qd[kMaxLanes];
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) jd[l] = qd[l] = 0.f;
      for (int j = 0; j < rl; ++j) {
        const int p = LL.J + ro + kSlice * j;
        const int c = LL.dx + __ldg(col + ro + kSlice * j);
        const int ql = __ldg(qlen + ro + kSlice * j);
        const int qo = __ldg(qoff + ro + kSlice * j);
        float t2[kMaxLanes];
#pragma unroll
        for (int l = 0; l < kMaxLanes; ++l) t2[l] = 0.f;
        for (int q = 0; q < ql; ++q) {       // Q dx
          const int e = qo + kSlice * q;
          const float w = __ldg(VQ + e);
          const int k = LL.dx + __ldg(qidx + e);
#pragma unroll
          for (int l = 0; l < kMaxLanes; ++l)
            if (l < nl) t2[l] += w * (lanes0 + l * lt)[k];
        }
#pragma unroll
        for (int l = 0; l < kMaxLanes; ++l) {
          if (l < nl) {
            const float* L = lanes0 + l * lt;
            const float dc = L[c];
            jd[l] += L[p] * dc;
            if (ql > 0) qd[l] += t2[l] * dc;
          }
        }
      }
#pragma unroll
      for (int l = 0; l < kMaxLanes; ++l) {
        if (l < nl) {
          (lanes0 + l * lt)[LL.y + r] = jd[l];
          (lanes0 + l * lt)[LL.qd + r] = qd[l];
        }
      }
    }
    __syncthreads();
    mark(clocks, 8, tid, t0);

    // -- P10, a warp per lane: the exact-quadratic Armijo search -----------
    for (int l = warp; l < nl; l += kWarps) {
      float* L = lanes0 + l * lt;
      const float rho_l = L[LL.sc + S_RHO];
      const long long b = b0 + l;
      const float* gv = L + LL.gv;
      const float* jd = L + LL.y;
      const float* qd = L + LL.qd;
      float part[kMaxCands + 1];
#pragma unroll
      for (int c = 0; c <= kMaxCands; ++c) part[c] = 0.f;
      for (int r = lane; r < m; r += 32) {
        const float lo = __ldg(lb + r), hi = __ldg(ub + r);
        const float g = gv[r], lr = lam[b * m + r] / rho_l;
        const float jr = jd[r], qr = qd[r];
        {
          const float rr = g + lr;
          const float t = rr - fminf(fmaxf(rr, lo), hi);
          part[0] += t * t;
        }
#pragma unroll
        for (int c = 0; c < kMaxCands; ++c) {
          if (c < opt.n_cands) {
            const float rr = (g + opt.cand[c] * jr + opt.cand_sq[c] * qr) + lr;
            const float t = rr - fminf(fmaxf(rr, lo), hi);
            part[c + 1] += t * t;
          }
        }
      }
      const float m0 = 0.5f * rho_l * warp_sum(part[0]);
      const float slope = L[LL.sc + S_SLOPE], df_obj = L[LL.sc + S_DF];
      float alpha = 0.f;
      bool found = false;
#pragma unroll
      for (int c = 0; c < kMaxCands; ++c) {
        if (c < opt.n_cands) {
          const float mv = opt.cand[c] * df_obj
              + 0.5f * rho_l * warp_sum(part[c + 1]);
          const bool ok = finite(mv) && mv <= m0 + opt.armijo_a[c] * slope;
          if (ok && !found) {
            alpha = opt.cand[c];
            found = true;
          }
        }
      }
      float* x = L + LL.x;
      const float* dx = L + LL.dx;
      for (int e = lane; e < n; e += 32) x[e] += alpha * dx[e];
      if (it == n_inner - 1) {
        for (int r = lane; r < m; r += 32)
          gv_out[b * m + r] = gv[r] + alpha * jd[r] + (alpha * alpha) * qd[r];
        __syncwarp();
        for (int e = lane; e < n; e += 32) x_out[b * n + e] = x[e];
        if (lane == 0) stat_out[b] = L[LL.sc + S_STAT];
      }
    }
    __syncthreads();
    mark(clocks, 9, tid, t0);
  }
}

bool make_opts(const double* opts, int n_cands, Opts* o) {
  if (n_cands <= 0 || n_cands > kMaxCands) return false;
  const double armijo = opts[0];
  o->max_step = (float)opts[1];
  o->gn_rel = (float)opts[2];
  o->delta = (float)opts[3];
  o->n_cands = n_cands;
  for (int c = 0; c < kMaxCands; ++c) {
    const double a = c < n_cands ? opts[4 + c] : 0.0;
    o->cand[c] = (float)a;
    o->cand_sq[c] = (float)(a * a);
    o->armijo_a[c] = (float)(armijo * a);
  }
  return true;
}

// shared bytes of a block of `lanes` lanes (the plan checked)
size_t smem_bytes(const int* d, int lanes) {
  return sizeof(float) * ((size_t)r4(d[H_STAGE]) +
                          (size_t)lanes * lane_layout(d).total);
}

}  // namespace

extern "C" {

// The descriptor layout this file reads, in the order of LAYOUT in
// omg_tools_torch/ops/fused_alm.py, which checks it before its first
// launch.  Writes min(n, 10) values and returns how many it wrote.
int omg_fused_layout(int* out, int n) {
  const int v[] = {kMagic, kHeader, kSlice, kMaxBlocks, kMaxLanes,
                   kMaxCands, H_END, B_REC, kLaneScalars, kPhases};
  const int k = n < 10 ? n : 10;
  for (int i = 0; i < k; ++i) out[i] = v[i];
  return k;
}

// Shared bytes a block of `lanes` lanes takes for this descriptor, or -1
// for a plan or lane count the kernel does not take.
int omg_fused_smem(const int* desc_host, int lanes) {
  if (lanes < 1 || lanes > kMaxLanes || !valid_plan(desc_host)) return -1;
  return (int)smem_bytes(desc_host, lanes);
}

// K3: n_inner fused ALM inner iterations for B lanes, `lanes` a block.
//   desc_host / desc_dev: the plan's int32 descriptor on the host (checked
//     here) and on the device; vals: one phase's values;
//   lb, ub (m,) scaled, compact order;
//   x (B, n), lam (B, m), rho (B,), pv (B, n_v): the lane state;
//   opts: float64 [armijo, max_step, gn_delta_rel, delta, cand_0, ...];
//   x_out (B, n), gv_out (B, m), stat_out (B,);
//   clocks: null, or kPhases uint64 on the device to which each block adds
//     the clock cycles of each phase P1-P10 (the profile of chip_smoke.py).
// Returns cudaErrorInvalidValue, launching nothing, for a plan, width,
// lane count or option list the kernel cannot take.
int omg_fused_inner_f32(const int* desc_host, const int* desc_dev,
                        const float* vals, const float* lb, const float* ub,
                        const float* x, const float* lam, const float* rho,
                        const float* pv, const double* opts, int n_cands,
                        float* x_out, float* gv_out, float* stat_out, int B,
                        int n_inner, int lanes, unsigned long long* clocks,
                        void* stream) {
  Opts o;
  if (B <= 0 || n_inner <= 0 || lanes < 1 || lanes > kMaxLanes ||
      !make_opts(opts, n_cands, &o) || !valid_plan(desc_host))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(desc_host, lanes);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_alm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + lanes - 1) / lanes;
  fused_alm_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      desc_dev, vals, lb, ub, x, lam, rho, pv, x_out, gv_out, stat_out,
      (long long)B, n_inner, lanes, lane_layout(desc_host), o, clocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
