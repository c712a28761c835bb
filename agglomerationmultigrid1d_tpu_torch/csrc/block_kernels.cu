// Hand-written Hopper (sm_90a) kernels for the block-tridiagonal V-cycle.
//
// Layout (the same as the JAX package): every operator stream is a
// (bs, bs, n) float32 array, entry (i, j) of block column k at
// [(i * bs + j) * n + k]; vectors are (bs, n), entry i of column k at
// [i * n + k].  Columns outside [0, n) are zero (zero-Dirichlet ends).
//
// One thread owns one block column k, so thread t of a warp reads element
// (i, j) of column k0 + t: every operator stream is read coalesced.  Each
// kernel is memory-bound (a few FLOPs per byte); the design keeps every
// operator element read from device memory exactly once per launch.
//
// Arithmetic order follows the plain PyTorch versions in
// ops/kernels/block_kernels.py: block contractions sum over j in ascending
// order, and the off-diagonal term is formed as (lower + upper).  In K1-K5
// FMA contraction is allowed, so results agree with the plain versions to a
// few float32 ulps, not bit for bit; K6, K12, K13 and K14 round every
// operation on their own and equal their plain versions bit for bit.
//
// Host entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() after the launch; -1 means an unsupported block size,
// -2 more sweeps than kMaxSweeps, -3 a shard or ghost width the edge pair (or
// a shard's columns K6s) does not take.  K6 (ff_stencil_defect_kernel) takes
// float-float pairs: two (bs, n) arrays per vector; K6s is its launch on one
// shard, with the neighbours' edge columns as ghosts; K12 (ff_bt_defect_kernel) is
// the same defect on a materialised operator, per-column streams in place of the
// stencil; K13 (ff_cg_defect_kernel) the same float-float defect on a CG
// band, one thread per node.  K7 is the multisweep kernel with ghost columns
// (a shard's neighbours), K8 one A-form sweep, K4 the bandwidth yardstick that
// reads the multisweep's operands.  The sharded path's per-smoothing pair:
// pack_edges_kernel copies a shard's edge columns of x and b into the two
// messages its ring neighbours receive, and edge_pair_kernel recomputes both
// shard edges of a zero-ghost pass in one launch, reading the received
// messages where the exchange left them.  aggmg_empty launches nothing but
// an empty kernel: the launch floor those two are measured against.  The
// block contractions (bd / bp_prolong / bp_restrict _gemv_kernel, float and
// double) follow; see their section.  K14 (ff_cheb_update_kernel), one step
// of the true cycle's Chebyshev smoothing on a block-Jacobi level (K9's
// apply of S^-1 to the defect's hi part, the recurrence and the float-float
// update in one launch), closes the file's kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int BS>
__device__ __forceinline__ void load_vec(float (&v)[BS], const float* __restrict__ p,
                                         long long n, long long k) {
#pragma unroll
  for (int i = 0; i < BS; ++i) v[i] = p[i * n + k];
}

template <int BS>
__device__ __forceinline__ void load_block(float (&m)[BS][BS], const float* __restrict__ p,
                                           long long n, long long k) {
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int j = 0; j < BS; ++j) m[i][j] = p[(i * BS + j) * n + k];
}

// out[i] = sum_j m[i][j] v[j], j ascending
template <int BS>
__device__ __forceinline__ void mat(const float (&m)[BS][BS], const float (&v)[BS],
                                    float (&out)[BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    float acc = m[i][0] * v[0];
#pragma unroll
    for (int j = 1; j < BS; ++j) acc = acc + m[i][j] * v[j];
    out[i] = acc;
  }
}

// One window column of the multisweep: its ML and MU blocks, x, b and
// c = S^-1 b.  The operator streams have column stride `op_stride` and are
// read at column `op_k`, the vectors `vec_stride` and `vec_k` (they differ
// where the vector ghosts are a received message, see edge_pair_kernel).
template <int BS>
__device__ __forceinline__ void load_column(float (&m_l)[BS][BS], float (&m_u)[BS][BS],
                                            float (&xr)[BS], float (&bv)[BS], float (&c)[BS],
                                            const float* __restrict__ ml,
                                            const float* __restrict__ mu,
                                            const float* __restrict__ sinv, long long op_stride,
                                            long long op_k, const float* __restrict__ x,
                                            const float* __restrict__ b, long long vec_stride,
                                            long long vec_k) {
  load_block<BS>(m_l, ml, op_stride, op_k);
  load_block<BS>(m_u, mu, op_stride, op_k);
  load_vec<BS>(xr, x, vec_stride, vec_k);
  load_vec<BS>(bv, b, vec_stride, vec_k);
  float s[BS][BS];
  load_block<BS>(s, sinv, op_stride, op_k);
  mat<BS>(s, bv, c);
}

// A window column beyond the shard and its ghosts: the zero of the global
// Dirichlet boundary.  It is never updated.
template <int BS>
__device__ __forceinline__ void zero_column(float (&m_l)[BS][BS], float (&m_u)[BS][BS],
                                            float (&xr)[BS], float (&bv)[BS], float (&c)[BS]) {
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    xr[i] = 0.f;
    bv[i] = 0.f;
    c[i] = 0.f;
#pragma unroll
    for (int j = 0; j < BS; ++j) m_l[i][j] = m_u[i][j] = 0.f;
  }
}

// K3: y = A_D x + A_L x_{-1} + A_U x_{+1}.
// Replaces pallas_bt_matvec (agglomerationmultigrid1d_tpu/ops/pallas/block_kernels.py:130,
// body _matvec_kernel :80).  Per block column it reads (3 bs^2 + bs) floats of
// operators and x and writes bs: 224 B at bs = 4.  The x neighbours are re-read
// by the adjacent threads and come from L1/L2, not device memory.
template <int BS>
__global__ void __launch_bounds__(kThreads)
    bt_matvec_kernel(const float* __restrict__ ad, const float* __restrict__ al,
                     const float* __restrict__ au, const float* __restrict__ x,
                     float* __restrict__ y, long long n) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  float xc[BS], xm[BS], xp[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    xc[j] = x[j * n + k];
    xm[j] = k > 0 ? x[j * n + k - 1] : 0.f;
    xp[j] = k + 1 < n ? x[j * n + k + 1] : 0.f;
  }
  float m[BS][BS], d[BS], l[BS], u[BS];
  load_block<BS>(m, ad, n, k);
  mat<BS>(m, xc, d);
  load_block<BS>(m, al, n, k);
  mat<BS>(m, xm, l);
  load_block<BS>(m, au, n, k);
  mat<BS>(m, xp, u);
#pragma unroll
  for (int i = 0; i < BS; ++i) y[i * n + k] = (d[i] + l[i]) + u[i];
}

constexpr int kMaxSweeps = 8;  // MAX_SWEEPS of ops/kernels/block_kernels.py

// How x moves in each sweep of multisweep_kernel, passed by value (the
// kernel's parameter space), so a launch reads no scalar from device memory.
struct Recurrence {
  float alpha;            // damped block-Jacobi (K1/K2)
  float cd[kMaxSweeps];   // Chebyshev (K5): d = cd[s] d + cz[s] z, x += d
  float cz[kMaxSweeps];
};

// One sweep's update of a column from its neighbours' x (xm, xp): damped
// block-Jacobi, or one step of the Chebyshev recurrence (d carries over).
template <int BS, bool CHEB>
__device__ __forceinline__ void sweep_column(float (&xr)[BS], float (&d)[BS],
                                             const float (&m_l)[BS][BS],
                                             const float (&m_u)[BS][BS], const float (&c)[BS],
                                             const float (&xm)[BS], const float (&xp)[BS],
                                             const Recurrence& rec, int s, bool live) {
  float l[BS], u[BS];
  mat<BS>(m_l, xm, l);
  mat<BS>(m_u, xp, u);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    if constexpr (CHEB) {
      d[i] = rec.cd[s] * d[i] + rec.cz[s] * ((c[i] - xr[i]) - (l[i] + u[i]));
      xr[i] = xr[i] + d[i];
    } else {
      xr[i] = xr[i] + rec.alpha * ((c[i] - xr[i]) - (l[i] + u[i]));
    }
  }
}

// r = b - A_D ((x + ML x_{-1}) + MU x_{+1}) of a swept column `col` of the
// shard, written to r_out.
template <int BS>
__device__ __forceinline__ void column_residual(const float (&xr)[BS], const float (&bv)[BS],
                                                const float (&m_l)[BS][BS],
                                                const float (&m_u)[BS][BS],
                                                const float (&xm)[BS], const float (&xp)[BS],
                                                const float* __restrict__ ad,
                                                float* __restrict__ r_out, long long n,
                                                long long col) {
  float l[BS], u[BS], tt[BS], ax[BS], m[BS][BS];
  mat<BS>(m_l, xm, l);
  mat<BS>(m_u, xp, u);
#pragma unroll
  for (int i = 0; i < BS; ++i) tt[i] = (xr[i] + l[i]) + u[i];
  load_block<BS>(m, ad, n, col);
  mat<BS>(m, tt, ax);
#pragma unroll
  for (int i = 0; i < BS; ++i) r_out[i * n + col] = bv[i] - ax[i];
}

// K2 / K1: n_sweeps damped block-Jacobi sweeps in M-form, in one pass.
//   c = S^-1 b;  n_sweeps times  x <- x + alpha ((c - x) - (ML x_{-1} + MU x_{+1}))
// and with EMIT_RESIDUAL also  r = b - A_D ((x + ML x_{-1}) + MU x_{+1}).
// ML = S^-1 A_L and MU = S^-1 A_U; S^-1 must be the exact inverse of A_D.
// Replaces pallas_block_jacobi_multisweep (K2, ops/pallas/block_kernels.py:495)
// and pallas_block_jacobi_multisweep_residual (K1, :510), whose shared body is
// _wide_sweep_kernel (:257) with _center_residual (:244).
//
// K5 (CHEB): n_sweeps steps of the Chebyshev recurrence over the same
// block-Jacobi preconditioner, d = 0 at the start:
//   z = (c - x) - (ML x_{-1} + MU x_{+1});  d = cd[s] d + cz[s] z;  x += d
// with the same optional residual.  Replaces pallas_chebyshev_multisweep
// (ops/pallas/block_kernels.py:422, body _wide_cheb_kernel :325).  d lives in
// one more register vector per thread; it starts at zero across the whole
// window, and a column's d depends only on x and b within s columns of it,
// so the validity argument below holds for d as for x.
//
// Bytes per block column: K2 and K5 read (3 bs^2 + 2 bs) floats and write bs:
// 240 B at bs = 4; K1 and K5 with the residual read (4 bs^2 + 2 bs) and write
// 2 bs: 320 B.  A few FLOPs per byte, so device-memory bandwidth bounds them.
//
// Temporal blocking: a thread block of kThreads threads covers a window of
// kThreads consecutive columns, of which the centre kThreads - 2 halo are
// written (halo = n_sweeps, + 1 with the residual); neighbouring windows
// overlap by 2 halo columns.  Each thread keeps its column's ML and MU in
// registers for all sweeps and exchanges x with its neighbours through shared
// memory.  The window's outermost columns see a zero neighbour and go wrong by
// one column per sweep, which never reaches the centre.  So operators are read
// once per launch (plus the 2 halo / kThreads overlap) instead of once per sweep.
//
// K7 (g > 0): the same kernel on one shard of an element-sharded operator,
// with the neighbours' columns as ghosts.  Replaces the ghosted
// _multisweep_impl(..., ghosts=) (ops/pallas/block_kernels.py:522, body
// _wide_sweep_kernel :257) and pallas_chebyshev_multisweep(..., ghosts=)
// (:421, body _wide_cheb_kernel :325), driven by
// parallel/sharded_kernels.py:117-218.  The ghost layout is the JAX
// package's: gops (n_ops >= 3, bs, bs, 2g) holds ML, MU, S^-1 (a fourth
// stream, A_D, is not read), gvec (2, bs, 2g) x and b; in each, the left
// neighbour's last g columns and then the right neighbour's first g.  A
// window column in [-g, 0) or [n, n + g) reads its ghost column and sweeps
// like any other; beyond the ghosts the column is zero, as without them.  So
// the result is the multisweep of [left ghosts | shard | right ghosts],
// cropped to the shard, which equals the unsharded result for g >= halo.
// The window reads at most `halo` ghost columns a side: a launch moves K1/K2/
// K5's bytes plus 2 halo ghost columns, whatever g is (the TPU's 128-column
// ghosts are its tiling rule).
//
// Every launch computes the output columns [col_lo, col_hi) of the (bs, n)
// arrays x_out / r_out and leaves the others untouched: [0, n) for a whole
// pass, or a strip of edge columns recomputed in place (its inner neighbours
// are the shard's own columns).  The sharded path recomputes both edges with
// edge_pair_kernel below; the strip form stays as the public cols= of K7.
template <int BS, bool EMIT_RESIDUAL, bool CHEB>
__global__ void __launch_bounds__(kThreads)
    multisweep_kernel(const float* __restrict__ ml, const float* __restrict__ mu,
                      const float* __restrict__ sinv, const float* __restrict__ ad,
                      const float* __restrict__ x, const float* __restrict__ b,
                      const float* __restrict__ gops, const float* __restrict__ gvec, int g,
                      float* __restrict__ x_out, float* __restrict__ r_out, long long n,
                      long long col_lo, long long col_hi, int n_sweeps, int halo,
                      const Recurrence rec) {
  __shared__ float sx[BS][kThreads];
  const int t = threadIdx.x;
  const long long col = col_lo + (long long)blockIdx.x * (kThreads - 2 * halo) + t - halo;
  const bool inside = col >= 0 && col < n;
  const long long gcol = col < 0 ? g + col : col - n + g;  // ghost array column (outside [0, n))
  const bool ghost = !inside && gcol >= 0 && gcol < 2LL * g;
  const bool live = inside || ghost;

  float m_l[BS][BS], m_u[BS][BS], xr[BS], bv[BS], c[BS];
  if (inside) {
    load_column<BS>(m_l, m_u, xr, bv, c, ml, mu, sinv, n, col, x, b, n, col);
  } else if (ghost) {
    const long long gw = 2LL * g;
    load_column<BS>(m_l, m_u, xr, bv, c, gops, gops + BS * BS * gw, gops + 2 * BS * BS * gw, gw,
                    gcol, gvec, gvec + BS * gw, gw, gcol);
  } else {
    zero_column<BS>(m_l, m_u, xr, bv, c);
  }
#pragma unroll
  for (int i = 0; i < BS; ++i) sx[i][t] = xr[i];
  __syncthreads();

  float xm[BS], xp[BS], d[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) d[i] = 0.f;
  for (int s = 0; s < n_sweeps; ++s) {
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      xm[j] = t > 0 ? sx[j][t - 1] : 0.f;
      xp[j] = t < kThreads - 1 ? sx[j][t + 1] : 0.f;
    }
    __syncthreads();  // every neighbour read of this sweep is done
    sweep_column<BS, CHEB>(xr, d, m_l, m_u, c, xm, xp, rec, s, live);
    if (live) {
#pragma unroll
      for (int i = 0; i < BS; ++i) sx[i][t] = xr[i];
    }
    __syncthreads();
  }

  if (!inside || col >= col_hi || t < halo || t >= kThreads - halo) return;
#pragma unroll
  for (int i = 0; i < BS; ++i) x_out[i * n + col] = xr[i];
  if (EMIT_RESIDUAL) {
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      xm[j] = sx[j][t - 1];
      xp[j] = sx[j][t + 1];
    }
    column_residual<BS>(xr, bv, m_l, m_u, xm, xp, ad, r_out, n, col);
  }
}

// ---------------------------------------------------------------------------
// The sharded path's edge pair: both shard edges of a zero-ghost pass,
// recomputed in place with the neighbours' columns, in ONE launch.
//
// Replaces, on the TPU side, _strip_ghosts and _overlap_splice
// (agglomerationmultigrid1d_tpu/parallel/sharded_kernels.py:81-114) around the
// ghosted _multisweep_impl (ops/pallas/block_kernels.py:522) and
// pallas_chebyshev_multisweep (:422): there two 640-column strips are cut,
// swept with their inner columns as ghosts, and spliced back.  Here it also
// replaces two launches of multisweep_kernel with cols= (one per edge).
//
// What bounds it: a launch reads 2 (s + 2 halo) <= 54 columns and writes
// 2 s <= 18, a few kilobytes: its bytes take under a microsecond, and so does
// its arithmetic.  Launch latency and the host's time per call bound it, not
// bytes.  The design therefore removes calls and host work, not bytes:
// * one launch for both edges: block 0 is the left edge, block 1 the right.
//   Two blocks of one warp each, not one block of two warps: the sides share
//   nothing, each lands on an SM of its own, and blockIdx is the side, so no
//   code divides the block;
// * a side is one warp, one thread per window column: s = k + 1 output
//   columns and halo = k (k + 1 with the residual) on either side of them, at
//   most 9 + 2 * 9 = 27 of the 32 lanes.  x moves between neighbouring
//   columns by warp shuffles: no shared memory, no __syncthreads, no 256-wide
//   window of which 229 columns are masked;
// * the vector ghosts are read where the ring exchange left them:
//   from_left / from_right are the received messages (2, bs, g), the
//   neighbour's x and then b edge columns, so the host concatenates nothing.
//   A null message is a ring end: those columns are the zero boundary (and
//   the operator ghosts of that side are not read).  The operator ghosts
//   stay the level's gops (3, bs, bs, 2 g) in K7's layout, exchanged once;
// * the inner neighbours are the shard's own columns [s, s + halo) and
//   [n - s - halo, n - s), read in place.
//
// The arithmetic is multisweep_kernel's, through the same device functions
// (load_column, sweep_column, column_residual), in the same order on the same
// columns; a window column beyond the halo differs from multisweep_kernel's
// 256-column window, and goes wrong by one column per sweep from the window's
// inner end, which never reaches the s outputs.  Needs halo <= g and
// n >= 2 s (then every inner column lies inside the shard).
constexpr int kWarp = 32;

template <int BS, bool EMIT_RESIDUAL, bool CHEB>
__global__ void __launch_bounds__(kWarp)
    edge_pair_kernel(const float* __restrict__ ml, const float* __restrict__ mu,
                     const float* __restrict__ sinv, const float* __restrict__ ad,
                     const float* __restrict__ x, const float* __restrict__ b,
                     const float* __restrict__ gops, const float* __restrict__ from_left,
                     const float* __restrict__ from_right, int g, float* __restrict__ x_out,
                     float* __restrict__ r_out, long long n, int n_sweeps, int halo,
                     const Recurrence rec) {
  constexpr unsigned kAll = 0xffffffffu;
  const int t = threadIdx.x;
  const bool right = blockIdx.x == 1;
  const int s = n_sweeps + 1;
  // window column t is shard column w: [-halo, s + halo) on the left edge,
  // [n - s - halo, n + halo) on the right
  const long long w = (right ? n - s - halo : -(long long)halo) + t;
  const bool in_window = t < s + 2 * halo;
  const bool inside = in_window && w >= 0 && w < n;
  const float* __restrict__ msg = right ? from_right : from_left;
  const bool ghost = in_window && !inside && msg != nullptr;
  const bool live = inside || ghost;

  float m_l[BS][BS], m_u[BS][BS], xr[BS], bv[BS], c[BS];
  if (inside) {
    load_column<BS>(m_l, m_u, xr, bv, c, ml, mu, sinv, n, w, x, b, n, w);
  } else if (ghost) {
    // the message's column: the neighbour's last g columns end at -1, its first g start at n
    const long long mcol = right ? w - n : g + w;
    const long long gw = 2LL * g;
    load_column<BS>(m_l, m_u, xr, bv, c, gops, gops + BS * BS * gw, gops + 2 * BS * BS * gw, gw,
                    right ? g + mcol : mcol, msg, msg + BS * g, g, mcol);
  } else {
    zero_column<BS>(m_l, m_u, xr, bv, c);
  }

  float xm[BS], xp[BS], d[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) d[i] = 0.f;
  for (int sw = 0; sw < n_sweeps; ++sw) {
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      const float up = __shfl_up_sync(kAll, xr[j], 1);
      const float down = __shfl_down_sync(kAll, xr[j], 1);
      xm[j] = t > 0 ? up : 0.f;
      xp[j] = t < kWarp - 1 ? down : 0.f;
    }
    sweep_column<BS, CHEB>(xr, d, m_l, m_u, c, xm, xp, rec, sw, live);
  }
  if (EMIT_RESIDUAL) {  // every lane takes part in the shuffles
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      xm[j] = __shfl_up_sync(kAll, xr[j], 1);
      xp[j] = __shfl_down_sync(kAll, xr[j], 1);
    }
  }
  if (t < halo || t >= halo + s) return;
#pragma unroll
  for (int i = 0; i < BS; ++i) x_out[i * n + w] = xr[i];
  if (EMIT_RESIDUAL) column_residual<BS>(xr, bv, m_l, m_u, xm, xp, ad, r_out, n, w);
}

// The send side of the edge pair: the first g columns of x and of b into
// to_left (2, bs, g), the last g into to_right, in one launch (in place of
// two stacks over four slices).  A null message is a side without a
// neighbour and is skipped.  At most 2 * 2 * 9 * 9 = 324 floats: one block,
// bound by launch latency like the edge pair.
constexpr int kPackThreads = 128;

template <int BS>
__global__ void __launch_bounds__(kPackThreads)
    pack_edges_kernel(const float* __restrict__ x, const float* __restrict__ b,
                      float* __restrict__ to_left, float* __restrict__ to_right, int g,
                      long long n) {
  const int per = 2 * BS * g;  // floats of one message
  for (int e = threadIdx.x; e < 2 * per; e += kPackThreads) {
    const bool right = e >= per;
    float* __restrict__ dst = right ? to_right : to_left;
    if (dst == nullptr) continue;
    const int m = right ? e - per : e;  // (vector, row, column) of the message
    const int c = m % g, i = (m / g) % BS;
    const float* __restrict__ src = m < BS * g ? x : b;
    dst[m] = src[i * n + (right ? n - g + c : c)];
  }
}

// Nothing: what a launch through this file's route costs at the least.
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// K6: the float-float stencil defect r = b - A x of the true-precision cycle.
//
// Replaces pallas_ff_stencil_mid_defect
// (agglomerationmultigrid1d_tpu/ops/pallas/block_kernels.py:621, body
// _ff_stencil_defect_kernel :595) together with the caller's boundary splice
// (agglomerationmultigrid1d_tpu/ops/df64.py:352-372, ff_bt_defect_stencil).
// Every vector is a float-float pair (hi, lo) of (bs, n) float32 arrays; the
// operator is a stencil: one (bs, bs) hi/lo block per diagonal for every
// column, except the first and last bw columns, which have blocks of their
// own.  `blocks` packs them as (2, 3, bs, bs, 2 bw + 1): hi / lo, then diag /
// lower / upper, then the bw left columns, the mid column, the bw right ones.
//
// Arithmetic: the error-free transformations of ops/df64.py (Knuth's
// two_sum, Dekker's two_prod with 12-bit splitting), in the JAX package's
// order: acc = b; for each diagonal (diag on x, lower on x_{-1}, upper on
// x_{+1}) and each block column j ascending, t = ff_mul(A[:, j], v[j]),
// acc = ff_add(acc, -t).  The EFTs assume every operation rounds once, so
// every product and sum is an explicit __fmul_rn / __fadd_rn / __fsub_rn,
// which nvcc never contracts into an FMA (the file's -O3 and default --fmad
// stay as they are for K1-K5).  The result equals the plain torch chain
// (ops/kernels/block_kernels.py: ff_stencil_mid_defect_plain: the interior
// pass with the mid blocks, then the two boundary windows spliced in) bit
// for bit: a boundary column's window defect reads the same neighbours, with
// the same zero outside [0, n), as this kernel does.
//
// K6s, the same kernel on one shard of an element-sharded vector: the
// shard's columns are global columns [col0, col0 + n) of n_total, so a
// column's stencil is chosen from its global index, and its neighbours past
// the shard's two ends are the ghost columns gl / gr, each (2, bs): the hi
// then the lo parts of the neighbouring rank's edge column of x (a null
// pointer is a ring end, read as zero).  The whole-array launch is the case
// col0 = 0, n_total = n, no ghosts; a shard's columns take exactly the
// arithmetic of the same columns of the whole array, so four stitched shards
// equal the whole launch bit for bit.
//
// Cost per block column: 24 bs bytes (x and b pairs in, r pair out: 2.4 GB
// per launch at the 1e8-DoF north star, bs = 2) and about 35 float32
// operations per block entry, 105 bs^2 per column, none of which may fuse:
// at bs = 2 the two bounds are of the same order on an H100 (~0.7 ms of
// bytes, ~0.6 ms of non-FMA issue).  Design: one thread per block column,
// coalesced reads of the column and its two neighbours (the neighbours come
// from L1), the stencil's blocks read through the read-only cache (every
// interior thread reads the same mid block, a broadcast), and the split of
// each x value made once per column and reused by all bs rows.
namespace eft {

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = __fmul_rn(4097.0f, a);  // 2^12 + 1
  hi = __fsub_rn(t, __fsub_rn(t, a));
  lo = __fsub_rn(a, hi);
}

// acc <- ff_add(acc, -ff_mul((a_hi, a_lo), (v_hi, v_lo))); (vh, vl) is the split of v_hi.
__device__ __forceinline__ void sub_product(float& acc_hi, float& acc_lo, float a_hi, float a_lo,
                                            float v_hi, float v_lo, float vh, float vl) {
  // ff_mul: Dekker's two_prod of the hi parts, then the cross terms
  const float p = __fmul_rn(a_hi, v_hi);
  float ah, al;
  split(a_hi, ah, al);
  float e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, vh), p), __fmul_rn(ah, vl)),
                                __fmul_rn(al, vh)),
                      __fmul_rn(al, vl));
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(a_hi, v_lo), __fmul_rn(a_lo, v_hi)));
  float t_hi, t_lo;
  quick_two_sum(p, e, t_hi, t_lo);
  // ff_add(acc, ff_neg(t)), the "sloppy" add
  float s, f;
  two_sum(acc_hi, -t_hi, s, f);
  f = __fadd_rn(f, __fadd_rn(acc_lo, -t_lo));
  quick_two_sum(s, f, acc_hi, acc_lo);
}

}  // namespace eft

// The vectors of a float-float defect: x and b in, r out, each a (hi, lo)
// pair of (bs, n) float32 arrays; entry i of column k of array a at
// [i * si[a] + k * sn[a]], the arrays in the order x_hi, x_lo, b_hi, b_lo,
// r_hi, r_lo.
struct FFVectors {
  const float* in[4];  // x_hi, x_lo, b_hi, b_lo
  float* out[2];       // r_hi, r_lo
  long long si[6], sn[6];
};

// The float-float defect of block column k, the body of K6 and K12: acc = b,
// then for each diagonal d (diag on x_k, lower on x_{k-1}, upper on
// x_{k+1}) and each block column j ascending, acc_i <- ff_add(acc_i,
// -ff_mul(A_d[i, j], v_j)) for every row i; r = acc.  entry(d, i, j, a_hi,
// a_lo) reads the operator's hi and lo entry.  A neighbour past the array's
// ends is the ghost gl / gr ((2, bs): hi, then lo) or, where that is null,
// zero, and the arithmetic runs on it all the same, as the plain chain's
// zero-padded shift does (signed zeros included).  The split of each x
// value is made once per diagonal and reused by all bs rows.
template <int BS, typename Entry>
__device__ __forceinline__ void ff_defect_column(const Entry& entry, const FFVectors& v, long long n,
                                                 long long k, const float* __restrict__ gl,
                                                 const float* __restrict__ gr) {
  const auto at = [&](int a, int i, long long c) { return i * v.si[a] + c * v.sn[a]; };
  float acc_hi[BS], acc_lo[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    acc_hi[i] = __ldg(v.in[2] + at(2, i, k));
    acc_lo[i] = __ldg(v.in[3] + at(3, i, k));
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {  // diag on x_k, lower on x_{k-1}, upper on x_{k+1}
    const long long kk = d == 0 ? k : (d == 1 ? k - 1 : k + 1);
    // past the array's ends: the neighbour's edge column, or zero at a ring end
    const float* ghost = kk < 0 ? gl : (kk >= n ? gr : nullptr);
    const bool in = kk >= 0 && kk < n;
    float v_hi[BS], v_lo[BS], vh[BS], vl[BS];
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      v_hi[j] = in ? __ldg(v.in[0] + at(0, j, kk)) : (ghost != nullptr ? ghost[j] : 0.f);
      v_lo[j] = in ? __ldg(v.in[1] + at(1, j, kk)) : (ghost != nullptr ? ghost[BS + j] : 0.f);
      eft::split(v_hi[j], vh[j], vl[j]);
    }
#pragma unroll
    for (int j = 0; j < BS; ++j) {
#pragma unroll
      for (int i = 0; i < BS; ++i) {
        float a_hi, a_lo;
        entry(d, i, j, a_hi, a_lo);
        eft::sub_product(acc_hi[i], acc_lo[i], a_hi, a_lo, v_hi[j], v_lo[j], vh[j], vl[j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    v.out[0][at(4, i, k)] = acc_hi[i];
    v.out[1][at(5, i, k)] = acc_lo[i];
  }
}

template <int BS>
__global__ void __launch_bounds__(kThreads)
    ff_stencil_defect_kernel(const float* __restrict__ blocks, int bw,
                             const float* __restrict__ x_hi, const float* __restrict__ x_lo,
                             const float* __restrict__ b_hi, const float* __restrict__ b_lo,
                             float* __restrict__ r_hi, float* __restrict__ r_lo, long long n,
                             long long col0, long long n_total, const float* __restrict__ gl,
                             const float* __restrict__ gr) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const int width = 2 * bw + 1;
  // the stencil column of global block column kg: a boundary column's own, else the mid
  const long long kg = col0 + k;
  const int c = kg < bw ? (int)kg : (kg >= n_total - bw ? (int)(kg - (n_total - bw)) + bw + 1 : bw);
  const FFVectors v = {{x_hi, x_lo, b_hi, b_lo}, {r_hi, r_lo}, {n, n, n, n, n, n}, {1, 1, 1, 1, 1, 1}};
  ff_defect_column<BS>(
      [&](int d, int i, int j, float& a_hi, float& a_lo) {
        const int e = ((d * BS + i) * BS + j) * width + c;  // hi block entry (i, j)
        a_hi = __ldg(blocks + e);
        a_lo = __ldg(blocks + e + 3 * BS * BS * width);
      },
      v, n, k, gl, gr);
}

// ---------------------------------------------------------------------------
// K12: the float-float defect r = b - A x of a materialised block-tridiagonal
// operator (ops.df64.BlockTridiagFF), whose blocks differ from column to
// column: the agglomerated levels of the true-precision cycle, where every
// sweep's residual is this defect.
//
// Replaces no Pallas kernel: the JAX package's ff_bt_defect
// (agglomerationmultigrid1d_tpu/ops/df64.py:197) is plain jnp, which XLA
// fuses; in plain torch the chain is ~40 launches per block entry (~238 at
// bs = 2), each streaming (bs, n) temporaries.  The arithmetic is K6's
// (ff_defect_column), in the same order, with the operator's entry (i, j) of
// diagonal d at column k read from its own streams: p[d] (hi) and p[3 + d]
// (lo) for d = diag, lower, upper, each (bs, bs, n) at its element strides
// (si, sj, sn).  So it equals the plain chain (ops/kernels/block_kernels.py:
// ff_bt_defect_plain) bit for bit.  The vectors come at their own strides
// too (a CG-topped chain's agglomerated levels hold them column-major, as
// the seam transfer leaves them), so none is copied.  Ghost columns gl / gr
// as in K6s: the neighbours' edge columns of a shard, null for zeros.
//
// Cost per block column: 24 bs^2 + 24 bs bytes (the six operator streams;
// the x and b pairs in, the r pair out: 144 B at bs = 2, 1.81 GB at the
// north star's level 1, 0.54 ms at 3.35 TB/s) against 105 bs^2 float32
// operations that may not fuse (~0.16 ms of instruction throughput there): bytes-bound.
// Design: one thread per block column, so each operator stream, x, b and r
// are read or written once and coalesced across a warp; the neighbours
// x_{k+-1} are the adjacent threads' columns, served by L1; the operator
// goes through the read-only path.
struct FFStreams {
  const float* p[6];  // hi diag, lower, upper, then lo diag, lower, upper
  long long si[6], sj[6], sn[6];
};

template <int BS>
__global__ void __launch_bounds__(kThreads)
    ff_bt_defect_kernel(const FFStreams a, const FFVectors v, long long n,
                        const float* __restrict__ gl, const float* __restrict__ gr) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  ff_defect_column<BS>(
      [&](int d, int i, int j, float& a_hi, float& a_lo) {
        a_hi = __ldg(a.p[d] + i * a.si[d] + j * a.sj[d] + k * a.sn[d]);
        a_lo = __ldg(a.p[3 + d] + i * a.si[3 + d] + j * a.sj[3 + d] + k * a.sn[3 + d]);
      },
      v, n, k, gl, gr);
}

// ---------------------------------------------------------------------------
// K13: the float-float defect r = b - A x of an assembled CG band
// (ops.df64.CgBandFF): the CG levels of a CG-topped chain, where every
// sweep's residual, every level defect and the outer defect are this defect.
//
// Replaces no Pallas kernel: the JAX package's ff_cg_defect
// (agglomerationmultigrid1d_tpu/ops/df64.py) is plain jnp, which XLA fuses;
// in plain torch the chain is ~43 launches per diagonal (~730 at p = 8),
// each streaming a whole node vector.  The band is (2p + 1, n): row p + off
// holds A[i, i + off] at column i.  Arithmetic: the EFTs of K6 and K12
// (eft::sub_product), acc = b, then for off = -p .. p ascending acc <-
// ff_add(acc, -ff_mul((band_hi, band_lo)[p + off][i], x[i + off])), r = acc;
// so it equals the plain chain (ops/kernels/block_kernels.py:
// ff_cg_defect_plain) bit for bit.  A node past the array's ends is the halo
// (a shard's: the p nodes before it and the p after it, hi and lo, each
// at its stride) or, where that is null, zero; the arithmetic runs on the
// zero as the plain chain's zero fill does, signed zeros included.
//
// Cost per node: 8 (2p + 1) + 24 bytes (the band's hi and lo rows, the x
// and b pairs in, the r pair out: 160 B at p = 8, 2.68 GB at 16,777,217
// nodes, 0.80 ms at 3.35 TB/s) against 33 (2p + 1) float32 operations that
// may not fuse (~0.28 ms of instruction throughput there): bytes-bound.
// Design: one thread per node, so each band row, x, b and r is read or
// written once and coalesced across a warp.  With the order P known at
// compile time (the flagship's 8, 4, 2, 1) a thread block stages its nodes'
// x window (p a side) once in shared memory, hi, lo and the split of hi, so
// each x value is split once rather than 2p + 1 times; any other order
// (P = 0, p at run time) reads its neighbours through L1 and splits them
// where it uses them, the same values.
struct CgBand {
  const float* hi;  // (2p + 1, n) at element strides (sr, sn)
  const float* lo;
  long long sr[2], sn[2];
};

// The p nodes past each end of a shard, hi and lo at their element strides;
// a null pointer reads zero.
struct CgHalo {
  const float* left[2];  // hi, lo
  const float* right[2];
  long long sl[2], sr[2];
};

// Node j of x (hi and lo): x itself on [0, n), the halo or zero past its ends
// (no thread reads past p a side).
__device__ __forceinline__ void cg_node(const FFVectors& v, const CgHalo& h, long long n, int p,
                                        long long j, float& hi, float& lo) {
  if (j >= 0 && j < n) {
    hi = __ldg(v.in[0] + j * v.sn[0]);
    lo = __ldg(v.in[1] + j * v.sn[1]);
  } else if (j < 0) {
    const long long t = p + j;
    hi = h.left[0] != nullptr ? h.left[0][t * h.sl[0]] : 0.f;
    lo = h.left[1] != nullptr ? h.left[1][t * h.sl[1]] : 0.f;
  } else {
    const long long t = j - n;
    hi = h.right[0] != nullptr && t < p ? h.right[0][t * h.sr[0]] : 0.f;
    lo = h.right[1] != nullptr && t < p ? h.right[1][t * h.sr[1]] : 0.f;
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
    ff_cg_defect_kernel(const CgBand a, const FFVectors v, const CgHalo h, long long n, int p) {
  const long long base = (long long)blockIdx.x * kThreads;
  const long long k = base + threadIdx.x;
  const auto band = [&](int o, float& a_hi, float& a_lo) {  // row o = off + p at node k
    a_hi = __ldg(a.hi + o * a.sr[0] + k * a.sn[0]);
    a_lo = __ldg(a.lo + o * a.sr[1] + k * a.sn[1]);
  };
  float acc_hi, acc_lo, a_hi, a_lo;
  if constexpr (P > 0) {
    // x's window of this block, nodes [base - P, base + kThreads + P): hi, lo and hi's split
    __shared__ float win[4][kThreads + 2 * P];
    for (int t = threadIdx.x; t < kThreads + 2 * P; t += kThreads) {
      cg_node(v, h, n, P, base - P + t, win[0][t], win[1][t]);
      eft::split(win[0][t], win[2][t], win[3][t]);
    }
    __syncthreads();
    if (k >= n) return;
    acc_hi = __ldg(v.in[2] + k * v.sn[2]);
    acc_lo = __ldg(v.in[3] + k * v.sn[3]);
#pragma unroll
    for (int o = 0; o <= 2 * P; ++o) {
      const int t = threadIdx.x + o;
      band(o, a_hi, a_lo);
      eft::sub_product(acc_hi, acc_lo, a_hi, a_lo, win[0][t], win[1][t], win[2][t], win[3][t]);
    }
  } else {
    if (k >= n) return;
    acc_hi = __ldg(v.in[2] + k * v.sn[2]);
    acc_lo = __ldg(v.in[3] + k * v.sn[3]);
    for (int o = 0; o <= 2 * p; ++o) {
      float x_hi, x_lo, xh, xl;
      cg_node(v, h, n, p, k - p + o, x_hi, x_lo);
      eft::split(x_hi, xh, xl);
      band(o, a_hi, a_lo);
      eft::sub_product(acc_hi, acc_lo, a_hi, a_lo, x_hi, x_lo, xh, xl);
    }
  }
  v.out[0][k * v.sn[4]] = acc_hi;
  v.out[1][k * v.sn[5]] = acc_lo;
}

template <int P>
void launch_ff_cg(const CgBand& a, const FFVectors& v, const CgHalo& h, long long n, int p,
                  cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  ff_cg_defect_kernel<P><<<grid, kThreads, 0, stream>>>(a, v, h, n, p);
}

template <int BS>
void launch_ff_stencil(const float* blocks, int bw, const float* x_hi, const float* x_lo,
                       const float* b_hi, const float* b_lo, float* r_hi, float* r_lo,
                       long long n, long long col0, long long n_total, const float* gl,
                       const float* gr, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  ff_stencil_defect_kernel<BS><<<grid, kThreads, 0, stream>>>(blocks, bw, x_hi, x_lo, b_hi, b_lo,
                                                              r_hi, r_lo, n, col0, n_total, gl, gr);
}

template <int BS>
void launch_ff_bt(const FFStreams& a, const FFVectors& v, long long n, const float* gl,
                  const float* gr, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  ff_bt_defect_kernel<BS><<<grid, kThreads, 0, stream>>>(a, v, n, gl, gr);
}

template <int BS>
void launch_matvec(const float* ad, const float* al, const float* au, const float* x,
                   float* y, long long n, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  bt_matvec_kernel<BS><<<grid, kThreads, 0, stream>>>(ad, al, au, x, y, n);
}

template <int BS, bool CHEB>
void launch_multisweep(const float* ml, const float* mu, const float* sinv, const float* ad,
                       const float* x, const float* b, const float* gops, const float* gvec,
                       int g, float* x_out, float* r_out, long long n, long long col_lo,
                       long long col_hi, int n_sweeps, const Recurrence& rec,
                       cudaStream_t stream) {
  const int halo = n_sweeps + (r_out != nullptr ? 1 : 0);
  const long long centre = kThreads - 2 * halo;
  const unsigned grid = (unsigned)((col_hi - col_lo + centre - 1) / centre);
  if (r_out != nullptr) {
    multisweep_kernel<BS, true, CHEB><<<grid, kThreads, 0, stream>>>(
        ml, mu, sinv, ad, x, b, gops, gvec, g, x_out, r_out, n, col_lo, col_hi, n_sweeps, halo,
        rec);
  } else {
    multisweep_kernel<BS, false, CHEB><<<grid, kThreads, 0, stream>>>(
        ml, mu, sinv, ad, x, b, gops, gvec, g, x_out, r_out, n, col_lo, col_hi, n_sweeps, halo,
        rec);
  }
}

template <int BS, bool CHEB>
void launch_edge_pair(const float* ml, const float* mu, const float* sinv, const float* ad,
                      const float* x, const float* b, const float* gops, const float* from_left,
                      const float* from_right, int g, float* x_out, float* r_out, long long n,
                      int n_sweeps, const Recurrence& rec, cudaStream_t stream) {
  const int halo = n_sweeps + (r_out != nullptr ? 1 : 0);
  if (r_out != nullptr) {
    edge_pair_kernel<BS, true, CHEB><<<2, kWarp, 0, stream>>>(
        ml, mu, sinv, ad, x, b, gops, from_left, from_right, g, x_out, r_out, n, n_sweeps, halo,
        rec);
  } else {
    edge_pair_kernel<BS, false, CHEB><<<2, kWarp, 0, stream>>>(
        ml, mu, sinv, ad, x, b, gops, from_left, from_right, g, x_out, r_out, n, n_sweeps, halo,
        rec);
  }
}

template <int BS>
void launch_pack_edges(const float* x, const float* b, float* to_left, float* to_right, int g,
                       long long n, cudaStream_t stream) {
  pack_edges_kernel<BS><<<1, kPackThreads, 0, stream>>>(x, b, to_left, to_right, g, n);
}

// K8: one A-form damped block-Jacobi sweep, x + alpha S^-1 (b - A x), with
// the residual formed as ((b - A_D x) - A_L x_{-1}) - A_U x_{+1}.  Replaces
// pallas_block_jacobi_sweep (ops/pallas/block_kernels.py:103, body
// _sweep_kernel :71).  Per block column it reads four operator streams
// (A_L, A_D, A_U, S^-1), x and b, and writes x: (4 bs^2 + 2 bs + bs) floats,
// 304 B at bs = 4, so device-memory bandwidth bounds it.  One thread per
// block column, as K3; the x neighbours come from L1/L2.
template <int BS>
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ ad, const float* __restrict__ al,
                 const float* __restrict__ au, const float* __restrict__ sinv,
                 const float* __restrict__ x, const float* __restrict__ b,
                 float* __restrict__ x_out, long long n, float alpha) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  float xc[BS], xm[BS], xp[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    xc[j] = x[j * n + k];
    xm[j] = k > 0 ? x[j * n + k - 1] : 0.f;
    xp[j] = k + 1 < n ? x[j * n + k + 1] : 0.f;
  }
  float m[BS][BS], d[BS], l[BS], u[BS], r[BS], z[BS];
  load_block<BS>(m, ad, n, k);
  mat<BS>(m, xc, d);
  load_block<BS>(m, al, n, k);
  mat<BS>(m, xm, l);
  load_block<BS>(m, au, n, k);
  mat<BS>(m, xp, u);
#pragma unroll
  for (int i = 0; i < BS; ++i) r[i] = ((b[i * n + k] - d[i]) - l[i]) - u[i];
  load_block<BS>(m, sinv, n, k);
  mat<BS>(m, r, z);
#pragma unroll
  for (int i = 0; i < BS; ++i) x_out[i * n + k] = xc[i] + alpha * z[i];
}

// K4: the bandwidth yardstick of the multisweep.  Reads the multisweep's
// operands once (ML, MU, S^-1, x, b: K2's 240 B per block column at bs = 4)
// and writes one vector, one add per element read:
//   out[i] = (x[i] + b[i]) + sum over ML, MU, S^-1 in turn of sum_j M[i][j].
// Replaces bench.py:bench_stream_bw._stream_kernel (bench.py:159), which
// prices the multisweep against the achievable bandwidth of its operand mix.
// One thread per block column; nothing is re-read, so its bytes are exactly
// K2's (no halo factor: the TPU's (tile + 2 128) / tile belongs to its tiles).
template <int BS>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const float* __restrict__ ml, const float* __restrict__ mu,
                  const float* __restrict__ sinv, const float* __restrict__ x,
                  const float* __restrict__ b, float* __restrict__ out, long long n) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const float* ops[3] = {ml, mu, sinv};
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    float acc = x[i * n + k] + b[i * n + k];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int j = 0; j < BS; ++j) acc = acc + ops[s][(i * BS + j) * n + k];
    out[i * n + k] = acc;
  }
}

template <int BS>
void launch_sweep(const float* ad, const float* al, const float* au, const float* sinv,
                  const float* x, const float* b, float* x_out, long long n, float alpha,
                  cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  sweep_kernel<BS><<<grid, kThreads, 0, stream>>>(ad, al, au, sinv, x, b, x_out, n, alpha);
}

template <int BS>
void launch_stream(const float* ml, const float* mu, const float* sinv, const float* x,
                   const float* b, float* out, long long n, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  stream_kernel<BS><<<grid, kThreads, 0, stream>>>(ml, mu, sinv, x, b, out, n);
}

// The block sizes every kernel below is instantiated for (SUPPORTED_BLOCK_SIZES
// in ops/kernels/block_kernels.py); -1 for any other.
#define AGGMG_DISPATCH_BS(bs, CALL) \
  switch (bs) {                     \
    case 1: CALL(1); break;         \
    case 2: CALL(2); break;         \
    case 3: CALL(3); break;         \
    case 4: CALL(4); break;         \
    case 5: CALL(5); break;         \
    case 9: CALL(9); break;         \
    default: return -1;             \
  }

// ---------------------------------------------------------------------------
// The block contractions of the solve path: bd_gemv_kernel (every
// block-Jacobi apply, ops/block_diag.py:bd_matvec), bp_prolong_gemv_kernel
// and bp_restrict_gemv_kernel (every block-aligned transfer,
// ops/transfer_ops.py:bp_prolong / bp_restrict).  They replace no Pallas
// kernel: the JAX package leaves these jnp.einsum contractions to XLA, which
// fuses them; on the card torch.einsum handed them to the library's batched
// gemv, with a copy of the operands to (n, bs, bs) before and a permute
// after.  Each moves a few FLOPs per byte, so device-memory bandwidth bounds
// it: the blocks, the input vector and the output are each touched once.
// One thread per (coarse) block column reads the SoA streams coalesced; no
// copy is made, the prolongation stores its r fine columns in fine order (the
// permute folded into the store, one vector store per row for r = 2 and 4)
// and the restriction reads them (across a warp the r offsets' loads cover
// one contiguous run, served by L1).
//
// Rounding: every output entry as the library's batched gemv rounds it at
// the cells' shapes (measured on the card for K = 1-4,
// tools/gemv_rounding_order.py; K = 5 and 9 take the same rule, unmeasured):
// the contracted index split in halves j < H and j >= H, H = ceil(K / 2),
// each half m_first v_first then fma(m_j, v_j, acc) ascending, the halves
// added: K = 2 gives m_0 v_0 + m_1 v_1 (both products rounded), K = 4
// fma(m_1, v_1, m_0 v_0) + fma(m_3, v_3, m_2 v_2).  The restriction adds its
// r offsets' contractions in ascending j with rounded adds, as
// ops/transfer_ops.py did.  Explicit intrinsics, so the compiler
// fuses nothing else.  Templated on the block sizes of the other kernels
// (AGGMG_DISPATCH_BS: the apply's bs, each transfer's bs_f and bs_c) and on
// float / double; operands at any element strides (an expanded r = 1
// prolongation has column stride 0), outputs contiguous.

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// m[0] v[0] rounded, then one fma per further term, ascending (N terms)
template <int N, typename T>
__device__ __forceinline__ T fma_chain(const T* __restrict__ m, long long stride, const T* v) {
  T acc = mul_rn(m[0], v[0]);
#pragma unroll
  for (int j = 1; j < N; ++j) acc = fma_rn(m[j * stride], v[j], acc);
  return acc;
}

// sum_j m[j * stride] v[j], j < K, in the library's order (see above): the
// halves j < H and j >= H, H = ceil(K / 2), each an fma chain, then added
template <int K, typename T>
__device__ __forceinline__ T dot_gemv(const T* __restrict__ m, long long stride, const T (&v)[K]) {
  constexpr int H = (K + 1) / 2;
  const T lo = fma_chain<H>(m, stride, v);
  if constexpr (H == K) {
    return lo;
  } else {
    return add_rn(lo, fma_chain<K - H>(m + H * stride, stride, v + H));
  }
}

// y[i, k] = sum_j blocks[i, j, k] x[j, k]; blocks' strides (s_i, s_j, s_n),
// x's (x_i, x_n); y (BS, n) contiguous.
template <int BS, typename T>
__global__ void __launch_bounds__(kThreads)
    bd_gemv_kernel(const T* __restrict__ blocks, long long s_i, long long s_j, long long s_n,
                   const T* __restrict__ x, long long x_i, long long x_n, T* __restrict__ y,
                   long long n) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  T v[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j) v[j] = x[j * x_i + k * x_n];
  const T* m = blocks + k * s_n;
#pragma unroll
  for (int i = 0; i < BS; ++i) y[i * n + k] = dot_gemv<BS>(m + i * s_i, s_j, v);
}

// A thread's R consecutive outputs of one row as aligned vector stores.
__device__ __forceinline__ void store_run(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_run(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_run(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store_run(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// Fine column r c + j of y (BSF, r n_c) is blocks[j, :, :, c] @ xc[:, c];
// blocks (r, BSF, BSC, n_c) at strides (s_j, s_i, s_b, s_c), xc at (x_b, x_c).
// R = r in {2, 4}: a row's R fine columns leave as one vector store, so a
// warp writes each row in one contiguous run (scalar stores r apart cost r
// times the store transactions); y's rows are then aligned to R elements
// (n_f = R n_c, and y is a fresh allocation).  R = 0: any r, scalar stores.
template <int BSF, int BSC, int R, typename T>
__global__ void __launch_bounds__(kThreads)
    bp_prolong_gemv_kernel(const T* __restrict__ blocks, long long s_j, long long s_i,
                           long long s_b, long long s_c, const T* __restrict__ xc, long long x_b,
                           long long x_c, T* __restrict__ y, int r, long long n_c) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_c) return;
  T v[BSC];
#pragma unroll
  for (int b = 0; b < BSC; ++b) v[b] = xc[b * x_b + c * x_c];
  const long long n_f = (long long)r * n_c;
  if constexpr (R == 0) {
    for (int j = 0; j < r; ++j) {
      const T* m = blocks + j * s_j + c * s_c;
#pragma unroll
      for (int i = 0; i < BSF; ++i) y[i * n_f + r * c + j] = dot_gemv<BSC>(m + i * s_i, s_b, v);
    }
  } else {
    T out[BSF][R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const T* m = blocks + j * s_j + c * s_c;
#pragma unroll
      for (int i = 0; i < BSF; ++i) out[i][j] = dot_gemv<BSC>(m + i * s_i, s_b, v);
    }
#pragma unroll
    for (int i = 0; i < BSF; ++i) store_run(y + i * n_f + R * c, out[i]);
  }
}

// out[b, c] = sum over j ascending of (sum_i blocks[j, i, b, c] rf[i, r c + j]);
// blocks as for the prolongation, rf (BSF, r n_c) at (f_i, f_n), out (BSC, n_c).
template <int BSF, int BSC, typename T>
__global__ void __launch_bounds__(kThreads)
    bp_restrict_gemv_kernel(const T* __restrict__ blocks, long long s_j, long long s_i,
                            long long s_b, long long s_c, const T* __restrict__ rf,
                            long long f_i, long long f_n, T* __restrict__ out, int r,
                            long long n_c) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_c) return;
  T acc[BSC];
  for (int j = 0; j < r; ++j) {
    T v[BSF];
#pragma unroll
    for (int i = 0; i < BSF; ++i) v[i] = rf[i * f_i + (r * c + j) * f_n];
    const T* m = blocks + j * s_j + c * s_c;
#pragma unroll
    for (int b = 0; b < BSC; ++b) {
      const T t = dot_gemv<BSF>(m + b * s_b, s_i, v);
      acc[b] = j == 0 ? t : add_rn(acc[b], t);
    }
  }
#pragma unroll
  for (int b = 0; b < BSC; ++b) out[b * n_c + c] = acc[b];
}

template <int BS, typename T>
void launch_bd_gemv(const void* blocks, long long s_i, long long s_j, long long s_n,
                    const void* x, long long x_i, long long x_n, void* y, long long n,
                    cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  bd_gemv_kernel<BS, T><<<grid, kThreads, 0, stream>>>((const T*)blocks, s_i, s_j, s_n,
                                                       (const T*)x, x_i, x_n, (T*)y, n);
}

template <int BSF, int BSC, typename T>
void launch_bp_gemv(bool restrict_, const void* blocks, long long s_j, long long s_i,
                    long long s_b, long long s_c, const void* v, long long v_0, long long v_1,
                    void* out, int r, long long n_c, cudaStream_t stream) {
  const unsigned grid = (unsigned)((n_c + kThreads - 1) / kThreads);
#define AGGMG_PROLONG(R)                                                        \
  bp_prolong_gemv_kernel<BSF, BSC, R, T><<<grid, kThreads, 0, stream>>>(        \
      (const T*)blocks, s_j, s_i, s_b, s_c, (const T*)v, v_0, v_1, (T*)out, r, n_c)
  if (restrict_) {
    bp_restrict_gemv_kernel<BSF, BSC, T><<<grid, kThreads, 0, stream>>>(
        (const T*)blocks, s_j, s_i, s_b, s_c, (const T*)v, v_0, v_1, (T*)out, r, n_c);
  } else if (r == 4) {
    AGGMG_PROLONG(4);
  } else if (r == 2) {
    AGGMG_PROLONG(2);
  } else {
    AGGMG_PROLONG(0);
  }
#undef AGGMG_PROLONG
}

// Every pair (bs_f, bs_c) of the block sizes AGGMG_DISPATCH_BS has.
template <int BSF, typename T>
int dispatch_bp_gemv_c(bool restrict_, int bs_c, const void* blocks, long long s_j, long long s_i,
                       long long s_b, long long s_c, const void* v, long long v_0, long long v_1,
                       void* out, int r, long long n_c, cudaStream_t stream) {
#define AGGMG_CALL(C) \
  launch_bp_gemv<BSF, C, T>(restrict_, blocks, s_j, s_i, s_b, s_c, v, v_0, v_1, out, r, n_c, stream)
  AGGMG_DISPATCH_BS(bs_c, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bp_gemv(bool restrict_, int bs_f, int bs_c, const void* blocks, long long s_j,
                     long long s_i, long long s_b, long long s_c, const void* v, long long v_0,
                     long long v_1, void* out, int r, long long n_c, cudaStream_t stream) {
#define AGGMG_CALL(F)                                                                          \
  return dispatch_bp_gemv_c<F, T>(restrict_, bs_c, blocks, s_j, s_i, s_b, s_c, v, v_0, v_1, out, \
                                  r, n_c, stream)
  AGGMG_DISPATCH_BS(bs_f, AGGMG_CALL)
#undef AGGMG_CALL
  return -1;  // not reached: every case returns
}

// ---------------------------------------------------------------------------
// K14: one step of the true cycle's Chebyshev smoothing on a block-Jacobi
// level (models/solvers.py: _smooth_true), after the step's float-float
// defect (K6 or K12) has given r_hi:
//
//   z = S^-1 r_hi                 (dot_gemv: K9's rounding)
//   d = z / theta                 (the first step)
//   d = c_d d + c_z z             (the later steps: two rounded products, one rounded add)
//   u = ff_add(u, (d, 0))         (two_sum(u_hi, d), e + (u_lo + 0), quick_two_sum)
//
// Replaces no Pallas kernel: the JAX package's _chebyshev over an ff_add
// update is plain jnp, which XLA fuses; in plain torch a step is K9 and
// ~20 elementwise launches (the scale by 1, the recurrence on 0-d tensors,
// the division or the two products and their add, a zeros_like, ff_add's
// 11), each streaming (bs, n) temporaries.  Every operation is an explicit
// __fmul_rn / __fadd_rn / __fdiv_rn in the plain chain's order, so the step
// equals it bit for bit (ops/kernels/block_kernels.py: ff_cheb_update_plain):
// the division is a true one, as the card's torch divides by the level's
// 0-d interval tensors, and u_lo + 0 turns a -0 tail into +0, as the
// chain's zero lo part does.  c_d, c_z and theta come by value, host floats
// from the level's recurrence table.
//
// Cost per block column: 4 bs^2 + 4 bs bytes of S^-1 and r_hi, u's pair in
// and out (16 bs), d in (4 bs, not in the first step) and out (4 bs, not in
// the last): 64 / 72 / 64 B at bs = 2 for the first, middle and last step,
// 3.2-3.6 GB at the north star's level 0 (~1 ms at 3.35 TB/s), against ~2
// bs^2 + 12 bs float32 operations: bytes-bound.  Design: one thread per
// block column, every stream read and written once and coalesced across a
// warp, S^-1 through the read-only path; operands at their element strides
// (a CG-topped chain's agglomerated levels hold their vectors column-major).
struct ChebStep {
  const float* sinv;  // (bs, bs, n) at strides (si, sj, sn)
  long long si, sj, sn;
  // r_hi, d_in (null on the first step), u_hi, u_lo, then the outputs
  // d_out (null on the last step), u_hi, u_lo; each (bs, n) at strides (vi, vn)
  const float* in[4];
  float* out[3];
  long long vi[7], vn[7];
};

template <int BS>
__global__ void __launch_bounds__(kThreads)
    ff_cheb_update_kernel(const ChebStep a, long long n, float theta, float c_d, float c_z) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const auto at = [&](int t, int i) { return i * a.vi[t] + k * a.vn[t]; };
  float r[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j) r[j] = __ldg(a.in[0] + at(0, j));
  const float* m = a.sinv + k * a.sn;
#pragma unroll
  for (int i = 0; i < BS; ++i) {
    const float z = dot_gemv<BS>(m + i * a.si, a.sj, r);
    const float d = a.in[1] == nullptr
                        ? __fdiv_rn(z, theta)
                        : __fadd_rn(__fmul_rn(c_d, __ldg(a.in[1] + at(1, i))), __fmul_rn(c_z, z));
    if (a.out[0] != nullptr) a.out[0][at(4, i)] = d;
    float s, e, hi, lo;
    eft::two_sum(__ldg(a.in[2] + at(2, i)), d, s, e);
    e = __fadd_rn(e, __fadd_rn(__ldg(a.in[3] + at(3, i)), 0.0f));
    eft::quick_two_sum(s, e, hi, lo);
    a.out[1][at(5, i)] = hi;
    a.out[2][at(6, i)] = lo;
  }
}

template <int BS>
void launch_ff_cheb_update(const ChebStep& a, long long n, float theta, float c_d, float c_z,
                           cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  ff_cheb_update_kernel<BS><<<grid, kThreads, 0, stream>>>(a, n, theta, c_d, c_z);
}

}  // namespace

extern "C" {

int aggmg_bt_matvec(int bs, const void* ad, const void* al, const void* au, const void* x,
                    void* y, long long n, void* stream) {
#define AGGMG_CALL(BS)                                                                  \
  launch_matvec<BS>((const float*)ad, (const float*)al, (const float*)au, (const float*)x, \
                    (float*)y, n, (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// ad and r_out are null for K2 (no residual) and both set for K1; gops and
// gvec are null with g = 0 for K1/K2, set with the ghost width g for K7; the
// launch writes the output columns [col_lo, col_hi), 0 <= col_lo < col_hi <= n.
int aggmg_multisweep(int bs, const void* ml, const void* mu, const void* sinv, const void* ad,
                     const void* x, const void* b, const void* gops, const void* gvec, int g,
                     void* x_out, void* r_out, long long n, long long col_lo, long long col_hi,
                     int n_sweeps, float alpha, void* stream) {
  if (n_sweeps < 0 || n_sweeps > kMaxSweeps) return -2;
  Recurrence rec = {};
  rec.alpha = alpha;
#define AGGMG_CALL(BS)                                                                        \
  launch_multisweep<BS, false>((const float*)ml, (const float*)mu, (const float*)sinv,         \
                               (const float*)ad, (const float*)x, (const float*)b,             \
                               (const float*)gops, (const float*)gvec, g, (float*)x_out,       \
                               (float*)r_out, n, col_lo, col_hi, n_sweeps, rec,                \
                               (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// K5.  coef is a HOST array of 2 n_steps floats (cd_0, cz_0, cd_1, cz_1, ...),
// copied into the kernel's parameters; ad, r_out and the ghosts (K7) as for
// aggmg_multisweep.
int aggmg_chebyshev(int bs, const void* ml, const void* mu, const void* sinv, const void* ad,
                    const void* x, const void* b, const void* gops, const void* gvec, int g,
                    void* x_out, void* r_out, long long n, long long col_lo, long long col_hi,
                    int n_steps, const void* coef, void* stream) {
  if (n_steps < 0 || n_steps > kMaxSweeps) return -2;
  Recurrence rec = {};
  for (int s = 0; s < n_steps; ++s) {
    rec.cd[s] = ((const float*)coef)[2 * s];
    rec.cz[s] = ((const float*)coef)[2 * s + 1];
  }
#define AGGMG_CALL(BS)                                                                       \
  launch_multisweep<BS, true>((const float*)ml, (const float*)mu, (const float*)sinv,         \
                              (const float*)ad, (const float*)x, (const float*)b,             \
                              (const float*)gops, (const float*)gvec, g, (float*)x_out,       \
                              (float*)r_out, n, col_lo, col_hi, n_steps, rec,                 \
                              (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// The edge pair, damped.  from_left / from_right are the received messages
// (2, bs, g) or null at a ring end; ad and r_out are null without the
// residual.  Writes columns [0, s) and [n - s, n), s = n_sweeps + 1.
static int edge_pair_refused(int n_steps, bool residual, int g, long long n) {
  if (n_steps < 0 || n_steps > kMaxSweeps) return -2;
  if (n_steps + (residual ? 1 : 0) > g || n < 2LL * (n_steps + 1)) return -3;
  return 0;
}

int aggmg_edge_pair(int bs, const void* ml, const void* mu, const void* sinv, const void* ad,
                    const void* x, const void* b, const void* gops, const void* from_left,
                    const void* from_right, int g, void* x_out, void* r_out, long long n,
                    int n_sweeps, float alpha, void* stream) {
  if (const int rc = edge_pair_refused(n_sweeps, r_out != nullptr, g, n)) return rc;
  Recurrence rec = {};
  rec.alpha = alpha;
#define AGGMG_CALL(BS)                                                                         \
  launch_edge_pair<BS, false>((const float*)ml, (const float*)mu, (const float*)sinv,           \
                              (const float*)ad, (const float*)x, (const float*)b,               \
                              (const float*)gops, (const float*)from_left,                      \
                              (const float*)from_right, g, (float*)x_out, (float*)r_out, n,     \
                              n_sweeps, rec, (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// The edge pair, Chebyshev; coef as for aggmg_chebyshev.
int aggmg_edge_pair_chebyshev(int bs, const void* ml, const void* mu, const void* sinv,
                              const void* ad, const void* x, const void* b, const void* gops,
                              const void* from_left, const void* from_right, int g, void* x_out,
                              void* r_out, long long n, int n_steps, const void* coef,
                              void* stream) {
  if (const int rc = edge_pair_refused(n_steps, r_out != nullptr, g, n)) return rc;
  Recurrence rec = {};
  for (int s = 0; s < n_steps; ++s) {
    rec.cd[s] = ((const float*)coef)[2 * s];
    rec.cz[s] = ((const float*)coef)[2 * s + 1];
  }
#define AGGMG_CALL(BS)                                                                        \
  launch_edge_pair<BS, true>((const float*)ml, (const float*)mu, (const float*)sinv,           \
                             (const float*)ad, (const float*)x, (const float*)b,               \
                             (const float*)gops, (const float*)from_left,                      \
                             (const float*)from_right, g, (float*)x_out, (float*)r_out, n,     \
                             n_steps, rec, (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// The edge columns of x and b into the send messages; a null message is skipped.
int aggmg_pack_edges(int bs, const void* x, const void* b, void* to_left, void* to_right, int g,
                     long long n, void* stream) {
  if (g < 0 || n < g) return -3;
#define AGGMG_CALL(BS)                                                                    \
  launch_pack_edges<BS>((const float*)x, (const float*)b, (float*)to_left, (float*)to_right, g, \
                        n, (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// The launch floor: one empty kernel on `stream`.
int aggmg_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// K6 and K6s.  blocks is the packed stencil (2, 3, bs, bs, 2 bw + 1); the n
// columns are global columns [col0, col0 + n) of n_total, with n_total >=
// 2 bw + 2 when bw > 0 (checked by the wrapper); gl / gr are the (2, bs)
// ghost columns past the two ends, null for zeros.
int aggmg_ff_stencil_defect(int bs, const void* blocks, int bw, const void* x_hi,
                            const void* x_lo, const void* b_hi, const void* b_lo, void* r_hi,
                            void* r_lo, long long n, long long col0, long long n_total,
                            const void* gl, const void* gr, void* stream) {
  if (col0 < 0 || col0 + n > n_total) return -3;
#define AGGMG_CALL(BS)                                                                          \
  launch_ff_stencil<BS>((const float*)blocks, bw, (const float*)x_hi, (const float*)x_lo,      \
                        (const float*)b_hi, (const float*)b_lo, (float*)r_hi, (float*)r_lo, n, \
                        col0, n_total, (const float*)gl, (const float*)gr,                     \
                        (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// K12.  ptrs: the six operator streams (hi diag, lower, upper, then lo diag,
// lower, upper), each (bs, bs, n) float32, then x_hi, x_lo, b_hi, b_lo and
// the outputs r_hi, r_lo, each (bs, n); strides: the element strides of the
// same twelve arrays in turn, (i, j, n) of each stream and (i, n) of each
// vector; gl / gr the (2, bs) ghost columns past the two ends, null for
// zeros.
int aggmg_ff_bt_defect(int bs, const void* const* ptrs, const long long* strides, long long n,
                       const void* gl, const void* gr, void* stream) {
  FFStreams a;
  for (int s = 0; s < 6; ++s) {
    a.p[s] = (const float*)ptrs[s];
    a.si[s] = strides[3 * s];
    a.sj[s] = strides[3 * s + 1];
    a.sn[s] = strides[3 * s + 2];
  }
  FFVectors v;
  for (int t = 0; t < 6; ++t) {
    if (t < 4) {
      v.in[t] = (const float*)ptrs[6 + t];
    } else {
      v.out[t - 4] = (float*)ptrs[6 + t];
    }
    v.si[t] = strides[18 + 2 * t];
    v.sn[t] = strides[18 + 2 * t + 1];
  }
#define AGGMG_CALL(BS) \
  launch_ff_bt<BS>(a, v, n, (const float*)gl, (const float*)gr, (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// K13.  ptrs: the band's hi and lo parts, each (2p + 1, n) float32; x_hi,
// x_lo, b_hi, b_lo and the outputs r_hi, r_lo, each (n,); then the halo's
// left hi, lo and right hi, lo, each (p,), null for zeros.  strides: the
// element strides of the band parts (row, node), then of the six vectors,
// then of the four halo parts.  p = 1, 2, 4, 8 launch their compile-time
// instances, any other p >= 0 the run-time one.
int aggmg_ff_cg_defect(int p, const void* const* ptrs, const long long* strides, long long n,
                       void* stream) {
  if (p < 0) return -1;
  CgBand a;
  a.hi = (const float*)ptrs[0];
  a.lo = (const float*)ptrs[1];
  for (int s = 0; s < 2; ++s) {
    a.sr[s] = strides[2 * s];
    a.sn[s] = strides[2 * s + 1];
  }
  FFVectors v;
  for (int t = 0; t < 6; ++t) {
    if (t < 4) {
      v.in[t] = (const float*)ptrs[2 + t];
    } else {
      v.out[t - 4] = (float*)ptrs[2 + t];
    }
    v.si[t] = 0;
    v.sn[t] = strides[4 + t];
  }
  CgHalo h;
  for (int s = 0; s < 2; ++s) {
    h.left[s] = (const float*)ptrs[8 + s];
    h.right[s] = (const float*)ptrs[10 + s];
    h.sl[s] = strides[10 + s];
    h.sr[s] = strides[12 + s];
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (p) {
    case 1: launch_ff_cg<1>(a, v, h, n, p, st); break;
    case 2: launch_ff_cg<2>(a, v, h, n, p, st); break;
    case 4: launch_ff_cg<4>(a, v, h, n, p, st); break;
    case 8: launch_ff_cg<8>(a, v, h, n, p, st); break;
    default: launch_ff_cg<0>(a, v, h, n, p, st); break;
  }
  return (int)cudaGetLastError();
}

// K14.  ptrs: S^-1 ((bs, bs, n) float32), then r_hi, d_in (null on the first
// step), u_hi, u_lo, and the outputs d_out (null on the last step), u_hi,
// u_lo, each (bs, n); strides: S^-1's (i, j, n), then (i, n) of the seven
// vectors in turn (anything for a null one).  theta divides on the first
// step; c_d, c_z form the later steps' d.
int aggmg_ff_cheb_update(int bs, const void* const* ptrs, const long long* strides, long long n,
                         float theta, float c_d, float c_z, void* stream) {
  ChebStep a;
  a.sinv = (const float*)ptrs[0];
  a.si = strides[0];
  a.sj = strides[1];
  a.sn = strides[2];
  for (int t = 0; t < 7; ++t) {
    if (t < 4) {
      a.in[t] = (const float*)ptrs[1 + t];
    } else {
      a.out[t - 4] = (float*)ptrs[1 + t];
    }
    a.vi[t] = strides[3 + 2 * t];
    a.vn[t] = strides[3 + 2 * t + 1];
  }
#define AGGMG_CALL(BS) launch_ff_cheb_update<BS>(a, n, theta, c_d, c_z, (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// K8.
int aggmg_block_jacobi_sweep(int bs, const void* ad, const void* al, const void* au,
                             const void* sinv, const void* x, const void* b, void* x_out,
                             long long n, float alpha, void* stream) {
#define AGGMG_CALL(BS)                                                                      \
  launch_sweep<BS>((const float*)ad, (const float*)al, (const float*)au, (const float*)sinv, \
                   (const float*)x, (const float*)b, (float*)x_out, n, alpha,               \
                   (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// K4.
int aggmg_stream(int bs, const void* ml, const void* mu, const void* sinv, const void* x,
                 const void* b, void* out, long long n, void* stream) {
#define AGGMG_CALL(BS)                                                                    \
  launch_stream<BS>((const float*)ml, (const float*)mu, (const float*)sinv, (const float*)x, \
                    (const float*)b, (float*)out, n, (cudaStream_t)stream)
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// The block contractions; f64 = 0 for float, 1 for double; -1 for a block
// size without an instance.  Strides in elements.
int aggmg_bd_gemv(int f64, int bs, const void* blocks, long long s_i, long long s_j,
                  long long s_n, const void* x, long long x_i, long long x_n, void* y,
                  long long n, void* stream) {
#define AGGMG_CALL(BS)                                                                     \
  if (f64) {                                                                               \
    launch_bd_gemv<BS, double>(blocks, s_i, s_j, s_n, x, x_i, x_n, y, n,                   \
                               (cudaStream_t)stream);                                      \
  } else {                                                                                 \
    launch_bd_gemv<BS, float>(blocks, s_i, s_j, s_n, x, x_i, x_n, y, n, (cudaStream_t)stream); \
  }
  AGGMG_DISPATCH_BS(bs, AGGMG_CALL)
#undef AGGMG_CALL
  return (int)cudaGetLastError();
}

// blocks (r, bs_f, bs_c, n_c) at strides (s_j, s_i, s_b, s_c); xc (bs_c, n_c)
// at (x_b, x_c); y (bs_f, r n_c).
int aggmg_bp_prolong_gemv(int f64, int bs_f, int bs_c, const void* blocks, long long s_j,
                          long long s_i, long long s_b, long long s_c, const void* xc,
                          long long x_b, long long x_c, void* y, int r, long long n_c,
                          void* stream) {
  return f64 ? dispatch_bp_gemv<double>(false, bs_f, bs_c, blocks, s_j, s_i, s_b, s_c, xc, x_b,
                                        x_c, y, r, n_c, (cudaStream_t)stream)
             : dispatch_bp_gemv<float>(false, bs_f, bs_c, blocks, s_j, s_i, s_b, s_c, xc, x_b,
                                       x_c, y, r, n_c, (cudaStream_t)stream);
}

// blocks as for the prolongation; rf (bs_f, r n_c) at (f_i, f_n); out (bs_c, n_c).
int aggmg_bp_restrict_gemv(int f64, int bs_f, int bs_c, const void* blocks, long long s_j,
                           long long s_i, long long s_b, long long s_c, const void* rf,
                           long long f_i, long long f_n, void* out, int r, long long n_c,
                           void* stream) {
  return f64 ? dispatch_bp_gemv<double>(true, bs_f, bs_c, blocks, s_j, s_i, s_b, s_c, rf, f_i,
                                        f_n, out, r, n_c, (cudaStream_t)stream)
             : dispatch_bp_gemv<float>(true, bs_f, bs_c, blocks, s_j, s_i, s_b, s_c, rf, f_i,
                                       f_n, out, r, n_c, (cudaStream_t)stream);
}

}  // extern "C"
