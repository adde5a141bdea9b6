// Offset-stencil matvec and whole-solve stencil PCG for Hopper (sm_90a).
//
// Layouts are the natural ones of ops/stencil.py: planes W (n_off, DOUT,
// DIN, n), node vectors (n, D), block-Jacobi inverse Binv (D, D, n).  A
// neighbour is read at (i + off) mod n; planes are zero wherever a node
// has no neighbour, so wrapped reads contribute exactly 0.
//
// Halo form of stencil_apply (halo = h > 0; the node-sharded lattice,
// parallel/gspmd.py): W, b and y hold a rank's n owned rows and v holds
// them with h rows of its neighbours on either side (n + 2h rows), so
// node i reads v[i + h + off] with no wrap.  The offsets come packed as
// h + off, which must lie in [0, 2h]; the one index term that differs is
// the wrap, taken mod nv = n + 2h, which no read reaches.  h = 0 is the
// form above: nv = n and the offsets mod n.
//
// stencil_apply<DOUT, DIN, TERMS> replaces the Pallas matvecs
//   glimslib_tpu/ops/stencil_pallas.py:_scalar_kernel            (DOUT=DIN=1)
//   glimslib_tpu/ops/stencil_pallas.py:_vector_kernel_streamed   (DOUT=DIN=d,
//     and DOUT=d, DIN=1 for the growth-strain coupling planes; d = 2 on a
//     rectangle lattice, 3 on a box).
// It computes y = sum_k s_k A_k v_k (- b), TERMS operators on one offset
// set: TERMS=1 (s=1, no b) is the plain matvec; TERMS=3 at d=1 is the
// lattice rd residual W_const c + wc c / 2 - M c_prev - load in one launch.
// What bounds it: one pass over the planes (4 * n_off * DOUT * DIN bytes a
// node; 19.4 MB for the N=32 elasticity operator) and the vectors, so it
// is bandwidth-bound at 0.25 flop/byte; at N=32 the whole pass is a few
// microseconds, so the latency of a round trip to HBM counts as much.
// Design: one thread a node for all DOUT outputs, threads of a warp on
// consecutive nodes, so every plane read is coalesced.  The offset loop
// is unrolled to the lattice's 15 offsets (loads predicated on off.n):
// a thread issues all its plane and neighbour loads before the first sum,
// so a launch waits for about one round trip, not 15.  (3,3) and (2,2)
// issue them in two chunks (offsets 0-7, 8-14; the 2D lattice's 7 offsets
// all fall in the first) and are held to 128 registers, so four blocks
// fit an SM and the N=32 grid (281 blocks) runs in one wave; with all 180
// loads at once (3,3) took 217 registers and two waves, and was slower at
// N=32 on the H100.  Each neighbour's DIN components are loaded once and
// used for every output row.  DOUT > 1 outputs go through shared memory,
// so a warp stores 32*DOUT contiguous floats in DOUT coalesced stores.
// Products and sums are rounded one by one (no FMA contraction), o outer
// and b inner, as the plain torch version does them, so on the same
// inputs the two agree to the bit.  The TPU kernel's (R, 128) tiling
// and in-register lane rolls are not carried over: a CUDA thread indexes
// its neighbour directly.
//
// stencil_pcg<D> replaces the whole-solve Pallas CG kernels
//   glimslib_tpu/ops/pallas_cg.py:_cg_scalar_kernel           (D=1, Jacobi)
//   glimslib_tpu/ops/pallas_cg.py:_cg_vector_kernel           (D=2, 3, VMEM-resident)
//   glimslib_tpu/ops/pallas_cg.py:_cg_vector_streamed_kernel  (D=2, 3, streamed)
// with the update order and stopping rule of solvers/cg.py:pcg (x0 = 0;
// stop when rr <= max(rtol^2 bb, atol^2) or at maxiter), in one
// cooperative launch per solve and no host sync inside it.
//
// Design: a persistent grid of one block per SM (the wrapper passes the
// SM count).  Block b owns the node range [b*nloc, (b+1)*nloc) for the
// whole solve and keeps x, r and Ap, which only it reads, in shared
// memory where they fit (below).  p, which neighbours read, and z go to
// global memory, stored (D, n) so that a warp's loads of one component
// are 128 contiguous bytes.  In this sweep order only the owner reads z
// too; it stays in global memory because at N=64 d=3 it does not fit
// beside x, r, Ap and two ring stages, and one place for z serves every
// mode.  An iteration is three sweeps, each closed by a grid barrier:
//   C) x += alpha p (x lags one iteration), p = z + beta p on the own rows.
//   A) Ap = A p; the partial of p.Ap.
//   B) r -= alpha Ap, z = M r; the partials of r.z and r.r.
// After barriers A and B every block sums all per-block partials in one
// fixed order (grid_sum2), so every block takes the same stopping
// decision.  The TPU streamed kernel's two-sweep order (p recomputed from
// z and the last p inside sweep A, p double-buffered) was timed against
// this one on the H100: it saves barrier C but doubles sweep A's
// gathers, and loses at N=64 (both d) and at N=32 d=3.  The barriers are
// cooperative groups' grid sync:
// an epoch-tagged flag per block, and a fire-and-forget add with an
// acquire spin, were both slower on the H100.
// Sweep A runs on chunks of U*T nodes (T=128, U nodes a thread) with 3
// threads a node: thread (l, g) sums the offsets g, g+3, ... of its nodes
// for all D outputs (each p[j, 0..D) is loaded once and used for every
// output row; the offset loop is unrolled, so all loads of a thread's
// nodes are issued before the sums); the three partials meet in shared
// memory and are added in a fixed order one chunk later, so a chunk costs
// one block sync.  The gathers are plain loads, cached in L1: each grid
// barrier is an acquire at GPU scope, so no line of a vector from before
// the barrier is read after it.
//
// Modes in one source, chosen by the wrapper from the bytes per SM
// (ops/fused_cg.py:launch_plan sizes the shared memory and the ring and
// passes both; the kernel traps if its layout would not fit):
//   RESIDENT (the VMEM-resident kernels' analogue): the owned range's
//     planes and preconditioner are copied into shared memory once per
//     solve (N=32 d=3: 197 KB a block; U=3 for d=3, 4 for d=1 and d=2),
//     so an iteration reads no plane from L2 or HBM.  What bounds it: latency,
//     not bytes: the three grid barriers with the two reads of the 132
//     partials after them (about 1 us each), and one L1-miss round trip
//     to L2 a chunk in sweep A (tools/pcg_phase_times.py).
//   STREAMED (the streamed kernel's analogue, N=64 d=3: 1.1 MB of planes a
//     block): the wrapper's call first copies the planes into scratch with
//     rows padded to a multiple of 4 (one pass a solve); each sweep A then
//     streams the owned planes through a ring of S stages of T nodes with
//     16-byte cp.async copies that bypass L1 and are evicted first from L2,
//     so the vectors keep both caches; chunk c+S-1 is issued as chunk c is
//     summed, and the next iteration's first chunks before the barriers.
//     The preconditioner is read from global memory in sweep B.  What
//     bounds it: HBM bandwidth on the planes (4 n_off D^2 bytes a node an
//     iteration) against one chunk's transfer and gathers a step: only 2
//     stages fit beside x, r and Ap at N=64 (64-node chunks with 6
//     threads a node were slower on the H100).
//   STREAMED_GLOBAL: the same with x, r and Ap in global memory (x in the
//     output), for when they do not fit beside two ring stages (N=64 d=3
//     on fewer than 118 SMs, N >= 67 d=3 on 132); up to 4 stages.  What
//     bounds it: the plane stream as in STREAMED (a third stage does not
//     speed sweep A), plus 6 D floats of global-memory traffic a node an
//     iteration in sweeps B and C (82.6 against 70.5 us at N=64 d=3 on
//     the H100), so it is taken only where the other does not fit.
// Partials are read with __ldcg (L2); read-only inputs through the
// read-only path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// the 3D Kuhn lattice's 15 offsets; _build.py's Offsets mirrors the struct
#define GLIMS_MAX_OFF 15
#define GLIMS_APPLY_BLOCK 128
// (3,3) and (2,2): offsets a chunk of loads, and blocks an SM (at most 128
// registers a thread), so that the N=32 grid fits the card in one wave
#define GLIMS_APPLY_CHUNK_SQ 8
#define GLIMS_APPLY_MIN_BLOCKS_SQ 4
// the forms that load in chunks: a d x d block per offset, d = 2 or 3
#define GLIMS_APPLY_CHUNKED(DOUT, DIN) ((DOUT) * (DIN) >= 4)
#define GLIMS_APPLY_MAX_TERMS 3

// whole-solve PCG geometry; ops/fused_cg.py mirrors these numbers
#define GLIMS_PCG_T 128  // nodes a thread row; a streamed chunk
#define GLIMS_PCG_G 3    // offset groups: threads a node
#define GLIMS_PCG_THREADS (GLIMS_PCG_T * GLIMS_PCG_G)
#define GLIMS_PCG_WARPS (GLIMS_PCG_THREADS / 32)
#define GLIMS_PCG_MAX_OFF GLIMS_MAX_OFF
#define GLIMS_PCG_OFF_PER_G (GLIMS_PCG_MAX_OFF / GLIMS_PCG_G)
#define GLIMS_PCG_MAX_STAGES 4
// nodes a thread sums per chunk: 1 streamed, GLIMS_PCG_U_RESIDENT(D) resident
// (a thread holds U * 5 * D gathered floats: 20, 40, 45 for D = 1, 2, 3)
#define GLIMS_PCG_U_RESIDENT(D) ((D) == 3 ? 3 : 4)
#define GLIMS_PCG_UB 4  // nodes a thread updates per step of sweeps B and C
#define GLIMS_PCG_RESIDENT 0
#define GLIMS_PCG_STREAMED 1
#define GLIMS_PCG_STREAMED_GLOBAL 2

struct Offsets {
  int n;
  int v[GLIMS_MAX_OFF];  // offsets taken mod n into [0, n)
};

struct ApplyArgs {
  const float* W[GLIMS_APPLY_MAX_TERMS];  // (n_off, DOUT, DIN, n) each
  const float* v[GLIMS_APPLY_MAX_TERMS];  // (nv, DIN) each
  float s[GLIMS_APPLY_MAX_TERMS];
  const float* b;  // (n, DOUT), subtracted; null for none
  float* y;        // (n, DOUT)
  int n;
  int nv;  // rows of v: n, or n + 2 halo in the halo form
  Offsets off;
};

// t[a] = sum_o sum_b W[o, a, b, i] * v[(i + off_o) mod nv, b] for every a
// (off_o packed mod n, or as halo + off_o in the halo form): all loads
// first (offsets past off.n load nothing and add exact zeros), then the
// sums in the plain version's order and rounding.
template <int DOUT, int DIN>
__device__ __forceinline__ void stencil_node(const float* __restrict__ W,
                                             const float* __restrict__ v,
                                             int n, int nv, const Offsets& off,
                                             int i, float (&t)[DOUT]) {
  constexpr int CH = GLIMS_APPLY_CHUNKED(DOUT, DIN) ? GLIMS_APPLY_CHUNK_SQ : GLIMS_MAX_OFF;
  const size_t plane = (size_t)n;
#pragma unroll
  for (int a = 0; a < DOUT; ++a) t[a] = 0.0f;
#pragma unroll
  for (int o0 = 0; o0 < GLIMS_MAX_OFF; o0 += CH) {
    float vj[CH][DIN];
    float w[CH][DOUT][DIN];
#pragma unroll
    for (int q = 0; q < CH; ++q) {
      const int o = o0 + q;
      const bool on = o < off.n && o < GLIMS_MAX_OFF;
      int j = i + off.v[on ? o : 0];
      if (j >= nv) j -= nv;
#pragma unroll
      for (int b = 0; b < DIN; ++b)
        vj[q][b] = on ? __ldg(v + (size_t)j * DIN + b) : 0.0f;
#pragma unroll
      for (int a = 0; a < DOUT; ++a)
#pragma unroll
        for (int b = 0; b < DIN; ++b)
          w[q][a][b] =
              on ? __ldg(W + ((size_t)(o * DOUT + a) * DIN + b) * plane + i) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < CH; ++q)
#pragma unroll
      for (int a = 0; a < DOUT; ++a)
#pragma unroll
        for (int b = 0; b < DIN; ++b)
          t[a] = __fadd_rn(t[a], __fmul_rn(w[q][a][b], vj[q][b]));
  }
}

// y[i] = s_0 A_0 v_0 + ... + s_{TERMS-1} A_{TERMS-1} v_{TERMS-1} (- b),
// summed left to right; one thread a node.
template <int DOUT, int DIN, int TERMS>
__global__ void __launch_bounds__(GLIMS_APPLY_BLOCK,
                                  GLIMS_APPLY_CHUNKED(DOUT, DIN) ? GLIMS_APPLY_MIN_BLOCKS_SQ : 1)
    stencil_apply_kernel(const ApplyArgs args) {
  const int n = args.n;
  const int i = blockIdx.x * GLIMS_APPLY_BLOCK + threadIdx.x;
  float out[DOUT];
#pragma unroll
  for (int a = 0; a < DOUT; ++a) out[a] = 0.0f;
  if (i < n) {
#pragma unroll
    for (int k = 0; k < TERMS; ++k) {
      float t[DOUT];
      stencil_node<DOUT, DIN>(args.W[k], args.v[k], n, args.nv, args.off, i, t);
#pragma unroll
      for (int a = 0; a < DOUT; ++a) {
        const float st = __fmul_rn(args.s[k], t[a]);
        out[a] = k == 0 ? st : __fadd_rn(out[a], st);
      }
    }
    if (args.b != nullptr) {
#pragma unroll
      for (int a = 0; a < DOUT; ++a)
        out[a] = __fsub_rn(out[a], __ldg(args.b + (size_t)i * DOUT + a));
    }
  }
  if (DOUT == 1) {
    if (i < n) args.y[i] = out[0];
    return;
  }
  // a warp's 32 nodes' outputs are 32 * DOUT contiguous floats of y
  __shared__ float ys[GLIMS_APPLY_BLOCK * DOUT];
  const int lane = threadIdx.x & 31;
  float* yw = ys + (threadIdx.x - lane) * DOUT;
#pragma unroll
  for (int a = 0; a < DOUT; ++a) yw[lane * DOUT + a] = out[a];
  __syncwarp();
  const size_t e0 = (size_t)(i - lane) * DOUT;
  const size_t end = (size_t)n * DOUT;
#pragma unroll
  for (int q = 0; q < DOUT; ++q) {
    const size_t e = e0 + q * 32 + lane;
    if (e < end) args.y[e] = yw[q * 32 + lane];
  }
}

// -- whole-solve PCG ---------------------------------------------------------

struct PcgArgs {
  const float* W;     // (n_off, D, D, ldw) mask-folded planes
  int ldw;            // plane stride: n (resident), n rounded up to 4 (streamed)
  const float* M;     // (D, D, n) masked preconditioner ((n,) for D=1)
  const float* b;     // (n, D)
  float* x;           // (n, D) out
  float* z;           // (D, n) scratch
  float* p;           // (D, n) scratch
  float* part;        // (4, blocks) scratch: partials
  float* r;           // (n, D) scratch, STREAMED_GLOBAL only
  float* ap;          // (n, D) scratch, STREAMED_GLOBAL only
  int* iters;
  float* resnorm;
  int n, nloc, stages, maxiter;
  float rtol, atol;
  Offsets off;
};

// L2 policy for plane copies: evicted first, so that the vectors the
// gathers read stay in the L2 while the planes stream past.
__device__ __forceinline__ unsigned long long l2_evict_first() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          unsigned long long pol) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;\n" ::"r"(s),
      "l"(src), "l"(pol)
      : "memory");
}

// 16-byte copy that bypasses L1 (which keeps the vectors' lines).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           unsigned long long pol) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(s),
      "l"(src), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most ``pending`` of this thread's newest groups are in
// flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Copy rows [node0, node0 + cnt) of n_planes planes of stride ldn into
// dst[q * ld + l] (cnt <= ld), by the whole block, 4 bytes a copy.
__device__ __forceinline__ void stage_planes(const float* __restrict__ src,
                                             int ldn, int n_planes, int node0,
                                             int cnt, int ld, float* dst,
                                             unsigned long long pol) {
  for (int e = threadIdx.x; e < n_planes * ld; e += GLIMS_PCG_THREADS) {
    const int q = e / ld;
    const int l = e - q * ld;
    if (l < cnt) cp_async4(dst + e, src + (size_t)q * ldn + node0 + l, pol);
  }
}

// The same for one streamed chunk of UT nodes, 16 bytes a copy: ldn and
// node0 are multiples of 4, and the 3 nodes a copy may take past cnt
// land in shared memory that is never read.
template <int UT>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ src,
                                            int ldn, int n_planes, int node0,
                                            int cnt, float* dst,
                                            unsigned long long pol) {
  constexpr int V = UT / 4;
  for (int e = threadIdx.x; e < n_planes * V; e += GLIMS_PCG_THREADS) {
    const int q = e / V;
    const int l = 4 * (e - q * V);
    if (l < cnt) cp_async16(dst + q * UT + l, src + (size_t)q * ldn + node0 + l, pol);
  }
}

// p_k = z + beta p_{k-1}, in one rounding.
__device__ __forceinline__ float p_next(float beta, float p_old, float z) {
  return __fmaf_rn(beta, p_old, z);
}

// Grid-wide sums of u and v, identical in every block: the block's sums
// (warps in order) go to pa[block], pb[block]; after a grid barrier warp
// 0 sums all partials in one fixed order (lane k sums k, k+32, ...
// ascending, then a shuffle tree) and broadcasts them.
__device__ __forceinline__ float2 grid_sum2(float u, float v, float* pa,
                                            float* pb, cg::grid_group& grid,
                                            float (*red)[GLIMS_PCG_WARPS],
                                            float* bcast) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    u += __shfl_down_sync(0xffffffffu, u, s);
    v += __shfl_down_sync(0xffffffffu, v, s);
  }
  if (lane == 0) {
    red[0][wid] = u;
    red[1][wid] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float su = 0.0f, sv = 0.0f;
#pragma unroll
    for (int w = 0; w < GLIMS_PCG_WARPS; ++w) {
      su += red[0][w];
      sv += red[1][w];
    }
    pa[blockIdx.x] = su;
    pb[blockIdx.x] = sv;
  }
  grid.sync();
  if (wid == 0) {
    const int nb = gridDim.x;
    float s = 0.0f, t = 0.0f;
    for (int k = lane; k < nb; k += 32) {
      s += __ldcg(pa + k);
      t += __ldcg(pb + k);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      t += __shfl_down_sync(0xffffffffu, t, o);
    }
    if (lane == 0) {
      bcast[0] = s;
      bcast[1] = t;
    }
  }
  __syncthreads();
  return make_float2(bcast[0], bcast[1]);
}

// Phase timer of block 0 (built with -DGLIMS_PCG_TIMING only, by
// tools/pcg_phase_times.py): SM cycles summed by phase over a solve.
#ifdef GLIMS_PCG_TIMING
__device__ unsigned long long glims_pcg_cycles[8];
#define PCG_MARK(phase)                                           \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                      \
    const long long now = clock64();                              \
    glims_pcg_cycles[phase] += (unsigned long long)(now - t_mark); \
    t_mark = now;                                                 \
  }
#else
#define PCG_MARK(phase)
#endif

// Row i of the preconditioner (owned node l): from shared memory
// (resident) or from global memory (streamed).
template <int D, bool STREAMED>
__device__ __forceinline__ void load_m(const float* __restrict__ Mg,
                                       const float* ms, int nloc, int n, int l,
                                       int i, float (&m)[D * D]) {
#pragma unroll
  for (int q = 0; q < D * D; ++q)
    m[q] = STREAMED ? __ldg(Mg + (size_t)q * n + i) : ms[q * nloc + l];
}

// z = M r at one node.
template <int D>
__device__ __forceinline__ void apply_m(const float (&m)[D * D],
                                        const float (&r)[D], float (&z)[D]) {
#pragma unroll
  for (int a = 0; a < D; ++a) {
    float s = 0.0f;
#pragma unroll
    for (int b = 0; b < D; ++b) s = fmaf(m[a * D + b], r[b], s);
    z[a] = s;
  }
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned v;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(v));
  return v;
}

template <int D, int MODE>
__global__ void __launch_bounds__(GLIMS_PCG_THREADS, 1)
    stencil_pcg_kernel(PcgArgs args) {
  constexpr bool STREAMED = MODE != GLIMS_PCG_RESIDENT;
  constexpr bool VG = MODE == GLIMS_PCG_STREAMED_GLOBAL;  // x, r, Ap global
  constexpr int NT = GLIMS_PCG_THREADS;
  constexpr int G = GLIMS_PCG_G;
  constexpr int T = GLIMS_PCG_T;
  constexpr int OFF_PER_G = GLIMS_PCG_OFF_PER_G;
  constexpr int U = STREAMED ? 1 : GLIMS_PCG_U_RESIDENT(D);  // nodes a thread
  constexpr int UT = U * T;                                // nodes a chunk
  constexpr int CRED = G * D * UT;  // floats of one chunk's partial sums
  constexpr int DD = D * D;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ float red[2][GLIMS_PCG_WARPS];
  __shared__ float bcast[2];
  __shared__ int offs[GLIMS_PCG_MAX_OFF];

  const int n = args.n, nloc = args.nloc, n_off = args.off.n;
  const int nb = gridDim.x, tid = threadIdx.x;
  const int tl = tid % T, g = tid / T;
  const int i0 = min(n, (int)blockIdx.x * nloc);
  const int cnt = min(n, i0 + nloc) - i0;  // owned nodes
  const int nchunks = (cnt + UT - 1) / UT;
  const int n_planes = n_off * DD;
  const int S = args.stages;
  // partials: pAp (with a row for grid_sum2's unused second value), rz, rr
  float* part_pap = args.part;
  float* part_rz = args.part + 2 * nb;
  float* part_rr = args.part + 3 * nb;
  float* zg = args.z;  // z and p are (D, n): a warp's component loads are
                       // 128 contiguous bytes
  const unsigned long long pol = l2_evict_first();

  // shared memory: x, r, Ap (nloc, D) each (global in STREAMED_GLOBAL),
  // the partial sums of two chunks (2, G, D, UT), then the planes and M
  // of the owned range (resident) or the ring of S chunks of planes
  // (streamed)
  float* xs = VG ? args.x + (size_t)i0 * D : smem;
  float* rs = VG ? args.r + (size_t)i0 * D : xs + nloc * D;
  float* aps = VG ? args.ap + (size_t)i0 * D : rs + nloc * D;
  float* cred = VG ? smem : aps + nloc * D;
  float* planes = cred + 2 * CRED;
  float* ms = planes + n_planes * nloc;  // resident only
  const float* smem_end = STREAMED ? planes + S * n_planes * UT : ms + DD * nloc;
  if ((size_t)(smem_end - smem) * sizeof(float) > dynamic_smem_bytes())
    __trap();  // the launch plan's size is short of this layout

  if (tid < n_off) offs[tid] = args.off.v[tid];
  if (!STREAMED) {
    stage_planes(args.W, args.ldw, n_planes, i0, cnt, nloc, planes, pol);
    stage_planes(args.M, n, DD, i0, cnt, nloc, ms, pol);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  // chunk c of the owned range into ring stage c % S (one commit group,
  // empty past the range)
  auto issue_chunk = [&](int c) {
    if (c * UT < cnt)
      stage_chunk<UT>(args.W, args.ldw, n_planes, i0 + c * UT,
                      min(UT, cnt - c * UT), planes + (c % S) * n_planes * UT,
                      pol);
    cp_async_commit();
  };

  // x = 0, r = b, z = M b, p_{-1} = 0
  float rz_l = 0.0f, bb_l = 0.0f;
  float* pg = args.p;
  for (int l = tid; l < cnt; l += NT) {
    const int i = i0 + l;
    float r[D], z[D], m[DD];
    load_m<D, STREAMED>(args.M, ms, nloc, n, l, i, m);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      r[a] = __ldg(args.b + (size_t)i * D + a);
      xs[l * D + a] = 0.0f;
      rs[l * D + a] = r[a];
      pg[(size_t)a * n + i] = 0.0f;
    }
    apply_m<D>(m, r, z);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      zg[(size_t)a * n + i] = z[a];
      rz_l += r[a] * z[a];
      bb_l += r[a] * r[a];
    }
  }
  if (STREAMED)
    for (int c = 0; c < S - 1; ++c) issue_chunk(c);
  float2 t = grid_sum2(rz_l, bb_l, part_rz, part_rr, grid, red, bcast);
  float rz = t.x, rr = t.y;
  const float tol2 = fmaxf(args.rtol * args.rtol * rr, args.atol * args.atol);

#ifdef GLIMS_PCG_TIMING
  long long t_mark = clock64();
#endif
  int k = 0;
  float beta = 0.0f;
  float alpha = 0.0f;
  while (k < args.maxiter && rr > tol2) {
    // C) x += alpha p, p = z + beta p on the own rows (x lags one
    // iteration behind; the last step follows the loop)
    for (int l0 = tid; l0 < cnt; l0 += GLIMS_PCG_UB * NT) {
      float po[GLIMS_PCG_UB][D], zo[GLIMS_PCG_UB][D];
#pragma unroll
      for (int u = 0; u < GLIMS_PCG_UB; ++u) {
        const int l = l0 + u * NT;
        if (l < cnt) {
#pragma unroll
          for (int a = 0; a < D; ++a) {
            po[u][a] = pg[(size_t)a * n + i0 + l];
            zo[u][a] = zg[(size_t)a * n + i0 + l];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < GLIMS_PCG_UB; ++u) {
        const int l = l0 + u * NT;
        if (l < cnt) {
#pragma unroll
          for (int a = 0; a < D; ++a) {
            xs[l * D + a] += alpha * po[u][a];
            pg[(size_t)a * n + i0 + l] = p_next(beta, po[u][a], zo[u][a]);
          }
        }
      }
    }
    grid.sync();
    PCG_MARK(3)  // p sweep and its barrier

    // A) Ap = A p and the partial of p.Ap.  Step c sums chunk c's offset
    // groups and, after one block sync, chunk c-1's groups (the thread
    // (tl, 0) that loaded the own rows of p).
    float pap_l = 0.0f;
    float own_p[U][D];
    for (int c = 0; c <= nchunks; ++c) {
      if (STREAMED && c < nchunks) cp_async_wait_pending(S - 2);
      __syncthreads();
      if (STREAMED) {
        if (c < nchunks) {
          issue_chunk(c + S - 1);
        } else {  // the next iteration's first chunks
          for (int q = 0; q < S - 1; ++q) issue_chunk(q);
        }
      }
      if (c > 0 && g == 0) {
        const float* cr = cred + ((c - 1) & 1) * CRED;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int lc = u * T + tl;
          const int l = (c - 1) * UT + lc;
          if (l < cnt) {
#pragma unroll
            for (int a = 0; a < D; ++a) {
              float y = cr[a * UT + lc];
#pragma unroll
              for (int h = 1; h < G; ++h) y += cr[(h * D + a) * UT + lc];
              aps[l * D + a] = y;
              pap_l += own_p[u][a] * y;
            }
          }
        }
      }
      if (c < nchunks) {
        const float* wc = STREAMED ? planes + (c % S) * n_planes * UT : planes;
        const int ldw = STREAMED ? UT : nloc;
        float* cw = cred + (c & 1) * CRED;
        float pj[U][OFF_PER_G][D];
        // every load of the thread's U nodes first, then the sums
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int l = c * UT + u * T + tl;
          if (l < cnt) {
            const int i = i0 + l;
            if (g == 0) {
#pragma unroll
              for (int a = 0; a < D; ++a) own_p[u][a] = pg[(size_t)a * n + i];
            }
#pragma unroll
            for (int m = 0; m < OFF_PER_G; ++m) {
              const int o = g + G * m;
              if (o < n_off) {
                int j = i + offs[o];
                if (j >= n) j -= n;
#pragma unroll
                for (int b = 0; b < D; ++b)
                  pj[u][m][b] = pg[(size_t)b * n + j];
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int lc = u * T + tl;
          const int l = c * UT + lc;
          if (l < cnt) {
            const float* w = wc + (STREAMED ? lc : l);
            float acc[D];
#pragma unroll
            for (int a = 0; a < D; ++a) acc[a] = 0.0f;
#pragma unroll
            for (int m = 0; m < OFF_PER_G; ++m) {
              const int o = g + G * m;
              if (o < n_off) {
#pragma unroll
                for (int a = 0; a < D; ++a)
#pragma unroll
                  for (int b = 0; b < D; ++b)
                    acc[a] = fmaf(w[(o * DD + a * D + b) * ldw], pj[u][m][b],
                                  acc[a]);
              }
            }
#pragma unroll
            for (int a = 0; a < D; ++a) cw[(g * D + a) * UT + lc] = acc[a];
          }
        }
      }
    }
    PCG_MARK(0)  // sweep A
    const float pAp =
        grid_sum2(pap_l, 0.0f, part_pap, part_pap + nb, grid, red, bcast).x;
    PCG_MARK(1)  // grid sums
    alpha = rz / (pAp == 0.0f ? 1.0f : pAp);

    // B) r -= alpha Ap, z = M r, partials of r.z and r.r (x waits for the
    // next p sweep); GLIMS_PCG_UB nodes a thread, their loads first
    float rz_p = 0.0f, rr_p = 0.0f;
    for (int l0 = tid; l0 < cnt; l0 += GLIMS_PCG_UB * NT) {
      float m[GLIMS_PCG_UB][DD];
#pragma unroll
      for (int u = 0; u < GLIMS_PCG_UB; ++u) {
        const int l = l0 + u * NT;
        if (l < cnt) load_m<D, STREAMED>(args.M, ms, nloc, n, l, i0 + l, m[u]);
      }
#pragma unroll
      for (int u = 0; u < GLIMS_PCG_UB; ++u) {
        const int l = l0 + u * NT;
        if (l < cnt) {
          float r[D], z[D];
#pragma unroll
          for (int a = 0; a < D; ++a) {
            r[a] = rs[l * D + a] - alpha * aps[l * D + a];
            rs[l * D + a] = r[a];
          }
          apply_m<D>(m[u], r, z);
#pragma unroll
          for (int a = 0; a < D; ++a) {
            zg[(size_t)a * n + i0 + l] = z[a];
            rz_p += r[a] * z[a];
            rr_p += r[a] * r[a];
          }
        }
      }
    }
    PCG_MARK(2)  // sweep B
    t = grid_sum2(rz_p, rr_p, part_rz, part_rr, grid, red, bcast);
    PCG_MARK(1)
    beta = t.x / (rz == 0.0f ? 1.0f : rz);
    rz = t.x;
    rr = t.y;
    ++k;
  }
  if (STREAMED) cp_async_wait<0>();
  // the last x += alpha p (p is 0 and alpha 0 if the loop did not run)
  for (int l = tid; l < cnt; l += NT) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      args.x[(size_t)(i0 + l) * D + a] =
          xs[l * D + a] + alpha * pg[(size_t)a * n + i0 + l];
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    *args.iters = k;
    *args.resnorm = sqrtf(rr);
  }
}

// -- host side ---------------------------------------------------------------

// The offsets come packed by the caller (_build.py pack_offsets), already
// taken mod n, or with halo > 0 as halo + off; a pack that does not fit n
// (in [0, n)) or the halo (in [0, 2 halo]) is refused.
static int check_offsets(const Offsets* off, int n, int halo = 0) {
  if (off == nullptr || n < 1 || halo < 0 || off->n < 1 || off->n > GLIMS_MAX_OFF)
    return (int)cudaErrorInvalidValue;
  const int hi = halo > 0 ? 2 * halo : n - 1;
  for (int o = 0; o < off->n; ++o)
    if (off->v[o] < 0 || off->v[o] > hi) return (int)cudaErrorInvalidValue;
  return 0;
}

template <int DOUT, int DIN, int TERMS>
static int launch_apply(const ApplyArgs& args, cudaStream_t stream) {
  const int grid = (args.n + GLIMS_APPLY_BLOCK - 1) / GLIMS_APPLY_BLOCK;
  stencil_apply_kernel<DOUT, DIN, TERMS>
      <<<grid, GLIMS_APPLY_BLOCK, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int D, int MODE>
static int launch_pcg(PcgArgs& args, int blocks, size_t smem,
                      cudaStream_t stream) {
  auto kern = stencil_pcg_kernel<D, MODE>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      GLIMS_PCG_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {(void*)&args};
  return (int)cudaLaunchCooperativeKernel((void*)kern, dim3(blocks),
                                          dim3(GLIMS_PCG_THREADS), kargs, smem,
                                          stream);
}

extern "C" {

// y (n, dout) = stencil(W (n_off, dout, din, n), v (n + 2 halo, din)),
// (dout, din) one of (1,1), (2,2), (2,1), (3,3), (3,1).
int glims_stencil_apply(int dout, int din, const float* W, const float* v,
                        float* y, int n, int halo, const Offsets* off,
                        void* stream) {
  const int err = check_offsets(off, n, halo);
  if (err) return err;
  ApplyArgs args = {};
  args.W[0] = W;
  args.v[0] = v;
  args.s[0] = 1.0f;
  args.y = y;
  args.n = n;
  args.nv = n + 2 * halo;
  args.off = *off;
  cudaStream_t s = (cudaStream_t)stream;
  if (dout == 1 && din == 1) return launch_apply<1, 1, 1>(args, s);
  if (dout == 2 && din == 2) return launch_apply<2, 2, 1>(args, s);
  if (dout == 2 && din == 1) return launch_apply<2, 1, 1>(args, s);
  if (dout == 3 && din == 3) return launch_apply<3, 3, 1>(args, s);
  if (dout == 3 && din == 1) return launch_apply<3, 1, 1>(args, s);
  return (int)cudaErrorInvalidValue;
}

// y (n,) = s0 W0 v0 + s1 W1 v1 + s2 W2 v2 - b, scalar planes (n_off, n)
// on one offset set, v_k (n + 2 halo,); the first ``terms`` (2 or 3) terms
// are read.
int glims_stencil_apply_sum(int terms, const float* W0, const float* v0,
                            float s0, const float* W1, const float* v1,
                            float s1, const float* W2, const float* v2,
                            float s2, const float* b, float* y, int n,
                            int halo, const Offsets* off, void* stream) {
  const int err = check_offsets(off, n, halo);
  if (err) return err;
  if (b == nullptr) return (int)cudaErrorInvalidValue;
  ApplyArgs args = {{W0, W1, W2}, {v0, v1, v2}, {s0, s1, s2}, b, y, n,
                    n + 2 * halo, *off};
  cudaStream_t s = (cudaStream_t)stream;
  if (terms == 2) return launch_apply<1, 1, 2>(args, s);
  if (terms == 3) return launch_apply<1, 1, 3>(args, s);
  return (int)cudaErrorInvalidValue;
}

// Whole-solve PCG of the mask-folded stencil system W x = b, in one
// cooperative launch of ``blocks`` blocks (one an SM), each owning
// ceil(n / blocks) nodes rounded up to 4, with ``smem_bytes`` of dynamic
// shared memory a block (the launch plan's).  mode: 0 resident, 1
// streamed through ``stages`` (2..4) ring stages, after a copy of the
// planes with rows padded to a multiple of 4 into the scratch; 2 the
// same with x, r and Ap in global memory.
// scratch: 2 * n * d + 4 * blocks floats, plus n_off * d * d * ceil4(n)
// in front of them when streamed, plus 2 * n * d behind them in mode 2.
int glims_stencil_pcg(int d, const float* W, const float* Minv,
                      const float* b, float* x, int* iters, float* resnorm,
                      float* scratch, int n, const Offsets* off,
                      float rtol, float atol, int maxiter, void* stream,
                      int mode, int blocks, int stages, int smem_bytes) {
  PcgArgs args;
  int err = check_offsets(off, n);
  if (err) return err;
  args.off = *off;
  const int n_off = off->n;
  const bool streamed = mode == GLIMS_PCG_STREAMED ||
                        mode == GLIMS_PCG_STREAMED_GLOBAL;
  if (blocks < 1 || smem_bytes < 0 ||
      (mode != GLIMS_PCG_RESIDENT && !streamed) ||
      (streamed && (stages < 2 || stages > GLIMS_PCG_MAX_STAGES)))
    return (int)cudaErrorInvalidValue;
  const size_t nd = (size_t)n * d;
  const int n_planes = n_off * d * d;
  const int ldw = streamed ? (n + 3) / 4 * 4 : n;
  const size_t plane_floats = streamed ? (size_t)n_planes * ldw : 0;
  cudaStream_t s = (cudaStream_t)stream;
  args.W = W;
  args.ldw = ldw;
  if (streamed) {  // planes with 16-byte aligned rows for the ring's copies
    float* Wp = scratch;
    err = (int)cudaMemcpy2DAsync(Wp, ldw * sizeof(float), W, n * sizeof(float),
                                 n * sizeof(float), n_planes,
                                 cudaMemcpyDeviceToDevice, s);
    if (err) return err;
    args.W = Wp;
  }
  args.M = Minv;
  args.b = b;
  args.x = x;
  args.z = scratch + plane_floats;
  args.p = args.z + nd;
  args.part = args.z + 2 * nd;
  args.r = args.part + 4 * (size_t)blocks;
  args.ap = args.r + nd;
  args.iters = iters;
  args.resnorm = resnorm;
  args.n = n;
  args.nloc = ((n + blocks - 1) / blocks + 3) / 4 * 4;
  args.stages = streamed ? stages : 1;
  args.maxiter = maxiter;
  args.rtol = rtol;
  args.atol = atol;
  const size_t smem = (size_t)smem_bytes;
  switch (d * 4 + mode) {
    case 4 + GLIMS_PCG_RESIDENT:
      return launch_pcg<1, GLIMS_PCG_RESIDENT>(args, blocks, smem, s);
    case 4 + GLIMS_PCG_STREAMED:
      return launch_pcg<1, GLIMS_PCG_STREAMED>(args, blocks, smem, s);
    case 4 + GLIMS_PCG_STREAMED_GLOBAL:
      return launch_pcg<1, GLIMS_PCG_STREAMED_GLOBAL>(args, blocks, smem, s);
    case 8 + GLIMS_PCG_RESIDENT:
      return launch_pcg<2, GLIMS_PCG_RESIDENT>(args, blocks, smem, s);
    case 8 + GLIMS_PCG_STREAMED:
      return launch_pcg<2, GLIMS_PCG_STREAMED>(args, blocks, smem, s);
    case 8 + GLIMS_PCG_STREAMED_GLOBAL:
      return launch_pcg<2, GLIMS_PCG_STREAMED_GLOBAL>(args, blocks, smem, s);
    case 12 + GLIMS_PCG_RESIDENT:
      return launch_pcg<3, GLIMS_PCG_RESIDENT>(args, blocks, smem, s);
    case 12 + GLIMS_PCG_STREAMED:
      return launch_pcg<3, GLIMS_PCG_STREAMED>(args, blocks, smem, s);
    case 12 + GLIMS_PCG_STREAMED_GLOBAL:
      return launch_pcg<3, GLIMS_PCG_STREAMED_GLOBAL>(args, blocks, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef GLIMS_PCG_TIMING
// Block 0's SM cycles by phase (PCG_MARK 0-3), summed since the last call
// (which zeroes them): sweep A, the two grid sums (block sums, barrier,
// partial reads), sweep B, the p sweep with its barrier.
int glims_pcg_cycles_take(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, glims_pcg_cycles, sizeof(glims_pcg_cycles));
  if (err) return err;
  unsigned long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(glims_pcg_cycles, zero, sizeof(zero));
}
#endif

}  // extern "C"
