// Offset-stencil matvec and whole-solve stencil PCG for Hopper (sm_90a).
//
// Layouts are the natural ones of ops/stencil.py: planes W (n_off, DOUT,
// DIN, n), node vectors (n, D), block-Jacobi inverse Binv (D, D, n).  A
// neighbour is read at (i + off) mod n; planes are zero wherever a node
// has no neighbour, so wrapped reads contribute exactly 0.
//
// stencil_apply<DOUT, DIN> replaces the Pallas matvecs
//   glimslib_tpu/ops/stencil_pallas.py:_scalar_kernel            (DOUT=DIN=1)
//   glimslib_tpu/ops/stencil_pallas.py:_vector_kernel_streamed   (DOUT=DIN=3,
//     and DOUT=3, DIN=1 for the growth-strain coupling planes).
// What bounds it: one pass over the planes (4 * n_off * DOUT * DIN bytes a
// node; 19.4 MB for the N=32 elasticity operator) and nothing else, so it
// is bandwidth-bound at 0.25 flop/byte.  Design: one thread per (node,
// output component), threads of a warp on consecutive nodes, so every
// plane read is coalesced; the vector reads hit the same few cache lines
// per warp and come from L1/L2.  The TPU kernel's (R, 128) tiling and
// in-register lane rolls are not carried over: a CUDA thread indexes its
// neighbour directly.
//
// stencil_pcg<D> replaces the whole-solve Pallas CG kernels
//   glimslib_tpu/ops/pallas_cg.py:_cg_scalar_kernel   (D=1, Jacobi)
//   glimslib_tpu/ops/pallas_cg.py:_cg_vector_kernel   (D=3, block-Jacobi)
// with the same update order and stopping rule as solvers/cg.py:pcg
// (x0 = 0; stop when rr <= max(rtol^2 bb, atol^2) or at maxiter).
// What bounds it: per iteration one plane pass (as above) plus ~10 vector
// passes of 4 n D bytes, and three grid-wide barriers.  At N=32 the planes
// (19.4 MB) and vectors (~2 MB) fit the 50 MB L2, so an iteration is bound
// by L2 bandwidth and barrier latency, not by HBM.  Design: one persistent
// cooperative launch per solve (cudaLaunchCooperativeKernel, grid sized to
// the co-resident limit and to the work), so the host never syncs inside
// the solve.  Dot products go to per-block partials; after each
// grid.sync() every block sums all partials in the same fixed order, so
// every block takes the same stopping decision.  Vectors that change
// during the solve are read with __ldcg (L2, never a stale L1 line); the
// read-only planes and preconditioner go through the read-only path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define GLIMS_MAX_OFF 32
#define GLIMS_APPLY_BLOCK 256
#define GLIMS_PCG_BLOCK 256

struct Offsets {
  int n;
  int v[GLIMS_MAX_OFF];  // offsets taken mod n into [0, n)
};

template <bool MUTABLE>
__device__ __forceinline__ float load_vec(const float* p) {
  return MUTABLE ? __ldcg(p) : __ldg(p);
}

// y[i, a] = sum_o sum_b W[o, a, b, i] * v[(i + off_o) mod n, b]
template <int DOUT, int DIN, bool MUTABLE_V>
__device__ __forceinline__ float stencil_row(const float* __restrict__ W,
                                             const float* v, int n,
                                             const Offsets& off, int i,
                                             int a) {
  const size_t plane = (size_t)n;
  float acc = 0.0f;
#pragma unroll 1
  for (int o = 0; o < off.n; ++o) {
    int j = i + off.v[o];
    if (j >= n) j -= n;
    const float* w = W + ((size_t)(o * DOUT + a) * DIN) * plane + i;
#pragma unroll
    for (int b = 0; b < DIN; ++b) {
      acc += __ldg(w + (size_t)b * plane) *
             load_vec<MUTABLE_V>(v + (size_t)j * DIN + b);
    }
  }
  return acc;
}

template <int DOUT, int DIN>
__global__ void __launch_bounds__(GLIMS_APPLY_BLOCK)
    stencil_apply_kernel(const float* __restrict__ W,
                         const float* __restrict__ v, float* __restrict__ y,
                         int n, Offsets off) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * DOUT) return;
  const int a = e / n;
  const int i = e - a * n;
  y[(size_t)i * DOUT + a] = stencil_row<DOUT, DIN, false>(W, v, n, off, i, a);
}

// -- whole-solve PCG ---------------------------------------------------------

// z = M r at node i: Jacobi (D=1, Minv = masked inverse diagonal (n,)) or
// block-Jacobi (D=3, Minv = masked Binv (D, D, n)).
template <int D>
__device__ __forceinline__ void precond(const float* __restrict__ Minv, int n,
                                        int i, const float (&r)[D],
                                        float (&z)[D]) {
#pragma unroll
  for (int a = 0; a < D; ++a) {
    float s = 0.0f;
#pragma unroll
    for (int b = 0; b < D; ++b) {
      s += __ldg(Minv + (size_t)(a * D + b) * n + i) * r[b];
    }
    z[a] = s;
  }
}

// Sum over the block; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = 0.0f;
  if (wid == 0) {
    t = lane < (GLIMS_PCG_BLOCK / 32) ? red[lane] : 0.0f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) t += __shfl_down_sync(0xffffffffu, t, s);
  }
  __syncthreads();
  return t;
}

// Sum of the per-block partials in one fixed order, broadcast to every
// thread of the block; identical in every block.
__device__ __forceinline__ float grid_total(const float* partials, int nb,
                                            float* bcast) {
  if (threadIdx.x < 32) {
    float s = 0.0f;
    for (int k = threadIdx.x; k < nb; k += 32) s += __ldcg(partials + k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) *bcast = s;
  }
  __syncthreads();
  const float t = *bcast;
  __syncthreads();
  return t;
}

template <int D>
__global__ void __launch_bounds__(GLIMS_PCG_BLOCK)
    stencil_pcg_kernel(const float* __restrict__ W,
                       const float* __restrict__ Minv,
                       const float* __restrict__ b, float* x, float* r,
                       float* z, float* p, float* Ap, float* partials,
                       int* iters_out, float* resnorm_out, int n, Offsets off,
                       float rtol, float atol, int maxiter) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[GLIMS_PCG_BLOCK / 32];
  __shared__ float bcast;
  const int nb = gridDim.x;
  float* part_pap = partials;
  float* part_rz = partials + nb;
  float* part_rr = partials + 2 * nb;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = nb * blockDim.x;
  const int nd = n * D;

  // x = 0, r = b, z = M b, p = z
  float l_rz = 0.0f, l_bb = 0.0f;
  for (int i = tid; i < n; i += nthreads) {
    float ri[D], zi[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const int q = i * D + a;
      ri[a] = __ldg(b + q);
      x[q] = 0.0f;
      r[q] = ri[a];
    }
    precond<D>(Minv, n, i, ri, zi);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const int q = i * D + a;
      z[q] = zi[a];
      p[q] = zi[a];
      l_rz += ri[a] * zi[a];
      l_bb += ri[a] * ri[a];
    }
  }
  l_rz = block_sum(l_rz, red);
  l_bb = block_sum(l_bb, red);
  if (threadIdx.x == 0) {
    part_rz[blockIdx.x] = l_rz;
    part_rr[blockIdx.x] = l_bb;
  }
  grid.sync();
  float rz = grid_total(part_rz, nb, &bcast);
  float rr = grid_total(part_rr, nb, &bcast);
  const float tol2 = fmaxf(rtol * rtol * rr, atol * atol);

  int k = 0;
  while (k < maxiter && rr > tol2) {
    // Ap = A p and the partials of p.Ap
    float l_pap = 0.0f;
    for (int e = tid; e < nd; e += nthreads) {
      const int a = e / n;
      const int i = e - a * n;
      const float y = stencil_row<D, D, true>(W, p, n, off, i, a);
      Ap[i * D + a] = y;
      l_pap += __ldcg(p + i * D + a) * y;
    }
    l_pap = block_sum(l_pap, red);
    if (threadIdx.x == 0) part_pap[blockIdx.x] = l_pap;
    grid.sync();
    const float pAp = grid_total(part_pap, nb, &bcast);
    const float alpha = rz / (pAp == 0.0f ? 1.0f : pAp);

    // x += alpha p, r -= alpha Ap, z = M r, partials of r.z and r.r
    float l_rz2 = 0.0f, l_rr = 0.0f;
    for (int i = tid; i < n; i += nthreads) {
      float ri[D], zi[D];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        const int q = i * D + a;
        x[q] = __ldcg(x + q) + alpha * __ldcg(p + q);
        ri[a] = __ldcg(r + q) - alpha * __ldcg(Ap + q);
        r[q] = ri[a];
      }
      precond<D>(Minv, n, i, ri, zi);
#pragma unroll
      for (int a = 0; a < D; ++a) {
        z[i * D + a] = zi[a];
        l_rz2 += ri[a] * zi[a];
        l_rr += ri[a] * ri[a];
      }
    }
    l_rz2 = block_sum(l_rz2, red);
    l_rr = block_sum(l_rr, red);
    if (threadIdx.x == 0) {
      part_rz[blockIdx.x] = l_rz2;
      part_rr[blockIdx.x] = l_rr;
    }
    grid.sync();
    const float rz_new = grid_total(part_rz, nb, &bcast);
    rr = grid_total(part_rr, nb, &bcast);
    const float beta = rz_new / (rz == 0.0f ? 1.0f : rz);

    // p = z + beta p
    for (int e = tid; e < nd; e += nthreads) {
      p[e] = __ldcg(z + e) + beta * __ldcg(p + e);
    }
    grid.sync();
    rz = rz_new;
    ++k;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *iters_out = k;
    *resnorm_out = sqrtf(rr);
  }
}

// -- host side ---------------------------------------------------------------

static int make_offsets(const int* offsets, int n_off, int n, Offsets* out) {
  if (n_off < 1 || n_off > GLIMS_MAX_OFF || n < 1) return (int)cudaErrorInvalidValue;
  out->n = n_off;
  for (int o = 0; o < n_off; ++o) {
    int m = offsets[o] % n;
    out->v[o] = m < 0 ? m + n : m;
  }
  return 0;
}

template <int DOUT, int DIN>
static int launch_apply(const float* W, const float* v, float* y, int n,
                        const Offsets& off, cudaStream_t stream) {
  const int total = n * DOUT;
  const int grid = (total + GLIMS_APPLY_BLOCK - 1) / GLIMS_APPLY_BLOCK;
  stencil_apply_kernel<DOUT, DIN>
      <<<grid, GLIMS_APPLY_BLOCK, 0, stream>>>(W, v, y, n, off);
  return (int)cudaGetLastError();
}

// Blocks of one PCG launch: the co-resident limit, capped by the work
// (one thread per vector entry).  The partials scratch holds 3 floats a
// block, so the caller sizes it for ceil(n * D / GLIMS_PCG_BLOCK) blocks.
template <int D>
static int pcg_blocks(int n, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stencil_pcg_kernel<D>, GLIMS_PCG_BLOCK, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int need = (n * D + GLIMS_PCG_BLOCK - 1) / GLIMS_PCG_BLOCK;
  int nb = per_sm * sms;
  if (nb > need) nb = need;
  *blocks = nb < 1 ? 1 : nb;
  return 0;
}

template <int D>
static int launch_pcg(const float* W, const float* Minv, const float* b,
                      float* x, int* iters, float* resnorm, float* scratch,
                      int n, const Offsets& off, float rtol, float atol,
                      int maxiter, cudaStream_t stream) {
  int nb = 0;
  int err = pcg_blocks<D>(n, &nb);
  if (err) return err;
  const size_t nd = (size_t)n * D;
  float* r = scratch;
  float* z = scratch + nd;
  float* p = scratch + 2 * nd;
  float* Ap = scratch + 3 * nd;
  float* partials = scratch + 4 * nd;
  Offsets off_v = off;
  void* args[] = {(void*)&W,       (void*)&Minv,    (void*)&b,
                  (void*)&x,       (void*)&r,       (void*)&z,
                  (void*)&p,       (void*)&Ap,      (void*)&partials,
                  (void*)&iters,   (void*)&resnorm, (void*)&n,
                  (void*)&off_v,   (void*)&rtol,    (void*)&atol,
                  (void*)&maxiter};
  return (int)cudaLaunchCooperativeKernel((void*)stencil_pcg_kernel<D>,
                                          dim3(nb), dim3(GLIMS_PCG_BLOCK),
                                          args, 0, stream);
}

extern "C" {

// y (n, dout) = stencil(W (n_off, dout, din, n), v (n, din)).
int glims_stencil_apply(int dout, int din, const float* W, const float* v,
                        float* y, int n, const int* offsets, int n_off,
                        void* stream) {
  Offsets off;
  int err = make_offsets(offsets, n_off, n, &off);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dout == 1 && din == 1) return launch_apply<1, 1>(W, v, y, n, off, s);
  if (dout == 3 && din == 3) return launch_apply<3, 3>(W, v, y, n, off, s);
  if (dout == 3 && din == 1) return launch_apply<3, 1>(W, v, y, n, off, s);
  return (int)cudaErrorInvalidValue;
}

// Whole-solve PCG of the mask-folded stencil system W x = b.
// scratch: 4 * n * d + 3 * ceil(n * d / 256) floats.
int glims_stencil_pcg(int d, const float* W, const float* Minv,
                      const float* b, float* x, int* iters, float* resnorm,
                      float* scratch, int n, const int* offsets, int n_off,
                      float rtol, float atol, int maxiter, void* stream) {
  Offsets off;
  int err = make_offsets(offsets, n_off, n, &off);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 1)
    return launch_pcg<1>(W, Minv, b, x, iters, resnorm, scratch, n, off, rtol,
                         atol, maxiter, s);
  if (d == 3)
    return launch_pcg<3>(W, Minv, b, x, iters, resnorm, scratch, n, off, rtol,
                         atol, maxiter, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
