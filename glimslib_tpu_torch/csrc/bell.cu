// Batched dense matvec of the supernode halo-ELL operators for Hopper
// (sm_90a):
//
//   y[b, m] = sum_k A[b, m, k] * x[b, k],   A (B, M, K), x (B, K), y (B, M)
//
// all float32, row-major, any B, M and K the launch plan can stage.
//
// bell_bmv replaces the three Pallas layouts of one function
//   glimslib_tpu/ops/bell_pallas.py:_bmv_call    (K4a, A (B, M, K))
//   glimslib_tpu/ops/bell_pallas.py:_bmv_C_call  (K4b, A (B/128, M, K, 128))
//   glimslib_tpu/ops/bell_pallas.py:_bmv_T_call  (K4c, A (M, K, B))
// The TPU needed the last two to put the block axis on its 128 lanes; the
// port keeps the canonical (B, M, K) layout and this one kernel.  Its
// callers are every halo-ELL matvec and every supernode block-Jacobi apply
// of the unstructured path (ops/bell.py, ops/p2_ell.py): tables of
// (1152, 96, 474) down to (88, 32, 32).
//
// What bounds it: one pass over A (4 B M K bytes) at 0.5 flop a byte, so
// HBM bandwidth (393 MB for the P2 rd plane, 117 us at 3.35 TB/s).  The
// design keeps bytes in flight and the compute off the copies' way:
// - A is read as the flat (B M, K) matrix cut into spans of R consecutive
//   rows, about 32 KB each (ops/bell_kernels.py bmv_plan).  In the bulk
//   mode every span starts on a 16-byte boundary and is a multiple of 16
//   bytes, whatever K is, so rows of 474 or 353 floats that start off
//   16-byte boundaries do not matter.
// - Persistent blocks, one an SM: block i takes spans i, i + grid, ... (a
//   static schedule, so results are bit-equal from run to run).
// - A ring of S stages (up to 8; 6-7 at 32 KB) in dynamic shared memory,
//   so an SM keeps 5-6 spans in flight.  A producer warp fills a stage
//   with cp.async.bulk copies of 4 KB (TMA, completed on the stage's
//   "full" mbarrier by complete_tx) as soon as the consumers release it on its
//   "empty" mbarrier; the b-vectors a span touches are staged beside it by
//   the producer's 4-byte cp.async copies, which arrive on the same full
//   mbarrier (cp.async.mbarrier.arrive.noinc).  The ragged mode stages A
//   that way too, for spans that cannot be 16-byte aligned (B M K not a
//   multiple of 4, or A off 16 bytes).
// - 12 consumer warps compute from shared memory: a group of G lanes (8 or
//   16) takes a row, sums in f32 in a fixed order and reduces by shuffles;
//   y is stored by the group's first lane.  Where K is a multiple of 4
//   (rows and x then start on 16 bytes) a lane reads float4s, a
//   quarter-warp 128 contiguous bytes an instruction; else floats, each
//   group of a warp starting at another chunk of G so that they read
//   other banks.
// Why (an H100 80GB HBM3 at 700 W, PERF.md section 6): with the copies
// issued by a thread of the consumers, the whole block stalled whenever
// the TMA queue pushed back, so the copies have a warp of their own; the
// consumers' instructions then bounded the large tables until the float4
// path and a chunk loop without a carried index cut them.

#include <cuda_runtime.h>
#include <stdint.h>

#define GLIMS_BMV_CWARPS 12  // consumer warps a block, beside one producer warp
#define GLIMS_BMV_THREADS (32 * (GLIMS_BMV_CWARPS + 1))
#define GLIMS_BMV_PIECE 4096  // bytes a bulk copy; a span takes several
#define GLIMS_BMV_MAX_STAGES 8
#define GLIMS_BMV_BAR_BYTES 128  // full and empty mbarriers, before the ring
#define GLIMS_BMV_MAX_SMEM 232448

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned v;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(v));
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity; a wait of some 2^24 tries
// (seconds) is a fault of the ring's bookkeeping, and traps rather than
// hangs the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), completing on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// one arrival on bar once every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

struct Span {
  long long r0;  // first row of the flat (B M, K) matrix
  int nr;        // rows
  long long b0;  // first b the rows touch
};

__device__ __forceinline__ Span span_of(long long j, long long rows, int R,
                                        int M) {
  Span s;
  s.r0 = j * R;
  s.nr = (int)min((long long)R, rows - s.r0);
  s.b0 = s.r0 / M;
  return s;
}

// The producer warp fills a stage: its lanes copy x of the span's b's (and,
// in the ragged mode, A) by cp.async, each lane then arrives once they
// have landed; lane 0 also arrives with the bulk copies' byte count and
// issues them, GLIMS_BMV_PIECE bytes each (on an H100 a span in one copy
// read ~20% slower at (1152, 96, 474)).
__device__ __forceinline__ void fill_stage(const float* __restrict__ A,
                                           const float* __restrict__ x,
                                           float* sa, float* sx, uint32_t bar,
                                           Span s, int M, int K, int x_floats,
                                           bool bulk, int lane) {
  const long long b1 = (s.r0 + s.nr - 1) / M;
  const int nx = (int)(b1 - s.b0 + 1) * K;
  if (nx > x_floats) __trap();  // the plan's x area is short of this span
  const float* gx = x + s.b0 * K;
  for (int i = lane; i < nx; i += 32) cp_async4(sx + i, gx + i);
  const float* ga = A + s.r0 * K;
  const int na = s.nr * K;
  if (bulk) {
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive_expect_tx(bar, (uint32_t)na * 4u);
      for (int o = 0; o < na; o += GLIMS_BMV_PIECE / 4)
        bulk_copy(sa + o, ga + o, (uint32_t)min(GLIMS_BMV_PIECE / 4, na - o) * 4u,
                  bar);
    }
  } else {
    for (int i = lane; i < na; i += 32) cp_async4(sa + i, ga + i);
    if (lane == 0) mbar_arrive(bar);
  }
  cp_async_arrive(bar);
}

// One row's dot product by a group of G lanes (lane l of the group), from
// shared memory.  VEC (K a multiple of 4, so every row and x start on 16
// bytes): lane l reads float4 chunks 4 (c G + l), a quarter-warp's 128
// contiguous bytes an instruction, into four sums.  Else a lane reads
// floats c G + l, its group starting at chunk ``first`` so that the groups
// of a warp read other banks, into two sums; the last chunk may be short.
template <int G, bool VEC>
__device__ __forceinline__ float row_dot(const float* __restrict__ a,
                                         const float* __restrict__ xb, int K,
                                         int l, int first) {
  if (VEC) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = 4 * l; k < K; k += 4 * G) {
      const float4 av = *reinterpret_cast<const float4*>(a + k);
      const float4 xv = *reinterpret_cast<const float4*>(xb + k);
      s.x = fmaf(av.x, xv.x, s.x);
      s.y = fmaf(av.y, xv.y, s.y);
      s.z = fmaf(av.z, xv.z, s.z);
      s.w = fmaf(av.w, xv.w, s.w);
    }
    return (s.x + s.y) + (s.z + s.w);
  }
  const int last = (K + G - 1) / G - 1;
  float s0 = 0.f, s1 = 0.f;
  if (last * G + l < K) s1 = a[last * G + l] * xb[last * G + l];
  // chunks [first, last), then [0, first)
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    int k = (part ? 0 : first) * G + l;
    const int end = (part ? first : last) * G;
#pragma unroll 2
    for (; k + G < end; k += 2 * G) {
      s0 = fmaf(a[k], xb[k], s0);
      s1 = fmaf(a[k + G], xb[k + G], s1);
    }
    if (k < end) s0 = fmaf(a[k], xb[k], s0);
  }
  return s0 + s1;
}

template <int G, bool VEC>
__global__ void __launch_bounds__(GLIMS_BMV_THREADS)
    bell_bmv_kernel(const float* __restrict__ A, const float* __restrict__ x,
                    float* __restrict__ y, long long rows, int M, int K,
                    int R, int S, int a_floats, int x_floats, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int stride = a_floats + x_floats;
  if (dynamic_smem_bytes() <
      GLIMS_BMV_BAR_BYTES + (unsigned)S * (unsigned)stride * 4u)
    __trap();  // the launch plan's size is short of this layout
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + GLIMS_BMV_MAX_STAGES;
  float* ring = reinterpret_cast<float*>(smem + GLIMS_BMV_BAR_BYTES);

  const long long n_spans = (rows + R - 1) / R;
  const long long mine =
      (n_spans - blockIdx.x + gridDim.x - 1) / gridDim.x;  // spans of this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(full + s), 33);  // the producer's lanes and lane 0's tx
      mbar_init(smem_addr(empty + s), GLIMS_BMV_CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == GLIMS_BMV_CWARPS) {  // the producer
    for (long long t = 0; t < mine; ++t) {
      const int stage = (int)(t % S);
      if (t >= S) mbar_wait(smem_addr(empty + stage), (uint32_t)((t / S - 1) & 1));
      float* sa = ring + stage * stride;
      fill_stage(A, x, sa, sa + a_floats, smem_addr(full + stage),
                 span_of(blockIdx.x + t * gridDim.x, rows, R, M), M, K,
                 x_floats, bulk, lane);
    }
    return;
  }

  const int l = lane & (G - 1);
  const int grp = threadIdx.x / G;
  constexpr int GROUPS = 32 * GLIMS_BMV_CWARPS / G;
  const int first = (lane / G) % ((K + G - 1) / G);  // other banks for each group
  for (long long t = 0; t < mine; ++t) {
    const int stage = (int)(t % S);
    const Span s = span_of(blockIdx.x + t * gridDim.x, rows, R, M);
    const float* sa = ring + stage * stride;
    const float* sx = sa + a_floats;
    const int m0 = (int)(s.r0 - s.b0 * M);  // the span's first row within b0
    mbar_wait(smem_addr(full + stage), (uint32_t)((t / S) & 1));

    for (int base = 0; base < s.nr; base += GROUPS) {
      const int r = base + grp;
      const bool on = r < s.nr;
      float acc = 0.0f;
      if (on)
        acc = row_dot<G, VEC>(sa + r * K, sx + ((m0 + r) / M) * K, K, l, first);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o, G);
      if (on && l == 0) y[s.r0 + r] = acc;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + stage));  // this warp is done with it
  }
}

template <int G, bool VEC>
int launch(const float* A, const float* x, float* y, long long rows, int M,
           int K, int R, int S, int a_floats, int x_floats, int bulk,
           int blocks, int smem, cudaStream_t stream) {
  // the attribute belongs to the current device's copy of the function, so
  // it is set at every launch that needs more than the default 48 KB
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bell_bmv_kernel<G, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  bell_bmv_kernel<G, VEC><<<blocks, GLIMS_BMV_THREADS, smem, stream>>>(
      A, x, y, rows, M, K, R, S, a_floats, x_floats, bulk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, M) = A (B, M, K) . x (B, K) on the given stream, by the launch
// plan of ops/bell_kernels.py bmv_plan: R rows a span, S stages of
// a_floats (A) + x_floats (x) floats, groups of G lanes a row, bulk (1)
// or ragged (0) staging, blocks, smem bytes.  Returns a cudaError_t.
int glims_bell_bmv(const float* A, const float* x, float* y, int B, int M,
                   int K, int R, int S, int a_floats, int x_floats, int G,
                   int bulk, int blocks, int smem, void* stream) {
  const long long rows = (long long)B * M;
  if (B < 1 || M < 1 || K < 1 || R < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (S < 1 || S > GLIMS_BMV_MAX_STAGES) return (int)cudaErrorInvalidValue;
  if ((long long)R * K > a_floats || a_floats % 4 || x_floats % 4 || x_floats < K)
    return (int)cudaErrorInvalidValue;
  const long long need =
      GLIMS_BMV_BAR_BYTES + (long long)S * (a_floats + x_floats) * 4;
  if (smem < need || smem > GLIMS_BMV_MAX_SMEM) return (int)cudaErrorInvalidValue;
  // a bulk span is 16-byte aligned at both ends: A's base, R K and B M K
  // multiples of 4 floats
  if (bulk && (((uintptr_t)A & 15) || ((long long)R * K) % 4 || (rows * K) % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // rows and x start on 16 bytes in the ring where K is a multiple of 4
  const bool vec = K % 4 == 0;
  switch (G * 2 + vec) {
    case 16: return launch<8, false>(A, x, y, rows, M, K, R, S, a_floats, x_floats, bulk, blocks, smem, s);
    case 17: return launch<8, true>(A, x, y, rows, M, K, R, S, a_floats, x_floats, bulk, blocks, smem, s);
    case 32: return launch<16, false>(A, x, y, rows, M, K, R, S, a_floats, x_floats, bulk, blocks, smem, s);
    case 33: return launch<16, true>(A, x, y, rows, M, K, R, S, a_floats, x_floats, bulk, blocks, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
