// Batched dense matvec of the supernode halo-ELL operators for Hopper
// (sm_90a):
//
//   y[b, m] = sum_k A[b, m, k] * x[b, k],   A (B, M, K), x (B, K), y (B, M)
//
// all float32, row-major, any M and K.
//
// bell_bmv replaces the three Pallas layouts of one function
//   glimslib_tpu/ops/bell_pallas.py:_bmv_call    (K4a, A (B, M, K))
//   glimslib_tpu/ops/bell_pallas.py:_bmv_C_call  (K4b, A (B/128, M, K, 128))
//   glimslib_tpu/ops/bell_pallas.py:_bmv_T_call  (K4c, A (M, K, B))
// The TPU needed the last two to put the block axis on its 128 lanes; a
// GPU warp reduces along K directly, so the port keeps the canonical
// (B, M, K) layout and this one kernel.  Its callers are every halo-ELL
// matvec (elasticity (1152, 96, 474), coupling (1152, 96, 158), rd
// constant planes and mass (1152, 32, 158)) and every supernode
// block-Jacobi apply ((1152, 96, 96) and (1152, 32, 32)) on the
// unstructured path (shapes of the n=32 Morton brain box, s=32).
//
// What bounds it: one pass over A (4 B M K bytes) at 0.5 flop/byte, so HBM
// bandwidth: 212 MB for the elasticity table, 63 us at 3.35 TB/s.  Design:
// one block per (b, tile of GLIMS_BMV_ROWS rows); x[b] is staged once in
// shared memory; one warp per row, its lanes striding along K so that each
// warp load of A is 128 contiguous bytes; a warp-shuffle sum of f32
// partials.  A is read once, as the TPU kernel reads it once (it keeps the
// product in registers).  Rows of 474 or 158 floats are not 16-byte
// aligned, so loads are scalar; vectorised or TMA streaming and fusing the
// halo gather are left for later.

#include <climits>
#include <cuda_runtime.h>

#define GLIMS_BMV_WARPS 8    // warps (rows in flight) a block
#define GLIMS_BMV_ROWS 32    // rows of one b a block covers
#define GLIMS_BMV_MAX_SMEM 232448

__global__ void __launch_bounds__(GLIMS_BMV_WARPS * 32)
    bell_bmv_kernel(const float* __restrict__ A, const float* __restrict__ x,
                    float* __restrict__ y, int M, int K, int tiles) {
  extern __shared__ float xs[];
  const int b = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - b * tiles) * GLIMS_BMV_ROWS;
  const float* xb = x + (size_t)b * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) xs[k] = __ldg(xb + k);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_end = min(row0 + GLIMS_BMV_ROWS, M);
  for (int m = row0 + warp; m < row_end; m += GLIMS_BMV_WARPS) {
    const float* a = A + ((size_t)b * M + m) * K;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = lane; k < K; k += 32) acc += __ldg(a + k) * xs[k];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, s);
    if (lane == 0) y[(size_t)b * M + m] = acc;
  }
}

extern "C" {

// y (B, M) = A (B, M, K) . x (B, K), on the given stream.
int glims_bell_bmv(const float* A, const float* x, float* y, int B, int M,
                   int K, void* stream) {
  if (B < 1 || M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > GLIMS_BMV_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bell_bmv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (M + GLIMS_BMV_ROWS - 1) / GLIMS_BMV_ROWS;
  const long long grid = (long long)B * tiles;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  bell_bmv_kernel<<<(unsigned)grid, GLIMS_BMV_WARPS * 32, smem,
                    (cudaStream_t)stream>>>(A, x, y, M, K, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
