// Block-sparse (BSR) aggregation of a (T, C) field to (T, B) bus series, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bsr_spmm_pallas` of
// atlite_tpu/ops/bsr_spmm.py (the pallas_call at bsr_spmm.py:337).  The
// matrix comes as the K dense (bb x bc) blocks of `to_bsr`, sorted by row
// block then column block; the wrapper turns the sorted row indices into a
// CSR pointer over the blocks (row block r owns blocks [row_ptr[r],
// row_ptr[r + 1])).  It computes
//     out[t, b] = sum_k sum_c blocks[k, b % bb, c] * flat[t, col_blk[k] * bc + c]
// over the blocks of row block b / bb, with
//   * float32 multiply-adds over every stored entry, zeros included: a NaN
//     field entry times a stored zero is NaN, the dense-in-block rule of the
//     Pallas kernel (jnp.dot over the whole block);
//   * columns past C read as zero (the JAX padding);
//   * zeros for every bus of a row block that no block covers.
//
// What bounds it on this card: operations.  At the continental shape (K=486
// blocks of 32 x 512, T=720) it does 2 * K * bb * bc * T = 11.5 GFLOP of
// float32 FMA (0.17 ms at the 67 TFLOP/s of an H100 SXM data sheet) against
// 0.37 GB that must move (field once, blocks, output: 0.11 ms at 3.35 TB/s).
//
// What the design does, simply and correctly first:
//   * one thread block per (32-row tile of a row block, 64-hour tile); it
//     walks its row block's contiguous run of blocks in order, so the
//     sequential k axis of the TPU grid becomes a loop in the block;
//   * per block, 32-column slabs of the matrix block (32 x 32) and of the
//     field (64 hours x 32 columns) are staged in shared memory; both reads
//     run along contiguous columns, so a warp reads 128 coalesced bytes;
//   * each thread keeps a 2 x 4 (bus, hour) tile of sums in registers and
//     writes it once: no atomics, so the bits repeat from run to run.
// Making it fast (TMA, wgmma with split-precision TF32, skipping empty
// slabs) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;                       // bus rows per thread block
constexpr int kTimes = 64;                      // hours per thread block
constexpr int kSlab = 32;                       // columns staged per step
constexpr int kThreads = 256;                   // 16 x 16
constexpr int kRowsPerThread = kRows / 16;      // 2
constexpr int kTimesPerThread = kTimes / 16;    // 4

__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float* __restrict__ flat, const float* __restrict__ blocks,
                const int* __restrict__ col_blk, const int* __restrict__ row_ptr,
                float* __restrict__ out, int T, int C, int B, int bb, int bc,
                int row_tiles) {
  __shared__ float As[kRows][kSlab + 1];   // matrix slab (rows x columns)
  __shared__ float Fs[kTimes][kSlab + 1];  // field slab (hours x columns)

  const int rb = blockIdx.x / row_tiles;              // row block
  const int r0 = (blockIdx.x % row_tiles) * kRows;    // first row within it
  const int t0 = blockIdx.y * kTimes;
  const int tx = threadIdx.x % 16;                    // hours tx + 16 j
  const int ty = threadIdx.x / 16;                    // rows 2 ty + i

  float acc[kRowsPerThread][kTimesPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kTimesPerThread; ++j) acc[i][j] = 0.0f;

  const int k_end = row_ptr[rb + 1];
  for (int k = row_ptr[rb]; k < k_end; ++k) {
    const float* blk = blocks + static_cast<long long>(k) * bb * bc;
    const long long c0 = static_cast<long long>(col_blk[k]) * bc;
    for (int s = 0; s < bc; s += kSlab) {
      for (int e = threadIdx.x; e < kRows * kSlab; e += kThreads) {
        const int r = e / kSlab, c = e % kSlab;
        const int row = r0 + r, col = s + c;
        As[r][c] = (row < bb && col < bc) ? blk[static_cast<long long>(row) * bc + col] : 0.0f;
      }
      for (int e = threadIdx.x; e < kTimes * kSlab; e += kThreads) {
        const int t = t0 + e / kSlab, c = e % kSlab;
        const long long gc = c0 + s + c;
        Fs[e / kSlab][c] = (t < T && s + c < bc && gc < C)
                               ? flat[static_cast<long long>(t) * C + gc]
                               : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kSlab; ++c) {
        float a[kRowsPerThread], f[kTimesPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) a[i] = As[kRowsPerThread * ty + i][c];
#pragma unroll
        for (int j = 0; j < kTimesPerThread; ++j) f[j] = Fs[tx + 16 * j][c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kTimesPerThread; ++j) acc[i][j] = fmaf(a[i], f[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + kRowsPerThread * ty + i;
    const long long b = static_cast<long long>(rb) * bb + row;
    if (row >= bb || b >= B) continue;
#pragma unroll
    for (int j = 0; j < kTimesPerThread; ++j) {
      const int t = t0 + tx + 16 * j;
      if (t < T) out[static_cast<long long>(t) * B + b] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launch the kernel on `stream` (a cudaStream_t, as PyTorch's current
// stream); returns cudaGetLastError() after the launch, 0 on success.
// flat: (T, C) float32; blocks: (K, bb, bc) float32; col_blk: (K,) int32;
// row_ptr: (nb + 1,) int32, nondecreasing, row_ptr[nb] = K; out: (T, B)
// float32 with B <= nb * bb.
int bsr_spmm_launch(int device, const float* flat, const float* blocks, const int* col_blk,
                    const int* row_ptr, float* out, int T, int C, int B, int bb, int bc,
                    int nb, void* stream) {
  if (T < 1 || C < 1 || B < 1 || bb < 1 || bc < 1 || nb < 1 ||
      static_cast<long long>(nb) * bb < B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (bb + kRows - 1) / kRows;
  const long long gx = static_cast<long long>(nb) * row_tiles;
  const long long gy = (T + kTimes - 1) / kTimes;
  if (gx > 0x7fffffffLL || gy > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  bsr_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      flat, blocks, col_blk, row_ptr, out, T, C, B, bb, bc, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* bsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
