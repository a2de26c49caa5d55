// Block-sparse (BSR) aggregation of a (T, C) field to (T, B) bus series, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bsr_spmm_pallas` of
// atlite_tpu/ops/bsr_spmm.py (the pallas_call at bsr_spmm.py:337).  It
// computes, for the K dense (bb x bc) blocks of `to_bsr`,
//     out[t, b] = sum_k sum_c blocks[k, b % bb, c] * flat[t, col_blk[k] * bc + c]
// over the blocks of row block b / bb, with
//   * one float32 multiply-add per nonzero entry;
//   * the dense-in-block NaN rule of the Pallas kernel (jnp.dot over the
//     whole block), exactly: a non-finite field value times a stored zero is
//     NaN.  With n_t the count of non-finite field values at hour t in the
//     columns of a stored block and m the count of them that meet a nonzero
//     of row b, the row is NaN at hour t iff n_t > m for one of its blocks;
//     the products at the nonzero entries carry NaN and +-Inf by themselves;
//   * columns past C read as zero (the JAX padding);
//   * zeros for every bus of a row block that no block covers.
//
// The wrapper (`compact_bsr` in ops/bsr_spmm.py) regroups the blocks: G
// consecutive row blocks (G = 64 / bb, at least 1) form a super row of
// R = G * bb rows, and a unit is one column block of a super row, with
// mask[u] the bits of its row blocks that store a block there.  Super row s
// owns units [unit_ptr[s], unit_ptr[s + 1]), unit u covers field columns
// unit_col[u] * bc + [0, bc), cut into slabs of `width` columns.  The
// entries of (unit u, slab j), e = u * slabs + j, are stored row-interleaved
// (ELL) in slices of 32 rows, each slice as long as its longest row: with
// S = ceil(R / 32) slices and p = ell_ptr[e * S + r / 32], entry i of row r
// is ell[p + i * 32 + r % 32], a (column inside the slab, float32 bits of the
// weight) pair, (0, 0) where the row has fewer entries (no entry has the
// bits of 0.0: zeros are not entries).
//
// What bounds it on this card: bytes, and the instructions spent on them.
// At the continental shape (K = 486 blocks of 32 x 512, T = 720, 115,921
// nonzeros, 1.46% of the stored entries) the products are 0.17 GFLOP,
// 0.0025 ms at the 67 TFLOP/s of an H100 SXM data sheet, while the field
// alone is 334 MB, 0.0997 ms at 3.35 TB/s: every stored column of the field
// must be read, for the NaN rule.  Staging, testing and the products all
// cost instructions for each field value or entry, so the design reads each
// field tile once, tests it with few instructions, and loads each entry once
// for several hours.
//
// What the design does:
//   * one thread block per (super row, time tile of 16 hours); it walks its
//     super row's units and their slabs, so the sequential k axis of the TPU
//     grid becomes a loop in the block.  A super row reads a field tile once
//     for all its row blocks: the two halves of a continental region row
//     share their column blocks, so the field is read about once, not twice
//     (where paired row blocks share no column block, a thread block's
//     other 32 rows idle instead);
//   * the tile of a step (16 hour rows of a slab) goes to shared memory by
//     cp.async, two hour rows a warp, in a two-stage ring: the next step
//     loads while this one is used;
//   * rows of the field are not 16 B aligned when C % 4 != 0, so each hour's
//     row is read from the 16 B boundary at or below its first column and
//     lands at offset (address / 4) % 4 of its shared row: every 16 B copy is
//     aligned on both sides.  The first 16 B of a row that starts off the
//     boundary go as four 4 B copies, and the last 16 B copy reads only the
//     bytes in range: the floats around the range land as zeros (finite);
//   * each warp sums the rows it staged (Inf or NaN if any value is) and the
//     block votes (__syncthreads_or), which is also the barrier that makes
//     the tile visible; only a tile with a non-finite value is counted
//     exactly: n_t by warp reductions, m per row and hour;
//   * a warp computes a 32-row slice (rows on the lanes) x 4 hours: it
//     loads each entry slot once, a coalesced read for its rows, and applies
//     it to its four hours from shared memory; the loop has a known count
//     and no branch (a padding slot adds 0 times a finite value), unrolled 8
//     deep so that its loads, mostly from L2, are in flight together;
//   * the sum of a (row, hour) pair stays in a register, in the fixed order
//     of units and entries; one write at the end, no atomics, so the bits
//     repeat from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = 2;                 // 32-row groups of a thread block's rows
constexpr int kHourGroups = kWarps / kRowGroups;
constexpr int kHG = 4;                        // hours a warp computes
constexpr int kHours = kHourGroups * kHG;     // hours a thread block takes
constexpr int kStageRows = kHours / kWarps;   // hour rows a warp stages and tests
constexpr int kMaxRows = 32 * kRowGroups;     // rows of a super row a thread block takes
constexpr int kMaxWidth = 512;                // columns of a slab (ops/bsr_spmm.py SLAB)
constexpr int kStages = 2;

struct Geom {
  int T, C, B, bb, bc;
  int rows;       // R: rows of a super row
  int row_tiles;  // ceil(R / kMaxRows)
  int width;      // columns a slab holds
  int slabs;      // slabs a unit: ceil(bc / width)
  int pitch;      // floats a staged hour row: 4 * ceil((width + 3) / 4)
};

__device__ __forceinline__ bool non_finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// cp.async of `bytes` (16 or fewer: the rest of the 16 B are zeroed)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

// cp.async of one float, or a zero where !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The float offset of the field at (t, col0) within its 16 B: where that
// column lands in a shared row.
__device__ __forceinline__ int pad_of(const float* flat, const Geom& g, int t, long long col0) {
  return static_cast<int>(
      (reinterpret_cast<uintptr_t>(flat + static_cast<long long>(t) * g.C + col0) >> 2) & 3);
}

__global__ void __launch_bounds__(kThreads, 3)
bsr_spmm_kernel(const float* __restrict__ flat, const int2* __restrict__ ell,
                const int* __restrict__ ell_ptr, const int* __restrict__ unit_ptr,
                const int* __restrict__ unit_col, const unsigned long long* __restrict__ unit_mask,
                float* __restrict__ out, Geom g) {
  extern __shared__ __align__(16) float tile[];  // kStages x kHours x pitch, then the counts
  int* count = reinterpret_cast<int*>(tile + kStages * kHours * g.pitch);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sr = blockIdx.x / g.row_tiles;
  const int row = (blockIdx.x - sr * g.row_tiles) * kMaxRows + (warp % kRowGroups) * 32 + lane;
  const int t0 = blockIdx.y * kHours;
  const int h0 = (warp / kRowGroups) * kHG;  // this warp's first hour within the tile
  const bool mine = row < g.rows;
  const int u0 = unit_ptr[sr];
  const int steps = (unit_ptr[sr + 1] - u0) * g.slabs;  // (unit, slab) steps

  float acc[kHG];
#pragma unroll
  for (int h = 0; h < kHG; ++h) acc[h] = 0.0f;

  // step i: the slab's first column in the field, and its columns inside the
  // field and the block
  auto cols = [&](int i, int& valid) {
    const int s = (i % g.slabs) * g.width;
    const long long col0 = static_cast<long long>(unit_col[u0 + i / g.slabs]) * g.bc + s;
    valid = static_cast<int>(
        max(0LL, min(static_cast<long long>(min(g.width, g.bc - s)), g.C - col0)));
    return col0;
  };
  // each warp stages hour rows warp, warp + kWarps, ... of the tile
  auto stage = [&](int i) {
    int valid;
    const long long col0 = cols(i, valid);
    float* buf = tile + (i % kStages) * kHours * g.pitch;
#pragma unroll
    for (int r = 0; r < kStageRows; ++r) {
      const int h = warp + kWarps * r;
      if (t0 + h >= g.T) break;
      const int pad = pad_of(flat, g, t0 + h, col0), end = pad + valid;
      const float* src = flat + static_cast<long long>(t0 + h) * g.C + col0 - pad;
      for (int q = lane; 4 * q < end; q += 32) {
        float* dst = buf + h * g.pitch + 4 * q;
        if (q == 0 && pad != 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + e, e >= pad && e < end);
        } else {
          cp_async16(dst, src + 4 * q, 4 * min(4, end - 4 * q));
        }
      }
    }
  };

  if (steps > 0) stage(0);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) stage(i + 1);  // its stage was last read before the barrier ending step i - 1
    cp_async_commit();
    cp_async_wait1();
    __syncwarp();

    // test the hour rows this warp staged: a float sum is Inf or NaN if any
    // value is; the floats around the range were staged as zeros
    const float* buf = tile + (i % kStages) * kHours * g.pitch;
    int valid;
    const long long col0 = cols(i, valid);
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < kStageRows; ++r) {
      const int h = warp + kWarps * r;
      if (t0 + h >= g.T) break;
      const int end = pad_of(flat, g, t0 + h, col0) + valid;
      for (int q = lane; 4 * q < end; q += 32) {
        const float4 v = *reinterpret_cast<const float4*>(buf + h * g.pitch + 4 * q);
        sum += (v.x + v.y) + (v.z + v.w);
      }
    }
    const bool any = __syncthreads_or(non_finite(sum));  // also: the whole tile is staged
    if (any) {  // n_t: the non-finite values in range, exact
#pragma unroll
      for (int r = 0; r < kStageRows; ++r) {
        const int h = warp + kWarps * r;
        int n = 0;
        if (t0 + h < g.T) {
          const int end = pad_of(flat, g, t0 + h, col0) + valid;
          for (int q = lane; 4 * q < end; q += 32) {
            const float4 v = *reinterpret_cast<const float4*>(buf + h * g.pitch + 4 * q);
            n += non_finite(v.x) + non_finite(v.y) + non_finite(v.z) + non_finite(v.w);
          }
        }
        n = __reduce_add_sync(0xffffffffu, n);
        if (lane == 0) count[h] = n;
      }
      __syncthreads();
    }

    if (mine) {
      const float* f[kHG];  // this warp's hour rows, from their first column
#pragma unroll
      for (int h = 0; h < kHG; ++h)
        f[h] = buf + (h0 + h) * g.pitch + pad_of(flat, g, min(t0 + h0 + h, g.T - 1), col0);
      const int unit = u0 + i / g.slabs, e = unit * g.slabs + i % g.slabs;
      const int slice = e * ((g.rows + 31) / 32) + row / 32;
      const int2* en = ell + ell_ptr[slice] + lane;
      const int len = (ell_ptr[slice + 1] - ell_ptr[slice]) / 32;
      if (!any) {  // a padding slot (0, 0) adds 0 * a finite value: nothing
#pragma unroll 8
        for (int k = 0; k < len; ++k) {
          const int2 x = __ldg(en + 32 * k);
          const float w = __int_as_float(x.y);
#pragma unroll
          for (int h = 0; h < kHG; ++h) acc[h] = fmaf(w, f[h][x.x], acc[h]);
        }
      } else {
        int met[kHG] = {};  // non-finite values met at this row's nonzeros
        for (int k = 0; k < len; ++k) {
          const int2 x = __ldg(en + 32 * k);
          if (x.y != 0) {  // not a padding slot: no entry has the bits of 0.0
            const float w = __int_as_float(x.y);
#pragma unroll
            for (int h = 0; h < kHG; ++h) {
              const float v = f[h][x.x];
              acc[h] = fmaf(w, v, acc[h]);
              met[h] += non_finite(v);
            }
          }
        }
        if ((unit_mask[unit] >> (row / g.bb)) & 1ull) {  // the row's block is stored here
#pragma unroll
          for (int h = 0; h < kHG; ++h)
            if (count[h0 + h] > met[h]) acc[h] = qnan();  // a stored zero met one
        }
      }
    }
    __syncthreads();  // the next step refills this stage
  }

  const long long b = static_cast<long long>(sr) * g.rows + row;
  if (mine && b < g.B) {
#pragma unroll
    for (int h = 0; h < kHG; ++h)
      if (t0 + h0 + h < g.T) out[static_cast<long long>(t0 + h0 + h) * g.B + b] = acc[h];
  }
}

// Floats a staged hour row takes, and the shared memory of a block, at a
// slab width
int pitch_of(int width) { return 4 * ((width + 6) / 4); }
int shared_bytes(int width) {
  return static_cast<int>(sizeof(float)) * (kStages * kHours * pitch_of(width) + kHours);
}

}  // namespace

extern "C" {

// Resident blocks an SM and shared-memory bytes a block of the kernel at slab
// width `width` on `device`; returns a CUDA error code, 0 on success.
int bsr_spmm_occupancy(int device, int width, int* blocks_per_sm, int* smem_bytes) {
  if (width < 1 || width > kMaxWidth || blocks_per_sm == nullptr || smem_bytes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = shared_bytes(width);
  err = cudaFuncSetAttribute(bsr_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bsr_spmm_kernel, kThreads, *smem_bytes));
}

// Launch the kernel on `stream` (a cudaStream_t, as PyTorch's current
// stream); returns cudaGetLastError() after the launch, 0 on success.
// flat: (T, C) float32; ell: (E, 2) int32, ell_ptr: (U * slabs * S + 1,) int32,
// unit_ptr: (nsr + 1,) int32, unit_col: (U,) int32, unit_mask: (U,) uint64,
// as above, with R = rows, slabs = ceil(bc / width); out: (T, B) float32
// with B <= nsr * R.
int bsr_spmm_launch(int device, const float* flat, const int* ell, const int* ell_ptr,
                    const int* unit_ptr, const int* unit_col, const void* unit_mask, float* out,
                    int T, int C, int B, int bb, int bc, int rows, int width, int nsr,
                    void* stream) {
  if (T < 1 || C < 1 || B < 1 || bb < 1 || bc < 1 || nsr < 1 || rows < bb || rows % bb ||
      rows / bb > 64 || width < 1 || width > kMaxWidth || static_cast<long long>(nsr) * rows < B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geom g;
  g.T = T, g.C = C, g.B = B, g.bb = bb, g.bc = bc;
  g.rows = rows;
  g.row_tiles = (rows + kMaxRows - 1) / kMaxRows;
  g.width = width;
  g.slabs = (bc + width - 1) / width;
  g.pitch = pitch_of(width);
  const long long gx = static_cast<long long>(nsr) * g.row_tiles;
  const long long gy = (T + kHours - 1) / kHours;
  if (gx > 0x7fffffffLL || gy > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int smem = shared_bytes(width);
  err = cudaFuncSetAttribute(bsr_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  bsr_spmm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      flat, reinterpret_cast<const int2*>(ell), ell_ptr, unit_ptr, unit_col,
      static_cast<const unsigned long long*>(unit_mask), out, g);
  return static_cast<int>(cudaGetLastError());
}

const char* bsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
