// Fused wind + PV capacity factors with bus aggregation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `wind_pv_bus_megakernel` of
// atlite_tpu/ops/megakernel.py (the pallas_call at megakernel.py:164), and
// follows the semantics of the step it fuses, __graft_entry__._step_fn:
// log-law hub-height wind speed -> piecewise-linear power curve; stored solar
// angles -> latitude-optimal fixed panel -> simple transposition with the
// low-sun / low-influx cutoff -> Huld; both capacity factors aggregated to
// (T, B) bus series with the sparse NaN rule of aggregate.dense_spmm (a NaN
// cell poisons only the buses whose matrix row is nonzero there).
//
// What bounds it on this card: device-memory bytes.  A pass must read nine
// (T, C) float32 fields once, 36 B per cell-hour (0.97 GB at the bench shape
// T=2184, C=12288: 0.29 ms at the 3.35 TB/s of an H100 SXM data sheet), and
// writes only the two (T, B) series.  The arithmetic per cell-hour (seven
// transcendentals, a scan over ~22 power-curve segments, 2 * 2 * B flops of
// aggregation) is of the same order on paper, so it is kept off the memory
// path rather than reduced.
//
// What the design does about it:
//   * each field element is read from device memory exactly once; the
//     capacity factors exist only in shared memory, and no intermediate
//     (T, C) array is written;
//   * loads are coalesced along cells (a warp reads 32 neighbouring cells of
//     one row), and each thread issues the 36 loads of four time rows before
//     it computes, to keep bytes in flight;
//   * the grid is (time tiles x cell splits), with enough splits that every
//     SM holds blocks; each block loops over its cells in chunks, so the
//     sequential grid axis of the TPU kernel becomes a loop in the block;
//   * the (time, bus) sums stay in registers; partial sums per split go to a
//     scratch buffer and a second kernel adds them in a fixed order: no
//     atomics, so results repeat bit for bit;
//   * NaN capacity factors are zeroed for the product, and a bit mask per
//     32 cells (warp ballot) of NaN cells is ANDed with a bit mask of the
//     matrix's nonzeros to mark touched buses.
//
// Floating point: float32 throughout with f-suffixed constants, precise
// logf/sinf/cosf (no fast-math intrinsics), and the build passes
// -fmad=false so that products and sums round as in the plain PyTorch
// version; the branch decisions (latitude breakpoints, power-curve segment,
// low-sun cutoff) then agree with it.  Accumulation uses explicit fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTimeTile = 32;                   // time rows per block
constexpr int kCellChunk = 128;                 // cells per chunk: 4 warps x 32
constexpr int kBusTile = 32;                    // buses per pass: one per lane
constexpr int kThreads = 256;
constexpr int kMaxKnots = 256;
constexpr int kRowGroups = kTimeTile / 4;       // float4 groups of time rows
constexpr int kWords = kCellChunk / 32;         // 32-cell bit words per row
constexpr int kHalves = kThreads / kCellChunk;  // threads per cell of a chunk

// float32 roundings of the constants the plain version compares against
constexpr float kDegToRad = 0.017453292f;    // pi / 180
constexpr float kRad25 = 0.43633232f;        // radians(25)
constexpr float kRad50 = 0.87266463f;        // radians(50)
constexpr float kRad40 = 0.6981317f;         // radians(40)
constexpr float kRad031 = 0.005410521f;      // radians(0.31)
constexpr float kPi = 3.1415927f;
constexpr float kSinOneDegree = 0.017452406f;  // sin(radians(1))
constexpr float kFltMax = 3.4028235e38f;

// field order of ops/megakernel.py FIELD_ORDER
enum Field { WND, ROUGH, ALT, AZ, TOA, DIR, DIF, ALB, TEMP, kNumFields };

struct Fields {
  const float* f[kNumFields];
};

struct Params {
  float hub_height;
  float k1, k2, k3, k4, k5, k6;
  float c_temp_irrad, c_temp_amb, r_tmod, r_irradiance, inverter_efficiency;
};

struct Smem {
  // capacity factors of a chunk, (cell, time) with the float4 group of
  // four time rows swizzled: group g of cell c sits at [c][g ^ (c & 7)],
  // so eight neighbouring cells store to distinct banks
  float4 cfw[kCellChunk][kRowGroups];
  float4 cfp[kCellChunk][kRowGroups];
  float m[kCellChunk][kBusTile + 1];  // matrix tile, (cell, bus), padded
  uint32_t nan_w[kTimeTile][kWords];  // NaN capacity factors, a bit a cell
  uint32_t nan_p[kTimeTile][kWords];
  uint32_t nz[kBusTile][kWords];      // nonzero matrix entries, a bit a cell
  float knot_v[kMaxKnots];
  float knot_p[kMaxKnots];
  float knot_slope[kMaxKnots];
};

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}

// torch.minimum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (is_nan(a) || is_nan(b)) ? qnan() : fminf(a, b);
}

// torch.nan_to_num(x, nan=0.0)
__device__ __forceinline__ float nan_to_num(float x) {
  if (is_nan(x)) return 0.0f;
  if (x > kFltMax) return kFltMax;
  if (x < -kFltMax) return -kFltMax;
  return x;
}

// physics/wind.py: extrapolate_wind_speed (log law, 100 m -> hub) then
// power_curve: [left, right) segments, clamps outside, NaN stays NaN
__device__ __forceinline__ float wind_cf(float wnd100, float z0, const Params& prm,
                                         const Smem& s, int n_seg) {
  const float hub = wnd100 * (logf(prm.hub_height / z0) / logf(100.0f / z0));
  if (is_nan(hub)) return hub;
  float out = 0.0f;
  for (int k = 0; k < n_seg; ++k) {
    const float left = s.knot_v[k];
    if (hub >= left && hub < s.knot_v[k + 1])
      out = out + (s.knot_p[k] + (hub - left) * s.knot_slope[k]);
  }
  if (hub < s.knot_v[0]) out = out + s.knot_p[0];
  if (hub >= s.knot_v[n_seg]) out = out + s.knot_p[n_seg];
  return out;
}

struct Panel {
  float sin_slope, cos_slope, cos_az, sin_az;
};

// physics/orientation.py: orientation_fields, latitude_optimal
__device__ __forceinline__ Panel latitude_optimal(float lat_deg) {
  const float latr = lat_deg * kDegToRad;
  const float a = fabsf(latr);
  const float slope = a <= kRad25 ? 0.87f * a
                    : (a <= kRad50 ? 0.76f * a + kRad031 : kRad40);
  const float az = latr < 0.0f ? 0.0f : kPi;
  return {sinf(slope), cosf(slope), cosf(az), sinf(az)};
}

// physics/orientation.py surface_orientation (tracking None) ->
// physics/irradiation.py tilted_irradiation (simple, direct/diffuse) ->
// physics/pv.py power_huld
__device__ __forceinline__ float pv_cf(const float (&v)[kNumFields], const Panel& pn,
                                       const Params& prm) {
  const float sin_alt = sinf(v[ALT]), cos_alt = cosf(v[ALT]);
  const float sin_az = sinf(v[AZ]), cos_az = cosf(v[AZ]);
  const float cos_rel = pn.cos_az * cos_az + pn.sin_az * sin_az;
  const float cosinc =
      clamp_min(pn.sin_slope * cos_alt * cos_rel + pn.cos_slope * sin_alt, 0.0f);

  const float toa = v[TOA];
  const float direct = nan_min(clamp_min(v[DIR], 0.0f), toa);
  const float diffuse = nan_min(clamp_min(v[DIF], 0.0f), toa - direct);
  const float k_geom = cosinc / sin_alt;
  const float influx = direct + diffuse;
  const float direct_t = k_geom * direct;
  const float diffuse_t = (1.0f + pn.cos_slope) / 2.0f * diffuse;
  const float ground_t = v[ALB] * influx * ((1.0f - pn.cos_slope) / 2.0f);
  const float total = nan_to_num(direct_t) + nan_to_num(diffuse_t) + nan_to_num(ground_t);
  const float irr = (sin_alt < kSinOneDegree || influx <= 0.01f) ? 0.0f : total;

  const float T_ = (prm.c_temp_amb * v[TEMP] + prm.c_temp_irrad * irr) - prm.r_tmod;
  const float G_ = irr / prm.r_irradiance;
  const float L = logf(G_ > 0.0f ? G_ : qnan());
  const float eff = 1.0f + prm.k1 * L + prm.k2 * (L * L)
                  + T_ * (prm.k3 + prm.k4 * L + prm.k5 * (L * L)) + prm.k6 * (T_ * T_);
  return G_ * clamp_min(nan_to_num(eff), 0.0f) * prm.inverter_efficiency;
}

// Block (time tile, cell split): for each bus tile, loop over the split's
// cells in chunks; phase 1 computes both capacity factors of the chunk into
// shared memory, phase 2 multiplies them by the matrix tile.  Writes the
// split's partial (T, B) sums.
__global__ void __launch_bounds__(kThreads)
wind_pv_bus_kernel(Fields F, const float* __restrict__ lat, const float* __restrict__ mat,
                   const float* __restrict__ knot_v, const float* __restrict__ knot_p,
                   const float* __restrict__ knot_slope, int n_knots, int T, int C, int B,
                   int cells_per_split, Params prm, float* __restrict__ part_w,
                   float* __restrict__ part_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t0 = blockIdx.x * kTimeTile;
  const int split = blockIdx.y;
  const int c_begin = split * cells_per_split;
  const int c_end = min(C, c_begin + cells_per_split);
  const int n_seg = n_knots - 1;

  for (int k = tid; k < n_knots; k += kThreads) {
    s.knot_v[k] = knot_v[k];
    s.knot_p[k] = knot_p[k];
    if (k < n_seg) s.knot_slope[k] = knot_slope[k];
  }
  __syncthreads();

  const int cell = tid % kCellChunk;  // phase 1: one cell of the chunk
  const int half = tid / kCellChunk;  // ... and every kHalves-th row group
  const int word = cell / 32;
  const int quad = tid / 32;          // phase 2: rows 4*quad..4*quad+3, bus = lane

  for (int b0 = 0; b0 < B; b0 += kBusTile) {
    float acc_w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc_p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool touched_w[4] = {false, false, false, false};
    bool touched_p[4] = {false, false, false, false};

    for (int c0 = c_begin; c0 < c_end; c0 += kCellChunk) {
      const int c = c0 + cell;
      const bool c_ok = c < c_end;
      const Panel pn = latitude_optimal(c_ok ? lat[c] : 0.0f);

      // ---- phase 1: capacity factors, four time rows at a time
      for (int g = half; g < kRowGroups; g += kHalves) {
        float v[4][kNumFields];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + 4 * g + j;
          const bool ok = c_ok && t < T;
          const size_t idx = static_cast<size_t>(t) * C + c;
#pragma unroll
          for (int f = 0; f < kNumFields; ++f) v[j][f] = ok ? __ldg(F.f[f] + idx) : 0.0f;
        }
        float w[4], p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = c_ok && t0 + 4 * g + j < T;
          const float cw = ok ? wind_cf(v[j][WND], v[j][ROUGH], prm, s, n_seg) : 0.0f;
          const float cp = ok ? pv_cf(v[j], pn, prm) : 0.0f;
          const uint32_t bw = __ballot_sync(0xffffffffu, is_nan(cw));
          const uint32_t bp = __ballot_sync(0xffffffffu, is_nan(cp));
          if (lane == 0) {
            s.nan_w[4 * g + j][word] = bw;
            s.nan_p[4 * g + j][word] = bp;
          }
          w[j] = is_nan(cw) ? 0.0f : cw;
          p[j] = is_nan(cp) ? 0.0f : cp;
        }
        s.cfw[cell][g ^ (cell & 7)] = make_float4(w[0], w[1], w[2], w[3]);
        s.cfp[cell][g ^ (cell & 7)] = make_float4(p[0], p[1], p[2], p[3]);
      }

      // ---- matrix tile and its nonzero bits
      for (int bl = half; bl < kBusTile; bl += kHalves) {
        const int b = b0 + bl;
        const float m = (c_ok && b < B) ? __ldg(mat + static_cast<size_t>(b) * C + c) : 0.0f;
        s.m[cell][bl] = m;
        const uint32_t bits = __ballot_sync(0xffffffffu, m != 0.0f);
        if (lane == 0) s.nz[bl][word] = bits;
      }
      __syncthreads();

      // ---- phase 2: (4 rows) x (1 bus) partial sums over the chunk
      float cw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float cp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k = 0; k < kCellChunk; ++k) {
        const float4 w = s.cfw[k][quad ^ (k & 7)];
        const float4 p = s.cfp[k][quad ^ (k & 7)];
        const float m = s.m[k][lane];
        cw[0] = fmaf(w.x, m, cw[0]);
        cw[1] = fmaf(w.y, m, cw[1]);
        cw[2] = fmaf(w.z, m, cw[2]);
        cw[3] = fmaf(w.w, m, cw[3]);
        cp[0] = fmaf(p.x, m, cp[0]);
        cp[1] = fmaf(p.y, m, cp[1]);
        cp[2] = fmaf(p.z, m, cp[2]);
        cp[3] = fmaf(p.w, m, cp[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc_w[j] += cw[j];
        acc_p[j] += cp[j];
        uint32_t hit_w = 0, hit_p = 0;
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
          hit_w |= s.nan_w[4 * quad + j][q] & s.nz[lane][q];
          hit_p |= s.nan_p[4 * quad + j][q] & s.nz[lane][q];
        }
        touched_w[j] = touched_w[j] || hit_w != 0;
        touched_p[j] = touched_p[j] || hit_p != 0;
      }
      __syncthreads();
    }

    const int b = b0 + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + 4 * quad + j;
      if (t < T && b < B) {
        const size_t o = (static_cast<size_t>(split) * T + t) * B + b;
        part_w[o] = touched_w[j] ? qnan() : acc_w[j];
        part_p[o] = touched_p[j] ? qnan() : acc_p[j];
      }
    }
  }
}

// out = sum over splits of the partials, in split order (a NaN partial
// makes the bus NaN)
__global__ void sum_splits_kernel(const float* __restrict__ part_w,
                                  const float* __restrict__ part_p, int splits, long long n,
                                  float* __restrict__ out_w, float* __restrict__ out_p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float w = part_w[i], p = part_p[i];
  for (int sp = 1; sp < splits; ++sp) {
    w += part_w[sp * n + i];
    p += part_p[sp * n + i];
  }
  out_w[i] = w;
  out_p[i] = p;
}

}  // namespace

extern "C" {

// Cell splits of the grid for T x C cells on a card with `sms` SMs: enough
// for two blocks per SM, at most one per chunk of cells.  The wrapper
// sizes the (splits, T, B) scratch with it.
int wind_pv_bus_splits(int T, int C, int sms) {
  const int n_time = (T + kTimeTile - 1) / kTimeTile;
  const int n_chunks = (C + kCellChunk - 1) / kCellChunk;
  const int want = (2 * sms + n_time - 1) / n_time;
  return want < 1 ? 1 : (want < n_chunks ? want : n_chunks);
}

// Launch both kernels on `stream` (a cudaStream_t, as PyTorch's current
// stream); returns cudaGetLastError() after the launches, 0 on success.
// fields: nine (T, C) float32 arrays in FIELD_ORDER; lat (C,); mat (B, C);
// knots (n_knots,) with slopes (n_knots - 1,); params: 12 floats in the
// order of Params; part_w/part_p: (splits, T, B) scratch; out: (T, B).
int wind_pv_bus_launch(int device, const float* const* fields, const float* lat,
                       const float* mat, const float* knot_v, const float* knot_p,
                       const float* knot_slope, int n_knots, int T, int C, int B, int splits,
                       const float* params, float* part_w, float* part_p, float* out_w,
                       float* out_p, void* stream) {
  if (n_knots < 2 || n_knots > kMaxKnots || T < 1 || C < 1 || B < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (C + kCellChunk - 1) / kCellChunk;
  const int cells_per_split = (n_chunks + splits - 1) / splits * kCellChunk;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(wind_pv_bus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sizeof(Smem)));
  if (err != cudaSuccess) return static_cast<int>(err);

  Fields F;
  for (int f = 0; f < kNumFields; ++f) F.f[f] = fields[f];
  const Params prm = {params[0], params[1], params[2], params[3],  params[4],  params[5],
                      params[6], params[7], params[8], params[9], params[10], params[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const dim3 grid((T + kTimeTile - 1) / kTimeTile, splits);
  wind_pv_bus_kernel<<<grid, kThreads, sizeof(Smem), st>>>(
      F, lat, mat, knot_v, knot_p, knot_slope, n_knots, T, C, B, cells_per_split, prm, part_w,
      part_p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n = static_cast<long long>(T) * B;
  sum_splits_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      part_w, part_p, splits, n, out_w, out_p);
  return static_cast<int>(cudaGetLastError());
}

const char* wind_pv_bus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
