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
// What bounds it on this card.  A pass must read nine (T, C) float32 fields
// once, 36 B a cell-hour (0.97 GB at the bench shape T=2184, C=12288: a
// 0.289 ms byte bound at 3.35 TB/s).  The physics of a cell-hour (two
// divisions and two logs for the hub speed, the power-curve search, sin/cos
// of the sun, a division and a log for the panel) costs a few hundred
// instructions, so issue and latency, not bytes, set the time: on an H100
// SXM (NVIDIA H100 80GB HBM3, 700 W; PERF.md) this kernel takes 0.52 ms at
// the bench shape, 55% of the byte bound, where the same staging with the
// physics replaced by a sum of the fields takes 0.34 ms; the wind chain
// costs ~0.18 ms of it, the PV chain ~0.15 ms.  The first design of this
// kernel (time tiles x cell splits, physics per 32-bus tile, a scan of the
// power curve) took 1.28 ms, of which the scan cost 0.24 ms and its
// unbalanced grid 0.38 ms.  At PyPSA-Eur's shape (T=8760, C=23711, B=34:
// 7.48 GB, a 2.2327 ms byte bound) the three kernels take 4.99 ms a step,
// 44.7% of the bound (the lead staging of design note e; 5.68 ms, 39.3%,
// with 4-byte copies).
//
// What the design does about it:
//   a. physics once per cell-hour, whatever B: a unit of work is 8 time rows
//      x 64 cells; phase 1 computes its two capacity-factor tiles into
//      shared memory, phase 2 multiplies them by every bus tile in turn;
//   b. the power curve is found by a branch-free binary search over the
//      knots (padded by the wrapper to a power of two with +inf), upper-bound
//      semantics, so membership is [left, right) as in the plain version;
//   c. fewer transcendentals: the low-influx cutoff (every night-time
//      cell-hour) is tested before the sun's trigonometry; one sincosf for
//      the sun's altitude (its sine equals sinf's bit for bit, so the
//      low-sun cutoff decides as the plain version does); the panel
//      azimuth is 0 or pi, so cos(az_p - az) is +-cos(az), and the panel
//      (slope sin/cos, transposition factors) is computed once per cell by
//      a prologue kernel; the Huld model divides by r_irradiance as a
//      product with its reciprocal and sums its polynomial with fmaf.  The
//      hub factor keeps the plain version's two logs and divisions, since it
//      decides the power-curve segment, but a thread reuses it for its
//      second row (4 h later) where the cell's roughness has the same bits:
//      on the bench's static roughness the step takes 0.54 ms, where
//      roughness that changes every hour in every cell takes 0.58 ms;
//   d. a balanced persistent grid: a whole number of blocks per SM, each
//      walking a contiguous run of units fixed by the wrapper, so that
//      every block does the same number of units, +-1; a run is cut into
//      items at time-tile edges, and each item writes its (8, B) partials;
//   e. the nine field tiles of the next unit (with its panel entries and
//      first bus tile of the matrix) are staged by 16-byte cp.async into a
//      ring of shared-memory stages while the current unit computes.  Where
//      rows may start off a 16-byte boundary (C % 4 != 0, as PyPSA-Eur's
//      C = 23,711, where row t starts 3 t mod 4 cells past one; or field
//      bases off a boundary), the kernel's kLead instance stages each
//      field row from the aligned address at or below the unit's first
//      cell of that row: 16 pieces where the row starts aligned, 17 where
//      it starts `lead` (1-3) cells past a boundary.  Phase 1 reads cell c
//      at column c + lead; rows r and r + 4 of a unit have the same lead.
//      A piece that runs past the tensor's end reads only up to it
//      (src-size below 16, the rest zero), so no copy leaves the 16-byte
//      segments of the tensor's storage.  Its field rows are 68 floats
//      (+2,304 B a block over two stages), so it reads the panel entries
//      from device memory (L2) in phase 1 instead of staging them
//      (-2,048 B): the narrow tile keeps four blocks an SM (57,072 B a
//      block) and the wide one three (65,264 B).  Where every row starts
//      aligned the other instance stages 16 pieces a row and the panel:
//      staging such rows the lead way cost 4-6% at the bench shape (B = 20
//      and 34) on the card above.  The lead staging needs
//      one 16-byte phase for the nine field bases (a Cutout's fields are
//      separate allocations); fields whose bases differ are staged by
//      4-byte copies, at their old speed.  The matrix rows are read as
//      float4 by phase 2, so they must start aligned: where C % 4 != 0 or
//      the matrix base is not 16-byte aligned, the prologue copies the
//      (B, C) matrix into (B, ceil(C / 4) * 4) scratch, zero past C, every
//      launch (3.2 MB at B = 34, C = 23,711), and no copy is kept across
//      calls.  At C = 12,255 of the bench fields the kernel took 0.572 ms
//      at B = 20 and 0.667 ms at B = 34, against 0.68 and 0.755 ms with
//      4-byte copies, and 0.52 and 0.61 ms at C = 12,288;
//   f. the bus tile is chosen from B (lane_buses): up to 20 buses, one
//      tile of 20 (four blocks, 32 warps an SM); above, tiles of 36 (three
//      blocks: 65.2 KB of shared memory a block), so that up to 36 buses,
//      PyPSA-Eur's 34 countries among them, take one pass.  With one tile
//      the unit's whole (B, 64) matrix slice rides the ring with its
//      fields, each lane keeps its buses' sums in registers over the units
//      of an item, and the partials are written once an item.  With more,
//      each later tile is staged while the unit waits, and every tile of
//      every unit adds its partials to the item's: on the card above,
//      B = 256 (8 tiles) took 6x the time of B = 20 at the bench shape.
//      Tiles of 32 (NBL 8: 48 B of spill loads against 24) took 1.18-1.37x
//      the time of tiles of 36 at B = 37 to 2048, and ~2x at B = 34 (two
//      passes).
//
// The sums keep a fixed order (per warp over its cells, warps in order,
// items in order; no atomics), so a second call repeats the bits.  NaN
// capacity factors are zeroed for the product, and a NaN bit per cell-hour
// (warp ballot) marks the buses whose matrix entry is nonzero there.
//
// Floating point: float32 with f-suffixed constants, precise logf/sincosf/
// cosf (no fast-math intrinsics); the build passes -fmad=false, so every
// product and sum rounds as in the plain PyTorch version unless written as
// fmaf (only the Huld polynomial and the aggregation are); the branch
// decisions (latitude breakpoints, power-curve segment, cutoff) then agree.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 8;                   // time rows of a unit
constexpr int kCells = 64;                 // cells of a unit
constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;                 // ring of staged units
constexpr int kCfPitch = kCells + 4;       // padded row of a capacity-factor tile
constexpr int kMaxBusTile = 36;            // buses of a pass (4 x NBL; design note f)
constexpr int kMaxKnots = 256;
constexpr int kCellsPerWarp = kCells / kWarps;  // phase 2: cells of a warp

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
  float c_temp_irrad, c_temp_amb, r_tmod, inv_r_irradiance, inverter_efficiency;
};

// one staged unit: the nine field tiles, a bus tile of the matrix (its
// rows start 16-byte aligned) and the panel of each cell, each (row-major)
// as in device memory.  In the kernel that stages rows from the aligned
// address at or below their first cell (kLead), a field row holds 17
// pieces of 16 bytes, cell c of the unit at column c + the row's lead
// (0-3), and phase 1 reads the panel from device memory instead (design
// note e)
template <int kBusTile, bool kLead>
struct alignas(16) Stage {
  float fld[kNumFields][kRows][kLead ? kCells + 4 : kCells];
  float4 panel[kLead ? 1 : kCells];
  float m[kBusTile][kCells];
};

// the shared-memory layout of the kernel whose lanes take NBL buses each
template <int NBL, bool kLead>
struct Smem {
  float knot_v[kMaxKnots];         // the search keys, padded with +inf
  float2 seg[kMaxKnots];           // (power at the knot, slope of its segment)
  float cf[2][kRows][kCfPitch];    // wind, PV capacity factors of the unit
  uint32_t nan_bits[2][kRows][kCells / 32];
  Stage<4 * NBL, kLead> stage[kStages];
  const float* field[kLead ? kNumFields : 1];  // the fields, for an index known at run time
};

// the per-warp partials of a bus tile, reduced in flush(); they take the
// place of the unit's field tiles, which phase 1 has read by then (36
// buses fill the 64-cell tiles exactly)
template <int NBL>
using Partials = float[kWarps][2][kRows][4 * NBL];
static_assert(sizeof(Partials<kMaxBusTile / 4>) <= sizeof(Stage<kMaxBusTile, false>::fld),
              "the partials must fit a stage's field tiles");

// blocks an SM, which sets the register budget (64 or 80 a thread): four
// fit the shared memory up to 20 buses a tile (NBL 5), three above; four
// blocks (32 warps) ran the bench shape 7% faster than three
template <int NBL>
constexpr int min_blocks() { return NBL <= 5 ? 4 : 3; }

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

// 16 bytes to shared memory, of which the first `bytes` are read and the
// rest are zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// physics/orientation.py: orientation_fields, latitude_optimal; then the
// cell's factors of physics/orientation.py surface_orientation and
// physics/irradiation.py tilted_irradiation: (sin(slope) * cos(az_p),
// cos(slope), (1 + cos(slope)) / 2, (1 - cos(slope)) / 2).  cos(az_p) is
// +-1 exactly; the sin(az_p) * sin(az) term of cos(az_p - az) (sin(pi) is
// -8.7e-8 in float32) is dropped.
//
// With `mat_pad`, the same launch also copies the (B, C) matrix into
// (B, pitch) rows, zero past C, so that every matrix row starts 16 bytes
// aligned (design note e).
__global__ void panel_kernel(const float* __restrict__ lat, int C, float4* __restrict__ panel,
                             const float* __restrict__ mat, int B, int pitch,
                             float* __restrict__ mat_pad) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < C) {
    const float latr = lat[i] * kDegToRad;
    const float a = fabsf(latr);
    const float slope = a <= kRad25 ? 0.87f * a : (a <= kRad50 ? 0.76f * a + kRad031 : kRad40);
    const float az = latr < 0.0f ? 0.0f : kPi;
    const float cs = cosf(slope);
    panel[i] = make_float4(sinf(slope) * cosf(az), cs, (1.0f + cs) / 2.0f, (1.0f - cs) / 2.0f);
  }
  if (mat_pad != nullptr && i < static_cast<long long>(B) * pitch) {
    const long long b = i / pitch, c = i % pitch;
    mat_pad[i] = c < C ? mat[b * C + c] : 0.0f;
  }
}

// physics/wind.py extrapolate_wind_speed: the log law's factor from 100 m
// to the hub, as the plain version rounds it (a 100 m hub is the field
// itself: factor 1)
__device__ __forceinline__ float hub_factor(float z0, float hub_height) {
  return hub_height == 100.0f ? 1.0f : logf(hub_height / z0) / logf(100.0f / z0);
}

// physics/wind.py power_curve at the hub speed: [left, right) segments,
// clamped outside, NaN stays NaN.  `n_pad` is the knots' count padded to a
// power of two, `n_knots` the real count.
template <typename S>
__device__ __forceinline__ float wind_cf(float hub, const S& s, int n_pad, int n_knots) {
  if (is_nan(hub)) return hub;
  // pos = number of knots <= hub (upper bound), log2(n_pad) + 1 compares;
  // the +inf padding is <= no finite hub
  int pos = 0;
#pragma unroll
  for (int step = kMaxKnots / 2; step > 0; step >>= 1)
    if (step < n_pad) pos += s.knot_v[pos + step - 1] <= hub ? step : 0;
  pos += s.knot_v[pos] <= hub ? 1 : 0;
  const int k = pos - 1;
  if (k < 0) return (0.0f + 0.0f) + s.seg[0].x;                      // below V[0]
  if (k >= n_knots - 1) return (0.0f + 0.0f) + s.seg[n_knots - 1].x;  // at or above V[-1]
  const float2 g = s.seg[k];
  return 0.0f + (g.x + (hub - s.knot_v[k]) * g.y);
}

// physics/orientation.py surface_orientation (tracking None) ->
// physics/irradiation.py tilted_irradiation (simple, direct/diffuse) ->
// physics/pv.py power_huld; 0 where the cutoff holds, as the plain version
// gives there
__device__ __forceinline__ float pv_cf(float alt, float az, float toa, float dir, float dif,
                                       float alb, float temp, const float4& pn,
                                       const Params& prm) {
  const float direct = nan_min(clamp_min(dir, 0.0f), toa);
  const float diffuse = nan_min(clamp_min(dif, 0.0f), toa - direct);
  const float influx = direct + diffuse;
  if (influx <= 0.01f) return 0.0f;  // every night-time cell-hour
  float sin_alt, cos_alt;
  sincosf(alt, &sin_alt, &cos_alt);
  if (sin_alt < kSinOneDegree) return 0.0f;

  const float cosinc = clamp_min(pn.x * cos_alt * cosf(az) + pn.y * sin_alt, 0.0f);
  const float k_geom = cosinc / sin_alt;
  const float direct_t = k_geom * direct;
  const float diffuse_t = pn.z * diffuse;
  const float ground_t = alb * influx * pn.w;
  const float irr = nan_to_num(direct_t) + nan_to_num(diffuse_t) + nan_to_num(ground_t);

  const float T_ = fmaf(prm.c_temp_amb, temp, prm.c_temp_irrad * irr) - prm.r_tmod;
  const float G_ = irr * prm.inv_r_irradiance;
  const float L = logf(G_ > 0.0f ? G_ : qnan());
  const float inner = fmaf(fmaf(prm.k5, L, prm.k4), L, prm.k3);
  const float eff = fmaf(T_, fmaf(prm.k6, T_, inner), fmaf(fmaf(prm.k2, L, prm.k1), L, 1.0f));
  return G_ * clamp_min(nan_to_num(eff), 0.0f) * prm.inverter_efficiency;
}

struct Work {
  Fields F;
  const float4* panel;  // (C,) from panel_kernel
  const float* mat;     // (B, pitch): rows 16-byte aligned, zero past C
  int T, C, B, n_cb;    // n_cb: 64-cell chunks of C
  int pitch;            // of the matrix rows, a multiple of 4
  int phase;            // the fields' common offset from a 16-byte boundary
                        // (0-3 floats), or -1: they differ (4-byte copies)
};

// cells between the 16-byte-aligned address at or below cell c0 of row t
// and that cell, alike in every field (phase >= 0)
__device__ __forceinline__ int row_lead(const Work& w, int t, int c0) {
  return (static_cast<unsigned>(t) * static_cast<unsigned>(w.C) + c0 + w.phase) & 3u;
}

// the 16-byte piece of row t that starts `k` cells after the aligned
// address at or below cell c0 (k a multiple of 4): its offset from a
// field's base (down to -3 in row 0) and the bytes read, fewer than 16
// where it runs past the tensor's end; past T or past the row's cells none
// (at the aligned address at or below the base)
struct Piece {
  long long at;
  int bytes;
};

__device__ __forceinline__ Piece row_piece(const Work& w, int t, int c0, int lead, int k) {
  const int cell = c0 - lead + k;
  if (t >= w.T || cell >= w.C) return {-w.phase, 0};
  const long long rem = static_cast<long long>(w.T - t) * w.C - cell;  // floats to the end
  return {static_cast<long long>(t) * w.C + cell, rem >= 4 ? 16 : 4 * static_cast<int>(rem)};
}

// stage unit u (time tile u / n_cb, cell chunk u % n_cb) into `st`, with
// the bus tile starting at b0 (`with_fields` false: the bus tile alone);
// rows past T, cells past C and buses past B are not read
template <int kBusTile, bool kLead>
__device__ __forceinline__ void stage_unit(const Work& w, const float* const* field, int u,
                                           int b0, bool with_fields,
                                           Stage<kBusTile, kLead>& st) {
  constexpr int kVecs = kCells / 4;  // 16-byte pieces of a unit's row
  const int tid = threadIdx.x;
  const int t0 = (u / w.n_cb) * kRows;
  const int c0 = (u % w.n_cb) * kCells;
  if (with_fields) {
    // pieces 0-15 of each row: threads 0-127 stage the even fields,
    // 128-255 the odd ones; the field index stays a compile-time constant
    // (no copy of the parameters to local memory)
    const int odd = tid / (kRows * kVecs), r = (tid / kVecs) % kRows, v = tid % kVecs;
    if constexpr (kLead) {
      const Piece pc = row_piece(w, t0 + r, c0, row_lead(w, t0 + r, c0), 4 * v);
#pragma unroll
      for (int f = 0; f < kNumFields; f += 2) {
        if (odd && f + 1 >= kNumFields) break;
        const float* src = (odd ? w.F.f[f + 1 < kNumFields ? f + 1 : f] : w.F.f[f]) + pc.at;
        cp_async16(&st.fld[f + odd][r][4 * v], src, pc.bytes);
      }
      // piece 16 of each row that does not start aligned: threads
      // 128-199, which stage one field fewer above
      const int j = tid - kThreads / 2;
      if (j >= 0 && j < kNumFields * kRows) {
        const int f = j / kRows, rr = j % kRows;
        const int lead = row_lead(w, t0 + rr, c0);
        if (lead != 0) {
          const Piece p16 = row_piece(w, t0 + rr, c0, lead, kCells);
          if (p16.bytes > 0) cp_async16(&st.fld[f][rr][kCells], field[f] + p16.at, p16.bytes);
        }
      }
    } else {
      if (w.phase == 0) {  // every row starts aligned
        const int t = t0 + r, c = c0 + 4 * v;
        const bool ok = t < w.T && c < w.C;
        const size_t at = ok ? static_cast<size_t>(t) * w.C + c : 0;
#pragma unroll
        for (int f = 0; f < kNumFields; f += 2) {
          if (odd && f + 1 >= kNumFields) break;
          const float* src = (odd ? w.F.f[f + 1 < kNumFields ? f + 1 : f] : w.F.f[f]) + at;
          cp_async16(&st.fld[f + odd][r][4 * v], src, ok ? 16 : 0);
        }
      } else {  // the field bases differ in their 16-byte phase: 4-byte copies
#pragma unroll
        for (int h = 0; h < kRows * kCells / kThreads; ++h) {
          const int q = tid + h * kThreads, rr = q / kCells, cc = q % kCells;
          const int t = t0 + rr, c = c0 + cc;
          const bool ok = t < w.T && c < w.C;
          const size_t at = ok ? static_cast<size_t>(t) * w.C + c : 0;
#pragma unroll
          for (int f = 0; f < kNumFields; ++f) cp_async4(&st.fld[f][rr][cc], w.F.f[f] + at, ok);
        }
      }
      for (int q = tid; q < kCells; q += kThreads) {
        const bool ok = c0 + q < w.C;
        cp_async16(&st.panel[q], w.panel + (ok ? c0 + q : 0), ok ? 16 : 0);
      }
    }
  }
  for (int q = tid; q < kBusTile * kVecs; q += kThreads) {
    const int b = b0 + q / kVecs, c = c0 + 4 * (q % kVecs);
    const bool ok = b < w.B && c < w.pitch;
    cp_async16(&st.m[q / kVecs][4 * (q % kVecs)],
               w.mat + (ok ? static_cast<size_t>(b) * w.pitch + c : 0), ok ? 16 : 0);
  }
}

// add the warps' partials of one bus tile in warp order and write (first
// unit of an item) or add them to the item's (8, B) partials
template <int NBL, bool kLead>
__device__ __forceinline__ void flush(Stage<4 * NBL, kLead>& st, const float (&acc_w)[NBL],
                                      const float (&acc_p)[NBL], uint32_t hit_w,
                                      uint32_t hit_p, float* __restrict__ part, int n_items,
                                      int item, int t0, int b0, int T, int B, bool first) {
  constexpr int kBusTile = 4 * NBL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane & 7, g = lane >> 3;
  Partials<NBL>& red = *reinterpret_cast<Partials<NBL>*>(&st.fld[0][0][0]);
#pragma unroll
  for (int j = 0; j < NBL; ++j) {
    red[warp][0][r][g + 4 * j] = (hit_w >> j) & 1u ? qnan() : acc_w[j];
    red[warp][1][r][g + 4 * j] = (hit_p >> j) & 1u ? qnan() : acc_p[j];
  }
  __syncthreads();
  for (int o = tid; o < 2 * kRows * kBusTile; o += kThreads) {
    const int cf = o / (kRows * kBusTile), rr = (o / kBusTile) % kRows, b = o % kBusTile;
    float sum = red[0][cf][rr][b];
#pragma unroll
    for (int wp = 1; wp < kWarps; ++wp) sum += red[wp][cf][rr][b];
    if (t0 + rr < T && b0 + b < B) {
      float* dst = part + ((static_cast<size_t>(cf) * n_items + item) * kRows + rr) * B + b0 + b;
      *dst = first ? sum : *dst + sum;
    }
  }
  __syncthreads();
}

// The persistent kernel.  Block k walks units [block_unit[k],
// block_unit[k+1]); its first item is block_item[k], and a new item starts
// at every time tile's first chunk.  part: (2, n_items, 8, B).
template <int NBL, bool kLead>
__global__ void __launch_bounds__(kThreads, min_blocks<NBL>())
wind_pv_bus_kernel(Work w, const float4* __restrict__ table, int n_pad, int n_knots,
                   const int* __restrict__ block_unit, const int* __restrict__ block_item,
                   Params prm, int n_items, float* __restrict__ part) {
  constexpr int kBusTile = 4 * NBL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NBL, kLead>& s = *reinterpret_cast<Smem<NBL, kLead>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ub = block_unit[blockIdx.x], ue = block_unit[blockIdx.x + 1];
  if (ub >= ue) return;
  const int n_bus_tiles = (w.B + kBusTile - 1) / kBusTile;

  for (int k = tid; k < n_pad; k += kThreads) {
    const float4 g = table[k];
    s.knot_v[k] = g.x;
    s.seg[k] = make_float2(g.y, g.z);
  }
  if constexpr (kLead) {
#pragma unroll
    for (int f = 0; f < kNumFields; ++f)
      if (tid == f) s.field[f] = w.F.f[f];
    __syncthreads();
  }

  // ring prologue: the first kStages - 1 units
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (ub + i < ue) stage_unit(w, s.field, ub + i, 0, true, s.stage[i]);
    cp_async_commit();
  }

  // phase 1: cell c1 of the unit, rows r1 and r1 + 4
  const int c1 = tid % kCells, r1 = tid / kCells;
  // phase 2: row r2, buses g2 + 4 j, cells kCellsPerWarp * warp + ...
  const int r2 = lane & 7, g2 = lane >> 3;
  const int k2 = kCellsPerWarp * warp;

  float acc_w[NBL] = {}, acc_p[NBL] = {};
  uint32_t hit_w = 0, hit_p = 0;
  int item = block_item[blockIdx.x] - 1;

  for (int u = ub; u < ue; ++u) {
    const int nxt = u + kStages - 1;
    if (nxt < ue) stage_unit(w, s.field, nxt, 0, true, s.stage[(nxt - ub) % kStages]);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    Stage<kBusTile, kLead>& st = s.stage[(u - ub) % kStages];
    const int cb = u % w.n_cb;
    const int t0 = (u / w.n_cb) * kRows;
    const bool first = u == ub || cb == 0;
    const bool last = u + 1 == ue || cb == w.n_cb - 1;
    if (first) ++item;

    // ---- phase 1: both capacity factors of the unit, once
    {
      const int c = cb * kCells + c1;
      const bool c_ok = c < w.C;
      float4 pn;
      int cc = c1;  // the cell's column in rows r1 and r1 + 4
      if constexpr (kLead) {
        pn = c_ok ? __ldg(&w.panel[c]) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        cc += row_lead(w, t0 + r1, cb * kCells);  // equal in both rows: 4 C % 4 == 0
      } else {
        pn = st.panel[c1];
      }
      // the second row's hub factor is the first's where the roughness has
      // the same bits (a static field, or land in ERA5); else its own
      const float z0a = st.fld[ROUGH][r1][cc], z0b = st.fld[ROUGH][r1 + 4][cc];
      const float fa = hub_factor(z0a, prm.hub_height);
      const float factor[2] = {
          fa, __float_as_uint(z0b) == __float_as_uint(z0a) ? fa : hub_factor(z0b, prm.hub_height)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r1 + 4 * h;
        const bool ok = c_ok && t0 + r < w.T;
        float cw = 0.0f, cp = 0.0f;
        if (ok) {
          cw = wind_cf(st.fld[WND][r][cc] * factor[h], s, n_pad, n_knots);
          cp = pv_cf(st.fld[ALT][r][cc], st.fld[AZ][r][cc], st.fld[TOA][r][cc],
                     st.fld[DIR][r][cc], st.fld[DIF][r][cc], st.fld[ALB][r][cc],
                     st.fld[TEMP][r][cc], pn, prm);
        }
        const uint32_t bw = __ballot_sync(0xffffffffu, is_nan(cw));
        const uint32_t bp = __ballot_sync(0xffffffffu, is_nan(cp));
        if (lane == 0) {
          s.nan_bits[0][r][c1 / 32] = bw;
          s.nan_bits[1][r][c1 / 32] = bp;
        }
        s.cf[0][r][c1] = is_nan(cw) ? 0.0f : cw;
        s.cf[1][r][c1] = is_nan(cp) ? 0.0f : cp;
      }
    }
    __syncthreads();

    // ---- phase 2: every bus tile against the unit's capacity factors
    const uint32_t nan_w = (s.nan_bits[0][r2][k2 / 32] >> (k2 % 32)) & 0xffu;
    const uint32_t nan_p = (s.nan_bits[1][r2][k2 / 32] >> (k2 % 32)) & 0xffu;
    for (int bt = 0; bt < n_bus_tiles; ++bt) {
      if (bt > 0) {  // the first bus tile came with the stage
        stage_unit(w, s.field, u, bt * kBusTile, false, st);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (n_bus_tiles > 1 || first) {
#pragma unroll
        for (int j = 0; j < NBL; ++j) acc_w[j] = acc_p[j] = 0.0f;
        hit_w = hit_p = 0;
      }
#pragma unroll
      for (int k = 0; k < kCellsPerWarp; k += 4) {
        const float4 fw = *reinterpret_cast<const float4*>(&s.cf[0][r2][k2 + k]);
        const float4 fp = *reinterpret_cast<const float4*>(&s.cf[1][r2][k2 + k]);
#pragma unroll
        for (int j = 0; j < NBL; ++j) {
          const float4 m = *reinterpret_cast<const float4*>(&st.m[g2 + 4 * j][k2 + k]);
          acc_w[j] = fmaf(fw.x, m.x, acc_w[j]);
          acc_w[j] = fmaf(fw.y, m.y, acc_w[j]);
          acc_w[j] = fmaf(fw.z, m.z, acc_w[j]);
          acc_w[j] = fmaf(fw.w, m.w, acc_w[j]);
          acc_p[j] = fmaf(fp.x, m.x, acc_p[j]);
          acc_p[j] = fmaf(fp.y, m.y, acc_p[j]);
          acc_p[j] = fmaf(fp.z, m.z, acc_p[j]);
          acc_p[j] = fmaf(fp.w, m.w, acc_p[j]);
        }
      }
      if (nan_w | nan_p) {  // rare: mark buses touching a NaN cell-hour
        for (int k = 0; k < kCellsPerWarp; ++k) {
#pragma unroll
          for (int j = 0; j < NBL; ++j) {
            const bool nz = st.m[g2 + 4 * j][k2 + k] != 0.0f;
            hit_w |= static_cast<uint32_t>(nz && ((nan_w >> k) & 1u)) << j;
            hit_p |= static_cast<uint32_t>(nz && ((nan_p >> k) & 1u)) << j;
          }
        }
      }
      if (n_bus_tiles > 1)
        flush<NBL>(st, acc_w, acc_p, hit_w, hit_p, part, n_items, item, t0, bt * kBusTile,
                   w.T, w.B, first);
    }
    if (n_bus_tiles == 1 && last)
      flush<NBL>(st, acc_w, acc_p, hit_w, hit_p, part, n_items, item, t0, 0, w.T, w.B, true);
    __syncthreads();  // the stage and the capacity factors are reused
  }
  cp_async_wait<0>();
}

// out[t][b] = sum over the items of t's time tile of their partials, in
// item order (a NaN partial makes the bus NaN)
__global__ void sum_items_kernel(const float* __restrict__ part, int n_items,
                                 const int* __restrict__ tile_item, int T, int B,
                                 float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = static_cast<long long>(T) * B;
  if (i >= n) return;
  const int t = static_cast<int>(i / B), b = static_cast<int>(i % B);
  const int tt = t / kRows, r = t % kRows;
  const size_t plane = static_cast<size_t>(n_items) * kRows * B;
  float sw = 0.0f, sp = 0.0f;
  for (int it = tile_item[tt]; it < tile_item[tt + 1]; ++it) {
    const size_t o = (static_cast<size_t>(it) * kRows + r) * B + b;
    sw += part[o];
    sp += part[plane + o];
  }
  out[i] = sw;
  out[n + i] = sp;
}

template <int NBL, bool kLead>
cudaError_t prepare(int* blocks_per_sm, int* smem_bytes) {
  constexpr int kSmem = static_cast<int>(sizeof(Smem<NBL, kLead>));
  cudaError_t err = cudaFuncSetAttribute(wind_pv_bus_kernel<NBL, kLead>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess || blocks_per_sm == nullptr) return err;
  *smem_bytes = kSmem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, wind_pv_bus_kernel<NBL, kLead>, kThreads, kSmem);
}

// the fewer blocks an SM of the two kernels of a bus tile, and the larger
// shared memory a block: the grid fits both
template <int NBL>
cudaError_t prepare_both(int* blocks_per_sm, int* smem_bytes) {
  int blocks[2], smem[2];
  cudaError_t err = prepare<NBL, true>(&blocks[0], &smem[0]);
  if (err == cudaSuccess) err = prepare<NBL, false>(&blocks[1], &smem[1]);
  *blocks_per_sm = blocks[0] < blocks[1] ? blocks[0] : blocks[1];
  *smem_bytes = smem[0] > smem[1] ? smem[0] : smem[1];
  return err;
}

// buses of a lane: 4 lanes per row share a tile of 4 * NBL buses; 20
// buses a pass up to B = 20 (four blocks an SM), 36 above (three; design
// note f)
constexpr int kNarrowNbl = 5;
int lane_buses(int B) { return B <= 4 * kNarrowNbl ? kNarrowNbl : kMaxBusTile / 4; }

template <int NBL, bool kLead>
cudaError_t launch(int n_blocks, const Work& w, const float4* table, int n_pad, int n_knots,
                   const int* block_unit, const int* block_item, const Params& prm,
                   int n_items, float* part, cudaStream_t st) {
  cudaError_t err = prepare<NBL, kLead>(nullptr, nullptr);
  if (err != cudaSuccess) return err;
  wind_pv_bus_kernel<NBL, kLead><<<n_blocks, kThreads, sizeof(Smem<NBL, kLead>), st>>>(
      w, table, n_pad, n_knots, block_unit, block_item, prm, n_items, part);
  return cudaGetLastError();
}

template <typename Fn>
cudaError_t dispatch(int nbl, Fn&& fn) {
  return nbl == kNarrowNbl ? fn(std::integral_constant<int, kNarrowNbl>())
                           : fn(std::integral_constant<int, kMaxBusTile / 4>());
}

}  // namespace

extern "C" {

// Resident blocks an SM of `device` holds of the kernels that take B
// buses (the fewer of the two stagings' kernels), their shared memory a
// block (the larger) and the buses of their pass; the wrapper launches a
// whole number of blocks per SM.
int wind_pv_bus_occupancy(int device, int B, int* blocks_per_sm, int* smem_bytes,
                          int* bus_tile) {
  if (B < 1 || blocks_per_sm == nullptr || smem_bytes == nullptr || bus_tile == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bus_tile = 4 * lane_buses(B);
  return static_cast<int>(dispatch(lane_buses(B), [&](auto nbl) {
    return prepare_both<decltype(nbl)::value>(blocks_per_sm, smem_bytes);
  }));
}

// Launch the panel prologue, the fused kernel and the item sums on `stream`
// (a cudaStream_t, as PyTorch's current stream); returns cudaGetLastError()
// after the launches, 0 on success.
// fields: nine (T, C) float32 arrays in FIELD_ORDER; lat (C,); mat (B, C);
// mat_pad: (B, ceil(C / 4) * 4) scratch, 16-byte aligned, which the
// prologue fills with the matrix where C % 4 != 0 or mat is not 16-byte
// aligned (else unused, may be null); table (n_pad, 4): knots padded with
// +inf, their powers and the slopes of the segments they start; block_unit
// (n_blocks + 1), block_item (n_blocks), tile_item (ceil(T / 8) + 1): the
// work split of ops/megakernel.py; params: 12 floats in the order of
// Params; panel: (C, 4) scratch; part: (2, n_items, 8, B) scratch; out:
// (2, T, B); staged16 (may be null): set to 1 where the fields and the
// matrix are all staged by 16-byte copies, 0 where the fields' bases differ
// in their 16-byte phase.
int wind_pv_bus_launch(int device, const float* const* fields, const float* lat,
                       const float* mat, float* mat_pad, const float* table, int n_pad,
                       int n_knots, int T, int C, int B, const int* block_unit,
                       const int* block_item, const int* tile_item, int n_blocks, int n_items,
                       const float* params, float* panel, float* part, float* out,
                       void* stream, int* staged16) {
  if (n_knots < 2 || n_knots > n_pad || n_pad > kMaxKnots || (n_pad & (n_pad - 1)) != 0 ||
      T < 1 || C < 1 || B < 1 || n_blocks < 1 || n_items < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pad = C % 4 != 0 || (reinterpret_cast<uintptr_t>(mat) & 15u) != 0;
  if (pad && (mat_pad == nullptr || (reinterpret_cast<uintptr_t>(mat_pad) & 15u) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  Work w;
  bool same_phase = true;
  for (int f = 0; f < kNumFields; ++f) {
    w.F.f[f] = fields[f];
    same_phase = same_phase && ((reinterpret_cast<uintptr_t>(fields[f]) ^
                                 reinterpret_cast<uintptr_t>(fields[0])) & 15u) == 0;
  }
  w.panel = reinterpret_cast<const float4*>(panel);
  w.mat = pad ? mat_pad : mat;
  w.T = T;
  w.C = C;
  w.B = B;
  w.n_cb = (C + kCells - 1) / kCells;
  w.pitch = pad ? (C + 3) / 4 * 4 : C;
  w.phase = same_phase ? static_cast<int>((reinterpret_cast<uintptr_t>(fields[0]) & 15u) / 4) : -1;
  if (staged16 != nullptr) *staged16 = same_phase ? 1 : 0;
  const Params prm = {params[0], params[1], params[2], params[3],  params[4],  params[5],
                      params[6], params[7], params[8], params[9], params[10], params[11]};

  const long long n_pro = pad ? static_cast<long long>(B) * w.pitch : C;
  panel_kernel<<<static_cast<unsigned>((n_pro + 255) / 256), 256, 0, st>>>(
      lat, C, reinterpret_cast<float4*>(panel), mat, B, w.pitch, pad ? mat_pad : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // rows that may start off a 16-byte boundary are staged from the aligned
  // address below them (design note e)
  const bool lead = w.phase > 0 || (w.phase == 0 && C % 4 != 0);
  err = dispatch(lane_buses(B), [&](auto nbl) {
    constexpr int NBL = decltype(nbl)::value;
    return (lead ? launch<NBL, true> : launch<NBL, false>)(
        n_blocks, w, reinterpret_cast<const float4*>(table), n_pad, n_knots, block_unit,
        block_item, prm, n_items, part, st);
  });
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n = static_cast<long long>(T) * B;
  sum_items_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(part, n_items,
                                                                           tile_item, T, B, out);
  return static_cast<int>(cudaGetLastError());
}

const char* wind_pv_bus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
