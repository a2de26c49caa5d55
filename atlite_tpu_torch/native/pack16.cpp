// CF int16 packing of a streamed time chunk — the host half of the
// streamer's int16 upload (atlite_tpu_torch/cutout.py, Cutout._pack) in
// one pass over the host's cores.
//
// Every field of a chunk is cut into contiguous blocks, one a thread; each
// element takes the steps of the numpy loop it replaces, in its order:
//
//   v = double(x); v = log(v) in log space; v = v - offset; v = v / scale
//   (a true division); the NaN-ignoring min and max of v; code = v rounded
//   half to even (np.rint under the default rounding mode), clipped to
//   0..65534; 65535 where v is NaN.
//
// Built without -ffast-math and with -ffp-contract=off, so each step rounds
// as numpy's does and the codes are numpy's bit for bit.  In log space the
// log is the C library's: where it and numpy's differ by an ulp (numpy has
// its own SIMD log on some CPUs), a code can move only if that ulp crosses
// a half step.  The caller checks each field's (lo, hi) against its pack
// range.
//
// Compiled with g++ at first use into build/native/ and loaded via ctypes
// (atlite_tpu_torch/native/__init__.py), which releases the GIL during the
// call; the numpy loop in Cutout._pack is the fallback.

#include <cmath>
#include <cstdint>
#include <limits>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Range {
  double lo = kInf, hi = -kInf;  // both untouched: no value that is not NaN
};

template <typename T, bool kLog>
Range pack_block(const T* src, int64_t begin, int64_t end, double off, double scale,
                 uint16_t* dst) {
  Range r;
  for (int64_t i = begin; i < end; ++i) {
    double v = static_cast<double>(src[i]);
    if (kLog) v = std::log(v);
    v = v - off;
    v = v / scale;
    const bool nan = v != v;
    r.lo = v < r.lo ? v : r.lo;  // a NaN compares false: ignored
    r.hi = v > r.hi ? v : r.hi;
    // rint, then the clip: the same codes as the clip to 0..65534, then
    // rint, since both ends are whole and rounding keeps order; inside
    // 0..65534, adding and taking away 2^52 rounds half to even
    double c = v > 0.0 ? v : 0.0;
    c = c < 65534.0 ? c : 65534.0;
    c = (c + 0x1p52) - 0x1p52;
    dst[i] = nan ? uint16_t{65535} : static_cast<uint16_t>(static_cast<int32_t>(c));
  }
  return r;
}

Range pack_any(const void* src, bool is_double, bool log_space, int64_t begin, int64_t end,
               double off, double scale, uint16_t* dst) {
  if (is_double) {
    const double* s = static_cast<const double*>(src);
    return log_space ? pack_block<double, true>(s, begin, end, off, scale, dst)
                     : pack_block<double, false>(s, begin, end, off, scale, dst);
  }
  const float* s = static_cast<const float*>(src);
  return log_space ? pack_block<float, true>(s, begin, end, off, scale, dst)
                   : pack_block<float, false>(s, begin, end, off, scale, dst);
}

}  // namespace

extern "C" {

// Packs `nfields` fields of `n` elements each: src[f] (float64 where
// is_double[f], else float32; C-contiguous) into dst[f] (uint16) with
// (offset[f], scale[f], log_space[f]), on `threads` threads, each taking
// one contiguous block of every field.  lo[f] and hi[f] receive the
// NaN-ignoring min and max of the field's (value - offset) / scale, NaN
// where every value is NaN.
void pack16(int64_t nfields, int64_t n, const void* const* src, const uint8_t* is_double,
            const double* offset, const double* scale, const uint8_t* log_space,
            uint16_t* const* dst, int64_t threads, double* lo, double* hi) {
  if (threads > n) threads = n;
  if (threads < 1) threads = 1;
  std::vector<Range> ranges(static_cast<size_t>(threads * nfields));
  auto work = [&](int64_t t) {
    const int64_t begin = n * t / threads, end = n * (t + 1) / threads;
    for (int64_t f = 0; f < nfields; ++f)
      ranges[t * nfields + f] = pack_any(src[f], is_double[f] != 0, log_space[f] != 0, begin,
                                         end, offset[f], scale[f], dst[f]);
  };
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(threads - 1));
  int64_t next = 1;
  try {
    for (; next < threads; ++next) pool.emplace_back(work, next);
  } catch (const std::system_error&) {
    for (; next < threads; ++next) work(next);  // no thread to spare: the rest on this one
  }
  work(0);
  for (auto& th : pool) th.join();
  const double nan = std::numeric_limits<double>::quiet_NaN();
  for (int64_t f = 0; f < nfields; ++f) {
    Range all;
    for (int64_t t = 0; t < threads; ++t) {
      const Range& r = ranges[t * nfields + f];
      all.lo = r.lo < all.lo ? r.lo : all.lo;
      all.hi = r.hi > all.hi ? r.hi : all.hi;
    }
    const bool none = all.lo == kInf && all.hi == -kInf;
    lo[f] = none ? nan : all.lo;
    hi[f] = none ? nan : all.hi;
  }
}

}  // extern "C"
