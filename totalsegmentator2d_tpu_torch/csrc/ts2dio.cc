// ts2dio: the PyTorch package's native host library.
//
// The host-side hot paths beneath its IO and front end, bound through
// ctypes by io/native.py: gzip/zlib inflate and deflate for the NRRD, NIfTI
// and MetaImage payloads, and the fused coronal MAX + MEAN projection of an
// int16 CT. It is the package's own copy of the reference package's
// csrc/ts2dio.cc entry points of the same names (the package loads no
// library of the reference package). Built with the host C++ compiler at
// first use by ops/cuda/build.py:
//
//   g++ -O3 -fPIC -std=c++17 -shared -ffp-contract=off ts2dio.cc -lz
//
// Two deliberate differences from the reference's source:
//
// 1. Payloads of 4 GiB or more. z_stream's avail_in and avail_out are
//    32-bit; the reference casts size_t lengths into them, which silently
//    truncates a stream past 4 GiB. Here every stream is fed and drained in
//    windows of at most TS2DIO_CHUNK bytes (under 1 GiB), whatever its size.
// 2. The projection's mean divides: sum / ny in double, where the reference
//    multiplies by 1/ny. The division is the one rounding numpy's
//    mean(dtype=float64) and the package's device projection (a 64-bit sum
//    divided in float64) make, so the three agree bit for bit by
//    construction. The multiply differs from them in the last bit of the
//    double for many sums; for an int16 volume of any real depth the
//    rounding to float32 then hides it, an argument the division does not
//    need.
//
// Every function returns a negative value on failure, otherwise the number
// of bytes (or outputs) written.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

// the largest window handed to zlib at once; a build may set it smaller
// (the tests build one with a few KiB to drive many windows through a
// small payload)
#ifndef TS2DIO_CHUNK
#define TS2DIO_CHUNK (1u << 29)
#endif
static_assert(TS2DIO_CHUNK > 0 && TS2DIO_CHUNK < (1u << 30),
              "zlib windows stay under 1 GiB");

namespace {

constexpr size_t kChunk = TS2DIO_CHUNK;

// A byte range handed to zlib one window at a time.
struct Feed {
  const unsigned char* base;
  size_t len;
  size_t given = 0;  // bytes handed to zlib so far

  Feed(const void* p, size_t n)
      : base(static_cast<const unsigned char*>(p)), len(n) {}
  bool done() const { return given == len; }
  // the next window into (next, avail)
  void next(Bytef*& ptr, uInt& avail) {
    size_t n = std::min(len - given, kChunk);
    ptr = const_cast<Bytef*>(base + given);
    avail = static_cast<uInt>(n);
    given += n;
  }
};

// the input bytes zlib has not consumed yet
size_t unread(const z_stream& zs, const Feed& in) {
  return (in.len - in.given) + zs.avail_in;
}

}  // namespace

extern "C" {

// Behavioural version of this library's entry points; io/native.py uses
// the library only at the version it was written for.
long long ts2dio_abi_version(void) { return 1; }

// An upper bound for the inflated size of a gzip or zlib stream. A single
// gzip member's ISIZE trailer (the size mod 2^32) is trusted when it is
// under 1 GiB; otherwise a counting pass inflates the stream, members
// concatenated after the first included.
long long ts2dio_inflate_bound(const char* src, size_t src_len) {
  if (src_len < 2) return -1;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  if (s[0] == 0x1f && s[1] == 0x8b && src_len >= 18) {
    uint32_t isize;
    std::memcpy(&isize, src + src_len - 4, 4);
    if (isize > 0 && isize < (1u << 30)) return static_cast<long long>(isize);
  }
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 47) != Z_OK) return -1;  // 47: gzip or zlib
  Feed in(src, src_len);
  std::vector<unsigned char> buf(1 << 20);
  long long total = 0;
  for (;;) {
    if (zs.avail_in == 0 && !in.done()) in.next(zs.next_in, zs.avail_in);
    zs.next_out = buf.data();
    zs.avail_out = static_cast<uInt>(buf.size());
    int ret = inflate(&zs, Z_NO_FLUSH);
    total += static_cast<long long>(buf.size() - zs.avail_out);
    if (ret == Z_STREAM_END) {
      if (unread(zs, in) == 0) break;
      if (inflateReset2(&zs, 47) != Z_OK) break;  // the next member
      continue;
    }
    // no progress with input left to give is fine; without it the stream
    // is truncated
    if (ret == Z_BUF_ERROR && !(zs.avail_in == 0 && in.done())) continue;
    if (ret != Z_OK) {
      inflateEnd(&zs);
      return -1;
    }
  }
  inflateEnd(&zs);
  return total;
}

// Inflate a gzip (members concatenated) or zlib stream into dst. Fails
// when dst is too small for the whole stream, so that a caller whose bound
// came from the last member's ISIZE can fall back.
long long ts2dio_inflate(const char* src, size_t src_len,
                         char* dst, size_t dst_cap) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 47) != Z_OK) return -1;
  Feed in(src, src_len), out(dst, dst_cap);
  for (;;) {
    if (zs.avail_in == 0 && !in.done()) in.next(zs.next_in, zs.avail_in);
    if (zs.avail_out == 0 && !out.done()) out.next(zs.next_out, zs.avail_out);
    int ret = inflate(&zs, Z_NO_FLUSH);
    if (ret == Z_STREAM_END) {
      if (unread(zs, in) == 0) break;
      if (inflateReset2(&zs, 47) != Z_OK) {
        inflateEnd(&zs);
        return -1;
      }
      continue;
    }
    if (ret == Z_BUF_ERROR) {
      bool in_left = !(zs.avail_in == 0 && in.done());
      bool out_left = !(zs.avail_out == 0 && out.done());
      if (in_left && out_left) continue;
      inflateEnd(&zs);
      return -1;  // truncated stream, or dst too small
    }
    if (ret != Z_OK) {
      inflateEnd(&zs);
      return -1;
    }
  }
  long long got = static_cast<long long>(
      reinterpret_cast<char*>(zs.next_out) - dst);
  inflateEnd(&zs);
  return got;
}

static long long deflate_impl(const char* src, size_t src_len,
                              char* dst, size_t dst_cap,
                              int level, int window_bits) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (level < 0 || level > 9) level = 1;
  if (deflateInit2(&zs, level, Z_DEFLATED, window_bits, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  Feed in(src, src_len), out(dst, dst_cap);
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    if (zs.avail_in == 0 && !in.done()) in.next(zs.next_in, zs.avail_in);
    if (zs.avail_out == 0) {
      if (out.done()) {
        deflateEnd(&zs);
        return -1;  // dst too small
      }
      out.next(zs.next_out, zs.avail_out);
    }
    ret = deflate(&zs, in.done() ? Z_FINISH : Z_NO_FLUSH);
    if (ret == Z_STREAM_ERROR) {
      deflateEnd(&zs);
      return -1;
    }
  }
  long long got = static_cast<long long>(
      reinterpret_cast<char*>(zs.next_out) - dst);
  deflateEnd(&zs);
  return got;
}

long long ts2dio_deflate_gzip(const char* src, size_t src_len,
                              char* dst, size_t dst_cap, int level) {
  return deflate_impl(src, src_len, dst, dst_cap, level, 31);  // 31: gzip
}

long long ts2dio_deflate_zlib(const char* src, size_t src_len,
                              char* dst, size_t dst_cap, int level) {
  return deflate_impl(src, src_len, dst, dst_cap, level, 15);  // 15: zlib
}

// The fused coronal projection: a (Z, Y, X) C-order int16 volume to the
// per-(z, x) MAX and MEAN along Y, in one pass. int16 maxima and int64 sums
// vectorize, and the int64 sum is exact (|sum| <= ny * 32768); the mean is
// that sum divided by ny in double, rounded once to float32.
long long ts2dio_project_max_mean_i16(const int16_t* vol, long long nz,
                                      long long ny, long long nx,
                                      float* out_max, float* out_mean) {
  if (nz <= 0 || ny <= 0 || nx <= 0) return -1;
  std::vector<int16_t> mx(static_cast<size_t>(nx));
  std::vector<long long> sum(static_cast<size_t>(nx));
  const double n = static_cast<double>(ny);
  for (long long z = 0; z < nz; ++z) {
    const int16_t* first = vol + (z * ny) * nx;
    for (long long x = 0; x < nx; ++x) {
      mx[x] = first[x];
      sum[x] = first[x];
    }
    for (long long y = 1; y < ny; ++y) {
      const int16_t* row = vol + (z * ny + y) * nx;
      int16_t* __restrict m = mx.data();
      long long* __restrict a = sum.data();
      for (long long x = 0; x < nx; ++x) {
        int16_t v = row[x];
        m[x] = v > m[x] ? v : m[x];  // branchless: a SIMD max
        a[x] += v;
      }
    }
    float* om = out_max + z * nx;
    float* oe = out_mean + z * nx;
    for (long long x = 0; x < nx; ++x) {
      om[x] = static_cast<float>(mx[x]);
      // divide, as numpy and the device projection do (see the top)
      oe[x] = static_cast<float>(static_cast<double>(sum[x]) / n);
    }
  }
  return nz * nx;
}

}  // extern "C"
