// ts2dio: the PyTorch package's native host library.
//
// The host-side hot paths beneath its IO and front end, bound through
// ctypes by io/native.py: gzip/zlib inflate and deflate for the NRRD, NIfTI
// and MetaImage payloads, the fused coronal MAX + MEAN projection of an
// int16 CT, the unpack of a scan's packed masks into its Result's arrays
// and the populated mappings those arrays live in, and the serial hot loops of the DICOM codecs (the JPEG Lossless
// and sequential-DCT Huffman decoders and the DCT reconstruction, the
// JPEG-LS scan decoder, the JPEG 2000 Tier-1 block decoder and inverse
// DWTs; io/jpegll.py, jpegdct.py, jpegls.py, jpeg2k.py). It is the
// package's own copy of the reference package's csrc/ts2dio.cc entry points
// of the same names (the package loads no library of the reference
// package). Built with the host C++ compiler at first use by
// ops/cuda/build.py:
//
//   g++ -O3 -fPIC -std=c++17 -shared -ffp-contract=off -pthread ts2dio.cc -lz
//
// -ffp-contract=off is load-bearing: the 9/7 inverse DWT's doubles must
// round exactly like numpy's elementwise operations (no FMA contraction),
// so the native and the Python decodes stay bit for bit equal; for the
// same reason the build adds no -march flag.
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
#include <cmath>
#include <cstdint>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>
#include <sys/mman.h>
#include <unistd.h>
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

// The projection of z slices [z0, z1) into their rows of out_max and
// out_mean. int16 maxima and column sums vectorize; the sums are exact in
// Acc: int32 while ny * 32768 < 2^31 (ny <= 65535), int64 beyond. The mean
// is the sum divided by ny in double, rounded once to float32.
template <typename Acc>
void project_slab_as(const int16_t* vol, long long z0, long long z1,
                     long long ny, long long nx, float* out_max,
                     float* out_mean) {
  std::vector<int16_t> mx(static_cast<size_t>(nx));
  std::vector<Acc> sum(static_cast<size_t>(nx));
  const double n = static_cast<double>(ny);
  for (long long z = z0; z < z1; ++z) {
    const int16_t* first = vol + (z * ny) * nx;
    for (long long x = 0; x < nx; ++x) {
      mx[x] = first[x];
      sum[x] = first[x];
    }
    for (long long y = 1; y < ny; ++y) {
      const int16_t* row = vol + (z * ny + y) * nx;
      int16_t* __restrict m = mx.data();
      Acc* __restrict a = sum.data();
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
}

void project_slab(const int16_t* vol, long long z0, long long z1,
                  long long ny, long long nx, float* out_max,
                  float* out_mean) {
  if (ny <= 65535)  // |sum| <= 65535 * 32768 < 2^31
    project_slab_as<int32_t>(vol, z0, z1, ny, nx, out_max, out_mean);
  else
    project_slab_as<long long>(vol, z0, z1, ny, nx, out_max, out_mean);
}

}  // namespace

extern "C" {

// Behavioural version of this library's entry points; io/native.py uses
// the library only at the version it was written for (2: the codec entry
// points, whose truncated-entropy streams return -4; 3: the projection
// threaded over z slabs, ts2dio_project_max_mean_i16_mt; 4: the Result's
// masks unpacked, placed and split in one threaded pass,
// ts2dio_assemble_masks_mt; 5: the populated mappings of the Result's
// arrays, ts2dio_map_pages and ts2dio_unmap_pages).
long long ts2dio_abi_version(void) { return 5; }

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
// per-(z, x) MAX and MEAN along Y, in one pass over ``threads`` contiguous
// z slabs, one per thread (the calling thread takes the first; at most one
// slab a slice). Each thread owns its accumulators and writes its own
// output rows, with no reduction across threads, so the result is bit for
// bit the same for every thread count. A thread the system refuses to
// start leaves its slab to the calling thread.
long long ts2dio_project_max_mean_i16_mt(const int16_t* vol, long long nz,
                                         long long ny, long long nx,
                                         float* out_max, float* out_mean,
                                         long long threads) {
  if (nz <= 0 || ny <= 0 || nx <= 0 || threads <= 0) return -1;
  threads = std::min(threads, nz);
  const long long per = nz / threads, rem = nz % threads;
  auto slab = [&](long long i) {
    const long long z0 = i * per + std::min(i, rem);
    const long long z1 = z0 + per + (i < rem ? 1 : 0);
    project_slab(vol, z0, z1, ny, nx, out_max, out_mean);
  };
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(threads - 1));
  for (long long i = 1; i < threads; ++i) {
    try {
      pool.emplace_back(slab, i);
    } catch (const std::system_error&) {
      slab(i);
    }
  }
  slab(0);
  for (std::thread& t : pool) t.join();
  return nz * nx;
}

// The same pass on the calling thread alone: the entry point of ABI 2.
long long ts2dio_project_max_mean_i16(const int16_t* vol, long long nz,
                                      long long ny, long long nx,
                                      float* out_max, float* out_mean) {
  return ts2dio_project_max_mean_i16_mt(vol, nz, ny, nx, out_max, out_mean,
                                        1);
}

// The Result's masks in one pass: the packed (h, w, nb) crop of a scan's
// masks (bit c of label channel c in byte c / 8, little bit order) to one
// byte a label in the full (H, W) frame, the crop at (y0, x0) and zero
// around it, written straight into the merged (H, W, L) array (``merged``,
// may be null) and into each of ``n_groups`` (H, W, counts[g]) arrays
// (``outs[g]``), group g holding label channels [sum(counts[:g]),
// sum(counts[:g + 1])) and L = sum(counts). ``src`` is the crop's first
// byte and ``src_row`` the bytes between its rows (a window of a larger
// canvas, or one scan of a batch); each pixel's nb bytes are contiguous.
// The full frame's rows are split into ``threads`` contiguous bands, one a
// thread (the calling thread takes the first); each thread writes every
// byte of its rows of every output, zeros included, so no byte is written
// by two threads and the output is the same for every thread count. A
// thread the system refuses to start leaves its band to the calling
// thread.
// Returns H * W, or -1 for arguments that do not describe such a layout.
long long ts2dio_assemble_masks_mt(const uint8_t* src, long long src_row,
                                   long long nb, long long h, long long w,
                                   long long y0, long long x0, long long H,
                                   long long W, const long long* counts,
                                   long long n_groups, uint8_t* merged,
                                   uint8_t* const* outs, long long threads) {
  if (nb <= 0 || h <= 0 || w <= 0 || H <= 0 || W <= 0 || n_groups <= 0 ||
      threads <= 0 || src_row < w * nb || y0 < 0 || x0 < 0 ||
      y0 + h > H || x0 + w > W)
    return -1;
  long long L = 0;
  for (long long g = 0; g < n_groups; ++g) {
    if (counts[g] <= 0) return -1;
    L += counts[g];
  }
  if (L > nb * 8) return -1;
  // byte -> its 8 bits as 8 bytes of 0 / 1, in bit order
  static const auto bits = [] {
    std::vector<uint8_t> t(256 * 8);
    for (int b = 0; b < 256; ++b)
      for (int i = 0; i < 8; ++i) t[b * 8 + i] = (b >> i) & 1;
    return t;
  }();
  threads = std::min(threads, H);
  const long long per = H / threads, rem = H % threads;
  // every output as (base, bytes a pixel, its first label channel)
  std::vector<uint8_t*> base;
  std::vector<long long> width, first;
  if (merged != nullptr) {
    base.push_back(merged);
    width.push_back(L);
    first.push_back(0);
  }
  for (long long g = 0, at = 0; g < n_groups; at += counts[g++]) {
    base.push_back(outs[g]);
    width.push_back(counts[g]);
    first.push_back(at);
  }
  auto band = [&](long long i) {
    const long long r0 = i * per + std::min(i, rem);
    const long long r1 = r0 + per + (i < rem ? 1 : 0);
    // a crop row's labels, 8 * nb bytes a pixel, and 8 bytes that the word
    // copies below may read past them
    std::vector<uint8_t> labels(static_cast<size_t>(w * nb * 8 + 8));
    uint8_t* const lab = labels.data();
    const uint8_t* const lut = bits.data();
    for (long long y = r0; y < r1; ++y) {
      const bool inside = y >= y0 && y < y0 + h;
      if (inside) {
        const uint8_t* in = src + (y - y0) * src_row;
        for (long long k = 0; k < w * nb; ++k)
          std::memcpy(lab + k * 8, lut + in[k] * 8, 8);
      }
      for (size_t o = 0; o < base.size(); ++o) {
        const long long n = width[o];
        uint8_t* const row = base[o] + y * W * n;
        if (!inside) {
          std::memset(row, 0, static_cast<size_t>(W * n));
          continue;
        }
        std::memset(row, 0, static_cast<size_t>(x0 * n));
        std::memset(row + (x0 + w) * n, 0,
                    static_cast<size_t>((W - x0 - w) * n));
        uint8_t* dst = row + x0 * n;
        const uint8_t* from = lab + first[o];
        // whole words while the last word's up to 7 bytes past a pixel
        // land in the labels of the row's next pixels, which those pixels
        // then write; the row's last pixels copy their own bytes alone
        const long long words = std::max(0LL, w - (7 + n - 1) / n);
        for (long long x = 0; x < words; ++x, dst += n, from += nb * 8)
          for (long long k = 0; k < n; k += 8)
            std::memcpy(dst + k, from + k, 8);
        for (long long x = words; x < w; ++x, dst += n, from += nb * 8)
          std::memcpy(dst, from, static_cast<size_t>(n));
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(threads - 1));
  for (long long i = 1; i < threads; ++i) {
    try {
      pool.emplace_back(band, i);
    } catch (const std::system_error&) {
      band(i);
    }
  }
  band(0);
  for (std::thread& t : pool) t.join();
  return H * W;
}

// The memory of one of a Result's mask arrays, mapped before the pass
// writes it: a private anonymous mapping of ``size`` bytes, readable and
// writable, whose pages are populated ``chunk`` bytes at a time (rounded up
// to whole pages), each chunk mapped again over the first mapping with
// MAP_FIXED | MAP_POPULATE. A populate holds the process's memory map for
// its chunk, so another thread's faults and mappings wait for at most one
// chunk. Returns the mapping's address, or null when the system refuses a
// mapping (nothing stays mapped then). ts2dio_unmap_pages releases it.
void* ts2dio_map_pages(long long size, long long chunk) {
  if (size <= 0) return nullptr;
#ifdef MAP_POPULATE
  const int populate = MAP_POPULATE;
#else
  const int populate = 0;
#endif
  const int prot = PROT_READ | PROT_WRITE;
  const int flags = MAP_PRIVATE | MAP_ANONYMOUS;
  const size_t bytes = static_cast<size_t>(size);
  const long long page = sysconf(_SC_PAGESIZE) > 0 ? sysconf(_SC_PAGESIZE)
                                                   : 4096;
  chunk = std::max(page, (std::min(chunk, size) + page - 1) / page * page);
  void* p = mmap(nullptr, bytes, prot, flags, -1, 0);
  if (p == MAP_FAILED) return nullptr;
  uint8_t* const base = static_cast<uint8_t*>(p);
  for (long long at = 0; at < size; at += chunk) {
    const size_t n = static_cast<size_t>(std::min(chunk, size - at));
    if (mmap(base + at, n, prot, flags | MAP_FIXED | populate, -1, 0) ==
        MAP_FAILED) {
      munmap(p, bytes);
      return nullptr;
    }
  }
  return p;
}

// Unmap what ts2dio_map_pages mapped. Returns 0, or -1 where the system
// refuses.
long long ts2dio_unmap_pages(void* addr, long long size) {
  return munmap(addr, static_cast<size_t>(size)) == 0 ? 0 : -1;
}

// ---------------------------------------------------------------------------
// JPEG Lossless (T.81 process 14) difference-stream decoder: the serial
// Huffman hot loop of io/jpegll.py. ``lut`` is the 64k-entry peek table
// (lut[next16bits] = (SSSS << 5) | code_length) built on the Python side
// from the DHT segment; ``seg`` is one unstuffed entropy segment (FF00
// resolved, RSTn removed). Returns ``count`` on success, -1 on an invalid
// code. Reconstruction (predictors/cumsum) stays in numpy — it is already
// vectorized there and depends on scan parameters this function need not
// know about. Returns -4 when the segment ends before ``count`` samples
// are coded (zero-pad bits, pushed only after the real bytes ran out, got
// consumed — decoding them would fabricate pixels from a truncated file).

long long ts2dio_jpegll_decode_diffs(const char* seg, size_t seg_len,
                                     const uint32_t* lut, int32_t* out,
                                     long long count) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(seg);
  uint64_t acc = 0;
  int nbits = 0;
  int pad_bits = 0;
  size_t pos = 0;
  for (long long i = 0; i < count; ++i) {
    while (nbits < 32) {
      if (pos < seg_len) {
        acc = (acc << 8) | s[pos++];
      } else {
        acc <<= 8;
        pad_bits += 8;
      }
      nbits += 8;
    }
    uint32_t entry = lut[(acc >> (nbits - 16)) & 0xFFFF];
    int len = static_cast<int>(entry & 0x1F);
    if (len == 0) return -1;  // invalid code
    int ssss = static_cast<int>(entry >> 5);
    nbits -= len;
    if (ssss == 0) {
      out[i] = 0;
    } else if (ssss == 16) {
      out[i] = 32768;
    } else {
      uint32_t extra =
          static_cast<uint32_t>((acc >> (nbits - ssss)) & ((1u << ssss) - 1));
      nbits -= ssss;
      // T.81 "extend": the low half of each category codes negatives
      out[i] = (extra < (1u << (ssss - 1)))
                   ? static_cast<int32_t>(extra) - ((1 << ssss) - 1)
                   : static_cast<int32_t>(extra);
    }
    acc &= (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
  }
  if (pad_bits > nbits) return -4;  // truncated entropy segment
  return count;
}

// ---------------------------------------------------------------------------
// Sequential-DCT JPEG (T.81 processes 1-2) block decoder: the serial
// Huffman hot loop of io/jpegdct.py. ``dc_lut``/``ac_lut`` are 64k-entry
// peek tables (lut[next16bits] = (symbol << 5) | code_length) built on the
// Python side; ``seg`` is one unstuffed entropy segment. ``out`` is an
// (nblocks, 64) int32 array, ZEROED by the caller, receiving quantized
// coefficients in zigzag order with DC prediction applied. Returns
// ``nblocks`` on success, -2 on an invalid Huffman code, -3 on an AC run
// past the end of a block, -4 on a truncated entropy segment (zero-pad
// bits got consumed). Dequantization/IDCT stay in numpy — vectorized
// over all blocks at once.

long long ts2dio_jpegdct_decode_blocks(const char* seg, size_t seg_len,
                                       const uint32_t* dc_lut,
                                       const uint32_t* ac_lut, int32_t* out,
                                       long long nblocks) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(seg);
  uint64_t acc = 0;
  int nbits = 0;
  int pad_bits = 0;
  size_t pos = 0;
  int32_t pred = 0;
  for (long long b = 0; b < nblocks; ++b) {
    int32_t* row = out + b * 64;
    // DC coefficient: category + extend
    while (nbits < 32) {
      if (pos < seg_len) {
        acc = (acc << 8) | s[pos++];
      } else {
        acc <<= 8;
        pad_bits += 8;
      }
      nbits += 8;
    }
    uint32_t entry = dc_lut[(acc >> (nbits - 16)) & 0xFFFF];
    int len = static_cast<int>(entry & 0x1F);
    if (len == 0) return -2;
    int ssss = static_cast<int>(entry >> 5);
    nbits -= len;
    if (ssss) {
      uint32_t extra =
          static_cast<uint32_t>((acc >> (nbits - ssss)) & ((1u << ssss) - 1));
      nbits -= ssss;
      pred += (extra < (1u << (ssss - 1)))
                  ? static_cast<int32_t>(extra) - ((1 << ssss) - 1)
                  : static_cast<int32_t>(extra);
    }
    row[0] = pred;
    // AC coefficients: (run, size) pairs until EOB or k = 63
    int k = 1;
    while (k < 64) {
      while (nbits < 32) {
        if (pos < seg_len) {
          acc = (acc << 8) | s[pos++];
        } else {
          acc <<= 8;
          pad_bits += 8;
        }
        nbits += 8;
      }
      entry = ac_lut[(acc >> (nbits - 16)) & 0xFFFF];
      len = static_cast<int>(entry & 0x1F);
      if (len == 0) return -2;
      int sym = static_cast<int>(entry >> 5);
      nbits -= len;
      int run = sym >> 4;
      int size = sym & 0x0F;
      if (size == 0) {
        if (run == 15) {  // ZRL: sixteen zeros
          k += 16;
          continue;
        }
        break;  // EOB
      }
      k += run;
      if (k > 63) return -3;
      uint32_t extra =
          static_cast<uint32_t>((acc >> (nbits - size)) & ((1u << size) - 1));
      nbits -= size;
      row[k] = (extra < (1u << (size - 1)))
                   ? static_cast<int32_t>(extra) - ((1 << size) - 1)
                   : static_cast<int32_t>(extra);
      ++k;
    }
    acc &= (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1);
  }
  if (pad_bits > nbits) return -4;  // truncated entropy segment
  return nblocks;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG 2000 Tier-1 (EBCOT) code-block decoder: the serial MQ/coding-pass
// hot loop of io/jpeg2k.py -- a byte-exact port of that file's
// _MQDecoder/_BlockDecoder (T.800 Annexes C and D). Packet parsing,
// dequantization and the inverse DWT stay in numpy. The significance
// context table row (75 entries, for this block's subband orientation)
// and the 9-pair sign LUT are built on the Python side and passed in.

namespace j2k {

struct MQTableRow {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

static const MQTableRow kMQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { kCtxRL = 17, kCtxUNI = 18, kNCtx = 19 };

struct MQDecoder {
  const unsigned char* data;
  size_t len, bp;
  uint32_t c, a;
  int ct;

  void bytein() {
    unsigned b = bp < len ? data[bp] : 0xFF;
    if (b == 0xFF) {
      unsigned b1 = bp + 1 < len ? data[bp + 1] : 0xFF;
      if (b1 > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp += 1;
        c += b1 << 9;
        ct = 7;
      }
    } else {
      bp += 1;
      unsigned b1 = bp < len ? data[bp] : 0xFF;
      c += b1 << 8;
      ct = 8;
    }
  }

  void init(const unsigned char* d, size_t n) {
    data = d;
    len = n;
    bp = 0;
    c = static_cast<uint32_t>(n ? d[0] : 0xFF) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  int decode(uint8_t* st) {  // st = {state, mps}
    const MQTableRow& row = kMQ[st[0]];
    uint32_t qe = row.qe;
    a -= qe;
    int d;
    // the MPS-without-renormalization exit dominates real streams; tell
    // the compiler so the hot path is the fallthrough
    if (__builtin_expect(((c >> 16) & 0xFFFF) < qe, 0)) {
      if (a < qe) {  // LPS exchange
        d = st[1];
        st[0] = row.nmps;
      } else {
        d = 1 - st[1];
        if (row.sw) st[1] ^= 1;
        st[0] = row.nlps;
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (__builtin_expect(a & 0x8000, 1)) return st[1];
      if (a < qe) {  // MPS exchange
        d = 1 - st[1];
        if (row.sw) st[1] ^= 1;
        st[0] = row.nlps;
      } else {
        d = st[1];
        st[0] = row.nmps;
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct -= 1;
    } while (!(a & 0x8000));
    return d;
  }
};

template <bool CAUSAL>
struct T1 {
  long long w, h;
  int style;
  const uint8_t* sig_tab;   // 75 entries for this orientation
  const uint8_t* sign_lut;  // 9 x (ctx, xor)
  // One flags word per coefficient, padded by one on every border:
  //   bits 0-6  incrementally maintained neighborhood index h*25+v*5+d
  //             (updated once when a neighbor becomes significant; the
  //             counts have natural maxima 2/2/4, so the packed sum
  //             never exceeds 64 and adds cannot carry into bit 7)
  //   bit 7     significant
  //   bit 8     sign (negative)
  //   bit 9     visited in this plane's significance pass
  //   bit 10    refined at least once
  // A single load serves every per-visit test, instead of five arrays.
  // The incremental index is not usable with the vertically-causal
  // style, whose context must EXCLUDE the row below on stripe row 3 —
  // causal blocks recompute from the sig bits.
  enum : uint16_t {
    kIdx = 0x7F, kSig = 1 << 7, kNeg = 1 << 8, kVis = 1 << 9, kRef = 1 << 10
  };
  std::vector<uint16_t> f;
  int32_t* mag;
  int32_t* lastp;
  uint8_t ctx[kNCtx][2];

  T1(long long w_, long long h_, int style_, const uint8_t* st,
     const uint8_t* sl, int32_t* m, int32_t* lp)
      : w(w_), h(h_), style(style_), sig_tab(st), sign_lut(sl),
        f((h_ + 2) * (w_ + 2), 0), mag(m), lastp(lp) {
    fresh_contexts();
  }

  void fresh_contexts() {
    for (int i = 0; i < kNCtx; ++i) {
      ctx[i][0] = 0;
      ctx[i][1] = 0;
    }
    ctx[kCtxUNI][0] = 46;
    ctx[kCtxRL][0] = 3;
    ctx[0][0] = 4;
  }

  uint16_t& F(long long y, long long x) { return f[(y + 1) * (w + 2) + x + 1]; }

  // neighborhood index for context formation: incremental in the common
  // case, recomputed (with the row below masked on stripe row 3) for
  // vertically-causal blocks (CAUSAL is a compile-time specialization:
  // the common non-causal path is a single masked load)
  int nb_index(long long y, long long x, uint16_t v) {
    if (!CAUSAL) return v & kIdx;
    int below = ((y & 3) == 3) ? 0 : 1;
    const uint16_t* c = &F(y, x);
    const long long row = w + 2;
    int hh = ((c[-1] & kSig) != 0) + ((c[+1] & kSig) != 0);
    int vv = ((c[-row] & kSig) != 0) + (below ? ((c[+row] & kSig) != 0) : 0);
    int dd = ((c[-row - 1] & kSig) != 0) + ((c[-row + 1] & kSig) != 0) +
             (below ? ((c[+row - 1] & kSig) != 0) +
                          ((c[+row + 1] & kSig) != 0)
                    : 0);
    return hh * 25 + vv * 5 + dd;
  }

  void mark_significant(long long y, long long x) {
    uint16_t* c = &F(y, x);
    const long long row = w + 2;
    *c |= kSig;
    c[-1] += 25;        // left/right neighbors gain a horizontal count
    c[+1] += 25;
    c[-row] += 5;       // up/down gain a vertical count
    c[+row] += 5;
    c[-row - 1] += 1;   // diagonals
    c[-row + 1] += 1;
    c[+row - 1] += 1;
    c[+row + 1] += 1;
  }

  int decode_sign(MQDecoder& mq, long long y, long long x) {
    int below = (CAUSAL && ((y & 3) == 3)) ? 0 : 1;
    const uint16_t* c = &F(y, x);
    const long long row = w + 2;
    auto contrib = [](uint16_t v) -> int {
      if (!(v & kSig)) return 0;
      return (v & kNeg) ? -1 : 1;
    };
    int hc = contrib(c[-1]) + contrib(c[+1]);
    int vc = contrib(c[-row]) + (below ? contrib(c[+row]) : 0);
    hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
    vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
    const uint8_t* e = sign_lut + 2 * ((hc + 1) * 3 + (vc + 1));
    return mq.decode(ctx[e[0]]) ^ e[1];
  }

  inline void sig_visit(MQDecoder& mq, int32_t bit, int p, long long y,
                        long long x) {
    uint16_t v = F(y, x);
    if (v & kSig) return;
    int ni = nb_index(y, x, v);
    if (ni == 0) return;  // no significant neighbor: cleanup's job
    F(y, x) = v | kVis;
    if (mq.decode(ctx[sig_tab[ni]])) {
      mark_significant(y, x);
      mag[y * w + x] |= bit;
      lastp[y * w + x] = p;
      if (decode_sign(mq, y, x)) F(y, x) |= kNeg;
    }
  }

  void pass_sig(MQDecoder& mq_io, int p) {
    // by-value MQ copy: the coder registers (c/a/ct) live in machine
    // registers for the whole pass instead of being spilled around every
    // uint8_t context-state write (which may alias struct members).
    // Full 4-row stripes run an unrolled column body (no per-row bound
    // checks); the remainder stripe loops.
    MQDecoder mq = mq_io;
    int32_t bit = 1 << p;
    for (long long y0 = 0; y0 + 4 <= h; y0 += 4)
      for (long long x = 0; x < w; ++x) {
        sig_visit(mq, bit, p, y0, x);
        sig_visit(mq, bit, p, y0 + 1, x);
        sig_visit(mq, bit, p, y0 + 2, x);
        sig_visit(mq, bit, p, y0 + 3, x);
      }
    if (h & 3)
      for (long long x = 0; x < w; ++x)
        for (long long y = h & ~3LL; y < h; ++y) sig_visit(mq, bit, p, y, x);
    mq_io = mq;
  }

  inline void ref_visit(MQDecoder& mq, int32_t bit, int p, long long y,
                        long long x) {
    uint16_t v = F(y, x);
    if (!(v & kSig) || (v & kVis)) return;
    int cx;
    if (v & kRef) {
      cx = 16;
    } else {
      cx = nb_index(y, x, v) ? 15 : 14;
      F(y, x) = v | kRef;
    }
    lastp[y * w + x] = p;
    if (mq.decode(ctx[cx])) mag[y * w + x] |= bit;
  }

  void pass_ref(MQDecoder& mq_io, int p) {
    MQDecoder mq = mq_io;
    int32_t bit = 1 << p;
    for (long long y0 = 0; y0 + 4 <= h; y0 += 4)
      for (long long x = 0; x < w; ++x) {
        ref_visit(mq, bit, p, y0, x);
        ref_visit(mq, bit, p, y0 + 1, x);
        ref_visit(mq, bit, p, y0 + 2, x);
        ref_visit(mq, bit, p, y0 + 3, x);
      }
    if (h & 3)
      for (long long x = 0; x < w; ++x)
        for (long long y = h & ~3LL; y < h; ++y) ref_visit(mq, bit, p, y, x);
    mq_io = mq;
  }

  inline void cln_visit(MQDecoder& mq, int32_t bit, int p, long long y,
                        long long x) {
    uint16_t v = F(y, x);
    if (v & (kVis | kSig)) {
      F(y, x) = v & ~kVis;
      return;
    }
    int ni = nb_index(y, x, v);
    if (mq.decode(ctx[sig_tab[ni]])) {
      mark_significant(y, x);
      mag[y * w + x] |= bit;
      lastp[y * w + x] = p;
      if (decode_sign(mq, y, x)) F(y, x) |= kNeg;
    }
  }

  // returns 0, or -3 on a segmentation-symbol mismatch
  int pass_cleanup(MQDecoder& mq_io, int p) {
    MQDecoder mq = mq_io;
    int32_t bit = 1 << p;
    for (long long y0 = 0; y0 + 4 <= h; y0 += 4)
      for (long long x = 0; x < w; ++x) {
        long long y = y0;
        // run-length mode when all four rows are insignificant,
        // unvisited, and have no significant neighbor; non-causal
        // blocks test that with one OR over the four flags words
        bool rl;
        if (!CAUSAL) {
          rl = ((F(y0, x) | F(y0 + 1, x) | F(y0 + 2, x) | F(y0 + 3, x)) &
                (kVis | kSig | kIdx)) == 0;
        } else {
          rl = true;
          for (long long yy = y0; yy < y0 + 4; ++yy) {
            uint16_t v = F(yy, x);
            if ((v & (kVis | kSig)) || nb_index(yy, x, v) != 0) {
              rl = false;
              break;
            }
          }
        }
        if (rl) {
          if (!mq.decode(ctx[kCtxRL])) continue;  // column stays zero
          int r = (mq.decode(ctx[kCtxUNI]) << 1) | mq.decode(ctx[kCtxUNI]);
          y = y0 + r;
          mark_significant(y, x);
          mag[y * w + x] |= bit;
          lastp[y * w + x] = p;
          if (decode_sign(mq, y, x)) F(y, x) |= kNeg;
          y += 1;
        }
        for (long long yy = y; yy < y0 + 4; ++yy) cln_visit(mq, bit, p, yy, x);
      }
    if (h & 3)
      for (long long x = 0; x < w; ++x)
        for (long long yy = h & ~3LL; yy < h; ++yy) cln_visit(mq, bit, p, yy, x);
    for (auto& v : f) v &= static_cast<uint16_t>(~kVis);
    if (style & 0x20) {  // segmentation symbols: 1010 in the UNI context
      int sym = 0;
      for (int i = 0; i < 4; ++i) sym = (sym << 1) | mq.decode(ctx[kCtxUNI]);
      if (sym != 0x0A) {
        mq_io = mq;
        return -3;
      }
    }
    mq_io = mq;
    return 0;
  }
};

template <bool CAUSAL>
static long long t1_exec(T1<CAUSAL>& t1, const unsigned char* data,
                         const long long* seg_lens,
                         const long long* seg_passes, long long nsegs,
                         long long style, long long start_plane) {
  const bool term_each = style & 0x04;
  const bool reset = style & 0x02;
  long long total = 0;
  for (long long i = 0; i < nsegs; ++i) total += seg_passes[i];
  MQDecoder mq;
  bool mq_live = false;
  const unsigned char* seg_ptr = data;
  long long seg_i = 0, seg_left = 0;
  int plane = static_cast<int>(start_plane);
  long long passes_done = 0;
  for (long long k = 0; k < total; ++k) {
    if (seg_left == 0) {
      if (reset && mq_live) t1.fresh_contexts();
      mq.init(seg_ptr, static_cast<size_t>(seg_lens[seg_i]));
      mq_live = true;
      seg_ptr += seg_lens[seg_i];
      seg_left = seg_passes[seg_i];
      seg_i += 1;
    } else if (term_each) {
      return -10;  // termination bookkeeping out of sync
    }
    if (plane < 0) return -2;
    if (passes_done == 0) {
      int rc = t1.pass_cleanup(mq, plane);
      if (rc) return rc;
      plane -= 1;
    } else {
      switch ((passes_done - 1) % 3) {
        case 0:
          t1.pass_sig(mq, plane);
          break;
        case 1:
          t1.pass_ref(mq, plane);
          break;
        default: {
          int rc = t1.pass_cleanup(mq, plane);
          if (rc) return rc;
          plane -= 1;
        }
      }
    }
    passes_done += 1;
    seg_left -= 1;
    if (reset && seg_left) t1.fresh_contexts();
  }
  return passes_done;
}

template <bool CAUSAL>
static long long t1_run(const unsigned char* data, const long long* seg_lens,
                        const long long* seg_passes, long long nsegs,
                        long long w, long long h, long long style,
                        long long start_plane, const unsigned char* sig_tab,
                        const unsigned char* sign_lut, int32_t* mag,
                        int32_t* lastp, uint8_t* signs) {
  T1<CAUSAL> t1(w, h, static_cast<int>(style), sig_tab, sign_lut, mag, lastp);
  long long rc = t1_exec(t1, data, seg_lens, seg_passes, nsegs, style,
                         start_plane);
  if (rc < 0) return rc;
  for (long long y = 0; y < h; ++y)
    for (long long x = 0; x < w; ++x)
      signs[y * w + x] = (t1.F(y, x) & T1<CAUSAL>::kNeg) ? 1 : 0;
  return rc;
}

// Decode + reconstruct in one native call, writing the final coefficient
// values straight into the destination band region (stride in elements).
// Same arithmetic as _BlockDecoder.values + the dequantization in
// _decode_tile: midpoint reconstruction adds half of 2^lastp to every
// significant magnitude; the irreversible path multiplies by delta after
// (one rounding, matching numpy's (mag + half) * delta order).
template <bool CAUSAL>
static long long t1_block(const unsigned char* data, const long long* seg_lens,
                          const long long* seg_passes, long long nsegs,
                          long long w, long long h, long long style,
                          long long start_plane,
                          const unsigned char* sig_tab,
                          const unsigned char* sign_lut, long long reversible,
                          double delta, void* dst, long long dst_stride) {
  std::vector<int32_t> mag(w * h, 0), lastp(w * h, 0);
  T1<CAUSAL> t1(w, h, static_cast<int>(style), sig_tab, sign_lut, mag.data(),
                lastp.data());
  long long rc = t1_exec(t1, data, seg_lens, seg_passes, nsegs, style,
                         start_plane);
  if (rc < 0) return rc;
  if (reversible) {
    int64_t* out = static_cast<int64_t*>(dst);
    for (long long y = 0; y < h; ++y)
      for (long long x = 0; x < w; ++x) {
        int64_t m = mag[y * w + x];
        if (m > 0) m += (static_cast<int64_t>(1) << lastp[y * w + x]) >> 1;
        out[y * dst_stride + x] = (t1.F(y, x) & T1<CAUSAL>::kNeg) ? -m : m;
      }
  } else {
    double* out = static_cast<double*>(dst);
    for (long long y = 0; y < h; ++y)
      for (long long x = 0; x < w; ++x) {
        int32_t m = mag[y * w + x];
        double v = static_cast<double>(m);
        if (m > 0) v += 0.5 * std::exp2(static_cast<double>(lastp[y * w + x]));
        v *= delta;
        out[y * dst_stride + x] = (t1.F(y, x) & T1<CAUSAL>::kNeg) ? -v : v;
      }
  }
  return rc;
}

}  // namespace j2k

extern "C" {

// Decodes one code block's coding passes. ``data`` holds the
// concatenated codeword-segment bytes; ``seg_lens``/``seg_passes``
// (nsegs entries) split it exactly as io/jpeg2k.py's _BlockDecoder.run
// receives them (already merged across quality layers unless the
// termination-on-each-pass style bit is set). ``sig_tab`` is the
// 75-entry significance-context row for the block's subband
// orientation; ``sign_lut`` the 9 x (context, xor) sign table. ``mag``,
// ``lastp`` (both int32, zeroed) and ``signs`` (uint8, zeroed) are h*w
// outputs. Returns the number of passes decoded, -2 when the stream
// signals more passes than bit planes, -3 on a segmentation-symbol
// mismatch. The fresh-block state (contexts, significance) matches
// _BlockDecoder exactly; selective arithmetic bypass is rejected on the
// Python side before this is called.
long long ts2dio_j2k_t1_decode(const unsigned char* data,
                               const long long* seg_lens,
                               const long long* seg_passes, long long nsegs,
                               long long w, long long h, long long style,
                               long long start_plane,
                               const unsigned char* sig_tab,
                               const unsigned char* sign_lut, int32_t* mag,
                               int32_t* lastp, uint8_t* signs) {
  if (style & 0x08)
    return j2k::t1_run<true>(data, seg_lens, seg_passes, nsegs, w, h, style,
                             start_plane, sig_tab, sign_lut, mag, lastp,
                             signs);
  return j2k::t1_run<false>(data, seg_lens, seg_passes, nsegs, w, h, style,
                            start_plane, sig_tab, sign_lut, mag, lastp,
                            signs);
}

// One-call block decode: Tier-1 coding passes + midpoint reconstruction
// (+ dequantization by ``delta`` when ``reversible`` is 0), written
// directly into the destination band region at ``dst`` with row stride
// ``dst_stride`` ELEMENTS (int64 when reversible, float64 otherwise).
// Same inputs and error codes as ts2dio_j2k_t1_decode.
long long ts2dio_j2k_t1_block(const unsigned char* data,
                              const long long* seg_lens,
                              const long long* seg_passes, long long nsegs,
                              long long w, long long h, long long style,
                              long long start_plane,
                              const unsigned char* sig_tab,
                              const unsigned char* sign_lut,
                              long long reversible, double delta, void* dst,
                              long long dst_stride) {
  if (style & 0x08)
    return j2k::t1_block<true>(data, seg_lens, seg_passes, nsegs, w, h,
                               style, start_plane, sig_tab, sign_lut,
                               reversible, delta, dst, dst_stride);
  return j2k::t1_block<false>(data, seg_lens, seg_passes, nsegs, w, h, style,
                              start_plane, sig_tab, sign_lut, reversible,
                              delta, dst, dst_stride);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG-LS (T.87 / LOCO-I) scan decoder: the serial per-sample hot loop of
// io/jpegls.py — a sample-exact port of that file's _decode_scan_py
// (gradient contexts, MED prediction with bias correction, limited
// Golomb coding, run mode with interruption coding). Header parsing and
// parameter resolution stay in Python.

namespace jls {

static const int kJ[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                           2, 3, 3, 3, 3, 4, 4, 5, 5, 6, 6,
                           7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct BitReader {
  const unsigned char* data;
  size_t len, pos;
  uint32_t buf;
  int nbits;
  bool last_ff, truncated;

  void fill() {
    if (pos >= len) {
      truncated = true;
      buf = 0;
      nbits = 8;  // keep running; caller checks `truncated` at the end
      return;
    }
    unsigned b = data[pos];
    if (last_ff) {
      if (b & 0x80) {  // a marker: scan data is over
        truncated = true;
        buf = 0;
        nbits = 8;
        return;
      }
      buf = b;
      nbits = 7;
    } else {
      buf = b;
      nbits = 8;
    }
    pos += 1;
    last_ff = (b == 0xFF);
  }

  int bit() {
    if (nbits == 0) fill();
    nbits -= 1;
    return (buf >> nbits) & 1;
  }

  int32_t bits(int n) {
    int32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }
};

struct Decoder {
  BitReader rd;
  int32_t maxval, near, t1, t2, t3, reset;
  int32_t range, qbpp, limit;
  int64_t rge;  // range * (2*near + 1)
  // gradient quantizer as a table over d + maxval (d spans
  // [-maxval, maxval]): one load instead of up to nine compares,
  // evaluated three times per regular-mode sample
  std::vector<int8_t> qlut;
  // A/B in 64-bit: hostile LSE RESET values (up to 65535) let A grow
  // toward reset*range/2 ~ 2^31 between halvings, which would overflow
  // int32 and shift N by >= 32 bits in the k-loop (both UB)
  int64_t A[367], B[365];
  int32_t C[365], N[367], Nn[2];
  int run_index;

  int quantize_slow(int32_t d) const {
    if (d <= -t3) return -4;
    if (d <= -t2) return -3;
    if (d <= -t1) return -2;
    if (d < -near) return -1;
    if (d <= near) return 0;
    if (d < t1) return 1;
    if (d < t2) return 2;
    if (d < t3) return 3;
    return 4;
  }

  void build_qlut() {
    qlut.resize(2 * static_cast<size_t>(maxval) + 1);
    for (int32_t d = -maxval; d <= maxval; ++d)
      qlut[d + maxval] = static_cast<int8_t>(quantize_slow(d));
  }

  int quantize(int32_t d) const { return qlut[d + maxval]; }

  int32_t golomb(int k, int32_t lim) {
    int32_t q = 0;
    while (rd.bit() == 0) {
      q += 1;
      if (q > lim) return -1;  // corrupt: unary beyond any legal code
    }
    if (q < lim - qbpp - 1) return (q << k) | rd.bits(k);
    return rd.bits(qbpp) + 1;
  }

  int32_t fix(int64_t rx) const {
    if (rx < -near)
      rx += rge;
    else if (rx > maxval + near)
      rx -= rge;
    return rx < 0 ? 0 : (rx > maxval ? maxval : static_cast<int32_t>(rx));
  }

  int32_t decode_ri(int32_t ra, int32_t rb, bool* err) {
    int ritype = (ra - rb <= near && rb - ra <= near) ? 1 : 0;
    int ctx = 365 + ritype;
    int64_t temp = A[ctx] + (ritype ? (N[ctx] >> 1) : 0);
    int k = 0;
    while ((static_cast<int64_t>(N[ctx]) << k) < temp) k += 1;
    int32_t emerr = golomb(k, limit - kJ[run_index] - 1);
    if (emerr < 0) {
      *err = true;
      return 0;
    }
    int32_t tval = emerr + ritype;
    int mapv = tval & 1;
    int32_t errabs = (tval + mapv) / 2;
    int32_t errval =
        (((k != 0 || 2 * Nn[ritype] >= N[ctx]) ? 1 : 0) == mapv) ? -errabs
                                                                 : errabs;
    if (errval < 0) Nn[ritype] += 1;
    A[ctx] += (emerr + 1 - ritype) >> 1;
    if (N[ctx] == reset) {
      A[ctx] >>= 1;
      N[ctx] >>= 1;
      Nn[ritype] >>= 1;
    }
    N[ctx] += 1;
    int32_t px, sign;
    if (ritype) {
      px = ra;
      sign = 1;
    } else {
      px = rb;
      sign = rb < ra ? -1 : 1;
    }
    return fix(px + static_cast<int64_t>(sign) * errval * (2 * near + 1));
  }
};

}  // namespace jls

extern "C" {

// Decodes one single-component, ILV-0 JPEG-LS scan. ``data`` is the
// entropy data (everything after the SOS header); the coding parameters
// are resolved on the Python side (io/jpegls.py _Params). ``out`` is an
// (h, w) int32 array. Returns h*w on success, -4 on a truncated entropy
// segment, -5 when a run overruns its line, -6 on a corrupt Golomb code.
long long ts2dio_jpegls_decode(const unsigned char* data, size_t len,
                               long long w, long long h, long long maxval,
                               long long near_, long long t1, long long t2,
                               long long t3, long long reset, int32_t* out) {
  jls::Decoder d;
  d.rd = {data, len, 0, 0, 0, false, false};
  d.maxval = static_cast<int32_t>(maxval);
  d.near = static_cast<int32_t>(near_);
  d.t1 = static_cast<int32_t>(t1);
  d.t2 = static_cast<int32_t>(t2);
  d.t3 = static_cast<int32_t>(t3);
  d.reset = static_cast<int32_t>(reset);
  d.range = static_cast<int32_t>((maxval + 2 * near_) / (2 * near_ + 1) + 1);
  d.qbpp = 1;
  while ((1 << d.qbpp) < d.range) d.qbpp += 1;
  {
    int bpp = 2;
    while ((1LL << bpp) < maxval + 1) bpp += 1;
    d.limit = 2 * (bpp + (bpp > 8 ? bpp : 8));
  }
  d.rge = static_cast<int64_t>(d.range) * (2 * d.near + 1);
  int64_t a_init = (d.range + 32) / 64;
  if (a_init < 2) a_init = 2;
  for (int i = 0; i < 367; ++i) {
    d.A[i] = a_init;
    d.N[i] = 1;
  }
  std::memset(d.B, 0, sizeof(d.B));
  std::memset(d.C, 0, sizeof(d.C));
  d.Nn[0] = d.Nn[1] = 0;
  d.run_index = 0;
  d.build_qlut();

  // padded line buffers: index i+1 holds sample i (see _decode_scan_py)
  std::vector<int32_t> buf0(w + 2, 0), buf1(w + 2, 0);
  int32_t* prev = buf0.data();
  int32_t* cur = buf1.data();
  const int32_t twonear1 = 2 * d.near + 1;
  for (long long y = 0; y < h; ++y) {
    prev[w + 1] = prev[w];
    cur[0] = prev[1];
    long long x = 0;
    while (x < w) {
      int32_t ra = cur[x];
      int32_t rc = prev[x];
      int32_t rb = prev[x + 1];
      int32_t rdd = prev[x + 2];
      int q1 = d.quantize(rdd - rb);
      int q2 = d.quantize(rb - rc);
      int q3 = d.quantize(rc - ra);
      if (q1 == 0 && q2 == 0 && q3 == 0) {
        // ---- run mode ----
        long long remaining = w - x;
        long long filled = 0;
        bool broken = true;
        while (d.rd.bit()) {
          long long seg = 1LL << jls::kJ[d.run_index];
          long long take = seg < remaining - filled ? seg : remaining - filled;
          filled += take;
          if (take == seg && d.run_index < 31) d.run_index += 1;
          if (filled == remaining) {
            broken = false;
            break;
          }
        }
        if (broken) {
          if (jls::kJ[d.run_index]) filled += d.rd.bits(jls::kJ[d.run_index]);
          // the mandatory interruption sample must still fit in the line
          if (filled >= remaining) return -5;
        }
        for (long long i = 0; i < filled; ++i) cur[x + 1 + i] = ra;
        x += filled;
        if (broken) {
          bool err = false;
          cur[x + 1] = d.decode_ri(ra, prev[x + 1], &err);
          if (err) return d.rd.truncated ? -4 : -6;
          if (d.run_index > 0) d.run_index -= 1;
          x += 1;
        }
        continue;
      }
      // ---- regular mode ----
      int sign;
      int q;
      {
        int qs = q1 * 81 + q2 * 9 + q3;
        sign = qs < 0 ? -1 : 1;
        q = qs < 0 ? -qs : qs;
      }
      int32_t mn = ra <= rb ? ra : rb;
      int32_t mx = ra <= rb ? rb : ra;
      int32_t px;
      if (rc >= mx)
        px = mn;
      else if (rc <= mn)
        px = mx;
      else
        px = ra + rb - rc;
      px += sign > 0 ? d.C[q] : -d.C[q];
      px = px < 0 ? 0 : (px > d.maxval ? d.maxval : px);
      int k = 0;
      while ((static_cast<int64_t>(d.N[q]) << k) < d.A[q]) k += 1;
      int32_t merr = d.golomb(k, d.limit);
      if (merr < 0) return d.rd.truncated ? -4 : -6;
      int32_t errval = (merr & 1) ? -((merr + 1) / 2) : merr / 2;
      if (k == 0 && d.near == 0 && 2 * d.B[q] <= -d.N[q])
        errval = -errval - 1;
      d.B[q] += static_cast<int64_t>(errval) * twonear1;
      d.A[q] += errval >= 0 ? errval : -errval;
      if (d.N[q] == d.reset) {
        d.A[q] >>= 1;
        d.B[q] >>= 1;
        d.N[q] >>= 1;
      }
      d.N[q] += 1;
      if (d.B[q] <= -d.N[q]) {
        d.B[q] += d.N[q];
        if (d.C[q] > -128) d.C[q] -= 1;
        if (d.B[q] <= -d.N[q]) d.B[q] = -d.N[q] + 1;
      } else if (d.B[q] > 0) {
        d.B[q] -= d.N[q];
        if (d.C[q] < 127) d.C[q] += 1;
        if (d.B[q] > 0) d.B[q] = 0;
      }
      if (sign < 0) errval = -errval;
      cur[x + 1] = d.fix(px + static_cast<int64_t>(errval) * twonear1);
      x += 1;
    }
    std::memcpy(out + y * w, cur + 1, w * sizeof(int32_t));
    std::swap(prev, cur);
  }
  if (d.rd.truncated) return -4;
  return h * w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG 2000 inverse DWT level synthesis (T.800 Annex F): the numpy
// interleave + lifting in io/jpeg2k.py (_idwt_level/_idwt_1d_53/_idwt_1d_97)
// as one native pass. Exactly the same arithmetic: integer lifting for the
// reversible 5/3; float64 lifting in the same operation order for the
// irreversible 9/7 (the Makefile compiles with -ffp-contract=off so no FMA
// contraction can change the rounding vs the numpy elementwise ops).

namespace j2kdwt {

// whole-sample symmetric extension of global index g into [i0, i1),
// returned as a LOCAL index (g - i0 reflected)
static inline long long sym(long long g, long long i0, long long i1) {
  long long n = i1 - i0;
  if (n == 1) return 0;
  long long period = 2 * (n - 1);
  long long j = (g - i0) % period;
  if (j < 0) j += period;
  if (j >= n) j = period - j;
  return j;
}

template <typename T>
static void interleave(const T* ll, const T* hl, const T* lh, const T* hh,
                       long long x0, long long y0, long long x1, long long y1,
                       T* a) {
  const long long w = x1 - x0;
  const long long n_ec = ((x1 + 1) >> 1) - ((x0 + 1) >> 1);  // even cols
  const long long n_oc = (x1 >> 1) - (x0 >> 1);              // odd cols
  long long er = 0, orr = 0;
  for (long long y = y0; y < y1; ++y) {
    T* row = a + (y - y0) * w;
    if ((y & 1) == 0) {
      const T* l = ll + er * n_ec;
      const T* h = hl + er * n_oc;
      long long e = 0, o = 0;
      for (long long x = x0; x < x1; ++x)
        row[x - x0] = ((x & 1) == 0) ? l[e++] : h[o++];
      er += 1;
    } else {
      const T* l = lh + orr * n_ec;
      const T* h = hh + orr * n_oc;
      long long e = 0, o = 0;
      for (long long x = x0; x < x1; ++x)
        row[x - x0] = ((x & 1) == 0) ? l[e++] : h[o++];
      orr += 1;
    }
  }
}

// in-place inverse 5/3 along a contiguous row for global range [i0, i1)
static void row_idwt53(int64_t* r, long long i0, long long i1) {
  const long long n = i1 - i0;
  if (n == 1) {
    if (i0 & 1) r[0] = r[0] >> 1;  // // 2 on the lone high-pass sample
    return;
  }
  // even (low) positions first, reading original odd neighbors
  for (long long g = i0 + (i0 & 1); g < i1; g += 2) {
    int64_t lm = r[sym(g - 1, i0, i1)], rp = r[sym(g + 1, i0, i1)];
    r[g - i0] -= (lm + rp + 2) >> 2;
  }
  // odd (high) positions, reading updated evens
  for (long long g = i0 + 1 - (i0 & 1); g < i1; g += 2) {
    int64_t lm = r[sym(g - 1, i0, i1)], rp = r[sym(g + 1, i0, i1)];
    r[g - i0] += (lm + rp) >> 1;
  }
}

static const double kA97 = -1.586134342059924;
static const double kB97 = -0.052980118572961;
static const double kG97 = 0.882911075530934;
static const double kD97 = 0.443506852043971;
static const double kK97 = 1.230174104914001;

static void row_idwt97(double* r, long long i0, long long i1) {
  const long long n = i1 - i0;
  if (n == 1) return;
  for (long long g = i0 + (i0 & 1); g < i1; g += 2) r[g - i0] *= kK97;
  for (long long g = i0 + 1 - (i0 & 1); g < i1; g += 2) r[g - i0] /= kK97;
  const double coefs[4] = {kD97, kG97, kB97, kA97};
  for (int step = 0; step < 4; ++step) {
    long long start = (step & 1) ? i0 + 1 - (i0 & 1) : i0 + (i0 & 1);
    double c = coefs[step];
    for (long long g = start; g < i1; g += 2) {
      double lm = r[sym(g - 1, i0, i1)], rp = r[sym(g + 1, i0, i1)];
      r[g - i0] -= c * (lm + rp);
    }
  }
}

// vertical pass, row-vectorized: each lifting sweep walks rows of one
// parity and updates them from their (opposite-parity) neighbor rows —
// symmetric reflection preserves parity, so sweeps never read a row
// modified within the same sweep (matching the numpy vectorized update).
static void vert_idwt53(int64_t* a, long long w, long long y0, long long y1) {
  const long long n = y1 - y0;
  if (n == 1) {
    if (y0 & 1)
      for (long long x = 0; x < w; ++x) a[x] = a[x] >> 1;
    return;
  }
  for (long long g = y0 + (y0 & 1); g < y1; g += 2) {
    const int64_t* lm = a + sym(g - 1, y0, y1) * w;
    const int64_t* rp = a + sym(g + 1, y0, y1) * w;
    int64_t* row = a + (g - y0) * w;
    for (long long x = 0; x < w; ++x) row[x] -= (lm[x] + rp[x] + 2) >> 2;
  }
  for (long long g = y0 + 1 - (y0 & 1); g < y1; g += 2) {
    const int64_t* lm = a + sym(g - 1, y0, y1) * w;
    const int64_t* rp = a + sym(g + 1, y0, y1) * w;
    int64_t* row = a + (g - y0) * w;
    for (long long x = 0; x < w; ++x) row[x] += (lm[x] + rp[x]) >> 1;
  }
}

static void vert_idwt97(double* a, long long w, long long y0, long long y1) {
  const long long n = y1 - y0;
  if (n == 1) return;
  for (long long g = y0 + (y0 & 1); g < y1; g += 2) {
    double* row = a + (g - y0) * w;
    for (long long x = 0; x < w; ++x) row[x] *= kK97;
  }
  for (long long g = y0 + 1 - (y0 & 1); g < y1; g += 2) {
    double* row = a + (g - y0) * w;
    for (long long x = 0; x < w; ++x) row[x] /= kK97;
  }
  const double coefs[4] = {kD97, kG97, kB97, kA97};
  for (int step = 0; step < 4; ++step) {
    long long start = (step & 1) ? y0 + 1 - (y0 & 1) : y0 + (y0 & 1);
    double c = coefs[step];
    for (long long g = start; g < y1; g += 2) {
      const double* lm = a + sym(g - 1, y0, y1) * w;
      const double* rp = a + sym(g + 1, y0, y1) * w;
      double* row = a + (g - y0) * w;
      for (long long x = 0; x < w; ++x) row[x] -= c * (lm[x] + rp[x]);
    }
  }
}

}  // namespace j2kdwt

extern "C" {

// One 2D synthesis level of the reversible 5/3 transform: combine the four
// int64 subbands of region [x0,x1) x [y0,y1) into ``out`` ((y1-y0, x1-x0)
// int64, caller-allocated). Returns the number of output samples.
long long ts2dio_j2k_idwt53(const int64_t* ll, const int64_t* hl,
                            const int64_t* lh, const int64_t* hh,
                            long long x0, long long y0, long long x1,
                            long long y1, int64_t* out) {
  const long long w = x1 - x0, h = y1 - y0;
  if (w <= 0 || h <= 0) return -1;
  j2kdwt::interleave(ll, hl, lh, hh, x0, y0, x1, y1, out);
  for (long long y = 0; y < h; ++y) j2kdwt::row_idwt53(out + y * w, x0, x1);
  j2kdwt::vert_idwt53(out, w, y0, y1);
  return w * h;
}

// Same for the irreversible 9/7 transform (float64 subbands).
long long ts2dio_j2k_idwt97(const double* ll, const double* hl,
                            const double* lh, const double* hh,
                            long long x0, long long y0, long long x1,
                            long long y1, double* out) {
  const long long w = x1 - x0, h = y1 - y0;
  if (w <= 0 || h <= 0) return -1;
  j2kdwt::interleave(ll, hl, lh, hh, x0, y0, x1, y1, out);
  for (long long y = 0; y < h; ++y) j2kdwt::row_idwt97(out + y * w, x0, x1);
  j2kdwt::vert_idwt97(out, w, y0, y1);
  return w * h;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sequential-DCT JPEG reconstruction (io/jpegdct.py _blocks_to_image):
// dequantize, de-zigzag, 2-D IDCT (row-column double arithmetic with the
// SAME orthonormal matrix the Python path uses, passed in), level shift,
// half-even rounding (nearbyint under the default FE_TONEAREST mode,
// matching np.rint), clamp, and blockwise reassembly with edge cropping.
// The entropy decoder (ts2dio_jpegdct_decode_blocks) feeds this directly,
// so a full lossy decode stays native end to end.

extern "C" {

// coefs: (nblocks, 64) int32 zigzag-order quantized coefficients,
// nblocks = bw*bh in raster block order. q: 64 uint16 zigzag quantizers.
// zigzag: 64 int32 mapping zigzag index -> natural (row-major) index.
// m: the (8,8) float64 IDCT basis matrix (out = M X M^T). out: rows*cols
// uint8 (precision 8) or uint16 (else). Returns rows*cols.
long long ts2dio_jpegdct_reconstruct(const int32_t* coefs, const uint16_t* q,
                                     const int32_t* zigzag, const double* m,
                                     long long bw, long long bh,
                                     long long rows, long long cols,
                                     long long precision, void* out) {
  if (bw <= 0 || bh <= 0 || rows <= 0 || cols <= 0) return -1;
  const double shift = static_cast<double>(1LL << (precision - 1));
  const double maxval = static_cast<double>((1LL << precision) - 1);
  uint8_t* out8 = static_cast<uint8_t*>(out);
  uint16_t* out16 = static_cast<uint16_t*>(out);
  double x8[64], t[64], p[64];
  for (long long n = 0; n < bw * bh; ++n) {
    const int32_t* c = coefs + n * 64;
    for (int i = 0; i < 64; ++i) x8[i] = 0.0;
    for (int z = 0; z < 64; ++z)
      x8[zigzag[z]] = static_cast<double>(c[z]) * q[z];
    // T = M X  (sum over u ascending), P = T M^T (sum over v ascending)
    for (int x = 0; x < 8; ++x)
      for (int v = 0; v < 8; ++v) {
        double s = 0.0;
        for (int u = 0; u < 8; ++u) s += m[x * 8 + u] * x8[u * 8 + v];
        t[x * 8 + v] = s;
      }
    for (int x = 0; x < 8; ++x)
      for (int y = 0; y < 8; ++y) {
        double s = 0.0;
        for (int v = 0; v < 8; ++v) s += t[x * 8 + v] * m[y * 8 + v];
        p[x * 8 + y] = s;
      }
    const long long r0 = (n / bw) * 8, c0 = (n % bw) * 8;
    const long long xmax = std::min<long long>(8, rows - r0);
    const long long ymax = std::min<long long>(8, cols - c0);
    for (long long x = 0; x < xmax; ++x)
      for (long long y = 0; y < ymax; ++y) {
        double v = std::nearbyint(p[x * 8 + y] + shift);
        v = v < 0.0 ? 0.0 : (v > maxval ? maxval : v);
        if (precision == 8)
          out8[(r0 + x) * cols + (c0 + y)] = static_cast<uint8_t>(v);
        else
          out16[(r0 + x) * cols + (c0 + y)] = static_cast<uint16_t>(v);
      }
  }
  return rows * cols;
}

}  // extern "C"
