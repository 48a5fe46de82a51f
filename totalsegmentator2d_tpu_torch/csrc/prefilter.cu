// Cubic B-spline prefilter (samples -> B-spline coefficients) along one
// axis, mirror boundary, float32. Replaces the Pallas TPU kernel
// totalsegmentator2d_tpu/ops/pallas/prefilter.py (_kernel, launched by
// bspline_prefilter_pallas), whose recursion it computes:
//
//   causal     s[i] = g*x[i] + z*s[i-1],   z = sqrt(3)-2, g = (1-z)(1-1/z)
//              s[0] = g * sum_{k<=horizon} z^k x[mirror(k)]
//   anticausal c[n-1] = (z*s[n-2] + s[n-1]) * z/(z^2-1)
//              c[i]   = z*(c[i+1] - s[i])
//
// The caller passes horizon = min(18, 2n-2) taps, the mirror index wrapping
// with period 2n-2, as the TPU kernel does.
//
// What bounds it on an H100. The work is 2*n*lines*4 bytes (read x once,
// write y once) and ~10 flops per sample: bytes at large sizes (52 MB for
// a batch of 8 projections, 16 us at 3.35 TB/s), latency at the main
// path's 1.6 MB per axis (~0.5 us of bytes): the launch, one round of
// loads, and the dependent steps of the two recursions. A TPU walks the
// recursion sequentially over a vector tile of lines; one thread per line
// on the card is a chain of ~2n dependent operations on ~1000 threads,
// about 5% of the card. Here the chain is ~2*SPAN steps long whatever n
// is, on ~13x the threads, and the bytes move in coalesced rows.
//
// Design: chunks of a line, computed independently. Each line is cut into
// chunks of CHUNK outputs, and each (line, chunk) pair is one work item of
// one thread. Both recursions forget their state geometrically (|z|^19 <
// 1.4e-11, below float32 rounding), so a chunk [c0, e) needs no carry from
// its neighbours: it runs the causal recursion from zero state WARM+1
// samples before c0 (s[c0-1] then holds the series g*sum_{j<=WARM} z^j
// x[c0-1-j]) and the anticausal recursion from zero state WARM samples
// after e (c[e-1] = -sum_{k<=WARM} z^(k+1) s[e-1+k]). A chunk whose warm-up
// would reach before sample 0 runs from sample 0 with the exact mirrored
// init; one whose look-ahead reaches n-1 starts from the closed form there.
// A line of at most CHUNK samples is one chunk with exactly the sequential
// arithmetic. Cost ~2x the operations at CHUNK = 32, on ~13x the threads;
// one launch per axis, no grid-wide sync, no atomics, and every output is a
// fixed sequence of operations, so runs are bitwise repeatable.
//
// A work item runs the causal pass forward over its window x[a, b) (at
// most SPAN samples), keeping s from c0 on in its own column of shared
// memory, then the anticausal pass backward from b-1, writing c[c0, e);
// each pass is a small loop that keeps memory accesses off its chain of
// dependent steps (filter_chunk).
//
// Windows are read from shared memory, filled by whole blocks:
// - the tile path (inner >= 32, or lines of more than THREADS work items):
//   a block takes 32 neighbouring `inner` columns and 4 consecutive chunks,
//   loads the 4*CHUNK + 2*WARM + 1 rows their windows span (each row 128
//   contiguous bytes, every load in flight at once: 1.3x the bytes of the
//   outputs instead of the 2.2x of a window a thread), and each warp
//   filters one chunk of 32 columns from there, writing coalesced rows;
// - the slab path (inner < 32, where the projection's axis 1 has inner =
//   2): a block stages whole contiguous (n, inner) slabs of as many lines
//   as give each thread one work item, with coalesced loads; the work
//   items keep their outputs in their columns until every window has been
//   read, write them back into the slab, and the block stores it the same
//   way. The slab keeps a pad float after every 32, so the work items of a
//   warp (chunks 32*inner floats apart) hit distinct banks.
// Either way a block needs under 48 KB of shared memory.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn keep
// nvcc from contracting them into FMAs), so the kernel reproduces its
// chunked plain PyTorch version (ops/cuda/prefilter.py) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;                     // outputs per work item
constexpr int WARM = 18;                      // warm-up samples each side
constexpr int HORIZON = 18;                   // most taps of the causal init
constexpr int SPAN = CHUNK + 2 * WARM + 1;    // samples a work item holds
constexpr int THREADS = 128;
constexpr int COLS = 32;                      // tile path: inner columns a block
constexpr int GROUP = THREADS / COLS;         // tile path: chunks a block
constexpr int TILE_ROWS = GROUP * CHUNK + 2 * WARM + 1;
constexpr int TILE_LOADS4 = (TILE_ROWS * COLS / 4 + THREADS - 1) / THREADS;
constexpr int KEEP = CHUNK + WARM;            // causal results kept a thread
constexpr int BATCH = 8;                      // samples read ahead a pass
constexpr int COPY_BATCH = CHUNK;             // slab loads in flight a thread:
                                              // a whole slab in one round
constexpr long long MAX_BLOCKS = 1 << 20;

// a slab in shared memory keeps one pad float after every 32, so that the
// work items of a warp, which read one window step at a time, hit distinct
// banks for every inner < 32 that is a power of two
__device__ __forceinline__ int padded(int idx) { return idx + (idx >> 5); }

__device__ __forceinline__ int mirror_index(int k, int n) {
    if (k < n) return k;
    const int period = 2 * n - 2;
    const int m = k % period;
    return m < n ? m : period - m;
}

// samples of a line in a shared tile: sample i at p[(i - first) * COLS]
struct TileLine {
    const float* p;
    int first;
    __device__ float operator()(int i) const { return p[(i - first) * COLS]; }
};

// samples of a line in a padded slab: sample i at slab index base + i*stride
struct SlabLine {
    const float* p;
    int base, stride;
    __device__ float operator()(int i) const { return p[padded(base + i * stride)]; }
};

// outputs of a work item into its own column: sample i at p[(i - c0)*THREADS]
struct ColumnLine {
    float* p;
    int c0;
    __device__ void store(int i, float v) const { p[(i - c0) * THREADS] = v; }
};

// a line in device memory: sample i at p[i*stride]
struct GlobalLine {
    float* p;
    long long stride;
    __device__ void store(int i, float v) const { p[(long long)i * stride] = v; }
};

// The filter's constants in float32, rounded from double as its plain
// version rounds them, with the taps of the causal-init series.
struct Coeffs {
    float z, gain, cz;
    float taps[HORIZON + 1];  // (float)(g * z^j), z^j accumulated in double
};

// One work item: outputs [c*CHUNK, min(c*CHUNK + CHUNK, n)) of the line
// read through `x` and written through `y`; buf is the thread's column of
// the block's buffer (element i at buf[i*THREADS]), which keeps the causal
// pass from c0 on. Each pass is a loop of BATCH steps an iteration: the
// next BATCH samples are loaded before the current ones are used and the
// batch's results are stored after it, so a step waits on no memory
// access, and a step outside the window keeps the state (a select, not a
// branch). The loop body stays small: straight-line code for a whole
// window runs once per warp and waits on instruction fetch.
template <typename X, typename Y>
__device__ __forceinline__ void filter_chunk(X x, Y y, const Coeffs& k, int n,
                                             int c, int horizon, float* buf) {
    const int c0 = c * CHUNK;
    const int e = min(c0 + CHUNK, n);
    const bool from0 = c0 <= WARM;          // warm-up would reach before 0
    const bool tail = e + WARM >= n;        // look-ahead reaches n-1
    const int a = from0 ? 0 : c0 - 1 - WARM;
    const int len = (tail ? n : e + WARM) - a;
    const int first = c0 - a;               // window index of c0
    const int last_out = e - 1 - a;         // window index of e-1

    // causal, forward from a: zero state, or the mirrored init at sample 0
    // (every mirror index lies inside the window)
    float s = __fmul_rn(x(a), k.gain);
    if (from0 && n > HORIZON) {             // no tap wraps: horizon = HORIZON
#pragma unroll
        for (int j = 1; j <= HORIZON; ++j)
            s = __fadd_rn(s, __fmul_rn(x(j), k.taps[j]));
    } else if (from0) {
#pragma unroll
        for (int j = 1; j <= HORIZON; ++j) {
            const float t = __fadd_rn(s, __fmul_rn(x(mirror_index(j, n)), k.taps[j]));
            s = j <= horizon ? t : s;
        }
    }
    if (first == 0) buf[0] = s;
    float prev = s;
    float xv[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) xv[u] = 1 + u < len ? x(a + 1 + u) : 0.0f;
#pragma unroll 1
    for (int k0 = 1; k0 < len; k0 += BATCH) {
        float xn[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const int i = k0 + BATCH + u;
            xn[u] = i < len ? x(a + i) : 0.0f;
        }
        float sb[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const float t = __fadd_rn(__fmul_rn(xv[u], k.gain), __fmul_rn(s, k.z));
            const bool on = k0 + u < len;
            prev = on ? s : prev;
            s = on ? t : s;
            sb[u] = s;
        }
        // stored after the batch: a store reads its register late, and the
        // next step would wait to overwrite it
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const int i = k0 + u;
            if (i < len && i >= first) buf[(i - first) * THREADS] = sb[u];
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) xv[u] = xn[u];
    }

    // anticausal, backward from b-1: the closed form at n-1 (prev is
    // s[n-2]), or zero state
    float cc = tail ? __fmul_rn(__fadd_rn(__fmul_rn(prev, k.z), s), k.cz)
                    : __fmul_rn(__fsub_rn(0.0f, s), k.z);
    if (len - 1 <= last_out) y.store(a + len - 1, cc);
    float sv[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
        const int i = len - 2 - u;
        sv[u] = i >= first ? buf[(i - first) * THREADS] : 0.0f;
    }
#pragma unroll 1
    for (int k1 = len - 2; k1 >= first; k1 -= BATCH) {
        float sn[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const int i = k1 - BATCH - u;
            sn[u] = i >= first ? buf[(i - first) * THREADS] : 0.0f;
        }
        float cb[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const float t = __fmul_rn(__fsub_rn(cc, sv[u]), k.z);
            cc = k1 - u >= first ? t : cc;
            cb[u] = cc;
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
            const int i = k1 - u;
            if (i >= first && i <= last_out) y.store(a + i, cb[u]);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) sv[u] = sn[u];
    }
}

// The tile path: a block takes COLS neighbouring `inner` columns of one
// `outer` index and GROUP consecutive chunks; it loads the rows those
// chunks' windows span (each row COLS contiguous floats) into shared
// memory, and thread (chunk g, column t) filters one work item from there.
__device__ void tile_block(const float* __restrict__ x, float* __restrict__ y,
                           long long block, int n, long long inner,
                           int horizon, const Coeffs& k, float* tile,
                           float* buf) {
    const int nchunks = (n + CHUNK - 1) / CHUNK;
    const long long col_tiles = (inner + COLS - 1) / COLS;
    const int groups = (nchunks + GROUP - 1) / GROUP;
    const long long r = block / col_tiles;
    const long long col0 = (block - r * col_tiles) * COLS;
    const int g = (int)(r % groups);
    const long long o = r / groups;
    const int cols = (int)min((long long)COLS, inner - col0);
    const int c_first = g * GROUP;
    const int row0 = c_first * CHUNK <= WARM ? 0 : c_first * CHUNK - 1 - WARM;
    const int rows = min(n, (c_first + GROUP) * CHUNK + WARM) - row0;

    const int t = threadIdx.x % COLS;
    const int lane_row = threadIdx.x / COLS;
    const float* src = x + o * n * inner + (long long)row0 * inner + col0;
    if ((inner & 3) == 0 && (((uintptr_t)x) & 15) == 0) {
        // every row is 8 aligned float4s: all of the tile's loads in one round
        float4 v[TILE_LOADS4];
#pragma unroll
        for (int u = 0; u < TILE_LOADS4; ++u) {
            const int q = threadIdx.x + u * THREADS, row = q >> 3, c4 = (q & 7) * 4;
            if (row < rows && c4 < cols)
                v[u] = *reinterpret_cast<const float4*>(src + (long long)row * inner + c4);
        }
#pragma unroll
        for (int u = 0; u < TILE_LOADS4; ++u) {
            const int q = threadIdx.x + u * THREADS, row = q >> 3, c4 = (q & 7) * 4;
            if (row < rows && c4 < cols)
                *reinterpret_cast<float4*>(tile + row * COLS + c4) = v[u];
        }
    } else {
        for (int r0 = 0; r0 < rows; r0 += GROUP * BATCH) {
            float v[BATCH];
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int row = r0 + lane_row + u * GROUP;
                if (row < rows && t < cols) v[u] = src[(long long)row * inner + t];
            }
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
                const int row = r0 + lane_row + u * GROUP;
                if (row < rows && t < cols) tile[row * COLS + t] = v[u];
            }
        }
    }
    __syncthreads();
    const int c = c_first + lane_row;
    if (c < nchunks && t < cols)
        filter_chunk(TileLine{tile + t, row0},
                     GlobalLine{y + o * n * inner + col0 + t, inner}, k, n, c,
                     horizon, buf);
    __syncthreads();  // the tile is refilled by the block's next unit
}

// count floats of device memory from src into the padded slab dst (or back,
// with `back`), coalesced, COPY_BATCH loads in flight a thread
__device__ void copy_slab(float* dst, const float* src, int count, bool back) {
    for (int q = threadIdx.x; q < count; q += COPY_BATCH * THREADS) {
        float v[COPY_BATCH];
#pragma unroll
        for (int u = 0; u < COPY_BATCH; ++u) {
            const int i = q + u * THREADS;
            if (i < count) v[u] = src[back ? padded(i) : i];
        }
#pragma unroll
        for (int u = 0; u < COPY_BATCH; ++u) {
            const int i = q + u * THREADS;
            if (i < count) dst[back ? i : padded(i)] = v[u];
        }
    }
}

// slab_outers == 0: the tile path. Otherwise each block stages slab_outers
// consecutive (n, inner) slabs at a time, one work item a thread.
__global__ void __launch_bounds__(THREADS)
prefilter_kernel(const float* __restrict__ x, float* __restrict__ y,
                 long long outer, int n, long long inner, int horizon,
                 int slab_outers, const Coeffs k) {
    extern __shared__ float smem[];
    float* buf = smem + threadIdx.x;        // KEEP x THREADS, then the tile or slab
    float* data = smem + KEEP * THREADS;
    if (slab_outers == 0) {
        const int nchunks = (n + CHUNK - 1) / CHUNK;
        const long long units = outer * ((nchunks + GROUP - 1) / GROUP)
                                * ((inner + COLS - 1) / COLS);
        for (long long b = blockIdx.x; b < units; b += gridDim.x)
            tile_block(x, y, b, n, inner, horizon, k, data, buf);
        return;
    }

    // the slab path: one work item a thread; its outputs go through its
    // column back into the slab once every window has been read
    const int nchunks = (n + CHUNK - 1) / CHUNK;
    const int line_floats = n * (int)inner;
    const int in_ = (int)inner;
    for (long long o0 = (long long)blockIdx.x * slab_outers; o0 < outer;
         o0 += (long long)gridDim.x * slab_outers) {
        const int count = (int)min((long long)slab_outers, outer - o0) * line_floats;
        copy_slab(data, x + o0 * line_floats, count, false);
        __syncthreads();
        const int t = threadIdx.x;
        const bool active = t < count / n * nchunks;
        const int r = t / in_;
        const int c = r % nchunks;
        const int base = (r / nchunks) * line_floats + (t - r * in_);
        if (active)
            filter_chunk(SlabLine{data, base, in_}, ColumnLine{buf, c * CHUNK},
                         k, n, c, horizon, buf);
        __syncthreads();
        if (active)
            for (int i = c * CHUNK; i < min(c * CHUNK + CHUNK, n); ++i)
                data[padded(base + i * in_)] = buf[(i - c * CHUNK) * THREADS];
        __syncthreads();
        copy_slab(y + o0 * line_floats, data, count, true);
        __syncthreads();  // before the next group's loads
    }
}

}  // namespace

// Filters x (outer, n, inner), contiguous float32, into y of the same shape
// on `stream`. Requires n >= 2 and horizon <= 18. Returns
// cudaGetLastError() after the launch.
extern "C" int ts2d_prefilter(const float* x, float* y, long long outer,
                              int n, long long inner, int horizon,
                              void* stream) {
    if (outer * inner == 0) return 0;
    if (n < 2 || horizon > HORIZON) return (int)cudaErrorInvalidValue;
    // the constants as the plain version rounds them (double, then float)
    Coeffs k;
    const double zd = sqrt(3.0) - 2.0;  // correctly rounded, as numpy's
    const double gd = (1.0 - zd) * (1.0 - 1.0 / zd);
    k.z = (float)zd;
    k.gain = (float)gd;
    k.cz = (float)(zd / (zd * zd - 1.0));
    double zk = 1.0;
    k.taps[0] = (float)gd;
    for (int j = 1; j <= HORIZON; ++j) {
        zk *= zd;
        k.taps[j] = (float)(gd * zk);
    }
    const long long nchunks = (n + CHUNK - 1) / CHUNK;
    const long long line_floats = (long long)n * inner;
    int slab_outers = 0;
    size_t smem = (size_t)KEEP * THREADS * sizeof(float);
    long long blocks;
    if (inner < COLS && nchunks * inner <= THREADS) {
        // as many lines as give one work item a thread: a slab of at most
        // THREADS * CHUNK floats, so every launch stays within 48 KB
        long long p = THREADS / (nchunks * inner);
        slab_outers = (int)(p < outer ? p : outer);
        const long long floats = slab_outers * line_floats;
        smem += (size_t)(floats + (floats >> 5) + 1) * sizeof(float);
        blocks = (outer + slab_outers - 1) / slab_outers;
    } else {
        smem += (size_t)TILE_ROWS * COLS * sizeof(float);
        blocks = outer * ((nchunks + GROUP - 1) / GROUP)
                 * ((inner + COLS - 1) / COLS);
    }
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    prefilter_kernel<<<(unsigned int)blocks, THREADS, smem,
                       (cudaStream_t)stream>>>(x, y, outer, n, inner, horizon,
                                               slab_outers, k);
    return (int)cudaGetLastError();
}
