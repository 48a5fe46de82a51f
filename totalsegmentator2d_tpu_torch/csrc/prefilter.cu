// Cubic B-spline prefilter (samples -> B-spline coefficients) along one
// axis, mirror boundary, float32. Port of the Pallas TPU kernel
// totalsegmentator2d_tpu/ops/pallas/prefilter.py (_kernel, launched by
// bspline_prefilter_pallas), with the same arithmetic:
//
//   causal     s[i] = g*x[i] + z*s[i-1],   z = sqrt(3)-2, g = (1-z)(1-1/z)
//              s[0] = g * sum_{k<=horizon} z^k x[mirror(k)]
//   anticausal c[n-1] = (z*s[n-2] + s[n-1]) * z/(z^2-1)
//              c[i]   = z*(c[i+1] - s[i])
//
// The caller passes horizon = min(18, 2n-2) taps (18 for tol 1e-10), the
// mirror index wrapping with period 2n-2, as the TPU kernel does.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn keep
// nvcc from contracting them into FMAs), so the kernel reproduces its plain
// PyTorch version (ops/cuda/prefilter.py) bit for bit.
//
// Layout: the array is viewed as (outer, n, inner) with the filter axis in
// the middle, so no axis is moved in memory. One thread owns one line
// (outer*inner lines): it runs the causal pass, writing s to the output,
// then the anticausal pass in place. Threads next to each other walk
// neighbouring `inner` addresses.
//
// What bounds it on an H100: the bytes moved are 2*n*lines*4 (read x once,
// write y once; the anticausal pass re-reads y, mostly from L1/L2), i.e.
// ~3.3 MB for a (400, 512, 2) projection -- about 1 us at 3.35 TB/s. The
// floor in practice is latency: each line is a chain of 2n dependent
// multiply-adds, and the main path has only ~1000 lines, so a handful of
// 128-thread blocks are resident on 132 SMs. Splitting lines into chunks
// (a parallel scan over the recurrence) is the way to a faster kernel; this
// first version is the simple, exact one.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int mirror_index(int k, int n) {
    const int period = 2 * n - 2;
    const int m = k % period;
    return m < n ? m : period - m;
}

__global__ void prefilter_kernel(const float* __restrict__ x,
                                 float* __restrict__ y,
                                 long long outer, int n, long long inner,
                                 int horizon) {
    const long long line = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (line >= outer * inner) return;
    const long long o = line / inner;
    const long long base = o * n * inner + (line - o * inner);
    const float* xs = x + base;
    float* ys = y + base;

    const double zd = sqrt(3.0) - 2.0;  // correctly rounded, as numpy's
    const double gd = (1.0 - zd) * (1.0 - 1.0 / zd);
    const float z = (float)zd;
    const float gain = (float)gd;

    // causal init: truncated mirrored series, tap weights rounded from double
    float s = __fmul_rn(xs[0], gain);
    double zk = 1.0;
    for (int k = 1; k <= horizon; ++k) {
        zk *= zd;
        const float w = (float)(gd * zk);
        s = __fadd_rn(s, __fmul_rn(xs[(long long)mirror_index(k, n) * inner], w));
    }
    ys[0] = s;
    for (int i = 1; i < n; ++i) {
        s = __fadd_rn(__fmul_rn(xs[(long long)i * inner], gain), __fmul_rn(s, z));
        ys[(long long)i * inner] = s;
    }

    // anticausal init (closed form) and backward pass, in place
    const float cz = (float)(zd / (zd * zd - 1.0));
    float c = __fmul_rn(__fadd_rn(__fmul_rn(ys[(long long)(n - 2) * inner], z), s), cz);
    ys[(long long)(n - 1) * inner] = c;
    for (int i = n - 2; i >= 0; --i) {
        c = __fmul_rn(__fsub_rn(c, ys[(long long)i * inner]), z);
        ys[(long long)i * inner] = c;
    }
}

}  // namespace

// Filters x (outer, n, inner), contiguous float32, into y of the same shape
// on `stream`. Requires n >= 2. Returns cudaGetLastError() after the launch.
extern "C" int ts2d_prefilter(const float* x, float* y, long long outer,
                              int n, long long inner, int horizon,
                              void* stream) {
    const long long lines = outer * inner;
    if (lines == 0) return 0;
    const int threads = 128;
    const long long blocks = (lines + threads - 1) / threads;
    prefilter_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(x, y, outer, n, inner, horizon);
    return (int)cudaGetLastError();
}
