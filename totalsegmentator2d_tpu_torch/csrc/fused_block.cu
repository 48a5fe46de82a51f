// Fused InstanceNorm-apply -> LeakyReLU -> conv3x3 (+ output statistics),
// bf16 operands on the tensor cores, fp32 accumulation. Port of the Pallas
// TPU kernel totalsegmentator2d_tpu/ops/pallas/fused_block.py (_kernel,
// launched by fused_norm_act_conv):
//
//   a     = bf16( leaky_relu(x * scale[n, c] + shift[n, c]) )  (or bf16(x))
//   out   = conv3x3_SAME(a, w) + b                              (fp32)
//   y     = bf16(out)
//   stats = per (n, cout): [sum(out), sum(out^2)] over H*W      (fp32)
//
// The SAME padding is zero in the ACTIVATED domain: an out-of-image tap
// contributes 0, not leaky(shift).
//
// Design: an implicit GEMM with M = output pixels of one image, N = Cout,
// K = 9*C ordered [ky][kx][c] -- the row order of the weight w (3, 3, C,
// Cout) bf16 read as (9C, Cout). A block of 8 warps owns a BM x BN output
// tile (BN = 32/64/128 by Cout, BM = 8192/BN, every warp 32x32 = 2x2 wmma
// 16x16x16 fragments) inside ONE image, and walks K in chunks of 32:
// the A chunk (BM pixels x 32 taps-channels) is gathered from x with the
// halo, normact is applied in fp32 as it goes to shared memory (the
// prologue), the B chunk is copied as is. Two shared buffers and a register
// stage overlap the next chunk's global loads with this chunk's mma. Tails
// in K (9C not a multiple of 32), N (Cout not a multiple of BN) and M (H*W
// not a multiple of BM) are zero-filled or masked, so any C, Cout, H and W
// work; C % 8 == 0 and Cout % 8 == 0 (every U-Net stage) take 16-byte
// loads, other shapes a scalar path.
//
// Statistics: TPU grid steps run in order and carry the sum; CUDA blocks do
// not. Each block writes its per-column [sum, sumsq] partial (taken in a
// fixed order from the fp32 values before the bf16 rounding) to a scratch
// buffer (N, tiles, 2, Cout), and a second kernel sums the tiles in order.
// No atomics: the same input gives bitwise the same y and stats.
//
// Normact uses __fmul_rn/__fadd_rn (no FMA contraction) so the bf16 A
// operand is bit-identical to the plain PyTorch version's
// (ops/cuda/fused_block.py); only the order of the fp32 sums differs.
//
// What bounds it on an H100: at the U-Net's shapes the work is 2*9*C*Cout
// flops per output pixel against 2*(C + Cout) bytes, i.e. ~9*C*Cout/(C+Cout)
// flops per byte: 144 at C = Cout = 32, 2304 at 512 -- above the card's
// ~295 flops/byte bf16 ridge from C = Cout = 64 on, so the tensor cores
// (989 TFLOP/s dense bf16) bound all but the two 32-channel shapes, which
// the 3.35 TB/s of HBM bound. This first version uses the Ampere-style
// wmma/mma.sync path, which reaches only a fraction of Hopper's wgmma rate;
// the TMA + wgmma pipeline is a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int BK = 32;        // K chunk
constexpr int WTILE = 32;     // warp tile (rows and columns)

template <int BN>
struct Tile {
    static constexpr int WARPS_N = BN / WTILE;
    static constexpr int WARPS_M = 8 / WARPS_N;
    static constexpr int BM = WTILE * WARPS_M;
    static constexpr int LDA = BK + 8;  // +8: spread wmma rows over banks
    static constexpr int LDB = BN + 8;
    static constexpr int LDC = BN + 4;
    static constexpr int A_BYTES = 2 * BM * LDA * 2;  // two buffers, bf16
    static constexpr int B_BYTES = 2 * BK * LDB * 2;
    static constexpr int C_BYTES = BM * LDC * 4;      // fp32, after the K loop
    static constexpr int SMEM =
        A_BYTES + B_BYTES > C_BYTES ? A_BYTES + B_BYTES : C_BYTES;
    // 16-byte (8 x bf16) vectors per chunk, and per thread
    static constexpr int A_VECS = BM * BK / 8;
    static constexpr int B_VECS = BK * BN / 8;
    static constexpr int A_VIT = (A_VECS + THREADS - 1) / THREADS;
    static constexpr int B_VIT = (B_VECS + THREADS - 1) / THREADS;
    // scalar path: elements per thread
    static constexpr int A_SIT = BM * BK / THREADS;
    static constexpr int B_SIT = BK * BN / THREADS;
};

__device__ __forceinline__ float normact(float v, float s, float t,
                                         float slope) {
    const float z = __fadd_rn(__fmul_rn(v, s), t);
    return z >= 0.f ? z : __fmul_rn(z, slope);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(THREADS)
fused_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ y,
                  float* __restrict__ partial, int H, int W, int C, int Cout,
                  float slope, int apply_normact) {
    using T = Tile<BN>;
    constexpr int BM = T::BM, LDA = T::LDA, LDB = T::LDB, LDC = T::LDC;
    __shared__ __align__(128) unsigned char smem[T::SMEM];
    __shared__ float red[2][THREADS];
    bf16* As = reinterpret_cast<bf16*>(smem);              // [2][BM][LDA]
    bf16* Bs = reinterpret_cast<bf16*>(smem + T::A_BYTES);  // [2][BK][LDB]
    float* Cs = reinterpret_cast<float*>(smem);             // [BM][LDC]

    const int tid = threadIdx.x, warp = tid / 32;
    const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
    const int tile = blockIdx.x, n0 = blockIdx.y * BN, n = blockIdx.z;
    const int HW = H * W, K = 9 * C, nk = (K + BK - 1) / BK;
    const long long img = (long long)n * HW;
    const bf16* xn = x + img * C;
    const float* sc = scale + (long long)n * C;
    const float* sh = shift + (long long)n * C;
    const bool act = apply_normact != 0;

    // -- the chunk loaders --------------------------------------------------
    // vector path: A vector v covers row v/4, k = kc*32 + (v%4)*8 .. +8, all
    // in one tap because C % 8 == 0; normact is applied when it is stored,
    // so the global load stays in flight during the mma of the chunk before
    uint4 a_raw[VEC ? T::A_VIT : 1];
    int a_c0[VEC ? T::A_VIT : 1];  // channel of the vector, -1 = zero
    int a_h[VEC ? T::A_VIT : 1], a_w[VEC ? T::A_VIT : 1];
    uint4 b_raw[VEC ? T::B_VIT : 1];
    // scalar path: final bf16 values
    bf16 a_val[VEC ? 1 : T::A_SIT];
    bf16 b_val[VEC ? 1 : T::B_SIT];

    if constexpr (VEC) {
#pragma unroll
        for (int i = 0; i < T::A_VIT; ++i) {
            const int m = tile * BM + (tid + i * THREADS) / (BK / 8);
            a_h[i] = m < HW ? m / W : -1000000;  // out of range: every tap pads
            a_w[i] = m < HW ? m - (m / W) * W : 0;
        }
    }

    auto load = [&](int kc) {
        if constexpr (VEC) {
#pragma unroll
            for (int i = 0; i < T::A_VIT; ++i) {
                const int v = tid + i * THREADS;
                const int k0 = kc * BK + (v % (BK / 8)) * 8;
                a_c0[i] = -1;
                a_raw[i] = make_uint4(0, 0, 0, 0);
                if (k0 < K) {
                    const int tap = k0 / C, c0 = k0 - tap * C;
                    const int ky = tap / 3, kx = tap - ky * 3;
                    const int hh = a_h[i] + ky - 1, ww = a_w[i] + kx - 1;
                    if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
                        a_raw[i] = *reinterpret_cast<const uint4*>(
                            xn + ((long long)hh * W + ww) * C + c0);
                        a_c0[i] = c0;
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < T::B_VIT; ++i) {
                const int v = tid + i * THREADS;
                const int k = kc * BK + v / (BN / 8);
                const int col = n0 + (v % (BN / 8)) * 8;
                b_raw[i] = make_uint4(0, 0, 0, 0);
                if (v < T::B_VECS && k < K && col < Cout)
                    b_raw[i] = *reinterpret_cast<const uint4*>(
                        w + (long long)k * Cout + col);
            }
        } else {
#pragma unroll
            for (int i = 0; i < T::A_SIT; ++i) {
                const int e = tid + i * THREADS;
                const int m = tile * BM + e / BK, k = kc * BK + e % BK;
                float v = 0.f;
                if (m < HW && k < K) {
                    const int tap = k / C, c = k - tap * C;
                    const int ky = tap / 3, kx = tap - ky * 3;
                    const int hh = m / W + ky - 1, ww = m % W + kx - 1;
                    if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
                        v = __bfloat162float(
                            xn[((long long)hh * W + ww) * C + c]);
                        if (act) v = normact(v, sc[c], sh[c], slope);
                    }
                }
                a_val[i] = __float2bfloat16_rn(v);
            }
#pragma unroll
            for (int i = 0; i < T::B_SIT; ++i) {
                const int e = tid + i * THREADS;
                const int k = kc * BK + e / BN, col = n0 + e % BN;
                b_val[i] = (k < K && col < Cout)
                               ? w[(long long)k * Cout + col]
                               : __float2bfloat16_rn(0.f);
            }
        }
    };

    auto store = [&](int buf) {
        bf16* as = As + buf * BM * LDA;
        bf16* bs = Bs + buf * BK * LDB;
        if constexpr (VEC) {
#pragma unroll
            for (int i = 0; i < T::A_VIT; ++i) {
                const int v = tid + i * THREADS;
                uint4 out = a_raw[i];
                if (a_c0[i] >= 0 && act) {
                    const __nv_bfloat162* in =
                        reinterpret_cast<const __nv_bfloat162*>(&a_raw[i]);
                    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
                    const int c = a_c0[i];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float2 f = __bfloat1622float2(in[j]);
                        o[j] = __floats2bfloat162_rn(
                            normact(f.x, __ldg(sc + c + 2 * j),
                                    __ldg(sh + c + 2 * j), slope),
                            normact(f.y, __ldg(sc + c + 2 * j + 1),
                                    __ldg(sh + c + 2 * j + 1), slope));
                    }
                }
                *reinterpret_cast<uint4*>(as + (v / (BK / 8)) * LDA +
                                          (v % (BK / 8)) * 8) = out;
            }
#pragma unroll
            for (int i = 0; i < T::B_VIT; ++i) {
                const int v = tid + i * THREADS;
                if (v < T::B_VECS)
                    *reinterpret_cast<uint4*>(bs + (v / (BN / 8)) * LDB +
                                              (v % (BN / 8)) * 8) = b_raw[i];
            }
        } else {
#pragma unroll
            for (int i = 0; i < T::A_SIT; ++i) {
                const int e = tid + i * THREADS;
                as[(e / BK) * LDA + e % BK] = a_val[i];
            }
#pragma unroll
            for (int i = 0; i < T::B_SIT; ++i) {
                const int e = tid + i * THREADS;
                bs[(e / BN) * LDB + e % BN] = b_val[i];
            }
        }
    };

    // -- the product ----------------------------------------------------------
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    load(0);
    for (int kc = 0; kc < nk; ++kc) {
        const int buf = kc & 1;
        store(buf);
        __syncthreads();
        if (kc + 1 < nk) load(kc + 1);
        const bf16* as = As + buf * BM * LDA;
        const bf16* bs = Bs + buf * BK * LDB;
#pragma unroll
        for (int ks = 0; ks < BK; ks += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(af[i], as + (wm * WTILE + i * 16) * LDA + ks,
                                       LDA);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(bfr[j], bs + ks * LDB + wn * WTILE + j * 16,
                                       LDB);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
        }
    }

    // -- the epilogue: + b, y in bf16, per-column partial statistics ---------
    __syncthreads();  // every warp is done with As/Bs before Cs overwrites them
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(
                Cs + (wm * WTILE + i * 16) * LDC + wn * WTILE + j * 16,
                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();

    constexpr int GROUPS = THREADS / BN;
    const int col = tid % BN, group = tid / BN, gc = n0 + col;
    float s = 0.f, q = 0.f;
    if (gc < Cout) {
        const float bv = bias[gc];
        for (int r = group; r < BM; r += GROUPS) {
            const int m = tile * BM + r;
            if (m >= HW) break;
            const float v = __fadd_rn(Cs[r * LDC + col], bv);
            y[(img + m) * Cout + gc] = __float2bfloat16_rn(v);
            s = __fadd_rn(s, v);
            q = __fadd_rn(q, __fmul_rn(v, v));
        }
    }
    red[0][tid] = s;
    red[1][tid] = q;
    __syncthreads();
    if (tid < BN && gc < Cout) {
        float S = 0.f, Q = 0.f;
        for (int g = 0; g < GROUPS; ++g) {
            S = __fadd_rn(S, red[0][g * BN + tid]);
            Q = __fadd_rn(Q, red[1][g * BN + tid]);
        }
        const long long base = ((long long)n * gridDim.x + tile) * 2 * Cout + gc;
        partial[base] = S;
        partial[base + Cout] = Q;
    }
}

// stats[n][s][c] = sum over tiles t, in order, of partial[n][t][s][c]
__global__ void stats_sum_kernel(const float* __restrict__ partial,
                                 float* __restrict__ stats, int N, int tiles,
                                 int Cout) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N * 2 * Cout) return;
    const int c = i % Cout, s = (i / Cout) % 2, n = i / (2 * Cout);
    const float* p = partial + ((long long)n * tiles * 2 + s) * Cout + c;
    float acc = 0.f;
    for (int t = 0; t < tiles; ++t) acc = __fadd_rn(acc, p[(long long)t * 2 * Cout]);
    stats[i] = acc;
}

template <int BN>
int launch(const bf16* x, const float* scale, const float* shift, const bf16* w,
           const float* b, bf16* y, float* partial, float* stats, int N, int H,
           int W, int C, int Cout, float slope, int apply_normact,
           cudaStream_t stream) {
    const int tiles = (H * W + Tile<BN>::BM - 1) / Tile<BN>::BM;
    const dim3 grid(tiles, (Cout + BN - 1) / BN, N);
    const bool vec = C % 8 == 0 && Cout % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (vec)
        fused_conv_kernel<BN, true><<<grid, THREADS, 0, stream>>>(
            x, scale, shift, w, b, y, partial, H, W, C, Cout, slope, apply_normact);
    else
        fused_conv_kernel<BN, false><<<grid, THREADS, 0, stream>>>(
            x, scale, shift, w, b, y, partial, H, W, C, Cout, slope, apply_normact);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int total = N * 2 * Cout;
    stats_sum_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partial, stats, N,
                                                              tiles, Cout);
    return (int)cudaGetLastError();
}

}  // namespace

// Rows (output pixels of one image) per block for a given Cout: the caller
// sizes the partial-statistics scratch as (N, ceil(H*W / rows), 2, Cout).
extern "C" int ts2d_fused_rows_per_tile(int Cout) {
    return Cout <= 32 ? Tile<32>::BM : Cout <= 64 ? Tile<64>::BM : Tile<128>::BM;
}

// x (N, H, W, C) bf16, scale/shift (N, C) fp32 (unread when apply_normact is
// 0), w (3, 3, C, Cout) bf16, b (Cout) fp32, all contiguous; writes y (N, H,
// W, Cout) bf16, partial (N, tiles, 2, Cout) and stats (N, 2, Cout) fp32 on
// `stream`. Returns cudaGetLastError() after the launches.
extern "C" int ts2d_fused_norm_act_conv(const void* x, const float* scale,
                                        const float* shift, const void* w,
                                        const float* b, void* y, float* partial,
                                        float* stats, int N, int H, int W, int C,
                                        int Cout, float slope, int apply_normact,
                                        void* stream) {
    if (N == 0 || H == 0 || W == 0 || Cout == 0) return 0;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* yb = static_cast<bf16*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (Cout <= 32)
        return launch<32>(xb, scale, shift, wb, b, yb, partial, stats, N, H, W, C,
                          Cout, slope, apply_normact, st);
    if (Cout <= 64)
        return launch<64>(xb, scale, shift, wb, b, yb, partial, stats, N, H, W, C,
                          Cout, slope, apply_normact, st);
    return launch<128>(xb, scale, shift, wb, b, yb, partial, stats, N, H, W, C,
                       Cout, slope, apply_normact, st);
}
