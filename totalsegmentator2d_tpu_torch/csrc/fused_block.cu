// Fused InstanceNorm-apply -> LeakyReLU -> conv3x3 (+ output statistics),
// bf16 operands on Hopper's warpgroup tensor cores, fp32 accumulation. Port
// of the Pallas TPU kernel totalsegmentator2d_tpu/ops/pallas/fused_block.py
// (_kernel, launched by fused_norm_act_conv):
//
//   a     = bf16( leaky_relu(x * scale[n, c] + shift[n, c]) )  (or bf16(x))
//   out   = conv3x3_SAME(a, w) + b                              (fp32)
//   y     = bf16(out)
//   stats = per (n, cout): [sum(out), sum(out^2)] over H*W      (fp32)
//
// The SAME padding is zero in the ACTIVATED domain: an out-of-image tap
// contributes 0, not leaky(shift).
//
// What bounds it on an H100: 2*9*C*Cout flops per output pixel against
// 2*(C + Cout) bytes, i.e. ~9*C*Cout/(C+Cout) flops per byte: 144 at C = Cout
// = 32, 2304 at 512. The card's bf16 ridge is ~295 flops/byte, so the 32- and
// 64-channel shapes at 256^2 and 128^2 are bound by HBM (3.35 TB/s), the rest
// by the tensor cores (989 TFLOP/s dense bf16).
//
// Design (sm_90a; one persistent block per SM, 384 threads):
//
// * Work unit = one output tile: a box of one image (128 pixels: 8 rows x 16
//   columns, or 16 x 8 when W <= 8; 8 x 8 = 64 pixels for images of at most
//   8 x 8; 256 pixels at 32 output channels where the weights stay resident)
//   times BN output channels (32/64/128, from Cout; 64 at <= 8 x 8). Blocks
//   walk the units in a fixed order. A tile stays inside one image, so its
//   statistics belong to one n.
// * Producer warp (warp 8; setmaxnreg.dec): TMA loads into two shared-memory
//   rings with full/empty mbarriers.
//   - The halo tile: a (TH+2) x (TW+2) box of CW input channels (CW = 64,
//     or 32 when C % 64 != 0) through a 4-D tensor map over x (N, H, W, C)
//     at the signed origin (h0-1, w0-1). TMA zero-fills what lies outside
//     the image, which is the SAME padding. Each pixel of x is read once per
//     tile instead of once per tap; swizzled (64/128 B) so that the shifted
//     ldmatrix reads below are free of bank conflicts. Up to 4 stages deep.
//   - Weight slices: for each (channel chunk, tap), the CW x BN slice of the
//     (9C, Cout) bf16 matrix (pack_weight's HWIO memory) through a 2-D
//     tensor map, 64- or 128-byte swizzled, in atoms of <= 64 columns. When
//     a unit's whole weight slice fits in shared memory (one Cout tile), it
//     is loaded once per block and stays resident.
// * Normact warps (warps 9-11): normact once per element of each halo chunk
//   in shared memory, in place, after it arrives (out-of-image positions are
//   left at TMA's 0), with __fmul_rn/__fadd_rn so the bf16 A operand is
//   bit-identical to the plain PyTorch version's; a third barrier per slot
//   hands the chunk to the consumers. This overlaps with their products.
// * Two consumer warpgroups (setmaxnreg.inc), 64 output rows each (or, at
//   64-pixel tiles, all 64 rows and half of BN each): per stage of taps (3,
//   or all 9 when CW = 32 and BN <= 64), ldmatrix.x4 reads the A fragments
//   straight from the halo tile at the rows shifted by (ky, kx) (a shifted
//   view is not a canonical wgmma layout for a 16-wide tile, so A comes from
//   registers); then one wgmma.fence, wgmma m64nNk16 (A in registers, B =
//   the weight slice through a descriptor, MN-major) for every tap and k16
//   step of the stage, one commit and wait_group 0. A fragment written while
//   a wgmma is in flight makes ptxas serialize every wgmma, so the next
//   stage's ldmatrix waits for it.
// * Epilogue: + bias on the fp32 accumulators; y is rounded to bf16 through
//   a padded shared-memory stage and stored in 16-byte coalesced rows. The
//   per-column [sum, sumsq] of the in-image rows is added up in registers,
//   over a block's consecutive units of one image where the accumulators
//   are narrow (one Cout tile), else per unit; then summed over lanes by
//   shuffles and over warps in a fixed order in shared memory into a
//   partial row.
// * A last small kernel sums the partial rows in order. No atomics
//   anywhere: the same input gives bitwise the same y and stats.
//
// TMA needs 16-byte global strides and a tap needs whole 32-channel chunks:
// the kernel takes C % 32 == 0 and Cout % 8 == 0 (every U-Net stage of the
// flagship); the wrapper zero-pads other channel counts before the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 256;             // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;   // + the producer warpgroup
constexpr int MAX_SMEM = 232448;           // per block on an H100
constexpr int MAX_STAGES = 36;             // resident weights: 4 chunks x 9 taps
constexpr int YPAD = 8;                    // bf16 of padding per y-stage row
constexpr int MAX_HALO = 4;                // halo ring stages
constexpr int TRANSFORM = 96;              // normact threads: warps 1-3 of the producer group

struct Params {
    const float* scale;
    const float* shift;
    const float* bias;
    bf16* y;
    float* out;  // partial statistics
    int N, H, W, C, Cout;
    int cw, tw, twl, th, tiles_w, tiles, ct, nchunks, units;
    int nh, nb, resident, act, accum;
    float slope;
    int halo_bytes, halo_stage, b_stage, off_b, off_y, off_red, off_bar;
};

// -- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the TMA swizzle of a byte offset inside a 1024-byte-aligned buffer whose
// rows are (mask + 1) * 16 bytes: 16-byte chunk ^= (offset / 128) & mask
__device__ __forceinline__ uint32_t swz(uint32_t off, uint32_t mask) {
    return off ^ (((off >> 7) & mask) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
    uint32_t ok;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.b32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    return ok != 0;
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// wait for the phase of `parity` to complete; a phase that never completes
// (a fault in the pipeline) traps after 10 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try(bar, parity)) return;
    const uint64_t t0 = globaltimer_ns();
    while (!mbar_try(bar, parity))
        if (globaltimer_ns() - t0 > 10000000000ull) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
        : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(addr));
    return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
                 "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1 = 128 B, 2 = 64 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) |
           (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// D (64 x N fp32, registers) += A (64 x 16 bf16, registers) * B (16 x N
// bf16, shared memory, MN-major: imm-trans-b = 1). scale-d is the constant 1:
// the kernel zeroes the accumulators itself, so no predicate is computed
// between a stage's wgmmas.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc) {
    if constexpr (N == 128) wgmma_n128(d, a, desc);
    else if constexpr (N == 64) wgmma_n64(d, a, desc);
    else wgmma_n32(d, a, desc);
}

__device__ __forceinline__ float normact(float v, float s, float t, float slope) {
    const float z = __fadd_rn(__fmul_rn(v, s), t);
    return z >= 0.f ? z : __fmul_rn(z, slope);
}

struct Unit {
    int n, t, h0, w0, n0;
};

__device__ __forceinline__ Unit decode(const Params& p, int BN, int u) {
    Unit r;
    r.n0 = (u % p.ct) * BN;
    const int q = u / p.ct;
    r.t = q % p.tiles;
    r.n = q / p.tiles;
    r.h0 = (r.t / p.tiles_w) * p.th;
    r.w0 = (r.t % p.tiles_w) * p.tw;
    return r;
}

// -- the kernel -------------------------------------------------------------

// MODE 0: the two consumer warpgroups share a tile of 128 * MB pixels, 64 * MB
//         rows (MB m64 row blocks) each.
// MODE 1: they share a 64-pixel tile (images of at most 8x8), BN/2 columns
//         each (MB = 1).
template <int BN, int MODE, int CW, int MB>
__global__ void __launch_bounds__(THREADS, 1)
fused_conv_sm90(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap, const Params p) {
    constexpr int WG_N = MODE == 1 ? BN / 2 : BN;  // columns of one warpgroup
    constexpr int ATOM = WG_N < 64 ? WG_N : 64;    // B columns per swizzle atom
    constexpr int ATOMS = BN / ATOM;
    constexpr int ROWB = ATOM * 2;                 // bytes of one B row in an atom
    constexpr uint64_t BLAYOUT = ATOM == 64 ? 1 : 2;
    constexpr int RB = MODE == 0 ? 8 : 4;          // 16-row blocks of a column
    constexpr int KS = CW / 16;                    // k16 steps per tap and chunk
    constexpr int BP = CW * 2;                     // halo bytes per pixel
    constexpr uint32_t hmask = BP / 16 - 1;
    // taps per wgmma stage: a stage's A fragments are all loaded before its
    // wgmma.fence and none is written until wait_group 0 retires it (a
    // fragment written while a group is in flight makes ptxas serialize
    // every wgmma); all 9 taps when the registers allow
    constexpr int TPS = MB == 2 ? (CW == 32 ? 3 : 1) : CW == 32 && BN <= 64 ? 9 : 3;
    constexpr int WG_ROWS = 64 * MB;

    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const uint32_t sbase = smem_u32(smem);
    const uint32_t bring = sbase + p.off_b;
    const uint32_t bars = sbase + p.off_bar;
    // barriers: halo full / normact done / empty [MAX_HALO], B full / empty
    // [MAX_STAGES]
    auto HF = [&](int s) { return bars + 8 * s; };
    auto HR = [&](int s) { return bars + 8 * (MAX_HALO + s); };
    auto HE = [&](int s) { return bars + 8 * (2 * MAX_HALO + s); };
    auto BF = [&](int s) { return bars + 8 * (3 * MAX_HALO + s); };
    auto BE = [&](int s) { return bars + 8 * (3 * MAX_HALO + MAX_STAGES + s); };

    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < p.nh; ++s) {
            mbar_init(HF(s), 1);
            mbar_init(HR(s), TRANSFORM);
            mbar_init(HE(s), CONSUMERS);
        }
        for (int s = 0; s < p.nb; ++s) {
            mbar_init(BF(s), 1);
            mbar_init(BE(s), CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = tid / 128;
    const int tw2 = p.tw + 2;
    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n");
        if (tid >= CONSUMERS + 32) {
            // ---- normact: once per element of each halo chunk, in place ----
            if (!p.act) return;
            const int ttid = tid - CONSUMERS - 32;
            constexpr int groups = CW / 8, step = TRANSFORM / groups;
            const int g8 = ttid % groups;
            const int th2 = p.th + 2;
            int hs = 0, hph = 0, cn = -1, cc0 = -1;
            float s8[8], t8[8];
            for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
                const Unit un = decode(p, BN, u);
                for (int cc = 0; cc < p.nchunks; ++cc) {
                    if (un.n != cn || cc != cc0) {
                        const size_t c0 = (size_t)un.n * p.C + cc * CW + g8 * 8;
#pragma unroll
                        for (int i = 0; i < 8; ++i) {
                            s8[i] = __ldg(p.scale + c0 + i);
                            t8[i] = __ldg(p.shift + c0 + i);
                        }
                        cn = un.n;
                        cc0 = cc;
                    }
                    mbar_wait(HF(hs), hph);
                    // batches of NA 16-byte groups: all loads, then the
                    // math, then all stores, so the loads' latencies overlap
                    // (the shared accesses are ordered asm statements)
                    constexpr int NA = 4;
                    const uint32_t hbase = sbase + hs * p.halo_stage;
                    int pix = ttid / groups, r = pix / tw2, c = pix % tw2;
                    while (r < th2) {
                        uint32_t addr[NA];
                        bool live[NA];
                        uint4 v[NA];
#pragma unroll
                        for (int k = 0; k < NA; ++k) {
                            const int hh = un.h0 - 1 + r, ww = un.w0 - 1 + c;
                            live[k] = r < th2 && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
                            addr[k] = hbase + swz(pix * BP + g8 * 16, hmask);
                            pix += step;
                            for (c += step; c >= tw2; c -= tw2) ++r;
                        }
#pragma unroll
                        for (int k = 0; k < NA; ++k)
                            if (live[k]) v[k] = ld_shared_v4(addr[k]);
#pragma unroll
                        for (int k = 0; k < NA; ++k) {
                            uint32_t* w4 = reinterpret_cast<uint32_t*>(&v[k]);
#pragma unroll
                            for (int j = 0; j < 4; ++j) {
                                __nv_bfloat162 h2 = *reinterpret_cast<__nv_bfloat162*>(&w4[j]);
                                const float2 f = __bfloat1622float2(h2);
                                h2 = __floats2bfloat162_rn(
                                    normact(f.x, s8[2 * j], t8[2 * j], p.slope),
                                    normact(f.y, s8[2 * j + 1], t8[2 * j + 1], p.slope));
                                w4[j] = *reinterpret_cast<uint32_t*>(&h2);
                            }
                        }
#pragma unroll
                        for (int k = 0; k < NA; ++k)
                            if (live[k]) st_shared_v4(addr[k], v[k]);
                    }
                    // the writes come before the slot's next TMA load (async proxy)
                    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                    mbar_arrive(HR(hs));
                    if (++hs == p.nh) { hs = 0; hph ^= 1; }
                }
            }
            return;
        }
        // ---- producer: one thread issues every TMA load ----
        if (tid != CONSUMERS) return;
        // the halo cursor runs up to nh chunks ahead of the weight cursor
        int hu = blockIdx.x, hs = 0, hph = 0, lead = 0, hcc = 0;
        Unit hun = decode(p, BN, hu < p.units ? hu : 0);
        int bs = 0, bph = 0;
        bool first = true;
        for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
            const Unit un = decode(p, BN, u);
            for (int cc = 0; cc < p.nchunks; ++cc) {
                for (; lead < p.nh && hu < p.units; ++lead) {
                    mbar_wait(HE(hs), hph ^ 1);
                    mbar_expect_tx(HF(hs), p.halo_bytes);
                    tma_load_4d(sbase + hs * p.halo_stage, &xmap, HF(hs), hcc * CW,
                                hun.w0 - 1, hun.h0 - 1, hun.n);
                    if (++hs == p.nh) { hs = 0; hph ^= 1; }
                    if (++hcc == p.nchunks) {
                        hcc = 0;
                        hu += gridDim.x;
                        if (hu < p.units) hun = decode(p, BN, hu);
                    }
                }
                --lead;  // chunk cc's halo is on its way
                if (p.resident && !first) continue;
                for (int tap = 0; tap < 9; ++tap) {
                    mbar_wait(BE(bs), bph ^ 1);
                    mbar_expect_tx(BF(bs), p.b_stage);
                    for (int a = 0; a < ATOMS; ++a)
                        tma_load_2d(bring + bs * p.b_stage + a * CW * ROWB, &wmap,
                                    BF(bs), un.n0 + a * ATOM, tap * p.C + cc * CW);
                    if (++bs == p.nb) { bs = 0; bph ^= 1; }
                }
            }
            first = false;
        }
        return;
    }

    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
    const int wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
    const int rowbase = MODE == 0 ? WG_ROWS * wg : 0;  // tile rows of this warpgroup
    const int colbase = MODE == 1 ? wg * WG_N : 0;  // tile columns of this warpgroup
    constexpr uint32_t lbo = CW * ROWB, sbo = 8 * ROWB;
    const uint32_t bwg = MODE == 1 ? wg * (WG_N / ATOM) * lbo : 0;
    // NARROW (at most 64 columns per warpgroup): the registers hold, beside
    // the accumulators, the per-tap fragment offsets, the bias and the
    // statistics across units (at 64 columns this spills a few bytes, which
    // costs less than recomputing the offsets)
    constexpr bool NARROW = WG_N <= 64;
    // the swizzled halo offset of this lane's ldmatrix row for a tap and
    // k16 step (the halo slots are 1024-byte aligned, so the swizzle of an
    // offset is that of the address)
    const int mr = rowbase + 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int q0 = (mr >> p.twl) * tw2 + (mr & (p.tw - 1));
    auto a_off = [&](int tap, int ks) {
        return swz((uint32_t)(q0 + (tap / 3) * tw2 + tap % 3) * BP +
                       (ks * 2 + (lane >> 4)) * 16,
                   hmask);
    };
    // (row block b is 64 / TW tile rows further down: a whole number of
    // swizzle periods, so its offsets are block 0's plus a constant)
    const uint32_t dblk = (uint32_t)(64 >> p.twl) * tw2 * BP;
    uint32_t aoff[NARROW ? 9 : 1][KS];
    if constexpr (NARROW) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) aoff[tap][ks] = a_off(tap, ks);
    }
    // this warpgroup's epilogue: y stage, named barrier; both: column sums
    bf16* st = reinterpret_cast<bf16*>(smem + p.off_y) + wg * WG_ROWS * (WG_N + YPAD);
    float* rs = reinterpret_cast<float*>(smem + p.off_red);  // [2][RB][BN]
    const int wbar = 2 + wg;
    const int g0 = lane >> 2, t4 = lane & 3;
    const int rb = MODE == 0 ? wg * 4 + warp : warp;

    // statistics: each thread adds its columns' in-image values in registers,
    // and a flush sums them over lanes and warps in a fixed order into a
    // partial row [sum, sumsq] of Cout. With p.accum (narrow accumulators,
    // one Cout tile) the sums run over the block's consecutive
    // units of one image into the block's row of that image, (grid, N, 2,
    // Cout), whose rows of images the block never meets are zeroed here;
    // else every unit writes its tile's row, (N, tiles, 2, Cout)
    const bool accum = NARROW && p.accum;
    float ss[WG_N / 4], sq[WG_N / 4];
    int cur_n = -1, cur_n0 = 0, cur_t = 0;
    float* prow = p.out + (size_t)blockIdx.x * p.N * 2 * p.Cout;
    if (accum)
        for (int i = tid; i < p.N * 2 * p.Cout; i += CONSUMERS) prow[i] = 0.f;
    auto flush = [&]() {
#pragma unroll
        for (int c = 0; c < WG_N / 4; ++c) {
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
                ss[c] = __fadd_rn(ss[c], __shfl_xor_sync(0xffffffffu, ss[c], o));
                sq[c] = __fadd_rn(sq[c], __shfl_xor_sync(0xffffffffu, sq[c], o));
            }
            if (g0 == 0) {
                const int col = colbase + 8 * (c / 2) + 2 * t4 + (c & 1);
                rs[rb * BN + col] = ss[c];
                rs[(RB + rb) * BN + col] = sq[c];
            }
        }
        named_bar_sync(1, CONSUMERS);  // every warp's column sums are in rs
        if (tid < BN && cur_n0 + tid < p.Cout) {
            float S = 0.f, Q = 0.f;
#pragma unroll
            for (int r = 0; r < RB; ++r) {
                S = __fadd_rn(S, rs[r * BN + tid]);
                Q = __fadd_rn(Q, rs[(RB + r) * BN + tid]);
            }
            // a block's units run in increasing order, so it meets each
            // image in one run: every partial row is written once
            float* d = accum ? prow + (size_t)cur_n * 2 * p.Cout + cur_n0 + tid
                             : p.out + ((size_t)cur_n * p.tiles + cur_t) * 2 * p.Cout +
                                   cur_n0 + tid;
            d[0] = S;
            d[p.Cout] = Q;
        }
        named_bar_sync(1, CONSUMERS);  // rs is free again
    };

    // the bias of this thread's columns, held when there is one Cout tile
    float breg[NARROW ? WG_N / 4 : 1];
    if (accum)
#pragma unroll
        for (int c = 0; c < WG_N / 4; ++c) {
            const int col = colbase + 8 * (c / 2) + 2 * t4 + (c & 1);
            breg[NARROW ? c : 0] = col < p.Cout ? __ldg(p.bias + col) : 0.f;
        }

    float acc[MB][WG_N / 2];
    uint32_t afrag[TPS][KS][MB][4];
    int hpos = 0, bs = 0, bph = 0;
    bool first = true;

    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const Unit un = decode(p, BN, u);
        if (accum && (un.n != cur_n || un.n0 != cur_n0)) {
            if (cur_n >= 0) flush();
#pragma unroll
            for (int c = 0; c < WG_N / 4; ++c) ss[c] = sq[c] = 0.f;
            cur_n = un.n;
            cur_n0 = un.n0;
        }
#pragma unroll
        for (int b = 0; b < MB; ++b)
#pragma unroll
            for (int i = 0; i < WG_N / 2; ++i) acc[b][i] = 0.f;
        for (int cc = 0; cc < p.nchunks; ++cc, ++hpos) {
            const int hs = hpos % p.nh, hph = (hpos / p.nh) & 1;
            const uint32_t hbase = sbase + hs * p.halo_stage;
            mbar_wait(p.act ? HR(hs) : HF(hs), hph);
#pragma unroll
            for (int t0 = 0; t0 < 9; t0 += TPS) {
#pragma unroll
                for (int t = 0; t < TPS; ++t)
#pragma unroll
                    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
                        for (int b = 0; b < MB; ++b)
                            ldmatrix_x4(afrag[t][ks][b],
                                        hbase + b * dblk +
                                            (NARROW ? aoff[NARROW ? t0 + t : 0][ks]
                                                  : a_off(t0 + t, ks)));
                // the stage's weight slices
                const int slot0 = p.resident ? cc * 9 + t0 : bs;
                if (!p.resident || first) {
                    int sl = slot0, ph = p.resident ? 0 : bph;
                    for (int t = 0; t < TPS; ++t) {
                        mbar_wait(BF(sl), ph);
                        if (++sl == p.nb) { sl = 0; ph ^= 1; }
                    }
                }
#pragma unroll
                for (int b = 0; b < MB; ++b) fence_acc(acc[b]);
                wgmma_fence();
#pragma unroll
                for (int t = 0; t < TPS; ++t) {
                    int sl = slot0 + t;
                    if (sl >= p.nb) sl -= p.nb;
                    const uint32_t bbase = bring + sl * p.b_stage + bwg;
#pragma unroll
                    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
                        for (int b = 0; b < MB; ++b)
                            wgmma<WG_N>(acc[b], afrag[t][ks][b],
                                        make_desc(bbase + ks * 16 * ROWB, lbo, sbo, BLAYOUT));
                }
                wgmma_commit();
                // the chunk's last fragments are in registers (the wgmmas
                // that read them are issued): hand the halo slot back
                if (t0 + TPS == 9) mbar_arrive(HE(hs));
                wgmma_wait<0>();
#pragma unroll
                for (int b = 0; b < MB; ++b) fence_acc(acc[b]);
                if (!p.resident)
                    for (int t = 0; t < TPS; ++t) {
                        mbar_arrive(BE(bs));
                        if (++bs == p.nb) { bs = 0; bph ^= 1; }
                    }
            }
        }
        first = false;

        // ---- epilogue ----
        named_bar_sync(wbar, 128);  // this warpgroup's stage is free again
        if (!accum) {
#pragma unroll
            for (int c = 0; c < WG_N / 4; ++c) ss[c] = sq[c] = 0.f;
            cur_n = un.n;
            cur_n0 = un.n0;
            cur_t = un.t;
        }
#pragma unroll
        for (int b = 0; b < MB; ++b) {
            const int lr0 = 64 * b + 16 * warp + g0;  // stage row
            const int m0 = rowbase + lr0, m1 = m0 + 8;
            const bool v0 = un.h0 + (m0 >> p.twl) < p.H && un.w0 + (m0 & (p.tw - 1)) < p.W;
            const bool v1 = un.h0 + (m1 >> p.twl) < p.H && un.w0 + (m1 & (p.tw - 1)) < p.W;
#pragma unroll
            for (int jj = 0; jj < WG_N / 8; ++jj) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int gc = un.n0 + colbase + 8 * jj + 2 * t4 + e;
                    const float bv = accum      ? breg[NARROW ? 2 * jj + e : 0]
                                     : gc < p.Cout ? __ldg(p.bias + gc)
                                                   : 0.f;
                    const float y0 = __fadd_rn(acc[b][4 * jj + e], bv);
                    const float y1 = __fadd_rn(acc[b][4 * jj + 2 + e], bv);
                    acc[b][4 * jj + e] = y0;
                    acc[b][4 * jj + 2 + e] = y1;
                    const int c = 2 * jj + e;
                    if (v0) {
                        ss[c] = __fadd_rn(ss[c], y0);
                        sq[c] = __fadd_rn(sq[c], __fmul_rn(y0, y0));
                    }
                    if (v1) {
                        ss[c] = __fadd_rn(ss[c], y1);
                        sq[c] = __fadd_rn(sq[c], __fmul_rn(y1, y1));
                    }
                }
                *reinterpret_cast<__nv_bfloat162*>(st + lr0 * (WG_N + YPAD) + 8 * jj +
                                                   2 * t4) =
                    __floats2bfloat162_rn(acc[b][4 * jj], acc[b][4 * jj + 1]);
                *reinterpret_cast<__nv_bfloat162*>(st + (lr0 + 8) * (WG_N + YPAD) +
                                                   8 * jj + 2 * t4) =
                    __floats2bfloat162_rn(acc[b][4 * jj + 2], acc[b][4 * jj + 3]);
            }
        }
        named_bar_sync(wbar, 128);
        constexpr int CH = WG_N / 8;  // 16-byte chunks of one stage row
        bf16* yimg = p.y + (size_t)un.n * p.H * p.W * p.Cout;  // offsets < 2^31
#pragma unroll
        for (int idx = wtid; idx < WG_ROWS * CH; idx += 128) {
            const int lr = idx / CH, ch = idx % CH;
            const int m = rowbase + lr;
            const int hh = un.h0 + (m >> p.twl), ww = un.w0 + (m & (p.tw - 1));
            const int gc = un.n0 + colbase + ch * 8;
            if (hh < p.H && ww < p.W && gc < p.Cout)
                *reinterpret_cast<uint4*>(yimg + (hh * p.W + ww) * p.Cout + gc) =
                    *reinterpret_cast<const uint4*>(st + lr * (WG_N + YPAD) + ch * 8);
        }
        if (!accum) flush();
    }
    if (accum && cur_n >= 0) flush();
}

// stats[n][s][c] = sum over t, in order, of the partial at t * t_stride +
// n * n_stride + s * Cout + c
__global__ void stats_sum_kernel(const float* __restrict__ partial,
                                 float* __restrict__ stats, int N, int Cout, int tiles,
                                 long long t_stride, long long n_stride) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N * 2 * Cout) return;
    const int c = i % Cout, s = (i / Cout) % 2, n = i / (2 * Cout);
    const float* p = partial + n * n_stride + s * Cout + c;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < tiles; ++t) acc = __fadd_rn(acc, p[t * t_stride]);
    stats[i] = acc;
}

// -- host side --------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

int current_device() {
    int dev = 0;
    cudaGetDevice(&dev);
    return dev >= 0 && dev < MAX_DEVICES ? dev : 0;
}

// the SM count of the current device, asked once per device
int sm_count() {
    static int count[MAX_DEVICES] = {0};
    const int dev = current_device();
    if (count[dev] == 0) {
        int n = 0;
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        count[dev] = n > 0 ? n : 1;
    }
    return count[dev];
}

struct Plan {
    int bn, mode, mb, kid, tile, grid, stat_tiles;
    long long scratch;  // fp32 elements
    int smem;
    Params p;
};

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The tile configuration of one launch, from its shape: the 128-pixel tile,
// or the 64-pixel tile for images of at most 8x8; the weights resident where
// they fit. Returns 0, or cudaErrorInvalidValue for a shape the kernel does
// not take.
int make_plan(int N, int H, int W, int C, int Cout, Plan* pl) {
    if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || C % 32 || Cout % 8 ||
        (long long)H * W * (C > Cout ? C : Cout) >= (1LL << 31))
        return cudaErrorInvalidValue;
    Params& p = pl->p;
    p = Params{};
    p.N = N; p.H = H; p.W = W; p.C = C; p.Cout = Cout;
    // BN 64 at images of at most 8 x 8: twice the blocks of BN 128 on the
    // card (measured faster at 8 x 8 x 512 -> 512, and than splitting K
    // there by a second pass, PERF.md)
    const int bn = Cout <= 32 ? 32 : Cout <= 64 || (H <= 8 && W <= 8) ? 64 : 128;
    const int mode = H <= 8 && W <= 8 && bn >= 64 ? 1 : 0;
    const int wg_n = mode == 1 ? bn / 2 : bn;
    pl->bn = bn;
    pl->mode = mode;
    p.ct = (Cout + bn - 1) / bn;
    p.tw = W <= 8 || mode == 1 ? 8 : 16;
    p.twl = p.tw == 8 ? 3 : 4;
    p.cw = C % 64 == 0 ? 64 : 32;
    p.nchunks = C / p.cw;
    p.b_stage = p.cw * bn * 2;
    const int red_bytes = 2 * 2 * 8 * bn * 4;
    const int bar_bytes = 8 * (3 * MAX_HALO + 2 * MAX_STAGES);
    // 256-pixel tiles (two m64 row blocks per warpgroup) where the weights
    // stay resident beside them (BN 32, one Cout tile; wider accumulators
    // would spill), else 128-pixel tiles, or 64 at images of at most 8 x 8.
    // The weights stay resident where they fit beside the deepest halo ring
    // that fits; else a weight ring of up to 12 slices beside a 2-stage
    // halo ring.
    const bool wide = mode == 0 && wg_n <= 32 && p.ct == 1;
    for (int mb = wide ? 2 : 1;; --mb) {
        pl->mb = mb;
        pl->tile = mode == 0 ? 128 * mb : 64;
        p.th = pl->tile / p.tw;
        p.tiles_w = (W + p.tw - 1) / p.tw;
        p.tiles = p.tiles_w * ((H + p.th - 1) / p.th);
        p.halo_bytes = (p.tw + 2) * (p.th + 2) * p.cw * 2;
        p.halo_stage = round_up(p.halo_bytes, 1024);
        const int y_bytes = 2 * 64 * mb * (wg_n + YPAD) * 2;
        auto stages = [&](int nh) {
            const int fixed = 1024 + nh * p.halo_stage + y_bytes + red_bytes + bar_bytes;
            const int fit = (MAX_SMEM - fixed) / p.b_stage;
            return fit < MAX_STAGES ? fit : MAX_STAGES;
        };
        p.resident = 0;
        if (p.ct == 1)
            for (int nh = MAX_HALO; nh >= 2 && !p.resident; --nh)
                if (9 * p.nchunks <= stages(nh)) {
                    p.resident = 1;
                    p.nh = nh;
                    p.nb = 9 * p.nchunks;
                }
        if (mb == 2 && !p.resident) continue;
        if (!p.resident) {
            p.nh = 2;
            p.nb = stages(2) < 12 ? stages(2) : 12;
        }
        // a wgmma stage waits for all its taps' weight slices at once
        if (p.nb < (p.cw == 32 && bn <= 64 ? 9 : 3)) return cudaErrorInvalidValue;
        p.off_b = p.nh * p.halo_stage;
        p.off_y = p.off_b + p.nb * p.b_stage;
        p.off_red = p.off_y + y_bytes;
        p.off_bar = p.off_red + red_bytes;
        pl->smem = p.off_bar + bar_bytes + 1024;  // + the alignment slack
        break;
    }
    pl->kid = mode == 1 ? 3 : pl->mb == 2 ? 4 : (bn == 32 ? 0 : bn == 64 ? 1 : 2);
    const long long units = (long long)N * p.tiles * p.ct;
    if (units > 0x7fffffff) return cudaErrorInvalidValue;
    p.units = (int)units;
    pl->grid = p.units < sm_count() ? p.units : sm_count();
    // statistics partials: one row per block and image when the units of a
    // block accumulate (narrow accumulators, one Cout tile), else one per
    // tile
    p.accum = wg_n <= 64 && p.ct == 1;
    pl->stat_tiles = p.accum ? pl->grid : p.tiles;
    pl->scratch = (long long)N * pl->stat_tiles * 2 * Cout;
    return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library does not link libcuda)
EncodeTiled encode_fn() {
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                    &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

CUtensorMapSwizzle swizzle_for(int row_bytes) {
    return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
           : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B;
}

// encode failures are returned as 1000 + CUresult
int encode_maps(const Plan& pl, const void* x, const void* w, CUtensorMap* xm,
                CUtensorMap* wm) {
    EncodeTiled enc = encode_fn();
    if (!enc) return 1000 + CUDA_ERROR_NOT_FOUND;
    const Params& p = pl.p;
    const cuuint64_t xdim[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W, (cuuint64_t)p.H,
                                (cuuint64_t)p.N};
    const cuuint64_t xstr[3] = {(cuuint64_t)p.C * 2, (cuuint64_t)p.W * p.C * 2,
                                (cuuint64_t)p.H * p.W * p.C * 2};
    const cuuint32_t xbox[4] = {(cuuint32_t)p.cw, (cuuint32_t)(p.tw + 2),
                                (cuuint32_t)(p.th + 2), 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    CUresult r = enc(xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim,
                     xstr, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     swizzle_for(p.cw * 2), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 1000 + (int)r;
    const int wg_n = pl.mode == 1 ? pl.bn / 2 : pl.bn;
    const int atom = wg_n < 64 ? wg_n : 64;
    const cuuint64_t wdim[2] = {(cuuint64_t)p.Cout, (cuuint64_t)9 * p.C};
    const cuuint64_t wstr[1] = {(cuuint64_t)p.Cout * 2};
    const cuuint32_t wbox[2] = {(cuuint32_t)atom, (cuuint32_t)p.cw};
    r = enc(wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdim, wstr,
            wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(atom * 2),
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

typedef void (*KernelFn)(CUtensorMap, CUtensorMap, Params);

constexpr int KERNELS = 5;  // instantiations per chunk width

template <int CW>
KernelFn kernel_cw(int kid) {
    switch (kid) {
        case 0: return fused_conv_sm90<32, 0, CW, 1>;
        case 1: return fused_conv_sm90<64, 0, CW, 1>;
        case 2: return fused_conv_sm90<128, 0, CW, 1>;
        case 3: return fused_conv_sm90<64, 1, CW, 1>;
        default: return fused_conv_sm90<32, 0, CW, 2>;
    }
}

KernelFn kernel_for(const Plan& pl) {
    return pl.p.cw == 64 ? kernel_cw<64>(pl.kid) : kernel_cw<32>(pl.kid);
}

// lets the plan's instantiation use all of a block's shared memory, once
// per instantiation and device
cudaError_t allow_smem(const Plan& pl) {
    static bool done[MAX_DEVICES][2][KERNELS] = {};
    bool& d = done[current_device()][pl.p.cw == 64][pl.kid];
    if (d) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel_for(pl), cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    d = e == cudaSuccess;
    return e;
}

}  // namespace

// fp32 elements of the scratch buffer (statistics partials) that one launch
// needs; -1 for a shape the kernel does not take.
extern "C" long long ts2d_fused_scratch_floats(int N, int H, int W, int C, int Cout) {
    Plan pl;
    return make_plan(N, H, W, C, Cout, &pl) ? -1 : pl.scratch;
}

// The launch's configuration and the kernel instantiation's resources:
// info = {BN, tile pixels, mode (0: a 128- or 256-pixel tile split by rows,
// 1: a 64-pixel tile with BN split between the warpgroups), resident
// weights, work units, grid, registers per thread at entry, static shared
// bytes, dynamic shared bytes, local (spill) bytes per thread, blocks per
// SM}. Returns a CUDA error code.
extern "C" int ts2d_fused_kernel_info(int N, int H, int W, int C, int Cout, int* info) {
    Plan pl;
    int err = make_plan(N, H, W, C, Cout, &pl);
    if (err) return err;
    KernelFn kern = kernel_for(pl);
    cudaError_t e = allow_smem(pl);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kern);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, pl.smem);
    if (e != cudaSuccess) return (int)e;
    const int vals[11] = {pl.bn, pl.tile, pl.mode, pl.p.resident, pl.p.units, pl.grid,
                          attr.numRegs, (int)attr.sharedSizeBytes, pl.smem,
                          (int)attr.localSizeBytes, blocks};
    for (int i = 0; i < 11; ++i) info[i] = vals[i];
    return 0;
}

// x (N, H, W, C) bf16, scale/shift (N, C) fp32 (unread when apply_normact is
// 0), w (3, 3, C, Cout) bf16, b (Cout) fp32, all contiguous, x and w 16-byte
// aligned; writes y (N, H, W, Cout) bf16, the scratch (ts2d_fused_scratch_floats
// elements) and stats (N, 2, Cout) fp32 on `stream`. Returns 0, a CUDA error
// code (cudaGetLastError() after each launch), or 1000 + the CUresult of a
// failed tensor-map encode.
extern "C" int ts2d_fused_norm_act_conv(const void* x, const float* scale,
                                        const float* shift, const void* w,
                                        const float* b, void* y, float* scratch,
                                        float* stats, int N, int H, int W, int C,
                                        int Cout, float slope, int apply_normact,
                                        void* stream) {
    Plan pl;
    int err = make_plan(N, H, W, C, Cout, &pl);
    if (err) return err;
    if (apply_normact && (!scale || !shift)) return cudaErrorInvalidValue;
    CUtensorMap xm, wm;
    err = encode_maps(pl, x, w, &xm, &wm);
    if (err) return err;
    Params& p = pl.p;
    p.scale = scale;
    p.shift = shift;
    p.bias = b;
    p.y = static_cast<bf16*>(y);
    p.act = apply_normact != 0;
    p.slope = slope;
    p.out = scratch;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    KernelFn kern = kernel_for(pl);
    cudaError_t e = allow_smem(pl);
    if (e != cudaSuccess) return (int)e;
    kern<<<pl.grid, THREADS, pl.smem, st>>>(xm, wm, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // partials (grid, N, 2, Cout) of an accumulating kernel, else (N, tiles,
    // 2, Cout)
    const long long row = 2LL * Cout;
    const int total = N * 2 * Cout;
    stats_sum_kernel<<<(total + 255) / 256, 256, 0, st>>>(
        scratch, stats, N, Cout, pl.stat_tiles, p.accum ? N * row : row,
        p.accum ? row : pl.stat_tiles * row);
    return (int)cudaGetLastError();
}
