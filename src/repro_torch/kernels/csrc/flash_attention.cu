// Flash attention, forward, for sm_90a:
//     out[b, i, h, :] = sum_j softmax_j(s[i, j]) v[b, j, h / g, :]
//     s[i, j] = cap_fn(dot(q[b, i, h, :], k[b, j, h / g, :]) * hd^-0.5)
// masked to the finite -1e30 where key j is not visible from query i
// (causal: q_offset + i >= j; window: q_offset + i - j < window).
//
// Replaces the TPU kernel `_fa_kernel` / `flash_attention_fwd` of
// src/repro/kernels/flash_attention.py, and computes the function of the
// model's scan, `flash_attention` in src/repro/models/attention.py, which
// is a superset (window, q_offset, ragged lengths), so every attention
// call of Model.forward on a card goes through this file.  It reads the
// JAX layout directly: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), out like q;
// no transpose and no repeat of K/V (GQA: query head h reads KV head
// h / (H / KV)).  Two kernels, one per dtype family, one launch per call:
//
// bfloat16 / float16: `flash_kernel_tc`, on the tensor cores.
//   What bounds it: operations, 4 * B * H * hd * (visible query-key
//   pairs) at the 989 TFLOP/s of the 16-bit tensor cores.  At
//   qwen2-1.5b's layer (B=1, S=4096, H=12, KV=2, hd=128, causal):
//   5.2e10 operations -> 0.052 ms against 29 MB -> 0.009 ms of bytes.
//   What the design does about it: both products run as warpgroup MMAs
//   (wgmma) with float32 accumulators.  A block is 384 threads: two
//   consumer warpgroups of 64 query rows each (BQ = 128) and one producer
//   warpgroup, which gives its registers to the consumers (setmaxnreg 24
//   and 240: without it ptxas caps the block at 168 registers a thread
//   and spills the accumulators).  One producer thread loads the block's
//   Q tile once and streams K and V tiles (BK = 128 keys, 64 at hd = 256)
//   through a 2-stage ring in shared memory with TMA (a 4-D tensor map of
//   the (B, S, heads, hd) layout, 128-byte swizzle, rows past S and
//   columns past hd filled with zeros by the hardware); "full" and "empty"
//   mbarriers, one pair for K and one for V per stage, hand each tile
//   between producer and consumers, so K of the next tile loads while
//   this tile's P V runs.  S = Q K^T reads both operands from shared
//   memory (K's (key, hd) rows are the K-major B operand); the float32 S
//   accumulator is scaled, capped, masked and exponentiated in registers
//   and rounded to 16-bit A fragments (an m64nN accumulator's layout is
//   that of the register A operand of m64nNk16), so O += P V takes A from
//   registers and V from shared memory with the transpose bit: V is never
//   transposed in memory.  hd is padded with zeros to 64/128/256 (TMA's
//   out-of-bounds fill), so bf16/f16 inputs need hd % 8 == 0 (16-byte
//   rows for TMA).  Shared memory: Q 32 KB + K/V 128 KB at hd = 128; Q
//   64 KB + K/V 128 KB at hd = 256.  Inside a warpgroup S, softmax and
//   P V run one after the other; the two warpgroups overlap each other
//   only through the scheduler.  Issuing the next tile's S before the
//   last tile's P V (FlashAttention-3's intra-warpgroup overlap) was
//   slower here: ptxas serializes the two wgmma groups (C7513) when the
//   softmax between them has run-time branches, and making them
//   compile-time slowed the plain loop.  Not done either: ping-pong
//   between warpgroups, a persistent grid, TMA stores of the output.
//
// float32: `flash_kernel_f32`, on the CUDA cores (exact float32 has no
//   tensor-core path).  Bound: the same operations at the 67 TFLOP/s of
//   float32 FMAs (0.77 ms at the layer above).  One block of 256 threads
//   per (64 query rows, batch x head) walks 64-key tiles staged through
//   shared memory (K and V share one buffer) and does every product as
//   float32 FMAs (4x4 register tile for Q.K^T, 4 rows x hd/16 columns per
//   thread for P.V).
//
// Both: tiles entirely past the diagonal (causal) or before the window
// are skipped, and query tiles are launched longest-first, so the causal
// triangle's long rows do not form the tail.
//
// Arithmetic contract (the plain version, kernels/ref.py, converts the
// inputs to float32, scales q by the float32 hd^-0.5 before the dot and
// does everything else in float32):
// - float32 kernel: the same steps; only the order of the sums differs.
// - 16-bit kernel: the products of bf16 x bf16 (f16 x f16) are exact in
//   float32, so scaling the float32 dot afterwards instead of q before it
//   differs only by float32 rounding (q * scale is never rounded to 16
//   bits).  Scores and the softmax are float32 in the log2 domain
//   (hd^-0.5 * log2(e) folded into one multiply, exp2 instead of exp).
//   P is rounded to the input's 16-bit type before P.V: at most 2^-9
//   relative per weight in bf16 (2^-11 in f16), so the output moves by
//   at most 2^-9 * max|v| (2^-11 * max|v|); l sums the unrounded float32
//   p.  The tests and chip_smoke.py allow twice that, plus one output ulp.
// - Both: masked scores are -1e30, never -inf: a tile in which a row sees
//   no key gives p = exp(0) = 1 garbage that the first visible key wipes
//   exactly (its correction factor exp(-1e30 - m) is 0); with -inf that
//   step is NaN.  Keys past Sk (the ragged last tile) are -inf and give
//   p = 0.  Skipping a tile is exact only when every row of the block has
//   a visible key (a fully masked row averages over ALL keys in the
//   reference): true when causal and 0 <= q_pos < Sk for every row.  The
//   output is acc / max(l, 1e-30), rounded once to q's type.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// key tiles [kt_lo, kt_hi) a block of query rows [q0, q0 + bq) visits
struct TileRange {
    int lo, hi;
};

__device__ __forceinline__ TileRange key_tiles(int q0, int bq, int bk,
                                               int Sq, int Sk,
                                               long long q_offset,
                                               long long window,
                                               int causal) {
    TileRange r{0, (Sk + bk - 1) / bk};
    const long long q_lo = q_offset + q0;
    const long long q_hi = q_lo + min(bq, Sq - q0) - 1;
    if (causal && q_lo >= 0 && q_hi < Sk) {
        r.hi = (int)(q_hi / bk) + 1;
        const long long first = q_lo - window + 1;
        if (window > 0 && first > 0) r.lo = (int)(first / bk);
    }
    return r;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty owns rows 4ty..4ty+3, tx
                                // owns keys tx + 16j and 1/16 of hd

template <int HDP>
struct Layout {
    static constexpr int QST = HDP + 4;   // row stride of the Q, K/V tiles
    static constexpr int PST = BQ + 4;    // row stride of P^T (key-major)
    static constexpr size_t bytes =
        (size_t)(BQ * QST + BK * QST + BK * PST) * sizeof(float);
};

// rows [row0, row0 + 64) of a (rows, hd) slab with row stride `stride`
// into a tile, times `mul`; rows past n_rows and columns past hd are zero
template <int HDP>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride, int row0,
                                      int n_rows, int hd, float mul) {
    constexpr int QST = Layout<HDP>::QST;
    for (int i = threadIdx.x; i < 64 * HDP; i += THREADS) {
        const int r = i / HDP, d = i % HDP;
        float x = 0.f;
        if (row0 + r < n_rows && d < hd)
            x = src[(long long)(row0 + r) * stride + d] * mul;
        dst[r * QST + d] = x;
    }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int Sq, int Sk, int H, int KV, int hd, long long q_offset,
                 long long window, int causal, float cap, float scale) {
    constexpr int QST = Layout<HDP>::QST;
    constexpr int PST = Layout<HDP>::PST;
    constexpr int COLS = HDP / 16;            // head dims per thread (P.V)
    constexpr int VW = COLS < 4 ? COLS : 4;   // their vector width
    constexpr int NJ = COLS / VW;
    extern __shared__ float4 smem_f4[];
    float* Qs = reinterpret_cast<float*>(smem_f4);
    float* KVs = Qs + BQ * QST;
    float* Pt = KVs + BK * QST;

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int q0 = qt * BQ;
    const long long q_stride = (long long)H * hd;
    const long long kv_stride = (long long)KV * hd;
    const float* qb = q + ((long long)b * Sq * H + h) * hd;
    const float* kb = k + ((long long)b * Sk * KV + kvh) * hd;
    const float* vb = v + ((long long)b * Sk * KV + kvh) * hd;
    float* ob = out + ((long long)b * Sq * H + h) * hd;

    stage<HDP>(Qs, qb, q_stride, q0, Sq, hd, scale);

    const long long q_lo = q_offset + q0;
    const TileRange kt_range =
        key_tiles(q0, BQ, BK, Sq, Sk, q_offset, window, causal);

    float m[4], l[4], acc[4][COLS];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
    }

    for (int kt = kt_range.lo; kt < kt_range.hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();        // Q staged / last tile's V and P read
        stage<HDP>(KVs, kb, kv_stride, k0, Sk, hd, 1.f);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < HDP; d += 4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4*>(
                    &Qs[(ty * 4 + i) * QST + d]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kv[j] = *reinterpret_cast<const float4*>(
                    &KVs[(tx + 16 * j) * QST + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float a = s[i][j];
                    a = fmaf(qv[i].x, kv[j].x, a);
                    a = fmaf(qv[i].y, kv[j].y, a);
                    a = fmaf(qv[i].z, kv[j].z, a);
                    a = fmaf(qv[i].w, kv[j].w, a);
                    s[i][j] = a;
                }
        }

        // cap, mask, online softmax; the 16 threads of a row group are
        // lanes of one half-warp, so xor-shuffles up to 8 stay inside it
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const long long qp = q_lo + ty * 4 + i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kp = k0 + tx + 16 * j;
                float x = s[i][j];
                if (cap != 0.f) x = cap * tanhf(x / cap);
                if (kp >= Sk)
                    x = -INFINITY;
                else if ((causal && qp < kp) ||
                         (window > 0 && qp - kp >= window))
                    x = NEG_INF;
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                s[i][j] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float corr = expf(m[i] - m_new);
            l[i] = l[i] * corr + sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[i][c] *= corr;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(&Pt[(tx + 16 * j) * PST + ty * 4]) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

        __syncthreads();        // K read by all, P written
        stage<HDP>(KVs, vb, kv_stride, k0, Sk, hd, 1.f);
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                &Pt[c * PST + ty * 4]);
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) {
                const float* vrow = &KVs[c * QST + tx * VW + jj * 16 * VW];
                float vv[VW];
                if constexpr (VW == 4) {
                    const float4 t = *reinterpret_cast<const float4*>(vrow);
                    vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
                } else if constexpr (VW == 2) {
                    const float2 t = *reinterpret_cast<const float2*>(vrow);
                    vv[0] = t.x; vv[1] = t.y;
                } else {
                    vv[0] = vrow[0];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < VW; ++e)
                        acc[i][jj * VW + e] =
                            fmaf(p[i], vv[e], acc[i][jj * VW + e]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r >= Sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int e = 0; e < VW; ++e) {
                const int d = tx * VW + jj * 16 * VW + e;
                if (d < hd)
                    ob[(long long)r * q_stride + d] =
                        acc[i][jj * VW + e] / den;
            }
    }
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int hd,
                   long long q_offset, long long window, int causal,
                   float cap, float scale, cudaStream_t stream) {
    const size_t smem = Layout<HDP>::bytes;
    // above 48 KB dynamic shared memory must be asked for, once per device
    static unsigned configured = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32 || !((configured >> dev) & 1u)) {
        err = cudaFuncSetAttribute(flash_kernel_f32<HDP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return err;
        if (dev < 32) configured |= 1u << dev;
    }
    const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
    flash_kernel_f32<HDP><<<grid, THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq,
        Sk, H, KV, hd, q_offset, window, causal, cap, scale);
    return cudaGetLastError();
}

cudaError_t by_width(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int H, int KV, int hd,
                     long long q_offset, long long window, int causal,
                     float cap, float scale, cudaStream_t s) {
    if (hd <= 32)
        return launch<32>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                          window, causal, cap, scale, s);
    if (hd <= 64)
        return launch<64>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                          window, causal, cap, scale, s);
    if (hd <= 128)
        return launch<128>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                           window, causal, cap, scale, s);
    return launch<256>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                       window, causal, cap, scale, s);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 / float16: tensor cores (wgmma), TMA, mbarrier ring
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;         // query rows per block: 2 warpgroups x 64
constexpr int THREADS = 384;    // 2 consumer + 1 producer warpgroup
constexpr int STAGES = 2;       // K/V ring depth
constexpr int ROW = 128;        // bytes per row of a 64-column chunk
constexpr float LOG2E = 1.4426950408889634f;

template <int HDP>
struct Cfg {
    static constexpr int BK = HDP == 256 ? 64 : 128;   // keys per tile
    static constexpr int CHUNKS = HDP / 64;            // 64-column chunks
    static constexpr int Q_BYTES = BQ * HDP * 2;
    static constexpr int KV_BYTES = BK * HDP * 2;      // one K or V tile
    static constexpr int PV_N = HDP < 128 ? HDP : 128; // n of a P.V wgmma
    static constexpr int PV_PARTS = HDP / PV_N;
    static constexpr int BARS = 1 + 4 * STAGES;   // q, k/v full, k/v empty
    // 1024 bytes of slack: the 128-byte swizzle repeats every 1024 bytes,
    // and every tile starts on such a boundary
    static constexpr size_t smem =
        1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// one box of a 4-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (K-major: unused, 16; MN-major: the stride
// between 64-column chunks), stride byte offset 1024 (8 rows of 128 B)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
           (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from touching accumulator registers across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, float32 accumulators.  ss: A and B from shared memory,
// both K-major (S = Q K^T).  rs: A from registers, B from shared memory
// MN-major (the transpose bit; O += P V).
#define SIRA_R32 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
    " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
    " %30, %31}"
#define SIRA_R64 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
    " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29," \
    " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43," \
    " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57," \
    " %58, %59, %60, %61, %62, %63}"
#define SIRA_D8(i)                                                        \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
        "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SIRA_D32 SIRA_D8(0), SIRA_D8(8), SIRA_D8(16), SIRA_D8(24)
#define SIRA_D64 SIRA_D32, SIRA_D8(32), SIRA_D8(40), SIRA_D8(48), SIRA_D8(56)

template <typename T, int N>
struct Mma;

template <>
struct Mma<__nv_bfloat16, 64> {
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            SIRA_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
            : SIRA_D32 : "l"(a), "l"(b), "r"(scale_d));
    }
    static __device__ __forceinline__ void rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            SIRA_R32 ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
            : SIRA_D32
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    }
};

template <>
struct Mma<__nv_bfloat16, 128> {
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            SIRA_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
            : SIRA_D64 : "l"(a), "l"(b), "r"(scale_d));
    }
    static __device__ __forceinline__ void rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            SIRA_R64 ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
            : SIRA_D64
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    }
};

template <>
struct Mma<__half, 64> {
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
            SIRA_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
            : SIRA_D32 : "l"(a), "l"(b), "r"(scale_d));
    }
    static __device__ __forceinline__ void rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
            SIRA_R32 ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
            : SIRA_D32
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    }
};

template <>
struct Mma<__half, 128> {
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
            SIRA_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
            : SIRA_D64 : "l"(a), "l"(b), "r"(scale_d));
    }
    static __device__ __forceinline__ void rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
        asm volatile(
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
            SIRA_R64 ", {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
            : SIRA_D64
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    }
};

#undef SIRA_R32
#undef SIRA_R64
#undef SIRA_D8
#undef SIRA_D32
#undef SIRA_D64

// S = Q K^T of one key tile (stage base sKs), issued and committed
template <typename T, int HDP>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<HDP>::BK / 2],
                                         uint32_t sQ, uint32_t sKs, int wg) {
    constexpr int BK = Cfg<HDP>::BK;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;   // 16 columns = 32 bytes
        Mma<T, BK>::ss(
            sc, desc_sw128(sQ + (kk / 4) * BQ * ROW + wg * 64 * ROW + col, 16),
            desc_sw128(sKs + (kk / 4) * BK * ROW + col, 16), kk > 0);
    }
    wg_commit();
}

// O += P V of one key tile (stage base sVs), issued and committed
template <typename T, int HDP>
__device__ __forceinline__ void issue_pv(
    float (&o)[Cfg<HDP>::PV_PARTS][Cfg<HDP>::PV_N / 2],
    const uint32_t (&pa)[Cfg<HDP>::BK / 16][4], uint32_t sVs) {
    using C = Cfg<HDP>;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < C::PV_PARTS; ++p)
            Mma<T, C::PV_N>::rs(
                o[p], pa[kk],
                desc_sw128(sVs + p * (C::PV_N / 64) * C::BK * ROW +
                               kk * 16 * ROW,
                           C::BK * ROW));
    wg_commit();
}

// what a consumer thread knows of its rows: positions of rows r and r + 8,
// the range of its warpgroup's 64 rows, its column offset c2
struct Rows {
    long long qp0, wg_lo, wg_hi;
    int c2, Sk, causal;
    long long window;
    float cap, scale;
};

// scale (log2 domain), cap and mask the S tile of keys [k0, k0 + BK),
// update the running max m and this thread's part of the sum l, and round
// P in place into A fragments (keys 16kk..16kk+15 are the accumulator's
// column groups 2kk (a0, a1) and 2kk + 1 (a2, a3)); corr is the factor
// that moves O to the new max
template <typename T, int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             uint32_t (&pa)[BK / 16][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             const Rows& rw) {
    if (rw.cap != 0.f) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e)
            sc[e] = rw.cap * tanhf(sc[e] * rw.scale / rw.cap) * LOG2E;
    } else {
        const float sl2 = rw.scale * LOG2E;
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] *= sl2;
    }
    if (k0 + BK > rw.Sk || (rw.causal && k0 + BK - 1 > rw.wg_lo) ||
        (rw.window > 0 && rw.wg_hi - k0 >= rw.window)) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
            const int kp = k0 + 8 * (e / 4) + rw.c2 + (e & 1);
            const long long qp = rw.qp0 + 8 * ((e >> 1) & 1);
            if (kp >= rw.Sk)
                sc[e] = -INFINITY;
            else if ((rw.causal && qp < kp) ||
                     (rw.window > 0 && qp - kp >= rw.window))
                sc[e] = NEG_INF;
        }
    }
    // the four lanes of a quad share a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
        mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
        corr[h2] = ex2(m[h2] - mx[h2]);
        m[h2] = mx[h2];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
        const float p0 = ex2(sc[4 * j] - m[0]);
        const float p1 = ex2(sc[4 * j + 1] - m[0]);
        const float p2 = ex2(sc[4 * j + 2] - m[1]);
        const float p3 = ex2(sc[4 * j + 3] - m[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[j / 2][2 * (j % 2)] = pack2<T>(p0, p1);
        pa[j / 2][2 * (j % 2) + 1] = pack2<T>(p2, p3);
    }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
}

template <int HDP>
__device__ __forceinline__ void rescale(
    float (&o)[Cfg<HDP>::PV_PARTS][Cfg<HDP>::PV_N / 2],
    const float (&corr)[2]) {
#pragma unroll
    for (int p = 0; p < Cfg<HDP>::PV_PARTS; ++p)
#pragma unroll
        for (int e = 0; e < Cfg<HDP>::PV_N / 2; ++e)
            o[p][e] *= corr[(e >> 1) & 1];
}

// Shared memory, from a 1024-byte boundary: Q as CHUNKS column chunks of
// BQ rows x 128 B; K stages; V stages (each CHUNKS chunks of BK rows x
// 128 B); then the mbarriers.  Every chunk is 128-byte swizzled by TMA,
// which is the layout the wgmma descriptors name.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel_tc(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                T* __restrict__ out, int Sq, int Sk, int H, int KV, int hd,
                long long q_offset, long long window, int causal, float cap,
                float scale) {
    using C = Cfg<HDP>;
    constexpr int BK = C::BK;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t sQ = (raw + 1023u) & ~1023u;
    const uint32_t sK = sQ + C::Q_BYTES;                // + stage * KV_BYTES
    const uint32_t sV = sK + STAGES * C::KV_BYTES;
    const uint32_t bar_q = sV + STAGES * C::KV_BYTES;
    // then k_full, v_full, k_empty, v_empty: STAGES each, 8 bytes each
    auto bar = [&](int kind, int s) {
        return bar_q + 8u * (1 + kind * STAGES + s);
    };
    enum { K_FULL, V_FULL, K_EMPTY, V_EMPTY };

    const int tid = threadIdx.x;
    const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int q0 = qt * BQ;
    const TileRange kt_range =
        key_tiles(q0, BQ, BK, Sq, Sk, q_offset, window, causal);

    if (tid == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bar(K_FULL, s), 1);
            mbar_init(bar(V_FULL, s), 1);
            mbar_init(bar(K_EMPTY, s), 8);   // lane 0 of each consumer warp
            mbar_init(bar(V_EMPTY, s), 8);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int wg = tid / 128;
    if (wg == 2) {
        // producer warpgroup: gives its registers to the consumers; one
        // thread issues every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
        if (tid == 256) {
            mbar_expect_tx(bar_q, C::Q_BYTES);
            for (int c = 0; c < C::CHUNKS; ++c)
                tma_load(sQ + c * BQ * ROW, &tm_q, bar_q, c * 64, h, q0, b);
            for (int kt = kt_range.lo, i = 0; kt < kt_range.hi; ++kt, ++i) {
                const int s = i % STAGES;
                const uint32_t ph = (i / STAGES) & 1;
                mbar_wait(bar(K_EMPTY, s), ph ^ 1);   // round 0 passes
                mbar_expect_tx(bar(K_FULL, s), C::KV_BYTES);
                for (int c = 0; c < C::CHUNKS; ++c)
                    tma_load(sK + s * C::KV_BYTES + c * BK * ROW, &tm_k,
                             bar(K_FULL, s), c * 64, kvh, kt * BK, b);
                mbar_wait(bar(V_EMPTY, s), ph ^ 1);
                mbar_expect_tx(bar(V_FULL, s), C::KV_BYTES);
                for (int c = 0; c < C::CHUNKS; ++c)
                    tma_load(sV + s * C::KV_BYTES + c * BK * ROW, &tm_v,
                             bar(V_FULL, s), c * 64, kvh, kt * BK, b);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
        // consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64);
        // this thread holds rows r and r + 8 of them (the m64 accumulator
        // layout), columns 8j + c2 and 8j + c2 + 1
        const int t = tid % 128, warp = t / 32, lane = t % 32;
        const int r = 16 * warp + lane / 4;
        Rows rw;
        rw.wg_lo = q_offset + q0 + 64 * wg;
        rw.wg_hi = rw.wg_lo + 63;
        rw.qp0 = rw.wg_lo + r;
        rw.c2 = 2 * (lane % 4);
        rw.Sk = Sk;
        rw.causal = causal;
        rw.window = window;
        rw.cap = cap;
        rw.scale = scale;

        float o[C::PV_PARTS][C::PV_N / 2];
#pragma unroll
        for (int p = 0; p < C::PV_PARTS; ++p)
#pragma unroll
            for (int i = 0; i < C::PV_N / 2; ++i) o[p][i] = 0.f;
        float m[2] = {NEG_INF, NEG_INF};   // running max, log2 domain
        float l[2] = {0.f, 0.f};           // this thread's part of the sum
        float corr[2];
        uint32_t pa[BK / 16][4];
        const int n = kt_range.hi - kt_range.lo;

        mbar_wait(bar_q, 0);
        for (int i = 0; i < n; ++i) {
            const int s = i % STAGES;
            const uint32_t ph = (i / STAGES) & 1;
            float sc[BK / 2];
            mbar_wait(bar(K_FULL, s), ph);
            issue_qk<T, HDP>(sc, sQ, sK + s * C::KV_BYTES, wg);
            wg_wait0();
            reg_fence(sc);
            if (lane == 0) mbar_arrive(bar(K_EMPTY, s));
            softmax_tile<T, BK>(sc, pa, m, l, corr,
                                (kt_range.lo + i) * BK, rw);
            rescale<HDP>(o, corr);
            mbar_wait(bar(V_FULL, s), ph);
            issue_pv<T, HDP>(o, pa, sV + s * C::KV_BYTES);
            wg_wait0();
#pragma unroll
            for (int p = 0; p < C::PV_PARTS; ++p) reg_fence(o[p]);
            if (lane == 0) mbar_arrive(bar(V_EMPTY, s));
        }

        // out = O / max(l, 1e-30), two 16-bit values per store
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
            float sum = l[h2];
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            const float den = fmaxf(sum, 1e-30f);
            const int row = q0 + 64 * wg + r + 8 * h2;
            if (row >= Sq) continue;
            T* orow = out + (((long long)b * Sq + row) * H + h) * hd;
#pragma unroll
            for (int p = 0; p < C::PV_PARTS; ++p)
#pragma unroll
                for (int j = 0; j < C::PV_N / 8; ++j) {
                    const int col = p * C::PV_N + 8 * j + rw.c2;
                    if (col < hd)
                        *reinterpret_cast<uint32_t*>(orow + col) =
                            pack2<T>(o[p][4 * j + 2 * h2] / den,
                                     o[p][4 * j + 2 * h2 + 1] / den);
                }
        }
    }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
    static EncodeTiled cached = nullptr;
    if (!cached) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || !p)
            return cudaErrorSymbolNotFound;
        cached = (EncodeTiled)p;
    }
    *fn = cached;
    return cudaSuccess;
}

template <typename T>
struct TmaType;
template <>
struct TmaType<__nv_bfloat16> {
    static constexpr CUtensorMapDataType value =
        CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<__half> {
    static constexpr CUtensorMapDataType value =
        CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// a (batch, seq, heads, hd) tensor as a 4-D map (hd innermost), boxes of
// 64 columns x `rows` rows of one head, 128-byte swizzle, zeros outside
bool make_map(EncodeTiled enc, CUtensorMap* map, CUtensorMapDataType ty,
              const void* ptr, int batch, int seq, int heads, int hd,
              int rows) {
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                                (cuuint64_t)seq, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                   (cuuint64_t)heads * hd * 2,
                                   (cuuint64_t)seq * heads * hd * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return enc(map, ty, 4, const_cast<void*>(ptr), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int hd,
                   long long q_offset, long long window, int causal,
                   float cap, float scale, cudaStream_t stream) {
    using C = Cfg<HDP>;
    EncodeTiled enc;
    cudaError_t err = encoder(&enc);
    if (err != cudaSuccess) return err;
    const CUtensorMapDataType ty = TmaType<T>::value;
    CUtensorMap mq, mk, mv;
    if (!make_map(enc, &mq, ty, q, B, Sq, H, hd, BQ) ||
        !make_map(enc, &mk, ty, k, B, Sk, KV, hd, C::BK) ||
        !make_map(enc, &mv, ty, v, B, Sk, KV, hd, C::BK))
        return cudaErrorInvalidValue;
    static unsigned configured = 0;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32 || !((configured >> dev) & 1u)) {
        err = cudaFuncSetAttribute(flash_kernel_tc<T, HDP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)C::smem);
        if (err != cudaSuccess) return err;
        if (dev < 32) configured |= 1u << dev;
    }
    const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
    flash_kernel_tc<T, HDP><<<grid, THREADS, C::smem, stream>>>(
        mq, mk, mv, (T*)out, Sq, Sk, H, KV, hd, q_offset, window, causal,
        cap, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int H, int KV, int hd,
                     long long q_offset, long long window, int causal,
                     float cap, float scale, cudaStream_t s) {
    // 16-byte rows for TMA, 16-byte aligned bases
    if (hd % 8 != 0 || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
        return cudaErrorInvalidValue;
    if (hd <= 64)
        return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                             window, causal, cap, scale, s);
    if (hd <= 128)
        return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                              window, causal, cap, scale, s);
    return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                          window, causal, cap, scale, s);
}

}  // namespace tc

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd), out (B, Sq, H, hd), contiguous,
// all of one type.  dtype_kind: 0 = float32, 1 = float16, 2 = bfloat16
// (16-bit types need hd % 8 == 0 and 16-byte aligned q, k, v).  causal:
// 0/1; window: 0 = none; logit_cap: 0 = none; scale: hd^-0.5 as float32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sira_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Sk, int H, int KV, int hd,
                                    long long q_offset, long long window,
                                    int causal, float logit_cap, float scale,
                                    int dtype_kind, void* stream) {
    if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
        hd <= 0 || hd > 256 || window < 0 || (long long)B * H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype_kind) {
    case 0:
        return (int)f32::by_width(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                  q_offset, window, causal, logit_cap, scale,
                                  s);
    case 1:
        return (int)tc::by_width<__half>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                         q_offset, window, causal, logit_cap,
                                         scale, s);
    case 2:
        return (int)tc::by_width<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H,
                                                KV, hd, q_offset, window,
                                                causal, logit_cap, scale, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
