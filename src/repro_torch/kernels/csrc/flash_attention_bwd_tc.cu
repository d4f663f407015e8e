// Flash attention, backward, on the tensor cores (sm_90a): the
// tensor_cores route of dK/dV and dQ, for bfloat16 / float16 with
// hd <= 128.  What it computes, what bounds it, its design and its
// arithmetic contract are in the note at the head of
// flash_attention_bwd.cu, which holds the cuda_cores route and the D
// kernel; kernels/flash_attention.py route_for picks the route.  Each C
// entry returns the cudaError_t of its launches.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_tc.cuh"
#include "hopper.cuh"

namespace {

using namespace sira::bwd;

namespace tc {

using namespace sira::flash;
using namespace sira::hopper;

constexpr int THREADS = 384;    // 2 consumer + 1 producer warpgroup
constexpr int STAGES = 2;       // depth of the streamed-tile ring
constexpr int ROW = 128;        // bytes per row of a 64-column chunk
constexpr float LOG2E = 1.4426950408889634f;
// DEAD_LSE in the log2 domain of the stored lse
constexpr float DEAD_LSE2 = DEAD_LSE * LOG2E;

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// A = rows [row0, row0 + 64) of a tile of `rows` rows (chunks of rows x
// 128 B), B = the n rows of a tile of n rows, both K-major over HDP: the
// float32 acc = A B^T, issued (not committed)
template <typename T, int HDP, int N>
__device__ __forceinline__ void issue_abt(float (&acc)[N / 2], uint32_t a,
                                          int rows, int row0, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;   // 16 columns = 32 bytes
        Mma<T, N>::ss(acc,
                      desc_sw128(a + (kk / 4) * rows * ROW + row0 * ROW + col,
                                 16),
                      desc_sw128(b + (kk / 4) * N * ROW + col, 16), kk > 0);
    }
}

// acc += A B with A = the 16-bit fragments of a (64, K) tile in registers
// (K / 16 k-steps) and B = a (K rows, HDP) tile in shared memory read
// MN-major (the transpose bit): nothing is transposed in memory; issued
template <typename T, int HDP, int K>
__device__ __forceinline__ void issue_ab(float (&acc)[HDP / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
        Mma<T, HDP>::rs(acc, a[kk], desc_sw128(b + kk * 16 * ROW, K * ROW));
}

// element e of an m64nN accumulator: row 8 ((e >> 1) & 1) + r of the
// warpgroup's 64, column 8 (e / 4) + c2 + (e & 1); the 16-bit A fragment
// of k-step kk holds columns 16 kk .. 16 kk + 15 (a[0], a[1]: columns
// 8 j + c2 of j = 2 kk; a[2], a[3]: j = 2 kk + 1)
template <typename T, int N>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[N / 16][4],
                                           const float (&x)[N / 2]) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
        a[j / 2][2 * (j % 2)] = pack2<T>(x[4 * j], x[4 * j + 1]);
        a[j / 2][2 * (j % 2) + 1] = pack2<T>(x[4 * j + 2], x[4 * j + 3]);
    }
}

// one pair: P from the dot x (unscaled), lse2 = lse log2(e); dS = P (dp -
// D), times 1 - tanh^2 of the capped score with a cap
struct Pair {
    float p, ds;
};
__device__ __forceinline__ Pair p_ds(float x, float dp, float lse2, float D,
                                     float sl2, float scale, float cap) {
    Pair r;
    if (cap != 0.f) {
        const float t = tanhf(x * scale / cap);
        r.p = ex2(fmaf(cap * t, LOG2E, -lse2));
        r.ds = r.p * (dp - D) * (1.f - t * t);
    } else {
        r.p = ex2(fmaf(x, sl2, -lse2));
        r.ds = r.p * (dp - D);
    }
    return r;
}

__device__ __forceinline__ bool hidden(long long qp, long long kp,
                                       const Mask& mk) {
    return (mk.causal && qp < kp) || (mk.window > 0 && qp - kp >= mk.window);
}

// whether any pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) is
// masked or lies past Sq or Sk (else no element needs a test)
__device__ __forceinline__ bool edge_tile(int q0, int nq, int k0, int nk,
                                          const Mask& mk) {
    const long long qlo = mk.q_offset + q0, qhi = qlo + nq - 1;
    return q0 + nq > mk.Sq || k0 + nk > mk.Sk ||
           (mk.causal && qlo < (long long)k0 + nk - 1) ||
           (mk.window > 0 && qhi - k0 >= mk.window);
}

// ---- dK, dV ----------------------------------------------------------------

template <int HDP>
struct DkdvCfg {
    static constexpr int BK = 128;      // keys a block: 64 a warpgroup
    static constexpr int BQ = 64;       // query rows a streamed tile
    static constexpr int CHUNKS = HDP / 64;
    static constexpr int KV_BYTES = BK * HDP * 2;   // the K or the V tile
    static constexpr int Q_BYTES = BQ * HDP * 2;    // one Q or dO tile
    static constexpr int ROWS_BYTES = 2 * BQ * 4;   // lse2 and D of a tile
    static constexpr int BARS = 1 + 2 * STAGES;     // kv, q full, q empty
    static constexpr size_t smem = 1024 + 2 * KV_BYTES +
                                   STAGES * (2 * Q_BYTES + ROWS_BYTES) +
                                   8 * BARS;
};

// One block per (batch x query head, key tile of 128): the K and V tiles
// load once; Q, dO (by TMA) and lse, D (by one producer warp) of each
// visible query tile stream through the ring.  Consumer warpgroup wg owns
// keys k0 + 64 wg + [0, 64): S^T = K Q^T and dP^T = V dO^T (ss), P^T and
// dS^T in registers, then dV += P^T dO and dK += dS^T Q (rs, dO and Q
// read MN-major).  dk, dv are written directly when g = 1; otherwise this
// head's float32 partials go to part_k, part_v (B, Sk, H, hd) and
// flash_bwd_dkdv_sum adds the g heads of a group.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, float* __restrict__ part_k,
                  float* __restrict__ part_v, int Sq, int Sk, int H, int KV,
                  int hd, long long q_offset, long long window, int causal,
                  float cap, float scale) {
    using C = DkdvCfg<HDP>;
    constexpr int BK = C::BK, BQ = C::BQ;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t sK = (raw + 1023u) & ~1023u;
    const uint32_t sV = sK + C::KV_BYTES;
    const uint32_t sQ0 = sV + C::KV_BYTES;   // stage s: Q, then dO
    const uint32_t sRows = sQ0 + STAGES * 2 * C::Q_BYTES;
    const uint32_t bar_kv = sRows + STAGES * C::ROWS_BYTES;
    auto q_full = [&](int s) { return bar_kv + 8u * (1 + s); };
    auto q_empty = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };
    // stage s: lse2 (BQ floats), then D (BQ floats)
    float* rows = reinterpret_cast<float*>(smem_raw + (sRows - raw));

    const int tid = threadIdx.x;
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int g = H / KV, kvh = h / g;
    const int k0 = blockIdx.y * BK;   // key tile 0 (the longest) first
    const Mask mk{Sq, Sk, causal, q_offset, window, cap, 1.f / (float)Sk};
    const TileRange qr =
        query_tiles(k0, BK, BQ, Sq, Sk, q_offset, window, causal);
    const int n = qr.hi - qr.lo;

    if (tid == 0) {
        mbar_init(bar_kv, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(q_full(s), 1 + 32);   // the TMA thread + the row warp
            mbar_init(q_empty(s), 8);       // lane 0 of each consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int wg = tid / 128;
    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
        const int t = tid - 256;
        if (t == 0) {
            mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
            for (int c = 0; c < C::CHUNKS; ++c) {
                tma_load(sK + c * BK * ROW, &tm_k, bar_kv, c * 64, kvh, k0,
                         b);
                tma_load(sV + c * BK * ROW, &tm_v, bar_kv, c * 64, kvh, k0,
                         b);
            }
            for (int i = 0; i < n; ++i) {
                const int s = i % STAGES;
                const uint32_t ph = (i / STAGES) & 1;
                const int q0 = (qr.lo + i) * BQ;
                const uint32_t sQ = sQ0 + s * 2 * C::Q_BYTES;
                mbar_wait(q_empty(s), ph ^ 1);   // round 0 passes
                mbar_expect_tx(q_full(s), 2 * C::Q_BYTES);
                for (int c = 0; c < C::CHUNKS; ++c) {
                    tma_load(sQ + c * BQ * ROW, &tm_q, q_full(s), c * 64, h,
                             q0, b);
                    tma_load(sQ + C::Q_BYTES + c * BQ * ROW, &tm_do,
                             q_full(s), c * 64, h, q0, b);
                }
            }
        } else if (t >= 32 && t < 64) {
            // the row warp: lse (times log2 e) and D of each tile; rows
            // past Sq read 0 (their pairs are masked)
            const int lane = t - 32;
            const float* lse_h = lse + ((long long)b * H + h) * Sq;
            const float* d_h = delta + ((long long)b * H + h) * Sq;
            for (int i = 0; i < n; ++i) {
                const int s = i % STAGES;
                const uint32_t ph = (i / STAGES) & 1;
                const int q0 = (qr.lo + i) * BQ;
                float* L = rows + s * 2 * BQ;
                mbar_wait(q_empty(s), ph ^ 1);
                for (int r = lane; r < BQ; r += 32) {
                    const bool in = q0 + r < Sq;
                    L[r] = in ? lse_h[q0 + r] * LOG2E : 0.f;
                    L[BQ + r] = in ? d_h[q0 + r] : 0.f;
                }
                mbar_arrive(q_full(s));
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
        // this thread: keys wk0 + r and wk0 + r + 8 (accumulator rows),
        // query columns 8 j + c2 and 8 j + c2 + 1 of each tile
        const int t = tid % 128, warp = t / 32, lane = t % 32;
        const int r = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
        const int wk0 = k0 + 64 * wg;
        const float sl2 = scale * LOG2E;
        float dv_acc[HDP / 2], dk_acc[HDP / 2];
#pragma unroll
        for (int e = 0; e < HDP / 2; ++e) dv_acc[e] = dk_acc[e] = 0.f;

        mbar_wait(bar_kv, 0);
        for (int i = 0; i < n; ++i) {
            const int s = i % STAGES;
            const uint32_t ph = (i / STAGES) & 1;
            const int q0 = (qr.lo + i) * BQ;
            const uint32_t sQ = sQ0 + s * 2 * C::Q_BYTES;
            const uint32_t sdO = sQ + C::Q_BYTES;
            const float* L = rows + s * 2 * BQ;
            float st[BQ / 2], dpt[BQ / 2];
            mbar_wait(q_full(s), ph);
            wg_fence();
            issue_abt<T, HDP, BQ>(st, sK, BK, 64 * wg, sQ);
            issue_abt<T, HDP, BQ>(dpt, sV, BK, 64 * wg, sdO);
            wg_commit();
            wg_wait0();
            reg_fence(st);
            reg_fence(dpt);

            const bool edge = edge_tile(q0, BQ, wk0, 64, mk);
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
                const float2 l2 =
                    *reinterpret_cast<const float2*>(L + 8 * j + c2);
                const float2 dd =
                    *reinterpret_cast<const float2*>(L + BQ + 8 * j + c2);
#pragma unroll
                for (int e4 = 0; e4 < 4; ++e4) {
                    const int e = 4 * j + e4;
                    const float lse2 = (e4 & 1) ? l2.y : l2.x;
                    Pair pd = p_ds(st[e], dpt[e], lse2, (e4 & 1) ? dd.y : dd.x,
                                   sl2, scale, cap);
                    if (edge) {
                        const int qi = q0 + 8 * j + c2 + (e4 & 1);
                        const int kp = wk0 + r + 8 * (e4 >> 1);
                        if (qi >= Sq || kp >= Sk) {
                            pd.p = 0.f;
                            pd.ds = 0.f;
                        } else if (hidden(q_offset + qi, kp, mk)) {
                            pd.p = lse2 < DEAD_LSE2 ? mk.inv_sk : 0.f;
                            pd.ds = 0.f;
                        }
                    }
                    st[e] = pd.p;
                    dpt[e] = pd.ds;
                }
            }
            uint32_t pa[BQ / 16][4], da[BQ / 16][4];
            pack_frags<T, BQ>(pa, st);
            pack_frags<T, BQ>(da, dpt);
            wg_fence();
            issue_ab<T, HDP, BQ>(dv_acc, pa, sdO);
            issue_ab<T, HDP, BQ>(dk_acc, da, sQ);
            wg_commit();
            wg_wait0();
            reg_fence(dv_acc);
            reg_fence(dk_acc);
            if (lane == 0) mbar_arrive(q_empty(s));
        }

        // dK = scale dS^T q; two values per store
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
            const int key = wk0 + r + 8 * h2;
            if (key >= Sk) continue;
            const long long at = (long long)b * Sk + key;
#pragma unroll
            for (int j = 0; j < HDP / 8; ++j) {
                const int col = 8 * j + c2;
                if (col >= hd) continue;
                const float k0v = dk_acc[4 * j + 2 * h2] * scale;
                const float k1v = dk_acc[4 * j + 2 * h2 + 1] * scale;
                const float v0 = dv_acc[4 * j + 2 * h2];
                const float v1 = dv_acc[4 * j + 2 * h2 + 1];
                if (g == 1) {
                    const long long o = (at * KV + kvh) * hd + col;
                    *reinterpret_cast<uint32_t*>(dk + o) = pack2<T>(k0v, k1v);
                    *reinterpret_cast<uint32_t*>(dv + o) = pack2<T>(v0, v1);
                } else {
                    const long long o = (at * H + h) * hd + col;
                    *reinterpret_cast<float2*>(part_k + o) =
                        make_float2(k0v, k1v);
                    *reinterpret_cast<float2*>(part_v + o) =
                        make_float2(v0, v1);
                }
            }
        }
    }
}

// the GQA sum: dk[b, j, kvh, :] = the g partials of heads kvh g ..
// kvh g + g - 1 added in head order, rounded once (blockIdx.y: 0 = dk,
// 1 = dv); rows = B Sk KV, four values a thread
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dkdv_sum(const float* __restrict__ part_k,
                   const float* __restrict__ part_v, T* __restrict__ dk,
                   T* __restrict__ dv, long long rows, int g, int hd) {
    const float* src = blockIdx.y ? part_v : part_k;
    T* dst = blockIdx.y ? dv : dk;
    const int per_row = hd / 4;
    const long long total = rows * per_row;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += (long long)gridDim.x * blockDim.x) {
        const long long row = i / per_row;
        const int c = (int)(i % per_row) * 4;
        // the group's g heads are g consecutive rows of hd floats
        const float* p = src + row * g * hd + c;
        float4 a = *reinterpret_cast<const float4*>(p);
        for (int hh = 1; hh < g; ++hh) {
            const float4 x = *reinterpret_cast<const float4*>(p + hh * hd);
            a.x += x.x;
            a.y += x.y;
            a.z += x.z;
            a.w += x.w;
        }
        uint2 o;
        o.x = pack2<T>(a.x, a.y);
        o.y = pack2<T>(a.z, a.w);
        *reinterpret_cast<uint2*>(dst + row * hd + c) = o;
    }
}

// ---- dQ --------------------------------------------------------------------

template <int HDP>
struct DqCfg {
    static constexpr int BQ = 128;      // query rows a block: 64 a warpgroup
    static constexpr int BK = 64;       // keys a streamed tile
    static constexpr int CHUNKS = HDP / 64;
    static constexpr int Q_BYTES = BQ * HDP * 2;    // the Q or the dO tile
    static constexpr int KV_BYTES = BK * HDP * 2;   // one K or V tile
    static constexpr int BARS = 1 + 2 * STAGES;     // q, kv full, kv empty
    static constexpr size_t smem =
        1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 8 * BARS;
};

// One block per (query tile of 128, batch x head): Q and dO load once; K
// and V tiles of the visible keys stream through the ring.  Consumer
// warpgroup wg owns rows q0 + 64 wg + [0, 64): S = Q K^T and dP = dO V^T
// (ss), dS in registers, dQ += dS K (rs, K read MN-major); dq = scale dQ.
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int H, int KV, int hd, long long q_offset,
                long long window, int causal, float cap, float scale) {
    using C = DqCfg<HDP>;
    constexpr int BQ = C::BQ, BK = C::BK;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t sQ = (raw + 1023u) & ~1023u;
    const uint32_t sdO = sQ + C::Q_BYTES;
    const uint32_t sK0 = sdO + C::Q_BYTES;   // stage s: K, then V
    const uint32_t bar_q = sK0 + STAGES * 2 * C::KV_BYTES;
    auto kv_full = [&](int s) { return bar_q + 8u * (1 + s); };
    auto kv_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

    const int tid = threadIdx.x;
    const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int q0 = qt * BQ;
    const Mask mk{Sq, Sk, causal, q_offset, window, cap, 1.f / (float)Sk};
    const TileRange kr =
        key_tiles(q0, BQ, BK, Sq, Sk, q_offset, window, causal);
    const int n = kr.hi - kr.lo;

    if (tid == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(kv_full(s), 1);
            mbar_init(kv_empty(s), 8);   // lane 0 of each consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int wg = tid / 128;
    if (wg == 2) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
        if (tid == 256) {
            mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
            for (int c = 0; c < C::CHUNKS; ++c) {
                tma_load(sQ + c * BQ * ROW, &tm_q, bar_q, c * 64, h, q0, b);
                tma_load(sdO + c * BQ * ROW, &tm_do, bar_q, c * 64, h, q0,
                         b);
            }
            for (int i = 0; i < n; ++i) {
                const int s = i % STAGES;
                const uint32_t ph = (i / STAGES) & 1;
                const int k0 = (kr.lo + i) * BK;
                const uint32_t sK = sK0 + s * 2 * C::KV_BYTES;
                mbar_wait(kv_empty(s), ph ^ 1);   // round 0 passes
                mbar_expect_tx(kv_full(s), 2 * C::KV_BYTES);
                for (int c = 0; c < C::CHUNKS; ++c) {
                    tma_load(sK + c * BK * ROW, &tm_k, kv_full(s), c * 64,
                             kvh, k0, b);
                    tma_load(sK + C::KV_BYTES + c * BK * ROW, &tm_v,
                             kv_full(s), c * 64, kvh, k0, b);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
        // this thread: query rows wq0 + r and wq0 + r + 8, key columns
        // 8 j + c2 and 8 j + c2 + 1 of each tile
        const int t = tid % 128, warp = t / 32, lane = t % 32;
        const int r = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
        const int wq0 = q0 + 64 * wg;
        const float sl2 = scale * LOG2E;
        const float* lse_h = lse + ((long long)b * H + h) * Sq;
        const float* d_h = delta + ((long long)b * H + h) * Sq;
        float lse2[2], D[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
            const int row = wq0 + r + 8 * h2;
            lse2[h2] = row < Sq ? lse_h[row] * LOG2E : 0.f;
            D[h2] = row < Sq ? d_h[row] : 0.f;
        }
        float dq_acc[HDP / 2];
#pragma unroll
        for (int e = 0; e < HDP / 2; ++e) dq_acc[e] = 0.f;

        mbar_wait(bar_q, 0);
        for (int i = 0; i < n; ++i) {
            const int s = i % STAGES;
            const uint32_t ph = (i / STAGES) & 1;
            const int k0 = (kr.lo + i) * BK;
            const uint32_t sK = sK0 + s * 2 * C::KV_BYTES;
            const uint32_t sV = sK + C::KV_BYTES;
            float sc[BK / 2], dp[BK / 2];
            mbar_wait(kv_full(s), ph);
            wg_fence();
            issue_abt<T, HDP, BK>(sc, sQ, BQ, 64 * wg, sK);
            issue_abt<T, HDP, BK>(dp, sdO, BQ, 64 * wg, sV);
            wg_commit();
            wg_wait0();
            reg_fence(sc);
            reg_fence(dp);

            const bool edge = edge_tile(wq0, 64, k0, BK, mk);
#pragma unroll
            for (int e = 0; e < BK / 2; ++e) {
                const int h2 = (e >> 1) & 1;
                Pair pd = p_ds(sc[e], dp[e], lse2[h2], D[h2], sl2, scale,
                               cap);
                if (edge) {
                    const int qi = wq0 + r + 8 * h2;
                    const int kp = k0 + 8 * (e / 4) + c2 + (e & 1);
                    if (qi >= Sq || kp >= Sk || hidden(q_offset + qi, kp, mk))
                        pd.ds = 0.f;
                }
                dp[e] = pd.ds;
            }
            uint32_t da[BK / 16][4];
            pack_frags<T, BK>(da, dp);
            wg_fence();
            issue_ab<T, HDP, BK>(dq_acc, da, sK);
            wg_commit();
            wg_wait0();
            reg_fence(dq_acc);
            if (lane == 0) mbar_arrive(kv_empty(s));
        }

        // dq = scale dS k; two values per store
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
            const int row = wq0 + r + 8 * h2;
            if (row >= Sq) continue;
            T* out = dq + (((long long)b * Sq + row) * H + h) * hd;
#pragma unroll
            for (int j = 0; j < HDP / 8; ++j) {
                const int col = 8 * j + c2;
                if (col < hd)
                    *reinterpret_cast<uint32_t*>(out + col) =
                        pack2<T>(dq_acc[4 * j + 2 * h2] * scale,
                                 dq_acc[4 * j + 2 * h2 + 1] * scale);
            }
        }
    }
}

struct Maps {
    CUtensorMap q, k, v, dout;
};

// the four tensor maps: q and dout in boxes of `q_rows` rows, k and v of
// `k_rows`
template <typename T>
cudaError_t make_maps(const Args& a, int q_rows, int k_rows, Maps* m) {
    EncodeTiled enc;
    cudaError_t err = encoder(&enc);
    if (err != cudaSuccess) return err;
    const CUtensorMapDataType ty = TmaType<T>::value;
    if (!make_map(enc, &m->q, ty, a.q, a.B, a.Sq, a.H, a.hd, q_rows) ||
        !make_map(enc, &m->dout, ty, a.dout, a.B, a.Sq, a.H, a.hd, q_rows) ||
        !make_map(enc, &m->k, ty, a.k, a.B, a.Sk, a.KV, a.hd, k_rows) ||
        !make_map(enc, &m->v, ty, a.v, a.B, a.Sk, a.KV, a.hd, k_rows))
        return cudaErrorInvalidValue;
    return cudaSuccess;
}

template <typename T, int HDP>
cudaError_t run_dkdv(const Args& a, void* dk, void* dv, float* part,
                        cudaStream_t s) {
    using C = DkdvCfg<HDP>;
    Maps m;
    cudaError_t err = make_maps<T>(a, C::BQ, C::BK, &m);
    if (err != cudaSuccess) return err;
    static unsigned configured = 0;
    err = allow_smem(flash_bwd_dkdv_tc<T, HDP>, C::smem, configured);
    if (err != cudaSuccess) return err;
    const int g = a.H / a.KV;
    const long long plane = (long long)a.B * a.Sk * a.H * a.hd;
    float* part_k = g > 1 ? part : nullptr;
    float* part_v = g > 1 ? part + plane : nullptr;
    const dim3 grid((unsigned)(a.B * a.H),
                    (unsigned)((a.Sk + C::BK - 1) / C::BK));
    flash_bwd_dkdv_tc<T, HDP><<<grid, THREADS, C::smem, s>>>(
        m.q, m.k, m.v, m.dout, a.lse, a.delta, (T*)dk, (T*)dv, part_k,
        part_v, a.Sq, a.Sk, a.H, a.KV, a.hd, a.q_offset, a.window, a.causal,
        a.cap, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || g == 1) return err;
    const long long rows = (long long)a.B * a.Sk * a.KV;
    const long long want = (rows * (a.hd / 4) + 255) / 256;
    const unsigned blocks = (unsigned)(want < 132 * 8 ? want : 132 * 8);
    flash_bwd_dkdv_sum<T><<<dim3(blocks, 2), 256, 0, s>>>(
        part_k, part_v, (T*)dk, (T*)dv, rows, g, a.hd);
    return cudaGetLastError();
}

template <typename T, int HDP>
cudaError_t run_dq(const Args& a, void* dq, cudaStream_t s) {
    using C = DqCfg<HDP>;
    Maps m;
    cudaError_t err = make_maps<T>(a, C::BQ, C::BK, &m);
    if (err != cudaSuccess) return err;
    static unsigned configured = 0;
    err = allow_smem(flash_bwd_dq_tc<T, HDP>, C::smem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.Sq + C::BQ - 1) / C::BQ),
                    (unsigned)(a.B * a.H));
    flash_bwd_dq_tc<T, HDP><<<grid, THREADS, C::smem, s>>>(
        m.q, m.k, m.v, m.dout, a.lse, a.delta, (T*)dq, a.Sq, a.Sk, a.H,
        a.KV, a.hd, a.q_offset, a.window, a.causal, a.cap, a.scale);
    return cudaGetLastError();
}

// what the route takes: 16-byte rows (hd % 8 == 0) on 16-byte aligned
// bases, hd <= 128
bool takes(const Args& a) {
    return a.hd % 8 == 0 && a.hd <= 128 &&
           ((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
            (uintptr_t)a.dout) % 16 == 0;
}

template <typename T>
cudaError_t dkdv(const Args& a, void* dk, void* dv, float* part,
                 cudaStream_t s) {
    if (!takes(a) || (a.H != a.KV && part == nullptr) ||
        ((uintptr_t)dk | (uintptr_t)dv) % 16)
        return cudaErrorInvalidValue;
    return a.hd <= 64 ? run_dkdv<T, 64>(a, dk, dv, part, s)
                      : run_dkdv<T, 128>(a, dk, dv, part, s);
}

template <typename T>
cudaError_t dq(const Args& a, void* dq_out, cudaStream_t s) {
    if (!takes(a)) return cudaErrorInvalidValue;
    return a.hd <= 64 ? run_dq<T, 64>(a, dq_out, s)
                      : run_dq<T, 128>(a, dq_out, s);
}

}  // namespace tc

}  // namespace

// q, dout (B, Sq, H, hd); k, v (B, Sk, KV, hd), contiguous, of one 16-bit
// type on 16-byte aligned bases, hd % 8 == 0, hd <= 128; lse, delta
// float32 (B, H, Sq) -> dk, dv (B, Sk, KV, hd) of that type.  scratch:
// with H > KV, float32 room for 2 x (B, Sk, H, hd) per-head partials
// (unused when H == KV).  Masks and scale as sira_flash_attention's;
// dtype_kind: 1 = float16, 2 = bfloat16.
extern "C" int sira_flash_bwd_dkdv_tc(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, void* scratch,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int hd, long long q_offset,
                                      long long window, int causal,
                                      float logit_cap, float scale,
                                      int dtype_kind, void* stream) {
    if (bad_shape(B, Sq, Sk, H, KV, hd, window))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, dout, (const float*)lse, (const float*)delta,
                 B, Sq, Sk, H, KV, hd, q_offset, window, causal, logit_cap,
                 scale};
    cudaStream_t s = (cudaStream_t)stream;
    float* part = (float*)scratch;
    switch (dtype_kind) {
    case 1: return (int)tc::dkdv<__half>(a, dk, dv, part, s);
    case 2: return (int)tc::dkdv<__nv_bfloat16>(a, dk, dv, part, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// the same inputs -> dq (B, Sq, H, hd) of their type
extern "C" int sira_flash_bwd_dq_tc(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int Sq, int Sk, int H,
                                    int KV, int hd, long long q_offset,
                                    long long window, int causal,
                                    float logit_cap, float scale,
                                    int dtype_kind, void* stream) {
    if (bad_shape(B, Sq, Sk, H, KV, hd, window))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, dout, (const float*)lse, (const float*)delta,
                 B, Sq, Sk, H, KV, hd, q_offset, window, causal, logit_cap,
                 scale};
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype_kind) {
    case 1: return (int)tc::dq<__half>(a, dq, s);
    case 2: return (int)tc::dq<__nv_bfloat16>(a, dq, s);
    default: return (int)cudaErrorInvalidValue;
    }
}
