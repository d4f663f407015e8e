// Flash attention, backward, on the tensor cores (sm_90a): the
// tensor_cores route of dK/dV and dQ, for bfloat16 / float16 with
// hd <= 128 (flash_attention_bwd_tc256.cu holds the same route's tiling
// for 128 < hd <= 256; flash_bwd_tc.cuh what the two share).  What it
// computes, what bounds it, its design and its arithmetic contract are in
// the note at the head of flash_attention_bwd.cu, which holds the
// cuda_cores route and the D kernel; kernels/flash_attention.py route_for
// picks the route.  Each C entry returns the cudaError_t of its launches.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_bwd_tc.cuh"
#include "flash_tc.cuh"
#include "hopper.cuh"

namespace {

using namespace sira::bwd;

namespace tc {

using namespace sira::bwd_tc;
using namespace sira::flash;
using namespace sira::hopper;

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
    return run_dkdv_sum<T>(a, dk, dv, part_k, part_v, s);
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

template <typename T>
cudaError_t dkdv(const Args& a, void* dk, void* dv, float* part,
                 cudaStream_t s) {
    if (!takes(a, 128) || (a.H != a.KV && part == nullptr) ||
        ((uintptr_t)dk | (uintptr_t)dv) % 16)
        return cudaErrorInvalidValue;
    return a.hd <= 64 ? run_dkdv<T, 64>(a, dk, dv, part, s)
                      : run_dkdv<T, 128>(a, dk, dv, part, s);
}

template <typename T>
cudaError_t dq(const Args& a, void* dq_out, cudaStream_t s) {
    if (!takes(a, 128)) return cudaErrorInvalidValue;
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
