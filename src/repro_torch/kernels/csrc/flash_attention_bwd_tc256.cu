// Flash attention, backward, on the tensor cores (sm_90a): the
// tensor_cores route of dK/dV and dQ for bfloat16 / float16 with
// 128 < hd <= 256 (gemma2's head is 256).  It computes what
// flash_attention_bwd_tc.cu computes for hd <= 128, under the same
// arithmetic contract (flash_attention_bwd.cu's note: P and dS rounded to
// 16 bits before the products, float32 sums in a fixed order, no
// atomics, the GQA partials summed in head order by flash_bwd_dkdv_sum);
// what it shares with that file is in flash_bwd_tc.cuh.  There is no TPU
// kernel to replace: the reference differentiates its plain attention
// (src/repro/models/attention.py flash_attention) with jax.vjp.
//
// What bounds it: operations, as for hd <= 128 (dK/dV makes four products
// of the forward's size, dQ three; kernels/flash_attention.py bwd_work).
// At gemma2's layer (B = 1, S = 8192, H = 8, KV = 4, causal) they are
// 5.5e11 and 4.1e11 operations: 0.56 and 0.42 ms at the 989 TFLOP/s of
// the 16-bit tensor cores.
//
// Why hd <= 128's tiles do not fit: there each consumer warpgroup owns 64
// keys and holds their dK and dV over the whole head in registers (hd
// floats a thread, 256 at hd 256, against the 240 setmaxnreg grants), and
// the blocks' K/V tiles and Q/dO ring come to ~257 KB of shared memory
// against the 227 KB a block may have.  So here a block's two consumer
// warpgroups split the head dim instead of the keys or rows:
//
// flash_bwd_dkdv_tc256: one block per (batch x query head, 64 keys), key
//   tile 0 (the longest under a causal mask) first.  K and V of the tile
//   (2 x 32 KB) load once by TMA; the Q and dO tiles of every visible
//   64-row query tile stream through a 2-stage ring (2 x 64 KB) with lse
//   and D (one producer warp of plain loads).  Per query tile, warpgroup 0
//   computes S^T = K Q^T and warpgroup 1 dP^T = V dO^T (each 64 x 64 over
//   hd 256: 16 ss wgmma, 32 accumulators a thread).  The two accumulators
//   are laid out alike, thread for thread, so each warpgroup hands the
//   other half of its 32 values through shared memory (16 KB of float32,
//   one named barrier) and each then forms P and dS for 32 of the 64
//   query columns in float32: the elementwise work is split evenly.  P^T
//   and dS^T are rounded to 16 bits into two 64 x 64 tiles in shared
//   memory (8 KB each, 128-byte swizzled, the K-major A operand of
//   wgmma), and after a second named barrier warpgroup w runs
//   dV[:, 128 w + (0..127)] += P^T dO[:, 128 w + ...] and dK[...] += dS^T
//   Q[...] as ss wgmma m64n128k16 with dO and Q read MN-major (the
//   transpose bit).  A thread then holds 64 + 64 accumulators.  Shared
//   memory: 64 + 128 + 16 + 16 KB + lse/D + barriers = 226 KB.
// flash_bwd_dq_tc256: one block per (64 query rows, batch x head), the
//   longest rows first.  Q and dO (2 x 32 KB) load once; K and V tiles of
//   64 keys stream through the ring (2 x 64 KB).  Warpgroup 0 computes S
//   = Q K^T, warpgroup 1 dP = dO V^T; the same exchange gives each the
//   pairs of 32 keys, dS goes to one 16-bit tile, and warpgroup w runs
//   dQ[:, 128 w + ...] += dS K[:, 128 w + ...] (ss, K read MN-major): 64
//   accumulators a thread.  Shared memory 217 KB.
// Inside a block the products, the exchange and the elementwise step run
// one after the other; the two warpgroups' products overlap.  Edges are
// bound-checked as in flash_attention_bwd_tc.cu (TMA fills rows past Sq
// or Sk and columns past hd with zeros; no element past them is written).
// Each C entry returns the cudaError_t of its launches.
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

namespace tc256 {

using namespace sira::bwd_tc;
using namespace sira::flash;
using namespace sira::hopper;

constexpr int HDP = 256;              // the head, padded with zeros by TMA
constexpr int CHUNKS = HDP / 64;      // 64-column chunks of a tile
constexpr int BT = 64;                // keys or query rows of every tile
constexpr int TILE = BT * HDP * 2;    // one K, V, Q or dO tile: 32 KB
constexpr int SQUARE = BT * BT * 2;   // a 16-bit 64 x 64 tile: 8 KB
// the exchange: 32 float32 values for each of a warpgroup's 128 threads
constexpr int X_BYTES = 32 * 128 * 4;
constexpr int BARS = 1 + 2 * STAGES;  // the resident tiles, full, empty
// registers a thread (setmaxnreg): the producer's TMA loop, eight copies
// a tile, spills at 24; 128 x 40 + 256 x 232 = 64512 of the SM's 65536
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

constexpr size_t DKDV_SMEM = 1024 + 2 * TILE + STAGES * 2 * TILE +
                             2 * SQUARE + X_BYTES + STAGES * 2 * BT * 4 +
                             8 * BARS;
constexpr size_t DQ_SMEM =
    1024 + 2 * TILE + STAGES * 2 * TILE + SQUARE + X_BYTES + 8 * BARS;
static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448,
              "a block has at most 227 KB of shared memory");

// byte offset of element (row, col) in a 64 x 64 16-bit tile of 128-byte
// rows, 128-byte swizzled (16-byte unit col / 8 xor row % 8)
__device__ __forceinline__ uint32_t sw128(int row, int col) {
    return row * ROW + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// Each warpgroup holds one m64n64 accumulator x (S in warpgroup 0, dP in
// warpgroup 1), laid out alike in both, and warpgroup W forms P and dS of
// its elements 16 W .. 16 W + 15.  give() hands the other warpgroup the
// half of x it needs (element e of thread t at e * 128 + t of `xch`) and
// waits for the other's half (named barrier 1); then s_dp<W>() gives
// element e of this warpgroup's half of both.
__device__ __forceinline__ void give(const float (&x)[32], float* xch,
                                     int wg, int t) {
    if (wg == 0) {
#pragma unroll
        for (int e = 0; e < 16; ++e) xch[(16 + e) * 128 + t] = x[16 + e];
    } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) xch[e * 128 + t] = x[e];
    }
    named_barrier(1, 256);
}

template <int W>
__device__ __forceinline__ void s_dp(const float (&x)[32],
                                     const float* xch, int t, int e,
                                     float& s, float& dp) {
    if (W == 0) {
        s = x[e];
        dp = xch[e * 128 + t];
    } else {
        s = xch[(16 + e) * 128 + t];
        dp = x[16 + e];
    }
}

// dK/dV: P^T and dS^T of warpgroup W's 32 query columns of a tile (keys
// k0 + r, k0 + r + 8; query columns 32 W + 8 (e / 4) + c2 (+1)) into the
// 16-bit tiles tP, tDS; L: the tile's lse2, then its D
template <typename T, int W>
__device__ __forceinline__ void dkdv_pairs(
    const float (&x)[32], const float* xch, const float* L, uint8_t* tP,
    uint8_t* tDS, int t, int r, int c2, int q0, int k0, bool edge,
    const Mask& mk, float sl2, float scale) {
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
        const int qc = 32 * W + 8 * (e / 4) + c2;
        const int kr = r + 8 * ((e >> 1) & 1);
        const float2 l2 = *reinterpret_cast<const float2*>(L + qc);
        const float2 dd = *reinterpret_cast<const float2*>(L + BT + qc);
        Pair pd[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            float sx, dx;
            s_dp<W>(x, xch, t, e + u, sx, dx);
            const float lse2 = u ? l2.y : l2.x;
            pd[u] = p_ds(sx, dx, lse2, u ? dd.y : dd.x, sl2, scale, mk.cap);
            if (edge) {
                const int qi = q0 + qc + u, kp = k0 + kr;
                if (qi >= mk.Sq || kp >= mk.Sk) {
                    pd[u].p = 0.f;
                    pd[u].ds = 0.f;
                } else if (hidden(mk.q_offset + qi, kp, mk)) {
                    pd[u].p = lse2 < DEAD_LSE2 ? mk.inv_sk : 0.f;
                    pd[u].ds = 0.f;
                }
            }
        }
        const uint32_t off = sw128(kr, qc);
        *reinterpret_cast<uint32_t*>(tP + off) = pack2<T>(pd[0].p, pd[1].p);
        *reinterpret_cast<uint32_t*>(tDS + off) =
            pack2<T>(pd[0].ds, pd[1].ds);
    }
}

// dQ: dS of warpgroup W's 32 key columns of a tile (query rows q0 + r,
// q0 + r + 8, whose lse2 and D these are; key columns 32 W + 8 (e / 4) +
// c2 (+1)) into the 16-bit tile tDS
template <typename T, int W>
__device__ __forceinline__ void dq_pairs(
    const float (&x)[32], const float* xch, const float (&lse2)[2],
    const float (&D)[2], uint8_t* tDS, int t, int r, int c2, int q0,
    int k0, bool edge, const Mask& mk, float sl2, float scale) {
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
        const int kc = 32 * W + 8 * (e / 4) + c2;
        const int h2 = (e >> 1) & 1;
        const int row = r + 8 * h2;
        float ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            float sx, dx;
            s_dp<W>(x, xch, t, e + u, sx, dx);
            ds[u] = p_ds(sx, dx, lse2[h2], D[h2], sl2, scale, mk.cap).ds;
            if (edge) {
                const int qi = q0 + row, kp = k0 + kc + u;
                if (qi >= mk.Sq || kp >= mk.Sk ||
                    hidden(mk.q_offset + qi, kp, mk))
                    ds[u] = 0.f;
            }
        }
        *reinterpret_cast<uint32_t*>(tDS + sw128(row, kc)) =
            pack2<T>(ds[0], ds[1]);
    }
}

// acc (64 rows x 128 columns) += A B: A a 64 x 64 16-bit tile (K-major),
// B the 64 rows x columns [128 half, 128 half + 128) of a tile of 64 rows
// read MN-major; issued (not committed)
template <typename T>
__device__ __forceinline__ void issue_half(float (&acc)[64], uint32_t a,
                                           uint32_t b, int half) {
    const uint32_t bh = b + 2 * half * BT * ROW;
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk)
        Mma<T, 128>::ss_tb(acc, desc_sw128(a + kk * 32, 16),
                           desc_sw128(bh + kk * 16 * ROW, BT * ROW));
}

// ---- dK, dV ----------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_tc256(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ part_k,
                     float* __restrict__ part_v, int Sq, int Sk, int H,
                     int KV, int hd, long long q_offset, long long window,
                     int causal, float cap, float scale) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t sK = (raw + 1023u) & ~1023u;
    const uint32_t sV = sK + TILE;
    const uint32_t sQ0 = sV + TILE;   // stage s: Q, then dO
    const uint32_t sP = sQ0 + STAGES * 2 * TILE;   // P^T, 16-bit
    const uint32_t sDS = sP + SQUARE;              // dS^T, 16-bit
    const uint32_t sX = sDS + SQUARE;              // the exchange
    const uint32_t sRows = sX + X_BYTES;
    const uint32_t bar_kv = sRows + STAGES * 2 * BT * 4;
    auto q_full = [&](int s) { return bar_kv + 8u * (1 + s); };
    auto q_empty = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };
    auto at = [&](uint32_t addr) { return smem_raw + (addr - raw); };
    // stage s: lse2 (BT floats), then D (BT floats)
    float* rows = reinterpret_cast<float*>(at(sRows));

    const int tid = threadIdx.x;
    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int g = H / KV, kvh = h / g;
    const int k0 = blockIdx.y * BT;   // key tile 0 (the longest) first
    const TileRange qr =
        query_tiles(k0, BT, BT, Sq, Sk, q_offset, window, causal);
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
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(PRODUCER_REGS));
        const int t = tid - 256;
        if (t == 0) {
            mbar_expect_tx(bar_kv, 2 * TILE);
            for (int c = 0; c < CHUNKS; ++c) {
                tma_load(sK + c * BT * ROW, &tm_k, bar_kv, c * 64, kvh, k0,
                         b);
                tma_load(sV + c * BT * ROW, &tm_v, bar_kv, c * 64, kvh, k0,
                         b);
            }
            for (int i = 0; i < n; ++i) {
                const int s = i % STAGES;
                const uint32_t ph = (i / STAGES) & 1;
                const int q0 = (qr.lo + i) * BT;
                const uint32_t sQ = sQ0 + s * 2 * TILE;
                mbar_wait(q_empty(s), ph ^ 1);   // round 0 passes
                mbar_expect_tx(q_full(s), 2 * TILE);
                for (int c = 0; c < CHUNKS; ++c) {
                    tma_load(sQ + c * BT * ROW, &tm_q, q_full(s), c * 64, h,
                             q0, b);
                    tma_load(sQ + TILE + c * BT * ROW, &tm_do, q_full(s),
                             c * 64, h, q0, b);
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
                const int q0 = (qr.lo + i) * BT;
                float* L = rows + s * 2 * BT;
                mbar_wait(q_empty(s), ph ^ 1);
                for (int r = lane; r < BT; r += 32) {
                    const bool in = q0 + r < Sq;
                    L[r] = in ? lse_h[q0 + r] * LOG2E : 0.f;
                    L[BT + r] = in ? d_h[q0 + r] : 0.f;
                }
                mbar_arrive(q_full(s));
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                     :: "n"(CONSUMER_REGS));
        // this thread: keys k0 + r and k0 + r + 8 (accumulator rows);
        // of S^T / dP^T the query columns 8 j + c2 (+1), of which it forms
        // P and dS for j = 4 wg .. 4 wg + 3; of dK and dV the head columns
        // 128 wg + 8 j + c2 (+1).  (What only the consumers use is made
        // here, out of the producer warpgroup's few registers.)
        const Mask mk{Sq, Sk, causal, q_offset, window, cap,
                      1.f / (float)Sk};
        float* xch = reinterpret_cast<float*>(at(sX));
        const int t = tid % 128, warp = t / 32, lane = t % 32;
        const int r = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
        const float sl2 = scale * LOG2E;
        float dv_acc[64], dk_acc[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) dv_acc[e] = dk_acc[e] = 0.f;

        mbar_wait(bar_kv, 0);
        for (int i = 0; i < n; ++i) {
            const int s = i % STAGES;
            const uint32_t ph = (i / STAGES) & 1;
            const int q0 = (qr.lo + i) * BT;
            const uint32_t sQ = sQ0 + s * 2 * TILE;
            const uint32_t sdO = sQ + TILE;
            const float* L = rows + s * 2 * BT;
            float x[32];
            mbar_wait(q_full(s), ph);
            // warpgroup 0: S^T = K Q^T; warpgroup 1: dP^T = V dO^T
            wg_fence();
            issue_abt<T, HDP, BT>(x, wg ? sV : sK, BT, 0, wg ? sdO : sQ);
            wg_commit();
            wg_wait0();
            reg_fence(x);
            give(x, xch, wg, t);
            const bool edge = edge_tile(q0, BT, k0, BT, mk);
            if (wg == 0)
                dkdv_pairs<T, 0>(x, xch, L, at(sP), at(sDS), t, r, c2, q0,
                                 k0, edge, mk, sl2, scale);
            else
                dkdv_pairs<T, 1>(x, xch, L, at(sP), at(sDS), t, r, c2, q0,
                                 k0, edge, mk, sl2, scale);
            fence_proxy_async();
            named_barrier(2, 256);
            // this warpgroup's half of the head: dV += P^T dO, dK += dS^T Q
            wg_fence();
            issue_half<T>(dv_acc, sP, sdO, wg);
            issue_half<T>(dk_acc, sDS, sQ, wg);
            wg_commit();
            wg_wait0();
            reg_fence(dv_acc);
            reg_fence(dk_acc);
            if (lane == 0) mbar_arrive(q_empty(s));
        }

        // dK = scale dS^T q; two values per store
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
            const int key = k0 + r + 8 * h2;
            if (key >= Sk) continue;
            const long long at_k = (long long)b * Sk + key;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int col = 128 * wg + 8 * j + c2;
                if (col >= hd) continue;
                const float k0v = dk_acc[4 * j + 2 * h2] * scale;
                const float k1v = dk_acc[4 * j + 2 * h2 + 1] * scale;
                const float v0 = dv_acc[4 * j + 2 * h2];
                const float v1 = dv_acc[4 * j + 2 * h2 + 1];
                if (g == 1) {
                    const long long o = (at_k * KV + kvh) * hd + col;
                    *reinterpret_cast<uint32_t*>(dk + o) = pack2<T>(k0v, k1v);
                    *reinterpret_cast<uint32_t*>(dv + o) = pack2<T>(v0, v1);
                } else {
                    const long long o = (at_k * H + h) * hd + col;
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc256(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int Sq, int Sk, int H, int KV, int hd, long long q_offset,
                   long long window, int causal, float cap, float scale) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t sQ = (raw + 1023u) & ~1023u;
    const uint32_t sdO = sQ + TILE;
    const uint32_t sK0 = sdO + TILE;   // stage s: K, then V
    const uint32_t sDS = sK0 + STAGES * 2 * TILE;   // dS, 16-bit
    const uint32_t sX = sDS + SQUARE;                // the exchange
    const uint32_t bar_q = sX + X_BYTES;
    auto kv_full = [&](int s) { return bar_q + 8u * (1 + s); };
    auto kv_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
    auto at = [&](uint32_t addr) { return smem_raw + (addr - raw); };

    const int tid = threadIdx.x;
    const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int q0 = qt * BT;
    const TileRange kr =
        key_tiles(q0, BT, BT, Sq, Sk, q_offset, window, causal);
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
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                     :: "n"(PRODUCER_REGS));
        if (tid == 256) {
            mbar_expect_tx(bar_q, 2 * TILE);
            for (int c = 0; c < CHUNKS; ++c) {
                tma_load(sQ + c * BT * ROW, &tm_q, bar_q, c * 64, h, q0, b);
                tma_load(sdO + c * BT * ROW, &tm_do, bar_q, c * 64, h, q0,
                         b);
            }
            for (int i = 0; i < n; ++i) {
                const int s = i % STAGES;
                const uint32_t ph = (i / STAGES) & 1;
                const int k0 = (kr.lo + i) * BT;
                const uint32_t sK = sK0 + s * 2 * TILE;
                mbar_wait(kv_empty(s), ph ^ 1);   // round 0 passes
                mbar_expect_tx(kv_full(s), 2 * TILE);
                for (int c = 0; c < CHUNKS; ++c) {
                    tma_load(sK + c * BT * ROW, &tm_k, kv_full(s), c * 64,
                             kvh, k0, b);
                    tma_load(sK + TILE + c * BT * ROW, &tm_v, kv_full(s),
                             c * 64, kvh, k0, b);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                     :: "n"(CONSUMER_REGS));
        // this thread: query rows q0 + r and q0 + r + 8; of S / dP the key
        // columns 8 j + c2 (+1), of which it forms dS for j = 4 wg ..
        // 4 wg + 3; of dQ the head columns 128 wg + 8 j + c2 (+1)
        const Mask mk{Sq, Sk, causal, q_offset, window, cap,
                      1.f / (float)Sk};
        float* xch = reinterpret_cast<float*>(at(sX));
        const int t = tid % 128, warp = t / 32, lane = t % 32;
        const int r = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
        const float sl2 = scale * LOG2E;
        const float* lse_h = lse + ((long long)b * H + h) * Sq;
        const float* d_h = delta + ((long long)b * H + h) * Sq;
        float lse2[2], D[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
            const int row = q0 + r + 8 * h2;
            lse2[h2] = row < Sq ? lse_h[row] * LOG2E : 0.f;
            D[h2] = row < Sq ? d_h[row] : 0.f;
        }
        float dq_acc[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) dq_acc[e] = 0.f;

        mbar_wait(bar_q, 0);
        for (int i = 0; i < n; ++i) {
            const int s = i % STAGES;
            const uint32_t ph = (i / STAGES) & 1;
            const int k0 = (kr.lo + i) * BT;
            const uint32_t sK = sK0 + s * 2 * TILE;
            const uint32_t sV = sK + TILE;
            float x[32];
            mbar_wait(kv_full(s), ph);
            // warpgroup 0: S = Q K^T; warpgroup 1: dP = dO V^T
            wg_fence();
            issue_abt<T, HDP, BT>(x, wg ? sdO : sQ, BT, 0, wg ? sV : sK);
            wg_commit();
            wg_wait0();
            reg_fence(x);
            give(x, xch, wg, t);
            const bool edge = edge_tile(q0, BT, k0, BT, mk);
            if (wg == 0)
                dq_pairs<T, 0>(x, xch, lse2, D, at(sDS), t, r, c2, q0, k0,
                               edge, mk, sl2, scale);
            else
                dq_pairs<T, 1>(x, xch, lse2, D, at(sDS), t, r, c2, q0, k0,
                               edge, mk, sl2, scale);
            fence_proxy_async();
            named_barrier(2, 256);
            // this warpgroup's half of the head: dQ += dS K
            wg_fence();
            issue_half<T>(dq_acc, sDS, sK, wg);
            wg_commit();
            wg_wait0();
            reg_fence(dq_acc);
            if (lane == 0) mbar_arrive(kv_empty(s));
        }

        // dq = scale dS k; two values per store
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
            const int row = q0 + r + 8 * h2;
            if (row >= Sq) continue;
            T* out = dq + (((long long)b * Sq + row) * H + h) * hd;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int col = 128 * wg + 8 * j + c2;
                if (col < hd)
                    *reinterpret_cast<uint32_t*>(out + col) =
                        pack2<T>(dq_acc[4 * j + 2 * h2] * scale,
                                 dq_acc[4 * j + 2 * h2 + 1] * scale);
            }
        }
    }
}

// what this tiling takes: 128 < hd <= 256, and the rest of takes()
bool takes256(const Args& a) { return a.hd > 128 && takes(a, HDP); }

template <typename T>
cudaError_t dkdv(const Args& a, void* dk, void* dv, float* part,
                 cudaStream_t s) {
    if (!takes256(a) || (a.H != a.KV && part == nullptr) ||
        ((uintptr_t)dk | (uintptr_t)dv) % 16)
        return cudaErrorInvalidValue;
    Maps m;
    cudaError_t err = make_maps<T>(a, BT, BT, &m);
    if (err != cudaSuccess) return err;
    static unsigned configured = 0;
    err = allow_smem(flash_bwd_dkdv_tc256<T>, DKDV_SMEM, configured);
    if (err != cudaSuccess) return err;
    const int g = a.H / a.KV;
    const long long plane = (long long)a.B * a.Sk * a.H * a.hd;
    float* part_k = g > 1 ? part : nullptr;
    float* part_v = g > 1 ? part + plane : nullptr;
    const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.Sk + BT - 1) / BT));
    flash_bwd_dkdv_tc256<T><<<grid, THREADS, DKDV_SMEM, s>>>(
        m.q, m.k, m.v, m.dout, a.lse, a.delta, (T*)dk, (T*)dv, part_k,
        part_v, a.Sq, a.Sk, a.H, a.KV, a.hd, a.q_offset, a.window, a.causal,
        a.cap, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || g == 1) return err;
    return run_dkdv_sum<T>(a, dk, dv, part_k, part_v, s);
}

template <typename T>
cudaError_t dq(const Args& a, void* dq_out, cudaStream_t s) {
    if (!takes256(a)) return cudaErrorInvalidValue;
    Maps m;
    cudaError_t err = make_maps<T>(a, BT, BT, &m);
    if (err != cudaSuccess) return err;
    static unsigned configured = 0;
    err = allow_smem(flash_bwd_dq_tc256<T>, DQ_SMEM, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.Sq + BT - 1) / BT), (unsigned)(a.B * a.H));
    flash_bwd_dq_tc256<T><<<grid, THREADS, DQ_SMEM, s>>>(
        m.q, m.k, m.v, m.dout, a.lse, a.delta, (T*)dq_out, a.Sq, a.Sk, a.H,
        a.KV, a.hd, a.q_offset, a.window, a.causal, a.cap, a.scale);
    return cudaGetLastError();
}

}  // namespace tc256

}  // namespace

// q, dout (B, Sq, H, hd); k, v (B, Sk, KV, hd), contiguous, of one 16-bit
// type on 16-byte aligned bases, hd % 8 == 0, 128 < hd <= 256; lse, delta
// float32 (B, H, Sq) -> dk, dv (B, Sk, KV, hd) of that type.  scratch:
// with H > KV, float32 room for 2 x (B, Sk, H, hd) per-head partials
// (unused when H == KV).  Masks and scale as sira_flash_attention's;
// dtype_kind: 1 = float16, 2 = bfloat16.
extern "C" int sira_flash_bwd_dkdv_tc256(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dk, void* dv, void* scratch,
                                         int B, int Sq, int Sk, int H,
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
    float* part = (float*)scratch;
    switch (dtype_kind) {
    case 1: return (int)tc256::dkdv<__half>(a, dk, dv, part, s);
    case 2: return (int)tc256::dkdv<__nv_bfloat16>(a, dk, dv, part, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// the same inputs -> dq (B, Sq, H, hd) of their type
extern "C" int sira_flash_bwd_dq_tc256(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int B, int Sq, int Sk,
                                       int H, int KV, int hd,
                                       long long q_offset, long long window,
                                       int causal, float logit_cap,
                                       float scale, int dtype_kind,
                                       void* stream) {
    if (bad_shape(B, Sq, Sk, H, KV, hd, window))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, dout, (const float*)lse, (const float*)delta,
                 B, Sq, Sk, H, KV, hd, q_offset, window, causal, logit_cap,
                 scale};
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype_kind) {
    case 1: return (int)tc256::dq<__half>(a, dq, s);
    case 2: return (int)tc256::dq<__nv_bfloat16>(a, dq, s);
    default: return (int)cudaErrorInvalidValue;
    }
}
