// Flash attention, backward, for sm_90a: the gradients of
//     out[b, i, h, :] = sum_j P[i, j] v[b, j, h / g, :],
//     P[i, j] = softmax_j(s[i, j]),
//     s[i, j] = cap_fn(dot(q[b, i, h, :] * hd^-0.5, k[b, j, h / g, :]))
// masked as in the forward (flash_attention.cu: causal, window, q_offset,
// the finite -1e30), given dO = d loss / d out, the forward's out and its
// lse (log-sum-exp of each query row).  Three steps, one launch each
// (dK/dV on the tensor cores with GQA: two):
//
//   flash_bwd_delta  D[b, h, i] = sum_d dO[b, i, h, d] * out[b, i, h, d]
//                    (float32), one warp per row;
//   dK/dV            recompute S and P = exp(s - lse) (masked), dP =
//                    dO v^T, dS = P (dP - D) (times 1 - tanh^2 of the
//                    capped score when logit_cap > 0); dV = P^T dO,
//                    dK = dS^T q hd^-0.5;
//   dQ               recompute P and dS the same way; dQ = dS k hd^-0.5.
//
// There is no TPU kernel to replace: the reference differentiates its
// plain scanned attention (src/repro/models/attention.py flash_attention)
// with jax.vjp.  These kernels give the forward kernel a gradient, so
// Model.loss trains on the card through it.
//
// What bounds it on this card: operations.  The backward needs five
// products of the forward's size (S, dP, dV, dK, dQ), 2.5x the forward's
// 4 * B * H * hd * (visible query-key pairs); this file computes S and dP
// in both big kernels (seven products), which is how it avoids atomics.
// At qwen2-1.5b's layer (B = 1, S = 4096, H = 12, KV = 2, hd = 128,
// causal) the five are 1.3e11 operations: 0.13 ms at the 989 TFLOP/s of
// the 16-bit tensor cores, 1.9 ms at the 67 TFLOP/s of float32 FMAs.
//
// Two routes for dK/dV and dQ, chosen by the wrapper before launch
// (kernels/flash_attention.py route_for) and counted apart.  This file
// holds D and the cuda_cores route; flash_attention_bwd_tc.cu the
// tensor_cores route for hd <= 128 and flash_attention_bwd_tc256.cu for
// 128 < hd <= 256 (sources of their own, so they compile at the same
// time; its note gives that tiling's design); flash_bwd.cuh what all
// share (tile ranges, mask, arguments), flash_bwd_tc.cuh what the two
// tensor-core sources share.
//
// tensor_cores: bfloat16 / float16 with hd <= 128 (hd % 8 == 0, padded
//   to 64 or 128 with zeros by TMA's out-of-bounds fill), after
//   FlashAttention-3's backward and with the forward's building blocks
//   (flash_tc.cuh: wgmma, the 4-D TMA map; hopper.cuh: mbarriers).  A
//   block is 384 threads: two consumer warpgroups and one producer
//   warpgroup that gives its registers away (setmaxnreg 24 / 240).
//   `flash_bwd_dkdv_tc`: one block per (batch x query head, 128 keys),
//     key tile 0 (the one a causal mask keeps longest) launched first.
//     K and V of the tile load once by TMA; the Q and dO tiles of every
//     visible 64-row query tile stream through a 2-stage mbarrier ring
//     (one TMA thread), with lse and D (one warp of plain loads: a
//     ragged Sq leaves their rows off TMA's 16-byte grid).  Each consumer
//     warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T are ss wgmma
//     with both operands K-major; P^T and dS^T form in registers, are
//     rounded to 16-bit A fragments (an m64nN accumulator is laid out as
//     the register A operand of m64nNk16), and dV += P^T dO, dK += dS^T Q
//     run as rs wgmma with dO and Q read MN-major (the transpose bit):
//     nothing is transposed in memory.  dK is scaled by hd^-0.5 once.
//     The GQA sum without atomics: with g = H / KV > 1 each block writes
//     its head's float32 partial dK, dV to a scratch (B, Sk, H, hd) that
//     the wrapper allocates, and `flash_bwd_dkdv_sum` adds a group's g
//     heads in head order and rounds once; with g = 1 the block writes
//     dK, dV itself.  One block per query head gives 16 x 12 = 192
//     blocks at qwen2-1.5b's 1 x 2048 against 64 on the CUDA cores.
//   `flash_bwd_dq_tc`: one block per (128 query rows, batch x head), the
//     longest rows first; Q, dO (TMA), lse and D load once; K and V tiles
//     of 64 keys stream through the ring; S = Q K^T and dP = dO V^T (ss),
//     dS in registers, rounded, dQ += dS K (rs, K read MN-major); dQ is
//     scaled by hd^-0.5 at the end.
//   Rounding P and dS to 16 bits before the three products is the one
//   change to the arithmetic contract below: flash_attention.py
//   grad_tolerance adds 2 P_ROUNDING times the products of absolute
//   values (ref.py flash_attention_bwd_magnitudes).  S and dP are
//   products of 16-bit inputs, exact in float32; scaling S after the dot
//   instead of q before it differs by float32 rounding, as in the
//   forward; P = exp2(s hd^-0.5 log2(e) - lse log2(e)).  Inside a
//   warpgroup the products and the elementwise step run one after the
//   other; the two warpgroups overlap through the scheduler.
//
// cuda_cores: float32 (exact float32 has no tensor-core path; TF32 would
//   miss the float32 gradient bar); bf16/f16 only when forced.
//   `flash_bwd_dkdv`: one block per (key tile,
//   batch x KV head) walks every query tile of every query head of its
//   GQA group, so the group's sum stays in the block; `flash_bwd_dq`:
//   one block per (query tile, batch x head) walks the key tiles.  Every
//   product is a float32 FMA from 64 x 64 tiles (32 x 32 at hd = 256)
//   staged and widened through shared memory, 256 threads a block.
//
// Arithmetic contract (the plain version is kernels/ref.py
// flash_attention_bwd_ref, which takes the same out and lse):
// - every sum is float32, in a fixed order: each gradient element is
//   summed inside one block, and the GQA partials in head order, with no
//   atomics, so two calls give the same bits;
// - cuda_cores: q is scaled by the float32 hd^-0.5 before the dot, as in
//   the plain version; dK sums dS times that scaled q; dQ sums dS times
//   k and is then multiplied by hd^-0.5; every product is of float32
//   values;
// - tensor_cores: as above, but P and dS are rounded to the input's
//   16-bit type before the products, and dK, like dQ, is scaled after
//   its sum;
// - a masked pair has dS = 0 (the gradient of the mask's where); its P
//   is 0, except in a row that sees no key at all (lse below -1e29, see
//   flash_attention.cu), whose forward averaged v over all Sk keys: there
//   P = 1 / Sk and dV gets that row's share;
// - the gradients are rounded once, to the input's type.
// Edges are bound-checked (rows past Sq or Sk are zero in shared memory
// and never written); hd <= 256.  Each C entry returns the
// cudaError_t of its launches.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd.cuh"

namespace {

using namespace sira::bwd;

constexpr int THREADS = 256;    // 16 x 16 threads: (ty, tx)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
    return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// (a) D = rowsum(dO * out)
// ---------------------------------------------------------------------------

constexpr int DELTA_WARPS = THREADS / 32;

// rows r = (b Sq + i) H + h of out and dout, hd contiguous values each;
// D[(b H + h) Sq + i]
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout,
                float* __restrict__ delta, long long rows, int Sq, int H,
                int hd) {
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * DELTA_WARPS;
    for (long long r = (long long)blockIdx.x * DELTA_WARPS +
                       threadIdx.x / 32;
         r < rows; r += stride) {
        const T* o = out + r * hd;
        const T* d = dout + r * hd;
        float acc = 0.f;
        for (int c = lane; c < hd; c += 32)
            acc = fmaf(to_f(o[c]), to_f(d[c]), acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) {
            const long long h = r % H, bi = r / H;
            const long long i = bi % Sq, b = bi / Sq;
            delta[(b * H + h) * Sq + i] = acc;
        }
    }
}

// ---------------------------------------------------------------------------
// the tiles of (b) and (c)
// ---------------------------------------------------------------------------

template <int HDP>
struct Tiles {
    static constexpr int BQ = HDP == 256 ? 32 : 64;   // query rows a tile
    static constexpr int BK = BQ;                     // keys a tile
    static constexpr int RQ = BQ / 16;   // query rows of a thread (S, dP)
    static constexpr int RK = BK / 16;   // keys of a thread
    static constexpr int ST = HDP + 4;   // row stride of a (rows, hd) tile
    static constexpr int PST = BQ + 4;   // row stride of a (BQ, BK) tile
    static constexpr int COLS = HDP / 16;            // head dims a thread
    static constexpr int VW = COLS < 4 ? COLS : 4;   // sums over rows
    static constexpr int NJ = COLS / VW;
    // (b): K, V, Q, dO tiles; P and dS as (query, key); lse and D
    static constexpr size_t dkdv_bytes =
        (size_t)((2 * BK + 2 * BQ) * ST + 2 * BQ * PST + 2 * BQ) *
        sizeof(float);
    // (c): Q, dO, K, V tiles; dS as (key, query); lse and D
    static constexpr size_t dq_bytes =
        (size_t)((2 * BK + 2 * BQ) * ST + BK * PST + 2 * BQ) * sizeof(float);
};

// rows [row0, row0 + rows) of a (n_rows, hd) slab with row stride
// `stride`, widened to float32 and times `mul`, into a tile of stride
// HDP + 4; rows past n_rows and columns past hd are zero
template <int HDP, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int row0, int rows,
                                      int n_rows, int hd, float mul) {
    constexpr int ST = HDP + 4;
    for (int i = threadIdx.x; i < rows * HDP; i += THREADS) {
        const int r = i / HDP, d = i % HDP;
        float x = 0.f;
        if (row0 + r < n_rows && d < hd)
            x = to_f(src[(long long)(row0 + r) * stride + d]) * mul;
        dst[r * ST + d] = x;
    }
}

// acc[ii][jj] = dot(A row (ty RQ + ii), B row (tx + 16 jj)) over HDP
template <int HDP>
__device__ __forceinline__ void tile_dot(
    float (&acc)[Tiles<HDP>::RQ][Tiles<HDP>::RK], const float* A,
    const float* Bm, int ty, int tx) {
    using L = Tiles<HDP>;
#pragma unroll
    for (int ii = 0; ii < L::RQ; ++ii)
#pragma unroll
        for (int jj = 0; jj < L::RK; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
        float4 a[L::RQ], b[L::RK];
#pragma unroll
        for (int ii = 0; ii < L::RQ; ++ii)
            a[ii] = *reinterpret_cast<const float4*>(
                &A[(ty * L::RQ + ii) * L::ST + d]);
#pragma unroll
        for (int jj = 0; jj < L::RK; ++jj)
            b[jj] = *reinterpret_cast<const float4*>(
                &Bm[(tx + 16 * jj) * L::ST + d]);
#pragma unroll
        for (int ii = 0; ii < L::RQ; ++ii)
#pragma unroll
            for (int jj = 0; jj < L::RK; ++jj) {
                float x = acc[ii][jj];
                x = fmaf(a[ii].x, b[jj].x, x);
                x = fmaf(a[ii].y, b[jj].y, x);
                x = fmaf(a[ii].z, b[jj].z, x);
                x = fmaf(a[ii].w, b[jj].w, x);
                acc[ii][jj] = x;
            }
    }
}

// s (the scaled dot) becomes P and dp becomes dS, for the thread's pairs
// of query rows q0 + ty RQ + ii and keys k0 + tx + 16 jj; row_lse and
// row_d hold the tile's lse and D
template <int HDP>
__device__ __forceinline__ void p_and_ds(
    float (&s)[Tiles<HDP>::RQ][Tiles<HDP>::RK],
    float (&dp)[Tiles<HDP>::RQ][Tiles<HDP>::RK], const float* row_lse,
    const float* row_d, int q0, int k0, int ty, int tx, const Mask& mk) {
    using L = Tiles<HDP>;
#pragma unroll
    for (int ii = 0; ii < L::RQ; ++ii) {
        const int i = ty * L::RQ + ii;
        const long long qp = mk.q_offset + q0 + i;
        const float lse = row_lse[i], D = row_d[i];
#pragma unroll
        for (int jj = 0; jj < L::RK; ++jj) {
            const int kp = k0 + tx + 16 * jj;
            float x = s[ii][jj], t = 0.f;
            if (mk.cap != 0.f) {
                t = tanhf(x / mk.cap);
                x = mk.cap * t;
            }
            float p = 0.f, ds = 0.f;
            if (q0 + i < mk.Sq && kp < mk.Sk) {
                if ((mk.causal && qp < kp) ||
                    (mk.window > 0 && qp - kp >= mk.window)) {
                    p = lse < DEAD_LSE ? mk.inv_sk : 0.f;
                } else {
                    p = expf(x - lse);
                    ds = p * (dp[ii][jj] - D);
                    if (mk.cap != 0.f) ds *= 1.f - t * t;
                }
            }
            s[ii][jj] = p;
            dp[ii][jj] = ds;
        }
    }
}

// the VW head dims of column group jj of thread tx, from row r of a tile
template <int HDP>
__device__ __forceinline__ void load_cols(float (&x)[Tiles<HDP>::VW],
                                          const float* row, int tx,
                                          int jj) {
    using L = Tiles<HDP>;
    const float* p = row + tx * L::VW + jj * 16 * L::VW;
    if constexpr (L::VW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else if constexpr (L::VW == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        x[0] = t.x; x[1] = t.y;
    } else {
        x[0] = p[0];
    }
}

// ---------------------------------------------------------------------------
// (b) dK, dV
// ---------------------------------------------------------------------------

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int Sq, int Sk, int H, int KV, int hd,
               long long q_offset, long long window, int causal, float cap,
               float scale) {
    using L = Tiles<HDP>;
    constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST, PST = L::PST;
    extern __shared__ float4 smem_f4[];
    float* Ks = reinterpret_cast<float*>(smem_f4);
    float* Vs = Ks + BK * ST;
    float* Qs = Vs + BK * ST;
    float* dOs = Qs + BQ * ST;
    float* Ps = dOs + BQ * ST;       // (query, key)
    float* dSs = Ps + BQ * PST;      // (query, key)
    float* row_lse = dSs + BQ * PST;
    float* row_d = row_lse + BQ;

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
    const int g = H / KV;
    const int k0 = blockIdx.x * BK;
    const long long q_stride = (long long)H * hd;
    const long long kv_stride = (long long)KV * hd;
    const long long kv_base = ((long long)b * Sk * KV + kvh) * hd;
    const Mask mk{Sq, Sk, causal, q_offset, window, cap, 1.f / (float)Sk};

    stage<HDP>(Ks, k + kv_base, kv_stride, k0, BK, Sk, hd, 1.f);
    stage<HDP>(Vs, v + kv_base, kv_stride, k0, BK, Sk, hd, 1.f);

    float dk_acc[L::RK][L::COLS], dv_acc[L::RK][L::COLS];
#pragma unroll
    for (int kk = 0; kk < L::RK; ++kk)
#pragma unroll
        for (int c = 0; c < L::COLS; ++c) dk_acc[kk][c] = dv_acc[kk][c] = 0.f;

    const TileRange qr =
        query_tiles(k0, BK, BQ, Sq, Sk, q_offset, window, causal);
    for (int hh = 0; hh < g; ++hh) {
        const int h = kvh * g + hh;
        const long long q_base = ((long long)b * Sq * H + h) * hd;
        const float* lse_h = lse + ((long long)b * H + h) * Sq;
        const float* d_h = delta + ((long long)b * H + h) * Sq;
        for (int qt = qr.lo; qt < qr.hi; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();     // the last tile's Q, dO, P, dS are read
            stage<HDP>(Qs, q + q_base, q_stride, q0, BQ, Sq, hd, scale);
            stage<HDP>(dOs, dout + q_base, q_stride, q0, BQ, Sq, hd, 1.f);
            for (int i = tid; i < BQ; i += THREADS) {
                const bool in = q0 + i < Sq;
                row_lse[i] = in ? lse_h[q0 + i] : 0.f;
                row_d[i] = in ? d_h[q0 + i] : 0.f;
            }
            __syncthreads();

            float s[L::RQ][L::RK], dp[L::RQ][L::RK];
            tile_dot<HDP>(s, Qs, Ks, ty, tx);
            tile_dot<HDP>(dp, dOs, Vs, ty, tx);
            p_and_ds<HDP>(s, dp, row_lse, row_d, q0, k0, ty, tx, mk);
#pragma unroll
            for (int ii = 0; ii < L::RQ; ++ii)
#pragma unroll
                for (int jj = 0; jj < L::RK; ++jj) {
                    const int at = (ty * L::RQ + ii) * PST + tx + 16 * jj;
                    Ps[at] = s[ii][jj];
                    dSs[at] = dp[ii][jj];
                }
            __syncthreads();

            // this thread: keys ty RK + kk, its head dims
#pragma unroll 2
            for (int r = 0; r < BQ; ++r) {
                float pk[L::RK], dsk[L::RK];
#pragma unroll
                for (int kk = 0; kk < L::RK; ++kk) {
                    pk[kk] = Ps[r * PST + ty * L::RK + kk];
                    dsk[kk] = dSs[r * PST + ty * L::RK + kk];
                }
#pragma unroll
                for (int jj = 0; jj < L::NJ; ++jj) {
                    float dov[L::VW], qv[L::VW];
                    load_cols<HDP>(dov, dOs + r * ST, tx, jj);
                    load_cols<HDP>(qv, Qs + r * ST, tx, jj);
#pragma unroll
                    for (int kk = 0; kk < L::RK; ++kk)
#pragma unroll
                        for (int e = 0; e < L::VW; ++e) {
                            dv_acc[kk][jj * L::VW + e] = fmaf(
                                pk[kk], dov[e], dv_acc[kk][jj * L::VW + e]);
                            dk_acc[kk][jj * L::VW + e] = fmaf(
                                dsk[kk], qv[e], dk_acc[kk][jj * L::VW + e]);
                        }
                }
            }
        }
    }

#pragma unroll
    for (int kk = 0; kk < L::RK; ++kk) {
        const int key = k0 + ty * L::RK + kk;
        if (key >= Sk) continue;
        T* dk_row = dk + kv_base + (long long)key * kv_stride;
        T* dv_row = dv + kv_base + (long long)key * kv_stride;
#pragma unroll
        for (int jj = 0; jj < L::NJ; ++jj)
#pragma unroll
            for (int e = 0; e < L::VW; ++e) {
                const int d = tx * L::VW + jj * 16 * L::VW + e;
                if (d < hd) {
                    dk_row[d] = from_f<T>(dk_acc[kk][jj * L::VW + e]);
                    dv_row[d] = from_f<T>(dv_acc[kk][jj * L::VW + e]);
                }
            }
    }
}

// ---------------------------------------------------------------------------
// (c) dQ
// ---------------------------------------------------------------------------

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int Sq, int Sk, int H, int KV, int hd,
             long long q_offset, long long window, int causal, float cap,
             float scale) {
    using L = Tiles<HDP>;
    constexpr int BQ = L::BQ, BK = L::BK, ST = L::ST, PST = L::PST;
    extern __shared__ float4 smem_f4[];
    float* Qs = reinterpret_cast<float*>(smem_f4);
    float* dOs = Qs + BQ * ST;
    float* Ks = dOs + BQ * ST;
    float* Vs = Ks + BK * ST;
    float* dSt = Vs + BK * ST;       // (key, query)
    float* row_lse = dSt + BK * PST;
    float* row_d = row_lse + BQ;

    const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
    const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int q0 = qt * BQ;
    const long long q_stride = (long long)H * hd;
    const long long kv_stride = (long long)KV * hd;
    const long long q_base = ((long long)b * Sq * H + h) * hd;
    const long long kv_base = ((long long)b * Sk * KV + kvh) * hd;
    const Mask mk{Sq, Sk, causal, q_offset, window, cap, 1.f / (float)Sk};

    stage<HDP>(Qs, q + q_base, q_stride, q0, BQ, Sq, hd, scale);
    stage<HDP>(dOs, dout + q_base, q_stride, q0, BQ, Sq, hd, 1.f);
    for (int i = tid; i < BQ; i += THREADS) {
        const bool in = q0 + i < Sq;
        row_lse[i] = in ? lse[((long long)b * H + h) * Sq + q0 + i] : 0.f;
        row_d[i] = in ? delta[((long long)b * H + h) * Sq + q0 + i] : 0.f;
    }

    float dq_acc[L::RQ][L::COLS];
#pragma unroll
    for (int ii = 0; ii < L::RQ; ++ii)
#pragma unroll
        for (int c = 0; c < L::COLS; ++c) dq_acc[ii][c] = 0.f;

    const TileRange kr =
        key_tiles(q0, BQ, BK, Sq, Sk, q_offset, window, causal);
    for (int kt = kr.lo; kt < kr.hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();        // Q staged / the last tile's K, dS read
        stage<HDP>(Ks, k + kv_base, kv_stride, k0, BK, Sk, hd, 1.f);
        stage<HDP>(Vs, v + kv_base, kv_stride, k0, BK, Sk, hd, 1.f);
        __syncthreads();

        float s[L::RQ][L::RK], dp[L::RQ][L::RK];
        tile_dot<HDP>(s, Qs, Ks, ty, tx);
        tile_dot<HDP>(dp, dOs, Vs, ty, tx);
        p_and_ds<HDP>(s, dp, row_lse, row_d, q0, k0, ty, tx, mk);
#pragma unroll
        for (int ii = 0; ii < L::RQ; ++ii)
#pragma unroll
            for (int jj = 0; jj < L::RK; ++jj)
                dSt[(tx + 16 * jj) * PST + ty * L::RQ + ii] = dp[ii][jj];
        __syncthreads();

        // this thread: query rows ty RQ + ii, its head dims
#pragma unroll 2
        for (int c = 0; c < BK; ++c) {
            float dsq[L::RQ];
#pragma unroll
            for (int ii = 0; ii < L::RQ; ++ii)
                dsq[ii] = dSt[c * PST + ty * L::RQ + ii];
#pragma unroll
            for (int jj = 0; jj < L::NJ; ++jj) {
                float kv[L::VW];
                load_cols<HDP>(kv, Ks + c * ST, tx, jj);
#pragma unroll
                for (int ii = 0; ii < L::RQ; ++ii)
#pragma unroll
                    for (int e = 0; e < L::VW; ++e)
                        dq_acc[ii][jj * L::VW + e] = fmaf(
                            dsq[ii], kv[e], dq_acc[ii][jj * L::VW + e]);
            }
        }
    }

#pragma unroll
    for (int ii = 0; ii < L::RQ; ++ii) {
        const int row = q0 + ty * L::RQ + ii;
        if (row >= Sq) continue;
        T* dq_row = dq + q_base + (long long)row * q_stride;
#pragma unroll
        for (int jj = 0; jj < L::NJ; ++jj)
#pragma unroll
            for (int e = 0; e < L::VW; ++e) {
                const int d = tx * L::VW + jj * 16 * L::VW + e;
                if (d < hd)
                    dq_row[d] = from_f<T>(dq_acc[ii][jj * L::VW + e] * scale);
            }
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int HDP>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv, cudaStream_t s) {
    using L = Tiles<HDP>;
    static unsigned configured = 0;
    cudaError_t err =
        allow_smem(flash_bwd_dkdv<T, HDP>, L::dkdv_bytes, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.Sk + L::BK - 1) / L::BK),
                    (unsigned)(a.B * a.KV));
    flash_bwd_dkdv<T, HDP><<<grid, THREADS, L::dkdv_bytes, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.delta, (T*)dk, (T*)dv, a.Sq, a.Sk, a.H, a.KV, a.hd, a.q_offset,
        a.window, a.causal, a.cap, a.scale);
    return cudaGetLastError();
}

template <typename T, int HDP>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t s) {
    using L = Tiles<HDP>;
    static unsigned configured = 0;
    cudaError_t err =
        allow_smem(flash_bwd_dq<T, HDP>, L::dq_bytes, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((a.Sq + L::BQ - 1) / L::BQ),
                    (unsigned)(a.B * a.H));
    flash_bwd_dq<T, HDP><<<grid, THREADS, L::dq_bytes, s>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse,
        a.delta, (T*)dq, a.Sq, a.Sk, a.H, a.KV, a.hd, a.q_offset, a.window,
        a.causal, a.cap, a.scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dkdv_by_width(const Args& a, void* dk, void* dv,
                          cudaStream_t s) {
    if (a.hd <= 32) return launch_dkdv<T, 32>(a, dk, dv, s);
    if (a.hd <= 64) return launch_dkdv<T, 64>(a, dk, dv, s);
    if (a.hd <= 128) return launch_dkdv<T, 128>(a, dk, dv, s);
    return launch_dkdv<T, 256>(a, dk, dv, s);
}

template <typename T>
cudaError_t dq_by_width(const Args& a, void* dq, cudaStream_t s) {
    if (a.hd <= 32) return launch_dq<T, 32>(a, dq, s);
    if (a.hd <= 64) return launch_dq<T, 64>(a, dq, s);
    if (a.hd <= 128) return launch_dq<T, 128>(a, dq, s);
    return launch_dq<T, 256>(a, dq, s);
}

}  // namespace

// out, dout (B, Sq, H, hd) contiguous, of one type -> delta float32
// (B, H, Sq).  dtype_kind: 0 = float32, 1 = float16, 2 = bfloat16.
extern "C" int sira_flash_bwd_delta(const void* out, const void* dout,
                                    void* delta, int B, int Sq, int H,
                                    int hd, int dtype_kind, void* stream) {
    if (B <= 0 || Sq <= 0 || H <= 0 || hd <= 0)
        return (int)cudaErrorInvalidValue;
    const long long rows = (long long)B * Sq * H;
    const long long want = (rows + DELTA_WARPS - 1) / DELTA_WARPS;
    const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
    cudaStream_t s = (cudaStream_t)stream;
    float* d = (float*)delta;
    switch (dtype_kind) {
    case 0:
        flash_bwd_delta<float><<<blocks, THREADS, 0, s>>>(
            (const float*)out, (const float*)dout, d, rows, Sq, H, hd);
        break;
    case 1:
        flash_bwd_delta<__half><<<blocks, THREADS, 0, s>>>(
            (const __half*)out, (const __half*)dout, d, rows, Sq, H, hd);
        break;
    case 2:
        flash_bwd_delta<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
            (const __nv_bfloat16*)out, (const __nv_bfloat16*)dout, d, rows,
            Sq, H, hd);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// q, dout (B, Sq, H, hd); k, v (B, Sk, KV, hd), contiguous, of one type;
// lse, delta float32 (B, H, Sq) -> dk, dv (B, Sk, KV, hd) of that type.
// Masks and scale as sira_flash_attention's.
extern "C" int sira_flash_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int Sq, int Sk,
                                   int H, int KV, int hd, long long q_offset,
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
    case 0: return (int)dkdv_by_width<float>(a, dk, dv, s);
    case 1: return (int)dkdv_by_width<__half>(a, dk, dv, s);
    case 2: return (int)dkdv_by_width<__nv_bfloat16>(a, dk, dv, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// the same inputs -> dq (B, Sq, H, hd) of their type
extern "C" int sira_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int Sq,
                                 int Sk, int H, int KV, int hd,
                                 long long q_offset, long long window,
                                 int causal, float logit_cap, float scale,
                                 int dtype_kind, void* stream) {
    if (bad_shape(B, Sq, Sk, H, KV, hd, window))
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, dout, (const float*)lse, (const float*)delta,
                 B, Sq, Sk, H, KV, hd, q_offset, window, causal, logit_cap,
                 scale};
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype_kind) {
    case 0: return (int)dq_by_width<float>(a, dq, s);
    case 1: return (int)dq_by_width<__half>(a, dq, s);
    case 2: return (int)dq_by_width<__nv_bfloat16>(a, dq, s);
    default: return (int)cudaErrorInvalidValue;
    }
}
