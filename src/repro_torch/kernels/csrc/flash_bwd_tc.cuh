// What the two tiles of the tensor_cores route of the attention backward
// share (flash_attention_bwd_tc.cu: hd <= 128; flash_attention_bwd_tc256.cu:
// 128 < hd <= 256): the block shape (two consumer warpgroups and a
// producer warpgroup), the ring depth, P and dS of one pair, the mask
// tests, S = A B^T issued as ss wgmma, the four tensor maps, and the GQA
// sum of the per-head float32 partials (flash_bwd_dkdv_sum), which has
// internal linkage so that each source holds its own copy.  Plain C
// interface: no PyTorch header.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_tc.cuh"
#include "hopper.cuh"

namespace sira {
namespace bwd_tc {
namespace {

using namespace sira::bwd;
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

// the second launch of a GQA dK/dV call: the sum of the per-head partials
// part_k, part_v that the first wrote
template <typename T>
cudaError_t run_dkdv_sum(const Args& a, void* dk, void* dv,
                         const float* part_k, const float* part_v,
                         cudaStream_t s) {
    const long long rows = (long long)a.B * a.Sk * a.KV;
    const long long want = (rows * (a.hd / 4) + 255) / 256;
    const unsigned blocks = (unsigned)(want < 132 * 8 ? want : 132 * 8);
    flash_bwd_dkdv_sum<T><<<dim3(blocks, 2), 256, 0, s>>>(
        part_k, part_v, (T*)dk, (T*)dv, rows, a.H / a.KV, a.hd);
    return cudaGetLastError();
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

// what the route takes: 16-byte rows (hd % 8 == 0) on 16-byte aligned
// bases, hd <= max_hd
inline bool takes(const Args& a, int max_hd) {
    return a.hd % 8 == 0 && a.hd <= max_hd &&
           ((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
            (uintptr_t)a.dout) % 16 == 0;
}

}  // namespace
}  // namespace bwd_tc
}  // namespace sira
