// Flash attention, forward, for sm_90a:
//     out[b, i, h, :] = sum_j softmax_j(s[i, j]) v[b, j, h / g, :]
//     s[i, j] = cap_fn(dot(q[b, i, h, :] * hd^-0.5, k[b, j, h / g, :]))
// masked to the finite -1e30 where key j is not visible from query i
// (causal: q_offset + i >= j; window: q_offset + i - j < window).
//
// Replaces the TPU kernel `_fa_kernel` / `flash_attention_fwd` of
// src/repro/kernels/flash_attention.py, and computes the function of the
// model's scan, `flash_attention` in src/repro/models/attention.py, which
// is a superset (window, q_offset, ragged lengths), so every attention
// call of Model.forward on a card goes through this kernel.  It reads the
// JAX layout directly: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), out like q;
// no transpose and no repeat of K/V (GQA: query head h reads KV head
// h / (H / KV)).
//
// What bounds it on this card.  Bytes: q, k, v read once, out written
// once.  Operations: 4 * B * H * hd * (visible query-key pairs), about
// half of 4*B*H*Sq*Sk*hd when causal, at the bf16 tensor-core peak of
// 989 TFLOP/s.  At qwen2-1.5b's layer (B=1, S=4096, H=12, KV=2, hd=128,
// bf16): 5.2e10 operations -> 0.052 ms against 29 MB -> 0.009 ms, so
// operations bound it.
//
// What this design does about it: little yet, on purpose (simple and
// right first).  One block of 256 threads per (64 query rows, batch x
// head); it walks 64-key tiles of K and V staged through shared memory
// (K and V share one buffer), keeps the online-softmax state (m, l) and
// the 64 x hd output accumulator in registers, and does every product as
// float32 FMAs on the CUDA cores (4x4 register tile for Q.K^T, 4 rows x
// hd/16 columns per thread for P.V).  The float32 peak outside the tensor
// cores is 67 TFLOP/s, so the same work takes at least 0.77 ms at that
// layer: this kernel is 15x its bound by construction.  Tiles entirely
// past the diagonal (causal) or before the window are skipped.  Query
// tiles are launched longest-first, so the causal triangle's long rows do
// not form the tail.  Tensor cores (mma.sync / wgmma), TMA and warp
// specialisation are a later change.
//
// Arithmetic contract (kept by the plain version, kernels/ref.py):
// inputs are converted to float32, q is multiplied by the float32 scale
// hd^-0.5 BEFORE the dot, scores, softmax and the P.V product are
// float32, the result is acc / max(l, 1e-30) rounded once to q's type.
// Masked scores are -1e30, never -inf: a tile in which a row sees no key
// gives p = exp(0) = 1 garbage that the first visible key wipes exactly
// (its correction factor exp(-1e30 - m) is 0); with -inf that step is
// NaN.  Keys past Sk (the ragged last tile) are -inf and give p = 0.
//
// Trap for the tensor-core version: hd^-0.5 is not representable in bf16
// unless hd is a power of 4 (hd = 128 gives 2^-3.5), so a bf16 product
// of q with the scale folded in after the dot rounds differently from
// this kernel; that version has to state its own tolerance.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty owns rows 4ty..4ty+3, tx
                                // owns keys tx + 16j and 1/16 of hd
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__half* p, float x) {
    *p = __float2half_rn(x);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

template <int HDP>
struct Layout {
    static constexpr int QST = HDP + 4;   // row stride of the Q, K/V tiles
    static constexpr int PST = BQ + 4;    // row stride of P^T (key-major)
    static constexpr size_t bytes =
        (size_t)(BQ * QST + BK * QST + BK * PST) * sizeof(float);
};

// rows [row0, row0 + 64) of a (rows, hd) slab with row stride `stride`
// into a float32 tile, times `mul`; rows past n_rows and columns past hd
// are zero
template <typename T, int HDP>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int row0,
                                      int n_rows, int hd, float mul) {
    constexpr int QST = Layout<HDP>::QST;
    for (int i = threadIdx.x; i < 64 * HDP; i += THREADS) {
        const int r = i / HDP, d = i % HDP;
        float x = 0.f;
        if (row0 + r < n_rows && d < hd)
            x = to_f32(src[(long long)(row0 + r) * stride + d]) * mul;
        dst[r * QST + d] = x;
    }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int KV, int hd, long long q_offset, long long window,
             int causal, float cap, float scale) {
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
    const T* qb = q + ((long long)b * Sq * H + h) * hd;
    const T* kb = k + ((long long)b * Sk * KV + kvh) * hd;
    const T* vb = v + ((long long)b * Sk * KV + kvh) * hd;
    T* ob = out + ((long long)b * Sq * H + h) * hd;

    stage<T, HDP>(Qs, qb, q_stride, q0, Sq, hd, scale);

    // Key tiles to visit.  Skipping is exact only when every row has a
    // visible key (a fully masked row averages over ALL keys in the
    // reference): true when causal and 0 <= q_pos < Sk for every row.
    const int n_kt = (Sk + BK - 1) / BK;
    const int q_rows = min(BQ, Sq - q0);
    const long long q_lo = q_offset + q0, q_hi = q_lo + q_rows - 1;
    int kt_lo = 0, kt_hi = n_kt;
    if (causal && q_lo >= 0 && q_hi < Sk) {
        kt_hi = (int)(q_hi / BK) + 1;
        const long long first = q_lo - window + 1;
        if (window > 0 && first > 0) kt_lo = (int)(first / BK);
    }

    float m[4], l[4], acc[4][COLS];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
    }

    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();        // Q staged / last tile's V and P read
        stage<T, HDP>(KVs, kb, kv_stride, k0, Sk, hd, 1.f);
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
        stage<T, HDP>(KVs, vb, kv_stride, k0, Sk, hd, 1.f);
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
                    store(&ob[(long long)r * q_stride + d],
                          acc[i][jj * VW + e] / den);
            }
    }
}

template <typename T, int HDP>
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
        err = cudaFuncSetAttribute(flash_kernel<T, HDP>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return err;
        if (dev < 32) configured |= 1u << dev;
    }
    const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)(B * H));
    flash_kernel<T, HDP><<<grid, THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, KV, hd,
        q_offset, window, causal, cap, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t by_width(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int H, int KV, int hd,
                     long long q_offset, long long window, int causal,
                     float cap, float scale, cudaStream_t s) {
    if (hd <= 32)
        return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                             window, causal, cap, scale, s);
    if (hd <= 64)
        return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                             window, causal, cap, scale, s);
    if (hd <= 128)
        return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                              window, causal, cap, scale, s);
    return launch<T, 256>(q, k, v, out, B, Sq, Sk, H, KV, hd, q_offset,
                          window, causal, cap, scale, s);
}

}  // namespace

// q (B, Sq, H, hd), k/v (B, Sk, KV, hd), out (B, Sq, H, hd), contiguous,
// all of one type.  dtype_kind: 0 = float32, 1 = float16, 2 = bfloat16.
// causal: 0/1; window: 0 = none; logit_cap: 0 = none; scale: hd^-0.5 as
// float32.  Returns the cudaError_t of the launch (0 = success).
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
        return (int)by_width<float>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                    q_offset, window, causal, logit_cap,
                                    scale, s);
    case 1:
        return (int)by_width<__half>(q, k, v, out, B, Sq, Sk, H, KV, hd,
                                     q_offset, window, causal, logit_cap,
                                     scale, s);
    case 2:
        return (int)by_width<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV,
                                            hd, q_offset, window, causal,
                                            logit_cap, scale, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
