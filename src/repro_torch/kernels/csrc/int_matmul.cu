// Integer matmul with a SIRA-minimised accumulator and an optional fused
// per-channel scale/bias epilogue, for sm_90a.
//
// Replaces the TPU kernel `_matmul_kernel` / `int_matmul` of
// src/repro/kernels/int_matmul.py.  It computes the same function and is
// not a block-by-block translation: the TPU kernel walks a sequential
// (M/bm, N/bn, K/bk) grid and carries the accumulator in scratch memory
// from one K step to the next; here one thread block owns one (BM, BN)
// output tile, loops over K in BK-wide slabs staged through shared memory,
// and keeps the accumulators in registers.  Edges are bound-checked, so
// no operand is padded.
//
// Bound on this card: the shapes of the main path are tall and skinny
// (M = n*ho*wo, K = 27..2304, N = 16..256) or tiny (batch x 64), so the
// least time is set by the bytes of x it reads and of out it writes, not
// by integer operations.  This version uses no tensor cores: int8 operands
// are packed four to a word along K as the slabs are staged and multiplied
// with __dp4a (four multiply-adds an instruction); int32 operands take
// plain 32-bit multiply-adds.  Both read each operand once per tile
// column, and both are limited by the integer ALU and shared-memory
// loads, well above the byte bound.
//
// Arithmetic contract (must be kept bit for bit by any faster version):
//   * products and sums wrap modulo 2^32 -- done on `unsigned`, signed
//     overflow being undefined (__dp4a wraps in hardware);
//   * narrow mode (acc_bits <= 15): the 32-bit sum is wrapped to 16 bits
//     once at the store and sign-extended.  Reduction modulo 2^16 is a
//     ring homomorphism of arithmetic modulo 2^32, so this equals
//     accumulating in int16 throughout;
//   * epilogue: float(acc) * scale[n] + bias[n] with separately rounded
//     multiply and add (__fmul_rn, __fadd_rn: no FMA contraction); a null
//     bias adds 0.0f.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;   // rows of the output tile
constexpr int BN = 64;   // columns of the output tile
constexpr int BK = 32;   // depth of one shared-memory slab
constexpr int TD = 16;   // threads per tile side; each owns a 4x4 micro-tile
constexpr int TM = BM / TD;
constexpr int TN = BN / TD;

enum OutKind { OUT_I16 = 0, OUT_I32 = 1, OUT_F32 = 2 };

// Store one accumulator: wrap to 16 bits in narrow mode, then the raw
// integer or the dequantised float.
template <int kOut>
__device__ __forceinline__ void store_acc(
        unsigned acc, void* __restrict__ out, long long o, long long n,
        const float* __restrict__ scale, const float* __restrict__ bias,
        int narrow) {
    int v = (int)acc;
    if (narrow) v = (int)(int16_t)(uint16_t)(acc & 0xFFFFu);
    if (kOut == OUT_I16) {
        ((int16_t*)out)[o] = (int16_t)v;
    } else if (kOut == OUT_I32) {
        ((int32_t*)out)[o] = v;
    } else {
        const float b = bias ? bias[n] : 0.0f;
        ((float*)out)[o] =
            __fadd_rn(__fmul_rn(__int2float_rn(v), scale[n]), b);
    }
}

template <typename TIn, int kOut>
__global__ void __launch_bounds__(TD * TD)
int_matmul_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, void* __restrict__ out,
                  long long M, long long K, long long N, int narrow) {
    // +1 column: the k-loop reads a column of As, keep its rows in
    // different banks
    __shared__ unsigned As[BM][BK + 1];
    __shared__ unsigned Bs[BK][BN];

    const int tid = threadIdx.x;
    const int tx = tid % TD;
    const int ty = tid / TD;
    const long long m0 = (long long)blockIdx.x * BM;
    const long long n0 = (long long)blockIdx.y * BN;

    unsigned acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

    for (long long k0 = 0; k0 < K; k0 += BK) {
        // x slab (BM, BK): consecutive threads read consecutive k
        for (int e = tid; e < BM * BK; e += TD * TD) {
            const int r = e / BK, c = e % BK;
            const long long m = m0 + r, k = k0 + c;
            int v = 0;
            if (m < M && k < K) v = (int)x[m * K + k];
            As[r][c] = (unsigned)v;
        }
        // w slab (BK, BN): consecutive threads read consecutive n
        for (int e = tid; e < BK * BN; e += TD * TD) {
            const int r = e / BN, c = e % BN;
            const long long k = k0 + r, n = n0 + c;
            int v = 0;
            if (k < K && n < N) v = (int)w[k * N + n];
            Bs[r][c] = (unsigned)v;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
            unsigned a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[ty + i * TD][k];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + j * TD];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long m = m0 + ty + i * TD;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const long long n = n0 + tx + j * TD;
            if (n >= N) continue;
            store_acc<kOut>(acc[i][j], out, m * N + n, n, scale, bias,
                            narrow);
        }
    }
}

// int8 operands: the same tiling with K packed four bytes to a word, so
// one __dp4a does four multiply-adds.  BK8 bytes of K per slab.
constexpr int BK8 = 64;
constexpr int KW = BK8 / 4;   // packed words per slab row

__device__ __forceinline__ unsigned pack4(int b0, int b1, int b2, int b3) {
    return (unsigned)(b0 & 0xFF) | ((unsigned)(b1 & 0xFF) << 8) |
           ((unsigned)(b2 & 0xFF) << 16) | ((unsigned)(b3 & 0xFF) << 24);
}

template <int kOut>
__global__ void __launch_bounds__(TD * TD)
int8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, void* __restrict__ out,
                   long long M, long long K, long long N, int narrow) {
    __shared__ unsigned As[BM][KW + 1];
    __shared__ unsigned Bs[KW][BN];

    const int tid = threadIdx.x;
    const int tx = tid % TD;
    const int ty = tid / TD;
    const long long m0 = (long long)blockIdx.x * BM;
    const long long n0 = (long long)blockIdx.y * BN;
    // rows of x start on a word boundary: whole words can be loaded
    const bool x_words = (K % 4 == 0) && (((uintptr_t)x & 3) == 0);

    int acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0;

    for (long long k0 = 0; k0 < K; k0 += BK8) {
        // x slab (BM, KW words): consecutive threads, consecutive words
        for (int e = tid; e < BM * KW; e += TD * TD) {
            const int r = e / KW, c = e % KW;
            const long long m = m0 + r, k = k0 + 4 * c;
            unsigned v = 0u;
            if (m < M && k < K) {
                const int8_t* p = x + m * K + k;
                if (x_words) {            // K % 4 == 0, so k + 3 < K
                    v = *(const unsigned*)p;
                } else {
                    v = pack4(p[0], k + 1 < K ? p[1] : 0,
                              k + 2 < K ? p[2] : 0, k + 3 < K ? p[3] : 0);
                }
            }
            As[r][c] = v;
        }
        // w slab (KW words, BN): four rows of w make one word; consecutive
        // threads read consecutive n of each row
        for (int e = tid; e < KW * BN; e += TD * TD) {
            const int r = e / BN, c = e % BN;
            const long long k = k0 + 4 * r, n = n0 + c;
            unsigned v = 0u;
            if (n < N && k < K) {
                const int8_t* p = w + k * N + n;
                v = pack4(p[0], k + 1 < K ? p[N] : 0,
                          k + 2 < K ? p[2 * N] : 0,
                          k + 3 < K ? p[3 * N] : 0);
            }
            Bs[r][c] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < KW; ++k) {
            int a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = (int)As[ty + i * TD][k];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = (int)Bs[k][tx + j * TD];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long m = m0 + ty + i * TD;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const long long n = n0 + tx + j * TD;
            if (n >= N) continue;
            store_acc<kOut>((unsigned)acc[i][j], out, m * N + n, n, scale,
                            bias, narrow);
        }
    }
}

template <typename TIn, int kOut>
void launch_kernel(dim3 grid, dim3 block, cudaStream_t stream, const TIn* x,
                   const TIn* w, const float* scale, const float* bias,
                   void* out, long long M, long long K, long long N,
                   int narrow) {
    if constexpr (std::is_same<TIn, int8_t>::value) {
        int8_matmul_kernel<kOut><<<grid, block, 0, stream>>>(
            x, w, scale, bias, out, M, K, N, narrow);
    } else {
        int_matmul_kernel<TIn, kOut><<<grid, block, 0, stream>>>(
            x, w, scale, bias, out, M, K, N, narrow);
    }
}

template <typename TIn>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* bias, void* out, long long M, long long K,
                   long long N, int out_kind, int narrow,
                   cudaStream_t stream) {
    const dim3 grid((unsigned)((M + BM - 1) / BM),
                    (unsigned)((N + BN - 1) / BN));
    const dim3 block(TD * TD);
    const TIn* xp = (const TIn*)x;
    const TIn* wp = (const TIn*)w;
    switch (out_kind) {
    case OUT_I16:
        launch_kernel<TIn, OUT_I16>(grid, block, stream, xp, wp, scale, bias,
                                    out, M, K, N, narrow);
        break;
    case OUT_I32:
        launch_kernel<TIn, OUT_I32>(grid, block, stream, xp, wp, scale, bias,
                                    out, M, K, N, narrow);
        break;
    case OUT_F32:
        launch_kernel<TIn, OUT_F32>(grid, block, stream, xp, wp, scale, bias,
                                    out, M, K, N, narrow);
        break;
    default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// in_kind: 0 = int8 operands, 1 = int32 operands.
// out_kind: 0 = int16, 1 = int32 (raw accumulator), 2 = float32 (epilogue;
// `scale` must then be non-null, `bias` may be null).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sira_int_matmul(const void* x, const void* w,
                               const float* scale, const float* bias,
                               void* out, long long M, long long K,
                               long long N, int in_kind, int out_kind,
                               int narrow, void* stream) {
    if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
    if (out_kind == OUT_F32 && scale == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (in_kind == 0)
        return (int)launch<int8_t>(x, w, scale, bias, out, M, K, N,
                                   out_kind, narrow, s);
    if (in_kind == 1)
        return (int)launch<int32_t>(x, w, scale, bias, out, M, K, N,
                                    out_kind, narrow, s);
    return (int)cudaErrorInvalidValue;
}
