// Integer matmul with a SIRA-minimised accumulator and an optional fused
// per-channel scale/bias epilogue, for sm_90a.
//
// Replaces the TPU kernel `_matmul_kernel` / `int_matmul` of
// src/repro/kernels/int_matmul.py.  It computes the same function and is
// not a block-by-block translation: the TPU kernel walks a sequential
// (M/bm, N/bn, K/bk) grid and carries the accumulator in scratch memory
// from one K step to the next; here a thread block owns whole (BM, BN)
// output tiles, loops over K inside the block and keeps the accumulators
// in registers.  Edges are bound-checked, so no operand is padded per
// call.  Two kernels behind one launcher, chosen by the caller (`route`):
//
// Tensor cores, int8 operands: `int8_matmul_tc`.
//   What bounds it: bytes.  The main path's products are tall and skinny
//   (M = n*ho*wo up to 262144, K = 27..2304, N = 16..256): at
//   262144x576x64 the kernel reads 151 MB of x and writes 67 MB of int32
//   (0.065 ms at 3.35 TB/s) for 19.3 G operations (0.0098 ms at 1979
//   TOP/s).  What the design does about it: x is read once (a tile covers
//   all of N, up to 256 columns; wider N takes more column tiles) and the
//   output is written once, in 16-byte-coalesced TMA stores.  The products
//   run as warpgroup MMAs, `wgmma.mma_async ... .s32.s8.s8` (m64nBNk32,
//   BN = 8..256), with int32 accumulators in registers.  For 8-bit types
//   wgmma takes both operands K-major only: x (M, K) row-major is, and the
//   weight is read as an (N, K) matrix with K contiguous and a row pitch
//   that is a multiple of 16 bytes (the lowering stores it so once; the
//   wrapper makes such a copy of any other layout).  A block is 384
//   threads: two consumer warpgroups of 64 rows each (BM = 128) and one
//   producer warpgroup that gives its registers to the consumers
//   (setmaxnreg 40 / 232).  The grid is persistent (one block per SM
//   walks tiles), and a ring of STAGES shared-memory stages, each one
//   128-byte slice of K of the x tile (16 KB) and of the weight tile
//   (BN x 128 B), is handed between producer and consumers by "full" and
//   "empty" mbarriers, so the next tile's loads run under this tile's
//   MMAs and epilogue.  One producer thread issues every copy: x and the
//   weight by TMA, 128-byte swizzled (the layout the wgmma descriptors
//   name), zeros beyond M, N and K filled by the hardware.  TMA needs x's
//   rows on 16-byte boundaries; where they are not (K = 9, 27, 49), a tile
//   of a contiguous x with K <= 128 is still one byte range that starts on
//   16 bytes (m0 * K, m0 a multiple of 128), so the producer fetches it
//   with one bulk copy into a staging buffer and the other three producer
//   warps re-lay it into the swizzled rows (aligned shared-memory words
//   and funnel shifts), while the bulk copies of the next stages are in
//   flight; any other view (an odd offset, rows wider than K) they load
//   from device memory into the same layout, one stage at a time.  What
//   lies past K is not cleared: the weight's tile is zero there, and
//   integer products with zero are zero.  The epilogue converts each
//   64 x (128 B) chunk of the accumulators in registers,
//   stages it in shared memory (double-buffered per warpgroup) and stores
//   it with one TMA store, which drops rows and columns beyond M and N; an
//   output whose rows are not 16-byte multiples (N = 1, 10) is stored from
//   registers with bound checks instead.
//
// CUDA cores, int8 or int32 operands: `int8_matmul_kernel` (K packed four
//   bytes to a word, __dp4a) and `int_matmul_kernel` (32-bit multiply-
//   adds: the tensor cores have no 32-bit integer path).  One 256-thread
//   block per 64 x 64 output tile stages BK-deep slabs of both operands
//   through shared memory; limited by the integer ALU and shared-memory
//   loads, well above the byte bound.  They take any strides of w, so
//   both weight layouts run without a copy.
//
// Arithmetic contract (kept bit for bit by both kernels):
//   * products and sums wrap modulo 2^32 -- done on `unsigned`, signed
//     overflow being undefined (__dp4a wraps in hardware; wgmma without
//     .satfinite wraps, and int8 products cannot reach 2^31 before
//     K = 131072 anyway);
//   * narrow mode (acc_bits <= 15): the 32-bit sum is wrapped to 16 bits
//     once at the store and sign-extended.  Reduction modulo 2^16 is a
//     ring homomorphism of arithmetic modulo 2^32, so this equals
//     accumulating in int16 throughout;
//   * epilogue: float(acc) * scale[n] + bias[n] with separately rounded
//     multiply and add (__fmul_rn, __fadd_rn: no FMA contraction); a null
//     bias adds 0.0f.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

enum OutKind { OUT_I16 = 0, OUT_I32 = 1, OUT_F32 = 2 };

template <int kOut>
struct OutType;
template <>
struct OutType<OUT_I16> {
    typedef int16_t type;
};
template <>
struct OutType<OUT_I32> {
    typedef int32_t type;
};
template <>
struct OutType<OUT_F32> {
    typedef float type;
};

// One accumulator as the output element of column n: wrapped to 16 bits
// in narrow mode, then the raw integer or the dequantised float (0 for a
// column past N, whose scale must not be read).
template <int kOut>
__device__ __forceinline__ typename OutType<kOut>::type out_value(
        unsigned acc, int narrow, const float* __restrict__ scale,
        const float* __restrict__ bias, long long n, long long N) {
    int v = (int)acc;
    if (narrow) v = (int)(int16_t)(uint16_t)(acc & 0xFFFFu);
    if constexpr (kOut == OUT_I16) {
        return (int16_t)v;
    } else if constexpr (kOut == OUT_I32) {
        return v;
    } else {
        if (n >= N) return 0.0f;
        const float b = bias ? __ldg(bias + n) : 0.0f;
        return __fadd_rn(__fmul_rn(__int2float_rn(v), __ldg(scale + n)), b);
    }
}

template <typename T>
__device__ __forceinline__ uint32_t bits32(T v) {
    if constexpr (std::is_same<T, float>::value)
        return __float_as_uint(v);
    else
        return (uint32_t)v;
}

// ---------------------------------------------------------------------------
// CUDA cores
// ---------------------------------------------------------------------------
namespace cc {

constexpr int BM = 64;   // rows of the output tile
constexpr int BN = 64;   // columns of the output tile
constexpr int BK = 32;   // depth of one shared-memory slab
constexpr int TD = 16;   // threads per tile side; each owns a 4x4 micro-tile
constexpr int TM = BM / TD;
constexpr int TN = BN / TD;

template <int kOut>
__device__ __forceinline__ void store_acc(
        unsigned acc, void* __restrict__ out, long long o, long long n,
        long long N, const float* __restrict__ scale,
        const float* __restrict__ bias, int narrow) {
    ((typename OutType<kOut>::type*)out)[o] =
        out_value<kOut>(acc, narrow, scale, bias, n, N);
}

// x (M, K) with row pitch ldx elements; w (K, N) at w[k * wsk + n * wsn]
template <typename TIn, int kOut>
__global__ void __launch_bounds__(TD * TD)
int_matmul_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, void* __restrict__ out,
                  long long M, long long K, long long N, long long ldx,
                  long long wsk, long long wsn, int narrow) {
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
            if (m < M && k < K) v = (int)x[m * ldx + k];
            As[r][c] = (unsigned)v;
        }
        // w slab (BK, BN): consecutive threads read consecutive n
        for (int e = tid; e < BK * BN; e += TD * TD) {
            const int r = e / BN, c = e % BN;
            const long long k = k0 + r, n = n0 + c;
            int v = 0;
            if (k < K && n < N) v = (int)w[k * wsk + n * wsn];
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
            store_acc<kOut>(acc[i][j], out, m * N + n, n, N, scale, bias,
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
                   long long M, long long K, long long N, long long ldx,
                   long long wsk, long long wsn, int narrow) {
    __shared__ unsigned As[BM][KW + 1];
    __shared__ unsigned Bs[KW][BN];

    const int tid = threadIdx.x;
    const int tx = tid % TD;
    const int ty = tid / TD;
    const long long m0 = (long long)blockIdx.x * BM;
    const long long n0 = (long long)blockIdx.y * BN;
    // rows of x start on a word boundary: whole words can be loaded
    const bool x_words = (K % 4 == 0) && (ldx % 4 == 0) &&
                         (((uintptr_t)x & 3) == 0);
    // a K-major weight whose columns start on word boundaries: four k of
    // one column are one word
    const bool w_words = wsk == 1 && (wsn % 4 == 0) &&
                         (((uintptr_t)w & 3) == 0);

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
                const int8_t* p = x + m * ldx + k;
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
                const int8_t* p = w + k * wsk + n * wsn;
                if (w_words && k + 3 < K) {   // k % 4 == 0
                    v = *(const unsigned*)p;
                } else {
                    v = pack4(p[0], k + 1 < K ? p[wsk] : 0,
                              k + 2 < K ? p[2 * wsk] : 0,
                              k + 3 < K ? p[3 * wsk] : 0);
                }
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
            store_acc<kOut>((unsigned)acc[i][j], out, m * N + n, n, N,
                            scale, bias, narrow);
        }
    }
}

template <typename TIn, int kOut>
void launch_kernel(dim3 grid, dim3 block, cudaStream_t stream, const TIn* x,
                   const TIn* w, const float* scale, const float* bias,
                   void* out, long long M, long long K, long long N,
                   long long ldx, long long wsk, long long wsn, int narrow) {
    if constexpr (std::is_same<TIn, int8_t>::value) {
        int8_matmul_kernel<kOut><<<grid, block, 0, stream>>>(
            x, w, scale, bias, out, M, K, N, ldx, wsk, wsn, narrow);
    } else {
        int_matmul_kernel<TIn, kOut><<<grid, block, 0, stream>>>(
            x, w, scale, bias, out, M, K, N, ldx, wsk, wsn, narrow);
    }
}

template <typename TIn>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* bias, void* out, long long M, long long K,
                   long long N, long long ldx, long long wsk, long long wsn,
                   int out_kind, int narrow, cudaStream_t stream) {
    const dim3 grid((unsigned)((M + BM - 1) / BM),
                    (unsigned)((N + BN - 1) / BN));
    const dim3 block(TD * TD);
    const TIn* xp = (const TIn*)x;
    const TIn* wp = (const TIn*)w;
    switch (out_kind) {
    case OUT_I16:
        launch_kernel<TIn, OUT_I16>(grid, block, stream, xp, wp, scale, bias,
                                    out, M, K, N, ldx, wsk, wsn, narrow);
        break;
    case OUT_I32:
        launch_kernel<TIn, OUT_I32>(grid, block, stream, xp, wp, scale, bias,
                                    out, M, K, N, ldx, wsk, wsn, narrow);
        break;
    case OUT_F32:
        launch_kernel<TIn, OUT_F32>(grid, block, stream, xp, wp, scale, bias,
                                    out, M, K, N, ldx, wsk, wsn, narrow);
        break;
    default:
        return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------------
// Tensor cores: int8 wgmma, TMA ring, persistent grid
// ---------------------------------------------------------------------------
namespace tc {

using namespace sira::hopper;

constexpr int BM = 128;            // rows per tile: 2 warpgroups x 64
constexpr int BK = 128;            // bytes of K per stage (one swizzle row)
constexpr int THREADS = 384;       // 2 consumer + 1 producer warpgroup
constexpr int X_BYTES = BM * BK;   // one x stage
constexpr int EPI_BYTES = 64 * 128;   // one epilogue chunk: 64 rows x 128 B
constexpr int SMEM_LIMIT = 232448;    // a block's shared memory on sm_90
constexpr int STAGES_CAP = 8;
// ring depth by default: on an H100 at 262144x576x64 every depth from 4
// to 8 runs within 1% (2: +25%, 3: +8%), and 4 is all that fits at
// BN = 256
constexpr int STAGES_DEFAULT = 4;

// wgmma m64nBNk32, int32 accumulators, both operands from shared memory,
// both K-major; scale_d = 0 overwrites the accumulators
template <int BN>
struct Imma;

template <>
struct Imma<8> {
    static __device__ __forceinline__ void ss(int (&d)[4], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
            "{%0, %1, %2, %3}"
            ", %4, %5, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Imma<16> {
    static __device__ __forceinline__ void ss(int (&d)[8], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}"
            ", %8, %9, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Imma<32> {
    static __device__ __forceinline__ void ss(int (&d)[16], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
            " %12, %13, %14, %15}"
            ", %16, %17, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Imma<64> {
    static __device__ __forceinline__ void ss(int (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
            " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31}"
            ", %32, %33, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Imma<128> {
    static __device__ __forceinline__ void ss(int (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
            " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
            " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
            " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
            " %60, %61, %62, %63}"
            ", %64, %65, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
              "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
              "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
              "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
              "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
              "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
              "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
              "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
              "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

template <>
struct Imma<256> {
    static __device__ __forceinline__ void ss(int (&d)[128], uint64_t a,
                                              uint64_t b, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
            " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
            " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
            " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
            " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
            " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
            " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
            " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
            " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105,"
            " %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
            " %116, %117, %118, %119, %120, %121, %122, %123, %124, %125,"
            " %126, %127}"
            ", %128, %129, p;\n}\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
              "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
              "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
              "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
              "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
              "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
              "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
              "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
              "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
              "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
              "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
              "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
              "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
              "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
              "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
              "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
              "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
              "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
              "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
              "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
              "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
              "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
              "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
              "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
              "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
              "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
              "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
              "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
              "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
              "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
              "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
              "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

// how the producer brings x into a stage: TMA (rows on 16-byte
// boundaries); one bulk copy of the tile's byte range, re-laid in shared
// memory by the loader warps (contiguous rows, K <= 128, any K); or loads
// from device memory by the loader warps (any other view)
enum XMode { X_TMA = 0, X_BULK = 1, X_LOADS = 2 };
constexpr int LOADERS = 96;   // producer warps 1-3

template <int BN>
struct Cfg {
    static constexpr int W_BYTES = BN * BK;             // one weight stage
    // 1024 bytes of slack: the 128-byte swizzle repeats every 1024 bytes,
    // and every tile starts on such a boundary; `raw` bytes a stage of
    // staging for X_BULK; three mbarriers a stage
    static constexpr size_t smem(int stages, int raw) {
        return 1024 + (size_t)stages * (X_BYTES + W_BYTES + raw) +
               4 * EPI_BYTES + 24 * (size_t)stages;
    }
};

// 16 bytes of x from `p` (any alignment, `n` <= 16 of them valid) as four
// words: the aligned words that hold a valid byte, shifted into place
__device__ __forceinline__ void load16(const uint8_t* p, int n,
                                       uint32_t (&v)[4], bool global) {
    const uintptr_t lo = (uintptr_t)p & ~(uintptr_t)3;
    const uintptr_t end = (uintptr_t)p + n;
    const unsigned sh = ((uintptr_t)p & 3) * 8;
    uint32_t wd[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
        const uint32_t* q = reinterpret_cast<const uint32_t*>(lo + 4 * i);
        wd[i] = lo + 4 * i < end ? (global ? __ldg(q) : *q) : 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __funnelshift_r(wd[i], wd[i + 1], sh);
}

__device__ __forceinline__ void st_shared16(uint32_t a,
                                            const uint32_t (&v)[4]) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};"
                 :: "r"(a), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
}

// Shared memory, from a 1024-byte boundary: x stages, weight stages, four
// epilogue buffers (two per consumer warpgroup), the X_BULK staging of
// every stage, then the full, empty and raw-x mbarriers of every stage.
template <int BN, int kOut>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_tc(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w,
               const __grid_constant__ CUtensorMap tm_out,
               const int8_t* __restrict__ x, long long ldx,
               const float* __restrict__ scale,
               const float* __restrict__ bias, void* __restrict__ out,
               int M, int K, int N, int narrow, int x_mode, int raw,
               int out_tma, int stages) {
    using C = Cfg<BN>;
    using T = typename OutType<kOut>::type;
    constexpr int ES = sizeof(T);
    // an epilogue chunk: CW columns, P bytes a row (128, swizzled, when the
    // tile is that wide)
    constexpr int P = BN * ES < 128 ? BN * ES : 128;
    constexpr int CW = P / ES;
    constexpr int NCH = BN / CW;

    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = smem_u32(smem_raw);
    const uint32_t sX = (base + 1023u) & ~1023u;
    const uint32_t sW = sX + stages * X_BYTES;
    const uint32_t sE = sW + stages * C::W_BYTES;
    const uint32_t sR = sE + 4 * EPI_BYTES;
    const uint32_t bars = sR + stages * raw;
    auto full = [&](int s) { return bars + 8u * s; };
    auto empty = [&](int s) { return bars + 8u * (stages + s); };
    auto xraw = [&](int s) { return bars + 8u * (2 * stages + s); };

    const int tid = threadIdx.x;
    const int m_tiles = (M + BM - 1) / BM;
    const int n_tiles = (N + BN - 1) / BN;
    const int tiles = m_tiles * n_tiles;
    const int k_steps = (K + BK - 1) / BK;

    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            // the issuer's arrive.expect_tx, and one arrival per loader
            // thread once its part of x is in place
            mbar_init(full(s), x_mode == X_TMA ? 1 : 1 + LOADERS);
            mbar_init(empty(s), 8);   // lane 0 of each consumer warp
            mbar_init(xraw(s), 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int wg = tid / 128;
    if (wg == 2) {
        // producer warpgroup: thread 0 issues every copy; warps 1-3 put x
        // in place where TMA cannot
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        const int pt = tid - 256;
        if (pt != 0 && (pt < 32 || x_mode == X_TMA)) return;
        if (pt == 0) {
            prefetch_map(&tm_w);
            if (x_mode == X_TMA) prefetch_map(&tm_x);
        }
        const int lt = pt - 32;
        int it = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const int m0 = (tile / n_tiles) * BM;
            const int n0 = (tile % n_tiles) * BN;
            const int rows = min(BM, M - m0);
            for (int ks = 0; ks < k_steps; ++ks, ++it) {
                const int s = it % stages;
                const uint32_t ph = (it / stages) & 1;
                const uint32_t dx = sX + s * X_BYTES;
                const uint32_t rw = sR + s * raw;
                if (pt == 0) {
                    mbar_wait(empty(s), ph ^ 1);      // round 0 passes
                    if (x_mode == X_BULK) {
                        // a tile of a contiguous x is one byte range, and
                        // it starts on 16 bytes (m0 * K, m0 a multiple of
                        // 128); its last tile may end on a ragged tail
                        const uint32_t bytes = (uint32_t)(rows * K) & ~15u;
                        mbar_expect_tx(xraw(s), bytes);
                        if (bytes)
                            bulk_load(rw, x + (long long)m0 * K, bytes,
                                      xraw(s));
                    }
                    mbar_expect_tx(full(s),
                                   C::W_BYTES +
                                       (x_mode == X_TMA ? X_BYTES : 0));
                    tma_load(sW + s * C::W_BYTES, &tm_w, full(s), ks * BK,
                             n0);
                    if (x_mode == X_TMA)
                        tma_load(dx, &tm_x, full(s), ks * BK, m0);
                    continue;
                }
                // loaders: the 16-byte units of this K step that hold
                // data, unit c of row r to unit c ^ (r % 8) of its
                // 128-byte row (TMA's 128-byte swizzle).  Bytes past K and
                // rows past `rows` keep what the stage held: the weight is
                // zero past K and rows past M are never stored.
                const int kb = min(BK, K - ks * BK);
                const int upr = (kb + 15) >> 4;
                if (x_mode == X_BULK) {
                    mbar_wait(xraw(s), ph);
                    uint8_t* r8 = smem_raw + (rw - base);
                    const int tot = rows * K, tail = tot & 15;
                    if (tail) {
                        if (lt < tail)
                            r8[tot - tail + lt] = (uint8_t)__ldg(
                                x + (long long)m0 * K + tot - tail + lt);
                        named_barrier(3, LOADERS);
                    }
                    for (int u = lt; u < rows * upr; u += LOADERS) {
                        const int r = u / upr, c = u - r * upr;
                        uint32_t v[4];
                        load16(r8 + r * K + 16 * c, 16, v, false);
                        st_shared16(dx + r * 128 + ((c ^ (r & 7)) << 4), v);
                    }
                } else {
                    mbar_wait(empty(s), ph ^ 1);
                    for (int u = lt; u < rows * upr; u += LOADERS) {
                        const int r = u / upr, c = u - r * upr;
                        const int k = ks * BK + 16 * c;
                        const int8_t* p = x + (long long)(m0 + r) * ldx + k;
                        uint32_t v[4];
                        if (((uintptr_t)p & 15) == 0 && k + 16 <= K) {
                            const uint4 q =
                                __ldg(reinterpret_cast<const uint4*>(p));
                            v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
                        } else {
                            load16(reinterpret_cast<const uint8_t*>(p),
                                   K - k < 16 ? K - k : 16, v, true);
                        }
                        st_shared16(dx + r * 128 + ((c ^ (r & 7)) << 4), v);
                    }
                }
                fence_proxy_async();
                mbar_arrive(full(s));
            }
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    if (out_tma && tid == 0) prefetch_map(&tm_out);
    // consumers: warpgroup wg owns rows 64 wg + [0, 64) of each tile; this
    // thread holds rows rr0 and rr0 + 8 of them (the m64 accumulator
    // layout), columns 8j + q2 and 8j + q2 + 1
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int rr0 = 16 * warp + lane / 4;
    const int q2 = 2 * (lane % 4);
    int acc[BN / 2];
    int it = 0, ep = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        int prev = 0;
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
            const int s = it % stages;
            const uint32_t ph = (it / stages) & 1;
            mbar_wait(full(s), ph);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 32; ++kk)
                Imma<BN>::ss(
                    acc,
                    desc_sw128(sX + s * X_BYTES + wg * 64 * BK + 32 * kk, 16),
                    desc_sw128(sW + s * C::W_BYTES + 32 * kk, 16),
                    ks > 0 || kk > 0);
            wg_commit();
            if (ks > 0) {
                // the MMAs of the previous stage are done: release it
                wg_wait<1>();
                if (lane == 0) mbar_arrive(empty(prev));
            }
            prev = s;
        }
        wg_wait0();
        reg_fence(acc);
        if (lane == 0) mbar_arrive(empty(prev));

        const long long row0 = (long long)m0 + 64 * wg + rr0;
        if (out_tma) {
#pragma unroll
            for (int c = 0; c < NCH; ++c, ++ep) {
                const uint32_t buf = sE + (2 * wg + (ep & 1)) * EPI_BYTES;
                // the store issued from this buffer two chunks ago has
                // read it
                if (ep >= 2 && t == 0) bulk_wait_read<1>();
                named_barrier(1 + wg, 128);
#pragma unroll
                for (int jj = 0; jj < CW / 8; ++jj) {
                    const int j = c * (CW / 8) + jj;
                    const long long n = (long long)n0 + 8 * j + q2;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int rr = rr0 + 8 * h;
                        const T e0 = out_value<kOut>(
                            (unsigned)acc[4 * j + 2 * h], narrow, scale, bias,
                            n, N);
                        const T e1 = out_value<kOut>(
                            (unsigned)acc[4 * j + 2 * h + 1], narrow, scale,
                            bias, n + 1, N);
                        const int b = (8 * jj + q2) * ES;
                        const uint32_t a =
                            buf + rr * P +
                            (P == 128 ? (((b >> 4) ^ (rr & 7)) << 4) | (b & 15)
                                      : b);
                        if constexpr (ES == 4) {
                            asm volatile(
                                "st.shared.v2.b32 [%2], {%0, %1};"
                                :: "r"(bits32(e0)), "r"(bits32(e1)),
                                   "r"(a) : "memory");
                        } else {
                            const uint32_t pair =
                                (uint32_t)(uint16_t)e0 |
                                ((uint32_t)(uint16_t)e1 << 16);
                            asm volatile("st.shared.b32 [%0], %1;"
                                         :: "r"(a), "r"(pair) : "memory");
                        }
                    }
                }
                fence_proxy_async();
                named_barrier(1 + wg, 128);
                if (t == 0) {
                    tma_store(&tm_out, buf, n0 + c * CW, m0 + 64 * wg);
                    bulk_commit();
                }
            }
        } else {
            T* o = (T*)out;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
                const long long n = (long long)n0 + 8 * j + q2;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const long long row = row0 + 8 * h;
                    if (row >= M) continue;
                    if (n < N)
                        o[row * N + n] = out_value<kOut>(
                            (unsigned)acc[4 * j + 2 * h], narrow, scale, bias,
                            n, N);
                    if (n + 1 < N)
                        o[row * N + n + 1] = out_value<kOut>(
                            (unsigned)acc[4 * j + 2 * h + 1], narrow, scale,
                            bias, n + 1, N);
                }
            }
        }
    }
    // the block's shared memory must outlive the last stores' reads of it;
    // their writes to device memory complete with the grid
    if (out_tma && t == 0) bulk_wait_read<0>();
}

template <int kOut>
struct MapType;
template <>
struct MapType<OUT_I16> {
    static constexpr CUtensorMapDataType value =
        CU_TENSOR_MAP_DATA_TYPE_UINT16;
};
template <>
struct MapType<OUT_I32> {
    static constexpr CUtensorMapDataType value =
        CU_TENSOR_MAP_DATA_TYPE_INT32;
};
template <>
struct MapType<OUT_F32> {
    static constexpr CUtensorMapDataType value =
        CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

inline bool aligned16(const void* p, long long pitch_bytes) {
    return ((uintptr_t)p % 16 == 0) && (pitch_bytes % 16 == 0);
}

template <int BN, int kOut>
cudaError_t launch(const int8_t* x, long long ldx, const int8_t* w,
                   long long ldw, const float* scale, const float* bias,
                   void* out, int M, int K, int N, int narrow, int stages,
                   cudaStream_t stream) {
    using C = Cfg<BN>;
    constexpr int ES = sizeof(typename OutType<kOut>::type);
    constexpr int P = BN * ES < 128 ? BN * ES : 128;
    const int x_mode =
        aligned16(x, ldx) ? X_TMA
        : (ldx == K && K <= BK && (uintptr_t)x % 16 == 0) ? X_BULK
                                                          : X_LOADS;
    // the staging of one stage: 128 rows of K bytes, and 32 bytes for the
    // aligned reads of load16 past the last row
    const int raw = x_mode == X_BULK ? ((BM * K + 15) & ~15) + 32 : 0;
    if (stages == 0) {
        stages = STAGES_DEFAULT;
        while (stages > 2 && C::smem(stages, raw) > SMEM_LIMIT) --stages;
    }
    if (stages < 2 || stages > STAGES_CAP ||
        C::smem(stages, raw) > SMEM_LIMIT)
        return cudaErrorInvalidValue;
    EncodeTiled enc;
    cudaError_t err = encoder(&enc);
    if (err != cudaSuccess) return err;
    const int x_tma = x_mode == X_TMA;
    const int out_tma = aligned16(out, (long long)N * ES);
    CUtensorMap mx, mw, mo;
    memset(&mx, 0, sizeof(mx));
    memset(&mo, 0, sizeof(mo));
    if (!make_map_2d(enc, &mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, ldw,
                     BK, BN, CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    if (x_tma && !make_map_2d(enc, &mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, M,
                              K, ldx, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    if (out_tma &&
        !make_map_2d(enc, &mo, MapType<kOut>::value, out, M, N,
                     (long long)N * ES, P / ES, 64,
                     P == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_NONE))
        return cudaErrorInvalidValue;
    static unsigned configured = 0;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 32 || !((configured >> dev) & 1u)) {
        err = cudaFuncSetAttribute(int8_matmul_tc<BN, kOut>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_LIMIT);
        if (err != cudaSuccess) return err;
        if (dev < 32) configured |= 1u << dev;
    }
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    const long long tiles =
        (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
    const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
    int8_matmul_tc<BN, kOut>
        <<<grid, THREADS, C::smem(stages, raw), stream>>>(
            mx, mw, mo, x, ldx, scale, bias, out, M, K, N, narrow, x_mode,
            raw, out_tma, stages);
    return cudaGetLastError();
}

// the narrowest instantiated tile width that covers N in as few column
// tiles of at most 256 as possible
inline int tile_width(long long N) {
    const long long n_tiles = (N + 255) / 256;
    const long long per = (N + n_tiles - 1) / n_tiles;
    int bn = 8;
    while (bn < per) bn *= 2;
    return bn;
}

template <int kOut>
cudaError_t by_width(const int8_t* x, long long ldx, const int8_t* w,
                     long long ldw, const float* scale, const float* bias,
                     void* out, int M, int K, int N, int narrow, int stages,
                     cudaStream_t s) {
    switch (tile_width(N)) {
    case 8:
        return launch<8, kOut>(x, ldx, w, ldw, scale, bias, out, M, K, N,
                               narrow, stages, s);
    case 16:
        return launch<16, kOut>(x, ldx, w, ldw, scale, bias, out, M, K, N,
                                narrow, stages, s);
    case 32:
        return launch<32, kOut>(x, ldx, w, ldw, scale, bias, out, M, K, N,
                                narrow, stages, s);
    case 64:
        return launch<64, kOut>(x, ldx, w, ldw, scale, bias, out, M, K, N,
                                narrow, stages, s);
    case 128:
        return launch<128, kOut>(x, ldx, w, ldw, scale, bias, out, M, K, N,
                                 narrow, stages, s);
    default:
        return launch<256, kOut>(x, ldx, w, ldw, scale, bias, out, M, K, N,
                                 narrow, stages, s);
    }
}

cudaError_t run(const void* x, long long ldx, const void* w, long long ldw,
                const float* scale, const float* bias, void* out,
                long long M, long long K, long long N, int out_kind,
                int narrow, int stages, cudaStream_t s) {
    // TMA coordinates are 32-bit; the weight must be K-major with 16-byte
    // rows (make_map_2d refuses anything else)
    if (K <= 0 || M >= (1ll << 31) || K >= (1ll << 31) || N >= (1ll << 31) ||
        !aligned16(w, ldw) || ldw < K)
        return cudaErrorInvalidValue;
    const int8_t* xp = (const int8_t*)x;
    const int8_t* wp = (const int8_t*)w;
    switch (out_kind) {
    case OUT_I16:
        return by_width<OUT_I16>(xp, ldx, wp, ldw, scale, bias, out, (int)M,
                                 (int)K, (int)N, narrow, stages, s);
    case OUT_I32:
        return by_width<OUT_I32>(xp, ldx, wp, ldw, scale, bias, out, (int)M,
                                 (int)K, (int)N, narrow, stages, s);
    case OUT_F32:
        return by_width<OUT_F32>(xp, ldx, wp, ldw, scale, bias, out, (int)M,
                                 (int)K, (int)N, narrow, stages, s);
    default:
        return cudaErrorInvalidValue;
    }
}

}  // namespace tc

}  // namespace

// x (M, K) with row pitch ldx elements, unit column stride.
// w (K, N) at w[k * wsk + n * wsn] (elements).
// in_kind: 0 = int8 operands, 1 = int32 operands.
// out_kind: 0 = int16, 1 = int32 (raw accumulator), 2 = float32 (epilogue;
// `scale` must then be non-null, `bias` may be null).
// route: 0 = CUDA cores (any strides of w); 1 = tensor cores (int8 only,
// K >= 1, w K-major: wsk == 1 and a 16-byte-aligned base and row pitch
// wsn; `stages` 2..what fits at the tile width, 0 = STAGES_DEFAULT).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sira_int_matmul(const void* x, const void* w,
                               const float* scale, const float* bias,
                               void* out, long long M, long long K,
                               long long N, long long ldx, long long wsk,
                               long long wsn, int in_kind, int out_kind,
                               int narrow, int route, int stages,
                               void* stream) {
    if (M <= 0 || N <= 0 || K < 0 || ldx < K)
        return (int)cudaErrorInvalidValue;
    if (out_kind == OUT_F32 && scale == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (route == 1) {
        if (in_kind != 0 || wsk != 1) return (int)cudaErrorInvalidValue;
        return (int)tc::run(x, ldx, w, wsn, scale, bias, out, M, K, N,
                            out_kind, narrow, stages, s);
    }
    if (route != 0) return (int)cudaErrorInvalidValue;
    if (in_kind == 0)
        return (int)cc::launch<int8_t>(x, w, scale, bias, out, M, K, N, ldx,
                                       wsk, wsn, out_kind, narrow, s);
    if (in_kind == 1)
        return (int)cc::launch<int32_t>(x, w, scale, bias, out, M, K, N, ldx,
                                        wsk, wsn, out_kind, narrow, s);
    return (int)cudaErrorInvalidValue;
}
