// Tensor-core building blocks of the 16-bit attention kernels
// (flash_attention.cu's forward, flash_attention_bwd_tc.cu's and
// flash_attention_bwd_tc256.cu's dK/dV and dQ):
// the wgmma m64nNk16 instructions with float32 accumulators (Mma), the
// packing of two float32 values into one 16-bit A-fragment register
// (pack2), the TMA element type of a 16-bit type (TmaType) and the 4-D
// tensor map of a (batch, seq, heads, hd) tensor (make_map).  Plain C
// interface: no PyTorch header.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace sira {
namespace flash {

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
// MN-major (the transpose bit; O += P V).  ss_tb (N = 128): A K-major and
// B MN-major, both from shared memory, accumulating (the hd-256
// backward's dV += P^T dO, dK += dS^T Q, dQ += dS K).
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
    static __device__ __forceinline__ void ss_tb(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            SIRA_R64 ", %64, %65, p, 1, 1, 0, 1;\n}\n"
            : SIRA_D64 : "l"(a), "l"(b), "r"(1));
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
    static __device__ __forceinline__ void ss_tb(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
            SIRA_R64 ", %64, %65, p, 1, 1, 0, 1;\n}\n"
            : SIRA_D64 : "l"(a), "l"(b), "r"(1));
    }
};

#undef SIRA_R32
#undef SIRA_R64
#undef SIRA_D8
#undef SIRA_D32
#undef SIRA_D64

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
inline bool make_map(hopper::EncodeTiled enc, CUtensorMap* map,
                     CUtensorMapDataType ty, const void* ptr, int batch,
                     int seq, int heads, int hd, int rows) {
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

}  // namespace flash
}  // namespace sira
