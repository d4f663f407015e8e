// Hopper (sm_90a) building blocks shared by the kernels of this directory
// (flash_attention.cu, flash_attention_bwd.cu, int_matmul.cu,
// multithreshold.cu): shared-memory addresses, mbarriers, TMA copies
// between device and shared memory, the wgmma shared-memory descriptor of
// a 128-byte-swizzled operand, wgmma fences, and libcuda's tensor-map
// encoder reached through the runtime (no -lcuda).  Plain C interface: no
// PyTorch header.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sira {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
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

// ---- TMA -------------------------------------------------------------------

// one box of a 2-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1) : "memory");
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

// brings a tensor map (a __grid_constant__ parameter) into the cache
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];"
                 :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// `bytes` (a multiple of 16) from a 16-byte-aligned global address into
// shared memory, one bulk copy; completes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
           "r"(bar) : "memory");
}

// one box from shared memory into a 2-D tensor map (elements outside the
// tensor are not written); joins this thread's open bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
        "[%0, {%2, %3}], [%1];"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0),
           "r"(c1) : "memory");
}

// `bytes` (a multiple of 16) from shared memory to a 16-byte-aligned
// global address, one bulk copy; joins this thread's open bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
        :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// makes this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma operand reads, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

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
// until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// keeps the compiler from touching accumulator registers across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// ---- host: tensor maps -----------------------------------------------------

// cuTensorMapEncodeTiled of libcuda, reached through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline cudaError_t encoder(EncodeTiled* fn) {
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

// a row-major (rows, cols) matrix with a row pitch of `pitch` bytes as a
// 2-D map (cols innermost), boxes of box_cols x box_rows; elements outside
// the matrix read as zeros and are not written.  TMA needs the base and
// the pitch on 16-byte boundaries and box_cols * elem a multiple of 16.
inline bool make_map_2d(EncodeTiled enc, CUtensorMap* map,
                        CUtensorMapDataType ty, const void* ptr,
                        long long rows, long long cols, long long pitch,
                        int box_cols, int box_rows, CUtensorMapSwizzle sw) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)pitch};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return enc(map, ty, 2, const_cast<void*>(ptr), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the device's SM count (cached for the first 32 devices)
inline cudaError_t sm_count(int* n) {
    static int cached[32] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 32 && cached[dev]) {
        *n = cached[dev];
        return cudaSuccess;
    }
    err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && dev < 32) cached[dev] = *n;
    return err;
}

}  // namespace hopper
}  // namespace sira
