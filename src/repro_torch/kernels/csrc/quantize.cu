// Fused activation quantisation for sm_90a:
//     out[m, c] = clip(round_half_even(x[m, c] / s[c] + z[c]), qmin, qmax)
//
// Replaces the TPU kernel `_quant_kernel` / `quantize` of
// src/repro/kernels/quantize.py.  One elementwise pass over the flattened
// (M, C) array, so no tiling and no padding are carried over.
//
// Bound on this card: bytes (x read once, out written once).  The design
// serves the memory system: each thread takes 4 elements per step, one
// 16-byte load of float32 (two of float64) and one store of 4 packed int8
// (4 bytes) or 4 int32 (16 bytes); one persistent grid fills the SMs once
// and walks the array; indices are 32-bit where M*C < 2^31.  A per-tensor
// scale and zero point (the main path's) are read once per thread; a
// per-channel column advances with the walk, so no element computes a
// `%`.  Where x or out is not aligned for the vector access, a scalar
// kernel runs, chosen by a check before the launch; a last partial
// vector is done element by element.
//
// Arithmetic contract (must be kept bit for bit by any faster version):
// scale and zero point arrive as float32 and are promoted to the type of
// x; the division is a true IEEE division (never a multiply by a
// reciprocal), the add is rounded separately, and rint rounds half to
// even.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using sira::hopper::sm_count;

constexpr int THREADS = 256;
constexpr int V = 4;             // elements per thread and step (vector)

__device__ __forceinline__ float div_add(float x, float s, float z) {
    return __fadd_rn(__fdiv_rn(x, s), z);
}
__device__ __forceinline__ double div_add(double x, double s, double z) {
    return __dadd_rn(__ddiv_rn(x, s), z);
}
__device__ __forceinline__ float round_even(float v) { return rintf(v); }
__device__ __forceinline__ double round_even(double v) { return rint(v); }

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(int8_t* p, const int (&q)[4]) {
    *reinterpret_cast<uint32_t*>(p) =
        (uint32_t)(q[0] & 0xff) | (uint32_t)(q[1] & 0xff) << 8
        | (uint32_t)(q[2] & 0xff) << 16 | (uint32_t)q[3] << 24;
}
__device__ __forceinline__ void store4(int32_t* p, const int (&q)[4]) {
    *reinterpret_cast<int4*>(p) = make_int4(q[0], q[1], q[2], q[3]);
}

template <typename TX>
__device__ __forceinline__ int quant(TX x, TX s, TX z, int qmin, int qmax) {
    TX q = round_even(div_add(x, s, z));
    q = q < (TX)qmin ? (TX)qmin : q;
    q = q > (TX)qmax ? (TX)qmax : q;
    return (int)q;
}

// IDX: uint32_t where total < 2^31, else unsigned long long.  VEC: the
// 4-element vector path (aligned x and out) or one element per step.
template <typename TX, typename TO, typename IDX, bool VEC, bool PER_CHANNEL>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ zero, TO* __restrict__ out,
                IDX total, IDX C, int qmin, int qmax) {
    constexpr int W = VEC ? V : 1;
    const IDX step = (IDX)gridDim.x * THREADS * W;
    IDX i = ((IDX)blockIdx.x * THREADS + threadIdx.x) * W;
    const TX s0 = (TX)scale[0], z0 = (TX)zero[0];
    // the column of element i, advanced by d_col per step
    IDX col = PER_CHANNEL ? i % C : 0;
    const IDX d_col = PER_CHANNEL ? step % C : 0;
    for (; i < total; i += step) {
        const int rem = total - i < (IDX)W ? (int)(total - i) : W;
        TX xv[W];
        if constexpr (VEC) {
            if (rem == W) {
                load4(x + i, xv);
            } else {
#pragma unroll
                for (int j = 0; j < W; ++j) xv[j] = j < rem ? x[i + j] : TX(0);
            }
        } else {
            xv[0] = x[i];
        }
        int q[W];
#pragma unroll
        for (int j = 0; j < W; ++j) {
            TX s = s0, z = z0;
            if constexpr (PER_CHANNEL) {
                IDX c = col + j;
                while (c >= C) c -= C;
                s = (TX)__ldg(scale + c);
                z = (TX)__ldg(zero + c);
            }
            q[j] = quant(xv[j], s, z, qmin, qmax);
        }
        if constexpr (VEC) {
            if (rem == W) {
                store4(out + i, q);
            } else {
#pragma unroll
                for (int j = 0; j < W; ++j)
                    if (j < rem) out[i + j] = (TO)q[j];
            }
        } else {
            out[i] = (TO)q[0];
        }
        if constexpr (PER_CHANNEL) {
            col += d_col;
            if (col >= C) col -= C;
        }
    }
}

template <typename TX, typename TO, typename IDX, bool VEC, bool PC>
cudaError_t launch(const void* x, const float* scale, const float* zero,
                   void* out, long long total, long long C, int qmin,
                   int qmax, cudaStream_t stream) {
    auto kernel = quantize_kernel<TX, TO, IDX, VEC, PC>;
    static int per_sm = 0;          // resident blocks per SM, cached
    if (per_sm == 0) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, THREADS, 0);
        if (err != cudaSuccess) return err;
    }
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
    const long long per_block = (long long)THREADS * (VEC ? V : 1);
    const long long need = (total + per_block - 1) / per_block;
    const long long fill = (long long)per_sm * sms;
    kernel<<<(unsigned)(need < fill ? need : fill), THREADS, 0, stream>>>(
        (const TX*)x, scale, zero, (TO*)out, (IDX)total, (IDX)C, qmin, qmax);
    return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch_out(const void* x, const float* scale, const float* zero,
                       void* out, long long total, long long C,
                       int per_channel, int qmin, int qmax,
                       cudaStream_t stream) {
    const bool vec = (uintptr_t)x % 16 == 0
                     && (uintptr_t)out % (V * sizeof(TO)) == 0;
    const bool narrow = total < (1LL << 31);
#define SIRA_QUANT_LAUNCH(IDX, VEC, PC) \
    return launch<TX, TO, IDX, VEC, PC>(x, scale, zero, out, total, C, \
                                        qmin, qmax, stream)
    if (narrow) {
        if (vec) {
            if (per_channel) SIRA_QUANT_LAUNCH(uint32_t, true, true);
            SIRA_QUANT_LAUNCH(uint32_t, true, false);
        }
        if (per_channel) SIRA_QUANT_LAUNCH(uint32_t, false, true);
        SIRA_QUANT_LAUNCH(uint32_t, false, false);
    }
    if (vec) {
        if (per_channel) SIRA_QUANT_LAUNCH(unsigned long long, true, true);
        SIRA_QUANT_LAUNCH(unsigned long long, true, false);
    }
    if (per_channel) SIRA_QUANT_LAUNCH(unsigned long long, false, true);
    SIRA_QUANT_LAUNCH(unsigned long long, false, false);
#undef SIRA_QUANT_LAUNCH
}

}  // namespace

// x_kind: 0 = float32, 1 = float64.  out_kind: 0 = int8, 1 = int32.
// scale/zero: float32, C entries when per_channel is 1, else one entry.
// x (M, C) contiguous.  Returns the cudaError_t of the launch (0 = success).
extern "C" int sira_quantize(const void* x, const float* scale,
                             const float* zero, void* out, long long M,
                             long long C, int per_channel, int qmin,
                             int qmax, int x_kind, int out_kind,
                             void* stream) {
    if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
    if (x_kind < 0 || x_kind > 1 || out_kind < 0 || out_kind > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const long long total = M * C;
    const int pc = per_channel && C > 1;
    switch (x_kind * 2 + out_kind) {
    case 0:
        return (int)launch_out<float, int8_t>(x, scale, zero, out, total, C,
                                              pc, qmin, qmax, s);
    case 1:
        return (int)launch_out<float, int32_t>(x, scale, zero, out, total, C,
                                               pc, qmin, qmax, s);
    case 2:
        return (int)launch_out<double, int8_t>(x, scale, zero, out, total, C,
                                               pc, qmin, qmax, s);
    default:
        return (int)launch_out<double, int32_t>(x, scale, zero, out, total,
                                                C, pc, qmin, qmax, s);
    }
}
