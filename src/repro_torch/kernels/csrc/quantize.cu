// Fused activation quantisation for sm_90a:
//     out[m, c] = clip(round_half_even(x[m, c] / s[c] + z[c]), qmin, qmax)
//
// Replaces the TPU kernel `_quant_kernel` / `quantize` of
// src/repro/kernels/quantize.py.  One elementwise pass, one thread per
// element over the flattened (M, C) array (grid-stride), so no tiling and
// no padding are carried over.
//
// Bound on this card: bytes (x read once, out written once).
//
// Arithmetic contract (must be kept bit for bit by any faster version):
// scale and zero point arrive as float32 and are promoted to the type of
// x; the division is a true IEEE division (never a multiply by a
// reciprocal), the add is rounded separately, and rint rounds half to
// even.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float div_add(float x, float s, float z) {
    return __fadd_rn(__fdiv_rn(x, s), z);
}
__device__ __forceinline__ double div_add(double x, double s, double z) {
    return __dadd_rn(__ddiv_rn(x, s), z);
}
__device__ __forceinline__ float round_even(float v) { return rintf(v); }
__device__ __forceinline__ double round_even(double v) { return rint(v); }

template <typename TX, typename TO>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ zero, TO* __restrict__ out,
                long long total, long long C, int per_channel, int qmin,
                int qmax) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long c = per_channel ? (i % C) : 0;
        const TX s = (TX)scale[c];
        const TX z = (TX)zero[c];
        TX q = round_even(div_add(x[i], s, z));
        q = q < (TX)qmin ? (TX)qmin : q;
        q = q > (TX)qmax ? (TX)qmax : q;
        out[i] = (TO)(int)q;
    }
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const float* scale, const float* zero,
                   void* out, long long total, long long C, int per_channel,
                   int qmin, int qmax, cudaStream_t stream) {
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 132LL * 32) blocks = 132LL * 32;   // grid-stride beyond
    quantize_kernel<TX, TO><<<(unsigned)blocks, THREADS, 0, stream>>>(
        (const TX*)x, scale, zero, (TO*)out, total, C, per_channel, qmin,
        qmax);
    return cudaGetLastError();
}

}  // namespace

// x_kind: 0 = float32, 1 = float64.  out_kind: 0 = int8, 1 = int32.
// scale/zero: float32, C entries when per_channel is 1, else one entry.
// Returns the cudaError_t of the launch (0 = success).
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
    const int key = x_kind * 2 + out_kind;
    switch (key) {
    case 0:
        return (int)launch<float, int8_t>(x, scale, zero, out, total, C,
                                          per_channel, qmin, qmax, s);
    case 1:
        return (int)launch<float, int32_t>(x, scale, zero, out, total, C,
                                           per_channel, qmin, qmax, s);
    case 2:
        return (int)launch<double, int8_t>(x, scale, zero, out, total, C,
                                           per_channel, qmin, qmax, s);
    case 3:
        return (int)launch<double, int32_t>(x, scale, zero, out, total, C,
                                            per_channel, qmin, qmax, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
