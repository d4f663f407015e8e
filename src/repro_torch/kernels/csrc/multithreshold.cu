// Fused MultiThreshold layer tail for sm_90a:
//     out[m, c] = out_bias + #{ i : x[m, c] >= T[i, c] }
//
// Replaces the TPU kernel `_mt_kernel` / `multithreshold` of
// src/repro/kernels/multithreshold.py.  Same function, other shape: the
// TPU kernel keeps the whole (N, bc) threshold slab resident and runs N
// broadcast compares over a (bm, bc) tile; here a block of (BC, BY)
// threads covers BC columns and BY*ROWS rows, each thread holds its ROWS
// inputs and counts in registers, and the block's threshold columns pass
// through shared memory in chunks of NCHUNK rows, so any N fits in static
// shared memory for every compare type.  C is the fastest index, so the
// loads of x, of T and the stores of out coalesce.
//
// Bound on this card: bytes for small N (x read once, out written once,
// T is small and stays in L2); for N = 255 the M*C*N compares dominate.
// The compare is a linear count; `>=` is kept, so ties count.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BC = 32;       // columns per block (one warp wide)
constexpr int BY = 8;        // thread rows per block
constexpr int ROWS = 8;      // rows per thread
constexpr int NCHUNK = 64;   // threshold rows staged per pass

template <typename TX, typename TO>
__global__ void __launch_bounds__(BC * BY)
multithreshold_kernel(const TX* __restrict__ x, const TX* __restrict__ thr,
                      TO* __restrict__ out, long long M, long long C,
                      int N, int out_bias) {
    __shared__ TX sT[NCHUNK][BC];

    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const long long c = (long long)blockIdx.y * BC + tx;
    const long long m0 = (long long)blockIdx.x * (BY * ROWS) + ty;
    const bool col_ok = c < C;

    TX xv[ROWS];
    int cnt[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const long long m = m0 + (long long)r * BY;
        cnt[r] = 0;
        xv[r] = (col_ok && m < M) ? x[m * C + c] : TX(0);
    }

    for (int n0 = 0; n0 < N; n0 += NCHUNK) {
        const int nc = min(NCHUNK, N - n0);
        for (int i = ty; i < nc; i += BY)
            sT[i][tx] = col_ok ? thr[(long long)(n0 + i) * C + c] : TX(0);
        __syncthreads();
        for (int i = 0; i < nc; ++i) {
            const TX t = sT[i][tx];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) cnt[r] += (xv[r] >= t) ? 1 : 0;
        }
        __syncthreads();
    }

    if (!col_ok) return;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const long long m = m0 + (long long)r * BY;
        if (m < M) out[m * C + c] = (TO)(out_bias + cnt[r]);
    }
}

template <typename TX, typename TO>
cudaError_t launch(const void* x, const void* thr, void* out, long long M,
                   long long C, int N, int out_bias, cudaStream_t stream) {
    const dim3 block(BC, BY);
    const dim3 grid((unsigned)((M + BY * ROWS - 1) / (BY * ROWS)),
                    (unsigned)((C + BC - 1) / BC));
    multithreshold_kernel<TX, TO><<<grid, block, 0, stream>>>(
        (const TX*)x, (const TX*)thr, (TO*)out, M, C, N, out_bias);
    return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_out(const void* x, const void* thr, void* out,
                       long long M, long long C, int N, int out_bias,
                       int out_kind, cudaStream_t stream) {
    switch (out_kind) {
    case 0: return launch<TX, int8_t>(x, thr, out, M, C, N, out_bias, stream);
    case 1: return launch<TX, int16_t>(x, thr, out, M, C, N, out_bias, stream);
    case 2: return launch<TX, int32_t>(x, thr, out, M, C, N, out_bias, stream);
    default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// x_kind: 0 = int32, 1 = float32, 2 = float64 (x and thresholds share it).
// out_kind: 0 = int8, 1 = int16, 2 = int32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sira_multithreshold(const void* x, const void* thr, void* out,
                                   long long M, long long C, int N,
                                   int out_bias, int x_kind, int out_kind,
                                   void* stream) {
    if (M <= 0 || C <= 0 || N < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (x_kind) {
    case 0:
        return (int)launch_out<int32_t>(x, thr, out, M, C, N, out_bias,
                                        out_kind, s);
    case 1:
        return (int)launch_out<float>(x, thr, out, M, C, N, out_bias,
                                      out_kind, s);
    case 2:
        return (int)launch_out<double>(x, thr, out, M, C, N, out_bias,
                                       out_kind, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
