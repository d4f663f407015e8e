// What the two routes of the attention backward share
// (flash_attention_bwd.cu, the CUDA cores; flash_attention_bwd_tc.cu, the
// tensor cores): the dead-row threshold of lse, the key and query tiles a
// tile of the other side visits, the mask's parameters, the arguments of
// a call, its shape check, and the opt-in to more than 48 KB of shared
// memory.  Plain C interface: no PyTorch header.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sira {
namespace bwd {

// an lse below this marks a row that sees no key (its lse is -1e30 or,
// from the 16-bit forward, -6.9e29)
constexpr float DEAD_LSE = -1e29f;

struct TileRange {
    int lo, hi;
};

// key tiles [lo, hi) with a visible pair for query rows [q0, q0 + bq):
// the forward's rule (tiles wholly past the diagonal or before the window
// are skipped only when causal and 0 <= q_pos < Sk for every row)
__device__ __forceinline__ TileRange key_tiles(int q0, int bq, int bk,
                                               int Sq, int Sk,
                                               long long q_offset,
                                               long long window,
                                               int causal) {
    TileRange r{0, (Sk + bk - 1) / bk};
    const long long q_lo = q_offset + q0;
    const long long q_hi = q_lo + min(bq, Sq - q0) - 1;
    if (causal && q_lo >= 0 && q_hi < Sk) {
        r.hi = (int)(q_hi / bk) + 1;
        const long long first = q_lo - window + 1;
        if (window > 0 && first > 0) r.lo = (int)(first / bk);
    }
    return r;
}

// query tiles [lo, hi) with a visible pair for keys [k0, k0 + bk).  A
// skipped tile adds nothing only if none of its rows sees no key at all
// (such a row adds 1 / Sk of its dO to every dV), so tiles are skipped
// only when causal with 0 <= q_pos < Sk for every query
__device__ __forceinline__ TileRange query_tiles(int k0, int bk, int bq,
                                                 int Sq, int Sk,
                                                 long long q_offset,
                                                 long long window,
                                                 int causal) {
    const int n = (Sq + bq - 1) / bq;
    TileRange r{0, n};
    if (causal && q_offset >= 0 && q_offset + Sq <= Sk) {
        // query i sees key j when q_offset + i >= j and, with a window,
        // q_offset + i - j < window
        const long long first = k0 - q_offset;
        if (first > 0) r.lo = (int)min((long long)n, first / bq);
        if (window > 0) {
            const long long last = (long long)k0 + bk - 2 + window - q_offset;
            if (last < 0)
                r.hi = r.lo;
            else if (last < Sq - 1)
                r.hi = (int)(last / bq) + 1;
        }
        if (r.hi < r.lo) r.hi = r.lo;
    }
    return r;
}

struct Mask {
    int Sq, Sk, causal;
    long long q_offset, window;
    float cap, inv_sk;
};

// above 48 KB dynamic shared memory must be asked for, once per device
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, unsigned& configured) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 32 && ((configured >> dev) & 1u)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess && dev < 32) configured |= 1u << dev;
    return err;
}

struct Args {
    const void *q, *k, *v, *dout;
    const float *lse, *delta;
    int B, Sq, Sk, H, KV, hd;
    long long q_offset, window;
    int causal;
    float cap, scale;
};

inline bool bad_shape(int B, int Sq, int Sk, int H, int KV, int hd,
               long long window) {
    return B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 ||
           H % KV != 0 || hd <= 0 || hd > 256 || window < 0 ||
           (long long)B * H > 65535;
}

}  // namespace bwd
}  // namespace sira
