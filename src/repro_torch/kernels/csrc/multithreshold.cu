// Fused MultiThreshold layer tail for sm_90a:
//     out[m, c] = out_bias + #{ i : x[m, c] >= T[i, c] }
//
// Replaces the TPU kernel `_mt_kernel` / `multithreshold` of
// src/repro/kernels/multithreshold.py.  The TPU kernel keeps the (N, bc)
// threshold slab resident and runs N broadcast compares over a (bm, bc)
// tile.  Here two routes compute the same function; the wrapper picks one
// from the shape and type (`multithreshold.route_for`):
//
// compare-count (N < 16).  Bound by bytes: x is read once and out written
// once, and the compares are few.  The columns are cut into tiles of 32,
// or one flat tile where C divides a block's 1024 (512 float64) elements;
// a tile is read as the flat sequence of its elements, so a C of 4, 8 or
// 16 fills every lane, and each thread loads 16 bytes of x (4 int32 or
// float32, 2 float64) and stores its 4 (2) outputs at once.  A persistent
// grid, evened so that every block walks as many steps, keeps a thread on
// the same columns, so N <= 15 thresholds sit in registers (padded to 3,
// 7 or 15 with the type's largest value, the count clamped to N), loaded
// 16 bytes at a time after the thread's first load of x is in flight.
// What bounds the large tails is bytes in flight: a flat tile of at least
// a 16 KB chunk per SM goes to `multithreshold_stream`, where one thread
// keeps four chunks of x in flight by bulk copies into a shared-memory
// ring and stores each chunk's counts by one bulk copy, so the bytes in
// flight cost no registers.  N > 15 and other widths (17, a ragged last
// tile) read their thresholds through L1.
//
// search (N >= 16).  A linear count does N compares per element: at
// N = 255 integer issue bounds it, not bytes.  Each element counts
// #{T <= x} by a branch-free binary search of ceil(log2(N + 1)) steps in
// its column.  A block of 1024 threads loads its tile's (2^k - 1, 32)
// threshold slab into shared memory once (padded with the largest value;
// the count is clamped to N, so an x equal to INT32_MAX or +inf does not
// count the padding) and reuses it for every step of the persistent walk:
// few blocks, few slab loads.  The slab's row pitch is 32 columns, a
// width that divides 32 is repeated across them, and the four (two)
// elements of a thread are searched in an order rotated by lane group, so
// the 32 lanes of a step read 32 different columns: one bank each.  Slabs
// past 48 KB (float64 at N = 255) are dynamic shared memory.
//
// Both routes keep `>=` exactly: ties count, equal thresholds count once
// each, a NaN x counts nothing.  16-byte accesses are taken only where the
// pointers and the row length are aligned, by a check before the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace sira::hopper;

constexpr int THREADS = 256;              // per block, compare-count
constexpr int SEARCH_THREADS = 1024;      // per block, search: few slabs
constexpr int SLAB_LOADS = 8;             // slab loads in flight a thread
constexpr int MAX_STEPS = 10;             // 1023 rows of 32 int32 < 227 KB
constexpr int TILE = 32;                   // columns per tile, slab pitch
constexpr int MAX_SMEM = 227 * 1024;       // per block on an H100
constexpr int REG_MAX = 15;                // most thresholds in registers
constexpr int CHUNK_VECS = 4;              // stream: vectors per thread
constexpr int STAGES = 4;                  // stream: chunks of x in flight

enum Mode { REG = 0, LOOP = 1, SEARCH = 2 };

__device__ __forceinline__ int32_t top_of(int32_t) { return INT32_MAX; }
__device__ __forceinline__ float top_of(float) {
    return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double top_of(double) {
    return __longlong_as_double(0x7ff0000000000000LL);
}

// V consecutive elements; 16 bytes when V > 1 (the caller checked the
// alignment)
__device__ __forceinline__ void load_vec(const int32_t* p, int32_t (&v)[4]) {
    const int4 r = *reinterpret_cast<const int4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load_vec(const double* p, double (&v)[2]) {
    const double2 r = *reinterpret_cast<const double2*>(p);
    v[0] = r.x; v[1] = r.y;
}
template <typename TX>
__device__ __forceinline__ void load_vec(const TX* p, TX (&v)[1]) {
    v[0] = p[0];
}

// out_kind: 0 = int8, 1 = int16, 2 = int32 (two's complement wrap)
__device__ __forceinline__ void store_one(void* out, int kind, long long i,
                                          int v) {
    if (kind == 0) static_cast<int8_t*>(out)[i] = (int8_t)v;
    else if (kind == 1) static_cast<int16_t*>(out)[i] = (int16_t)v;
    else static_cast<int32_t*>(out)[i] = v;
}

template <int V>
__device__ __forceinline__ void store_vec(void* out, int kind, long long i,
                                          const int (&v)[V]) {
    if constexpr (V == 1) {
        store_one(out, kind, i, v[0]);
    } else if (kind == 0) {
        uint32_t p = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) p |= (uint32_t)(v[j] & 0xff) << (8 * j);
        if constexpr (V == 4) reinterpret_cast<uint32_t*>(
            static_cast<int8_t*>(out) + i)[0] = p;
        else reinterpret_cast<uint16_t*>(
            static_cast<int8_t*>(out) + i)[0] = (uint16_t)p;
    } else if (kind == 1) {
        uint32_t lo = (uint32_t)(v[0] & 0xffff) | ((uint32_t)v[1] << 16);
        if constexpr (V == 4) {
            const uint32_t hi = (uint32_t)(v[2] & 0xffff)
                                | ((uint32_t)v[3] << 16);
            reinterpret_cast<uint2*>(static_cast<int16_t*>(out) + i)[0] =
                make_uint2(lo, hi);
        } else {
            reinterpret_cast<uint32_t*>(static_cast<int16_t*>(out) + i)[0] =
                lo;
        }
    } else {
        if constexpr (V == 4) reinterpret_cast<int4*>(
            static_cast<int32_t*>(out) + i)[0] =
            make_int4(v[0], v[1], v[2], v[3]);
        else reinterpret_cast<int2*>(static_cast<int32_t*>(out) + i)[0] =
            make_int2(v[0], v[1]);
    }
}

// The NR thresholds of columns c0 .. c0 + V - 1 (wrapping at the tile
// width wt) of a tile starting at column col0, padded with `top` past N:
// one 16-byte load per threshold row where the V columns are adjacent
// and aligned, else one load per element.
template <int V, int NR, typename TX>
__device__ __forceinline__ void load_thresholds(
        TX (&treg)[NR][V], const TX* __restrict__ thr, long long C,
        long long col0, int c0, int wt, int N, TX top) {
    const TX* base = thr + col0 + c0;
    if (V > 1 && wt % V == 0 && (reinterpret_cast<uintptr_t>(base) % 16 == 0)
        && C % V == 0) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            if (i < N) {
                load_vec(base + (long long)i * C, treg[i]);
            } else {
#pragma unroll
                for (int j = 0; j < V; ++j) treg[i][j] = top;
            }
        }
        return;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
        int c = c0 + j;
        while (c >= wt) c -= wt;
#pragma unroll
        for (int i = 0; i < NR; ++i)
            treg[i][j] = i < N ? thr[(long long)i * C + col0 + c] : top;
    }
}

// a[s] <- a[(s + q) % V] for V a power of two: a barrel of selects, no
// local memory
template <typename T, int V>
__device__ __forceinline__ void rotate(T (&a)[V], int q) {
#pragma unroll
    for (int b = 1; b < V; b <<= 1) {
        const bool on = (q & b) != 0;
        T r[V];
#pragma unroll
        for (int s = 0; s < V; ++s) r[s] = on ? a[(s + b) % V] : a[s];
#pragma unroll
        for (int s = 0; s < V; ++s) a[s] = r[s];
    }
}

// Grid: (persistent blocks, column tiles).  Each thread takes one vector
// of V elements per step of its walk.  NR: thresholds held in registers
// (REG).  steps: k of the 2^k - 1 slab rows (SEARCH).
template <typename TX, int V, int MODE, int NR>
__global__ void __launch_bounds__(MODE == SEARCH ? SEARCH_THREADS : THREADS)
multithreshold_kernel(const TX* __restrict__ x, const TX* __restrict__ thr,
                      void* __restrict__ out, long long M, long long C,
                      int N, int out_bias, int out_kind, int steps, int tw) {
    constexpr int NT = MODE == SEARCH ? SEARCH_THREADS : THREADS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    TX* slab = reinterpret_cast<TX*>(smem_raw);
    const TX top = top_of(TX(0));

    const long long col0 = (long long)blockIdx.y * tw;
    const int wt = (int)(C - col0 < tw ? C - col0 : tw);      // tile width
    const bool replicate = TILE % wt == 0;
    const long long tile_elems = M * wt;
    const int tid = threadIdx.x;

    // Element e of the tile is (row, sc) = (e / wt, e % wt), advanced by
    // the grid's step without division.  (A 64-bit division costs a thread
    // some hundred instructions before its first load; the usual tile
    // width is a power of two: shifts.)
    const bool pow2 = (wt & (wt - 1)) == 0;
    const int shift = __ffs(wt) - 1;
    auto split = [&](long long v, long long& r, int& c) {
        r = pow2 ? v >> shift : v / wt;
        c = (int)(v - r * wt);
    };
    long long e = ((long long)blockIdx.x * NT + tid) * V;
    const long long step = (long long)gridDim.x * NT * V;
    long long row, d_row;
    int sc, d_sc;
    split(e, row, sc);
    split(step, d_row, d_sc);
    // lanes whose columns repeat in a warp search in another order
    const int q = (MODE == SEARCH && V > 1 && replicate)
                  ? ((tid & 31) * V / TILE) % V : 0;

    // one vector of the walk, its address and length; the next one's load
    // is issued before this one counts and stores
    struct Step {
        long long base, e;
        int sc, rem;
        TX x[V];
    };
    auto fetch = [&](Step& st) {
        st.e = e;
        st.base = row * C + col0 + sc;
        st.sc = sc;
        const long long left = tile_elems - e;
        st.rem = left <= 0 ? 0 : left < V ? (int)left : V;
        if (st.rem == V) {
            load_vec(x + st.base, st.x);
        } else {                          // last, partial vector (flat tile)
#pragma unroll
            for (int j = 0; j < V; ++j)
                st.x[j] = j < st.rem ? x[st.base + j] : TX(0);
        }
        e += step;
        row += d_row;
        sc += d_sc;
        if (sc >= wt) { sc -= wt; ++row; }
    };
    Step cur, next;
    fetch(cur);      // the first load flies while the thresholds load

    TX treg[NR][V];
    if constexpr (MODE == REG) {
        // the host takes REG only where wt divides NT * V: the step is a
        // multiple of wt, so these columns stay the thread's for the walk
        load_thresholds<V, NR>(treg, thr, C, col0, cur.sc, wt, N, top);
    }
    if constexpr (MODE == SEARCH) {
        // the tile's slab, SLAB_LOADS loads in flight per thread
        const int n_slab = ((1 << steps) - 1) * TILE;
        for (int i0 = 0; i0 < n_slab; i0 += NT * SLAB_LOADS) {
            TX v[SLAB_LOADS];
#pragma unroll
            for (int u = 0; u < SLAB_LOADS; ++u) {
                const int i = i0 + u * NT + tid;
                const int k = i / TILE, s = i % TILE;
                const int c = replicate ? s % wt : s;
                v[u] = (i < n_slab && k < N && c < wt)
                       ? thr[(long long)k * C + col0 + c] : top;
            }
#pragma unroll
            for (int u = 0; u < SLAB_LOADS; ++u) {
                const int i = i0 + u * NT + tid;
                if (i < n_slab) slab[i] = v[u];
            }
        }
        __syncthreads();
    }

    while (cur.rem > 0) {
        fetch(next);
        int cnt[V];
        if constexpr (MODE == REG) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
                int c = 0;
#pragma unroll
                for (int i = 0; i < NR; ++i)
                    c += cur.x[j] >= treg[i][j] ? 1 : 0;
                cnt[j] = c < N ? c : N;
            }
        } else if constexpr (MODE == LOOP) {
            const TX* tcol[V];
#pragma unroll
            for (int j = 0; j < V; ++j) {
                int c = cur.sc + j;
                while (c >= wt) c -= wt;
                tcol[j] = thr + col0 + c;
                cnt[j] = 0;
            }
            for (int i = 0; i < N; ++i) {
                const long long off = (long long)i * C;
#pragma unroll
                for (int j = 0; j < V; ++j)
                    cnt[j] += cur.x[j] >= __ldg(tcol[j] + off) ? 1 : 0;
            }
        } else {
            // slot s holds element (s + q) % V; idx is the slab offset
            // pos * TILE + column, so pos = idx / TILE at the end
            int idx[V];
            rotate(cur.x, q);
#pragma unroll
            for (int s = 0; s < V; ++s) {
                const int j = (s + q) & (V - 1);
                int c = cur.sc + j;
                while (c >= wt) c -= wt;
                idx[s] = replicate ? (int)(cur.e % TILE) + j : c;
            }
#pragma unroll
            for (int b = MAX_STEPS - 1; b >= 0; --b) {
                if (b < steps) {
#pragma unroll
                    for (int s = 0; s < V; ++s) {
                        const TX t = slab[idx[s] + ((1 << b) - 1) * TILE];
                        idx[s] += cur.x[s] >= t ? TILE << b : 0;
                    }
                }
            }
#pragma unroll
            for (int s = 0; s < V; ++s) {
                const int pos = idx[s] / TILE;
                cnt[s] = pos < N ? pos : N;
            }
            rotate(cnt, (V - q) & (V - 1));
        }
#pragma unroll
        for (int j = 0; j < V; ++j) cnt[j] += out_bias;
        if (cur.rem == V) {
            store_vec<V>(out, out_kind, cur.base, cnt);
        } else {
#pragma unroll
            for (int j = 0; j < V; ++j)
                if (j < cur.rem)
                    store_one(out, out_kind, cur.base + j, cnt[j]);
        }
        cur = next;
    }
}

// The compare-count of a large flat tile (C divides THREADS * V) with its
// N <= 15 thresholds in registers, x and out moved by bulk copies: one
// thread keeps STAGES chunks of x in flight into a shared-memory ring
// (an mbarrier per stage) and stores each chunk's counts from a double
// staging buffer, so the bytes in flight cost no registers.  A chunk is
// CHUNK_VECS vectors per thread; the last, partial chunk (M * C not a
// multiple of a chunk) is counted with ordinary loads by one block.
template <typename TX, int V, int NR>
__global__ void __launch_bounds__(THREADS)
multithreshold_stream(const TX* __restrict__ x, const TX* __restrict__ thr,
                      void* __restrict__ out, long long total, int C, int N,
                      int out_bias, int out_kind) {
    constexpr int CH = CHUNK_VECS * THREADS * V;     // elements per chunk
    constexpr int X_BYTES = CH * (int)sizeof(TX);
    extern __shared__ __align__(128) unsigned char smem_raw[];
    TX* ring = reinterpret_cast<TX*>(smem_raw);
    unsigned char* staging = smem_raw + STAGES * X_BYTES;   // 2 x CH x 4 B
    uint64_t* bars = reinterpret_cast<uint64_t*>(staging + 2 * CH * 4);
    const TX top = top_of(TX(0));
    const int tid = threadIdx.x;
    const int out_size = 1 << out_kind;              // 1, 2, 4 bytes
    const long long chunks = total / CH;             // full chunks
    const long long grid = gridDim.x;
    const long long mine = chunks > blockIdx.x
        ? (chunks - blockIdx.x + grid - 1) / grid : 0;

    // this thread's columns: the same in every chunk (C divides CH)
    auto load = [&](long long i) {        // chunk i of this block, by tid 0
        const int s = (int)(i % STAGES);
        const long long chunk = blockIdx.x + i * grid;
        mbar_expect_tx(smem_u32(&bars[s]), X_BYTES);
        bulk_load(smem_u32(ring + (long long)s * CH), x + chunk * CH,
                  X_BYTES, smem_u32(&bars[s]));
    };
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&bars[s]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int i = 0; i < STAGES && i < mine; ++i) load(i);
    }
    TX treg[NR][V];
    load_thresholds<V, NR>(treg, thr, C, 0, (tid * V) % C, C, N, top);
    __syncthreads();                      // the barriers are initialised

    for (long long i = 0; i < mine; ++i) {
        const int s = (int)(i % STAGES);
        mbar_wait(smem_u32(&bars[s]), (uint32_t)((i / STAGES) & 1));
        TX xv[CHUNK_VECS][V];
#pragma unroll
        for (int k = 0; k < CHUNK_VECS; ++k)
            load_vec(ring + (long long)s * CH + (k * THREADS + tid) * V,
                     xv[k]);
        // the staging half this chunk writes was stored two chunks ago
        if (tid == 0 && i >= 2) bulk_wait_read<1>();
        __syncthreads();                  // stage s read, staging free
        if (tid == 0 && i + STAGES < mine) load(i + STAGES);
        void* stage = staging + (i & 1) * CH * 4;
#pragma unroll
        for (int k = 0; k < CHUNK_VECS; ++k) {
            int cnt[V];
#pragma unroll
            for (int j = 0; j < V; ++j) {
                int c = 0;
#pragma unroll
                for (int n = 0; n < NR; ++n)
                    c += xv[k][j] >= treg[n][j] ? 1 : 0;
                cnt[j] = (c < N ? c : N) + out_bias;
            }
            store_vec<V>(stage, out_kind, (k * THREADS + tid) * V, cnt);
        }
        fence_proxy_async();
        __syncthreads();                  // the chunk's counts are staged
        if (tid == 0) {
            const long long chunk = blockIdx.x + i * grid;
            bulk_store(static_cast<unsigned char*>(out)
                       + chunk * CH * out_size, smem_u32(stage),
                       CH * out_size);
            bulk_commit();
        }
    }
    if (tid == 0) bulk_wait_read<0>();

    if (blockIdx.x == chunks % grid) {    // the partial last chunk
        for (long long e = chunks * CH + tid; e < total; e += THREADS) {
            const TX xe = x[e];
            const int c = (int)((e - chunks * CH) % C);
            int cnt = 0;
            for (int n = 0; n < N; ++n)
                cnt += xe >= thr[(long long)n * C + c] ? 1 : 0;
            store_one(out, out_kind, e, cnt + out_bias);
        }
    }
}

struct Args {
    const void* x; const void* thr; void* out;
    long long M, C;
    int N, out_bias, out_kind;
    int steps;      // search: k of the 2^k - 1 slab rows
    int tw;         // columns per tile
};

template <typename TX, int V, int MODE, int NR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    auto kernel = multithreshold_kernel<TX, V, MODE, NR>;
    constexpr int NT = MODE == SEARCH ? SEARCH_THREADS : THREADS;
    const int smem = MODE == SEARCH
        ? ((1 << a.steps) - 1) * TILE * (int)sizeof(TX) : 0;
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
    static int smem_allowed = 48 * 1024;
    if (smem > smem_allowed) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (err != cudaSuccess) return err;
        smem_allowed = MAX_SMEM;
    }
    // resident blocks per SM, cached per instantiation and slab size
    static int per_sm = 0, per_sm_smem = -1;
    if (smem != per_sm_smem) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, NT, smem);
        if (err != cudaSuccess) return err;
        per_sm_smem = smem;
    }
    int sms = 0;
    const cudaError_t err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
    const long long tiles = (a.C + a.tw - 1) / a.tw;
    const long long wt = a.C < a.tw ? a.C : a.tw;
    const long long vecs = (a.M * wt + V - 1) / V;
    const long long need = (vecs + NT - 1) / NT;
    long long fill = (long long)per_sm * sms / tiles;
    if (fill < 1) fill = 1;
    // as many blocks as fill the SMs, evened out so that every block walks
    // the same number of steps (no last step that runs a fraction full)
    const long long rounds = (need + fill - 1) / fill;
    const dim3 grid((unsigned)((need + rounds - 1) / rounds),
                    (unsigned)tiles);
    kernel<<<grid, NT, smem, stream>>>(
        (const TX*)a.x, (const TX*)a.thr, a.out, a.M, a.C, a.N, a.out_bias,
        a.out_kind, a.steps, a.tw);
    return cudaGetLastError();
}

template <typename TX, int V, int NR>
cudaError_t launch_stream(const Args& a, long long chunks, int sms,
                          cudaStream_t stream) {
    auto kernel = multithreshold_stream<TX, V, NR>;
    constexpr int CH = CHUNK_VECS * THREADS * V;
    constexpr int smem = STAGES * CH * (int)sizeof(TX) + 2 * CH * 4
                         + STAGES * 8;
    static int per_sm = 0;                // resident blocks per SM, cached
    if (per_sm == 0) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, THREADS, smem);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
    }
    const long long fill = (long long)per_sm * sms;
    const long long rounds = (chunks + fill - 1) / fill;
    kernel<<<(unsigned)((chunks + rounds - 1) / rounds), THREADS, smem,
             stream>>>((const TX*)a.x, (const TX*)a.thr, a.out, a.M * a.C,
                       (int)a.C, a.N, a.out_bias, a.out_kind);
    return cudaGetLastError();
}

template <typename TX, int V>
cudaError_t launch_route(Args a, int route, cudaStream_t stream) {
    if (route == 1) {
        a.tw = TILE;
        a.steps = 0;
        while ((1LL << a.steps) - 1 < a.N) ++a.steps;
        return launch<TX, V, SEARCH, 1>(a, stream);
    }
    // the count reads a C that divides a block's step as one flat tile:
    // one contiguous stream, and a thread's columns never change
    const bool flat = (long long)THREADS * V % a.C == 0;
    a.tw = flat ? (int)a.C : TILE;
    // registers where every tile's width divides the step
    const bool fixed_cols = flat || a.C % TILE == 0;
    if (!fixed_cols || a.N > REG_MAX) return launch<TX, V, LOOP, 1>(a, stream);
    // bulk copies for a flat tile of at least one chunk per SM, where x
    // (16-byte vectors) and out lie on 16 bytes
    if constexpr (V * sizeof(TX) == 16) {
        constexpr long long CH = (long long)CHUNK_VECS * THREADS * V;
        int sms = 0;
        const cudaError_t err = sm_count(&sms);
        if (err != cudaSuccess) return err;
        const long long chunks = a.M * a.C / CH;
        if (flat && (uintptr_t)a.out % 16 == 0 && chunks >= sms) {
            if (a.N <= 3)
                return launch_stream<TX, V, 3>(a, chunks, sms, stream);
            if (a.N <= 7)
                return launch_stream<TX, V, 7>(a, chunks, sms, stream);
            return launch_stream<TX, V, REG_MAX>(a, chunks, sms, stream);
        }
    }
    if (a.N <= 3) return launch<TX, V, REG, 3>(a, stream);
    if (a.N <= 7) return launch<TX, V, REG, 7>(a, stream);
    return launch<TX, V, REG, REG_MAX>(a, stream);
}

template <typename TX>
cudaError_t launch_type(const Args& a, int route, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(TX);
    const int out_size = a.out_kind == 0 ? 1 : a.out_kind == 1 ? 2 : 4;
    // 16-byte loads need x on 16 bytes, the vector's outputs aligned in
    // `out`, and rows a whole number of vectors unless one tile holds
    // whole rows (C <= 32)
    const bool vec = (uintptr_t)a.x % 16 == 0
                     && (uintptr_t)a.out % (VEC * out_size) == 0
                     && (a.C % VEC == 0 || a.C <= TILE);
    return vec ? launch_route<TX, VEC>(a, route, stream)
               : launch_route<TX, 1>(a, route, stream);
}

}  // namespace

// x_kind: 0 = int32, 1 = float32, 2 = float64 (x and thresholds share it).
// out_kind: 0 = int8, 1 = int16, 2 = int32.  route: 0 = compare-count,
// 1 = search.  x (M, C) and thr (N, C) contiguous.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sira_multithreshold(const void* x, const void* thr, void* out,
                                   long long M, long long C, int N,
                                   int out_bias, int x_kind, int out_kind,
                                   int route, void* stream) {
    if (M <= 0 || C <= 0 || N < 0 || out_kind < 0 || out_kind > 2 ||
        route < 0 || route > 1)
        return (int)cudaErrorInvalidValue;
    const Args a{x, thr, out, M, C, N, out_bias, out_kind, 0, TILE};
    cudaStream_t s = (cudaStream_t)stream;
    switch (x_kind) {
    case 0: return (int)launch_type<int32_t>(a, route, s);
    case 1: return (int)launch_type<float>(a, route, s);
    case 2: return (int)launch_type<double>(a, route, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

