// unitig_sum: per-unitig float32 sums of node counts, in node order, for
// Hopper.
//
// Port of the JAX package's float32 scatter-adds of node counts into their
// unitigs: platanus_b_tpu/models/dbg.py:338-340 (_label_core's csum, which
// becomes ucov) and platanus_b_tpu/models/clean.py:512-514
// (_chain_pull_kernel's csum). XLA's CPU backend runs such a scatter-add
// as one sequential float32 sum in update order, so the function is, for
// each unitig u:
//   s = 0.0f; for i = 0 .. n-1 with uid[i] == u: s = fl32(s + fl32(c[i]))
// (fl32 rounds to nearest even). Nodes with uid < 0 or uid >= num_u add
// nothing. Atomics in no fixed order give other roundings once a partial
// sum passes 2^24, so the order is the function.
//
// Design: float32 holds every integer up to 2^24 exactly. While every
// partial sum of a unitig is an integer at or below 2^24, the sequential
// float sum is the exact integer sum; only what comes after a unitig's
// partial sums pass 2^24 depends on the order. Each node's key is its
// count when that lies in [0, 2^24], else 2^25, so that a key sum at or
// below 2^24 proves every partial sum exact.
// 1. node pass: the key sums of every unitig, one atomicAdd (uint64, so
//    its order does not matter) for each group of a warp's lanes with one
//    unitig (__match_any_sync, then __reduce_add_sync of the keys, which
//    fit in 32 bits over a warp);
// 2. unitig pass: a key sum at or below 2^24 is the answer, converted
//    once; any other unitig goes on the list of long unitigs;
// 3. long pass: a persistent grid, one block for each long unitig, scans
//    uid in tiles of kTile ids in id order. While the running key sum plus
//    the tile's stays at or below 2^24, the tile's sum is added exactly;
//    from the first tile where it would not, the block compacts the
//    tile's counts of u into shared memory in id order and one thread
//    adds them one by one with __fadd_rn, and so for every later tile.
// No step reads the host: a labeling with no long unitig pays for pass 3
// a launch whose blocks read the empty list and return.
//
// Bound: memory. The function reads uid and counts once and writes one
// float a unitig. Pass 3 reads uid again for every long unitig, and the
// counts of its nodes, and its serial adds are a chain of dependent float
// adds, which no bound of bytes or operations counts; at 40x no unitig
// passes 2^24 and pass 3 does no work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                      // ids a thread, in a row
constexpr int kTile = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kExact = 1ull << 24;
constexpr unsigned long long kTooBig = 1ull << 25;

__device__ __forceinline__ unsigned long long key_of(long long c) {
    return (c >= 0 && c <= (long long)kExact) ? (unsigned long long)c
                                              : kTooBig;
}

__global__ void __launch_bounds__(kThreads)
node_pass(const long long* __restrict__ uid, const long long* __restrict__ c,
          long long n, long long num_u, unsigned long long* __restrict__ sums) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    // every lane of the warp runs each round, so the warp votes stay full
    for (long long base = start - (threadIdx.x & 31); base < n;
         base += stride) {
        const long long i = base + (threadIdx.x & 31);
        long long u = -1;
        unsigned key = 0;
        if (i < n) {
            u = uid[i];
            key = (unsigned)key_of(c[i]);
        }
        const unsigned same = __match_any_sync(0xffffffffu, u);
        const unsigned total = __reduce_add_sync(same, key);
        if (u >= 0 && u < num_u && (threadIdx.x & 31) == __ffs(same) - 1)
            atomicAdd(&sums[u], (unsigned long long)total);
    }
}

__global__ void __launch_bounds__(kThreads)
unitig_pass(const unsigned long long* __restrict__ sums, long long num_u,
            float* __restrict__ out, int* __restrict__ list,
            int* __restrict__ n_long) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         u < num_u; u += stride) {
        const unsigned long long s = sums[u];
        if (s <= kExact) out[u] = (float)s;
        else list[atomicAdd(n_long, 1)] = (int)u;
    }
}

__global__ void __launch_bounds__(kThreads)
long_pass(const long long* __restrict__ uid, const long long* __restrict__ c,
          long long n, const int* __restrict__ list,
          const int* __restrict__ n_long, float* __restrict__ out) {
    __shared__ float vals[kTile];
    __shared__ int warp_cnt[kWarps];
    __shared__ unsigned long long warp_key[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int count = *n_long;
    for (int li = blockIdx.x; li < count; li += gridDim.x) {
        const long long u = list[li];
        unsigned long long run = 0;   // exact while !serial
        bool serial = false;
        float s = 0.0f;               // thread 0's sum once serial
        for (long long base = 0; base < n; base += kTile) {
            const long long first = base + (long long)threadIdx.x * kPer;
            long long cv[kPer];
            unsigned hit = 0;
            int cnt = 0;
            unsigned long long key = 0;
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                const long long i = first + j;
                cv[j] = 0;
                if (i < n && uid[i] == u) {
                    cv[j] = c[i];
                    hit |= 1u << j;
                    ++cnt;
                    key += key_of(cv[j]);
                }
            }
            // exclusive scan of the hits over the block, in id order
            int incl = cnt;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int up = __shfl_up_sync(0xffffffffu, incl, d);
                if (lane >= d) incl += up;
            }
#pragma unroll
            for (int d = 16; d > 0; d >>= 1)
                key += __shfl_xor_sync(0xffffffffu, key, d);
            if (lane == 31) warp_cnt[warp] = incl;
            if (lane == 0) warp_key[warp] = key;
            __syncthreads();
            int before = 0, total = 0;
            unsigned long long tile_key = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                before += w < warp ? warp_cnt[w] : 0;
                total += warp_cnt[w];
                tile_key += warp_key[w];
            }
            if (total > 0) {
                if (!serial && run + tile_key <= kExact) {
                    run += tile_key;
                } else {
                    if (!serial) {
                        serial = true;
                        s = (float)run;
                    }
                    int at = before + incl - cnt;
#pragma unroll
                    for (int j = 0; j < kPer; ++j)
                        if (hit >> j & 1) vals[at++] = __ll2float_rn(cv[j]);
                    __syncthreads();
                    if (threadIdx.x == 0)
                        for (int k = 0; k < total; ++k)
                            s = __fadd_rn(s, vals[k]);
                }
            }
            __syncthreads();
        }
        if (threadIdx.x == 0) out[u] = serial ? s : (float)run;
    }
}

int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev) != cudaSuccess)
            sms = 132;
    }
    return sms;
}

int grid_for(long long work) {
    const long long blocks = (work + kThreads - 1) / kThreads;
    const long long most = (long long)sm_count() * 8;
    return (int)(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

}  // namespace

// out[num_u] float32: each unitig's sequential float32 sum of counts in id
// order over uid[n], counts[n] (int64). scratch: num_u + 1 int64 (the key
// sums, then the count of long unitigs); list: num_u int32.
extern "C" int platanus_unitig_sum(const void* uid, const void* counts,
                                   long long n, long long num_u, void* out,
                                   void* scratch, void* list, void* stream) {
    if (n < 0 || num_u < 0 || num_u > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (num_u == 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    auto* sums = static_cast<unsigned long long*>(scratch);
    auto* n_long = reinterpret_cast<int*>(sums + num_u);
    cudaError_t e = cudaMemsetAsync(sums, 0, sizeof(long long) * (num_u + 1),
                                    s);
    if (e != cudaSuccess) return (int)e;
    const auto* u = static_cast<const long long*>(uid);
    const auto* c = static_cast<const long long*>(counts);
    auto* o = static_cast<float*>(out);
    auto* l = static_cast<int*>(list);
    if (n > 0) {
        node_pass<<<grid_for(n), kThreads, 0, s>>>(u, c, n, num_u, sums);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    unitig_pass<<<grid_for(num_u), kThreads, 0, s>>>(sums, num_u, o, l,
                                                      n_long);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    long_pass<<<sm_count(), kThreads, 0, s>>>(u, c, n, l, n_long, o);
    return (int)cudaGetLastError();
}
