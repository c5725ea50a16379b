// list_rank: pointer-doubling list ranking and the cycle cut's min-pair
// propagation for Hopper.
//
// Port of two device loops of the JAX package's unitig labeling, each
// compiled by XLA into one device program:
// - _doubling_rank (platanus_b_tpu/models/dbg.py:191-214), a
//   lax.while_loop of at most `iters` steps that leaves once no pointer
//   is live, the exit test running on the device. One step, for every id
//   i whose pointer p = ptr[i] is live (p >= 0):
//     rank[i] += rank[p]; anchor[i] = anchor[p]; ptr[i] = ptr[p]
//   reading only the previous step's arrays (Wyllie's synchronous step),
//   from the start state _label_core builds from the predecessor links
//   prv (dbg.py:254-256): ptr = prv, rank = (prv >= 0), anchor = prv
//   where prv >= 0, else i.
// - the min-pair loop of the cycle cut (dbg.py:273-285), a lax.fori_loop
//   of exactly `iters` steps: for every live i, (a[i], b[i]) takes
//   (a[p], b[p]) if that pair is lexicographically smaller, and
//   ptr[i] = ptr[p].
// A pointer at or past m reads row m - 1, as the reference's clip does.
//
// Bound: memory. A step reads each id's state and gathers its target's at
// random; there is no arithmetic to speak of. So the design shrinks the
// bytes a step moves.
// - One 8-byte record an id. From that start state every step keeps
//   anchor[i] == ptr[i] on a live id: its new anchor and ptr both come
//   from its target q, whose two fields are equal if q is live, and if q
//   is dead ptr becomes -1. So a record holds one link (ptr while the id
//   is live, its anchor once dead), the rank and a live bit:
//     bits 0-31 link (int32), bit 63 live;
//     live: bits 32-62 rank (cycle ranks reach 2^iters, iters <= 30);
//     dead: bits 32-61 rank (below m < 2^30), bit 62 "fresh".
//   A live id's step reads its own 8 bytes, gathers its target's record
//   (one 32-byte sector) and writes 8 bytes: rank + rank_q, link_q,
//   live_q. 48 bytes, where three int64 arrays took 144.
// - Dead ids cost a read. Steps still read one buffer and write the other
//   (double buffering keeps every step synchronous, so the outputs equal
//   the plain version's bit for bit, cycle members and a binding cap
//   included: an in-place step would read neighbours already updated). A
//   record that a step writes dead for the first time is "fresh": the
//   other buffer lacks it. The next step copies it there without the bit
//   and clears the bit in its own buffer too; from then on both buffers
//   hold it and a step only reads it. (The clear races with other ids
//   gathering that record, harmlessly: it changes no bit they read.)
// - The first step builds the records from prv (gathering prv at the
//   target), and a finishing kernel writes the int64 ptr, rank, anchor;
//   neither is a pass of its own.
// - The loop's exit stays on the card: each step raises flags[s + 1]
//   (atomicOr, once a warp) when a record it writes is live; a step whose
//   flags[s] is 0 returns at once. A running step records s + 1 in
//   flags[iters + 1]; the finishing kernel reads the result from buffer
//   (steps run) % 2 and writes stats = {steps that did work, 1 if a
//   pointer is still live}, which the caller reads with one 16-byte copy.
// - The min-pair loop carries (a, b) as one int64, a << 32 | b (both lie
//   in [0, m], so the packed compare is the lexicographic one), beside an
//   int32 ptr and the fresh flag in one 16-byte record; its `iters` steps
//   all run, the first reading the int64 inputs and the last writing the
//   int64 outputs.
// Each thread takes kIds ids a round (strided by the block, so that the
// own reads stay coalesced) and issues their gathers together.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kIds = 4;
constexpr unsigned long long kLive = 1ull << 63;
constexpr unsigned long long kFresh = 1ull << 62;
constexpr unsigned long long kLinkMask = 0xffffffffull;

__device__ __forceinline__ long long clip(long long p, long long m) {
    return p < m ? p : m - 1;
}

__device__ __forceinline__ int link_of(unsigned long long r) {
    return (int)(unsigned)(r & kLinkMask);
}

__device__ __forceinline__ unsigned long long rank_of(unsigned long long r) {
    return (r & kLive) ? (r >> 32) & 0x7fffffffull : (r >> 32) & 0x3fffffffull;
}

__device__ __forceinline__ unsigned long long record(int link,
                                                     unsigned long long rank,
                                                     bool live) {
    return (unsigned long long)(unsigned)link | (rank << 32)
           | (live ? kLive : kFresh);
}

// Warp vote then one atomic a warp: flag |= any(live) over the warp.
__device__ __forceinline__ void raise_flag(int* flag, bool live) {
    const unsigned any = __ballot_sync(0xffffffffu, live);
    if (any && (threadIdx.x & 31) == 0) atomicOr(flag, 1);
}

// Step 0: the records after one step, straight from prv. Every dead
// record is fresh: buffer 0 never held the start state.
__global__ void __launch_bounds__(kThreads)
rank_first(const long long* __restrict__ prv,
           unsigned long long* __restrict__ out, long long m, int iters,
           int* __restrict__ flags) {
    if (blockIdx.x == 0 && threadIdx.x == 0) flags[iters + 1] = 1;
    bool in_live = false, out_live = false;
    const long long round = (long long)gridDim.x * kThreads * kIds;
    for (long long base = (long long)blockIdx.x * kThreads * kIds
                          + threadIdx.x;
         base < m; base += round) {
        long long p[kIds], pq[kIds];
#pragma unroll
        for (int k = 0; k < kIds; ++k) {
            const long long i = base + k * kThreads;
            p[k] = i < m ? prv[i] : -1;
        }
#pragma unroll
        for (int k = 0; k < kIds; ++k)
            pq[k] = p[k] >= 0 ? prv[clip(p[k], m)] : -1;
#pragma unroll
        for (int k = 0; k < kIds; ++k) {
            const long long i = base + k * kThreads;
            if (i >= m) continue;
            if (p[k] >= 0) {
                const long long q = clip(p[k], m);
                const bool live = pq[k] >= 0;
                out[i] = record((int)(live ? pq[k] : q), 1 + (live ? 1 : 0),
                                live);
                in_live = true;
                out_live |= live;
            } else {
                out[i] = record((int)i, 0, false);
            }
        }
    }
    raise_flag(&flags[0], in_live);
    raise_flag(&flags[1], out_live);
}

__global__ void __launch_bounds__(kThreads)
rank_step(unsigned long long* __restrict__ in,
          unsigned long long* __restrict__ out, long long m, int s, int iters,
          int* __restrict__ flags) {
    if (flags[s] == 0) return;
    if (blockIdx.x == 0 && threadIdx.x == 0) flags[iters + 1] = s + 1;
    bool out_live = false;
    const long long round = (long long)gridDim.x * kThreads * kIds;
    for (long long base = (long long)blockIdx.x * kThreads * kIds
                          + threadIdx.x;
         base < m; base += round) {
        unsigned long long r[kIds], rq[kIds];
#pragma unroll
        for (int k = 0; k < kIds; ++k) {
            const long long i = base + k * kThreads;
            r[k] = i < m ? in[i] : 0;
        }
#pragma unroll
        for (int k = 0; k < kIds; ++k)
            rq[k] = (r[k] & kLive) ? in[clip(link_of(r[k]), m)] : 0;
#pragma unroll
        for (int k = 0; k < kIds; ++k) {
            const long long i = base + k * kThreads;
            if (i >= m) continue;
            if (r[k] & kLive) {
                const bool live = (rq[k] & kLive) != 0;
                out[i] = record(link_of(rq[k]),
                                rank_of(r[k]) + rank_of(rq[k]), live);
                out_live |= live;
            } else if (r[k] & kFresh) {
                const unsigned long long done = r[k] & ~kFresh;
                out[i] = done;
                in[i] = done;
            }
        }
    }
    raise_flag(&flags[s + 1], out_live);
}

__global__ void __launch_bounds__(kThreads)
rank_finish(const unsigned long long* __restrict__ buf0,
            const unsigned long long* __restrict__ buf1, long long m,
            int iters, const int* __restrict__ flags,
            long long* __restrict__ ptr, long long* __restrict__ rank,
            long long* __restrict__ anchor, long long* __restrict__ stats) {
    const int ran = flags[iters + 1];
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        stats[0] = flags[0] ? ran : 0;
        stats[1] = flags[iters];
    }
    const unsigned long long* __restrict__ buf = (ran & 1) ? buf1 : buf0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < m; i += stride) {
        const unsigned long long r = buf[i];
        const long long link = link_of(r);
        ptr[i] = (r & kLive) ? link : -1;
        rank[i] = (long long)rank_of(r);
        anchor[i] = link;
    }
}

// The min-pair record: (a << 32 | b), ptr, fresh.
struct __align__(16) Pair {
    long long ab;
    int ptr;
    int fresh;
};

template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads)
min_pair_step(const long long* __restrict__ ptr0,
              const long long* __restrict__ a0,
              const long long* __restrict__ b0, Pair* __restrict__ in,
              Pair* __restrict__ out, long long* __restrict__ a_out,
              long long* __restrict__ b_out, long long m) {
    const long long round = (long long)gridDim.x * kThreads * kIds;
    for (long long base = (long long)blockIdx.x * kThreads * kIds
                          + threadIdx.x;
         base < m; base += round) {
        Pair r[kIds], rq[kIds];
#pragma unroll
        for (int k = 0; k < kIds; ++k) {
            const long long i = base + k * kThreads;
            if (i >= m) {
                r[k] = Pair{0, -1, 0};
            } else if (kFirst) {
                r[k] = Pair{a0[i] << 32 | b0[i], (int)ptr0[i], 1};
            } else {
                r[k] = in[i];
            }
        }
#pragma unroll
        for (int k = 0; k < kIds; ++k) {
            if (r[k].ptr < 0) continue;
            const long long q = clip(r[k].ptr, m);
            rq[k] = kFirst ? Pair{a0[q] << 32 | b0[q], (int)ptr0[q], 0}
                           : in[q];
        }
#pragma unroll
        for (int k = 0; k < kIds; ++k) {
            const long long i = base + k * kThreads;
            if (i >= m) continue;
            Pair o = r[k];
            bool write = true;
            if (r[k].ptr >= 0) {
                o.ab = rq[k].ab < r[k].ab ? rq[k].ab : r[k].ab;
                o.ptr = rq[k].ptr;
                o.fresh = 1;
            } else if (kFirst) {
                o.fresh = 1;         // buffer 0 never held the inputs
            } else if (r[k].fresh) {
                o.fresh = 0;
                if (!kLast) in[i] = o;
            } else {
                write = kLast;
            }
            if (kLast) {
                a_out[i] = o.ab >> 32;
                b_out[i] = o.ab & 0xffffffffll;
            } else if (write) {
                out[i] = o;
            }
        }
    }
}

int grid_for(long long work) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev) != cudaSuccess)
            sms = 132;
    }
    const long long blocks = (work + kThreads - 1) / kThreads;
    const long long most = (long long)sms * kBlocksPerSm;
    return (int)(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

bool bad_size(long long m, int iters) {
    return m < 0 || m >= (1ll << 30) || iters < 1 || iters > 30;
}

}  // namespace

// Pointer doubling from the predecessor links prv (m,) int64: writes ptr,
// rank and anchor (m,) int64 and stats (2,) int64. buf0, buf1: m uint64 of
// scratch each; flags: iters + 2 int32 of scratch.
extern "C" int platanus_list_rank(const void* prv, void* buf0, void* buf1,
                                  long long m, int iters, void* flags,
                                  void* ptr, void* rank, void* anchor,
                                  void* stats, void* stream) {
    if (bad_size(m, iters)) return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    auto* f = static_cast<int*>(flags);
    cudaError_t e = cudaMemsetAsync(f, 0, sizeof(int) * (iters + 2), s);
    if (e != cudaSuccess) return (int)e;
    unsigned long long* buf[2] = {static_cast<unsigned long long*>(buf0),
                                  static_cast<unsigned long long*>(buf1)};
    const int grid = grid_for((m + kIds - 1) / kIds);
    rank_first<<<grid, kThreads, 0, s>>>(static_cast<const long long*>(prv),
                                         buf[1], m, iters, f);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    for (int step = 1; step < iters; ++step) {
        rank_step<<<grid, kThreads, 0, s>>>(buf[step & 1],
                                            buf[(step + 1) & 1], m, step,
                                            iters, f);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    rank_finish<<<grid_for(m), kThreads, 0, s>>>(
        buf[0], buf[1], m, iters, f, static_cast<long long*>(ptr),
        static_cast<long long*>(rank), static_cast<long long*>(anchor),
        static_cast<long long*>(stats));
    return (int)cudaGetLastError();
}

// The min-pair loop over (m,) int64 ptr, a, b (a, b in [0, 2^31)): writes
// a_out, b_out (m,) int64. buf0, buf1: 2 m int64 of scratch each.
extern "C" int platanus_min_pair(const void* ptr, const void* a,
                                 const void* b, void* buf0, void* buf1,
                                 long long m, int iters, void* a_out,
                                 void* b_out, void* stream) {
    if (bad_size(m, iters)) return (int)cudaErrorInvalidValue;
    if (m == 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    const auto* p0 = static_cast<const long long*>(ptr);
    const auto* a0 = static_cast<const long long*>(a);
    const auto* b0 = static_cast<const long long*>(b);
    Pair* buf[2] = {static_cast<Pair*>(buf0), static_cast<Pair*>(buf1)};
    auto* ao = static_cast<long long*>(a_out);
    auto* bo = static_cast<long long*>(b_out);
    const int grid = grid_for((m + kIds - 1) / kIds);
    for (int step = 0; step < iters; ++step) {
        Pair* in = buf[step & 1];
        Pair* out = buf[(step + 1) & 1];
        const bool first = step == 0, last = step == iters - 1;
        if (first && last)
            min_pair_step<true, true><<<grid, kThreads, 0, s>>>(
                p0, a0, b0, in, out, ao, bo, m);
        else if (first)
            min_pair_step<true, false><<<grid, kThreads, 0, s>>>(
                p0, a0, b0, in, out, ao, bo, m);
        else if (last)
            min_pair_step<false, true><<<grid, kThreads, 0, s>>>(
                p0, a0, b0, in, out, ao, bo, m);
        else
            min_pair_step<false, false><<<grid, kThreads, 0, s>>>(
                p0, a0, b0, in, out, ao, bo, m);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}
