// unitig_sum: per-unitig float32 sums of node counts, in node order, and
// each unitig's node count, for Hopper.
//
// Port of the JAX package's float32 scatter-adds of node counts into their
// unitigs: platanus_b_tpu/models/dbg.py:338-340 (_label_core's csum, which
// becomes ucov) and platanus_b_tpu/models/clean.py:512-514
// (_chain_pull_kernel's csum). XLA's CPU backend runs such a scatter-add
// as one sequential float32 sum in update order, so the function is, for
// each unitig u:
//   s = 0.0f; for i = 0 .. n-1 with uid[i] == u: s = fl32(s + fl32(c[i]))
// (fl32 rounds to nearest even). Nodes with uid < 0 or uid >= num_u add
// nothing. Beside it, on request, ulen[u]: the nodes with uid == u (the
// labeling's ulen, dbg.py:336-337). Atomics in no fixed order give other
// roundings once a partial sum passes 2^24, so the order is the function,
// and no atomic here decides a rounding.
//
// One cooperative launch (every block resident; phases split by grid
// syncs). Bound: on the main path no unitig passes 2^24, and the bytes
// bound it: one read of uid and counts, one write of the sums and ulen
// (in practice the node pass's atomics set the time, as they set
// index_add_'s). A long unitig adds the walk, a chain of dependent steps:
// its serial bound is the longest walk's steps times one step's chain.
// 1. Node pass: one float2 atomic add (RED, its return unused) a node of
//    (key, 1) into the unitig's pair, where key = c for c in [0, 2^24),
//    else 2^24. Float adds of non-negative integers are exact until a
//    partial sum reaches 2^24 and never fall back below it, so a key sum
//    under 2^24 proves every partial sum exact in any order: it is the
//    answer. The pairs are kept kReplicas times (one copy a warp, by its
//    index; 16: fewer let the nodes of one long unitig, scattered over the
//    whole array, queue on a few addresses, more cost the convert pass
//    more than they save on the main path; a labeling of some 330 k
//    unitigs, as 100x coverage makes, would rather have 4, whose copies
//    stay in L2), each copy's array padded to 256 bytes so no two copies
//    of a pair share a line. uid and counts are read 16 bytes a load where
//    both are 16-byte aligned. Above 2^24 nodes the float count could
//    round, so then a uint32 count is kept beside. No warp vote merges
//    lanes of one unitig (__match_any_sync): adjacent node ids almost
//    never share a unitig, and on the main path the vote doubled the time
//    (it halves it where a few unitigs hold every node).
// 2. Convert pass: sums the replicas and zeroes them behind itself (the
//    pairs are a scratch that stays zero between calls), writes ulen and
//    the short sums, and lists the long unitigs in a slot map (each
//    unitig's index in the list, or -1). When the list is empty every
//    block returns: the main path is one device operation.
// 3. Long path, in the scratch:
//    a. offsets of each long unitig's values (block 0), then one pass of
//       the grid over uid for kGroup long unitigs at a time: a block holds
//       a tile of kTile ids, ranks each id among its warp's ids of the
//       same unitig (__match_any_sync), counts each unitig's ids, a grid
//       sync, an exclusive scan over the blocks of each unitig's counts
//       (a block a unitig), a grid sync, and the block writes fl32(c[i]) of
//       each of its ids to its place: every long unitig's values land
//       contiguous and in id order.
//    b. Chunk transfers. Take s a float32 whose ulp u = 2^j, j >= 1, is
//       that of its binade [2^(23+j), 2^(24+j)), and add a non-negative
//       integer x = q u + r (0 <= r < u) without leaving the binade: the
//       sum rounds to s + q u if r < u/2, to s + (q + 1) u if r > u/2,
//       and on a tie to whichever of the two has an even significand. So
//       the increment depends on x and on the parity of s / u alone, and a
//       chunk of kChunk values, added from either parity, has an increment
//       and an end parity that compose from its values' (an ordered warp
//       reduction). Below 2^24 (j = 0) every add is exact and the
//       increment is the sum. The binade j of a chunk is guessed from the
//       exact integer prefix at its start (chunk sums, then a scan a long
//       unitig).
//    c. The walk: a warp a long unitig keeps s as (j, k), s = k 2^j with
//       k in [2^23, 2^24) (or j = 0, k < 2^24). A chunk may be taken
//       (k += its increment for the parity of k) when its guess is j, its
//       values all lie in [0, 2^31) and k stays under 2^24 (the top of
//       the binade); any other chunk is added one value at a time with
//       __fadd_rn (a replay). A step takes 32 chunks: the lanes compose
//       their chunks' transfers in order (a warp scan, which does not
//       wait on k), each lane finds k after its chunk, a ballot finds the
//       first chunk that cannot be taken, and the warp replays it and
//       steps again from the next one. The chain of dependent steps falls
//       from a unitig's nodes to its chunks / 32, plus a step and a
//       replay near each binade crossing.
// No step reads the host.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;                 // blocks an SM, for registers
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                     // rows of 32 ids a warp holds
constexpr int kBatch = 8;                     // rows loaded at once
constexpr int kTile = kThreads * kRows;       // ids a block holds
constexpr int kGroup = 32;                    // long unitigs a pass over uid
constexpr int kChunk = 512;        // values a chunk of the fold (256 and
                                   // 1024: no faster on real long calls)
constexpr int kPerLane = kChunk / 32;
constexpr int kBufStride = kChunk + kChunk / 32;
constexpr int kReplicas = 16;
constexpr int kTop = 1 << 24;                 // significands stay below
constexpr float kExact = 16777216.0f;         // 2^24
constexpr long long kValueCap = 1ll << 31;    // a chunk's values stay below
constexpr int kAccept = 1 << 8;               // meta: the chunk may be taken
static_assert(kChunk % 32 == 0 && kChunk >= 32 && kChunk <= 1024,
              "a chunk is whole rows of a warp");
static_assert((kReplicas & (kReplicas - 1)) == 0, "replicas: a power of 2");

struct Args {
    const long long* uid;
    const long long* c;
    long long n;
    long long num_u;
    float* out;
    long long* ulen;          // null when not asked for
    long long* stats;         // null, or [long unitigs, chunks, replays,
                              //         the longest walk's steps]
    long long stride;         // replicas' distance: num_u to 256 bytes
    float2* pair;             // [kReplicas][stride]: zero on entry and exit
    unsigned* cnt;            // [kReplicas][stride] when exact_counts, same
    int exact_counts;         // n > 2^24: a float count could round
    int* slot;                // [num_u]
    int* list;                // [num_u] the long unitigs
    long long* len;           // [num_u + 1] their node counts
    long long* off;           // [num_u + 1] their values' offsets
    long long* cfirst;        // [num_u + 1] their first chunks
    int* n_long;
    int* gcnt;                // [grid][kGroup]
    long long* gpre;          // [grid][kGroup]
    long long* gtot;          // [kGroup]
    float* vals;              // [n]
    int* cslot;               // [chunks] each chunk's long unitig
    long long* csum;          // [chunks] chunk sums, then their prefixes
    int4* rec;                // [chunks] (increment from parity 0, from 1,
                              //           guess | kAccept, 0)
};

struct Tile {
    int code[kTile];          // slot << 16 | rank among its warp's, or -1
    float val[kTile];
};

union Shared {
    Tile tile;
    float buf[kWarps][kBufStride];
};

__device__ __forceinline__ float key_of(long long c) {
    return (c >= 0 && c < (long long)kTop) ? (float)c : kExact;
}

__device__ __forceinline__ void add_node(const Args& a, float2* pair,
                                         unsigned* cnt, long long u,
                                         long long c) {
    if (u >= 0 && u < a.num_u) {
        atomicAdd(pair + u, make_float2(key_of(c), 1.0f));
        if (a.exact_counts) atomicAdd(cnt + u, 1u);
    }
}

__device__ void node_pass(const Args& a, long long gtid, long long nthreads) {
    const long long rep = (gtid >> 5) & (kReplicas - 1);
    float2* pair = a.pair + rep * a.stride;
    unsigned* cnt = a.cnt + rep * a.stride;
    const bool vec = ((reinterpret_cast<uintptr_t>(a.uid)
                       | reinterpret_cast<uintptr_t>(a.c)) & 15) == 0;
    if (!vec) {
        for (long long i = gtid; i < a.n; i += nthreads)
            add_node(a, pair, cnt, __ldg(a.uid + i), __ldg(a.c + i));
        return;
    }
    constexpr int kU = 4;                     // 16-byte loads in flight
    const auto* u2 = reinterpret_cast<const longlong2*>(a.uid);
    const auto* c2 = reinterpret_cast<const longlong2*>(a.c);
    const long long pairs = a.n >> 1;
    long long p = gtid;
    for (; p + (kU - 1) * nthreads < pairs; p += kU * nthreads) {
        longlong2 uu[kU], cc[kU];
#pragma unroll
        for (int j = 0; j < kU; ++j) {
            uu[j] = __ldg(u2 + p + j * nthreads);
            cc[j] = __ldg(c2 + p + j * nthreads);
        }
#pragma unroll
        for (int j = 0; j < kU; ++j) {
            add_node(a, pair, cnt, uu[j].x, cc[j].x);
            add_node(a, pair, cnt, uu[j].y, cc[j].y);
        }
    }
    for (; p < pairs; p += nthreads) {
        const longlong2 uu = __ldg(u2 + p), cc = __ldg(c2 + p);
        add_node(a, pair, cnt, uu.x, cc.x);
        add_node(a, pair, cnt, uu.y, cc.y);
    }
    if (gtid == 0 && (a.n & 1))
        add_node(a, pair, cnt, __ldg(a.uid + a.n - 1), __ldg(a.c + a.n - 1));
}

// A thread a unitig, all its replicas' loads in flight at once.
__device__ void convert_pass(const Args& a, long long gtid,
                             long long nthreads) {
    for (long long u = gtid; u < a.num_u; u += nthreads) {
        float2 p[kReplicas];
#pragma unroll
        for (int r = 0; r < kReplicas; ++r)
            p[r] = __ldcg(a.pair + r * a.stride + u);
        float key = 0.0f, count = 0.0f;
#pragma unroll
        for (int r = 0; r < kReplicas; ++r) {
            a.pair[r * a.stride + u] = make_float2(0.0f, 0.0f);
            key += p[r].x;
            count += p[r].y;
        }
        long long len = (long long)count;
        if (a.exact_counts) {
            len = 0;
            for (int r = 0; r < kReplicas; ++r) {
                len += __ldcg(a.cnt + r * a.stride + u);
                a.cnt[r * a.stride + u] = 0u;
            }
        }
        if (a.ulen) a.ulen[u] = len;
        if (key < kExact) {
            a.out[u] = key;
            a.slot[u] = -1;
        } else {
            const int s = atomicAdd(a.n_long, 1);
            a.list[s] = (int)u;
            a.len[s] = len;
            a.slot[u] = s;
        }
    }
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    return x;
}

// Exclusive scan of v over the block; *total receives the block's sum.
__device__ long long block_exclusive_scan(long long v, long long* total,
                                          long long* warp_sums) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long x = warp_inclusive_scan(v);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    long long before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const long long s = warp_sums[w];
        before += w < warp ? s : 0;
        all += s;
    }
    __syncthreads();
    *total = all;
    return before + x - v;
}

// Block 0: each long unitig's values' offset and first chunk, and each
// chunk's long unitig.
__device__ void offsets(const Args& a, int L, long long* warp_sums) {
    long long obase = 0, cbase = 0;
    for (int s0 = 0; s0 < L; s0 += kThreads) {
        const int s = s0 + threadIdx.x;
        const long long ln = s < L ? __ldcg(a.len + s) : 0;
        const long long nc = (ln + kChunk - 1) / kChunk;
        long long tl, tc;
        const long long el = block_exclusive_scan(ln, &tl, warp_sums);
        const long long ec = block_exclusive_scan(nc, &tc, warp_sums);
        if (s < L) {
            a.off[s] = obase + el;
            a.cfirst[s] = cbase + ec;
            for (long long c = cbase + ec; c < cbase + ec + nc; ++c)
                a.cslot[c] = s;
        }
        obase += tl;
        cbase += tc;
    }
    if (threadIdx.x == 0) {
        a.off[L] = obase;
        a.cfirst[L] = cbase;
    }
}

// The values of chunk g: [*beg, *end).
__device__ void chunk_range(const Args& a, long long g, long long* beg,
                            long long* end) {
    const int s = __ldcg(a.cslot + g);
    const long long o = __ldcg(a.off + s);
    *beg = o + (g - __ldcg(a.cfirst + s)) * kChunk;
    const long long last = o + __ldcg(a.len + s);
    *end = *beg + kChunk < last ? *beg + kChunk : last;
}

// A chunk's increment (in ulps of 2^j) and end parity from start parity
// 0 and from 1, and whether every value lies in [0, kValueCap).
struct Transfer {
    long long i0, i1;
    int e0, e1;
    bool ok;
};

__device__ __forceinline__ void transfer_add(Transfer& t, float x, int j) {
    if (!(x >= 0.0f && x < (float)kValueCap)) {
        t.ok = false;
        return;
    }
    const long long X = (long long)x;
    if (j == 0) {                            // below 2^24: exact
        t.i0 += X;
        t.i1 += X;
        return;
    }
    const long long q = X >> j, r = X & ((1ll << j) - 1), half = 1ll << (j - 1);
    const long long d0 = q + (r > half || (r == half && ((t.e0 + q) & 1)));
    const long long d1 = q + (r > half || (r == half && ((t.e1 + q) & 1)));
    t.i0 += d0;
    t.e0 = (int)((t.e0 + d0) & 1);
    t.i1 += d1;
    t.e1 = (int)((t.e1 + d1) & 1);
}

__device__ __forceinline__ int pad(int p) { return p + (p >> 5); }

__device__ __forceinline__ float to_float(int j, int k, float other) {
    if (j < 0) return other;
    if (j == 0) return (float)k;
    return __uint_as_float(((unsigned)(j + 150) << 23) | (k & 0x7fffff));
}

__device__ __forceinline__ void from_float(float s, int* j, int* k,
                                           float* other) {
    if (!(s >= 0.0f) || isinf(s)) {          // negative: no binade walk
        *j = -1;
        *other = s;
    } else if (s < kExact) {
        *j = 0;
        *k = (int)s;
    } else {
        const unsigned bits = __float_as_uint(s);
        *j = (int)(bits >> 23) - 150;
        *k = (int)((bits & 0x7fffff) | 0x800000);
    }
}

__device__ void long_path(const Args& a, int L, Shared& sh,
                          int (*wcnt)[kGroup], long long* sbase,
                          long long* warp_sums) {
    cg::grid_group grid = cg::this_grid();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = gridDim.x * kWarps;
    const int gw = blockIdx.x * kWarps + warp;
    const unsigned below = (1u << lane) - 1;
    if (blockIdx.x == 0) offsets(a, L, warp_sums);

    // a. every long unitig's values, contiguous and in id order
    for (int g0 = 0; g0 < L; g0 += kGroup) {
        const int gs = L - g0 < kGroup ? L - g0 : kGroup;
        for (long long base = 0; base < a.n;
             base += (long long)gridDim.x * kTile) {
            const long long tb = base + (long long)blockIdx.x * kTile;
            for (int i = threadIdx.x; i < kWarps * kGroup; i += kThreads)
                wcnt[i / kGroup][i % kGroup] = 0;
            __syncthreads();
            for (int r0 = 0; r0 < kRows; r0 += kBatch) {
                // kBatch rows' loads in flight at once: uid, then the slot
                // map, then the counts of the ids in this group
                const long long i0 = tb + (warp * kRows + r0) * 32 + lane;
                long long uu[kBatch];
                int sl[kBatch];
                float v[kBatch];
#pragma unroll
                for (int b = 0; b < kBatch; ++b)
                    uu[b] = i0 + b * 32 < a.n ? __ldg(a.uid + i0 + b * 32) : -1;
#pragma unroll
                for (int b = 0; b < kBatch; ++b) {
                    sl[b] = uu[b] >= 0 && uu[b] < a.num_u
                        ? __ldcg(a.slot + uu[b]) - g0 : -1;
                    if (sl[b] < 0 || sl[b] >= gs) sl[b] = -1;
                }
#pragma unroll
                for (int b = 0; b < kBatch; ++b)
                    v[b] = sl[b] >= 0 ? __ll2float_rn(__ldg(a.c + i0 + b * 32))
                                      : 0.0f;
#pragma unroll
                for (int b = 0; b < kBatch; ++b) {
                    const int t = (warp * kRows + r0 + b) * 32 + lane;
                    const unsigned peers = __match_any_sync(0xffffffffu, sl[b]);
                    int code = -1;
                    if (sl[b] >= 0)
                        code = sl[b] << 16
                            | (wcnt[warp][sl[b]] + __popc(peers & below));
                    __syncwarp();
                    if (sl[b] >= 0 && lane == __ffs(peers) - 1)
                        wcnt[warp][sl[b]] += __popc(peers);
                    __syncwarp();
                    sh.tile.code[t] = code;
                    sh.tile.val[t] = v[b];
                }
            }
            __syncthreads();
            if (threadIdx.x < gs) {                // warps' starts, block count
                int run = 0;
                for (int w = 0; w < kWarps; ++w) {
                    const int c = wcnt[w][threadIdx.x];
                    wcnt[w][threadIdx.x] = run;
                    run += c;
                }
                a.gcnt[blockIdx.x * kGroup + threadIdx.x] = run;
            }
            grid.sync();
            // a block a long unitig: its counts' exclusive scan over the
            // blocks, after the rounds before
            for (int s = blockIdx.x; s < gs; s += gridDim.x) {
                long long carry = base == 0 ? 0 : __ldcg(a.gtot + s);
                for (int b0 = 0; b0 < (int)gridDim.x; b0 += kThreads) {
                    const int b = b0 + threadIdx.x;
                    const long long v = b < (int)gridDim.x
                        ? __ldcg(a.gcnt + b * kGroup + s) : 0;
                    long long total;
                    const long long ex = block_exclusive_scan(v, &total,
                                                              warp_sums);
                    if (b < (int)gridDim.x) a.gpre[b * kGroup + s] = carry + ex;
                    carry += total;
                }
                if (threadIdx.x == 0) a.gtot[s] = carry;
            }
            grid.sync();
            if (threadIdx.x < gs)
                sbase[threadIdx.x] = __ldcg(a.off + g0 + threadIdx.x)
                    + __ldcg(a.gpre + blockIdx.x * kGroup + threadIdx.x);
            __syncthreads();
            for (int t = threadIdx.x; t < kTile; t += kThreads) {
                const int code = sh.tile.code[t];
                if (code >= 0) {
                    const int sl = code >> 16;
                    a.vals[sbase[sl] + wcnt[t / (32 * kRows)][sl]
                           + (code & 0xffff)] = sh.tile.val[t];
                }
            }
            __syncthreads();
        }
    }
    grid.sync();

    // b. chunk sums (values clamped to +-(kValueCap - 1): a guess only) ...
    const long long nchunks = __ldcg(a.cfirst + L);
    for (long long g = gw; g < nchunks; g += nwarps) {
        long long beg, end;
        chunk_range(a, g, &beg, &end);
        long long sum = 0;
        for (int q = lane; q < kChunk; q += 32) {
            const long long i = beg + q;
            if (i < end) {
                const float x = __ldcg(a.vals + i);
                sum += x >= (float)kValueCap ? kValueCap - 1
                     : x <= -(float)kValueCap ? 1 - kValueCap : (long long)x;
            }
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, d);
        if (lane == 0) a.csum[g] = sum;
    }
    grid.sync();
    // ... their exclusive prefixes, a block a long unitig, in place ...
    for (int s = blockIdx.x; s < L; s += gridDim.x) {
        const long long c0 = __ldcg(a.cfirst + s), c1 = __ldcg(a.cfirst + s + 1);
        long long carry = 0;
        for (long long cb = c0; cb < c1; cb += kThreads) {
            const long long c = cb + threadIdx.x;
            const long long v = c < c1 ? __ldcg(a.csum + c) : 0;
            long long total;
            const long long ex = block_exclusive_scan(v, &total, warp_sums);
            if (c < c1) a.csum[c] = carry + ex;
            carry += total;
        }
    }
    grid.sync();
    // ... and each chunk's transfer at the binade its prefix guesses
    float* buf = sh.buf[warp];
    for (long long g = gw; g < nchunks; g += nwarps) {
        long long beg, end;
        chunk_range(a, g, &beg, &end);
        const long long P = __ldcg(a.csum + g);
        const int j = P < (long long)kTop ? 0 : 40 - __clzll(P);
        for (int q = lane; q < kChunk; q += 32)
            buf[pad(q)] = beg + q < end ? __ldcg(a.vals + beg + q) : 0.0f;
        __syncwarp();
        Transfer t = {0, 0, 0, 1, true};
#pragma unroll
        for (int q = 0; q < kPerLane; ++q)
            transfer_add(t, buf[pad(lane * kPerLane + q)], j);
        __syncwarp();
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {         // lane order = value order
            const long long o0 = __shfl_down_sync(0xffffffffu, t.i0, d);
            const long long o1 = __shfl_down_sync(0xffffffffu, t.i1, d);
            const int f0 = __shfl_down_sync(0xffffffffu, t.e0, d);
            const int f1 = __shfl_down_sync(0xffffffffu, t.e1, d);
            if ((lane & (2 * d - 1)) == 0) {
                t.i0 += t.e0 ? o1 : o0;
                t.e0 = t.e0 ? f1 : f0;
                t.i1 += t.e1 ? o1 : o0;
                t.e1 = t.e1 ? f1 : f0;
            }
        }
        const bool ok = __all_sync(0xffffffffu, t.ok);
        if (lane == 0)
            a.rec[g] = make_int4((int)(t.i0 < kTop ? t.i0 : kTop),
                                 (int)(t.i1 < kTop ? t.i1 : kTop),
                                 j | (ok ? kAccept : 0), 0);
    }
    grid.sync();

    // c. the walk, a warp a long unitig, up to 32 chunks a step
    for (int s = gw; s < L; s += nwarps) {
        const long long c0 = __ldcg(a.cfirst + s), c1 = __ldcg(a.cfirst + s + 1);
        const long long o = __ldcg(a.off + s), last = o + __ldcg(a.len + s);
        int j = 0, k = 0;                     // s = k 2^j
        float other = 0.0f;                   // s when j < 0
        long long replays = 0, steps = 0;
        int4 next = c0 + lane < c1 ? __ldcg(a.rec + c0 + lane)
                                   : make_int4(0, 0, -1, 0);
        for (long long cb = c0; cb < c1; cb += 32) {
            const int4 r = next;
            if (cb + 32 + lane < c1) next = __ldcg(a.rec + cb + 32 + lane);
            const int cnt = c1 - cb < 32 ? (int)(c1 - cb) : 32;
            for (int start = 0; start < cnt;) {
                ++steps;
                // the lanes' transfers from `start` on, composed in order
                // (off the chain through k)
                const bool mine = lane >= start && lane < cnt;
                int t0 = mine ? r.x : 0, t1 = mine ? r.y : 0;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const int p0 = __shfl_up_sync(0xffffffffu, t0, d);
                    const int p1 = __shfl_up_sync(0xffffffffu, t1, d);
                    if (lane >= d) {
                        const int n0 = p0 + ((p0 & 1) ? t1 : t0);
                        const int n1 = p1 + ((p1 & 1) ? t0 : t1);
                        t0 = n0;
                        t1 = n1;
                    }
                }
                // k after each lane's chunk, if every chunk before it is
                // taken; the first lane that cannot be taken is replayed
                const int kl = k + ((k & 1) ? t1 : t0);
                const bool take = !mine || (r.z == (j | kAccept) && kl < kTop);
                const unsigned bad = __ballot_sync(0xffffffffu, !take);
                if (bad == 0) {
                    k = __shfl_sync(0xffffffffu, kl, cnt - 1);
                    break;
                }
                const int f = __ffs(bad) - 1;
                const int kf = __shfl_sync(0xffffffffu, kl, f > 0 ? f - 1 : 0);
                if (f > start) k = kf;
                // the replay: the chunk staged in shared memory by the
                // warp, then added in order by every lane alike
                const long long beg = o + (cb + f - c0) * kChunk;
                const int len = (int)(last - beg < kChunk ? last - beg : kChunk);
                for (int q = lane; q < len; q += 32)
                    buf[pad(q)] = __ldcg(a.vals + beg + q);
                __syncwarp();
                float sf = to_float(j, k, other);
#pragma unroll 8
                for (int q = 0; q < len; ++q) sf = __fadd_rn(sf, buf[pad(q)]);
                __syncwarp();
                from_float(sf, &j, &k, &other);
                ++replays;
                start = f + 1;
            }
        }
        if (lane == 0) {
            a.out[__ldcg(a.list + s)] = to_float(j, k, other);
            if (a.stats) {
                atomicAdd((unsigned long long*)a.stats + 1,
                          (unsigned long long)(c1 - c0));
                atomicAdd((unsigned long long*)a.stats + 2,
                          (unsigned long long)replays);
                atomicMax((unsigned long long*)a.stats + 3,
                          (unsigned long long)steps);
            }
        }
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
unitig_sum_kernel(Args a) {
    __shared__ Shared sh;
    __shared__ int wcnt[kWarps][kGroup];
    __shared__ long long sbase[kGroup];
    __shared__ long long warp_sums[kWarps];
    cg::grid_group grid = cg::this_grid();
    const long long nthreads = (long long)gridDim.x * kThreads;
    const long long gtid = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (gtid == 0) {
        *a.n_long = 0;
        if (a.stats)
            for (int i = 0; i < 4; ++i) a.stats[i] = 0;
    }
    node_pass(a, gtid, nthreads);
    grid.sync();
    convert_pass(a, gtid, nthreads);
    grid.sync();
    const int L = __ldcg(a.n_long);
    if (L == 0) return;
    if (gtid == 0 && a.stats) a.stats[0] = L;
    long_path(a, L, sh, wcnt, sbase, warp_sums);
}

constexpr int kMaxDevices = 64;

// Blocks of a cooperative launch: every block resident at once.
int max_grid(int* grid) {
    static int cached[kMaxDevices] = {0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices && cached[dev] > 0) {
        *grid = cached[dev];
        return 0;
    }
    int sms = 0, per_sm = 0, coop = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess
        || (e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                       dev)) != cudaSuccess
        || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, unitig_sum_kernel, kThreads, 0)) != cudaSuccess)
        return (int)e;
    if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    *grid = sms * per_sm;
    if (dev < kMaxDevices) cached[dev] = *grid;
    return 0;
}

long long align16(long long b) { return (b + 15) & ~15ll; }

// num_u rounded up to 32 pairs (256 bytes), so that no two replicas of a
// unitig share a cache line
long long stride_of(long long num_u) { return (num_u + 31) & ~31ll; }

// Byte offsets of the work scratch's arrays; [kParts] is its size.
enum { kSlot, kList, kLen, kOff, kCfirst, kNLong, kGcnt, kGpre, kGtot,
       kVals, kCslot, kCsum, kRec, kParts };

void work_layout(long long n, long long num_u, int grid, long long* at) {
    const long long chunks = n / kChunk + num_u + 1;
    const long long sizes[kParts] = {
        4 * num_u, 4 * num_u, 8 * (num_u + 1), 8 * (num_u + 1),
        8 * (num_u + 1), 16, 4ll * grid * kGroup, 8ll * grid * kGroup,
        8 * kGroup, 4 * n, 4 * chunks, 8 * chunks, 16 * chunks};
    long long b = 0;
    for (int i = 0; i < kParts; ++i) {
        at[i] = b;
        b += align16(sizes[i]);
    }
    at[kParts] = b;
}

bool valid(long long n, long long num_u) {
    return n >= 0 && n < (1ll << 32) && num_u >= 0 && num_u < 0x7fffffffLL;
}

}  // namespace

// The scratch of a call: sizes[0] bytes that must be zero on entry (and
// are zero again on exit), sizes[1] bytes of work space.
extern "C" int platanus_unitig_sum_scratch(long long n, long long num_u,
                                           long long* sizes) {
    if (!valid(n, num_u)) return (int)cudaErrorInvalidValue;
    int grid = 0;
    const int rc = max_grid(&grid);
    if (rc) return rc;
    long long at[kParts + 1];
    work_layout(n, num_u, grid, at);
    sizes[0] = align16(kReplicas * stride_of(num_u) * (n > kTop ? 12ll : 8ll));
    sizes[1] = at[kParts];
    return 0;
}

// out[num_u] float32: each unitig's sequential float32 sum of counts in id
// order over uid[n], counts[n] (int64); ulen[num_u] int64 (or null): each
// unitig's node count; stats (or null): 4 int64. One cooperative launch
// on `stream`. The zeroed scratch is left zero; two calls may share the
// scratch only on one stream, in order.
extern "C" int platanus_unitig_sum(const void* uid, const void* counts,
                                   long long n, long long num_u, void* out,
                                   void* ulen, void* stats, void* zeroed,
                                   long long zeroed_bytes, void* work,
                                   long long work_bytes, void* stream) {
    long long sizes[2];
    int rc = platanus_unitig_sum_scratch(n, num_u, sizes);
    if (rc) return rc;
    if (zeroed_bytes < sizes[0] || work_bytes < sizes[1])
        return (int)cudaErrorInvalidValue;
    if (num_u == 0) return 0;
    int most = 0;
    if ((rc = max_grid(&most))) return rc;
    long long at[kParts + 1];
    work_layout(n, num_u, most, at);
    auto* w = static_cast<char*>(work);
    Args a;
    a.uid = static_cast<const long long*>(uid);
    a.c = static_cast<const long long*>(counts);
    a.n = n;
    a.num_u = num_u;
    a.out = static_cast<float*>(out);
    a.ulen = static_cast<long long*>(ulen);
    a.stats = static_cast<long long*>(stats);
    a.stride = stride_of(num_u);
    a.pair = static_cast<float2*>(zeroed);
    a.cnt = reinterpret_cast<unsigned*>(a.pair + kReplicas * a.stride);
    a.exact_counts = n > kTop;
    a.slot = reinterpret_cast<int*>(w + at[kSlot]);
    a.list = reinterpret_cast<int*>(w + at[kList]);
    a.len = reinterpret_cast<long long*>(w + at[kLen]);
    a.off = reinterpret_cast<long long*>(w + at[kOff]);
    a.cfirst = reinterpret_cast<long long*>(w + at[kCfirst]);
    a.n_long = reinterpret_cast<int*>(w + at[kNLong]);
    a.gcnt = reinterpret_cast<int*>(w + at[kGcnt]);
    a.gpre = reinterpret_cast<long long*>(w + at[kGpre]);
    a.gtot = reinterpret_cast<long long*>(w + at[kGtot]);
    a.vals = reinterpret_cast<float*>(w + at[kVals]);
    a.cslot = reinterpret_cast<int*>(w + at[kCslot]);
    a.csum = reinterpret_cast<long long*>(w + at[kCsum]);
    a.rec = reinterpret_cast<int4*>(w + at[kRec]);
    const long long work_ids = n > 2 * num_u ? n : 2 * num_u;
    const long long want = (work_ids + 8ll * kThreads - 1) / (8ll * kThreads);
    const int grid = (int)(want < most ? (want > 0 ? want : 1) : most);
    void* params[] = {&a};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)unitig_sum_kernel, dim3(grid), dim3(kThreads), params,
        0, static_cast<cudaStream_t>(stream));
}
