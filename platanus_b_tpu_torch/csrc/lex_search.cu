// lex_search: lexicographic binary search of multi-lane keys for Hopper.
//
// Port of the JAX package's bulk search (platanus_b_tpu/ops/search.py:26
// _lower_bound and :81 _upper_bound, each a lax.fori_loop that XLA
// compiles into one device program under _lookup_jit, :48, and
// lookup_range_jit, :103). A key is L int64 lanes, lane 0 most
// significant, compared as signed 64-bit integers (ops/keys.py flips each
// lane's sign bit so that signed order is the reference's unsigned word
// order).
//
// Two modes, each step for step the port's plain version in ops/search.py:
// - LOOKUP (_bound, then lookup's equality test): the table's first n
//   rows; `steps` = max(1, ceil(log2(n + 1))) steps of
//     active = lo < hi; mid = (lo + hi) >> 1;
//     if active: query <= table[mid] ? hi = mid : lo = mid + 1
//   from lo = 0, hi = n; out = lo if lo < n and table[lo] == query, else -1.
// - RANGE (_bound_padded, both bounds of lookup_range): a table of `cap`
//   rows of which the first n are live and every row at or past n reads
//   as the all-ones SENTINEL key; `steps` = max(1, ceil(log2(cap + 1)))
//   steps with no convergence guard:
//     mid = (lo + hi) >> 1; row = clip(mid, 0, cap - 1); past = row >= n;
//     lower: go_left = past or query <= table[row]
//     upper: go_left = past ? query < SENTINEL : query < table[row]
//     go_left ? hi = mid : lo = mid + 1
//   from lo = 0, hi = n. lo may pass n and mid may pass cap (the
//   reference's padded-table rules, which give a query at or above the
//   last row of a full table a bound of n + 1); these are ported as they
//   are, not as a textbook search.
//
// Bound: memory. Each query reads its L lanes and writes one (LOOKUP) or
// two (RANGE) int64; the table's rows count once. But a search is a chain
// of `steps` dependent gathers (21-23 at a bacterial graph's size), so what
// holds a query back is the latency of that chain and the loads in flight.
// The design:
// - The top levels in shared memory. The first `depth` steps of every
//   search touch only the fixed midpoints of [0, n), an implicit tree: the
//   node of heap index j (root 1, children 2j and 2j + 1) is reached by
//   the path of j's bits, and its (lo, hi), and so its row, follow from
//   that path alone. A persistent grid loads the tree's rows once a block
//   (2^depth - 1 rows in kTreeBytes: depth 9 at one lane, 8 at two).
//   Whether a node's interval is empty (LOOKUP) or its row is past n
//   (RANGE) is worked out from (lo, hi), which every query carries anyway;
//   such a node's row is never stored or read. The budget is small on
//   purpose: L1 holds the top levels as well, and on the main path's
//   lookups (nearly sorted runs of queries, a warp's lanes sharing their
//   paths) a 32 KB tree a block ran 1.3-1.6x as long as none, the shared
//   memory taking L1's room for the middle levels; 4 KB ran as fast as
//   none (lex_search_in_turns.py, NVIDIA H100).
// - One vector load a row: 16 bytes at two lanes, two at four.
// - kQ queries a thread, interleaved, where that measured faster (one-lane
//   lookups: 4): each step issues the loads of all of them before it
//   compares, so that several gathers are in flight per thread.
// - LOOKUP keeps the equality of its last `hi = mid` compare: when the
//   search ends, lo is that mid (or n), so the final test needs no load.
// - One descent for both bounds in RANGE mode: while the lower and the
//   upper search stand at the same mid they read the same row, and one
//   three-way compare decides both; they part only where the query meets
//   its run (or the padding).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSentinel = 0x7fffffffffffffffLL;
constexpr int kLookup = 0;
constexpr int kRange = 1;
// The tree's budget of shared memory a block, and the queries a thread
// (0: by mode and width, queries_per_thread); -D overrides them for
// lex_search_in_turns.py's sweep.
#ifndef LEX_TREE_BYTES
#define LEX_TREE_BYTES 4096
#endif
#ifndef LEX_QUERIES
#define LEX_QUERIES 0
#endif
constexpr int kTreeBytes = LEX_TREE_BYTES;

struct Params {
    const long long* table;    // (cap, L)
    const long long* queries;  // (M, L)
    long long M;
    int n, cap, L, steps, depth;
    long long* out0;
    long long* out1;
};

// A key of kL lanes in registers (kL = 1..4), or kL = 0: a pointer to L
// lanes in memory.
template <int kL>
struct Key {
    long long v[kL];
    __device__ __forceinline__ void query(const long long* p, int) {
#pragma unroll
        for (int j = 0; j < kL; ++j) v[j] = p[j];
    }
    // A table or tree row: 16-byte aligned at an even width.
    template <bool kShared>
    __device__ __forceinline__ void row(const long long* p, int) {
        if constexpr (kL % 2 == 0) {
#pragma unroll
            for (int j = 0; j < kL; j += 2) {
                const longlong2 t =
                    kShared ? *reinterpret_cast<const longlong2*>(p + j)
                            : __ldg(reinterpret_cast<const longlong2*>(p + j));
                v[j] = t.x;
                v[j + 1] = t.y;
            }
        } else {
#pragma unroll
            for (int j = 0; j < kL; ++j) v[j] = kShared ? p[j] : __ldg(p + j);
        }
    }
    __device__ __forceinline__ int cmp(const Key& r, int) const {
#pragma unroll
        for (int j = 0; j < kL; ++j)
            if (v[j] != r.v[j]) return v[j] < r.v[j] ? -1 : 1;
        return 0;
    }
    __device__ __forceinline__ bool below_sentinel(int) const {
        bool below = false;
#pragma unroll
        for (int j = 0; j < kL; ++j) below |= v[j] != kSentinel;
        return below;
    }
};

template <>
struct Key<0> {
    const long long* p;
    __device__ __forceinline__ void query(const long long* q, int) { p = q; }
    template <bool kShared>
    __device__ __forceinline__ void row(const long long* r, int) { p = r; }
    __device__ __forceinline__ int cmp(const Key& r, int L) const {
        for (int j = 0; j < L; ++j) {
            const long long a = p[j], t = r.p[j];
            if (a != t) return a < t ? -1 : 1;
        }
        return 0;
    }
    __device__ __forceinline__ bool below_sentinel(int L) const {
        for (int j = 0; j < L; ++j)
            if (p[j] != kSentinel) return true;
        return false;
    }
};

// Queries a thread (lex_search_in_turns.py: 4 ran fastest for one-lane
// lookups, 1 for two-lane ones; ranges ran within 2 % at 1 and at 4).
template <int kMode, int kL>
__host__ __device__ constexpr int queries_per_thread() {
    if (kL == 0) return 1;
    if (LEX_QUERIES > 0) return LEX_QUERIES;
    return kMode == kLookup && kL == 1 ? 4 : 1;
}

// The rows of the tree's 2^depth - 1 nodes, node j at tree[(j - 1) L].
template <int kMode>
__device__ void load_tree(const Params& p, long long* tree, int L) {
    const int nodes = (1 << p.depth) - 1;
    for (int j = threadIdx.x + 1; j <= nodes; j += blockDim.x) {
        int lo = 0, hi = p.n;
        bool open = true;
        for (int b = 30 - __clz(j); b >= 0; --b) {
            if (kMode == kLookup && lo >= hi) {
                open = false;
                break;
            }
            const int mid = (lo + hi) >> 1;
            if ((j >> b) & 1) lo = mid + 1;
            else hi = mid;
        }
        int row;
        if (kMode == kLookup) {
            if (!open || lo >= hi) continue;
            row = (lo + hi) >> 1;
        } else {
            row = min((lo + hi) >> 1, p.cap - 1);
            if (row >= p.n) continue;
        }
        for (int l = 0; l < L; ++l)
            tree[(j - 1) * L + l] = p.table[(long long)row * L + l];
    }
}

template <int kL, int kQ>
__device__ void lookup_group(const Params& p, const long long* tree,
                             long long base, int L) {
    Key<kL> q[kQ];
    int lo[kQ], hi[kQ], j[kQ];
    bool eq[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
        const long long i = base + k * kThreads;
        lo[k] = 0;
        hi[k] = i < p.M ? p.n : 0;
        j[k] = 1;
        eq[k] = false;
        q[k].query(p.queries + (i < p.M ? i : 0) * L, L);
    }
    int t = 0;
    for (; t < p.depth; ++t) {
        Key<kL> r[kQ];
#pragma unroll
        for (int k = 0; k < kQ; ++k)
            if (lo[k] < hi[k]) r[k].template row<true>(tree + (j[k] - 1) * L, L);
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
            if (lo[k] >= hi[k]) continue;
            const int mid = (lo[k] + hi[k]) >> 1;
            const int c = q[k].cmp(r[k], L);
            if (c <= 0) {
                hi[k] = mid;
                eq[k] = c == 0;
                j[k] = 2 * j[k];
            } else {
                lo[k] = mid + 1;
                j[k] = 2 * j[k] + 1;
            }
        }
    }
    for (; t < p.steps; ++t) {
        bool any = false;
        Key<kL> r[kQ];
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
            if (lo[k] >= hi[k]) continue;
            any = true;
            r[k].template row<false>(
                p.table + (long long)((lo[k] + hi[k]) >> 1) * L, L);
        }
        if (!any) break;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
            if (lo[k] >= hi[k]) continue;
            const int mid = (lo[k] + hi[k]) >> 1;
            const int c = q[k].cmp(r[k], L);
            if (c <= 0) {
                hi[k] = mid;
                eq[k] = c == 0;
            } else {
                lo[k] = mid + 1;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
        const long long i = base + k * kThreads;
        if (i < p.M) p.out0[i] = (lo[k] < p.n && eq[k]) ? lo[k] : -1;
    }
}

// One step of both bounds of kQ queries, rows from the tree (kShared) or
// the table.
template <int kL, int kQ, bool kShared>
__device__ __forceinline__ void range_step(const Params& p,
                                           const long long* src,
                                           const Key<kL>* q, const bool* bs,
                                           int* lo_l, int* hi_l, int* j_l,
                                           int* lo_u, int* hi_u, int* j_u,
                                           int L) {
    int mid_l[kQ], mid_u[kQ];
    bool past_l[kQ], past_u[kQ], same[kQ];
    Key<kL> r_l[kQ], r_u[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
        mid_l[k] = (lo_l[k] + hi_l[k]) >> 1;
        mid_u[k] = (lo_u[k] + hi_u[k]) >> 1;
        const int row_l = min(mid_l[k], p.cap - 1);
        const int row_u = min(mid_u[k], p.cap - 1);
        past_l[k] = row_l >= p.n;
        past_u[k] = row_u >= p.n;
        same[k] = mid_l[k] == mid_u[k];
        if (!past_l[k])
            r_l[k].template row<kShared>(
                src + (kShared ? (long long)(j_l[k] - 1) : row_l) * L, L);
        if (!past_u[k] && !same[k])
            r_u[k].template row<kShared>(
                src + (kShared ? (long long)(j_u[k] - 1) : row_u) * L, L);
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
        const int c_l = past_l[k] ? 0 : q[k].cmp(r_l[k], L);
        const int c_u = past_u[k] ? 0 : (same[k] ? c_l : q[k].cmp(r_u[k], L));
        const bool left_l = past_l[k] || c_l <= 0;
        const bool left_u = past_u[k] ? bs[k] : c_u < 0;
        if (left_l) hi_l[k] = mid_l[k];
        else lo_l[k] = mid_l[k] + 1;
        if (left_u) hi_u[k] = mid_u[k];
        else lo_u[k] = mid_u[k] + 1;
        j_l[k] = 2 * j_l[k] + (left_l ? 0 : 1);
        j_u[k] = 2 * j_u[k] + (left_u ? 0 : 1);
    }
}

template <int kL, int kQ>
__device__ void range_group(const Params& p, const long long* tree,
                            long long base, int L) {
    Key<kL> q[kQ];
    bool bs[kQ];
    int lo_l[kQ], hi_l[kQ], j_l[kQ], lo_u[kQ], hi_u[kQ], j_u[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
        const long long i = base + k * kThreads;
        q[k].query(p.queries + (i < p.M ? i : 0) * L, L);
        bs[k] = q[k].below_sentinel(L);
        lo_l[k] = lo_u[k] = 0;
        hi_l[k] = hi_u[k] = p.n;
        j_l[k] = j_u[k] = 1;
    }
    int t = 0;
    for (; t < p.depth; ++t)
        range_step<kL, kQ, true>(p, tree, q, bs, lo_l, hi_l, j_l, lo_u, hi_u,
                                 j_u, L);
    for (; t < p.steps; ++t)
        range_step<kL, kQ, false>(p, p.table, q, bs, lo_l, hi_l, j_l, lo_u,
                                  hi_u, j_u, L);
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
        const long long i = base + k * kThreads;
        if (i < p.M) {
            p.out0[i] = lo_l[k];
            p.out1[i] = lo_u[k];
        }
    }
}

template <int kMode, int kL>
__global__ void __launch_bounds__(kThreads) lex_search(const Params p) {
    extern __shared__ __align__(16) long long tree[];
    constexpr int kQ = queries_per_thread<kMode, kL>();
    const int L = kL ? kL : p.L;
    load_tree<kMode>(p, tree, L);
    __syncthreads();
    const long long per_block = (long long)kThreads * kQ;
    for (long long base = blockIdx.x * per_block + threadIdx.x; base < p.M;
         base += gridDim.x * per_block) {
        if constexpr (kMode == kLookup) lookup_group<kL, kQ>(p, tree, base, L);
        else range_group<kL, kQ>(p, tree, base, L);
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

template <int kMode, int kL>
cudaError_t launch(const Params& p, cudaStream_t s) {
    const size_t smem = sizeof(long long) * (size_t)((1 << p.depth) - 1)
                        * p.L;
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, lex_search<kMode, kL>, kThreads, smem);
    if (e != cudaSuccess) return e;
    constexpr int kQ = queries_per_thread<kMode, kL>();
    const long long need = (p.M + (long long)kThreads * kQ - 1)
                           / ((long long)kThreads * kQ);
    const long long most = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
    const int grid = (int)(need < most ? need : most);
    lex_search<kMode, kL><<<grid, kThreads, smem, s>>>(p);
    return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(const Params& p, cudaStream_t s) {
    switch (p.L) {
    case 1: return launch<kMode, 1>(p, s);
    case 2: return launch<kMode, 2>(p, s);
    case 3: return launch<kMode, 3>(p, s);
    case 4: return launch<kMode, 4>(p, s);
    default: return launch<kMode, 0>(p, s);
    }
}

}  // namespace

// mode 0 (LOOKUP): out0[M] = row of each query among the first n rows, or
// -1. mode 1 (RANGE): out0[M], out1[M] = lower and upper bounds in a
// padded table of cap rows, n live. table (cap, L), 16-byte aligned;
// queries (M, L); n and cap below 2^30.
extern "C" int platanus_lex_search(const void* table, const void* queries,
                                   long long M, int L, long long n,
                                   long long cap, int steps, int mode,
                                   void* out0, void* out1, void* stream) {
    if (M < 0 || L < 1 || n < 0 || cap < n || cap >= (1ll << 30)
        || steps < 1 || (mode != kLookup && mode != kRange)
        || (mode == kRange && (cap < 1 || out1 == nullptr))
        || (mode == kLookup && n < 1)
        || reinterpret_cast<uintptr_t>(table) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (M == 0) return 0;
    // the deepest tree whose rows fit in kTreeBytes, no deeper than the
    // search
    int depth = 0;
    while (depth < steps
           && (long long)((2 << depth) - 1) * L * 8 <= kTreeBytes)
        ++depth;
    const Params p{static_cast<const long long*>(table),
                   static_cast<const long long*>(queries), M, (int)n,
                   (int)cap, L, steps, depth,
                   static_cast<long long*>(out0),
                   static_cast<long long*>(out1)};
    auto s = static_cast<cudaStream_t>(stream);
    return (int)(mode == kLookup ? launch_mode<kLookup>(p, s)
                                 : launch_mode<kRange>(p, s));
}
