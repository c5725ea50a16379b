// lex_search: lexicographic binary search of multi-lane keys for Hopper.
//
// Port of the JAX package's bulk search (platanus_b_tpu/ops/search.py:26
// _lower_bound and :81 _upper_bound, each a lax.fori_loop that XLA
// compiles into one device program under _lookup_jit, :48, and
// lookup_range_jit, :103). A key is L int64 lanes, lane 0 most
// significant, compared as signed 64-bit integers (ops/keys.py flips each
// lane's sign bit so that signed order is the reference's unsigned word
// order). One thread searches one query with its lanes in registers
// (L <= 4; wider keys compare lane by lane from memory) and walks the
// whole search; no step is shared between threads.
//
// Two modes, each step for step the port's plain version in ops/search.py:
// - LOOKUP (_bound, then lookup's equality test): the table's first n
//   rows; `steps` = max(1, ceil(log2(n + 1))) steps of
//     active = lo < hi; mid = (lo + hi) >> 1;
//     row = table[clip(mid, 0, n - 1)];
//     if active: query <= row ? hi = mid : lo = mid + 1
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
// two (RANGE) int64; the table's rows are read log2(n) times a query but
// count once. A step is a dependent gather, so a query's latency is
// `steps` round trips to L2 or memory; enough queries in flight hide it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSentinel = 0x7fffffffffffffffLL;
constexpr int kLookup = 0;
constexpr int kRange = 1;

// Lexicographic compare of the query with table row r: -1, 0 or 1.
template <int kL>
struct Query {
    long long lane[kL];
    __device__ void load(const long long* __restrict__ q, int) {
#pragma unroll
        for (int j = 0; j < kL; ++j) lane[j] = q[j];
    }
    __device__ int cmp(const long long* __restrict__ row, int) const {
#pragma unroll
        for (int j = 0; j < kL; ++j) {
            const long long t = row[j];
            if (lane[j] != t) return lane[j] < t ? -1 : 1;
        }
        return 0;
    }
    __device__ bool below_sentinel(int) const {
        bool below = false;
#pragma unroll
        for (int j = 0; j < kL; ++j) below |= lane[j] != kSentinel;
        return below;
    }
};

// Any L: the lanes stay in memory.
template <>
struct Query<0> {
    const long long* q;
    __device__ void load(const long long* __restrict__ p, int) { q = p; }
    __device__ int cmp(const long long* __restrict__ row, int L) const {
        for (int j = 0; j < L; ++j) {
            const long long a = q[j], t = row[j];
            if (a != t) return a < t ? -1 : 1;
        }
        return 0;
    }
    __device__ bool below_sentinel(int L) const {
        for (int j = 0; j < L; ++j)
            if (q[j] != kSentinel) return true;
        return false;
    }
};

struct Params {
    const long long* table;    // (cap, L)
    const long long* queries;  // (M, L)
    long long M, n, cap;
    int L, steps, mode;
    long long* out0;
    long long* out1;
};

template <int kL>
__global__ void __launch_bounds__(kThreads) lex_search(const Params p) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.M) return;
    const long long* __restrict__ table = p.table;
    const int L = p.L;
    const long long n = p.n;
    Query<kL> q;
    q.load(p.queries + i * L, L);
    if (p.mode == kLookup) {
        long long lo = 0, hi = n;
        for (int t = 0; t < p.steps; ++t) {
            if (lo < hi) {
                const long long mid = (lo + hi) >> 1;
                if (q.cmp(table + mid * L, L) <= 0) hi = mid;
                else lo = mid + 1;
            }
        }
        p.out0[i] = (lo < n && q.cmp(table + lo * L, L) == 0) ? lo : -1;
        return;
    }
    const bool below_sent = q.below_sentinel(L);
    long long lo_l = 0, hi_l = n, lo_u = 0, hi_u = n;
    for (int t = 0; t < p.steps; ++t) {
        long long mid = (lo_l + hi_l) >> 1;
        long long row = mid < 0 ? 0 : (mid < p.cap ? mid : p.cap - 1);
        const bool left_l = row >= n || q.cmp(table + row * L, L) <= 0;
        if (left_l) hi_l = mid;
        else lo_l = mid + 1;
        mid = (lo_u + hi_u) >> 1;
        row = mid < 0 ? 0 : (mid < p.cap ? mid : p.cap - 1);
        const bool left_u = row >= n ? below_sent
                                     : q.cmp(table + row * L, L) < 0;
        if (left_u) hi_u = mid;
        else lo_u = mid + 1;
    }
    p.out0[i] = lo_l;
    p.out1[i] = lo_u;
}

}  // namespace

// mode 0 (LOOKUP): out0[M] = row of each query among the first n rows, or
// -1. mode 1 (RANGE): out0[M], out1[M] = lower and upper bounds in a
// padded table of cap rows, n live. table (cap, L), queries (M, L).
extern "C" int platanus_lex_search(const void* table, const void* queries,
                                   long long M, int L, long long n,
                                   long long cap, int steps, int mode,
                                   void* out0, void* out1, void* stream) {
    if (M < 0 || L < 1 || n < 0 || cap < n || steps < 1
        || (mode != kLookup && mode != kRange)
        || (mode == kRange && (cap < 1 || out1 == nullptr))
        || (mode == kLookup && n < 1))
        return (int)cudaErrorInvalidValue;
    if (M == 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    const Params p{static_cast<const long long*>(table),
                   static_cast<const long long*>(queries), M, n, cap, L, steps,
                   mode, static_cast<long long*>(out0),
                   static_cast<long long*>(out1)};
    const long long blocks = (M + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks);
    switch (L) {
    case 1: lex_search<1><<<grid, kThreads, 0, s>>>(p); break;
    case 2: lex_search<2><<<grid, kThreads, 0, s>>>(p); break;
    case 3: lex_search<3><<<grid, kThreads, 0, s>>>(p); break;
    case 4: lex_search<4><<<grid, kThreads, 0, s>>>(p); break;
    default: lex_search<0><<<grid, kThreads, 0, s>>>(p);
    }
    return (int)cudaGetLastError();
}
