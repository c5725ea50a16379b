// chain_dp: colinear chaining DP of anchor groups for Hopper.
//
// Port of the JAX package's chaining program _chain_kernel
// (platanus_b_tpu/models/longread.py:31), a vmapped lax.fori_loop that XLA
// compiles into one device loop. For each group b and each step
// i = 1 .. n[b]-1, in order:
//   a link from j = i - h (h = 1 .. H) is ok iff j >= 0, 0 < dq, 0 < dt,
//   dq <= max_gap and dt <= max_gap (dq = q[i] - q[j], dt = t[i] - t[j],
//   int32); its candidate is (f[j] + min(dq, dt, kk)) - cost[|dq - dt|],
//   each operation rounded to float32 (no FMA), with cost the float32
//   table of ops/gapcost.py (XLA's values, never recomputed here); a link
//   that is not ok scores -inf;
//   the pick is the first maximum over h, as argmax takes it: on equal
//   values the smallest h, which is the nearest j;
//   if the pick is strictly above f[i], f[i] and prev[i] take its value
//   and its j.
// f starts at kk and prev at -1 everywhere, padding included; step i only
// writes f[i], so f[i] is still kk when step i compares with it.
//
// Bound: the serial chain of a group's n-1 dependent steps (step i reads
// f[i-1]), not bytes or operations: a bucket's bytes and its
// B * steps * H links take microseconds on the card, and the chain of its
// longest group is n-1 steps long whatever the card does beside it. What
// must stay on the chain from f[i-1] to f[i] is three dependent float
// operations, about 4 cycles each (C = 12 cycles a step):
//   the add       f[i-1] + gain(i, 1),
//   the subtract  of cost(i, 1),
//   the max       with R(i), the best of every other candidate and kk.
// Everything else is taken off it:
// - The split pick. Step i combines the kD = 2 nearest candidates (h = 1,
//   2), which every lane computes alike from f[i-1] and f[i-2], with M(i),
//   the maximum over h = 3 .. H. M(i) reads f[i-3] and older only, so its
//   warp reduction runs two steps ahead of the step that uses it, beside
//   the chain; R(i) = max(cand(i, 2), M(i)) reads f[i-2] and older, so it
//   is ready before f[i-1] is. (kD 1, 3 and 4 measured slower.)
// - Why the split is exact. A maximum of floats is exact and does not
//   depend on the order it is taken in, and argmax's first maximum of
//   [cand(1), .., cand(kD), M] (on equal values the earlier entry wins)
//   is the first maximum over all h when M is the first maximum over
//   h > kD: a tie between a near h and M goes to the near h. Every far
//   candidate is raised to kk before the reduction: a value <= kk never
//   makes a link (the pick must be strictly above f[i] = kk), and a pick
//   above kk keeps its value and its smallest h. So f[i] = max(cand(1),
//   R(i)) with R(i) >= kk, and the raised values are all positive, so
//   their float bits order as unsigned integers (-0, +0 and -inf all
//   become kk): one __reduce_max_sync on the bits, and a __ballot_sync of
//   the lanes holding the maximum, whose nearest j is M's. A link that is
//   not ok has cost +inf, so its candidate is -inf; if no candidate is
//   above kk, no link is made.
// - prev leaves the steps. Lane i mod 32 keeps f[i] and M(i)'s ballot;
//   after each tile of 32 steps every lane finds its step's prev at once
//   (the first near h whose candidate, recomputed from the same operands,
//   equals f[i], else M(i)'s j, or -1 when f[i] is kk), and the warp
//   stores the tile's f and prev coalesced.
// - No load and no link arithmetic sits on the chain. Each group has one
//   chain warp, which runs the steps, and kLinkWarps link warps, which
//   compute every f-independent part of the next tile's links, ok,
//   float(gain) and cost[gap], into a double buffer in shared memory, so
//   that a step reads its parts at addresses known in advance. The gap cost
//   table is staged in shared memory once per block by cp.async; q and t
//   by cp.async into a ring of four 32-anchor tiles, two tiles ahead of the
//   steps. One named barrier a tile passes the buffers between the warps.
//
// Design:
// - kGroups groups per block, each a chain warp and kLinkWarps link warps
//   (each warp on its own or shared scheduler); each group runs its own
//   n-1 steps, not the bucket's cap-1.
// - A lookback of at most 32 (every preset's is 25) is held by the chain
//   warp's lanes: lane l holds f[j] for the latest j = l mod 32 computed so
//   far, so the window never shifts; at step i lane i mod 32 takes f[i] in
//   place of f[i - 32]. Its offset from a step is known from l and the step.
// - A longer lookback, or a table that shared memory cannot hold, reads
//   the window from memory instead (chain_dp_mem, one warp a group), each
//   lane taking the offsets h = lane + 1 + 32 k: q and t through the
//   read-only cache, f from the warp's own stores, one __syncwarp a step.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // groups per block of chain_dp_mem
constexpr int kGroups = 2;         // groups per block of chain_dp_regs
constexpr int kLinkWarps = 2;      // link warps a group, beside its chain
                                   // warp
constexpr int kTile = 32;          // steps a tile; lane l keeps step l's f
constexpr int kRing = 4 * kTile;   // staged anchors a group: tiles k-1 .. k+2
constexpr int kD = 2;              // near candidates on the chain
constexpr int kMaxSmem = 232448;   // a block's shared memory on the H100

struct Params {
    const int* q;
    const int* t;
    const int* n;
    const float* cost;
    float* f;
    int* prev;
    int B, cap, H, max_gap, kk;
};

// A group's shared memory in chain_dp_regs; the gap cost table follows the
// kGroups of them. The link parts are double-buffered by tile.
struct GroupSmem {
    float2 link[2][kTile * kTile];  // [r][lane]: (gain, cost) of the lane's
                                    // window link to step s0 + r + kD
    float2 near[2][kTile * kD];     // [r][d]: (gain, cost) of the link
                                    // from s0 + r - d - 1 to s0 + r
    int2 qt[kRing];                 // anchor i's (q, t) at i mod kRing
};

// The link from anchor (qj, tj) to (qi, ti): its gap |dq - dt| and, in
// `gain`, min(dq, dt, kk); or gap -1 if it is not a link. Differences wrap
// as int32 does in the reference.
__device__ __forceinline__ int link_gap(int qi, int ti, int qj, int tj,
                                        bool in_window, const Params& p,
                                        int& gain) {
    const int dq = (int)((unsigned)qi - (unsigned)qj);
    const int dt = (int)((unsigned)ti - (unsigned)tj);
    const int lo = min(dq, dt), hi = max(dq, dt);
    gain = min(lo, p.kk);
    // ok: 0 < dq, dt <= max_gap; then |dq - dt| = hi - lo < max_gap
    return in_window && lo > 0 && hi <= p.max_gap
               ? (int)((unsigned)hi - (unsigned)lo) : -1;
}

// The f-independent parts of a link, (float(gain), cost[gap]), or (0, +inf)
// if it is not a link, so that (f + gain) - cost is its candidate or -inf.
__device__ __forceinline__ float2 link_parts(int gain, int gap,
                                             const float* cost) {
    return gap < 0 ? make_float2(0.0f, INFINITY)
                   : make_float2(__int2float_rn(gain), cost[gap]);
}

__device__ __forceinline__ float candidate(float fj, float2 parts) {
    return __fsub_rn(__fadd_rn(fj, parts.x), parts.y);
}

// The warp's first maximum over each lane's best (v, h): the largest v, and
// the smallest h among the lanes that hold it (argmax's tie rule, given
// that each lane's h is its smallest with value v).
__device__ __forceinline__ float warp_pick(float v, int h, int& best_h) {
    const unsigned u = v == 0.0f ? 0u : __float_as_uint(v);  // -0 as +0
    const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    const unsigned m = __reduce_max_sync(kFull, k);
    best_h = (int)__reduce_min_sync(kFull, k == m ? (unsigned)h : 0xffffffffu);
    return __uint_as_float((m & 0x80000000u) ? (m & 0x7fffffffu) : ~m);
}

// Positions that no step writes (0 and n .. cap-1) keep the initial values.
__device__ __forceinline__ void init_rest(const Params& p, float* f, int* prev,
                                          int n, float kkf, int lane) {
    for (int i = lane; i < p.cap; i += 32) {
        if (i == 0 || i >= n) {
            f[i] = kkf;
            prev[i] = -1;
        }
    }
}

// Tile k's anchors below n into the group's ring, as one cp.async group.
__device__ __forceinline__ void stage_tile(GroupSmem& w, const int* q,
                                           const int* t, int k, int n,
                                           int lane) {
    const int i = k * kTile + lane;
    if (i < n) {
        const unsigned dq = (unsigned)__cvta_generic_to_shared(&w.qt[i % kRing].x);
        const unsigned dt = (unsigned)__cvta_generic_to_shared(&w.qt[i % kRing].y);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(dq), "l"(q + i) : "memory");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(dt), "l"(t + i) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The gap cost table's `len` floats into shared memory by every thread of
// the block, as cp.async copies of 16 bytes where `src` allows them.
__device__ __forceinline__ void stage_cost(float* dst, const float* src,
                                           int len) {
    const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
    const int wide = ((size_t)src & 15) ? 0 : len / 4;
    for (int i = threadIdx.x; i < wide; i += blockDim.x)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(base + 16 * i), "l"(src + 4 * i) : "memory");
    for (int i = 4 * wide + threadIdx.x; i < len; i += blockDim.x)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(base + 4 * i), "l"(src + i) : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The barrier of group g's warps: one a tile, after which the chain warp
// reads the tile the link warps have just written, and the link warps
// write the buffer the chain warp has just read.
__device__ __forceinline__ void group_sync(int g) {
    asm volatile("bar.sync %0, %1;\n"
                 :: "r"(g + 1), "n"(32 * (1 + kLinkWarps)) : "memory");
}

// Link warp `lw`'s share of the tile of steps s0 .. s0+31, into buffer
// `buf`: rows r = lw * kRows .. + kRows-1, each lane l the link from its
// window anchor to step s0 + r + kD, and (link warp 0) lane l's near links
// of step s0 + l. Lane l's window anchor is s0 + l - 32 up to step s0 + l
// and s0 + l after it; the ring holds anchors s0 - 32 .. s0 + 63. Every
// load comes before the first store, in three passes (ring reads and
// integer work, table gathers, stores), so that the compiler, which cannot
// tell the buffers apart, keeps all of them in flight.
__device__ __forceinline__ void link_tile(GroupSmem& w, int buf, int s0,
                                          int lw, int lane, const Params& p,
                                          const float* cost) {
    constexpr int kRows = kTile / kLinkWarps;
    constexpr int kLinks = kRows + kD;  // the window's, then the near ones
    int gain[kLinks], gap[kLinks];      // gap -1: not a link
    const int s = s0 + lane;
    const int jo = s - kTile;
    const int2 as = w.qt[s % kRing], ao = w.qt[jo & (kRing - 1)];
    const int r0 = lw * kRows;
#pragma unroll
    for (int m = 0; m < kLinks; ++m) {
        int2 ai = as, aj;
        bool in_window;
        if (m < kRows) {
            const int r = r0 + m;
            const bool newer = r > lane;
            const int i = s0 + r + kD;
            ai = w.qt[i % kRing];
            aj = newer ? as : ao;
            in_window = (newer || jo >= 0) && i - (newer ? s : jo) <= p.H;
        } else {
            const int d = m - kRows + 1, j = s - d;
            aj = w.qt[j & (kRing - 1)];
            in_window = lw == 0 && j >= 0 && d <= p.H;
        }
        gap[m] = link_gap(ai.x, ai.y, aj.x, aj.y, in_window, p, gain[m]);
    }
    float2 parts[kLinks];
#pragma unroll
    for (int m = 0; m < kLinks; ++m) parts[m] = link_parts(gain[m], gap[m], cost);
#pragma unroll
    for (int m = 0; m < kRows; ++m)
        w.link[buf][(r0 + m) * kTile + lane] = parts[m];
    if (lw == 0) {
#pragma unroll
        for (int d = 0; d < kD; ++d) w.near[buf][lane * kD + d] = parts[kRows + d];
    }
}

// H <= 32: the window in the lanes, the split pick, tiles of 32 steps.
// Warp g runs group g's chain; warps g + kGroups * (1 + lw), lw = 0 ..
// kLinkWarps-1, compute its link parts a tile ahead, link warp 0 also
// staging its anchors.
__global__ void __launch_bounds__(kGroups * 32 * (1 + kLinkWarps), 1)
chain_dp_regs(Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = warp % kGroups;
    const int lw = warp / kGroups - 1;  // -1: the chain warp
    GroupSmem& w = reinterpret_cast<GroupSmem*>(smem)[g];
    float* cost = reinterpret_cast<float*>(smem + kGroups * sizeof(GroupSmem));
    stage_cost(cost, p.cost, p.max_gap + 1);

    const int b = blockIdx.x * kGroups + g;
    const size_t row = (size_t)min(b, p.B - 1) * p.cap;
    const int* q = p.q + row;
    const int* t = p.t + row;
    float* f = p.f + row;
    int* prev = p.prev + row;
    const int n = b < p.B ? min(max(__ldg(p.n + b), 0), p.cap) : 0;
    const float kkf = __int2float_rn(p.kk);
    if (b < p.B && lw < 0) init_rest(p, f, prev, n, kkf, lane);
    if (lw == 0 && n >= 2) {
        stage_tile(w, q, t, 0, n, lane);
        stage_tile(w, q, t, 1, n, lane);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the table and the first two tiles are in
    if (n < 2) return;  // the group's warps leave together
    const int tiles = (n + kTile - 1) / kTile;
    if (lw >= 0) {
        for (int k = 0; k < tiles; ++k) {
            // tile k+2 into the slot of tile k-2, which every link warp
            // has left (tile k reads tiles k-1 .. k+1)
            if (lw == 0) stage_tile(w, q, t, k + 2, n, lane);
            link_tile(w, k & 1, k * kTile, lw, lane, p, cost);
            // tile k+2's anchors are in before the barrier
            if (lw == 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
            group_sync(g);
        }
        return;
    }
    float wf = kkf;   // lane l: f of its window anchor, f[s0 + l] at a
                      // tile's end
    unsigned wm = 0;  // lane l: the ballot behind M(s0 + l)
    float fm[kD];     // f[s-1] .. f[s-kD]
    float M[kD];      // M(s) .. M(s+kD-1), raised to kk, and their ballots
    unsigned A[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) {
        fm[d] = kkf;
        M[d] = kkf;
        A[d] = 0;
    }
    for (int k = 0; k < tiles; ++k) {
        const int s0 = k * kTile;
        group_sync(g);  // tile k's link parts are written
        const float2* link = w.link[k & 1];
        const float2* near = w.near[k & 1];
        float before[kD];  // f[s0-1] .. f[s0-kD]
#pragma unroll
        for (int d = 0; d < kD; ++d) before[d] = fm[d];
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
            // beside the chain: M(s0 + r + kD) over the window, which holds
            // f[s-32] .. f[s-1] (h = kD+1 .. kD+32; those past H score kk)
            const unsigned key = __float_as_uint(
                fmaxf(candidate(wf, link[r * kTile + lane]), kkf));
            const unsigned mx = __reduce_max_sync(kFull, key);
            const unsigned at = __ballot_sync(kFull, key == mx);
            float v[kD];
#pragma unroll
            for (int d = 0; d < kD; ++d)
                v[d] = candidate(fm[d], near[r * kD + d]);
            float rest = M[0];
#pragma unroll
            for (int d = kD - 1; d >= 1; --d) rest = fmaxf(v[d], rest);
            const float fs = fmaxf(v[0], rest);  // the chain's last step
            if (lane == r) {
                wf = fs;
                wm = A[0];
            }
#pragma unroll
            for (int d = kD - 1; d >= 1; --d) fm[d] = fm[d - 1];
            fm[0] = fs;
#pragma unroll
            for (int d = 0; d + 1 < kD; ++d) {
                M[d] = M[d + 1];
                A[d] = A[d + 1];
            }
            M[kD - 1] = __uint_as_float(mx);
            A[kD - 1] = at;
        }
        // prev of step s = s0 + lane, beside the chain: the first near h
        // whose candidate (recomputed from the same operands, so the same
        // bits) equals f[s], else M(s)'s j: the nearest lane of its ballot,
        // taken when lane (s-kD-1) mod 32 held j = s-kD-1
        const int s = s0 + lane;
        const int jb = s - kD - 1;
        int pv = jb - __clz(__funnelshift_l(wm, wm, 31 - (jb & 31)));
#pragma unroll
        for (int d = kD - 1; d >= 0; --d) {
            float fj = __shfl_up_sync(kFull, wf, d + 1);  // f[s-1-d]
#pragma unroll
            for (int e = 0; e <= d; ++e)
                if (lane == d - e) fj = before[e];
            pv = candidate(fj, near[lane * kD + d]) == wf ? s - 1 - d : pv;
        }
        if (s < n) {
            f[s] = wf;
            prev[s] = wf > kkf ? pv : -1;
        }
    }
}

// H > 32: the window read from memory.
__global__ void __launch_bounds__(kWarps * 32) chain_dp_mem(Params p) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (b >= p.B) return;
    const size_t row = (size_t)b * p.cap;
    const int* q = p.q + row;
    const int* t = p.t + row;
    float* f = p.f + row;
    int* prev = p.prev + row;
    const int n = min(max(__ldg(p.n + b), 0), p.cap);
    const float kkf = __int2float_rn(p.kk);
    init_rest(p, f, prev, n, kkf, lane);
    __syncwarp();  // f[0] before any lane reads it
    for (int i = 1; i < n; ++i) {
        const int qi = __ldg(q + i), ti = __ldg(t + i);
        const int lim = min(i, p.H);
        float v = -INFINITY;
        int vh = lane + 1;
        for (int h = lane + 1; h <= lim; h += 32) {
            const int j = i - h;
            int gain;
            const int gap = link_gap(qi, ti, __ldg(q + j), __ldg(t + j), true,
                                     p, gain);
            const float c = candidate(f[j], link_parts(gain, gap, p.cost));
            if (c > v) {
                v = c;
                vh = h;
            }
        }
        int bh;
        const float best = warp_pick(v, vh, bh);
        const bool better = best > kkf;
        if (lane == (i & 31)) {
            f[i] = better ? best : kkf;
            prev[i] = better ? i - bh : -1;
        }
        __syncwarp();  // f[i] before the next step reads it
    }
}

}  // namespace

// C entry point. q, t: (B, cap) int32, each group's anchors in its first
// n[b] columns; n: (B,) int32; gap_cost: (max_gap + 1,) float32; f_out:
// (B, cap) float32; prev_out: (B, cap) int32. One launch for the bucket.
// Returns the launch's cudaGetLastError().
extern "C" int platanus_chain_dp(const void* q, const void* t, const void* n,
                                 int B, int cap, int H, int max_gap, int kk,
                                 const void* gap_cost, void* f_out,
                                 void* prev_out, void* stream) {
    if (B <= 0 || cap <= 0) return 0;
    if (H < 1 || max_gap < 0) return (int)cudaErrorInvalidValue;
    const Params p{static_cast<const int*>(q), static_cast<const int*>(t),
                   static_cast<const int*>(n),
                   static_cast<const float*>(gap_cost),
                   static_cast<float*>(f_out), static_cast<int*>(prev_out),
                   B, cap, H, max_gap, kk};
    auto s = static_cast<cudaStream_t>(stream);
    const size_t smem = kGroups * sizeof(GroupSmem)
                        + sizeof(float) * ((size_t)max_gap + 1);
    if (H <= 32 && smem <= (size_t)kMaxSmem) {
        const cudaError_t e = cudaFuncSetAttribute(
            chain_dp_regs, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
        chain_dp_regs<<<(B + kGroups - 1) / kGroups,
                        kGroups * 32 * (1 + kLinkWarps), smem, s>>>(p);
    } else {
        chain_dp_mem<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(p);
    }
    return (int)cudaGetLastError();
}
