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
// B * steps * H links take microseconds on the card, the chain of its
// largest group milliseconds. Each step must be as short as the card
// allows, and nothing outside the chain may wait inside it.
//
// Design:
// - One warp per group, kWarps groups per block, no block barrier; each
//   warp runs its own group's n-1 steps, not the bucket's cap-1.
// - A lookback of at most 32 (every preset's is 25) lives in registers:
//   lane l holds anchor i - h, h = l + 1, as (q, t, f). A step scores the
//   lane's link, reduces the warp to the first maximum with two
//   __reduce_*_sync (the largest value as an order-preserving key, then
//   the smallest h among the lanes holding it), and shifts the window by
//   one h with __shfl_up_sync, lane 0 taking the new anchor. Every lane
//   computes f[i] itself from the reduced maximum, so no broadcast ends
//   the step.
// - q[i + 1], t[i + 1] are loaded one step ahead; lane i mod 32 stores
//   f[i] and prev[i] (the stores leave the chain).
// - A longer lookback reads the window from memory instead, each lane
//   taking the offsets h = lane + 1 + 32 k: q and t through the read-only
//   cache, f from the warp's own stores, one __syncwarp a step.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // groups per block

struct Params {
    const int* q;
    const int* t;
    const int* n;
    const float* cost;
    float* f;
    int* prev;
    int B, cap, H, max_gap, kk;
};

// float -> unsigned key with the same order (no NaN occurs); -0 and +0,
// which compare equal, share the key of +0
__device__ __forceinline__ unsigned order_key(float x) {
    const unsigned u = x == 0.0f ? 0u : __float_as_uint(x);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The candidate of the link from anchor (qj, tj, fj) to (qi, ti), -inf if
// it is not a link. Differences wrap as int32 does in the reference.
__device__ __forceinline__ float link(int qi, int ti, int qj, int tj, float fj,
                                      const Params& p) {
    const int dq = (int)((unsigned)qi - (unsigned)qj);
    const int dt = (int)((unsigned)ti - (unsigned)tj);
    if (dq <= 0 || dt <= 0 || dq > p.max_gap || dt > p.max_gap)
        return -INFINITY;
    const int gain = min(min(dq, dt), p.kk);
    const int gap = abs(dq - dt);  // < max_gap: both lie in (0, max_gap]
    return __fsub_rn(__fadd_rn(fj, __int2float_rn(gain)), __ldg(p.cost + gap));
}

// The warp's first maximum over each lane's best (v, h): the largest v, and
// the smallest h among the lanes that hold it (argmax's tie rule, given
// that each lane's h is its smallest with value v).
__device__ __forceinline__ float warp_pick(float v, int h, int& best_h) {
    const unsigned k = order_key(v);
    const unsigned m = __reduce_max_sync(kFull, k);
    best_h = (int)__reduce_min_sync(kFull, k == m ? (unsigned)h : 0xffffffffu);
    return from_key(m);
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

// H <= 32: the window in registers, one anchor a lane.
__global__ void __launch_bounds__(kWarps * 32) chain_dp_regs(Params p) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (b >= p.B) return;  // the whole warp leaves
    const size_t row = (size_t)b * p.cap;
    const int* q = p.q + row;
    const int* t = p.t + row;
    float* f = p.f + row;
    int* prev = p.prev + row;
    const int n = min(max(__ldg(p.n + b), 0), p.cap);
    const float kkf = __int2float_rn(p.kk);
    init_rest(p, f, prev, n, kkf, lane);
    if (n < 2) return;

    // the window before step 1: anchor 0 at h = 1 (lane 0)
    const int h = lane + 1;
    int wq = 0, wt = 0;
    float wf = -INFINITY;
    if (lane == 0) {
        wq = __ldg(q);
        wt = __ldg(t);
        wf = kkf;
    }
    int qi = __ldg(q + 1), ti = __ldg(t + 1);
    for (int i = 1; i < n; ++i) {
        int qn = 0, tn = 0;
        if (i + 1 < n) {
            qn = __ldg(q + i + 1);
            tn = __ldg(t + i + 1);
        }
        // j >= 0 and h <= H
        const float v = h <= min(i, p.H) ? link(qi, ti, wq, wt, wf, p)
                                         : -INFINITY;
        int bh;
        const float best = warp_pick(v, h, bh);
        const bool better = best > kkf;
        const float fi = better ? best : kkf;
        if (lane == (i & 31)) {
            f[i] = fi;
            prev[i] = better ? i - bh : -1;
        }
        // shift: h -> h + 1; anchor i enters at h = 1
        const int uq = __shfl_up_sync(kFull, wq, 1);
        const int ut = __shfl_up_sync(kFull, wt, 1);
        const float uf = __shfl_up_sync(kFull, wf, 1);
        wq = lane ? uq : qi;
        wt = lane ? ut : ti;
        wf = lane ? uf : fi;
        qi = qn;
        ti = tn;
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
            const float c = link(qi, ti, __ldg(q + j), __ldg(t + j), f[j], p);
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
    const int blocks = (B + kWarps - 1) / kWarps;
    if (H <= 32)
        chain_dp_regs<<<blocks, kWarps * 32, 0, s>>>(p);
    else
        chain_dp_mem<<<blocks, kWarps * 32, 0, s>>>(p);
    return (int)cudaGetLastError();
}
