// edit_distance: banded unit-cost edit distance for Hopper.
//
// Port of the Pallas TPU kernel _bed_kernel
// (platanus_b_tpu/ops/pallas_align.py:43, launched by _bed_call :151).
// For each (query, target) pair of 2-bit codes it computes D(qlen-1, tlen-1)
// over an anti-diagonal wavefront restricted to a band of bw cells whose
// start on diagonal d is lo(d) = max(d*qlen // max(qlen+tlen-1, 1) - bw/2, 0).
// Exact when the optimal path stays in band, an upper bound otherwise; a
// code >= 4 always mismatches; an empty side gives max(len q, len t).
// With bw >= 2*qlen the band covers the whole matrix and the result is the
// plain Levenshtein distance (the bubble-crush use, ops/align.py).
//
// Bound: the serial chain of a pair's qlen+tlen-1 dependent diagonals, not
// bytes or operations. Each diagonal step must be as short as the card
// allows, and nothing outside the chain may wait inside it.
//
// Design:
// - One warp per pair, up to kWarps pairs per block; no block barrier.
// - Effective width: a cell with lo(d) + c >= qlen is infeasible, and a
//   cell reads only band cells <= c + 1 of the earlier diagonals, so only
//   the first Wp = min(bw, qlen) cells of a pair are computed (cells past
//   them read as BIG, as out-of-band cells do). Each warp picks its tier
//   from its own pair's Wp.
// - Register tiers (Wp <= 496): C = ceil(Wp/31) rows a lane, C in 1..16.
//   Row i lives in slot i mod 32C, lane l holding rows R..R+C-1 with
//   R = l*C mod 32C, so a cell's parents (rows i-1 and i) are the slot
//   before and the same slot whatever the band's shifts: one __shfl_sync
//   per diagonal (the previous lane's last row), no shift-dependent code.
//   The rows held are the window [lo', lo' + 32C), lo' = lo rounded down to
//   a multiple of C; when lo' moves, one lane takes rows 32C higher and
//   loads their query characters. 32C >= Wp + C keeps every parent outside
//   the band on a slot that holds an out-of-band (BIG) row.
// - Border cells (i == 0 or j == 0) occur only in a prefix of the
//   diagonals, which runs a loop of its own; the rest runs without them.
// - Wide tier (Wp > 496): the warp strides over the band, whose diagonals
//   d, d-1 and d-2 rotate through three (Wp+3)-int buffers with BIG in
//   column 0 and columns Wp+1, Wp+2, one __syncwarp per diagonal. The
//   buffers sit in shared memory, or in global scratch the caller
//   allocates when they do not fit (one slice per pair).
// - No division in the loop: ic(d) = d*qlen // denom grows by 0 or 1 per
//   diagonal (qlen <= denom), so it is carried with a remainder.
// - The sequences are staged in shared memory before the loop (when a
//   pair's rows and their margins fit kStageCap); a diagonal's target
//   characters are loaded one diagonal ahead. Otherwise they are read
//   through the read-only cache.
// The host plan (make_plan) fixes the block's warps, the staging and where
// the wide band lives, from bw and the padded widths alone, so the caller
// knows the scratch it must allocate without reading the lengths.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 28;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;             // pairs per block at most
constexpr int kRegCells = 16 * 32;    // slots of the widest register tier
constexpr int kRegWidth = 16 * 31;    // widest band it takes
constexpr int kStageCap = 32 * 1024;  // staged sequence bytes per pair
constexpr int kMaxSmem = 227 * 1024;  // per-block opt-in on an H100

__host__ __device__ __forceinline__ int pad16(int x) { return (x + 15) & ~15; }

template <int C>
__device__ __forceinline__ int left_of(const int (&D)[C], int k, int nb) {
    return k == 0 ? nb : D[k == 0 ? 0 : k - 1];
}

// A lane's state in the register tier. Lane l holds C consecutive rows
// R .. R+C-1, R = l*C mod 32C: slot s of the warp holds row i = s mod 32C
// from the window [lo', lo' + 32C), lo' = lo rounded down to a multiple of
// C, so the window moves a whole lane at a time.
template <int C>
struct Lane {
    int D1[C], D2[C];  // diagonals d-1 and d-2 at the lane's rows
    int qc[C];         // q[R + k]
    int cost[C];       // substitution costs of diagonal d
    int nb2;           // diagonal d-2 at the row before R
    int R;             // the lane's first row
    int ic, rem, lo;   // ic(d) = d*qlen // denom carried, and lo(d)
    int lo_al;         // lo' (d)
};

// One diagonal of the register tier. A cell's parents are rows i-1 (del on
// d-1, sub on d-2) and i (ins on d-1): the slot before and the same slot,
// the previous lane's last row for k = 0 (lane 0 wraps to lane 31). nb2 is
// that neighbour on d-2, the nb1 of the diagonal before. Rows R+k with
// a > k > b are feasible and in band. EDGE: the diagonal may hold a cell
// with i == 0 or j == 0, whose parents are the DP matrix's border.
template <int C, bool EDGE>
__device__ __forceinline__ void reg_step(Lane<C>& s, int lane, int d, int a,
                                         int b) {
    const int nb1 = __shfl_sync(kFull, s.D1[C - 1], (lane + 31) & 31);
    int N[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        int sub_v = left_of(s.D2, k, s.nb2);
        int del_v = left_of(s.D1, k, nb1);
        int ins_v = s.D1[k];
        if (EDGE) {
            const int i = s.R + k;
            const int j = d - i;
            sub_v = i == 0 ? j : (j == 0 ? i : sub_v);
            del_v = i == 0 ? j + 1 : del_v;
            ins_v = j == 0 ? i + 1 : ins_v;
        }
        const int v = min(sub_v + s.cost[k], min(del_v, ins_v) + 1);
        N[k] = (k < a && k > b) ? v : kBig;
    }
    s.nb2 = nb1;
#pragma unroll
    for (int k = 0; k < C; ++k) {
        s.D2[k] = s.D1[k];
        s.D1[k] = N[k];
    }
}

// Staged rows are read unguarded, their codes >= 4 made unequal at
// staging (query 0xFF, target 0xFE): the region holds kRegCells bytes past
// the query and before the target, and min(Lq, bw/2) + 32 past the
// target, which covers every index a slot reaches (a cell outside the
// matrix is masked). Unstaged rows are read clamped to the row.
template <bool STAGE>
__device__ __forceinline__ int load_q(const uint8_t* qs, int i, int qlen) {
    return STAGE ? qs[i] : __ldg(qs + min(i, qlen - 1));
}

template <bool STAGE>
__device__ __forceinline__ int load_t(const uint8_t* ts, int j, int tlen) {
    return STAGE ? ts[j] : __ldg(ts + max(min(j, tlen - 1), 0));
}

template <int C, bool STAGE>
__device__ __forceinline__ int cost_of(int qc, int tc) {
    return (qc != tc || (!STAGE && qc >= 4)) ? 1 : 0;
}

// Diagonals from d on, up to d_last; with EDGE only while the diagonal may
// hold a border cell (lo == 0 or d - lo < wp, true for a prefix of the
// diagonals). The characters of diagonal d+1 are loaded before diagonal d
// is computed and compared after it, so their latency leaves the chain.
// Returns the first diagonal not run.
template <int C, bool STAGE, bool EDGE>
__device__ __forceinline__ int run_diagonals(Lane<C>& s, int d, int d_last,
                                             const uint8_t* qs,
                                             const uint8_t* ts, int qlen,
                                             int tlen, int half, int wp,
                                             int lane) {
    constexpr int S = 32 * C;
    const int denom = qlen + tlen - 1;
#pragma unroll 2
    for (; d <= d_last; ++d) {
        if (EDGE && !(s.lo == 0 || d - s.lo < wp)) break;
        // target characters of diagonal d+1, t[d+1 - R - k], first: a lane
        // the window moves below (at the end of this diagonal) holds rows
        // above the band on d+1, so their characters are not read there
        int tn[C];
#pragma unroll
        for (int k = 0; k < C; ++k)
            tn[k] = load_t<STAGE>(ts, d + 1 - s.R - k, tlen);
        // band start of diagonal d+1
        s.rem += qlen;
        if (s.rem >= denom) {
            s.rem -= denom;
            ++s.ic;
        }
        const int lo_next = max(s.ic - half, 0);
        // diagonal d on rows R..R+C-1; feasible and in band: lo <= i,
        // i < lo + wp, i < qlen, j >= 0 (i <= d), j < tlen (i > d - tlen)
        const int hi = min(min(s.lo + wp, qlen), d + 1);
        const int lb = max(s.lo - 1, d - tlen);
        reg_step<C, EDGE>(s, lane, d, hi - s.R, lb - s.R);
#pragma unroll
        for (int k = 0; k < C; ++k)
            s.cost[k] = cost_of<C, STAGE>(s.qc[k], tn[k]);
        // the window moves a lane when lo' does: that lane's rows go up by
        // 32C, with their query characters
        if (lo_next >= s.lo_al + C) {
            s.lo_al += C;
            if (s.R < s.lo_al) {
                s.R += S;
#pragma unroll
                for (int k = 0; k < C; ++k)
                    s.qc[k] = load_q<STAGE>(qs, s.R + k, qlen);
            }
        }
        s.lo = lo_next;
    }
    return d;
}

template <int C, bool STAGE>
__device__ void run_reg(const uint8_t* qs, const uint8_t* ts, int qlen,
                        int tlen, int bw, int lane, int* out) {
    const int half = bw >> 1;
    const int d_last = qlen + tlen - 2;
    const int wp = min(bw, qlen);
    Lane<C> s;
    s.R = lane * C;
#pragma unroll
    for (int k = 0; k < C; ++k) {
        s.D1[k] = s.D2[k] = kBig;
        s.qc[k] = load_q<STAGE>(qs, s.R + k, qlen);
        s.cost[k] = cost_of<C, STAGE>(s.qc[k], load_t<STAGE>(ts, -s.R - k, tlen));
    }
    s.nb2 = kBig;
    s.ic = s.rem = s.lo = s.lo_al = 0;
    const int d = run_diagonals<C, STAGE, true>(s, 0, d_last, qs, ts, qlen,
                                                tlen, half, wp, lane);
    run_diagonals<C, STAGE, false>(s, d, d_last, qs, ts, qlen, tlen, half,
                                   wp, lane);
    // D(qlen-1, tlen-1): row qlen-1 of the last diagonal, one slot
    const int slot = (qlen - 1) % (32 * C);
#pragma unroll
    for (int k = 0; k < C; ++k)
        if (lane * C + k == slot) *out = s.D1[k];
}

// Register tier C = ceil(Wp / 31) (so 32C >= Wp + C), C in [1, 16].
template <int C, bool STAGE>
__device__ void run_tier(int c, const uint8_t* qs, const uint8_t* ts,
                         int qlen, int tlen, int bw, int lane, int* out) {
    if (c == C) {
        run_reg<C, STAGE>(qs, ts, qlen, tlen, bw, lane, out);
    } else if constexpr (C < 16) {
        run_tier<C + 1, STAGE>(c, qs, ts, qlen, tlen, bw, lane, out);
    }
}

__device__ void run_wide(const uint8_t* qs, const uint8_t* ts, int qlen,
                         int tlen, int bw, int lane, int* buf, int* out) {
    const int half = bw >> 1;
    const int denom = qlen + tlen - 1;
    const int d_last = qlen + tlen - 2;
    const int wp = min(bw, qlen);
    const int stride = wp + 3;
    for (int x = lane; x < 3 * stride; x += 32) buf[x] = kBig;
    __syncwarp();
    int* cur = buf;
    int* p1 = buf + stride;      // diagonal d-1
    int* p2 = buf + 2 * stride;  // diagonal d-2
    int ic = 0, rem = 0, lo = 0, lo1 = 0, lo2 = 0;
    for (int d = 0; d <= d_last; ++d) {
        const int s1 = lo - lo1;
        const int s2 = lo - lo2;
        for (int c = lane; c < wp; c += 32) {
            const int i = lo + c;
            const int j = d - i;
            int v = kBig;
            if (i < qlen && j >= 0 && j < tlen) {
                const int qc = qs[i];
                const int tc = ts[j];
                const int cost = (qc == tc && qc < 4) ? 0 : 1;
                const int sub_v = i == 0 ? j : (j == 0 ? i : p2[c + s2]);
                const int del_v = i == 0 ? j + 1 : p1[c + s1];
                const int ins_v = j == 0 ? i + 1 : p1[c + s1 + 1];
                v = min(sub_v + cost, min(del_v, ins_v) + 1);
            }
            cur[c + 1] = v;
            if (d == d_last && c == qlen - 1 - lo) *out = v;
        }
        __syncwarp();
        int* done = p2;
        p2 = p1;
        p1 = cur;
        cur = done;
        lo2 = lo1;
        lo1 = lo;
        rem += qlen;
        if (rem >= denom) {
            rem -= denom;
            ++ic;
        }
        lo = max(ic - half, 0);
    }
}

// scratch: null, or band_ints ints per pair for the wide tier's buffers in
// global memory; otherwise each warp's shared region starts with band_ints
// ints of buffers (when band_ints > 0), then, with STAGE, its pair's query
// and target with the margins load_q and load_t read (make_plan).
template <bool STAGE>
__global__ void __launch_bounds__(kWarps * 32)
edit_distance_kernel(const uint8_t* __restrict__ q,
                     const uint8_t* __restrict__ t,
                     const int* __restrict__ qlens,
                     const int* __restrict__ tlens, int B, int Lq, int Lt,
                     int bw, int* __restrict__ out, int* __restrict__ scratch,
                     int band_ints, int region_bytes) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= B) return;
    const int qlen = qlens[b];
    const int tlen = tlens[b];
    int* dst = out + b;
    if (qlen == 0 || tlen == 0) {
        if (lane == 0) *dst = qlen > tlen ? qlen : tlen;
        return;
    }
    unsigned char* region = smem + (size_t)warp * region_bytes;
    int* band = scratch ? scratch + (size_t)b * band_ints
                        : reinterpret_cast<int*>(region);
    const uint8_t* qs = q + (size_t)b * Lq;
    const uint8_t* ts = t + (size_t)b * Lt;
    if (STAGE) {
        uint8_t* sq = region + (scratch ? 0 : 4 * band_ints);
        uint8_t* st = sq + pad16(Lq + kRegCells) + kRegCells;
        for (int x = lane; x < qlen; x += 32) {
            const uint8_t c = __ldg(qs + x);
            sq[x] = c < 4 ? c : 0xFF;
        }
        for (int x = lane; x < tlen; x += 32) {
            const uint8_t c = __ldg(ts + x);
            st[x] = c < 4 ? c : 0xFE;
        }
        __syncwarp();
        qs = sq;
        ts = st;
    }
    const int wp = min(bw, qlen);
    if (wp <= kRegWidth)
        run_tier<1, STAGE>((wp + 30) / 31, qs, ts, qlen, tlen, bw, lane, dst);
    else
        run_wide(qs, ts, qlen, tlen, bw, lane, band, dst);
}

struct Plan {
    int warps;         // pairs per block
    bool stage;        // sequences in shared memory
    bool band_global;  // wide-tier buffers in scratch
    int band_ints;     // wide-tier buffer ints per pair (0: no wide tier)
    int region_bytes;  // shared bytes per warp
};

// Fixed by bw and the padded widths, so that the caller can size the
// scratch: prefer staged sequences and shared buffers, then four warps a
// block; sequences and buffers leave shared memory last.
Plan make_plan(int bw, int Lq, int Lt) {
    const int W = bw < Lq ? bw : Lq;
    const int band_ints = W > kRegWidth ? ((3 * (W + 3) + 3) & ~3) : 0;
    const long long seq = (long long)pad16(Lq + kRegCells) + kRegCells +
                          pad16(Lt + (Lq < bw / 2 ? Lq : bw / 2) + 32);
    const bool can_stage = seq <= kStageCap;
    const bool opts[4][2] = {{true, false}, {false, false}, {true, true},
                             {false, true}};
    for (const auto& o : opts) {
        const bool stage = o[0], glob = o[1];
        if (stage && !can_stage) continue;
        if (glob && band_ints == 0) continue;
        const long long per = (stage ? seq : 0) + (glob ? 0 : 4ll * band_ints);
        for (int warps = kWarps; warps >= 1; warps >>= 1) {
            if (warps * per <= kMaxSmem)
                return Plan{warps, stage, glob, band_ints, (int)per};
        }
    }
    return Plan{kWarps, false, true, band_ints, 0};
}

template <bool STAGE>
cudaError_t launch(const Plan& p, const void* q, const void* t,
                   const void* qlens, const void* tlens, int B, int Lq,
                   int Lt, int bw, void* out, void* scratch,
                   cudaStream_t s) {
    static bool opted_in = false;  // once per template instance
    const size_t smem = (size_t)p.warps * p.region_bytes;
    if (smem > 48 * 1024 && !opted_in) {
        cudaError_t e = cudaFuncSetAttribute(
            edit_distance_kernel<STAGE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (e != cudaSuccess) return e;
        opted_in = true;
    }
    const int blocks = (B + p.warps - 1) / p.warps;
    edit_distance_kernel<STAGE><<<blocks, p.warps * 32, smem, s>>>(
        static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
        static_cast<const int*>(qlens), static_cast<const int*>(tlens), B, Lq,
        Lt, bw, static_cast<int*>(out),
        p.band_global ? static_cast<int*>(scratch) : nullptr, p.band_ints,
        p.region_bytes);
    return cudaGetLastError();
}

}  // namespace

// int32 scratch per pair the caller must pass (0: none) for a launch at
// band bw over (B, Lq) queries and (B, Lt) targets.
extern "C" long long platanus_edit_distance_scratch_ints(int bw, int Lq,
                                                         int Lt) {
    const Plan p = make_plan(bw, Lq, Lt);
    return p.band_global ? p.band_ints : 0;
}

// C entry point. q: (B, Lq) u8 padded with 4; t: (B, Lt) u8 padded with 4,
// read forward; qlens, tlens: (B,) int32, each <= Lq, Lt; out: (B,) int32;
// scratch: null, or B * platanus_edit_distance_scratch_ints(bw, Lq, Lt)
// int32. Returns the launch's cudaGetLastError().
extern "C" int platanus_edit_distance(const void* q, const void* t,
                                      const void* qlens, const void* tlens,
                                      int B, int Lq, int Lt, int bw, void* out,
                                      void* scratch, void* stream) {
    if (B <= 0) return 0;
    if (bw < 1 || Lq < 0 || Lt < 0) return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(bw, Lq, Lt);
    if (p.band_global && scratch == nullptr) return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t e = p.stage
        ? launch<true>(p, q, t, qlens, tlens, B, Lq, Lt, bw, out, scratch, s)
        : launch<false>(p, q, t, qlens, tlens, B, Lq, Lt, bw, out, scratch, s);
    return (int)e;
}
