// ungap_align: ungapped full-overlap scoring of the mapper's seed candidates
// for Hopper (the polish / coverage mapper).
//
// Replaces the scoring half of platanus_b_tpu/models/mapper.py
// _map_ungap_kernel (:374-443), an XLA fusion on the TPU. Eager PyTorch
// would materialise its (R, S, H, L) coordinate and mismatch tensors and
// its (R, S*H, S*H) dedup mask; this kernel writes none of them.
//
// Per read r and candidate slot f = s*H + h (flat order), with the slot's
// contig cid, read-start offset ro and orientation:
//   a_start/a_end = the read positions whose contig coordinate
//                   (ro + p forward, ro - p reverse) lies in the contig;
//   span          = max(a_end - a_start, 0);
//   mis           = positions in span where neither base is N and the read
//                   base differs from the contig base (reverse slots compare
//                   against 3 ^ min(cb, 3));
//   score         = span - mis - 50 mis if the slot is ok, mis <=
//                   int((1 - min_identity) * span) and span > 0, else
//                   INT_MIN;
// then a slot loses its score if an earlier slot with a live score has the
// same (cid, ro, orientation); the first maximum is picked, and the read is
// mapped if that maximum is live and unique. The picked slot's (ro, mis,
// span) are returned even when nothing is live (then slot 0), as the
// reference does. Float decisions use round-to-nearest intrinsics so that
// no FMA contraction changes them (build without --use_fast_math).
//
// Bound: bytes, counted over what the inputs need: the read codes, the ok
// flags, the metadata of the ok slots and the outputs; the contig bases are
// gathers from a pool of a few MiB that stays in the 50 MB L2. A read has
// about three ok slots of 80, so the ok slots' metadata is a small part of
// the (R, S, H) arrays, and the kernel reads no other slot's metadata. What
// the card spends instead is latency: every read waits on three dependent
// loads (its ok flags, the ok slots' metadata, starts[cid]) before the pool
// gathers, so the design keeps as many reads in flight as it can: five
// per-read arrays of S*H ints, so that four blocks of 32 reads fit an SM's
// shared memory (at S*H = 80), and no local memory.
// Design: one read per group of 8 lanes, 32 reads per block; no slot is
// walked in series. (4 and 16 lanes per read measured slower; see PERF.md.)
// - Each lane loads 4 ok flags per 32-bit load (slots 4q .. 4q+3); a group
//   scan compacts slot 0 and the ok slots, in slot order, into the group's
//   entry arrays in shared memory; then each lane loads its entries' is_fwd,
//   cid, ro and clen at once, then starts[cid]. The read's codes come in
//   beside them, 4 bases per 32-bit load, and stay in registers.
// - Dedup before scoring: an ok entry with an earlier ok entry of the same
//   (cid, ro, orientation, clen) has that entry's span, mismatches and
//   liveness, so it would lose its score to it; it is not scored. Slot 0 is
//   always scored, so the pick needs no second count when nothing is live.
// - Scoring: two entries at a time across the group's 8 lanes; a lane
//   compares 4 bases per step with the SIMD byte intrinsics (__vcmpne4,
//   __vminu4), the contig's 4 bytes cut from two aligned pool words with a
//   funnel shift.
// - mis and span replace clen and starts[cid] in shared memory, and the
//   score follows from them; the dedup of equal (cid, ro, orientation)
//   entries of different clen, the first-maximum argmax and the pick read
//   them there. Flags in e_info mark the entries scored and those that lost
//   their score to an earlier twin.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;        // lanes per read (a power of two, <= 16)
constexpr int kThreads = 256;    // 32 reads per block at most
constexpr int kArrays = 5;       // per-read shared arrays of S*H ints
constexpr int kChunk = 4;        // ok words (4 slots each) a lane loads at once
constexpr size_t kBlockSmem = 96 * 1024;  // entry arrays of a block, at most
constexpr size_t kMaxSmem = 227 * 1024;   // a block's dynamic shared memory
// e_info: slot index | orientation | ok | scored (no earlier ok twin) |
// killed (an earlier live twin took its score)
constexpr int kFwd = 1 << 24;
constexpr int kOk = 1 << 25;
constexpr int kScored = 1 << 26;
constexpr int kKilled = 1 << 27;
constexpr int kSlotMask = kFwd - 1;

// 4 read codes from position 4w on (positions >= L read as N)
__device__ __forceinline__ uint32_t read_word(const uint8_t* __restrict__ rd,
                                              int w, int L, bool aligned) {
    const int p = 4 * w;
    if (aligned && p + 3 < L)
        return __ldg(reinterpret_cast<const uint32_t*>(rd + p));
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        x |= (uint32_t)(p + i < L ? __ldg(rd + p + i) : 4) << (8 * i);
    return x;
}

// bit b set when slot 4q + b (< SH) is ok
__device__ __forceinline__ unsigned ok_bits(const uint8_t* __restrict__ row,
                                            int q, int SH, bool aligned) {
    if (aligned) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(row) + q);
        const uint32_t x = __vcmpne4(w, 0u) & 0x01010101u;
        return (x | (x >> 7) | (x >> 14) | (x >> 21)) & 0xFu;
    }
    unsigned m = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        if (4 * q + b < SH && __ldg(row + 4 * q + b)) m |= 1u << b;
    return m;
}

// bytes g .. g+3 of the pool, each index clamped to 0 .. pool_n-1
__device__ __forceinline__ uint32_t pool_word(const uint8_t* __restrict__ pool,
                                              int pool_n, int pool_words,
                                              long long g) {
    if (pool_words > 0 && g >= 0 && g + 3 < 4LL * pool_words) {
        const uint32_t* p32 = reinterpret_cast<const uint32_t*>(pool);
        const int gi = (int)g;
        uint32_t lo = __ldg(p32 + (gi >> 2));
        uint32_t hi = __ldg(p32 + ((gi + 3) >> 2));
        return __funnelshift_r(lo, hi, 8 * (gi & 3));
    }
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        long long c = g + i;
        c = c < 0 ? 0 : (c > pool_n - 1 ? pool_n - 1 : c);
        x |= (uint32_t)__ldg(pool + c) << (8 * i);
    }
    return x;
}

// byte mask of the positions p0 .. p0+3 inside [lo, hi)
__device__ __forceinline__ uint32_t span_mask(int p0, int lo, int hi) {
    const int a = min(max(lo - p0, 0), 4), b = min(max(hi - p0, 0), 4);
    const uint32_t mb = b == 4 ? 0xFFFFFFFFu : ((1u << (8 * b)) - 1u);
    const uint32_t ma = a == 4 ? 0xFFFFFFFFu : ((1u << (8 * a)) - 1u);
    return mb & ~ma;
}

// one entry to score: its contig window against the read
struct Cand {
    int j;          // entry index
    bool fwd, ok;
    int ro, cst;    // read-start offset, starts[cid]
    int a_start, hi, span;
};

__device__ __forceinline__ Cand make_cand(const int* e_info, const int* e_ro,
                                          const int* e_len, const int* e_cst,
                                          int j, int Lr, int L) {
    Cand c;
    c.j = j;
    const int info = e_info[j];
    c.fwd = (info & kFwd) != 0;
    c.ok = (info & kOk) != 0;
    c.ro = e_ro[j];
    c.cst = e_cst[j];
    const int cl = e_len[j];
    int a_end;
    if (c.fwd) {
        c.a_start = max(0, -c.ro);
        a_end = min(Lr, cl - c.ro);
    } else {
        c.a_start = max(0, c.ro - (cl - 1));
        a_end = min(Lr, c.ro + 1);
    }
    c.span = max(a_end - c.a_start, 0);
    c.hi = min(a_end, L);
    return c;
}

// mismatches among the 4 positions of read word w (codes rb)
__device__ __forceinline__ int mis_word(const Cand& c, int w, uint32_t rb,
                                        const uint8_t* __restrict__ pool,
                                        int pool_n, int pool_words) {
    const int p0 = 4 * w;
    const uint32_t in_span = span_mask(p0, c.a_start, c.hi);
    // outside the span any pool word will do: no branch, so the loads of
    // all of a lane's words can be in flight together
    const long long g = !in_span ? 0
                        : c.fwd ? (long long)c.cst + c.ro + p0
                                : (long long)c.cst + c.ro - p0 - 3;
    uint32_t cb = pool_word(pool, pool_n, pool_words, g);
    if (!c.fwd) cb = __byte_perm(cb, 0, 0x0123);  // position order
    const uint32_t tb = c.fwd ? cb : (__vminu4(cb, 0x03030303u) ^ 0x03030303u);
    const uint32_t mm = __vcmpne4(tb, rb) & __vcmpne4(rb, 0x04040404u) &
                        __vcmpne4(cb, 0x04040404u) & in_span;
    return __popc(mm) >> 3;
}

// an entry's score from its span and mismatches once scored; INT_MIN for
// entries not scored or not live
__device__ __forceinline__ int entry_score(int info, int span, int mis,
                                           float one_minus) {
    if (!(info & kScored) || !(info & kOk)) return INT_MIN;
    const int thresh = (int)__fmul_rn(one_minus, __int2float_rn(span));
    return (mis <= thresh && span > 0) ? span - mis - 50 * mis : INT_MIN;
}

// NS: read words of 4 codes each lane keeps in registers (lane lg holds
// words lg + kLanes s); 0 reads them from global memory at each step.
template <int NS>
__global__ void __launch_bounds__(kThreads)
ungap_align_kernel(const uint8_t* __restrict__ codes,
                   const int* __restrict__ lengths, int R, int L,
                   bool codes_aligned, const uint8_t* __restrict__ pool,
                   int pool_n, int pool_words, const int* __restrict__ starts,
                   const uint8_t* __restrict__ ok, bool ok_aligned,
                   const uint8_t* __restrict__ is_fwd,
                   const int* __restrict__ cid, const int* __restrict__ ro,
                   const int* __restrict__ clen, int SH, float min_identity,
                   int* __restrict__ out_id, int* __restrict__ out_ro,
                   float* __restrict__ out_ident, int* __restrict__ out_mis,
                   int* __restrict__ out_span) {
    extern __shared__ int smem[];
    const int lane = threadIdx.x & 31;
    const int lg = lane & (kLanes - 1);  // lane in the read's group
    const int gi = threadIdx.x / kLanes;  // the read's group in the block
    const int gbase = lane & ~(kLanes - 1);
    const unsigned gmask = ((1u << kLanes) - 1u) << gbase;
    const int r = blockIdx.x * (blockDim.x / kLanes) + gi;
    if (r >= R) return;  // the whole group leaves together
    int* e_info = smem + (size_t)gi * kArrays * SH;
    int* e_cid = e_info + SH;
    int* e_ro = e_cid + SH;
    int* e_len = e_ro + SH;    // clen, then the span once scored
    int* e_cst = e_len + SH;   // starts[cid], then the mismatches

    const uint8_t* rd = codes + (size_t)r * L;
    const int Lr = __ldg(lengths + r);
    const int nw = (L + 3) / 4;
    uint32_t rw[NS > 0 ? NS : 1];
#pragma unroll
    for (int s = 0; s < (NS > 0 ? NS : 1); ++s) {
        const int w = lg + kLanes * s;
        rw[s] = (NS > 0 && w < nw) ? read_word(rd, w, L, codes_aligned) : 0u;
    }

    // ---- slot 0 and every ok slot, in slot order
    const size_t base = (size_t)r * SH;
    const uint8_t* ok_row = ok + base;
    const int nq = (SH + 3) / 4;
    int n = 0;
    for (int q0 = 0; q0 < nq; q0 += kLanes * kChunk) {
        unsigned okm[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
            const int q = q0 + kLanes * u + lg;
            okm[u] = q < nq ? ok_bits(ok_row, q, SH, ok_aligned) : 0u;
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
            const int q = q0 + kLanes * u + lg;
            const unsigned take = okm[u] | (q == 0 ? 1u : 0u);
            const int c = __popc(take);
            int incl = c;  // inclusive scan over the group's lanes
#pragma unroll
            for (int d = 1; d < kLanes; d <<= 1) {
                const int v = __shfl_up_sync(gmask, incl, d, kLanes);
                if (lg >= d) incl += v;
            }
            int j = n + incl - c;
            for (unsigned m = take; m; m &= m - 1) {
                const int b = __ffs(m) - 1;
                e_info[j++] = (4 * q + b) | ((okm[u] >> b) & 1u ? kOk : 0);
            }
            n += __shfl_sync(gmask, incl, kLanes - 1, kLanes);
        }
    }
    __syncwarp(gmask);

    // ---- the entries' metadata: the four loads at once, then starts[cid]
    for (int j = lg; j < n; j += kLanes) {
        const int info = e_info[j];
        const int f = info & kSlotMask;
        const bool fw = __ldg(is_fwd + base + f) != 0;
        const int c = __ldg(cid + base + f);
        const int o = __ldg(ro + base + f);
        const int cl = __ldg(clen + base + f);
        e_info[j] = info | (fw ? kFwd : 0);
        e_cid[j] = c;
        e_ro[j] = o;
        e_len[j] = cl;
        e_cst[j] = __ldg(starts + c);
    }
    __syncwarp(gmask);

    // ---- dedup before scoring: entry 0 (slot 0) is always scored; an ok
    // entry is scored unless an earlier ok entry has the same key
    for (int j0 = 0; j0 < n; j0 += kLanes) {
        const int j = j0 + lg;
        bool scored = false;
        if (j < n) {
            scored = true;
            if (j > 0) {
                const int key_c = e_cid[j], key_r = e_ro[j], key_l = e_len[j];
                const int key_f = e_info[j] & kFwd;
                for (int i = 0; i < j; ++i) {
                    if ((e_info[i] & kOk) && e_cid[i] == key_c &&
                        e_ro[i] == key_r && e_len[i] == key_l &&
                        (e_info[i] & kFwd) == key_f) {
                        scored = false;
                        break;
                    }
                }
            }
        }
        __syncwarp(gmask);
        if (scored) e_info[j] |= kScored;
        __syncwarp(gmask);
    }

    // ---- scores, two entries at a time; span and mismatches replace clen
    // and starts[cid]
    const float one_minus = __fsub_rn(1.0f, min_identity);
    for (int j0 = 0; j0 < n; j0 += kLanes) {
        const bool mine = j0 + lg < n && (e_info[j0 + lg] & kScored);
        unsigned m = (__ballot_sync(gmask, mine) >> gbase) &
                     ((1u << kLanes) - 1u);
        while (m) {  // the same for the whole group
            const int ja = j0 + __ffs(m) - 1;
            m &= m - 1;
            const bool two = m != 0;
            const int jb = two ? j0 + __ffs(m) - 1 : ja;
            if (two) m &= m - 1;
            const Cand a = make_cand(e_info, e_ro, e_len, e_cst, ja, Lr, L);
            const Cand b = make_cand(e_info, e_ro, e_len, e_cst, jb, Lr, L);
            int ma = 0, mb = 0;
            if constexpr (NS > 0) {
#pragma unroll
                for (int s = 0; s < NS; ++s) {
                    const int w = lg + kLanes * s;  // (b repeats a when !two)
                    if (w < nw) {
                        ma += mis_word(a, w, rw[s], pool, pool_n, pool_words);
                        mb += mis_word(b, w, rw[s], pool, pool_n, pool_words);
                    }
                }
            } else {
                for (int w = lg; w < nw; w += kLanes) {
                    const uint32_t rb = read_word(rd, w, L, codes_aligned);
                    ma += mis_word(a, w, rb, pool, pool_n, pool_words);
                    mb += mis_word(b, w, rb, pool, pool_n, pool_words);
                }
            }
#pragma unroll
            for (int d = kLanes / 2; d > 0; d >>= 1) {
                ma += __shfl_xor_sync(gmask, ma, d, kLanes);
                mb += __shfl_xor_sync(gmask, mb, d, kLanes);
            }
            if (lg == 0) {
                e_len[ja] = a.span;
                e_cst[ja] = ma;
            }
            if (lg == 1 && two) {
                e_len[jb] = b.span;
                e_cst[jb] = mb;
            }
        }
    }
    __syncwarp(gmask);

    // ---- an entry with an earlier live entry of the same (cid, ro,
    // orientation) loses its score (equal clen was settled above)
    for (int j0 = 0; j0 < n; j0 += kLanes) {
        const int j = j0 + lg;
        bool killed = false;
        if (j < n) {
            const int info = e_info[j];
            if (entry_score(info, e_len[j], e_cst[j], one_minus) != INT_MIN) {
                for (int i = 0; i < j; ++i) {
                    const int ii = e_info[i];
                    if (e_cid[i] == e_cid[j] && e_ro[i] == e_ro[j] &&
                        ((ii ^ info) & kFwd) == 0 &&
                        entry_score(ii, e_len[i], e_cst[i], one_minus) !=
                            INT_MIN) {
                        killed = true;
                        break;
                    }
                }
            }
        }
        __syncwarp(gmask);
        if (killed) e_info[j] |= kKilled;
        __syncwarp(gmask);
    }

    // ---- first maximum over the entries (slot order), then its count
    auto final_score = [&](int j) {
        const int info = e_info[j];
        return (info & kKilled)
                   ? INT_MIN
                   : entry_score(info, e_len[j], e_cst[j], one_minus);
    };
    int best = INT_MAX, best_sc = INT_MIN;
    for (int j = lg; j < n; j += kLanes) {
        const int sc = final_score(j);
        if (best == INT_MAX || sc > best_sc) {
            best_sc = sc;
            best = j;
        }
    }
#pragma unroll
    for (int d = kLanes / 2; d > 0; d >>= 1) {
        const int o_sc = __shfl_xor_sync(gmask, best_sc, d, kLanes);
        const int o_j = __shfl_xor_sync(gmask, best, d, kLanes);
        if (o_sc > best_sc || (o_sc == best_sc && o_j < best)) {
            best_sc = o_sc;
            best = o_j;
        }
    }
    int n_best = 0;
    for (int j = lg; j < n; j += kLanes)
        n_best += (final_score(j) == best_sc && best_sc != INT_MIN) ? 1 : 0;
#pragma unroll
    for (int d = kLanes / 2; d > 0; d >>= 1)
        n_best += __shfl_xor_sync(gmask, n_best, d, kLanes);

    // the pick is a live scored entry, or entry 0 (slot 0) when none is live
    if (lg == 0) {
        const bool unique = best_sc != INT_MIN && n_best == 1;
        const int c = e_cid[best];
        const int span = e_len[best], mis = e_cst[best];
        out_id[r] = unique ? ((e_info[best] & kFwd) ? c + 1 : -(c + 1)) : 0;
        out_ro[r] = e_ro[best];
        out_ident[r] = span > 0 ? __fdiv_rn(__int2float_rn(span - mis),
                                            __int2float_rn(max(span, 1)))
                                : 0.0f;
        out_mis[r] = mis;
        out_span[r] = span;
    }
}

template <int NS>
cudaError_t launch(const uint8_t* codes, const int* lengths, int R, int L,
                   bool codes_aligned, const uint8_t* pool, int pool_n,
                   int pool_words, const int* starts, const uint8_t* ok,
                   bool ok_aligned, const uint8_t* is_fwd, const int* cid,
                   const int* ro, const int* clen, int SH, float min_identity,
                   int* out_id, int* out_ro, float* out_ident, int* out_mis,
                   int* out_span, int reads, size_t smem,
                   cudaStream_t stream) {
    // raise the instance's cap once to the card's most; a launch asks for
    // only what it uses, so the cap does not change its occupancy
    static const cudaError_t cap = cudaFuncSetAttribute(
        ungap_align_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSmem);
    if (cap != cudaSuccess) return cap;
    unsigned blocks = (unsigned)((R + reads - 1) / reads);
    ungap_align_kernel<NS><<<blocks, kLanes * reads, smem, stream>>>(
        codes, lengths, R, L, codes_aligned, pool, pool_n, pool_words, starts,
        ok, ok_aligned, is_fwd, cid, ro, clen, SH, min_identity, out_id,
        out_ro, out_ident, out_mis, out_span);
    return cudaGetLastError();
}

}  // namespace

// C entry point. codes: (R, L) u8; lengths: (R,) int32; pool: (pool_n,) u8;
// starts: (C+1,) int32; ok, is_fwd: (R, SH) u8 (0/1); cid, ro, clen:
// (R, SH) int32; outputs (R,): id, ro, mis, span int32 and identity f32.
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue when
// one read's S*H entry arrays exceed a block's 227 KB of shared memory
// (S*H > 8301).
extern "C" int platanus_ungap_align(const void* codes, const void* lengths,
                                    int R, int L, const void* pool, int pool_n,
                                    const void* starts, const void* ok,
                                    const void* is_fwd, const void* cid,
                                    const void* ro, const void* clen, int SH,
                                    float min_identity, void* out_id,
                                    void* out_ro, void* out_ident,
                                    void* out_mis, void* out_span,
                                    void* stream) {
    if (R <= 0) return 0;
    const size_t per_read = (size_t)kArrays * SH * sizeof(int);
    if (L <= 0 || SH <= 0 || SH >= kFwd || pool_n <= 0 ||
        per_read > kMaxSmem)
        return (int)cudaErrorInvalidValue;
    int reads = kThreads / kLanes;  // reads per block
    while (reads > 1 && reads * per_read > kBlockSmem) reads >>= 1;
    const size_t smem = reads * per_read;
    const bool ok_aligned =
        (reinterpret_cast<uintptr_t>(ok) & 3) == 0 && (SH & 3) == 0;
    const bool codes_aligned =
        (reinterpret_cast<uintptr_t>(codes) & 3) == 0 && (L & 3) == 0;
    const int pool_words =
        (reinterpret_cast<uintptr_t>(pool) & 3) == 0 ? pool_n / 4 : 0;
    auto s = static_cast<cudaStream_t>(stream);
    auto c = static_cast<const uint8_t*>(codes);
    auto ln = static_cast<const int*>(lengths);
    auto pl = static_cast<const uint8_t*>(pool);
    auto st = static_cast<const int*>(starts);
    auto okp = static_cast<const uint8_t*>(ok);
    auto fw = static_cast<const uint8_t*>(is_fwd);
    auto ci = static_cast<const int*>(cid);
    auto rp = static_cast<const int*>(ro);
    auto cl = static_cast<const int*>(clen);
    auto oi = static_cast<int*>(out_id);
    auto orp = static_cast<int*>(out_ro);
    auto oid = static_cast<float*>(out_ident);
    auto om = static_cast<int*>(out_mis);
    auto osp = static_cast<int*>(out_span);
    const int nw = (L + 3) / 4;
#define PLATANUS_UNGAP(n)                                                     \
    return launch<n>(c, ln, R, L, codes_aligned, pl, pool_n, pool_words, st, \
                     okp, ok_aligned, fw, ci, rp, cl, SH, min_identity, oi,   \
                     orp, oid, om, osp, reads, smem, s)
    if (nw <= 4 * kLanes) PLATANUS_UNGAP(4);
    if (nw <= 8 * kLanes) PLATANUS_UNGAP(8);
    if (nw <= 16 * kLanes) PLATANUS_UNGAP(16);
    PLATANUS_UNGAP(0);
#undef PLATANUS_UNGAP
}
