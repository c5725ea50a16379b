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
// Design: one warp per read. The read's codes sit in registers (positions
// p = lane + 32 i). Slot metadata goes to shared memory; for every slot that
// can score, each lane tests its positions and __popc(__ballot_sync) summed
// over i gives the mismatches. The O((S*H)^2) earlier-equal test runs only
// over live slots, and the first-maximum argmax is a warp shuffle reduction.
// Bound: latency and L2, not HBM. At 240k reads of 100 bp the reads are
// 24 MB read once; the contig bases are byte gathers from a pool of a few
// MiB that stays in the 50 MB L2, and only candidates that can score (a
// few per read) are counted.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kArrays = 5;  // per-warp shared arrays of S*H ints

struct Slot {
    int cid, ro, fwd, clen;
};

// Warp-collective: (mis, span) of one slot against the read in registers
// (NI > 0) or in global memory (NI == 0).
template <int NI>
__device__ __forceinline__ void count_slot(const uint8_t* rc, const uint8_t* rd,
                                           int L, int Lr, int ni,
                                           const uint8_t* __restrict__ pool,
                                           int pool_n, int cstart, Slot s,
                                           int lane, int* mis_out,
                                           int* span_out) {
    int a_start, a_end;
    if (s.fwd) {
        a_start = max(0, -s.ro);
        a_end = min(Lr, s.clen - s.ro);
    } else {
        a_start = max(0, s.ro - (s.clen - 1));
        a_end = min(Lr, s.ro + 1);
    }
    int span = max(a_end - a_start, 0);
    // one position p with read base rb: a counted mismatch?
    auto mismatch = [&](int p, int rb) {
        if (p < a_start || p >= a_end || p >= L || rb == 4) return false;
        int coord = s.fwd ? s.ro + p : s.ro - p;
        int cb = pool[min(max(cstart + coord, 0), pool_n - 1)];
        int tb = s.fwd ? cb : (3 ^ min(cb, 3));
        return cb != 4 && tb != rb;
    };
    int mis = 0;
    if constexpr (NI > 0) {
#pragma unroll
        for (int i = 0; i < NI; ++i) {
            if (i < ni)  // uniform across the warp
                mis += __popc(__ballot_sync(kFull,
                                            mismatch(lane + 32 * i, rc[i])));
        }
    } else {
        for (int i = 0; i < ni; ++i) {
            int p = lane + 32 * i;
            mis += __popc(__ballot_sync(kFull,
                                        mismatch(p, p < L ? rd[p] : 4)));
        }
    }
    *mis_out = mis;
    *span_out = span;
}

template <int NI>
__global__ void ungap_align_kernel(const uint8_t* __restrict__ codes,
                                   const int* __restrict__ lengths, int R,
                                   int L, const uint8_t* __restrict__ pool,
                                   int pool_n, const int* __restrict__ starts,
                                   const uint8_t* __restrict__ ok,
                                   const uint8_t* __restrict__ is_fwd,
                                   const int* __restrict__ cid,
                                   const int* __restrict__ ro,
                                   const int* __restrict__ clen, int SH,
                                   float min_identity, int* __restrict__ out_id,
                                   int* __restrict__ out_ro,
                                   float* __restrict__ out_ident,
                                   int* __restrict__ out_mis,
                                   int* __restrict__ out_span) {
    extern __shared__ int smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int r = blockIdx.x * (blockDim.x >> 5) + warp;
    if (r >= R) return;  // the whole warp leaves together
    int* s_score = smem + (size_t)warp * kArrays * SH;
    int* s_final = s_score + SH;
    int* s_cid = s_final + SH;
    int* s_ro = s_cid + SH;
    int* s_fc = s_ro + SH;  // orientation (bit 0), ok (bit 1)

    const uint8_t* rd = codes + (size_t)r * L;
    const int Lr = lengths[r];
    const int ni = (L + 31) / 32;
    uint8_t rc[NI > 0 ? NI : 1];
#pragma unroll
    for (int i = 0; i < (NI > 0 ? NI : 1); ++i) {
        int p = lane + 32 * i;
        rc[i] = (NI > 0 && p < L) ? rd[p] : 4;
    }

    const size_t base = (size_t)r * SH;
    for (int f = lane; f < SH; f += 32) {
        s_cid[f] = cid[base + f];
        s_ro[f] = ro[base + f];
        s_fc[f] = (is_fwd[base + f] ? 1 : 0) | (ok[base + f] ? 2 : 0);
        s_score[f] = INT_MIN;
    }
    __syncwarp();

    const float one_minus = __fsub_rn(1.0f, min_identity);
    // scores of the slots that can score
    for (int f = 0; f < SH; ++f) {
        if (!(s_fc[f] & 2)) continue;  // uniform across the warp
        Slot s{s_cid[f], s_ro[f], s_fc[f] & 1, clen[base + f]};
        int mis, span;
        count_slot<NI>(rc, rd, L, Lr, ni, pool, pool_n, starts[s.cid], s,
                       lane, &mis, &span);
        int thresh = (int)__fmul_rn(one_minus, __int2float_rn(span));
        if (lane == 0 && mis <= thresh && span > 0)
            s_score[f] = span - mis - 50 * mis;
    }
    __syncwarp();

    // dedup: a live slot with a live, equal (cid, ro, orientation) slot
    // before it loses its score
    for (int f = lane; f < SH; f += 32) {
        int sc = s_score[f];
        if (sc != INT_MIN) {
            for (int g = 0; g < f; ++g) {
                if (s_score[g] != INT_MIN && s_cid[g] == s_cid[f] &&
                    s_ro[g] == s_ro[f] && ((s_fc[g] ^ s_fc[f]) & 1) == 0) {
                    sc = INT_MIN;
                    break;
                }
            }
        }
        s_final[f] = sc;
    }
    __syncwarp();

    // first maximum, then how many slots share it
    int best = INT_MAX, best_sc = INT_MIN;
    for (int f = lane; f < SH; f += 32) {
        int sc = s_final[f];
        if (best == INT_MAX || sc > best_sc) {
            best_sc = sc;
            best = f;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        int o_sc = __shfl_xor_sync(kFull, best_sc, off);
        int o_f = __shfl_xor_sync(kFull, best, off);
        if (o_sc > best_sc || (o_sc == best_sc && o_f < best)) {
            best_sc = o_sc;
            best = o_f;
        }
    }
    int n_best = 0;
    for (int f = lane; f < SH; f += 32)
        n_best += (s_final[f] == best_sc && best_sc != INT_MIN) ? 1 : 0;
    n_best = __reduce_add_sync(kFull, n_best);
    const bool unique = best_sc != INT_MIN && n_best == 1;

    Slot b{s_cid[best], s_ro[best], s_fc[best] & 1, clen[base + best]};
    int mis, span;
    count_slot<NI>(rc, rd, L, Lr, ni, pool, pool_n, starts[b.cid], b, lane,
                   &mis, &span);
    if (lane == 0) {
        out_id[r] = unique ? (b.fwd ? b.cid + 1 : -(b.cid + 1)) : 0;
        out_ro[r] = b.ro;
        out_ident[r] = span > 0 ? __fdiv_rn(__int2float_rn(span - mis),
                                            __int2float_rn(max(span, 1)))
                                : 0.0f;
        out_mis[r] = mis;
        out_span[r] = span;
    }
}

template <int NI>
cudaError_t launch(const uint8_t* codes, const int* lengths, int R, int L,
                   const uint8_t* pool, int pool_n, const int* starts,
                   const uint8_t* ok, const uint8_t* is_fwd, const int* cid,
                   const int* ro, const int* clen, int SH, float min_identity,
                   int* out_id, int* out_ro, float* out_ident, int* out_mis,
                   int* out_span, int warps, cudaStream_t stream) {
    unsigned blocks = (unsigned)((R + warps - 1) / warps);
    size_t smem = (size_t)warps * kArrays * SH * sizeof(int);
    ungap_align_kernel<NI><<<blocks, 32 * warps, smem, stream>>>(
        codes, lengths, R, L, pool, pool_n, starts, ok, is_fwd, cid, ro, clen,
        SH, min_identity, out_id, out_ro, out_ident, out_mis, out_span);
    return cudaGetLastError();
}

}  // namespace

// C entry point. codes: (R, L) u8; lengths: (R,) int32; pool: (pool_n,) u8;
// starts: (C+1,) int32; ok, is_fwd: (R, SH) u8 (0/1); cid, ro, clen:
// (R, SH) int32; outputs (R,): id, ro, mis, span int32 and identity f32.
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue when
// one warp's S*H slot arrays do not fit in 48 KB of shared memory.
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
    if (L <= 0 || SH <= 0 || pool_n <= 0 ||
        (size_t)kArrays * SH * sizeof(int) > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    int warps = 8;
    while (warps > 1 && (size_t)warps * kArrays * SH * sizeof(int) > 48 * 1024)
        warps >>= 1;
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
    int ni = (L + 31) / 32;
#define PLATANUS_UNGAP(n)                                                     \
    return launch<n>(c, ln, R, L, pl, pool_n, st, okp, fw, ci, rp, cl, SH,   \
                     min_identity, oi, orp, oid, om, osp, warps, s)
    if (ni <= 4) PLATANUS_UNGAP(4);
    if (ni <= 8) PLATANUS_UNGAP(8);
    if (ni <= 16) PLATANUS_UNGAP(16);
    PLATANUS_UNGAP(0);
#undef PLATANUS_UNGAP
}
