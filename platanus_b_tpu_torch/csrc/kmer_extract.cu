// kmer_extract: fused 2-bit unpack + canonical k-mer extraction for Hopper.
//
// Replaces platanus_b_tpu/ops/kmer.py:unpack_codes / unpack_codes_lens
// (:98, :115) + extract_canonical_kmers / extract_forward_kmers (:25, :69),
// which XLA fuses inside ops/count.py:304-374 on the TPU.
//
// Bound: bytes. The pass reads 4 bytes of packed words per 16 bases (and the
// N-mask or the lengths) and writes L = ceil(W/2) int64 lanes per window, so
// the lane stores (8 L bytes per window) are nearly all of its traffic. The
// few dozen integer operations per window come close behind: the canonical
// pass takes a little longer than the forward-only one.
// Design, so that little but the stores costs:
// - one block of 128 threads per tile. A tile is a run of whole reads
//   (reads of up to kWholeWords words) or a window range of one long row,
//   so window and read indices inside a tile are 32-bit and no window
//   needs a division. (A persistent grid of a few blocks per SM walking
//   over the tiles measured slower on the H100 at the main path's shapes,
//   with 128 or 256 threads and with tiles balanced over the blocks; see
//   PERF.md);
// - the tile's packed words and N-mask come into shared memory with
//   coalesced 16-byte loads; each window's forward words are cut from there
//   with __funnelshift_l (16 bases per word), the reverse complement with ~
//   and a 2-bit group reversal of the same slices, all in registers (W is a
//   template parameter, so the word arrays never spill);
// - validity is one funnel-shifted 64-bit slice of the N-mask for k <= 64,
//   a difference of per-row prefix counts of N bits in shared memory above
//   it, or the read's length;
// - consecutive threads write consecutive windows' lanes, as 16-byte
//   streaming stores when L is even;
// - each thread counts its valid windows in a register; the block reduces
//   them and does one atomicAdd on n_valid (one per tile of about 4,000
//   windows, not one per warp).
// Keys are sign-flipped int64 lanes; SENTINEL = INT64_MAX where the window
// touches an N or padding.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreadsLog2 = 7;
constexpr int kThreads = 1 << kThreadsLog2;
constexpr int kWarps = kThreads / 32;
constexpr int kTileWindows = 4096;  // windows a tile aims for
constexpr int kWholeWords = 64;     // rows of <= 1024 bases go whole into tiles
constexpr int kPad = 4;             // zero words after each shared slice
constexpr int kSmemWords = 10240;   // 40 KB of slices per block at most

struct Plan {
    int whole;      // 1: tiles of `rows` whole rows; 0: window ranges of a row
    int rows;       // rows per tile (1 for window ranges)
    int span;       // windows per tile and row (P for whole rows)
    int per_row;    // tiles per row (1 for whole rows)
    int gshift;     // log2(threads per row)
    int cap_w;      // words of the word slice, padding and alignment included
    int cap_n;      // the same for the N-mask slice (0 without it)
    int cap_pre;    // prefix counts (k > 64 with an N-mask)
    long long tiles;
};

// reverses the order of the 16 2-bit groups: a bit reversal, then each
// group's two bits swapped back
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
    const uint32_t y = __brev(x);
    return ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
}

// Copies n words from global memory into dst (16-byte aligned) with 16-byte
// loads, and zeroes kPad words after them. The copy starts at dst + off,
// off = the source's word offset modulo 4, so that source and destination
// quads line up; returns off.
__device__ __forceinline__ int load_slice(uint32_t* dst,
                                          const uint32_t* __restrict__ src,
                                          int n) {
    const int off = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    const int head = min((4 - off) & 3, n);
    uint32_t* d = dst + off;
    if ((int)threadIdx.x < head) d[threadIdx.x] = __ldg(src + threadIdx.x);
    const int nq = (n - head) >> 2;
    const uint4* sq = reinterpret_cast<const uint4*>(src + head);
    uint4* dq = reinterpret_cast<uint4*>(d + head);
    for (int i = threadIdx.x; i < nq; i += kThreads) dq[i] = __ldg(sq + i);
    for (int i = head + 4 * nq + threadIdx.x; i < n; i += kThreads)
        d[i] = __ldg(src + i);
    if ((int)threadIdx.x < kPad) d[n + threadIdx.x] = 0u;
    return off;
}

template <int W, bool FORWARD_ONLY, bool USE_NMASK>
__global__ void __launch_bounds__(kThreads)
kmer_extract_kernel(const uint32_t* __restrict__ words,
                    const uint32_t* __restrict__ nmask,
                    const int* __restrict__ lengths, int R, int Lw, int P,
                    int k, Plan pl, long long* __restrict__ out,
                    unsigned long long* __restrict__ n_valid) {
    constexpr int L = (W + 1) / 2;
    constexpr bool kBigK = USE_NMASK && W > 4;  // k > 64: prefix counts
    extern __shared__ uint4 smem_q[];
    uint32_t* s_w = reinterpret_cast<uint32_t*>(smem_q);
    uint32_t* s_n = s_w + pl.cap_w;
    int* s_pre = reinterpret_cast<int*>(s_n + pl.cap_n);
    int* s_len = s_pre + pl.cap_pre;
    __shared__ unsigned s_red[kWarps];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int G = 1 << pl.gshift;  // threads per row
    const int nb = k - 16 * (W - 1);  // bases in word 0 (1..16)
    const uint32_t top_mask = nb == 16 ? 0xFFFFFFFFu : ((1u << (2 * nb)) - 1u);
    const int Ln = Lw / 2;
    unsigned count = 0;

    const long long t = blockIdx.x;  // the block's tile
    int r0, p0, rows, p_end, w0, nw, m0 = 0, nm = 0;
    if (pl.whole) {
        r0 = (int)(t * pl.rows);
        rows = min(pl.rows, R - r0);
        p0 = 0;
        p_end = P;
        w0 = 0;
        nw = rows * Lw;
        nm = rows * Ln;
    } else {
        r0 = (int)(t / pl.per_row);
        p0 = (int)(t - (long long)r0 * pl.per_row) * pl.span;
        rows = 1;
        p_end = min(P, p0 + pl.span);
        w0 = p0 >> 4;
        nw = min(Lw, w0 + (pl.span + k) / 16 + 2) - w0;
        m0 = p0 >> 5;
        nm = min(Ln, m0 + (pl.span + k) / 32 + 3) - m0;
    }
    const int offw = load_slice(s_w, words + (size_t)r0 * Lw + w0, nw);
    int offn = 0;
    if (USE_NMASK)
        offn = load_slice(s_n, nmask + (size_t)r0 * Ln + m0, nm);
    else
        for (int i = tid; i < rows; i += kThreads)
            s_len[i] = __ldg(lengths + r0 + i);
    __syncthreads();
    const int nmr = pl.whole ? Ln : nm;  // N-mask words of a tile row
    if (kBigK) {
        // s_pre[rr (nmr + 1) + i] = N bits in the row's first i words
        for (int rr = warp; rr < rows; rr += kWarps) {
            const uint32_t* row = s_n + offn + rr * Ln;
            int* pre = s_pre + rr * (nmr + 1);
            int carry = 0;
            if (lane == 0) pre[0] = 0;
            for (int c = 0; c < nmr; c += 32) {
                int i = c + lane;
                int v = i < nmr ? __popc(row[i]) : 0;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
                    if (lane >= d) v += u;
                }
                if (i < nmr) pre[i + 1] = carry + v;
                carry += __shfl_sync(0xFFFFFFFFu, v, 31);
            }
        }
        __syncthreads();
    }

    long long* otile = out + ((size_t)r0 * P + p0) * L;
    for (int rr = tid >> pl.gshift; rr < rows; rr += kThreads >> pl.gshift) {
        const uint32_t* wrow = s_w + offw + rr * Lw - w0;  // indexed by word
        const uint32_t* nrow = s_n + offn + rr * Ln - m0;
        const int* pre = s_pre + rr * (nmr + 1) - m0;
        long long* orow = otile + rr * P * L;
        for (int p = p0 + (tid & (G - 1)); p < p_end; p += G) {
            bool valid;
            if (!USE_NMASK) {
                valid = p + k <= s_len[rr];
            } else if (!kBigK) {
                // bits p .. p+k-1 of the row's mask, bit 31 first
                const int wi = p >> 5, sh = p & 31;
                const uint32_t hi =
                    __funnelshift_l(nrow[wi + 1], nrow[wi], sh);
                if (W <= 2) {
                    valid = (hi >> (32 - k)) == 0u;
                } else {
                    const uint32_t lo =
                        __funnelshift_l(nrow[wi + 2], nrow[wi + 1], sh);
                    valid = hi == 0u && (lo >> (64 - k)) == 0u;
                }
            } else {
                auto before = [&](int q) {  // N bits at positions < q
                    int c = pre[q >> 5];
                    if (q & 31) c += __popc(nrow[q >> 5] >> (32 - (q & 31)));
                    return c;
                };
                valid = before(p + k) == before(p);
            }
            count += valid ? 1u : 0u;

            // 16 bases starting at base q, base q in the top two bits
            auto ex16 = [&](int q) {
                const int wi = q >> 4;
                return __funnelshift_l(wrow[wi + 1], wrow[wi], (q & 15) * 2);
            };
            uint32_t f[W];
            uint32_t rc[W];
#pragma unroll
            for (int j = 0; j < W; ++j) {
                if (j == 0) {
                    uint32_t v = ex16(p);
                    f[0] = nb == 16 ? v : (v >> (2 * (16 - nb)));
                } else {
                    f[j] = ex16(p + k - 16 * (W - j));
                }
                if (!FORWARD_ONLY) {
                    // reverse-complement word j: complement of the 16
                    // forward bases starting at 16 (W-1-j), reversed
                    rc[j] = rev2(~ex16(p + 16 * (W - 1 - j)));
                    if (j == 0) rc[0] &= top_mask;
                }
            }
            // the key word by word (a pointer to f or rc would put both
            // arrays in local memory)
            uint32_t key[W];
#pragma unroll
            for (int j = 0; j < W; ++j) key[j] = f[j];
            if (!FORWARD_ONLY) {
                bool le = true;  // f <= rc, lexicographic from word 0
                bool decided = false;
#pragma unroll
                for (int j = 0; j < W; ++j) {
                    if (!decided && f[j] != rc[j]) {
                        le = f[j] < rc[j];
                        decided = true;
                    }
                }
#pragma unroll
                for (int j = 0; j < W; ++j) key[j] = le ? f[j] : rc[j];
            }
            // an odd W leaves the last lane's low word missing: it is 0,
            // except for the all-ones key, whose lanes are all INT64_MAX
            // like the SENTINEL's (ops/keys.py:words_to_lanes)
            uint32_t pad = 0u;
            if (W % 2) {
                uint32_t all = 0xFFFFFFFFu;
#pragma unroll
                for (int j = 0; j < W; ++j) all &= key[j];
                pad = all == 0xFFFFFFFFu ? 0xFFFFFFFFu : 0u;
            }
            long long lane_v[L];
#pragma unroll
            for (int j = 0; j < L; ++j) {
                uint64_t hi = key[2 * j];
                uint64_t lo = (2 * j + 1 < W) ? key[2 * j + 1] : pad;
                lane_v[j] = valid
                    ? (long long)(((hi << 32) | lo) ^ 0x8000000000000000ull)
                    : 0x7FFFFFFFFFFFFFFFll;
            }
            long long* o = orow + (p - p0) * L;
            if (L % 2 == 0) {
#pragma unroll
                for (int j = 0; j < L; j += 2)
                    __stcs(reinterpret_cast<longlong2*>(o + j),
                           make_longlong2(lane_v[j], lane_v[j + 1]));
            } else {
#pragma unroll
                for (int j = 0; j < L; ++j) __stcs(o + j, lane_v[j]);
            }
        }
    }

    count = __reduce_add_sync(0xFFFFFFFFu, count);
    if (lane == 0) s_red[warp] = count;
    __syncthreads();
    if (tid == 0) {
        unsigned long long total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += s_red[w];
        if (total) atomicAdd(n_valid, total);
    }
}

int round4(int n) { return (n + 3) & ~3; }

// Tiles and shared memory for one call; returns the bytes of shared memory.
size_t make_plan(int R, int Lw, int P, int k, bool nmask, bool big_k,
                 Plan* pl) {
    const int Ln = Lw / 2;
    if (Lw <= kWholeWords) {
        const int row_words = Lw + (nmask ? Ln + (big_k ? Ln + 1 : 0) : 1);
        const int fit = (kSmemWords - 64) / row_words;  // >= 78 rows
        int g = 0;
        // threads per row: a power of two >= P, <= 32, such that the rows
        // of one pass fit in shared memory
        while ((1 << g) < P && g < 5) ++g;
        while ((kThreads >> g) > fit) ++g;
        const int per_pass = kThreads >> g;
        int rows = min(max(kTileWindows / P, 1), fit);
        rows = max(rows / per_pass * per_pass, per_pass);
        pl->whole = 1;
        pl->rows = rows;
        pl->span = P;
        pl->per_row = 1;
        pl->gshift = g;
        pl->cap_w = round4(rows * Lw + 3 + kPad);
        pl->cap_n = nmask ? round4(rows * Ln + 3 + kPad) : 0;
        pl->cap_pre = nmask && big_k ? rows * (Ln + 1) : 0;
        pl->tiles = ((long long)R + rows - 1) / rows;
        return 4 * (size_t)(pl->cap_w + pl->cap_n + pl->cap_pre +
                            (nmask ? 0 : rows));
    }
    const int span = kTileWindows;
    pl->whole = 0;
    pl->rows = 1;
    pl->span = span;
    pl->per_row = (P + span - 1) / span;
    pl->gshift = kThreadsLog2;  // all threads on the row
    const int nw = (span + k) / 16 + 2, nm = (span + k) / 32 + 3;
    pl->cap_w = round4(nw + 3 + kPad);
    pl->cap_n = nmask ? round4(nm + 3 + kPad) : 0;
    pl->cap_pre = nmask && big_k ? nm + 1 : 0;
    pl->tiles = (long long)R * pl->per_row;
    return 4 * (size_t)(pl->cap_w + pl->cap_n + pl->cap_pre + (nmask ? 0 : 1));
}

template <int W, bool FWD>
cudaError_t launch_w(const uint32_t* words, const uint32_t* nmask,
                     const int* lengths, int R, int Lw, int P, int k,
                     long long* out, unsigned long long* n_valid,
                     cudaStream_t stream) {
    const bool nm = nmask != nullptr;
    Plan pl;
    const size_t smem = make_plan(R, Lw, P, k, nm, W > 4, &pl);
    if (pl.tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    auto kern = nm ? kmer_extract_kernel<W, FWD, true>
                   : kmer_extract_kernel<W, FWD, false>;
    kern<<<(unsigned)pl.tiles, kThreads, smem, stream>>>(
        words, nmask, lengths, R, Lw, P, k, pl, out, n_valid);
    return cudaGetLastError();
}

template <bool FWD>
cudaError_t dispatch(int W, const uint32_t* words, const uint32_t* nmask,
                     const int* lengths, int R, int Lw, int P, int k,
                     long long* out, unsigned long long* n_valid,
                     cudaStream_t s) {
    switch (W) {
#define PLATANUS_W(n) \
    case n: return launch_w<n, FWD>(words, nmask, lengths, R, Lw, P, k, out, n_valid, s);
        PLATANUS_W(1) PLATANUS_W(2) PLATANUS_W(3) PLATANUS_W(4)
        PLATANUS_W(5) PLATANUS_W(6) PLATANUS_W(7) PLATANUS_W(8)
        PLATANUS_W(9) PLATANUS_W(10) PLATANUS_W(11) PLATANUS_W(12)
        PLATANUS_W(13) PLATANUS_W(14) PLATANUS_W(15) PLATANUS_W(16)
#undef PLATANUS_W
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// C entry point. words: (R, Lw) u32; nmask: (R, Lw/2) u32 or null; lengths:
// (R,) int32 (used when nmask is null); out: (R, P, L) int64 lanes;
// n_valid: one u64 accumulator (zeroed by the caller). Windows start at
// 0..P-1, so P + k - 1 <= 16 Lw. Returns the launch's cudaGetLastError().
extern "C" int platanus_kmer_extract(const void* words, const void* nmask,
                                     const void* lengths, int R, int Lw, int P,
                                     int k, int W, int forward_only, void* out,
                                     void* n_valid, void* stream) {
    if (R <= 0 || P <= 0) return 0;
    if (k < 1 || W < 1 || W > 16 || k - 16 * (W - 1) < 1 || k - 16 * (W - 1) > 16)
        return (int)cudaErrorInvalidValue;
    if ((long long)P + k - 1 > 16LL * Lw || (nmask != nullptr && Lw % 2))
        return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    auto w = static_cast<const uint32_t*>(words);
    auto nm = static_cast<const uint32_t*>(nmask);
    auto ln = static_cast<const int*>(lengths);
    auto o = static_cast<long long*>(out);
    auto nv = static_cast<unsigned long long*>(n_valid);
    cudaError_t err = forward_only
        ? dispatch<true>(W, w, nm, ln, R, Lw, P, k, o, nv, s)
        : dispatch<false>(W, w, nm, ln, R, Lw, P, k, o, nv, s);
    return (int)err;
}
