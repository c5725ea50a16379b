// kmer_extract: fused 2-bit unpack + canonical k-mer extraction for Hopper.
//
// Replaces platanus_b_tpu/ops/kmer.py:unpack_codes / unpack_codes_lens
// (:98, :115) + extract_canonical_kmers / extract_forward_kmers (:25, :69),
// which XLA fuses inside ops/count.py:304-374 on the TPU.
//
// Bound: bytes. Each window reads about 2W packed words (mostly L1 hits,
// neighbouring threads share them) and writes L = ceil(W/2) int64 lanes, so
// the pass is limited by the lane stores (8 L bytes per window) and does a
// few dozen integer operations per window.
// Design: one thread per (read, window). The forward words are cut from the
// packed read with a funnel shift (16 bases per word), the reverse
// complement with ~ and a 2-bit group reversal of the same 16-base slices,
// all in registers (W is a template parameter, so the word arrays never
// spill to local memory). The thread keeps the lexicographic minimum,
// encodes it as sign-flipped int64 lanes (SENTINEL = INT64_MAX where the
// window touches an N or padding), and a warp ballot counts valid windows
// with one atomic per warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t extract16(const uint32_t* row, int Lw, int q) {
    // 16 bases starting at base position q, base q in the top two bits
    int wi = q >> 4;
    int sh = (q & 15) * 2;
    uint32_t a = row[wi];
    if (sh == 0) return a;
    uint32_t b = (wi + 1 < Lw) ? row[wi + 1] : 0u;
    return (a << sh) | (b >> (32 - sh));
}

__device__ __forceinline__ uint32_t rev2(uint32_t x) {
    x = ((x >> 2) & 0x33333333u) | ((x & 0x33333333u) << 2);
    x = ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);
    x = ((x >> 8) & 0x00FF00FFu) | ((x & 0x00FF00FFu) << 8);
    return (x >> 16) | (x << 16);
}

template <int W, bool FORWARD_ONLY, bool USE_NMASK>
__global__ void __launch_bounds__(kThreads)
kmer_extract_kernel(const uint32_t* __restrict__ words,
                    const uint32_t* __restrict__ nmask,
                    const int* __restrict__ lengths,
                    int R, int Lw, int P, int k,
                    long long* __restrict__ out,
                    unsigned long long* __restrict__ n_valid) {
    constexpr int L = (W + 1) / 2;
    long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    bool valid = false;
    if (gid < (long long)R * P) {
        int r = (int)(gid / P);
        int p = (int)(gid - (long long)r * P);
        const uint32_t* row = words + (size_t)r * Lw;
        if (USE_NMASK) {
            const uint32_t* nrow = nmask + (size_t)r * (Lw / 2);
            valid = true;
            int end = p + k;  // exclusive
            for (int q = p; q < end; q = (q & ~31) + 32) {
                uint32_t m = nrow[q >> 5];
                int lo = q & 31;
                int hi = min(end - (q & ~31), 32);  // exclusive bit count
                // bits lo..hi-1 counted from the top (bit 31 = position 0)
                uint32_t sel = (hi - lo == 32) ? 0xFFFFFFFFu
                    : (((1u << (hi - lo)) - 1u) << (32 - hi));
                if (m & sel) { valid = false; break; }
            }
        } else {
            valid = p + k <= lengths[r];
        }

        uint32_t f[W];
        uint32_t rc[W];
        const int nb = k - 16 * (W - 1);  // bases in word 0 (1..16)
        const uint32_t top_mask = nb == 16 ? 0xFFFFFFFFu : ((1u << (2 * nb)) - 1u);
#pragma unroll
        for (int j = 0; j < W; ++j) {
            if (j == 0) {
                uint32_t v = extract16(row, Lw, p);
                f[0] = nb == 16 ? v : (v >> (2 * (16 - nb)));
            } else {
                f[j] = extract16(row, Lw, p + k - 16 * (W - j));
            }
            if (!FORWARD_ONLY) {
                // reverse-complement word j: complement of the 16 forward
                // bases starting at 16 (W-1-j), in reversed order
                rc[j] = rev2(~extract16(row, Lw, p + 16 * (W - 1 - j)));
                if (j == 0) rc[0] &= top_mask;
            }
        }
        const uint32_t* key = f;
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
            key = le ? f : rc;
        }
        // an odd W leaves the last lane's low word missing: it is 0, except
        // for the all-ones key, whose lanes are all INT64_MAX like the
        // SENTINEL's (ops/keys.py:words_to_lanes)
        uint32_t pad = 0u;
        if (W % 2) {
            uint32_t all = 0xFFFFFFFFu;
#pragma unroll
            for (int j = 0; j < W; ++j) all &= key[j];
            pad = all == 0xFFFFFFFFu ? 0xFFFFFFFFu : 0u;
        }
        long long* o = out + gid * L;
#pragma unroll
        for (int j = 0; j < L; ++j) {
            long long lane;
            if (valid) {
                uint64_t hi = key[2 * j];
                uint64_t lo = (2 * j + 1 < W) ? key[2 * j + 1] : pad;
                lane = (long long)(((hi << 32) | lo) ^ 0x8000000000000000ull);
            } else {
                lane = 0x7FFFFFFFFFFFFFFFll;
            }
            o[j] = lane;
        }
    }
    unsigned ballot = __ballot_sync(0xFFFFFFFFu, valid);
    if ((threadIdx.x & 31) == 0 && ballot)
        atomicAdd(n_valid, (unsigned long long)__popc(ballot));
}

template <int W, bool FWD>
cudaError_t launch_w(const uint32_t* words, const uint32_t* nmask,
                     const int* lengths, int R, int Lw, int P, int k,
                     long long* out, unsigned long long* n_valid,
                     cudaStream_t stream) {
    long long total = (long long)R * P;
    unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    if (nmask != nullptr)
        kmer_extract_kernel<W, FWD, true><<<blocks, kThreads, 0, stream>>>(
            words, nmask, lengths, R, Lw, P, k, out, n_valid);
    else
        kmer_extract_kernel<W, FWD, false><<<blocks, kThreads, 0, stream>>>(
            words, nmask, lengths, R, Lw, P, k, out, n_valid);
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
// n_valid: one u64 accumulator (zeroed by the caller). Returns the launch's
// cudaGetLastError().
extern "C" int platanus_kmer_extract(const void* words, const void* nmask,
                                     const void* lengths, int R, int Lw, int P,
                                     int k, int W, int forward_only, void* out,
                                     void* n_valid, void* stream) {
    if (R <= 0 || P <= 0) return 0;
    if (k < 1 || W < 1 || W > 16 || k - 16 * (W - 1) < 1 || k - 16 * (W - 1) > 16)
        return (int)cudaErrorInvalidValue;
    if ((long long)R * P / kThreads + 1 > 0x7FFFFFFFll)
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
