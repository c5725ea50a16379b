// list_rank: pointer-doubling list ranking and the cycle cut's min-pair
// propagation for Hopper.
//
// Port of two device loops of the JAX package's unitig labeling, each
// compiled by XLA into one device program:
// - _doubling_rank (platanus_b_tpu/models/dbg.py:191-214), a
//   lax.while_loop of at most `iters` steps that leaves once no pointer
//   is live, the exit test running on the device. One step, for every id
//   i whose pointer p = ptr[i] is live (p >= 0):
//     rank[i] += rank[p]; anchor[i] = anchor[p]; ptr[i] = ptr[p]
//   reading only the previous step's arrays (Wyllie's synchronous step).
// - the min-pair loop of the cycle cut (dbg.py:273-285), a lax.fori_loop
//   of exactly `iters` steps: for every live i, (a[i], b[i]) takes
//   (a[p], b[p]) if that pair is lexicographically smaller, and
//   ptr[i] = ptr[p].
// Ids index (m,) int64 arrays; a pointer at or past m reads row m - 1, as
// the reference's clip does.
//
// Design: one kernel launch a step, all queued by the host without a
// sync, each reading one buffer and writing the other (double buffering
// keeps every step synchronous, so ptr, rank and anchor equal the plain
// version's bit for bit, cycle members and a binding cap included: an
// in-place step would read neighbours already updated). Each step raises
// flags[s + 1] (atomicOr, once a warp) when a pointer of its output is
// live; a step whose flags[s] is 0 returns at once, so the steps after the
// last live pointer cost a launch each and no memory traffic. Step 0
// always runs and raises flags[0] from its input. A running step records
// s + 1 in flags[iters + 1]; a finishing kernel then copies the result
// into the input buffer when an odd number of steps ran, and writes
// stats = {steps that did work, 1 if a pointer is still live}, which the
// caller reads with one 16-byte copy in place of a reduction a step.
// The min-pair loop has no exit test: its `iters` steps all run, and the
// caller takes the result from buffer iters % 2.
//
// Bound: memory. A step reads ptr, rank, anchor in order and gathers them
// at p (random 8-byte reads, a 32-byte sector each), and writes three
// arrays; there is no arithmetic to speak of. The function's own bytes
// are ptr read once and ptr, rank, anchor written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ long long clip(long long p, long long m) {
    return p < m ? p : m - 1;
}

// Warp vote then one atomic a warp: flag |= any(live) over the warp.
__device__ __forceinline__ void raise_flag(int* flag, bool live) {
    const unsigned any = __ballot_sync(0xffffffffu, live);
    if (any && (threadIdx.x & 31) == 0) atomicOr(flag, 1);
}

__global__ void __launch_bounds__(kThreads)
rank_step(const long long* __restrict__ ptr, const long long* __restrict__ rank,
          const long long* __restrict__ anchor, long long* __restrict__ ptr_o,
          long long* __restrict__ rank_o, long long* __restrict__ anchor_o,
          long long m, int s, int iters, int* __restrict__ flags) {
    if (s > 0 && flags[s] == 0) return;
    if (blockIdx.x == 0 && threadIdx.x == 0) flags[iters + 1] = s + 1;
    bool in_live = false, out_live = false;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < m; i += stride) {
        const long long p = ptr[i];
        if (p >= 0) {
            const long long q = clip(p, m);
            const long long np = ptr[q];
            rank_o[i] = rank[i] + rank[q];
            anchor_o[i] = anchor[q];
            ptr_o[i] = np;
            in_live = true;
            out_live |= np >= 0;
        } else {
            rank_o[i] = rank[i];
            anchor_o[i] = anchor[i];
            ptr_o[i] = p;
        }
    }
    if (s == 0) raise_flag(&flags[0], in_live);
    raise_flag(&flags[s + 1], out_live);
}

__global__ void __launch_bounds__(kThreads)
rank_finish(long long* __restrict__ ptr, long long* __restrict__ rank,
            long long* __restrict__ anchor, const long long* __restrict__ ptr1,
            const long long* __restrict__ rank1,
            const long long* __restrict__ anchor1, long long m, int iters,
            const int* __restrict__ flags, long long* __restrict__ stats) {
    const int ran = flags[iters + 1];
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        stats[0] = flags[0] ? ran : 0;
        stats[1] = flags[iters];
    }
    if ((ran & 1) == 0) return;  // the result is in the first buffer
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < m; i += stride) {
        ptr[i] = ptr1[i];
        rank[i] = rank1[i];
        anchor[i] = anchor1[i];
    }
}

__global__ void __launch_bounds__(kThreads)
min_pair_step(const long long* __restrict__ ptr,
              const long long* __restrict__ a, const long long* __restrict__ b,
              long long* __restrict__ ptr_o, long long* __restrict__ a_o,
              long long* __restrict__ b_o, long long m) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < m; i += stride) {
        const long long p = ptr[i];
        long long ai = a[i], bi = b[i], np = p;
        if (p >= 0) {
            const long long q = clip(p, m);
            const long long ap = a[q], bp = b[q];
            if (ap < ai || (ap == ai && bp < bi)) {
                ai = ap;
                bi = bp;
            }
            np = ptr[q];
        }
        ptr_o[i] = np;
        a_o[i] = ai;
        b_o[i] = bi;
    }
}

int grid_for(long long m) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long blocks = (m + kThreads - 1) / kThreads;
    const long long most = (long long)sms * kBlocksPerSm;
    return (int)(blocks < most ? (blocks > 0 ? blocks : 1) : most);
}

}  // namespace

// Pointer doubling over (m,) int64 arrays. Buffer 0 (ptr0, rank0, anchor0)
// holds the input and receives the result; buffer 1 is scratch of the
// same size. flags: iters + 2 int32 of scratch; stats: 2 int64 out.
extern "C" int platanus_list_rank(void* ptr0, void* rank0, void* anchor0,
                                  void* ptr1, void* rank1, void* anchor1,
                                  long long m, int iters, void* flags,
                                  void* stats, void* stream) {
    if (m < 0 || iters < 1) return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    auto* f = static_cast<int*>(flags);
    cudaError_t e = cudaMemsetAsync(f, 0, sizeof(int) * (iters + 2), s);
    if (e != cudaSuccess) return (int)e;
    long long* buf[2][3] = {
        {static_cast<long long*>(ptr0), static_cast<long long*>(rank0),
         static_cast<long long*>(anchor0)},
        {static_cast<long long*>(ptr1), static_cast<long long*>(rank1),
         static_cast<long long*>(anchor1)}};
    const int grid = grid_for(m);
    for (int step = 0; step < iters; ++step) {
        long long* const* in = buf[step & 1];
        long long* const* out = buf[(step + 1) & 1];
        rank_step<<<grid, kThreads, 0, s>>>(in[0], in[1], in[2], out[0],
                                            out[1], out[2], m, step, iters, f);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    rank_finish<<<grid, kThreads, 0, s>>>(
        buf[0][0], buf[0][1], buf[0][2], buf[1][0], buf[1][1], buf[1][2], m,
        iters, f, static_cast<long long*>(stats));
    return (int)cudaGetLastError();
}

// The min-pair loop over (m,) int64 arrays: `iters` steps, step s reading
// buffer s % 2 and writing the other; the result is in buffer iters % 2.
extern "C" int platanus_min_pair(void* ptr0, void* a0, void* b0, void* ptr1,
                                 void* a1, void* b1, long long m, int iters,
                                 void* stream) {
    if (m < 0 || iters < 1) return (int)cudaErrorInvalidValue;
    if (m == 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    long long* buf[2][3] = {
        {static_cast<long long*>(ptr0), static_cast<long long*>(a0),
         static_cast<long long*>(b0)},
        {static_cast<long long*>(ptr1), static_cast<long long*>(a1),
         static_cast<long long*>(b1)}};
    const int grid = grid_for(m);
    for (int step = 0; step < iters; ++step) {
        long long* const* in = buf[step & 1];
        long long* const* out = buf[(step + 1) & 1];
        min_pair_step<<<grid, kThreads, 0, s>>>(in[0], in[1], in[2], out[0],
                                                out[1], out[2], m);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}
