// Exact k-th-value threshold + strictly-greater mask for Hopper (sm_90a).
//
// Replaces the TPU kernel `_median_mask_kernel` (avtubes/ops/median_select.py,
// launched by `median_mask_pallas`).  Per map of n non-negative finite f32
// values it finds the k-th smallest element exactly — ties and all,
// bit-identical to sort(x)[k] — and writes the mask `x > that` as {0,1}
// float32.  The int32 bit patterns of non-negative floats order like the
// floats, and counting integers has no rounding, so there is no tolerance.
//
// Bound on this card: by bytes on paper (one read and one write of the map,
// a handful of integer operations per element), but a serving batch is 8 maps
// of 196 KB: the bytes take about a microsecond, so what limits it is how
// many SMs work and how many grid-wide steps are serial.  The design:
//
//   * One map = one CLUSTER of 8 thread blocks (1024 threads each) on
//     neighbouring SMs; a block owns an eighth of the map and keeps it in
//     REGISTERS (up to 16 values a thread, 16-byte loads when the pointers
//     and n allow), so device memory is read exactly once.  A batch of 8 maps
//     fills 64 SMs.
//   * Radix select, most significant digit first, over the 31 value bits as
//     11 + 10 + 10: three passes.  In a pass every block histograms the
//     current digit of its elements that still match the prefix found so
//     far, in its own shared memory, and sums every 32 bins into a group
//     total.  After one cluster barrier, one warp of every block reads the
//     eight blocks' group totals through distributed shared memory
//     (`map_shared_rank`), scans them for the group that holds rank k, then
//     reads only that group's 32 bins from the eight blocks and scans those:
//     the bin is appended to the prefix and the count below it comes off k.
//     Every block computes the same choice from the same sums, so no
//     broadcast across the cluster is needed.  Reading whole histograms
//     remotely (16 K loads a block and pass) cost more than everything else
//     together; the two levels read 768.  Each pass has a histogram of its
//     own (zeroed once at the start), so a pass costs ONE cluster barrier; a
//     last barrier keeps a block's shared memory alive until its neighbours
//     have read it.  After the third pass the prefix IS the k-th smallest
//     bit pattern.
//   * Plateaus.  A min-max-normalised map puts its top digit in a handful of
//     bins, and a constant map puts every element in one.  Plain
//     `atomicAdd` on shared memory takes that in its stride on this card
//     (a constant map times like a random one), where grouping a warp's
//     lanes by digit first (`__match_any_sync`) cost a quarter of the kernel's
//     time, so the adds are plain.
//   * A map too large for the registers of its 8 blocks (more than 131072
//     values) takes the same kernel with RESIDENT = false: each pass re-reads
//     the block's share from global memory (L2).  VEC = false (n not a
//     multiple of 4, or pointers off a 16-byte boundary) uses 4-byte loads
//     and stores.  The variant is chosen from n and the pointers alone.
//
// NaN and negative inputs (sign bit set) are outside the contract: their bit
// patterns do not order like the floats.  Nothing here clamps or checks them
// (a value with the sign bit set is counted in no pass).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int NTHREADS = 1024;
constexpr int NWARPS = NTHREADS / 32;
constexpr int CLUSTER = 8;            // blocks per map: the portable cluster size
constexpr int ITEMS = 16;             // values a thread keeps in registers
constexpr int NPASS = 3;
// pass p looks at bits [digit_shift(p), digit_shift(p) + digit_bits(p)) of the
// 31 value bits: 11 + 10 + 10 (`RADIX_DIGITS` of ops/median_select.py)
__host__ __device__ constexpr int digit_bits(int p) { return p == 0 ? 11 : 10; }
__host__ __device__ constexpr int digit_shift(int p) { return p == 0 ? 20 : (p == 1 ? 10 : 0); }
// where pass p's histogram starts in the block's shared array
__host__ __device__ constexpr int hist_offset(int p) { return p == 0 ? 0 : (p == 1 ? 2048 : 3072); }
constexpr int HIST_TOTAL = 4096;
constexpr int GROUP = 32;             // bins summed into one group total

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL_MASK, v, off);
    return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(FULL_MASK, v, off);
        if (lane >= off) v += up;
    }
    return v;
}

// All threads of all blocks of the cluster arrive / wait; the `.aligned` forms
// need every warp converged, hence the __syncwarp.
__device__ __forceinline__ void cluster_arrive() {
    __syncwarp();
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    __syncwarp();
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <bool RESIDENT, bool VEC>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NTHREADS)
median_mask_kernel(const int* __restrict__ pred_bits, float* __restrict__ out,
                   int n, int k) {
    constexpr int U = VEC ? 4 : 1;          // values per load
    constexpr int UNITS = ITEMS / U;        // loads a thread keeps
    __shared__ int hist[HIST_TOTAL];        // one histogram per pass
    __shared__ int group_total[NPASS][64];  // per pass: sums over GROUP bins
    __shared__ int chosen[NPASS][2];        // per pass: the bin, the count below it

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const size_t map_offset = static_cast<size_t>(blockIdx.x / CLUSTER) * n;
    const int* src = pred_bits + map_offset;
    float* dst = out + map_offset;

    // this block's share of the map, in loads of U values
    const int units = n / U;
    const int share = (units + CLUSTER - 1) / CLUSTER;
    const int u0 = min(rank * share, units);
    const int count = min(share, units - u0);
    const int per_thread = (count + NTHREADS - 1) / NTHREADS;   // block-uniform

    for (int i = tid; i < HIST_TOTAL; i += NTHREADS) hist[i] = 0;

    // -1 (sign bit set) marks a slot past the share: it matches no prefix
    int v[ITEMS];
    if constexpr (RESIDENT) {
#pragma unroll
        for (int j = 0; j < UNITS; ++j) {
            const int idx = tid + j * NTHREADS;
            if constexpr (VEC) {
                int4 q = make_int4(-1, -1, -1, -1);
                if (idx < count) q = reinterpret_cast<const int4*>(src)[u0 + idx];
                v[4 * j] = q.x; v[4 * j + 1] = q.y; v[4 * j + 2] = q.z; v[4 * j + 3] = q.w;
            } else {
                v[j] = idx < count ? src[u0 + idx] : -1;
            }
        }
    }
    __syncthreads();

    // f(value) for every value of the share
    auto for_each_value = [&](auto&& f) {
        if constexpr (RESIDENT) {
#pragma unroll
            for (int j = 0; j < UNITS; ++j) {
                if (j < per_thread) {
#pragma unroll
                    for (int q = 0; q < U; ++q) f(v[j * U + q]);
                }
            }
        } else {
            for (int base = 0; base < count; base += NTHREADS) {
                const int idx = base + tid;
                if constexpr (VEC) {
                    int4 q = make_int4(-1, -1, -1, -1);
                    if (idx < count) q = reinterpret_cast<const int4*>(src)[u0 + idx];
                    f(q.x); f(q.y); f(q.z); f(q.w);
                } else {
                    f(idx < count ? src[u0 + idx] : -1);
                }
            }
        }
    };

    int prefix = 0;     // the digits found so far, most significant first
    int rank_left = k;  // rank of the wanted element among those matching `prefix`
#pragma unroll
    for (int p = 0; p < NPASS; ++p) {
        const int nbits = digit_bits(p), shift = digit_shift(p);
        const int groups = (1 << nbits) / GROUP;    // 64, 32, 32
        int* h = hist + hist_offset(p);
        int* g = group_total[p];

        for_each_value([&](int value) {
            if ((value >> (shift + nbits)) == prefix)
                atomicAdd(h + ((value >> shift) & ((1 << nbits) - 1)), 1);
        });
        __syncthreads();
        for (int i = warp; i < groups; i += NWARPS) {   // a warp sums a group of bins
            const int total = warp_sum(h[i * GROUP + lane]);
            if (lane == 0) g[i] = total;
        }
        cluster_arrive();   // this block's histogram and group totals are complete ...
        cluster_wait();     // ... and so are everybody's

        if (warp == 0) {
            // the cluster's group totals: lane i has groups i and i + 32
            int g0 = 0, g1 = 0;
#pragma unroll
            for (int r = 0; r < CLUSTER; ++r) {
                const int* rg = cluster.map_shared_rank(g, r);
                g0 += rg[lane];
                if (groups == 64) g1 += rg[lane + 32];
            }
            const int incl0 = warp_inclusive_scan(g0, lane);
            const int incl1 = __shfl_sync(FULL_MASK, incl0, 31) + warp_inclusive_scan(g1, lane);
            const unsigned hit0 = __ballot_sync(FULL_MASK, incl0 > rank_left);
            const unsigned hit1 = __ballot_sync(FULL_MASK, groups == 64 && incl1 > rank_left);
            // the group that holds the rank (the last one, outside the contract)
            int group = groups - 1, below = 0;
            if (hit0 != 0) {
                group = __ffs(hit0) - 1;
                below = __shfl_sync(FULL_MASK, incl0 - g0, group);
            } else if (hit1 != 0) {
                group = 32 + __ffs(hit1) - 1;
                below = __shfl_sync(FULL_MASK, incl1 - g1, group - 32);
            }
            // that group's 32 bins, summed over the cluster
            int mine = 0;
#pragma unroll
            for (int r = 0; r < CLUSTER; ++r)
                mine += cluster.map_shared_rank(h, r)[group * GROUP + lane];
            const int incl = below + warp_inclusive_scan(mine, lane);
            const unsigned hit = __ballot_sync(FULL_MASK, incl > rank_left);
            const int bin = hit != 0 ? __ffs(hit) - 1 : GROUP - 1;
            const int below_bin = __shfl_sync(FULL_MASK, incl - mine, bin);
            if (lane == 0) {
                chosen[p][0] = group * GROUP + bin;
                chosen[p][1] = below_bin;
            }
        }
        if (p == NPASS - 1) cluster_arrive();   // no more remote reads from this block
        __syncthreads();
        prefix = (prefix << nbits) | chosen[p][0];
        rank_left -= chosen[p][1];
    }

    // `prefix` is the k-th smallest bit pattern; strictly-greater mask (int
    // compare == float compare for non-negatives)
    if constexpr (RESIDENT) {
#pragma unroll
        for (int j = 0; j < UNITS; ++j) {
            const int idx = tid + j * NTHREADS;
            if (idx < count) {
                if constexpr (VEC) {
                    reinterpret_cast<float4*>(dst)[u0 + idx] = make_float4(
                        v[4 * j] > prefix ? 1.0f : 0.0f, v[4 * j + 1] > prefix ? 1.0f : 0.0f,
                        v[4 * j + 2] > prefix ? 1.0f : 0.0f, v[4 * j + 3] > prefix ? 1.0f : 0.0f);
                } else {
                    dst[u0 + idx] = v[j] > prefix ? 1.0f : 0.0f;
                }
            }
        }
    } else {
        for (int idx = tid; idx < count; idx += NTHREADS) {
            if constexpr (VEC) {
                const int4 q = reinterpret_cast<const int4*>(src)[u0 + idx];
                reinterpret_cast<float4*>(dst)[u0 + idx] = make_float4(
                    q.x > prefix ? 1.0f : 0.0f, q.y > prefix ? 1.0f : 0.0f,
                    q.z > prefix ? 1.0f : 0.0f, q.w > prefix ? 1.0f : 0.0f);
            } else {
                dst[u0 + idx] = src[u0 + idx] > prefix ? 1.0f : 0.0f;
            }
        }
    }
    cluster_wait();     // nobody leaves while a neighbour may still read its histogram
}

// The calling thread's current device becomes `device`; the runtime call is
// made only when it is another one (a serving thread that did not load the
// model starts on device 0).
inline cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

template <bool RESIDENT, bool VEC>
cudaError_t launch(const int* pred_bits, float* out, int batch, int n, int k,
                   cudaStream_t stream) {
    // the cluster size is part of the kernel (__cluster_dims__): the grid is a
    // multiple of it by construction
    median_mask_kernel<RESIDENT, VEC><<<batch * CLUSTER, NTHREADS, 0, stream>>>(
        pred_bits, out, n, k);
    return cudaGetLastError();
}

}  // namespace

// Which variant a map of n values at these addresses takes, from n and the
// pointers alone: bit 0 = 16-byte loads and stores (VEC), bit 1 = the map
// stays in its cluster's registers (RESIDENT).
extern "C" int avt_median_mask_variant(const float* pred, const float* out, int n) {
    const bool vec = (n % 4 == 0)
        && (reinterpret_cast<uintptr_t>(pred) % 16 == 0)
        && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const long long units = vec ? n / 4 : n;
    const long long share = (units + CLUSTER - 1) / CLUSTER;
    const bool resident = share <= static_cast<long long>(NTHREADS) * (ITEMS / (vec ? 4 : 1));
    return (vec ? 1 : 0) | (resident ? 2 : 0);
}

// Launches on `stream` of `device`, does not synchronise, allocates nothing.
// `pred` and `out` are (batch, n) contiguous float32; 0 <= k < n; batch * 8
// blocks must fit the grid (batch < 2^28).  Returns the cudaError_t of the
// launch (0 = success) for the caller to raise on.
extern "C" int avt_median_mask(const float* pred, float* out, int batch, int n,
                               int k, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || n <= 0) return 0;
    if (batch >= (1 << 28)) return static_cast<int>(cudaErrorInvalidValue);
    const int* bits = reinterpret_cast<const int*>(pred);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (avt_median_mask_variant(pred, out, n)) {
        case 3: err = launch<true, true>(bits, out, batch, n, k, st); break;
        case 2: err = launch<true, false>(bits, out, batch, n, k, st); break;
        case 1: err = launch<false, true>(bits, out, batch, n, k, st); break;
        default: err = launch<false, false>(bits, out, batch, n, k, st); break;
    }
    return static_cast<int>(err);
}
