// Exact k-th-value threshold + strictly-greater mask for Hopper (sm_90a).
//
// Replaces the TPU kernel `_median_mask_kernel` (avtubes/ops/median_select.py,
// launched by `median_mask_pallas`).  Per map of n non-negative finite f32
// values: a 31-step bisection over the int32 bit patterns (which order like
// the floats) finds the smallest pattern m with count(bits <= m) >= k+1 —
// exactly the k-th smallest element, ties and all, bit-identical to
// sort(x)[k] — and the mask `bits > m` is written as {0,1} float32.
//
// One block of 1024 threads per map.  The map is staged once into dynamic
// shared memory when it fits (a 224x224 map is 196 KB, under the 227 KB a
// block may use once the >48 KB opt-in is made); a larger map is re-read
// from global memory (L2) on each step.  Each step: every thread counts over
// its strided share (16-byte loads when n is a multiple of 4), a warp-shuffle
// sum, one shared-memory exchange, and a thread-uniform lo/hi update; the
// per-warp counts are double-buffered so a step costs one barrier.
//
// Bound on this card: by bytes on paper (one read and one write of the map,
// ~2 int ops per element and step), but what limits it is occupancy and
// latency: the 31 steps are serial, each ends in a block-wide barrier, and
// with one block per map a batch of 8 maps uses 8 of the card's 132 SMs.
// Splitting a map over a cluster of blocks, a radix select with fewer passes,
// and fusing the min-max pass that precedes it are later work.
//
// NaN and negative inputs (sign bit set) are outside the contract: their bit
// patterns do not order like the floats.  Nothing here clamps or checks them.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int NTHREADS = 1024;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_BITS = 0x7F7FFFFF;  // largest finite f32
constexpr int ITERS = 31;             // ceil(log2(MAX_BITS + 1))
// a block may use 232448 bytes of shared memory, static part included
constexpr int MAX_DYNAMIC_SMEM = 232448 - 1024;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <bool STAGE, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
median_mask_kernel(const int* __restrict__ pred_bits, float* __restrict__ out,
                   int n, int k) {
    extern __shared__ __align__(16) int staged[];
    __shared__ int warp_counts[2][NWARPS];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int* src = pred_bits + static_cast<size_t>(blockIdx.x) * n;
    float* dst = out + static_cast<size_t>(blockIdx.x) * n;

    if (STAGE) {
        if (VEC) {
            const int4* s4 = reinterpret_cast<const int4*>(src);
            int4* d4 = reinterpret_cast<int4*>(staged);
            for (int i = tid; i < n / 4; i += NTHREADS) d4[i] = s4[i];
        } else {
            for (int i = tid; i < n; i += NTHREADS) staged[i] = src[i];
        }
        __syncthreads();
    }
    const int* bits = STAGE ? staged : src;

    int lo = 0, hi = MAX_BITS;
    for (int it = 0; it < ITERS; ++it) {
        const int mid = lo + ((hi - lo) >> 1);  // lo + hi would overflow int32
        int c = 0;
        if (VEC) {
            const int4* b4 = reinterpret_cast<const int4*>(bits);
            for (int i = tid; i < n / 4; i += NTHREADS) {
                const int4 v = b4[i];
                c += (v.x <= mid) + (v.y <= mid) + (v.z <= mid) + (v.w <= mid);
            }
        } else {
            for (int i = tid; i < n; i += NTHREADS) c += (bits[i] <= mid);
        }
        c = warp_sum(c);
        int* counts = warp_counts[it & 1];
        if (lane == 0) counts[warp] = c;
        __syncthreads();
        // every warp sums the 32 per-warp counts itself: no second barrier,
        // and the other buffer is free to be written in the next step
        const int cnt = warp_sum(counts[lane]);
        if (cnt >= k + 1) hi = mid; else lo = mid + 1;
    }

    // strictly-greater mask; int compare == float compare for non-negatives
    if (VEC) {
        const int4* b4 = reinterpret_cast<const int4*>(bits);
        float4* o4 = reinterpret_cast<float4*>(dst);
        for (int i = tid; i < n / 4; i += NTHREADS) {
            const int4 v = b4[i];
            o4[i] = make_float4(v.x > lo ? 1.0f : 0.0f, v.y > lo ? 1.0f : 0.0f,
                                v.z > lo ? 1.0f : 0.0f, v.w > lo ? 1.0f : 0.0f);
        }
    } else {
        for (int i = tid; i < n; i += NTHREADS) dst[i] = bits[i] > lo ? 1.0f : 0.0f;
    }
}

constexpr int MAX_DEVICES = 64;

// The calling thread's current device becomes `device`; the runtime call is
// made only when it is another one (a serving thread that did not load the
// model starts on device 0).
inline cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

template <bool STAGE, bool VEC>
cudaError_t launch(const int* pred_bits, float* out, int batch, int n, int k,
                   int device, cudaStream_t stream) {
    size_t smem = 0;
    if (STAGE) {
        smem = static_cast<size_t>(n) * sizeof(int);
        // Above 48 KB dynamic shared memory is opt-in.  The opt-in is made
        // once per instantiation and device, for the most a map may take, and
        // not on every launch.  Two threads racing here both set the same value.
        static std::atomic<bool> opted_in[MAX_DEVICES];
        const bool remember = device >= 0 && device < MAX_DEVICES;
        if (smem > 48 * 1024 && !(remember && opted_in[device].load())) {
            cudaError_t err = cudaFuncSetAttribute(
                median_mask_kernel<STAGE, VEC>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
            if (err != cudaSuccess) return err;
            if (remember) opted_in[device].store(true);
        }
    }
    median_mask_kernel<STAGE, VEC><<<batch, NTHREADS, smem, stream>>>(pred_bits, out, n, k);
    return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of `device`, does not synchronise, allocates nothing.
// `pred` and `out` are (batch, n) contiguous float32; 0 <= k < n.  Returns the
// cudaError_t of the launch (0 = success) for the caller to raise on.
extern "C" int avt_median_mask(const float* pred, float* out, int batch, int n,
                               int k, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || n <= 0) return 0;
    const int* bits = reinterpret_cast<const int*>(pred);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool stage = static_cast<size_t>(n) * sizeof(int) <= MAX_DYNAMIC_SMEM;
    const bool vec = (n % 4 == 0)
        && (reinterpret_cast<uintptr_t>(pred) % 16 == 0)
        && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    if (stage) {
        err = vec ? launch<true, true>(bits, out, batch, n, k, device, st)
                  : launch<true, false>(bits, out, batch, n, k, device, st);
    } else {
        err = vec ? launch<false, true>(bits, out, batch, n, k, device, st)
                  : launch<false, false>(bits, out, batch, n, k, device, st);
    }
    return static_cast<int>(err);
}
