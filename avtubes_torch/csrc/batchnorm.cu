// Training-mode BatchNorm with its ReLU and residual add, channels-last bf16,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which fuses
// it with its neighbours.  It was added because PyTorch trains a bf16
// `channels_last_3d` BatchNorm3d on generic kernels (a TensorIterator Welford
// reduction and an elementwise transform that cannot vectorise) and runs the
// ReLU and the residual add around it as passes of their own: the largest
// block of time in the R3D-18 tube step that is not a product.
//
// The activation is a (rows, C) matrix, rows = N*T*H*W, C contiguous and one
// of R3D-18's widths, 64, 128, 256 or 512.  Bound on this card by bytes: a
// handful of float operations per 2-byte value.  So every kernel reads each
// tensor once with 16-byte loads (8 channels a thread, neighbouring threads on
// neighbouring channels, the block's 256 threads exactly C/8 lanes by
// 256 / (C/8) rows a pass) and keeps the per-channel constants of its 8
// channels in registers.  Four kernels:
//
//   stats            mean and invstd of each channel, and the running
//                    statistics advanced in place (momentum, n/(n-1));
//   apply            y = relu(x^ * w + b [+ r]), rounded once to bf16;
//   backward_reduce  g = dy * [y > 0], sum g and sum g * x^ per channel (the
//                    bias' and weight's gradients); writes g, the residual's
//                    gradient, where the output took a residual;
//   backward_elemt   dx = w * invstd * (g - sum g / n - x^ * sum g x^ / n).
//
// Reductions.  Each thread keeps float32 (mean, M2) of its values by Welford's
// update (never E[x^2] - E[x]^2: a channel far from zero would lose its
// variance), or plain float32 sums in the backward; a block combines its
// threads' in shared memory by Chan's formula in a fixed order and writes
// one partial.  Blocks take contiguous chunks of rows, so a chunk's count is
// known from its index.  The partials are combined in float64, in a fixed
// order, inside the same launch: the last block of each group of `GROUP`
// blocks to finish (an integer ticket, `atomicInc`, which wraps the counter
// back to 0 for the next launch) combines its group's, and the last group to
// finish combines the groups' and writes the result.  No float atomics, so
// two runs give the same bits; and no single block reads every partial,
// which at C = 512 would take it tens of microseconds.
//
// The ReLU's mask in the backward: where the output took a residual it is
// read from the saved output y (kept alive anyway as the next convolution's
// input); elsewhere it is recomputed from x by the same instructions as the
// forward (`normalized`), so it is the forward's bit for bit.
//
// Every kernel's grid is BLOCKS_PER_SM blocks an SM (`ops/batchnorm.py`
// sizes it), and `__launch_bounds__` holds each kernel to the registers that
// keep them all resident: one wave, no tail of a second.  The elementwise
// kernels walk their chunk from its end: the kernel before them walked it
// from its start, so its last rows are still in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads a block
constexpr int BLOCKS_PER_SM = 4;  // resident at once: each kernel's grid is one wave
constexpr int VEC = 8;         // channels a thread: one 16-byte load of bf16
constexpr int GROUP = 16;      // blocks a group of the two-level combine
constexpr int MAX_GROUPS = 63; // counters a launch may use, past the final one

using bf16 = __nv_bfloat16;

struct Tile {                  // where a thread sits in its block
    int lanes, rp, lane, r;    // C/8 threads a row, rows a pass, its lane and row
    long long r0, r1;          // the block's chunk of rows
    __device__ Tile(int C, long long rows, long long per) {
        lanes = C / VEC;
        rp = NT / lanes;
        lane = threadIdx.x % lanes;
        r = threadIdx.x / lanes;
        r0 = min(rows, static_cast<long long>(blockIdx.x) * per);
        r1 = min(rows, r0 + per);
    }
    // rows of this thread: r0 + r + k * rp, k < count()
    __device__ long long count() const {
        const long long span = r1 - r0 - r;
        return span > 0 ? (span + rp - 1) / rp : 0;
    }
    __device__ long long offset(long long k, int C) const {
        return (r0 + r + k * rp) * C + lane * VEC;
    }
};

__device__ __forceinline__ uint4 load16(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[VEC]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ uint4 pack(const float (&v)[VEC]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return u;
}

// the BatchNorm's output before the residual and the ReLU; the forward and
// the backward's mask both compute it by these instructions (no contraction)
__device__ __forceinline__ float normalized(float x, float mean, float scale, float bias) {
    return __fmaf_rn(__fsub_rn(x, mean), scale, bias);
}

__device__ __forceinline__ bool kept_by_relu(float v) {
    return __bfloat162float(__float2bfloat16_rn(v)) > 0.0f;
}

// Chan's combination of (mean, M2, n) with (mb, m2b, nb)
template <typename T>
__device__ __forceinline__ void chan(T& mean, T& m2, T& n, T mb, T m2b, T nb) {
    if (nb == T(0)) return;
    const T nab = n + nb;
    const T d = mb - mean;
    const T f = nb / nab;
    mean += d * f;
    m2 += m2b + d * d * n * f;
    n = nab;
}

__device__ __forceinline__ double rows_between(long long a, long long b, long long per,
                                               long long rows) {
    return static_cast<double>(min(rows, b * per) - min(rows, a * per));
}

// One ticket of `counter` for this block; true in the block that takes the
// last of `size` (the counter wraps to 0 then).  Call with the block's
// writes fenced; every thread gets the answer.
__device__ __forceinline__ bool last_to_arrive(unsigned int* counter, int size) {
    __shared__ bool last;
    __syncthreads();
    if (threadIdx.x == 0)
        last = atomicInc(counter, static_cast<unsigned int>(size - 1))
               == static_cast<unsigned int>(size - 1);
    __syncthreads();
    return last;
}

// The two-level combine of the blocks' partials part[block][2][C] (float):
// groups into gpart[group][2][C] (double), then groups into `finish(c, a, b)`.
// STATS: (mean, M2) pairs by Chan's formula with each block's row count;
// else plain sums.
template <bool STATS, typename Finish>
__device__ void combine(const float* part, double* gpart, unsigned int* counters, int C,
                        long long rows, long long per, Finish finish) {
    __threadfence();
    const int blocks = gridDim.x, groups = (blocks + GROUP - 1) / GROUP;
    const int grp = blockIdx.x / GROUP;
    const int b0 = grp * GROUP, b1 = min(blocks, b0 + GROUP);
    if (!last_to_arrive(&counters[1 + grp], b1 - b0)) return;
    for (int c = threadIdx.x; c < C; c += NT) {
        double a = 0.0, q = 0.0, n = 0.0;
        for (int b = b0; b < b1; ++b) {
            const double pa = __ldcg(&part[(2 * b) * C + c]);
            const double pq = __ldcg(&part[(2 * b + 1) * C + c]);
            if (STATS) chan(a, q, n, pa, pq, rows_between(b, b + 1, per, rows));
            else { a += pa; q += pq; }
        }
        gpart[(2 * grp) * C + c] = a;
        gpart[(2 * grp + 1) * C + c] = q;
    }
    __threadfence();
    if (!last_to_arrive(&counters[0], groups)) return;
    for (int c = threadIdx.x; c < C; c += NT) {
        double a = 0.0, q = 0.0, n = 0.0;
        for (int g = 0; g < groups; ++g) {
            const double ga = __ldcg(&gpart[(2 * g) * C + c]);
            const double gq = __ldcg(&gpart[(2 * g + 1) * C + c]);
            if (STATS) {
                const long long e = min(static_cast<long long>(blocks), (g + 1LL) * GROUP);
                chan(a, q, n, ga, gq, rows_between(static_cast<long long>(g) * GROUP, e, per, rows));
            } else { a += ga; q += gq; }
        }
        finish(c, a, q);
    }
}

// A block's threads hold partials of their rows for their 8 channels in
// (a, q); write the block's partial, the rows in order (Chan's formula with
// the rows' counts n where STATS, else sums), to part[block][2][C].
template <bool STATS>
__device__ void block_partial(const Tile& t, const float (&a)[VEC], const float (&q)[VEC],
                              float n, int C, float* part) {
    __shared__ float sa[NT * VEC], sq[NT * VEC];   // [rp][C] each: rp * C = NT * 8
    __shared__ float sn[NT];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
        sa[t.r * C + t.lane * VEC + j] = a[j];
        sq[t.r * C + t.lane * VEC + j] = q[j];
    }
    if (t.lane == 0) sn[t.r] = n;
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += NT) {
        float ba = 0.0f, bq = 0.0f, bn = 0.0f;
        for (int i = 0; i < t.rp; ++i) {
            if (STATS) chan(ba, bq, bn, sa[i * C + c], sq[i * C + c], sn[i]);
            else { ba += sa[i * C + c]; bq += sq[i * C + c]; }
        }
        part[(2 * blockIdx.x) * C + c] = ba;
        part[(2 * blockIdx.x + 1) * C + c] = bq;
    }
}

__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
bn_stats_kernel(const bf16* __restrict__ x, long long rows, int C, long long per,
                float* __restrict__ part, double* __restrict__ gpart,
                unsigned int* __restrict__ counters, float* __restrict__ mean_out,
                float* __restrict__ invstd_out, float* __restrict__ running_mean,
                float* __restrict__ running_var, float momentum, float eps) {
    constexpr int UNROLL = 4;
    const Tile t(C, rows, per);
    float mean[VEC] = {}, m2[VEC] = {};
    float n = 0.0f;
    auto update = [&](const uint4& u) {
        float v[VEC];
        unpack(u, v);
        n += 1.0f;
        const float inv = __frcp_rn(n);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const float d = v[j] - mean[j];
            mean[j] = fmaf(d, inv, mean[j]);
            m2[j] = fmaf(d, v[j] - mean[j], m2[j]);
        }
    };
    const long long count = t.count();
    long long k = 0;
    for (; k + UNROLL <= count; k += UNROLL) {
        uint4 u[UNROLL];
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) u[i] = load16(x + t.offset(k + i, C));
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) update(u[i]);
    }
    for (; k < count; ++k) update(load16(x + t.offset(k, C)));
    block_partial<true>(t, mean, m2, n, C, part);
    combine<true>(part, gpart, counters, C, rows, per, [&](int c, double m, double q) {
        const double var = q / static_cast<double>(rows);
        mean_out[c] = static_cast<float>(m);
        invstd_out[c] = static_cast<float>(1.0 / sqrt(var + static_cast<double>(eps)));
        if (running_mean != nullptr) {
            const double unbiased = var * static_cast<double>(rows) / static_cast<double>(rows - 1);
            running_mean[c] = momentum * static_cast<float>(m) + (1.0f - momentum) * running_mean[c];
            running_var[c] = momentum * static_cast<float>(unbiased)
                             + (1.0f - momentum) * running_var[c];
        }
    });
}

template <bool RES, bool RELU>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
bn_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res, bf16* __restrict__ y,
                long long rows, int C, long long per, const float* __restrict__ mean,
                const float* __restrict__ invstd, const float* __restrict__ weight,
                const float* __restrict__ bias) {
    constexpr int UNROLL = 4;
    const Tile t(C, rows, per);
    float mu[VEC], sc[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
        const int c = t.lane * VEC + j;
        mu[j] = mean[c];
        sc[j] = __fmul_rn(weight[c], invstd[c]);
        b[j] = bias[c];
    }
    auto apply = [&](const uint4& ux, const uint4& ur, long long off) {
        float v[VEC], rv[VEC];
        unpack(ux, v);
        if (RES) unpack(ur, rv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            float o = normalized(v[j], mu[j], sc[j], b[j]);
            if (RES) o = __fadd_rn(o, rv[j]);
            if (RELU) o = o < 0.0f ? 0.0f : o;
            v[j] = o;
        }
        *reinterpret_cast<uint4*>(y + off) = pack(v);
    };
    long long k = t.count() - 1;
    for (; k >= UNROLL - 1; k -= UNROLL) {
        uint4 ux[UNROLL], ur[UNROLL];
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
            ux[i] = load16(x + t.offset(k - i, C));
            if (RES) ur[i] = load16(res + t.offset(k - i, C));
        }
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) apply(ux[i], ur[i], t.offset(k - i, C));
    }
    for (; k >= 0; --k) {
        const long long off = t.offset(k, C);
        apply(load16(x + off), RES ? load16(res + off) : uint4{}, off);
    }
}

// MASK: 0 no ReLU; 1 the ReLU's mask recomputed from x; 2 read from y, and
// g = dy * mask written to `g`
template <int MASK>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
bn_backward_reduce_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                          const bf16* __restrict__ y, bf16* __restrict__ g, long long rows,
                          int C, long long per, const float* __restrict__ mean,
                          const float* __restrict__ invstd, const float* __restrict__ weight,
                          const float* __restrict__ bias, float* __restrict__ part,
                          double* __restrict__ gpart, unsigned int* __restrict__ counters,
                          float* __restrict__ grad_weight, float* __restrict__ grad_bias) {
    constexpr int UNROLL = 2;
    const Tile t(C, rows, per);
    float mu[VEC], sc[VEC], b[VEC];
    float sg[VEC] = {}, sgx[VEC] = {};   // sum g and sum g (x - mean): x^ = (x - mean) invstd
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
        const int c = t.lane * VEC + j;
        mu[j] = mean[c];
        sc[j] = __fmul_rn(weight[c], invstd[c]);
        b[j] = bias[c];
    }
    auto accumulate = [&](const uint4& ud, const uint4& ux, const uint4& uy, long long off) {
        float d[VEC], v[VEC], o[VEC];
        unpack(ud, d);
        unpack(ux, v);
        if (MASK == 2) unpack(uy, o);
        unsigned int bits[VEC / 2] = {0u, 0u, 0u, 0u};   // the kept halves of dy's words
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            bool keep = true;
            if (MASK == 1) keep = kept_by_relu(normalized(v[j], mu[j], sc[j], b[j]));
            if (MASK == 2) keep = o[j] > 0.0f;
            if (keep) bits[j / 2] |= (j % 2) ? 0xFFFF0000u : 0x0000FFFFu;
            else d[j] = 0.0f;
            sg[j] += d[j];
            sgx[j] = fmaf(d[j], v[j] - mu[j], sgx[j]);
        }
        if (MASK == 2)
            *reinterpret_cast<uint4*>(g + off) = make_uint4(ud.x & bits[0], ud.y & bits[1],
                                                            ud.z & bits[2], ud.w & bits[3]);
    };
    const long long count = t.count();
    long long k = 0;
    for (; k + UNROLL <= count; k += UNROLL) {
        uint4 ud[UNROLL], ux[UNROLL], uy[UNROLL] = {};
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
            const long long off = t.offset(k + i, C);
            ud[i] = load16(dy + off);
            ux[i] = load16(x + off);
            if (MASK == 2) uy[i] = load16(y + off);
        }
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) accumulate(ud[i], ux[i], uy[i], t.offset(k + i, C));
    }
    for (; k < count; ++k) {
        const long long off = t.offset(k, C);
        accumulate(load16(dy + off), load16(x + off), MASK == 2 ? load16(y + off) : uint4{},
                   off);
    }
    block_partial<false>(t, sgx, sg, 0.0f, C, part);
    combine<false>(part, gpart, counters, C, rows, per, [&](int c, double sw, double sb) {
        grad_weight[c] = static_cast<float>(sw * static_cast<double>(invstd[c]));
        grad_bias[c] = static_cast<float>(sb);
    });
}

// MASK as in the reduce: 0 g = dy; 1 g = dy * mask recomputed from x; 2 g
// read as written by the reduce
template <int MASK>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
bn_backward_elemt_kernel(const bf16* __restrict__ gin, const bf16* __restrict__ x,
                         bf16* __restrict__ dx, long long rows, int C, long long per,
                         const float* __restrict__ mean, const float* __restrict__ invstd,
                         const float* __restrict__ weight, const float* __restrict__ bias,
                         const float* __restrict__ grad_weight,
                         const float* __restrict__ grad_bias) {
    constexpr int UNROLL = 2;
    const Tile t(C, rows, per);
    const float inv_n = static_cast<float>(1.0 / static_cast<double>(rows));
    float mu[VEC], sc[VEC], b[VEC], k1[VEC], c2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
        const int c = t.lane * VEC + j;
        mu[j] = mean[c];
        sc[j] = __fmul_rn(weight[c], invstd[c]);
        b[j] = bias[c];
        k1[j] = grad_bias[c] * inv_n;                  // sum g / n
        c2[j] = invstd[c] * (grad_weight[c] * inv_n);  // invstd * sum g x^ / n
    }
    auto apply = [&](const uint4& ug, const uint4& ux, long long off) {
        float gv[VEC], v[VEC];
        unpack(ug, gv);
        unpack(ux, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            float gj = gv[j];
            if (MASK == 1 && !kept_by_relu(normalized(v[j], mu[j], sc[j], b[j]))) gj = 0.0f;
            v[j] = sc[j] * ((gj - k1[j]) - (v[j] - mu[j]) * c2[j]);
        }
        *reinterpret_cast<uint4*>(dx + off) = pack(v);
    };
    long long k = t.count() - 1;
    for (; k >= UNROLL - 1; k -= UNROLL) {
        uint4 ug[UNROLL], ux[UNROLL];
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
            ug[i] = load16(gin + t.offset(k - i, C));
            ux[i] = load16(x + t.offset(k - i, C));
        }
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) apply(ug[i], ux[i], t.offset(k - i, C));
    }
    for (; k >= 0; --k) {
        const long long off = t.offset(k, C);
        apply(load16(gin + off), load16(x + off), off);
    }
}

inline cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

// the rows a block takes for `grid` blocks, and the blocks that then hold
// any (every one but possibly the last few of `grid` is used)
inline long long rows_per_block(long long rows, int grid) { return (rows + grid - 1) / grid; }

inline int blocks_used(long long rows, long long per) {
    return static_cast<int>((rows + per - 1) / per);
}

// R3D-18's widths: C / 8 lanes divide the block's threads
inline bool shape_taken(long long rows, int channels, int grid) {
    return rows >= 2 && (channels == 64 || channels == 128 || channels == 256 || channels == 512)
           && grid >= 1 && grid <= GROUP * MAX_GROUPS;
}

}  // namespace

// Every function launches one kernel on `stream` of `device`, does not
// synchronise and allocates nothing; it returns the launch's cudaError_t (0 =
// success) for the caller to raise on.  Tensors are (rows, channels) bf16
// with channels (64, 128, 256 or 512) contiguous and 16-byte aligned;
// per-channel vectors float32.
// `grid` is the blocks to use (1 to 1008, every kernel of one BatchNorm the
// same); `part` holds grid * 2 * channels floats, `gpart` at least
// ceil(grid / 16) * 2 * channels doubles, and `counters` 64 unsigned ints, zero before the
// first launch (each launch leaves them zero).  Launches that share
// `counters` must not overlap: one stream.

extern "C" int avt_bn_stats(const void* x, long long rows, int channels, int grid, void* part,
                            void* gpart, void* counters, void* mean, void* invstd,
                            void* running_mean, void* running_var, float momentum, float eps,
                            int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!shape_taken(rows, channels, grid)) return static_cast<int>(cudaErrorInvalidValue);
    const long long per = rows_per_block(rows, grid);
    bn_stats_kernel<<<blocks_used(rows, per), NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), rows, channels, per, static_cast<float*>(part),
        static_cast<double*>(gpart), static_cast<unsigned int*>(counters),
        static_cast<float*>(mean), static_cast<float*>(invstd),
        static_cast<float*>(running_mean), static_cast<float*>(running_var), momentum, eps);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int avt_bn_apply(const void* x, const void* residual, void* y, long long rows,
                            int channels, int grid, int relu, const void* mean,
                            const void* invstd, const void* weight, const void* bias,
                            int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!shape_taken(rows, channels, grid)) return static_cast<int>(cudaErrorInvalidValue);
    const long long per = rows_per_block(rows, grid);
    const int blocks = blocks_used(rows, per);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* rb = static_cast<const bf16*>(residual);
    bf16* yb = static_cast<bf16*>(y);
    const float *m = static_cast<const float*>(mean), *is = static_cast<const float*>(invstd),
                *w = static_cast<const float*>(weight), *b = static_cast<const float*>(bias);
    if (rb != nullptr && relu)
        bn_apply_kernel<true, true><<<blocks, NT, 0, st>>>(xb, rb, yb, rows, channels, per, m, is, w, b);
    else if (rb != nullptr)
        bn_apply_kernel<true, false><<<blocks, NT, 0, st>>>(xb, rb, yb, rows, channels, per, m, is, w, b);
    else if (relu)
        bn_apply_kernel<false, true><<<blocks, NT, 0, st>>>(xb, rb, yb, rows, channels, per, m, is, w, b);
    else
        bn_apply_kernel<false, false><<<blocks, NT, 0, st>>>(xb, rb, yb, rows, channels, per, m, is, w, b);
    return static_cast<int>(cudaGetLastError());
}

// mask: 0 none, 1 recomputed from x, 2 read from y (g written)
extern "C" int avt_bn_backward_reduce(const void* dy, const void* x, const void* y, void* g,
                                      long long rows, int channels, int grid, int mask,
                                      const void* mean, const void* invstd, const void* weight,
                                      const void* bias, void* part, void* gpart, void* counters,
                                      void* grad_weight, void* grad_bias, int device,
                                      void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!shape_taken(rows, channels, grid) || mask < 0 || mask > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long per = rows_per_block(rows, grid);
    const int blocks = blocks_used(rows, per);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto launch = [&](auto kernel) {
        kernel<<<blocks, NT, 0, st>>>(
            static_cast<const bf16*>(dy), static_cast<const bf16*>(x),
            static_cast<const bf16*>(y), static_cast<bf16*>(g), rows, channels, per,
            static_cast<const float*>(mean), static_cast<const float*>(invstd),
            static_cast<const float*>(weight), static_cast<const float*>(bias),
            static_cast<float*>(part), static_cast<double*>(gpart),
            static_cast<unsigned int*>(counters), static_cast<float*>(grad_weight),
            static_cast<float*>(grad_bias));
    };
    if (mask == 2) launch(bn_backward_reduce_kernel<2>);
    else if (mask == 1) launch(bn_backward_reduce_kernel<1>);
    else launch(bn_backward_reduce_kernel<0>);
    return static_cast<int>(cudaGetLastError());
}

// mask as in the reduce; with 2, `g` is what the reduce wrote, else dy
extern "C" int avt_bn_backward_elemt(const void* g, const void* x, void* dx, long long rows,
                                     int channels, int grid, int mask, const void* mean,
                                     const void* invstd, const void* weight, const void* bias,
                                     const void* grad_weight, const void* grad_bias, int device,
                                     void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!shape_taken(rows, channels, grid) || mask < 0 || mask > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long per = rows_per_block(rows, grid);
    const int blocks = blocks_used(rows, per);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto launch = [&](auto kernel) {
        kernel<<<blocks, NT, 0, st>>>(
            static_cast<const bf16*>(g), static_cast<const bf16*>(x), static_cast<bf16*>(dx),
            rows, channels, per, static_cast<const float*>(mean),
            static_cast<const float*>(invstd), static_cast<const float*>(weight),
            static_cast<const float*>(bias), static_cast<const float*>(grad_weight),
            static_cast<const float*>(grad_bias));
    };
    if (mask == 1) launch(bn_backward_elemt_kernel<1>);
    else launch(bn_backward_elemt_kernel<0>);   // 0 and 2: g as given
    return static_cast<int>(cudaGetLastError());
}
