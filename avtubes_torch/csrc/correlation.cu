// Correlation cost volume, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_corr_kernel` (avtubes/ops/correlation.py, launched
// by `correlation_pallas`) and the backward of `_correlation_pallas_ad`, which
// on the TPU falls back to the compiler's VJP of the unrolled version.  For
// feature maps f1, f2 of shape (B, H, W, C), float32, channels last:
//
//   out[b,i,j,k] = (1/C) * sum_c f1[b,i,j,c] * f2[b,i+dy,j+dx,c]
//
// with k = iy*n + ix over (dy, dx) = ((iy-s)*stride, (ix-s)*stride),
// s = max_disp / stride, n = 2s+1, D = n*n, and f2 read as zero outside the
// map.  The two gradients are in gather form (no atomics, deterministic):
//
//   gf1[b,i,j,c] = (1/C) * sum_k g[b,i,j,k]       * f2[b,i+dy_k,j+dx_k,c]
//   gf2[b,y,x,c] = (1/C) * sum_k g[b,y-dy_k,x-dx_k,k] * f1[b,y-dy_k,x-dx_k,c]
//
// The displacement grid is symmetric (-d_k = d_{D-1-k}), so gf2 is the same
// sum as gf1 with f1 in the place of f2 and the coefficient of neighbour k
// taken from that neighbour's own g vector at channel D-1-k.  One kernel
// (`corr_bwd_kernel<MIRROR>`) computes either.
//
// Design.  The TPU kernel keeps a whole padded image in VMEM and walks the D
// shifts; here nothing is padded in memory and a block owns one row segment:
// block = (b, row i, TW consecutive columns).  It stages in shared memory the
// n rows i+dy of the other map over the TW + 2*s*stride columns the segment
// can reach, zero where the map ends (the bounds check replaces the padded
// copy), plus its own f1 segment (forward) or its D-long coefficient vectors
// (backward).  Forward: one thread per output element, threads running along
// k so that a warp's stores of out[b,i,j,:] are contiguous, each a C-long
// fp32 dot product of `fmaf`s read as float4 from shared memory.  Backward:
// one thread per (column, 4 channels), a D-long sum.  A pixel's channels are
// stored at a stride of CP floats with CP/4 odd, so that the float4 reads of
// neighbouring columns fall in different banks; channels beyond C are zero.
// TW is chosen so that a block needs at most 64 KB (three blocks per SM; a
// wider segment would amortise the halo better but leave one block per SM with
// its load and its arithmetic unable to overlap); a shape whose single-column
// tile exceeds what a block may hold takes the `direct` kernels, which read
// global memory with the same bounds check.
//
// Bound on this card: by bytes (each input read once, the output written
// once; 2*B*H*W*C*D FLOPs are fewer microseconds than that at D = 81).  What
// this design pays above the bound: each block re-reads its halo from L2
// ((TW+2R)/TW times the row, n times over the rows), and every FMA of the
// forward needs one non-broadcast 4-byte shared-memory operand, which caps it
// near a quarter of the fp32 rate.  Register tiles over (j, ix), which share
// those operands, are later work.  No TF32, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_THREADS = 256;
// a block may use 232448 bytes of shared memory, static part included
constexpr int MAX_DYNAMIC_SMEM = 232448 - 1024;
// preferred size of a block's tile: three blocks fit one SM
constexpr int TILE_SMEM_TARGET = 64 * 1024;

struct Geom {
    int H, W, C, D;
    int n;        // displacements per axis
    int steps;    // max_disp / stride
    int stride;
    int R;        // steps * stride: the reach in pixels
    int TW;       // columns per block
    int nt;       // blocks per row
    int HW;       // halo width: TW + 2R
    int CP;       // floats per staged pixel (multiple of 4, CP/4 odd)
    int C4;       // ceil(C / 4)
    float inv_c;
};

__device__ __forceinline__ float4 load4(const float* p, int c, int C, bool vec) {
    if (vec) return *reinterpret_cast<const float4*>(p);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    v.x = p[0];
    if (c + 1 < C) v.y = p[1];
    if (c + 2 < C) v.z = p[2];
    if (c + 3 < C) v.w = p[3];
    return v;
}

// rows i+dy (n of them), columns x0-R .. x0+TW-1+R of `img` (one image,
// H x W x C) into halo[(iy*HW + col)*CP + c]; zero outside the map and in
// the channels from C up to 4*C4
template <bool VEC>
__device__ void stage_halo(const float* __restrict__ img, float* halo,
                           const Geom& g, int i, int x0) {
    const int total = g.n * g.HW * g.C4;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int c4 = e % g.C4;
        const int t = e / g.C4;
        const int col = t % g.HW, iy = t / g.HW;
        const int y = i + (iy - g.steps) * g.stride;
        const int x = x0 - g.R + col;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (y >= 0 && y < g.H && x >= 0 && x < g.W)
            v = load4(img + (static_cast<size_t>(y) * g.W + x) * g.C + 4 * c4,
                      4 * c4, g.C, VEC);
        *reinterpret_cast<float4*>(halo + static_cast<size_t>(iy * g.HW + col) * g.CP
                                   + 4 * c4) = v;
    }
}

template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
corr_fwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                float* __restrict__ out, Geom g) {
    extern __shared__ __align__(16) float smem[];
    float* halo = smem;                                   // n * HW * CP
    float* tile = smem + static_cast<size_t>(g.n) * g.HW * g.CP;   // TW * CP

    const int seg = blockIdx.x % g.nt;
    const int row = blockIdx.x / g.nt;                    // b*H + i
    const int i = row % g.H, b = row / g.H;
    const int x0 = seg * g.TW;
    const size_t image = static_cast<size_t>(b) * g.H * g.W * g.C;

    stage_halo<VEC>(f2 + image, halo, g, i, x0);
    for (int e = threadIdx.x; e < g.TW * g.C4; e += blockDim.x) {
        const int c4 = e % g.C4, jj = e / g.C4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (x0 + jj < g.W)
            v = load4(f1 + image + (static_cast<size_t>(i) * g.W + x0 + jj) * g.C + 4 * c4,
                      4 * c4, g.C, VEC);
        *reinterpret_cast<float4*>(tile + jj * g.CP + 4 * c4) = v;
    }
    __syncthreads();

    float* orow = out + (static_cast<size_t>(row) * g.W + x0) * g.D;
    for (int o = threadIdx.x; o < g.TW * g.D; o += blockDim.x) {
        const int jj = o / g.D, k = o % g.D;
        if (x0 + jj >= g.W) break;                        // ragged last segment
        const int iy = k / g.n, ix = k % g.n;
        const float4* a = reinterpret_cast<const float4*>(tile + jj * g.CP);
        const float4* v = reinterpret_cast<const float4*>(
            halo + static_cast<size_t>(iy * g.HW + jj + ix * g.stride) * g.CP);
        float acc = 0.f;
        for (int c4 = 0; c4 < g.C4; ++c4) {
            const float4 p = a[c4], q = v[c4];
            acc = fmaf(p.x, q.x, acc);
            acc = fmaf(p.y, q.y, acc);
            acc = fmaf(p.z, q.z, acc);
            acc = fmaf(p.w, q.w, acc);
        }
        orow[o] = acc * g.inv_c;
    }
}

// grad[b,i,j,c] = (1/C) sum_k coef[j][k] * src[b, i+dy_k, j+dx_k, c].
// MIRROR = false (gradient of f1): src = f2, coef[j][k] = gout[b,i,j,k].
// MIRROR = true  (gradient of f2): src = f1, coef[j][k] = gout[b,i+dy_k,j+dx_k,D-1-k],
//                                  zero where that pixel is outside the map.
template <bool MIRROR, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
corr_bwd_kernel(const float* __restrict__ gout, const float* __restrict__ src,
                float* __restrict__ grad, Geom g) {
    extern __shared__ __align__(16) float smem[];
    float* halo = smem;                                   // n * HW * CP
    float* coef = smem + static_cast<size_t>(g.n) * g.HW * g.CP;   // TW * D

    const int seg = blockIdx.x % g.nt;
    const int row = blockIdx.x / g.nt;
    const int i = row % g.H, b = row / g.H;
    const int x0 = seg * g.TW;

    stage_halo<VEC>(src + static_cast<size_t>(b) * g.H * g.W * g.C, halo, g, i, x0);
    const float* gimg = gout + static_cast<size_t>(b) * g.H * g.W * g.D;
    for (int e = threadIdx.x; e < g.TW * g.D; e += blockDim.x) {
        const int jj = e / g.D, k = e % g.D;
        float v = 0.f;
        if (MIRROR) {
            const int y = i + (k / g.n - g.steps) * g.stride;
            const int x = x0 + jj + (k % g.n - g.steps) * g.stride;
            if (x0 + jj < g.W && y >= 0 && y < g.H && x >= 0 && x < g.W)
                v = gimg[(static_cast<size_t>(y) * g.W + x) * g.D + (g.D - 1 - k)];
        } else if (x0 + jj < g.W) {
            v = gimg[(static_cast<size_t>(i) * g.W + x0 + jj) * g.D + k];
        }
        coef[e] = v;
    }
    __syncthreads();

    float* grow = grad + (static_cast<size_t>(row) * g.W + x0) * g.C;
    for (int o = threadIdx.x; o < g.TW * g.C4; o += blockDim.x) {
        const int jj = o / g.C4, c4 = o % g.C4;
        if (x0 + jj >= g.W) break;
        const float* co = coef + jj * g.D;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int iy = 0; iy < g.n; ++iy) {
            const float* hrow = halo + static_cast<size_t>(iy * g.HW + jj) * g.CP + 4 * c4;
            for (int ix = 0; ix < g.n; ++ix) {
                const float w = co[iy * g.n + ix];
                const float4 q = *reinterpret_cast<const float4*>(
                    hrow + static_cast<size_t>(ix * g.stride) * g.CP);
                acc.x = fmaf(w, q.x, acc.x);
                acc.y = fmaf(w, q.y, acc.y);
                acc.z = fmaf(w, q.z, acc.z);
                acc.w = fmaf(w, q.w, acc.w);
            }
        }
        float* dst = grow + static_cast<size_t>(jj) * g.C + 4 * c4;
        if (VEC) {
            *reinterpret_cast<float4*>(dst) = make_float4(
                acc.x * g.inv_c, acc.y * g.inv_c, acc.z * g.inv_c, acc.w * g.inv_c);
        } else {
            const int c = 4 * c4;
            dst[0] = acc.x * g.inv_c;
            if (c + 1 < g.C) dst[1] = acc.y * g.inv_c;
            if (c + 2 < g.C) dst[2] = acc.z * g.inv_c;
            if (c + 3 < g.C) dst[3] = acc.w * g.inv_c;
        }
    }
}

// ---- the same sums straight from global memory, for a displacement window
// ---- too large for any tile to fit a block's shared memory

__global__ void __launch_bounds__(MAX_THREADS)
corr_fwd_direct_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                       float* __restrict__ out, Geom g, size_t total) {
    for (size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         o < total; o += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int k = static_cast<int>(o % g.D);
        const size_t pix = o / g.D;                       // (b*H + i)*W + j
        const int j = static_cast<int>(pix % g.W);
        const int i = static_cast<int>((pix / g.W) % g.H);
        const int y = i + (k / g.n - g.steps) * g.stride;
        const int x = j + (k % g.n - g.steps) * g.stride;
        float acc = 0.f;
        if (y >= 0 && y < g.H && x >= 0 && x < g.W) {
            const size_t image = pix - (static_cast<size_t>(i) * g.W + j);   // b*H*W
            const float* a = f1 + pix * g.C;
            const float* v = f2 + (image + static_cast<size_t>(y) * g.W + x) * g.C;
            for (int c = 0; c < g.C; ++c) acc = fmaf(a[c], v[c], acc);
        }
        out[o] = acc * g.inv_c;
    }
}

template <bool MIRROR>
__global__ void __launch_bounds__(MAX_THREADS)
corr_bwd_direct_kernel(const float* __restrict__ gout, const float* __restrict__ src,
                       float* __restrict__ grad, Geom g, size_t total) {
    for (size_t o = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         o < total; o += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int c = static_cast<int>(o % g.C);
        const size_t pix = o / g.C;
        const int j = static_cast<int>(pix % g.W);
        const int i = static_cast<int>((pix / g.W) % g.H);
        const size_t image = pix - (static_cast<size_t>(i) * g.W + j);   // b*H*W
        float acc = 0.f;
        for (int k = 0; k < g.D; ++k) {
            const int y = i + (k / g.n - g.steps) * g.stride;
            const int x = j + (k % g.n - g.steps) * g.stride;
            if (y < 0 || y >= g.H || x < 0 || x >= g.W) continue;
            const size_t nb = image + static_cast<size_t>(y) * g.W + x;
            const float w = MIRROR ? gout[nb * g.D + (g.D - 1 - k)] : gout[pix * g.D + k];
            acc = fmaf(w, src[nb * g.C + c], acc);
        }
        grad[o] = acc * g.inv_c;
    }
}

constexpr int MAX_DEVICES = 64;

// The calling thread's current device becomes `device`; the runtime call is
// made only when it is another one.
inline cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

// Fills the tiling of `g` for a kernel whose block needs, beside the halo,
// `extra_per_col` floats per column.  Returns the bytes of dynamic shared
// memory, or 0 when not even a one-column tile fits a block.
size_t plan_tiles(Geom& g, int extra_per_col) {
    auto bytes = [&](int tw) {
        return sizeof(float) * (static_cast<size_t>(g.n) * (tw + 2 * g.R) * g.CP
                                + static_cast<size_t>(tw) * extra_per_col);
    };
    if (bytes(1) > static_cast<size_t>(MAX_DYNAMIC_SMEM)) return 0;
    int tw = 1;
    while (tw < g.W && bytes(tw + 1) <= static_cast<size_t>(TILE_SMEM_TARGET)) ++tw;
    g.nt = (g.W + tw - 1) / tw;
    g.TW = (g.W + g.nt - 1) / g.nt;       // even segments, none wider than tw
    g.HW = g.TW + 2 * g.R;
    return bytes(g.TW);
}

// Threads for `work` items per block: full rounds of at most MAX_THREADS.
int threads_for(int work) {
    const int rounds = (work + MAX_THREADS - 1) / MAX_THREADS;
    const int per_round = (work + rounds - 1) / rounds;
    return ((per_round + 31) / 32) * 32;
}

// Above 48 KB dynamic shared memory is opt-in: once per kernel and device.
template <typename Kernel>
cudaError_t allow_large_smem(Kernel kernel, std::atomic<bool>* opted_in, int device,
                             size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    const bool remember = device >= 0 && device < MAX_DEVICES;
    if (remember && opted_in[device].load()) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
    if (err == cudaSuccess && remember) opted_in[device].store(true);
    return err;
}

template <bool VEC>
cudaError_t launch_fwd(const float* f1, const float* f2, float* out, const Geom& g,
                       int blocks, size_t smem, int device, cudaStream_t st) {
    static std::atomic<bool> opted_in[MAX_DEVICES];
    cudaError_t err = allow_large_smem(corr_fwd_kernel<VEC>, opted_in, device, smem);
    if (err != cudaSuccess) return err;
    corr_fwd_kernel<VEC><<<blocks, threads_for(g.TW * g.D), smem, st>>>(f1, f2, out, g);
    return cudaGetLastError();
}

template <bool MIRROR, bool VEC>
cudaError_t launch_bwd(const float* gout, const float* src, float* grad, const Geom& g,
                       int blocks, size_t smem, int device, cudaStream_t st) {
    static std::atomic<bool> opted_in[MAX_DEVICES];
    cudaError_t err = allow_large_smem(corr_bwd_kernel<MIRROR, VEC>, opted_in, device, smem);
    if (err != cudaSuccess) return err;
    corr_bwd_kernel<MIRROR, VEC><<<blocks, threads_for(g.TW * g.C4), smem, st>>>(
        gout, src, grad, g);
    return cudaGetLastError();
}

bool make_geom(Geom& g, int H, int W, int C, int max_disp, int stride) {
    if (H <= 0 || W <= 0 || C <= 0 || max_disp < 0 || stride < 1) return false;
    g.H = H; g.W = W; g.C = C;
    g.stride = stride;
    g.steps = max_disp / stride;
    g.n = 2 * g.steps + 1;
    g.D = g.n * g.n;
    g.R = g.steps * stride;
    g.C4 = (C + 3) / 4;
    g.CP = 4 * (g.C4 | 1);                // CP/4 odd: float4 columns spread over the banks
    g.inv_c = 1.0f / static_cast<float>(C);
    g.TW = g.nt = g.HW = 0;
    return true;
}

int direct_blocks(size_t total) {
    const size_t want = (total + MAX_THREADS - 1) / MAX_THREADS;
    return static_cast<int>(want < 65536 ? want : 65536);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// All three launch on `stream` of `device`, do not synchronise and allocate
// nothing; every tensor is contiguous float32, channels last.  They return
// the cudaError_t of the launch (0 = success; cudaErrorInvalidValue for a
// geometry the kernels do not take) for the caller to raise on.

// f1, f2: (B, H, W, C) -> out: (B, H, W, D).
extern "C" int avt_correlation_forward(const float* f1, const float* f2, float* out,
                                       int B, int H, int W, int C, int max_disp,
                                       int stride, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (B <= 0) return 0;
    Geom g;
    if (!make_geom(g, H, W, C, max_disp, stride)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = plan_tiles(g, g.CP);
    if (smem == 0) {
        const size_t total = static_cast<size_t>(B) * H * W * g.D;
        corr_fwd_direct_kernel<<<direct_blocks(total), MAX_THREADS, 0, st>>>(f1, f2, out, g, total);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t blocks = static_cast<size_t>(B) * H * g.nt;
    if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = C % 4 == 0 && aligned16(f1) && aligned16(f2);
    err = vec ? launch_fwd<true>(f1, f2, out, g, static_cast<int>(blocks), smem, device, st)
              : launch_fwd<false>(f1, f2, out, g, static_cast<int>(blocks), smem, device, st);
    return static_cast<int>(err);
}

// One gradient.  mirror == 0: `src` is f2 and `grad` is the gradient of f1;
// mirror != 0: `src` is f1 and `grad` is the gradient of f2.
// gout: (B, H, W, D); src, grad: (B, H, W, C).
extern "C" int avt_correlation_backward(const float* gout, const float* src, float* grad,
                                        int mirror, int B, int H, int W, int C,
                                        int max_disp, int stride, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (B <= 0) return 0;
    Geom g;
    if (!make_geom(g, H, W, C, max_disp, stride)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = plan_tiles(g, g.D);
    if (smem == 0) {
        const size_t total = static_cast<size_t>(B) * H * W * C;
        if (mirror)
            corr_bwd_direct_kernel<true><<<direct_blocks(total), MAX_THREADS, 0, st>>>(
                gout, src, grad, g, total);
        else
            corr_bwd_direct_kernel<false><<<direct_blocks(total), MAX_THREADS, 0, st>>>(
                gout, src, grad, g, total);
        return static_cast<int>(cudaGetLastError());
    }
    const size_t blocks = static_cast<size_t>(B) * H * g.nt;
    if (blocks > 0x7fffffffu) return static_cast<int>(cudaErrorInvalidValue);
    const int nb = static_cast<int>(blocks);
    const bool vec = C % 4 == 0 && aligned16(src) && aligned16(grad);
    if (mirror)
        err = vec ? launch_bwd<true, true>(gout, src, grad, g, nb, smem, device, st)
                  : launch_bwd<true, false>(gout, src, grad, g, nb, smem, device, st);
    else
        err = vec ? launch_bwd<false, true>(gout, src, grad, g, nb, smem, device, st)
                  : launch_bwd<false, false>(gout, src, grad, g, nb, smem, device, st);
    return static_cast<int>(err);
}
