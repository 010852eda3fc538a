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
// taken from that neighbour's own g vector at channel D-1-k ("mirrored").
//
// Bound on this card: by bytes (each input read once, the output written
// once; the 2*B*H*W*C*D FLOPs are fewer microseconds than that at D = 81, and
// they stay on the fp32 CUDA cores: TF32 would break the 1e-5 bar).  Three
// things decide how far above the bound a kernel lands, and the tiled kernels
// below are built around them:
//
//   1. How often the other map is re-read from L2.  A block owns (image,
//      TH rows x TW columns) and stages the (TH+2R) x (TW+2R) pixels its tile
//      can reach, so the halo is shared along rows AND columns: 3.9 times the
//      map at 4 x 28 with R = 4 (a row segment of 7 columns re-read it 19
//      times).  Nothing is padded in memory: a copy whose pixel lies outside
//      the map is a `cp.async` with a source size of 0, which zero-fills.
//   2. Shared-memory operands per FMA.  The channels are walked in chunks of
//      CK = 32; a forward thread owns one row, one dy, JT = 4 neighbouring
//      columns and NX = 9 dx: 36 accumulators that live in registers across
//      all chunks, fed per channel quad by 4 float4 of f1 and 12 of f2 (9 FMAs
//      a load; one output per thread had 2).  A backward thread owns one row,
//      4 neighbouring columns and 4 channels: per dy 12 float4 of the source
//      and 36 scalar coefficients feed 144 FMAs.  A staged pixel takes CKP =
//      36 floats (an odd number of float4) and a staged row an odd number of
//      pixels, so that lanes along dy (forward) or along channel quad and
//      column group (backward) read different banks.
//   3. Overlap.  The chunks are copied by `cp.async` (16-byte copies,
//      `cp.async.wait_group`), either into one buffer or into a ring of two
//      (NSTAGE), chunk c+1 in flight while chunk c is multiplied.  Timed on an
//      H100: where the grid is one wave (the pretrainer's 20 images), a block
//      is alone on its SM and the ring takes a third off its time -- provided
//      the tile is chosen so that the grid IS one wave: 140 blocks on 132 SMs
//      wait for a second wave of 8, and the ring's shared memory keeps that
//      wave from fitting beside the first.  Where the grid is many waves (300
//      images), two blocks an SM with one buffer each overlap one another as
//      well as a ring does and beat one block an SM with a ring.  `plan_tiled`
//      models both and chooses tile and ring depth together.  Index
//      arithmetic is kept out of the copy and store loops (with a division
//      per element the integer instructions, not memory, bound the kernel): a
//      thread carries row and column along.
//
// The forward's results cross shared memory once more on the way out, so that
// a warp stores 128 contiguous bytes of out[b,i,j,:] (a thread's own 9-float
// runs would touch a sector per lane).  Both gradients come from ONE launch:
// gridDim.y = 2, blockIdx.y = 0 computes gf2 and 1 computes gf1 (the dearer
// blocks first, so that the cheaper ones fill the tail).  A gf2 block builds
// its TH x TW x D coefficients from the (TH+2R) x (TW+2R) patch of g, one warp
// per patch row with the lanes along g's channels (coalesced), scattered into
// shared memory by 4-byte `cp.async` (a load and a store per coefficient
// waited a trip to L2 each).
//
// Order of the fp32 sums: every output sums its C products (forward) or its D
// products (backward, dy outer) in increasing index order with `fmaf`, chunk
// after chunk into the same register; no atomics, so two runs give the same
// bits.  Against the plain version (another order) that is within 1e-5 on
// unit-scale inputs.
//
// Which kernel runs follows from the geometry alone (`avt_correlation_variant`,
// twin of `correlation_plan` in ops/correlation.py):
//   tiled          stride 1, C % 4 == 0, 16-byte aligned maps, and a tile that
//                  fits a block's shared memory (windows up to about 17 x 17);
//   rowseg_vec4 /  the row-segment kernels, the simpler design: block = (image,
//   rowseg_scalar  row, TW columns), the n halo rows whole in shared memory,
//                  one thread per output.  They take every stride; the scalar
//                  one takes C % 4 != 0 and unaligned maps (no `cp.async`);
//   direct         straight from global memory, for a window no tile holds.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_THREADS = 256;
// a block may use 232448 bytes of shared memory, static part included
constexpr int MAX_DYNAMIC_SMEM = 232448 - 1024;
// preferred size of a row-segment block's tile: three blocks fit one SM
constexpr int TILE_SMEM_TARGET = 64 * 1024;

// ---- the tiled kernels' constants (mirrored in ops/correlation.py)
constexpr int CK = 32;            // channels a chunk
constexpr int CKP = 36;           // floats a staged pixel: CK/4 + 1 float4, odd
constexpr int JT = 4;             // neighbouring columns a thread owns
constexpr int NX = 9;             // displacements along x a forward thread owns
constexpr int TILED_THREADS = 320;   // most threads a tiled block has
constexpr int DENSE_THREADS = 256;   // ... a forward block without a ring (two an SM)
constexpr int SM_COUNT = 132;
constexpr int SM_SMEM = 233472;   // shared memory of one SM; a block takes 1 KB beside its own
constexpr int COPY_COST = 13;     // FMAs that one float copied from L2 costs (measured)

enum Variant { V_DIRECT = 0, V_ROWSEG_SCALAR = 1, V_ROWSEG_VEC4 = 2, V_TILED = 3 };

// A loop whose index is a compile-time constant in the body, so that every
// register-array index below is resolved by the compiler (a `#pragma unroll`
// loop may leave such an array in local memory).
template <int V> struct Int { static constexpr int value = V; };
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    if constexpr (I < N) {
        f(Int<I>{});
        static_for<I + 1, N>(f);
    }
}

// ======================================================================
// tiled kernels
// ======================================================================

struct TGeom {
    int H, W, C, D;
    int n;          // displacements per axis
    int R;          // reach in pixels (stride is 1)
    int TH, TW;     // the tile; TW is a multiple of JT
    int tiles_x, tiles_y;
    int nq;         // column groups of JT in a tile row
    int nxc;        // forward: groups of NX displacements along x
    int hpitch;     // pixels a staged halo row takes (forward: odd)
    int tpitch;     // forward: pixels a staged f1 row takes (odd)
    float inv_c;
};

// 16 bytes global -> shared, asynchronously; `valid == false` reads nothing
// and fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const size_t s = __cvta_generic_to_global(src);
    const int bytes = valid ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(s), "r"(bytes) : "memory");
}
// the same for 4 bytes
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const size_t s = __cvta_generic_to_global(src);
    const int bytes = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(s), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// channels c0 .. c0+CK-1 of the pixels (y0 + r, x0 + col), r < rows,
// col < cols, of one image (H x W x C) -> buf[(r*pitch + col)*CKP + c - c0];
// zero outside the map and from channel C up
__device__ __forceinline__ void stage_patch_async(
        const float* __restrict__ img, float* buf, int H, int W, int C,
        int y0, int x0, int rows, int cols, int pitch, int c0) {
    // a thread keeps its channel quad and walks the pixels blockDim/Q at a
    // time, row and column carried along: index arithmetic, not divisions, is
    // what this loop costs (blockDim is a multiple of 32, hence of Q)
    constexpr int Q = CK / 4;
    const int c = c0 + 4 * (threadIdx.x % Q);
    const int step = blockDim.x / Q;
    const int step_r = step / cols, step_c = step - step_r * cols;
    int t = threadIdx.x / Q;
    int r = t / cols, col = t - r * cols;
    float* dst = buf + 4 * (threadIdx.x % Q);
    for (const int npix = rows * cols; t < npix; t += step) {
        const int y = y0 + r, x = x0 + col;
        const bool ok = y >= 0 && y < H && x >= 0 && x < W && c < C;
        const float* src = ok ? img + (static_cast<size_t>(y) * W + x) * C + c : img;
        cp_async16(dst + (r * pitch + col) * CKP, src, ok);
        r += step_r;
        col += step_c;
        if (col >= cols) { col -= cols; ++r; }
    }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& v, float acc) {
    acc = fmaf(a.x, v.x, acc);
    acc = fmaf(a.y, v.y, acc);
    acc = fmaf(a.z, v.z, acc);
    acc = fmaf(a.w, v.w, acc);
    return acc;
}

__device__ __forceinline__ void axpy4(float w, const float4& v, float4& acc) {
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z);
    acc.w = fmaf(w, v.w, acc.w);
}

// Forward.  Thread = (column group qd, tile row r, dy index iy, dx group xc),
// iy fastest: its JT x NX outputs out[i0+r, j0+4qd+jj, iy*n + xc*NX + ix].
template <int NSTAGE>
__global__ void __launch_bounds__(NSTAGE == 1 ? DENSE_THREADS : TILED_THREADS,
                                  NSTAGE == 1 ? 2 : 1)
corr_fwd_tiled_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                      float* __restrict__ out, TGeom g) {
    extern __shared__ __align__(16) float smem[];
    const int tiles = g.tiles_x * g.tiles_y;
    const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
    const int i0 = (tile / g.tiles_x) * g.TH, j0 = (tile % g.tiles_x) * g.TW;
    const size_t image = static_cast<size_t>(b) * g.H * g.W;   // pixels before this image
    const float* img1 = f1 + image * g.C;
    const float* img2 = f2 + image * g.C;
    const int hrows = g.TH + 2 * g.R;
    const int halo_floats = hrows * g.hpitch * CKP;
    const int stage_floats = halo_floats + g.TH * g.tpitch * CKP;
    const int nch = (g.C + CK - 1) / CK;

    auto copy_chunk = [&](int ch) {
        float* buf = smem + (ch % NSTAGE) * stage_floats;
        stage_patch_async(img2, buf, g.H, g.W, g.C, i0 - g.R, j0 - g.R, hrows,
                          g.TW + 2 * g.R, g.hpitch, ch * CK);
        stage_patch_async(img1, buf + halo_floats, g.H, g.W, g.C, i0, j0, g.TH, g.TW,
                          g.tpitch, ch * CK);
    };

    // a thread beyond the tile's work computes thread 0's sums and stores nothing
    // (a warp with no work at all skips the sums; the branch is on the warp)
    const int items = g.nq * g.TH * g.n * g.nxc;
    const bool active = static_cast<int>(threadIdx.x) < items;
    const bool warp_active = static_cast<int>(threadIdx.x & ~31u) < items;
    int rest = active ? threadIdx.x : 0;
    const int iy = rest % g.n;  rest /= g.n;
    const int r = rest % g.TH;  rest /= g.TH;
    const int qd = rest % g.nq;
    const int xc = rest / g.nq;
    const int a_off = (r * g.tpitch + JT * qd) * CKP;
    const int v_off = ((r + iy) * g.hpitch + JT * qd + xc * NX) * CKP;

    float acc[JT][NX];
    static_for<0, JT>([&](auto jj) {
        static_for<0, NX>([&](auto ix) { acc[decltype(jj)::value][decltype(ix)::value] = 0.f; });
    });

    static_for<0, NSTAGE - 1>([&](auto s_) {
        constexpr int s = decltype(s_)::value;
        if (s < nch) copy_chunk(s);
        cp_async_commit();
    });
    for (int ch = 0; ch < nch; ++ch) {
        if (ch + NSTAGE - 1 < nch) copy_chunk(ch + NSTAGE - 1);
        cp_async_commit();
        cp_async_wait<NSTAGE - 1>();          // chunk ch has landed
        __syncthreads();
        const float* stage = smem + (ch % NSTAGE) * stage_floats;
        const float* ap = stage + halo_floats + a_off;
        const float* vp = stage + v_off;
        if (warp_active) static_for<0, CK / 4>([&](auto q_) {
            constexpr int q = decltype(q_)::value;
            float4 a[JT];
            static_for<0, JT>([&](auto jj_) {
                constexpr int jj = decltype(jj_)::value;
                a[jj] = *reinterpret_cast<const float4*>(ap + jj * CKP + 4 * q);
            });
            // halo column col serves every (jj, ix) with jj + ix == col
            static_for<0, JT + NX - 1>([&](auto col_) {
                constexpr int col = decltype(col_)::value;
                const float4 v = *reinterpret_cast<const float4*>(vp + col * CKP + 4 * q);
                static_for<0, JT>([&](auto jj_) {
                    constexpr int jj = decltype(jj_)::value;
                    constexpr int ix = col - jj;
                    if constexpr (ix >= 0 && ix < NX) acc[jj][ix] = dot4(a[jj], v, acc[jj][ix]);
                });
            });
        });
        __syncthreads();                      // the buffer may be filled again
    }

    // through shared memory, so that the stores to out[b,i,j,:] are contiguous
    float* otile = smem;                      // TH * TW * D
    if (active) {
        static_for<0, JT>([&](auto jj_) {
            constexpr int jj = decltype(jj_)::value;
            float* o = otile + static_cast<size_t>(r * g.TW + JT * qd + jj) * g.D
                       + iy * g.n + xc * NX;
            static_for<0, NX>([&](auto ix_) {
                constexpr int ix = decltype(ix_)::value;
                if (xc * NX + ix < g.n) o[ix] = acc[jj][ix] * g.inv_c;
            });
        });
    }
    __syncthreads();
    // ragged tile edges end here: the rows and the floats of a row that exist
    const int rows = min(g.TH, g.H - i0), valid = min(g.TW, g.W - j0) * g.D;
    for (int rr = 0; rr < rows; ++rr) {
        float* dst = out + (image + static_cast<size_t>(i0 + rr) * g.W + j0) * g.D;
        const float* srow = otile + rr * g.TW * g.D;
        for (int e = threadIdx.x; e < valid; e += blockDim.x) dst[e] = srow[e];
    }
}

// Backward.  `mode` chooses the gradient: 0 = gf1 (source f2, coefficients
// g[b,i,j,:]), 1 = gf2 (source f1, mirrored coefficients), 2 = both, gf2 in
// the blocks with blockIdx.y == 0 and gf1 in the others.  Thread = (tile row
// r, column group qd, channel quad q of the chunk), q fastest.  N is the
// window's n when it is known at compile time, else 0.
template <int NSTAGE, int N>
__global__ void __launch_bounds__(TILED_THREADS, 2)
corr_bwd_tiled_kernel(const float* __restrict__ gout, const float* __restrict__ f1,
                      const float* __restrict__ f2, float* __restrict__ gf1,
                      float* __restrict__ gf2, int mode, TGeom g) {
    extern __shared__ __align__(16) float smem[];
    const int tiles = g.tiles_x * g.tiles_y;
    const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
    const int i0 = (tile / g.tiles_x) * g.TH, j0 = (tile % g.tiles_x) * g.TW;
    const bool mirror = mode == 2 ? blockIdx.y == 0 : mode == 1;
    const int n = N ? N : g.n;
    const int D = n * n;
    const size_t image = static_cast<size_t>(b) * g.H * g.W;
    const float* src = (mirror ? f1 : f2) + image * g.C;
    float* grad = (mirror ? gf2 : gf1) + image * g.C;
    const float* gimg = gout + image * D;
    const int hrows = g.TH + 2 * g.R, hw = g.TW + 2 * g.R;
    const int stage_floats = hrows * g.hpitch * CKP;
    const int nch = (g.C + CK - 1) / CK;
    float* coef = smem;                                   // TH * TW * D
    float* ring = smem + ((g.TH * g.TW * D + 3) & ~3);    // NSTAGE * stage_floats

    auto copy_chunk = [&](int ch) {
        stage_patch_async(src, ring + (ch % NSTAGE) * stage_floats, g.H, g.W, g.C,
                          i0 - g.R, j0 - g.R, hrows, hw, g.hpitch, ch * CK);
    };
    // the coefficients coef[(tr*TW + tc)*D + k]: 4-byte asynchronous copies (a
    // load into a register and a store would wait a trip to L2 each), in the
    // first chunk's group
    if (mirror) {
        // a warp per row of the g patch, the lanes along g's channels (so a
        // warp reads one pixel's contiguous vector): channel kk of patch pixel
        // (py, px) is the coefficient k = D-1-kk of the tile pixel
        // (py - ky, px - kx), where that is inside the tile
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
        for (int kk = lane; kk < D; kk += 32) {
            const int k = D - 1 - kk, ky = k / n, kx = k % n;
            for (int py = warp; py < hrows; py += nwarps) {
                const int tr = py - ky, y = i0 - g.R + py;
                if (tr < 0 || tr >= g.TH) continue;
                const bool row_ok = y >= 0 && y < g.H;
                const int base = (tr * g.TW - kx) * D + k;
                for (int px = 0; px < hw; ++px) {
                    const int tc = px - kx, x = j0 - g.R + px;
                    if (tc < 0 || tc >= g.TW) continue;
                    const bool ok = row_ok && x >= 0 && x < g.W;
                    cp_async4(coef + base + px * D,
                              ok ? gimg + (static_cast<size_t>(y) * g.W + x) * D + kk : gimg, ok);
                }
            }
        }
    } else {
        const int row_floats = g.TW * D, valid = min(g.TW, g.W - j0) * D;
        for (int tr = 0; tr < g.TH; ++tr) {
            const float* grow = gimg + (static_cast<size_t>(i0 + tr) * g.W + j0) * D;
            const int have = i0 + tr < g.H ? valid : 0;
            for (int e = threadIdx.x; e < row_floats; e += blockDim.x)
                cp_async4(coef + tr * row_floats + e, e < have ? grow + e : gimg, e < have);
        }
    }

    static_for<0, NSTAGE - 1>([&](auto s_) {
        constexpr int s = decltype(s_)::value;
        if (s < nch) copy_chunk(s);
        cp_async_commit();
    });

    constexpr int Q = CK / 4;
    const int items = g.TH * g.nq * Q;
    const bool active = static_cast<int>(threadIdx.x) < items;
    const bool warp_active = static_cast<int>(threadIdx.x & ~31u) < items;
    int rest = active ? threadIdx.x : 0;
    const int q = rest % Q;  rest /= Q;
    const int qd = rest % g.nq;
    const int r = rest / g.nq;
    const float* cp = coef + (r * g.TW + JT * qd) * D;
    const int v_off = (r * g.hpitch + JT * qd) * CKP + 4 * q;
    const int row = i0 + r, col0 = j0 + JT * qd;

    for (int ch = 0; ch < nch; ++ch) {
        if (ch + NSTAGE - 1 < nch) copy_chunk(ch + NSTAGE - 1);
        cp_async_commit();
        cp_async_wait<NSTAGE - 1>();          // chunk ch has landed
        __syncthreads();                      // ... and, the first time, the coefficients
        const float* vp = ring + (ch % NSTAGE) * stage_floats + v_off;
        float4 acc[JT];
        static_for<0, JT>([&](auto jj) {
            acc[decltype(jj)::value] = make_float4(0.f, 0.f, 0.f, 0.f);
        });
#pragma unroll 1
        for (int ky = 0; ky < (warp_active ? n : 0); ++ky) {
            const float* vrow = vp + ky * g.hpitch * CKP;
            const float* crow = cp + ky * n;
            if constexpr (N > 0) {
                // patch column c serves every (jj, kx) with jj + kx == c
                static_for<0, JT + N - 1>([&](auto c_) {
                    constexpr int c = decltype(c_)::value;
                    const float4 v = *reinterpret_cast<const float4*>(vrow + c * CKP);
                    static_for<0, JT>([&](auto jj_) {
                        constexpr int jj = decltype(jj_)::value;
                        constexpr int kx = c - jj;
                        if constexpr (kx >= 0 && kx < N) axpy4(crow[jj * D + kx], v, acc[jj]);
                    });
                });
            } else {
                for (int kx = 0; kx < n; ++kx) {
                    static_for<0, JT>([&](auto jj_) {
                        constexpr int jj = decltype(jj_)::value;
                        const float4 v = *reinterpret_cast<const float4*>(
                            vrow + (kx + jj) * CKP);
                        axpy4(crow[jj * D + kx], v, acc[jj]);
                    });
                }
            }
        }
        const int c = ch * CK + 4 * q;
        static_for<0, JT>([&](auto jj_) {
            constexpr int jj = decltype(jj_)::value;
            if (active && row < g.H && col0 + jj < g.W && c < g.C)   // ragged edges end here
                *reinterpret_cast<float4*>(
                    grad + (static_cast<size_t>(row) * g.W + col0 + jj) * g.C + c) =
                    make_float4(acc[jj].x * g.inv_c, acc[jj].y * g.inv_c,
                                acc[jj].z * g.inv_c, acc[jj].w * g.inv_c);
        });
        __syncthreads();                      // the buffer may be filled again
    }
}

// ======================================================================
// row-segment kernels (every stride, every C, any alignment)
// ======================================================================

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
        for (int c4 = 0; c4 < g.C4; ++c4) acc = dot4(a[c4], v[c4], acc);
        orow[o] = acc * g.inv_c;
    }
}

// grad[b,i,j,c] = (1/C) sum_k coef[j][k] * src[b, i+dy_k, j+dx_k, c].
// The gradient is chosen as in the tiled kernel (`mode`, blockIdx.y):
// gf1: src = f2, coef[j][k] = gout[b,i,j,k];
// gf2: src = f1, coef[j][k] = gout[b,i+dy_k,j+dx_k,D-1-k], zero where that
//      pixel is outside the map.
template <bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
corr_bwd_kernel(const float* __restrict__ gout, const float* __restrict__ f1,
                const float* __restrict__ f2, float* __restrict__ gf1,
                float* __restrict__ gf2, int mode, Geom g) {
    extern __shared__ __align__(16) float smem[];
    float* halo = smem;                                   // n * HW * CP
    float* coef = smem + static_cast<size_t>(g.n) * g.HW * g.CP;   // TW * D

    const bool mirror = mode == 2 ? blockIdx.y == 0 : mode == 1;
    const float* src = mirror ? f1 : f2;
    float* grad = mirror ? gf2 : gf1;
    const int seg = blockIdx.x % g.nt;
    const int row = blockIdx.x / g.nt;
    const int i = row % g.H, b = row / g.H;
    const int x0 = seg * g.TW;

    stage_halo<VEC>(src + static_cast<size_t>(b) * g.H * g.W * g.C, halo, g, i, x0);
    const float* gimg = gout + static_cast<size_t>(b) * g.H * g.W * g.D;
    for (int e = threadIdx.x; e < g.TW * g.D; e += blockDim.x) {
        const int jj = e / g.D, k = e % g.D;
        float v = 0.f;
        if (mirror) {
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
            for (int ix = 0; ix < g.n; ++ix)
                axpy4(co[iy * g.n + ix],
                      *reinterpret_cast<const float4*>(
                          hrow + static_cast<size_t>(ix * g.stride) * g.CP), acc);
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

__global__ void __launch_bounds__(MAX_THREADS)
corr_bwd_direct_kernel(const float* __restrict__ gout, const float* __restrict__ f1,
                       const float* __restrict__ f2, float* __restrict__ gf1,
                       float* __restrict__ gf2, int mode, Geom g, size_t total) {
    const bool mirror = mode == 2 ? blockIdx.y == 0 : mode == 1;
    const float* src = mirror ? f1 : f2;
    float* grad = mirror ? gf2 : gf1;
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
            const float w = mirror ? gout[nb * g.D + (g.D - 1 - k)] : gout[pix * g.D + k];
            acc = fmaf(w, src[nb * g.C + c], acc);
        }
        grad[o] = acc * g.inv_c;
    }
}

// ======================================================================
// host side: which kernel, which tile
// ======================================================================

constexpr int MAX_DEVICES = 64;

// The calling thread's current device becomes `device`; the runtime call is
// made only when it is another one.
inline cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

// What `avt_correlation_variant` reports, in this order.
struct Plan {
    int variant;
    int TH, TW;       // the tile (row segment: TH = 1; direct: 0, 0)
    int CK, stages;   // channels a chunk and chunks in flight (untiled: C, 1)
    int smem;         // bytes of dynamic shared memory a block
    int blocks;       // of one gradient in the backward
    int threads;
};

// The tile and the ring depth of the tiled kernels: the candidate with the
// least modelled time.  Candidates: every tile whose work fits one block (a
// thread per item) with one buffer or a ring of two, whose buffers fit a
// block's shared memory.  The model, in FMA times: a block copies `copy`
// floats at COPY_COST each and does `comp` FMAs; alone on its SM with one
// buffer it takes their sum; with a ring, or with a second block beside it,
// the smaller of the two hides behind the larger except for one chunk.  The
// busiest SM gets m = ceil(blocks / SM_COUNT) blocks.  So a grid of one wave
// takes the ring and the largest tile that still gives (almost) every SM a
// block, and a grid of many waves takes one buffer and two blocks an SM.
// `gradients` is what one backward launch computes (1 or 2).  Integers only
// and a fixed order of trial, so that the Python twin agrees exactly.
bool plan_tiled(bool backward, int gradients, int B, int H, int W, int C, int R, Plan& p,
                TGeom& g) {
    const int n = 2 * R + 1, D = n * n;
    const int nxc = (n + NX - 1) / NX;
    const int nch = (C + CK - 1) / CK;
    bool found = false;
    long long best = 0;
    for (int th = 1; th <= H && th <= TILED_THREADS; ++th) {
        for (int tq = 1; tq <= (W + JT - 1) / JT; ++tq) {
            const int tw = JT * tq;
            const long long items = backward ? static_cast<long long>(th) * tq * (CK / 4)
                                             : static_cast<long long>(th) * tq * n * nxc;
            if (items > TILED_THREADS) break;
            const int hrows = th + 2 * R, hcols = tw + 2 * R;
            // the forward's lanes run along dy: an odd pitch spreads them over
            // the banks; the backward's run along the channels of one pixel
            const int hpitch = backward ? hcols : (tw + NX * nxc - 1) | 1;
            const int tpitch = tw | 1;
            const long long tiles = static_cast<long long>((H + th - 1) / th) * ((W + tw - 1) / tw);
            const long long blocks = tiles * B;
            if (blocks * gradients > 0x7fffffffLL) continue;
            const long long m = (blocks * (backward ? gradients : 1) + SM_COUNT - 1) / SM_COUNT;
            const long long copy = COPY_COST
                * (static_cast<long long>(nch) * CK * (hrows * hcols + (backward ? 0 : th * tw))
                   + (backward ? static_cast<long long>(th) * tw * D : 0));
            const long long comp = static_cast<long long>(th) * tw * D * C;
            const long long overlapped = (copy > comp ? copy : comp)
                                         + (copy > comp ? comp : copy) / nch;
            for (int stages = 1; stages <= 2; ++stages) {
                if (!backward && stages == 1 && items > DENSE_THREADS) continue;
                long long smem;
                if (backward) {
                    smem = 4LL * ((th * tw * D + 3) & ~3) + 4LL * stages * CKP * hrows * hpitch;
                } else {
                    smem = 4LL * stages * CKP * (hrows * hpitch + th * tpitch);
                    if (smem < 4LL * th * tw * D) smem = 4LL * th * tw * D;   // the staged output
                }
                if (smem > MAX_DYNAMIC_SMEM) continue;
                // the forward's ring kernel may use the registers of a whole SM
                const int per_sm = (!backward && stages == 2) || 2 * (smem + 1024) > SM_SMEM ? 1 : 2;
                const long long time =
                    m * (stages == 1 && (m == 1 || per_sm == 1) ? copy + comp : overlapped);
                if (found && time >= best) continue;
                found = true;
                best = time;
                p.variant = V_TILED;
                p.TH = th; p.TW = tw; p.CK = CK; p.stages = stages;
                p.smem = static_cast<int>(smem);
                p.blocks = static_cast<int>(blocks);
                p.threads = (static_cast<int>(items) + 31) / 32 * 32;
                g.H = H; g.W = W; g.C = C; g.D = D; g.n = n; g.R = R;
                g.TH = th; g.TW = tw;
                g.tiles_x = (W + tw - 1) / tw; g.tiles_y = (H + th - 1) / th;
                g.nq = tq; g.nxc = nxc; g.hpitch = hpitch; g.tpitch = tpitch;
                g.inv_c = 1.0f / static_cast<float>(C);
            }
        }
    }
    return found;
}

// Fills the tiling of `g` for a row-segment kernel whose block needs, beside
// the halo, `extra_per_col` floats per column.  Returns the bytes of dynamic
// shared memory, or 0 when not even a one-column tile fits a block.
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

// The whole decision, from the geometry and `aligned` (C % 4 == 0 and every
// map on a 16-byte boundary) alone.  False for a geometry no kernel takes.
bool make_plan(bool backward, int gradients, int B, int H, int W, int C, int max_disp,
               int stride, bool aligned, Plan& p, TGeom& tg, Geom& g) {
    if (B <= 0 || gradients < 1 || gradients > 2 || !make_geom(g, H, W, C, max_disp, stride))
        return false;
    const bool tiled_allowed = stride == 1 && aligned;
    if (tiled_allowed && plan_tiled(backward, gradients, B, H, W, C, g.R, p, tg)) return true;
    const size_t smem = plan_tiles(g, backward ? g.D : g.CP);
    if (smem == 0) {
        const size_t total = static_cast<size_t>(B) * H * W * (backward ? C : g.D);
        p = Plan{V_DIRECT, 0, 0, C, 1, 0, direct_blocks(total), MAX_THREADS};
        return true;
    }
    const size_t blocks = static_cast<size_t>(B) * H * g.nt;
    if (blocks > 0x7fffffffu) return false;
    p = Plan{aligned ? V_ROWSEG_VEC4 : V_ROWSEG_SCALAR, 1, g.TW, C, 1,
             static_cast<int>(smem), static_cast<int>(blocks),
             threads_for(g.TW * (backward ? g.C4 : g.D))};
    return true;
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

template <int STAGES>
cudaError_t launch_fwd_tiled(const float* f1, const float* f2, float* out, const TGeom& g,
                             const Plan& p, int device, cudaStream_t st) {
    static std::atomic<bool> opted_in[MAX_DEVICES];
    cudaError_t err = allow_large_smem(corr_fwd_tiled_kernel<STAGES>, opted_in, device, p.smem);
    if (err != cudaSuccess) return err;
    corr_fwd_tiled_kernel<STAGES><<<p.blocks, p.threads, p.smem, st>>>(f1, f2, out, g);
    return cudaGetLastError();
}

template <int STAGES, int N>
cudaError_t launch_bwd_tiled(const float* gout, const float* f1, const float* f2, float* gf1,
                             float* gf2, int mode, const TGeom& g, const Plan& p, int device,
                             cudaStream_t st) {
    static std::atomic<bool> opted_in[MAX_DEVICES];
    cudaError_t err = allow_large_smem(corr_bwd_tiled_kernel<STAGES, N>, opted_in, device,
                                       p.smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.blocks, mode == 2 ? 2 : 1);
    corr_bwd_tiled_kernel<STAGES, N><<<grid, p.threads, p.smem, st>>>(
        gout, f1, f2, gf1, gf2, mode, g);
    return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_fwd(const float* f1, const float* f2, float* out, const Geom& g,
                       const Plan& p, int device, cudaStream_t st) {
    static std::atomic<bool> opted_in[MAX_DEVICES];
    cudaError_t err = allow_large_smem(corr_fwd_kernel<VEC>, opted_in, device, p.smem);
    if (err != cudaSuccess) return err;
    corr_fwd_kernel<VEC><<<p.blocks, p.threads, p.smem, st>>>(f1, f2, out, g);
    return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_bwd(const float* gout, const float* f1, const float* f2, float* gf1,
                       float* gf2, int mode, const Geom& g, const Plan& p, int device,
                       cudaStream_t st) {
    static std::atomic<bool> opted_in[MAX_DEVICES];
    cudaError_t err = allow_large_smem(corr_bwd_kernel<VEC>, opted_in, device, p.smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.blocks, mode == 2 ? 2 : 1);
    corr_bwd_kernel<VEC><<<grid, p.threads, p.smem, st>>>(gout, f1, f2, gf1, gf2, mode, g);
    return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Which kernel maps of this geometry take, and with which tile: the Variant
// code, or -1 for a geometry no kernel takes.  `backward` != 0 asks for the
// backward kernel's plan; `aligned` != 0 says that C % 4 == 0 and every map
// lies on a 16-byte boundary; `gradients` is the number of gradients one
// backward launch computes (1 or 2; the forward ignores it).  `plan`, where
// not null, receives the 8 ints of `Plan`.  Needs no device.
extern "C" int avt_correlation_variant(int backward, int gradients, int B, int H, int W,
                                       int C, int max_disp, int stride, int aligned,
                                       int* plan) {
    Plan p;
    TGeom tg;
    Geom g;
    if (!make_plan(backward != 0, gradients, B, H, W, C, max_disp, stride,
                   aligned != 0 && C % 4 == 0, p, tg, g))
        return -1;
    if (plan) {
        const int fields[8] = {p.variant, p.TH, p.TW, p.CK, p.stages, p.smem, p.blocks,
                               p.threads};
        for (int i = 0; i < 8; ++i) plan[i] = fields[i];
    }
    return p.variant;
}

// Both launch on `stream` of `device`, do not synchronise and allocate
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
    const bool aligned = C % 4 == 0 && aligned16(f1) && aligned16(f2);
    Plan p;
    TGeom tg;
    Geom g;
    if (!make_plan(false, 1, B, H, W, C, max_disp, stride, aligned, p, tg, g))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (p.variant) {
        case V_TILED:
            err = p.stages == 1 ? launch_fwd_tiled<1>(f1, f2, out, tg, p, device, st)
                                : launch_fwd_tiled<2>(f1, f2, out, tg, p, device, st);
            break;
        case V_ROWSEG_VEC4: err = launch_fwd<true>(f1, f2, out, g, p, device, st); break;
        case V_ROWSEG_SCALAR: err = launch_fwd<false>(f1, f2, out, g, p, device, st); break;
        default:
            corr_fwd_direct_kernel<<<p.blocks, p.threads, 0, st>>>(
                f1, f2, out, g, static_cast<size_t>(B) * H * W * g.D);
            err = cudaGetLastError();
    }
    return static_cast<int>(err);
}

// One launch for the gradients asked for: `gf1` (needs `f2`) and / or `gf2`
// (needs `f1`); a gradient that is not wanted is a null pointer, and so may
// the map be that only it would read.  gout: (B, H, W, D); the rest
// (B, H, W, C).
extern "C" int avt_correlation_backward(const float* gout, const float* f1, const float* f2,
                                        float* gf1, float* gf2, int B, int H, int W, int C,
                                        int max_disp, int stride, int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (B <= 0) return 0;
    if ((!gf1 && !gf2) || (gf1 && !f2) || (gf2 && !f1))
        return static_cast<int>(cudaErrorInvalidValue);
    const int mode = gf1 && gf2 ? 2 : gf2 ? 1 : 0;
    const bool aligned = C % 4 == 0
        && (!gf1 || (aligned16(gf1) && aligned16(f2)))
        && (!gf2 || (aligned16(gf2) && aligned16(f1)));
    Plan p;
    TGeom tg;
    Geom g;
    if (!make_plan(true, mode == 2 ? 2 : 1, B, H, W, C, max_disp, stride, aligned, p, tg, g))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (p.variant) {
        case V_TILED:
            if (p.stages == 1)
                err = tg.n == 9
                    ? launch_bwd_tiled<1, 9>(gout, f1, f2, gf1, gf2, mode, tg, p, device, st)
                    : launch_bwd_tiled<1, 0>(gout, f1, f2, gf1, gf2, mode, tg, p, device, st);
            else
                err = tg.n == 9
                    ? launch_bwd_tiled<2, 9>(gout, f1, f2, gf1, gf2, mode, tg, p, device, st)
                    : launch_bwd_tiled<2, 0>(gout, f1, f2, gf1, gf2, mode, tg, p, device, st);
            break;
        case V_ROWSEG_VEC4:
            err = launch_bwd<true>(gout, f1, f2, gf1, gf2, mode, g, p, device, st);
            break;
        case V_ROWSEG_SCALAR:
            err = launch_bwd<false>(gout, f1, f2, gf1, gf2, mode, g, p, device, st);
            break;
        default: {
            const dim3 grid(p.blocks, mode == 2 ? 2 : 1);
            corr_bwd_direct_kernel<<<grid, p.threads, 0, st>>>(
                gout, f1, f2, gf1, gf2, mode, g, static_cast<size_t>(B) * H * W * C);
            err = cudaGetLastError();
        }
    }
    return static_cast<int>(err);
}
