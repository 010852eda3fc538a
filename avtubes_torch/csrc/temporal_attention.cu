// TimeSformer's temporal attention, softmax(q k^T / 8) v over sequences of at
// most 16 tokens with heads of 64, forward and backward, bf16, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no TimeSformer.  It was added
// because PyTorch ran the 16-frame attention of TimeSformer-B/16 as its
// memory-efficient SDPA kernels (sm80 CUTLASS code with 64-row tiles, of which
// a 16-token sequence fills a quarter): 6.3 ms forward and 13.7 backward in a
// training step of 20 clips of 16 frames at 224^2, 4.8 times the bytes' floor.
//
// q, k, v and o are (S, L, D) bf16, contiguous, D = H * 64: token-major, as
// the three products before the attention give them and as the product after
// it takes them, so nothing is transposed on either side.  One (sequence,
// head) is an "item": a (L, 64) block of each tensor, L rows of 128 bytes, a
// row every D * 2 bytes.  At the recipe (S = 20 * 196 = 3,920, L = 16, H = 12)
// a tensor is 96.3 MB and the step's 12 blocks move 4.6 GB forward (q, k, v
// read, o and the float32 log-sum-exp written) and 9.3 GB backward by the
// usual count (q, k, v, o, dO, lse read; dq, dk, dv written): 13.9 GB, 4.15 ms
// at 3.35 TB/s.  The products are 4 L^2 64 FLOPs an item, 0.16 TFLOP a step,
// so bytes bound both kernels.  What the design does about that:
//
//   * One warp owns one item, from the load to the store: a 16-token sequence
//     is one m16 tile, so q k^T, the softmax and p v are one warp's
//     `mma.sync.m16n8k16` (bf16 in, float32 accumulate) and registers, with
//     no reduction across warps, no atomics and no second pass.  Two runs
//     give the same bits.
//   * Each warp streams its items through a ring of STAGES slots in shared
//     memory by 16-byte `cp.async` (a 4-byte one for each lse value), the
//     next STAGES - 1 items in flight while it computes one: 144 KB an SM in
//     flight forward, 128 KB backward, enough for the card's bandwidth at
//     the latency it has under load.  The grid is one block an SM, each
//     warp walking items warp-count apart, so a block's warps read the heads
//     of one sequence side by side (at H = 12 forward: one 24 KB block of
//     each tensor).  Rows past L are zero-filled and their keys masked.
//   * A slot's tile is swizzled (16-byte chunk c of row r at c ^ (r & 7)),
//     so `ldmatrix` reads 8 rows of one column without bank conflicts, plain
//     for the A operand and n-major B, transposed for k-major B.
//   * Results go back through the slot of an operand already in registers
//     and leave as 16-byte stores, a whole 128-byte row per 8 lanes.
//
// Forward: scores s = q k^T in float32; x = s / 8 in base 2, keys >= L at
// -inf; the row max m and l = sum exp2(x - m) by quad shuffles; p = exp2(x -
// m) rounded to bf16 for p v (as the memory-efficient kernel rounds it), o =
// (p v) / l rounded once; lse = (m + log2 l) ln 2 per row, float32, (S, H, L).
//
// Backward, one launch: p = exp(s / 8 - lse) recomputed in float32;
// dp = dO v^T; the row term D = rowsum(p * dp), which is rowsum(dO * o) of the
// exact output and needs neither o nor a pass of its own, so the kernel reads
// 8 KB an item where the usual count has 10; ds = p (dp - D) / 8;
// dv = p^T dO, dk = ds^T q, dq = ds k, with p and ds rounded once to bf16 and
// passed through a 1 KB square of shared memory for their transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int DH = 64;                   // a head's width
constexpr int LMAX = 16;                 // the longest sequence: one m16 tile
constexpr int ROW_BYTES = DH * 2;        // one token of one head
constexpr int TILE = LMAX * ROW_BYTES;   // one item's (16, 64) block of a tensor: 2 KB
constexpr int TILE_CHUNKS = TILE / 16;   // its 16-byte chunks, 4 a lane
constexpr float SCALE = 0.125f;          // 1 / sqrt(64), exact
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// forward: a slot holds q, k, v; 12 warps x 3 slots x 6 KB = 216 KB
constexpr int FWD_WARPS = 12, FWD_STAGES = 3;
constexpr int FWD_SLOT = 3 * TILE;
constexpr int FWD_SMEM = FWD_WARPS * FWD_STAGES * FWD_SLOT;
// backward: a slot holds q, k, v, dO and the 16 lse values; a warp's square
// holds p and ds (16 x 16 bf16 each); 8 warps x (3 x 8,256 + 1,024) bytes
constexpr int BWD_WARPS = 8, BWD_STAGES = 3;
constexpr int BWD_SLOT = 4 * TILE + LMAX * 4;
constexpr int SQUARE = LMAX * LMAX * 2;
constexpr int BWD_WARP_SMEM = BWD_STAGES * BWD_SLOT + 2 * SQUARE;
constexpr int BWD_SMEM = BWD_WARPS * BWD_WARP_SMEM;
static_assert(FWD_SMEM <= 232448 && BWD_SMEM <= 232448, "one block an SM");
static_assert(BWD_SLOT % 16 == 0, "slots stay 16-byte aligned");

constexpr int MAX_DEVICES = 64;

// byte offset of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
    return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// byte offset of chunk c (0 or 1) of row r in a 16 x 16 square (32-byte rows)
__device__ __forceinline__ uint32_t sq(int r, int c) {
    return r * 32 + ((c ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(__cvta_generic_to_global(src)), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a b for one m16n8k16 tile: a in an A fragment, b0 b1 in a B fragment
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                   uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
    asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
    uint4 v;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows r < len of one item's block of a tensor (`src` at its first element,
// rows `ld` elements apart) -> the swizzled tile at `dst`; rows len..15 are
// filled with zeros.
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int len, int ld,
                                          int lane) {
#pragma unroll
    for (int i = 0; i < TILE_CHUNKS / 32; ++i) {
        const int idx = i * 32 + lane, r = idx >> 3, c = idx & 7;
        const bool ok = r < len;
        cp_async16(dst + swz(r, c), src + (ok ? r * ld + c * 8 : 0), ok);
    }
}

// The tile at `src`, rows r < len, -> one item's block of a tensor.
__device__ __forceinline__ void store_tile(bf16* dst, uint32_t src, int len, int ld, int lane) {
#pragma unroll
    for (int i = 0; i < TILE_CHUNKS / 32; ++i) {
        const int idx = i * 32 + lane, r = idx >> 3, c = idx & 7;
        if (r < len) *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = lds128(src + swz(r, c));
    }
}

// the lane's row address for `ldmatrix` of an A operand over k-step x (columns
// 16x .. 16x + 15) or, transposed, of a k-major B operand over the n-tiles 2x
// and 2x + 1
__device__ __forceinline__ uint32_t at_a(uint32_t tile, int lane, int x) {
    return tile + swz((lane & 7) + ((lane >> 3) & 1) * 8, 2 * x + (lane >> 4));
}

// ... of an n-major B operand (rows are the 16 n, columns the k) over k-step x
__device__ __forceinline__ uint32_t at_b(uint32_t tile, int lane, int x) {
    return tile + swz((lane & 7) + (lane >> 4) * 8, 2 * x + ((lane >> 3) & 1));
}

// s = a b^T over 64 columns, a and b (16, 64) tiles: s[nt][i] is row
// g (i < 2) or g + 8 (i >= 2), column 8 nt + 2 t + (i & 1)
__device__ __forceinline__ void scores(uint32_t a_tile, uint32_t b_tile, int lane,
                                       float (&s)[2][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
        uint32_t a[4], b[4];
        ldsm(at_a(a_tile, lane, x), a);
        ldsm(at_b(b_tile, lane, x), b);
        mma(s[0], a, b[0], b[1]);
        mma(s[1], a, b[2], b[3]);
    }
}

// a (16, 16) matrix in the layout of `scores`, rounded to bf16, as an A fragment
__device__ __forceinline__ void as_a(const float (&p)[2][4], uint32_t (&a)[4]) {
    a[0] = pack(p[0][0], p[0][1]);
    a[1] = pack(p[0][2], p[0][3]);
    a[2] = pack(p[1][0], p[1][1]);
    a[3] = pack(p[1][2], p[1][3]);
}

// acc = a (an A fragment, 16 x 16) times the (16, 64) tile at `b_tile`;
// acc[n] is n-tile n (columns 8n .. 8n + 7) in the layout of `scores`
__device__ __forceinline__ void times_tile(const uint32_t (&a)[4], uint32_t b_tile, int lane,
                                           float (&acc)[8][4]) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
        uint32_t b[4];
        ldsm_t(at_a(b_tile, lane, x), b);
        mma(acc[2 * x], a, b[0], b[1]);
        mma(acc[2 * x + 1], a, b[2], b[3]);
    }
}

// acc, row g times f0 and row g + 8 times f1, rounded to bf16 -> the tile
__device__ __forceinline__ void put_tile(uint32_t tile, int lane, const float (&acc)[8][4],
                                         float f0, float f1) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        sts32(tile + swz(g, n) + 4 * t, pack(acc[n][0] * f0, acc[n][1] * f0));
        sts32(tile + swz(g + 8, n) + 4 * t, pack(acc[n][2] * f1, acc[n][3] * f1));
    }
}

// an A fragment -> the 16 x 16 square at `square`
__device__ __forceinline__ void put_square(uint32_t square, int lane, const uint32_t (&a)[4]) {
    const int g = lane >> 2, t = lane & 3;
    sts32(square + sq(g, 0) + 4 * t, a[0]);
    sts32(square + sq(g + 8, 0) + 4 * t, a[1]);
    sts32(square + sq(g, 1) + 4 * t, a[2]);
    sts32(square + sq(g + 8, 1) + 4 * t, a[3]);
}

// the transpose of the square at `square` as an A fragment
__device__ __forceinline__ void square_t(uint32_t square, int lane, uint32_t (&a)[4]) {
    const int r = (lane & 7) + (lane >> 4) * 8;
    ldsm_t(square + sq(r, (lane >> 3) & 1), a);
}

// first element of an item's block: sequence item / heads, head item % heads
__device__ __forceinline__ long long item_offset(int item, int len, int heads) {
    return static_cast<long long>(item / heads) * len * heads * DH + (item % heads) * DH;
}

__global__ void __launch_bounds__(FWD_WARPS * 32, 1)
ta_forward_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                  int items, int len, int heads) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int ld = heads * DH;
    const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
                          warp * FWD_STAGES * FWD_SLOT;
    const int first = blockIdx.x * FWD_WARPS + warp, stride = gridDim.x * FWD_WARPS;

    auto load = [&](int item, int slot) {
        const long long off = item_offset(item, len, heads);
        const uint32_t at = ring + slot * FWD_SLOT;
        load_tile(at, q + off, len, ld, lane);
        load_tile(at + TILE, k + off, len, ld, lane);
        load_tile(at + 2 * TILE, v + off, len, ld, lane);
    };
#pragma unroll
    for (int i = 0; i < FWD_STAGES - 1; ++i) {
        if (first + i * stride < items) load(first + i * stride, i);
        cp_async_commit();
    }
    int slot = 0;
    for (int item = first; item < items; item += stride) {
        const int ahead = item + (FWD_STAGES - 1) * stride;
        if (ahead < items) load(ahead, (slot + FWD_STAGES - 1) % FWD_STAGES);
        cp_async_commit();
        cp_async_wait<FWD_STAGES - 1>();   // this item's group has landed
        __syncwarp();
        const uint32_t qt = ring + slot * FWD_SLOT, kt = qt + TILE, vt = kt + TILE;

        float s[2][4];
        scores(qt, kt, lane, s);
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int key = 8 * nt + 2 * t + (i & 1);
                const float x = key < len ? s[nt][i] * (SCALE * LOG2E) : -INFINITY;
                s[nt][i] = x;
                if (i < 2) m0 = fmaxf(m0, x);
                else m1 = fmaxf(m1, x);
            }
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p = exp2f(s[nt][i] - (i < 2 ? m0 : m1));
                s[nt][i] = p;
                if (i < 2) l0 += p;
                else l1 += p;
            }
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        uint32_t pa[4];
        as_a(s, pa);
        float acc[8][4];
        times_tile(pa, vt, lane, acc);
        __syncwarp();
        put_tile(qt, lane, acc, 1.f / l0, 1.f / l1);   // q is read: its tile takes o
        if (t == 0) {
            float* out = lse + static_cast<long long>(item) * len;
            if (g < len) out[g] = (m0 + log2f(l0)) * LN2;
            if (g + 8 < len) out[g + 8] = (m1 + log2f(l1)) * LN2;
        }
        __syncwarp();
        store_tile(o + item_offset(item, len, heads), qt, len, ld, lane);
        __syncwarp();                      // the slot is free for the next load
        slot = (slot + 1) % FWD_STAGES;
    }
    cp_async_wait<0>();
}

__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
ta_backward_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, bf16* __restrict__ dq, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int items, int len, int heads) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int ld = heads * DH;
    const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
                          warp * BWD_WARP_SMEM;
    const uint32_t p_square = ring + BWD_STAGES * BWD_SLOT, ds_square = p_square + SQUARE;
    const int first = blockIdx.x * BWD_WARPS + warp, stride = gridDim.x * BWD_WARPS;

    auto load = [&](int item, int slot) {
        const long long off = item_offset(item, len, heads);
        const uint32_t at = ring + slot * BWD_SLOT;
        load_tile(at, q + off, len, ld, lane);
        load_tile(at + TILE, k + off, len, ld, lane);
        load_tile(at + 2 * TILE, v + off, len, ld, lane);
        load_tile(at + 3 * TILE, dout + off, len, ld, lane);
        if (lane < LMAX)
            cp_async4(at + 4 * TILE + 4 * lane,
                      lse + static_cast<long long>(item) * len + (lane < len ? lane : 0),
                      lane < len);
    };
#pragma unroll
    for (int i = 0; i < BWD_STAGES - 1; ++i) {
        if (first + i * stride < items) load(first + i * stride, i);
        cp_async_commit();
    }
    int slot = 0;
    for (int item = first; item < items; item += stride) {
        const int ahead = item + (BWD_STAGES - 1) * stride;
        if (ahead < items) load(ahead, (slot + BWD_STAGES - 1) % BWD_STAGES);
        cp_async_commit();
        cp_async_wait<BWD_STAGES - 1>();
        __syncwarp();
        const uint32_t qt = ring + slot * BWD_SLOT, kt = qt + TILE, vt = kt + TILE,
                       dot = vt + TILE, lt = dot + TILE;

        // p, recomputed; rows past len have none
        float p[2][4];
        scores(qt, kt, lane, p);
        const float lse0 = g < len ? lds_f32(lt + 4 * g) * LOG2E : INFINITY;
        const float lse1 = g + 8 < len ? lds_f32(lt + 4 * (g + 8)) * LOG2E : INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int key = 8 * nt + 2 * t + (i & 1);
                p[nt][i] = key < len
                    ? exp2f(p[nt][i] * (SCALE * LOG2E) - (i < 2 ? lse0 : lse1)) : 0.f;
            }
        // dp = dO v^T, the row term, ds = p (dp - D) / 8
        float ds[2][4];
        scores(dot, vt, lane, ds);
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            d0 += p[nt][0] * ds[nt][0] + p[nt][1] * ds[nt][1];
            d1 += p[nt][2] * ds[nt][2] + p[nt][3] * ds[nt][3];
        }
        d0 = quad_sum(d0);
        d1 = quad_sum(d1);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ds[nt][i] = p[nt][i] * (ds[nt][i] - (i < 2 ? d0 : d1)) * SCALE;
        uint32_t pa[4], dsa[4], pt[4], dst[4];
        as_a(p, pa);
        as_a(ds, dsa);
        put_square(p_square, lane, pa);
        put_square(ds_square, lane, dsa);
        __syncwarp();
        square_t(p_square, lane, pt);
        square_t(ds_square, lane, dst);

        float acc[8][4];
        times_tile(pt, dot, lane, acc);    // dv = p^T dO, over dO's tile
        __syncwarp();
        put_tile(dot, lane, acc, 1.f, 1.f);
        times_tile(dst, qt, lane, acc);    // dk = ds^T q, over q's
        __syncwarp();
        put_tile(qt, lane, acc, 1.f, 1.f);
        times_tile(dsa, kt, lane, acc);    // dq = ds k, over k's
        __syncwarp();
        put_tile(kt, lane, acc, 1.f, 1.f);
        __syncwarp();
        const long long off = item_offset(item, len, heads);
        store_tile(dq + off, kt, len, ld, lane);
        store_tile(dk + off, qt, len, ld, lane);
        store_tile(dv + off, dot, len, ld, lane);
        __syncwarp();
        slot = (slot + 1) % BWD_STAGES;
    }
    cp_async_wait<0>();
}

inline cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

// Above 48 KB dynamic shared memory is opt-in: once per kernel and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<bool>* opted_in, int device, int bytes) {
    const bool remember = device >= 0 && device < MAX_DEVICES;
    if (remember && opted_in[device].load()) return cudaSuccess;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && remember) opted_in[device].store(true);
    return err;
}

inline bool shape_taken(long long seqs, int len, int heads, int sms) {
    return seqs >= 0 && len >= 1 && len <= LMAX && heads >= 1 && sms >= 1 &&
           seqs * heads <= INT_MAX;
}

inline int grid_for(long long items, int warps, int sms) {
    const long long blocks = (items + warps - 1) / warps;
    return static_cast<int>(blocks < sms ? blocks : sms);
}

}  // namespace

// Each function launches one kernel on `stream` of `device`, does not
// synchronise and allocates nothing; it returns the launch's cudaError_t (0 =
// success) for the caller to raise on.  q, k, v, o, dout, dq, dk and dv are
// (seqs, len, heads * 64) bf16, contiguous and 16-byte aligned, 1 <= len <=
// 16; lse is (seqs, heads, len) float32.  `sms` is the device's SM count: the
// grid is one block an SM, fewer where there are fewer items.

extern "C" int avt_ta_forward(const void* q, const void* k, const void* v, void* o, void* lse,
                              long long seqs, int len, int heads, int sms, int device,
                              void* stream) {
    static std::atomic<bool> opted_in[MAX_DEVICES];
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!shape_taken(seqs, len, heads, sms)) return static_cast<int>(cudaErrorInvalidValue);
    const long long items = seqs * heads;
    if (items == 0) return 0;
    err = allow_smem(ta_forward_kernel, opted_in, device, FWD_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ta_forward_kernel<<<grid_for(items, FWD_WARPS, sms), FWD_WARPS * 32, FWD_SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), static_cast<int>(items), len, heads);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int avt_ta_backward(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, void* dq, void* dk, void* dv, long long seqs,
                               int len, int heads, int sms, int device, void* stream) {
    static std::atomic<bool> opted_in[MAX_DEVICES];
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!shape_taken(seqs, len, heads, sms)) return static_cast<int>(cudaErrorInvalidValue);
    const long long items = seqs * heads;
    if (items == 0) return 0;
    err = allow_smem(ta_backward_kernel, opted_in, device, BWD_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ta_backward_kernel<<<grid_for(items, BWD_WARPS, sms), BWD_WARPS * 32, BWD_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<int>(items), len, heads);
    return static_cast<int>(cudaGetLastError());
}
