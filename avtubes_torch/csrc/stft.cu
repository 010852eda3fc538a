// Fused log-spectrogram for Hopper (sm_90a): waveform in, (B, F, T) log-PSD out.
//
// Replaces the TPU kernel `_stft_kernel` (avtubes/ops/stft.py, launched by
// `_log_spectrogram_pallas`).  It computes what that kernel computes — per
// frame: constant detrend, windowed real DFT in IEEE float32, (re^2 + im^2) *
// scale, log(p + offset) / std, stored transposed as (B, F, T) — but it is not
// that kernel carried over:
//
//   * Framing happens HERE.  The TPU version needs a framed (B, T, nperseg)
//     array built outside the kernel because its vector loads must be
//     aligned; a CUDA warp computes its own offsets and reads
//     x[b, t*hop + n] straight from the (B, num_samples) waveform, so no
//     framed copy is ever written.
//   * int16 PCM is read directly and scaled by 1/32768 on load (the inverse
//     of the host's int16 quantization), so the int16 transport costs no
//     conversion pass.
//   * The transform is an FFT, not a product against cos/sin matrices.
//
// Bound on this card: the FUNCTION is bound by bytes (one read of the
// waveform, one write of the spectrogram; a real FFT per frame is a few FLOPs
// per byte), and at a serving batch the bytes take a few microseconds, so
// launch count, latency and the transposed store decide the time.  Two kernels:
//
// `log_spectrogram_fft_kernel<T, N, TILE>` — nperseg N in {256, 512, 1024}.
//   One warp owns one frame; a block owns TILE consecutive frames of one clip.
//   The N real samples are packed as M = N/2 complex values z[n] = x[2n] +
//   i x[2n+1]; lane l keeps z[l + 32 j], j < E = M/32, in registers (hop 511
//   leaves frames 4-byte aligned only, hence scalar loads).  The frame's sum
//   is a warp-shuffle reduction; the mean comes off BEFORE the window is
//   multiplied in.  The M-point FFT is radix-2 decimation in frequency: the
//   first log2(E) stages act on a lane's own registers (constant twiddles),
//   then one twiddle W_M^(l*k1), then five stages across the lanes by
//   `__shfl_xor_sync` — no shared memory and no barrier inside the transform.
//   Bin k = E*k2 + k1 is left at register bitrev(k1) of lane bitrev(k2); the
//   real-FFT split step X[k] = E[k] + W_N^k O[k] reads its partner Z[M-k]
//   from lane ~l (one shuffle) with that order folded into its indexing, so
//   no reordering pass exists.  Twiddles and window are tables made on the
//   host in float64 and rounded once, laid out in the order the lanes read
//   them (a lane's bins are E apart in bit-reversed order: read straight from
//   natural-order tables, those scattered loads cost a fifth of the kernel);
//   the arithmetic is fp32 FMAs (no fast math, no TF32).  A warp holding one frame would store 257 values 431
//   floats apart, so the block stages its (M+1) x TILE results in shared
//   memory (XOR-swizzled columns: a warp's bins are E rows apart, which a
//   padded row would fold onto four banks) and then writes runs of TILE
//   floats along t.  The last tile of a clip is masked.
//
// `log_spectrogram_dense_kernel<T>` — every other nperseg (and any hop, T, F).
//   The dense real DFT: one block = one clip x 64 frames x 64 bins, 256
//   threads with 4x4 micro-tiles, the window folded into (nperseg, F) cos/sin
//   matrices.  It is bound by operations the function does not need
//   (4*B*T*nperseg*F fp32 FLOPs on the CUDA cores).
//
// Which one runs is decided by the caller on nperseg alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float load_sample(const float* p) { return *p; }
__device__ __forceinline__ float load_sample(const int16_t* p) {
    return static_cast<float>(*p) * (1.0f / 32768.0f);
}

// ------------------------------------------------------------- FFT kernel

__host__ __device__ constexpr int log2_of(int v) { return v <= 1 ? 0 : 1 + log2_of(v >> 1); }

__host__ __device__ constexpr int bit_reverse(int v, int bits) {
    int out = 0;
    for (int b = 0; b < bits; ++b) out |= ((v >> b) & 1) << (bits - 1 - b);
    return out;
}

// A loop whose index is a compile-time constant in the body, so that every
// register-array index, twiddle and branch below is resolved by the compiler
// (a `#pragma unroll` loop left the arrays and tables in local memory).
template <int V> struct Int { static constexpr int value = V; };
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    if constexpr (I < N) {
        f(Int<I>{});
        static_for<I + 1, N>(f);
    }
}

// W_16^q = cos(2 pi q / 16) - i sin(2 pi q / 16), q < 8, rounded from float64
__host__ __device__ constexpr float cos16(int q) {
    return q == 0 ? 1.0f : q == 1 ? 0.92387953251128674f : q == 2 ? 0.70710678118654752f
         : q == 3 ? 0.38268343236508977f : q == 4 ? 0.0f : q == 5 ? -0.38268343236508977f
         : q == 6 ? -0.70710678118654752f : -0.92387953251128674f;
}
__host__ __device__ constexpr float sin16(int q) {
    return q == 0 ? 0.0f : q == 1 ? 0.38268343236508977f : q == 2 ? 0.70710678118654752f
         : q == 3 ? 0.92387953251128674f : q == 4 ? 1.0f : q == 5 ? 0.92387953251128674f
         : q == 6 ? 0.70710678118654752f : 0.38268343236508977f;
}

// E-point radix-2 decimation in frequency on a thread's own registers,
// E <= 16.  Result k is left at index bit_reverse(k).
template <int E>
__device__ __forceinline__ void fft_registers(float (&re)[E], float (&im)[E]) {
    static_assert(E >= 1 && E <= 16 && (E & (E - 1)) == 0, "E is 1, 2, 4, 8 or 16");
    static_for<0, log2_of(E)>([&](auto stage) {
        constexpr int size = E >> decltype(stage)::value;
        constexpr int half = size / 2;
        static_for<0, E / 2>([&](auto butterfly) {
            constexpr int i = decltype(butterfly)::value;
            constexpr int j = i % half;
            constexpr int a = (i / half) * size + j, b = a + half;
            constexpr int q = j * (16 / size);          // W_size^j = W_16^q
            const float dr = re[a] - re[b], di = im[a] - im[b];
            re[a] += re[b];
            im[a] += im[b];
            if constexpr (q == 0) {                     // 1
                re[b] = dr;
                im[b] = di;
            } else if constexpr (q == 4) {              // -i
                re[b] = di;
                im[b] = -dr;
            } else {                                    // (dr + i di)(c - i s)
                constexpr float c = cos16(q), s = sin16(q);
                re[b] = dr * c + di * s;
                im[b] = di * c - dr * s;
            }
        });
    });
}

template <typename T, int N, int TILE>
__global__ void __launch_bounds__(32 * TILE)
log_spectrogram_fft_kernel(const T* __restrict__ x,
                           const float* __restrict__ table,
                           float* __restrict__ out,
                           int num_samples, int hop, int num_frames,
                           float log_offset, float inv_std) {
    constexpr int M = N / 2;        // complex points
    constexpr int E = M / 32;       // complex values a lane keeps
    constexpr int EBITS = log2_of(E);
    constexpr int F = M + 1;        // bins 0..M
    constexpr int NT = 32 * TILE;
    static_assert(TILE == 16 || TILE == 32, "the column swizzle needs TILE <= 32");
    __shared__ float stage[F * TILE];   // [bin][frame ^ swizzle(bin)]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int t0 = blockIdx.x * TILE;
    // A warp is one frame.  A warp past the clip's last frame computes that
    // last frame again and its column is never stored: no branch around the
    // shuffles, which the compiler could not prove warp-uniform.
    const int t = min(t0 + warp, num_frames - 1);
    // `table` holds every constant in the order the lanes read it: rows of 32
    // floats, one per lane, so each read is one coalesced 128-byte load
    // (`fft_kernel_table` of ops/stft.py; rows by register r unless noted).
    constexpr int WIN_RE = 0, WIN_IM = E;               // window[64 r + 2 lane (+ 1)]
    constexpr int INTER_C = 2 * E, INTER_S = 3 * E;     // W_M^(lane * bit_reverse(r))
    constexpr int STAGE_C = 4 * E, STAGE_S = 4 * E + 4; // by lane stage s < 4: W_(2h)^(lane mod h)
                                                        // on the upper lanes, 1 on the lower
    constexpr int SPLIT_C = 4 * E + 8, SPLIT_S = 5 * E + 8;  // W_N^k, k = E bitrev5(lane) + bit_reverse(r)
    constexpr int SCALE = 6 * E + 8;                    // scale[k] / 4
    constexpr int NYQUIST = 7 * E + 8;                  // scale[M] / 4 in every lane
    const float* lane_table = table + lane;

    const T* fp = x + static_cast<size_t>(blockIdx.y) * num_samples
                    + static_cast<size_t>(t) * hop;
    float re[E], im[E];
    float sum = 0.0f;
    static_for<0, E>([&](auto j) {
        constexpr int n = 64 * decltype(j)::value;
        re[decltype(j)::value] = load_sample(fp + n + 2 * lane);
        im[decltype(j)::value] = load_sample(fp + n + 2 * lane + 1);
        sum += re[decltype(j)::value] + im[decltype(j)::value];
    });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, off);
    const float mean = sum * (1.0f / N);
    static_for<0, E>([&](auto j) {      // detrend, THEN the window
        constexpr int r = decltype(j)::value;
        re[r] = (re[r] - mean) * __ldg(lane_table + 32 * (WIN_RE + r));
        im[r] = (im[r] - mean) * __ldg(lane_table + 32 * (WIN_IM + r));
    });

    // stages on the register index n1 (z[lane + 32 n1]): E-point DFTs
    fft_registers<E>(re, im);
    // register r now holds k1 = bit_reverse(r): twiddle W_M^(lane * k1)
    static_for<1, E>([&](auto r_) {
        constexpr int r = decltype(r_)::value;
        const float c = __ldg(lane_table + 32 * (INTER_C + r));
        const float s = __ldg(lane_table + 32 * (INTER_S + r));
        const float vr = re[r], vi = im[r];
        re[r] = vr * c + vi * s;
        im[r] = vi * c - vr * s;
    });
    // five stages across the lanes: 32-point DFTs, one per register.  The
    // lower lane of a pair keeps a + b, the upper (a - b) * W_(2h)^j with
    // j = lane mod h (the table has 1 for the lower lanes).  The last
    // stage's twiddle is 1.
    static_for<0, 5>([&](auto s_) {
        constexpr int s = decltype(s_)::value;
        constexpr int h = 16 >> s;
        const bool upper = (lane & h) != 0;
        const float sign = upper ? -1.0f : 1.0f;
        float c = 1.0f, sn = 0.0f;
        if constexpr (s < 4) {
            c = __ldg(lane_table + 32 * (STAGE_C + s));
            sn = __ldg(lane_table + 32 * (STAGE_S + s));
        }
        static_for<0, E>([&](auto r_) {
            constexpr int r = decltype(r_)::value;
            // lower: own + other; upper: other - own
            const float vr = __shfl_xor_sync(FULL_MASK, re[r], h) + sign * re[r];
            const float vi = __shfl_xor_sync(FULL_MASK, im[r], h) + sign * im[r];
            if constexpr (s < 4) {
                re[r] = vr * c + vi * sn;
                im[r] = vi * c - vr * sn;
            } else {
                re[r] = vr;
                im[r] = vi;
            }
        });
    });

    // Register r of this lane holds Z[k], k = E*k2 + k1, k2 = bitrev5(lane),
    // k1 = bit_reverse(r).  Split step: with P = conj(Z[(M - k) mod M]),
    // 2 X[k] = (Z + P) + W_N^k (Z - P) / i.  For k1 != 0 the partner is
    // register bit_reverse(E - k1) of lane ~lane; for k1 == 0 it is register 0
    // of the lane that holds k2' = -k2 mod 32.  The factor 2 is taken out of
    // the scale (1/4 of the power: exact).
    const int k2 = static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27);
    const int src0 = static_cast<int>(__brev(static_cast<unsigned>((32 - k2) & 31)) >> 27);
    const int column = warp ^ (k2 & (TILE - 1));
    static_for<0, E>([&](auto r_) {
        constexpr int r = decltype(r_)::value;
        constexpr int k1 = bit_reverse(r, EBITS);
        const int k = E * k2 + k1;
        float pr, pi;
        if constexpr (k1 == 0) {
            pr = __shfl_sync(FULL_MASK, re[0], src0);
            pi = __shfl_sync(FULL_MASK, im[0], src0);
        } else {
            constexpr int rp = bit_reverse(E - k1, EBITS);
            pr = __shfl_xor_sync(FULL_MASK, re[rp], 31);
            pi = __shfl_xor_sync(FULL_MASK, im[rp], 31);
        }
        const float even_r = re[r] + pr, even_i = im[r] - pi;
        const float odd_r = im[r] + pi, odd_i = pr - re[r];
        const float c = __ldg(lane_table + 32 * (SPLIT_C + r));
        const float s = __ldg(lane_table + 32 * (SPLIT_S + r));
        const float xr = even_r + (odd_r * c + odd_i * s);
        const float xi = even_i + (odd_i * c - odd_r * s);
        const float power = (xr * xr + xi * xi) * __ldg(lane_table + 32 * (SCALE + r));
        stage[k * TILE + column] = logf(power + log_offset) * inv_std;
    });
    if (lane == 0) {    // k2 == 0: Z[0]; the Nyquist bin is real
        const float nyquist = 2.0f * (re[0] - im[0]);
        const float power = (nyquist * nyquist) * __ldg(lane_table + 32 * NYQUIST);
        stage[M * TILE + warp] = logf(power + log_offset) * inv_std;
    }
    __syncthreads();

    // out[b, k, t0 + f]: runs of TILE floats along t, the last tile masked
    float* ob = out + static_cast<size_t>(blockIdx.y) * F * num_frames;
    for (int idx = tid; idx < F * TILE; idx += NT) {
        const int f = idx & (TILE - 1);
        const int k = idx / TILE;
        if (t0 + f < num_frames)
            ob[static_cast<size_t>(k) * num_frames + t0 + f] =
                stage[k * TILE + (f ^ ((k / E) & (TILE - 1)))];
    }
}

template <typename T, int N, int TILE>
cudaError_t launch_fft(const void* x, const float* table, float* out, int batch,
                       int num_samples,
                       int hop, int num_frames, float log_offset,
                       float normalize_std, cudaStream_t stream) {
    const dim3 grid((num_frames + TILE - 1) / TILE, batch);
    // log(.) * (1/std), as the TPU kernel has it: within an ulp of the division
    log_spectrogram_fft_kernel<T, N, TILE><<<grid, 32 * TILE, 0, stream>>>(
        static_cast<const T*>(x), table, out, num_samples, hop,
        num_frames, log_offset, 1.0f / normalize_std);
    return cudaGetLastError();
}

// ----------------------------------------------------------- dense kernel

constexpr int TM = 64;        // frames per block
constexpr int TN = 64;        // frequency bins per block
constexpr int KC = 32;        // samples per shared-memory chunk
constexpr int NTHREADS = 256; // 16 (frames) x 16 (bins) threads, 4x4 each

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
log_spectrogram_dense_kernel(const T* __restrict__ x,
                             const float* __restrict__ cosm,
                             const float* __restrict__ sinm,
                             const float* __restrict__ scale,
                             float* __restrict__ out,
                             int num_samples, int nperseg, int hop,
                             int num_frames, int num_freqs,
                             float log_offset, float normalize_std) {
    __shared__ float mean_s[TM];
    __shared__ float a_s[KC][TM + 1];  // +1: conflict-free transposed stores
    __shared__ __align__(16) float c_s[KC][TN];
    __shared__ __align__(16) float s_s[KC][TN];

    const int tid = threadIdx.x;
    const int t0 = blockIdx.x * TM;
    const int f0 = blockIdx.y * TN;
    const T* xb = x + static_cast<size_t>(blockIdx.z) * num_samples;

    // pass 1: per-frame mean over the whole frame, one warp per frame
    {
        const int warp = tid >> 5, lane = tid & 31;
        for (int tt = warp; tt < TM; tt += NTHREADS / 32) {
            const int t = t0 + tt;
            float sum = 0.0f;
            if (t < num_frames) {
                const T* fp = xb + static_cast<size_t>(t) * hop;
                for (int n = lane; n < nperseg; n += 32) sum += load_sample(fp + n);
            }
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0) mean_s[tt] = sum / static_cast<float>(nperseg);
        }
    }
    __syncthreads();

    const int tx = tid & 15;   // frames tx, tx+16, tx+32, tx+48
    const int ty = tid >> 4;   // bins ty*4 .. ty*4+3

    float re[4][4], im[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) { re[i][j] = 0.0f; im[i][j] = 0.0f; }

    for (int k0 = 0; k0 < nperseg; k0 += KC) {
        // detrended frame chunk, stored sample-major: a_s[kk][tt]
        {
            const int kk = tid & (KC - 1);
            const int k = k0 + kk;
#pragma unroll
            for (int r = 0; r < TM / (NTHREADS / KC); ++r) {
                const int tt = (tid / KC) + r * (NTHREADS / KC);
                const int t = t0 + tt;
                float v = 0.0f;
                if (t < num_frames && k < nperseg)
                    v = load_sample(xb + static_cast<size_t>(t) * hop + k) - mean_s[tt];
                a_s[kk][tt] = v;
            }
        }
        // cos / sin chunk: c_s[kk][ff] = cosm[k0+kk][f0+ff]
        {
            const int ff = tid & (TN - 1);
            const int f = f0 + ff;
#pragma unroll
            for (int r = 0; r < KC / (NTHREADS / TN); ++r) {
                const int kk = (tid / TN) + r * (NTHREADS / TN);
                const int k = k0 + kk;
                float c = 0.0f, s = 0.0f;
                if (f < num_freqs && k < nperseg) {
                    const size_t idx = static_cast<size_t>(k) * num_freqs + f;
                    c = cosm[idx];
                    s = sinm[idx];
                }
                c_s[kk][ff] = c;
                s_s[kk][ff] = s;
            }
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
            float a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = a_s[kk][tx + 16 * i];
            const float4 c4 = *reinterpret_cast<const float4*>(&c_s[kk][ty * 4]);
            const float4 s4 = *reinterpret_cast<const float4*>(&s_s[kk][ty * 4]);
            const float c[4] = {c4.x, c4.y, c4.z, c4.w};
            const float s[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    re[i][j] = fmaf(a[i], c[j], re[i][j]);
                    im[i][j] = fmaf(a[i], s[j], im[i][j]);
                }
        }
        __syncthreads();
    }

    // epilogue: PSD scale, log, normalise; out[b, f, t], t fastest over tx
    float* ob = out + static_cast<size_t>(blockIdx.z) * num_freqs * num_frames;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int f = f0 + ty * 4 + j;
        if (f >= num_freqs) continue;
        const float sc = scale[f];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int t = t0 + tx + 16 * i;
            if (t >= num_frames) continue;
            const float power = (re[i][j] * re[i][j] + im[i][j] * im[i][j]) * sc;
            ob[static_cast<size_t>(f) * num_frames + t] =
                logf(power + log_offset) / normalize_std;
        }
    }
}

// The calling thread's current device becomes `device`; the runtime call is
// made only when it is another one.
inline cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess || current == device) return err;
    return cudaSetDevice(device);
}

}  // namespace

// Both entry points launch on `stream` of `device`, do not synchronise and
// allocate nothing.  `x` is (batch, num_samples) float32, or int16 PCM when
// x_is_int16 != 0; out is (batch, nperseg/2 + 1, num_frames) float32.  They
// return the cudaError_t of the launch (0 = success) for the caller to raise on.

// The FFT kernel.  table is `fft_kernel_table` of ops/stft.py: (7 E + 9, 32)
// float32 with E = nperseg / 64.  nperseg and frames_per_block must be a pair
// that is instantiated below (cudaErrorInvalidValue otherwise).
extern "C" int avt_log_spectrogram_fft(const void* x, int x_is_int16,
                                       const float* table, float* out,
                                       int batch, int num_samples, int nperseg,
                                       int hop, int num_frames, int frames_per_block,
                                       float log_offset, float normalize_std,
                                       int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || num_frames <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AVT_FFT_CASE(N, TILE)                                                     \
    if (nperseg == N && frames_per_block == TILE)                                 \
        return static_cast<int>(x_is_int16                                        \
            ? launch_fft<int16_t, N, TILE>(x, table, out, batch, num_samples, hop, \
                                           num_frames, log_offset, normalize_std, \
                                           st)                                    \
            : launch_fft<float, N, TILE>(x, table, out, batch, num_samples, hop,   \
                                         num_frames, log_offset, normalize_std,   \
                                         st));
    AVT_FFT_CASE(512, 32)
    AVT_FFT_CASE(512, 16)
    AVT_FFT_CASE(256, 32)
    AVT_FFT_CASE(1024, 16)
#undef AVT_FFT_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

// The dense kernel, any geometry.  cosm/sinm are (nperseg, num_freqs) with
// the window folded in, scale is (num_freqs,).
extern "C" int avt_log_spectrogram_dense(const void* x, int x_is_int16,
                                         const float* cosm, const float* sinm,
                                         const float* scale, float* out,
                                         int batch, int num_samples, int nperseg,
                                         int hop, int num_frames, int num_freqs,
                                         float log_offset, float normalize_std,
                                         int device, void* stream) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (batch <= 0 || num_frames <= 0 || num_freqs <= 0) return 0;
    const dim3 grid((num_frames + TM - 1) / TM, (num_freqs + TN - 1) / TN, batch);
    const dim3 block(NTHREADS);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_is_int16) {
        log_spectrogram_dense_kernel<int16_t><<<grid, block, 0, st>>>(
            static_cast<const int16_t*>(x), cosm, sinm, scale, out, num_samples,
            nperseg, hop, num_frames, num_freqs, log_offset, normalize_std);
    } else {
        log_spectrogram_dense_kernel<float><<<grid, block, 0, st>>>(
            static_cast<const float*>(x), cosm, sinm, scale, out, num_samples,
            nperseg, hop, num_frames, num_freqs, log_offset, normalize_std);
    }
    return static_cast<int>(cudaGetLastError());
}
