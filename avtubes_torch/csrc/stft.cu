// Fused log-spectrogram for Hopper (sm_90a): waveform in, (B, F, T) log-PSD out.
//
// Replaces the TPU kernel `_stft_kernel` (avtubes/ops/stft.py, launched by
// `_log_spectrogram_pallas`).  It computes what that kernel computes — per
// frame: constant detrend, window-folded real DFT against (nperseg, F) cos/sin
// matrices in IEEE float32, (re^2 + im^2) * scale, log(p + offset) / std,
// stored transposed as (B, F, T) — but it is not that kernel carried over:
//
//   * Framing happens HERE.  The TPU version needs a framed (B, T, nperseg)
//     array built outside the kernel because its vector loads must be
//     aligned; a CUDA block computes its own offsets and reads
//     x[b, t*hop + n] straight from the (B, num_samples) waveform, so no
//     framed copy is ever written.
//   * int16 PCM is read directly and scaled by 1/32768 on load (the inverse
//     of the host's int16 quantization), so the int16 transport costs no
//     conversion pass.
//
// Work split: one block = one clip x TM frames x TN frequency bins, 256
// threads, each thread a 4x4 micro-tile of (frame, bin) pairs with separate
// re/im accumulators.  Pass 1: one warp per frame sums the frame (coalesced)
// and keeps the TM means in shared memory — the mean must be known before any
// product is used.  Pass 2: chunks of KC samples of the detrended frames and
// of the cos/sin tiles go through shared memory; products are fp32 FMAs on
// the CUDA cores (no TF32, no bf16: reduced input precision costs ~1e-2 in
// the log-spectrogram).  The epilogue writes out[b, f, t] with t fastest
// across threads, masking the ragged edges; any nperseg, hop, T and F work.
//
// Bound on this card: the FUNCTION is bound by bytes (one read of the
// waveform, one write of the spectrogram; a real FFT per frame is a few
// FLOPs per byte).  THIS kernel is not: it takes the dense DFT, 4*B*T*nperseg*F
// fp32 FLOPs on the CUDA cores, some 170 FLOPs per byte at 512/257, so it is
// bound by operations the function does not need and stands far from the
// function's bound.  It is the simple version that is right; an FFT inside
// the kernel (radix-2/4 stages through shared memory, one frame per warp) is
// the follow-up that can approach the byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // frames per block
constexpr int TN = 64;        // frequency bins per block
constexpr int KC = 32;        // samples per shared-memory chunk
constexpr int NTHREADS = 256; // 16 (frames) x 16 (bins) threads, 4x4 each

__device__ __forceinline__ float load_sample(const float* p) { return *p; }
__device__ __forceinline__ float load_sample(const int16_t* p) {
    return static_cast<float>(*p) * (1.0f / 32768.0f);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
log_spectrogram_kernel(const T* __restrict__ x,
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

// Launches on `stream` of `device`, does not synchronise, allocates nothing.
// `x` is (batch, num_samples) float32, or int16 PCM when x_is_int16 != 0;
// cosm/sinm are (nperseg, num_freqs) and scale is (num_freqs,), float32;
// out is (batch, num_freqs, num_frames) float32.  Returns the cudaError_t of
// the launch (0 = success) for the caller to raise on.
extern "C" int avt_log_spectrogram(const void* x, int x_is_int16,
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
        log_spectrogram_kernel<int16_t><<<grid, block, 0, st>>>(
            static_cast<const int16_t*>(x), cosm, sinm, scale, out, num_samples,
            nperseg, hop, num_frames, num_freqs, log_offset, normalize_std);
    } else {
        log_spectrogram_kernel<float><<<grid, block, 0, st>>>(
            static_cast<const float*>(x), cosm, sinm, scale, out, num_samples,
            nperseg, hop, num_frames, num_freqs, log_offset, normalize_std);
    }
    return static_cast<int>(cudaGetLastError());
}
