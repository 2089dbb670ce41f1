// Fused feature kernel for Hopper (sm_90a): signal in, features out.
//
// Replaces spectrograms_tpu/ops/pallas_factored.py::_kernel, the JAX
// package's only Pallas kernel (its pl.pallas_call is in
// fused_factored_features). It computes the same function:
//
//   frames of the (virtually centre-padded) signal -> window -> real DFT
//   -> |X|^2 (-> sqrt when pre_amp) -> filterbank -> power | magnitude |
//   dB with a floor (-> DCT)  ->  out[b, row, frame]
//
// and keeps what the TPU kernel keeps out of device memory: no frame
// matrix, spectrum or power ever leaves the SM. It is not the TPU kernel
// carried over block by block: the 128-lane chunk layout, the
// Hermitian-folded mapping and the bf16 hi/lo MXU passes exist for the TPU's
// matrix unit. Here each block runs a plain radix-2 FFT in shared memory,
// all arithmetic in f32 (at least as precise as every TPU tier). Build
// without --use_fast_math: __log10f would move the dB values.
//
// Layout. Grid (ceil(n_frames / tile_f), batch); one block takes tile_f
// consecutive frames of one signal. Dynamic shared memory holds
//   buf  [tile_f][n_fft]        complex f32 FFT work space
//   pw   [tile_f][n_bins]       |X|^2 (or |X|) of bins 0..n_fft/2
//   feat [tile_f][n_out + 1]    filterbank features (DCT only; +1 pads banks)
// (tile_f = 8 at n_fft = 1024: 85 KB, two blocks an SM).
// Per frame: load with the centre padding as an index test (no padded
// copy) times the window, stored bit-reversed -> log2(n_fft) radix-2 DIT
// stages, twiddles from a host table built in f64 -> power of bins
// 0..n_fft/2 -> filterbank as a loop over each output's nonzero band of
// the natural-order (n_bins, n_out) mapping (the skipped entries are exact
// zeros) -> amplitude -> DCT as a loop over the (n_out, n_coef) matrix ->
// written straight into the (batch, rows, n_frames) layout.
//
// Bound on the H100 at the flagship shape (32 x 160000 f32 samples,
// 1024/256, mel-128 dB, DCT-40 -> 32 x 40 x 626 f32): it must read 20.5 MB
// and write 3.2 MB, 7.1 us at 3.35 TB/s. Its arithmetic, counting the DFT
// as a real FFT (2.5 N log2 N flops), is about 40k flops per frame
// (FFT 25.6k, DCT 10.2k, window, power, the mel bands, dB) over 20032
// frames: ~0.8 GFLOP, ~12 us at the 67 TFLOP/s f32 rate outside the tensor
// cores. So it is bound by operations, not bytes. This first design keeps
// every operand in shared memory so that the bytes stay at the floor, and
// spends its time on f32 SIMT work: a complex FFT of real input (twice the
// real FFT's flops), shared-memory butterflies with a barrier per stage,
// and FMA loops for the mel and DCT products. A packed real FFT and
// tensor-core products (wgmma) for the DCT are the next steps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float apply_amp(float v, int amp, float eps) {
  if (amp == 1) return sqrtf(v);
  if (amp == 2) return 10.0f * log10f(fmaxf(v, eps));
  return v;
}

__global__ void __launch_bounds__(kThreads)
fused_features_kernel(const float* __restrict__ x,
                      const float* __restrict__ window,
                      const float2* __restrict__ twiddle,
                      const float* __restrict__ mapping,
                      const int* __restrict__ bands,
                      const float* __restrict__ dct,
                      float* __restrict__ out,
                      long long n, int log2n, int hop, int pad, int n_frames,
                      int n_bins, int n_out, int n_coef, int amp, int pre_amp,
                      float eps, int tile_f) {
  extern __shared__ float4 smem[];
  const int n_fft = 1 << log2n;
  const int half_n = n_fft >> 1;
  float2* buf = reinterpret_cast<float2*>(smem);
  float* pw = reinterpret_cast<float*>(buf + tile_f * n_fft);
  float* feat = pw + tile_f * n_bins;
  const int feat_stride = n_out + 1;

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * tile_f;
  const float* xb = x + static_cast<long long>(b) * n;

  // 1. Frames: windowed samples, bit-reversed, imaginary part zero.
  for (int i = threadIdx.x; i < tile_f * n_fft; i += kThreads) {
    const int f = i >> log2n;
    const int t = i & (n_fft - 1);
    const long long s = static_cast<long long>(f0 + f) * hop - pad + t;
    float v = 0.0f;
    if (f0 + f < n_frames && s >= 0 && s < n) {
      v = __ldg(xb + s) * __ldg(window + t);
    }
    const int r = static_cast<int>(__brev(static_cast<unsigned>(t)) >> (32 - log2n));
    buf[(f << log2n) + r] = make_float2(v, 0.0f);
  }
  __syncthreads();

  // 2. Radix-2 decimation-in-time stages; stage s joins pairs at distance 2^s.
  for (int s = 0; s < log2n; ++s) {
    const int half = 1 << s;
    const int tw_stride = half_n >> s;
    for (int j = threadIdx.x; j < tile_f * half_n; j += kThreads) {
      const int f = j >> (log2n - 1);
      const int q = j & (half_n - 1);
      const int pos = q & (half - 1);
      const int i0 = (f << log2n) + ((q >> s) << (s + 1)) + pos;
      const int i1 = i0 + half;
      const float2 w = __ldg(twiddle + pos * tw_stride);
      const float2 u = buf[i0];
      const float2 v = buf[i1];
      const float vr = v.x * w.x - v.y * w.y;
      const float vi = v.x * w.y + v.y * w.x;
      buf[i0] = make_float2(u.x + vr, u.y + vi);
      buf[i1] = make_float2(u.x - vr, u.y - vi);
    }
    __syncthreads();
  }

  // 3. Power of bins 0..n_fft/2 (magnitude first when pre_amp).
  for (int i = threadIdx.x; i < tile_f * n_bins; i += kThreads) {
    const int f = i / n_bins;
    const int k = i - f * n_bins;
    const float2 c = buf[(f << log2n) + k];
    const float p = c.x * c.x + c.y * c.y;
    pw[i] = pre_amp ? sqrtf(p) : p;
  }
  __syncthreads();

  // 4. Filterbank over each output's band, then the amplitude scale.
  //    Frames vary fastest across threads: a warp reads few mapping values.
  for (int i = threadIdx.x; i < tile_f * n_out; i += kThreads) {
    const int f = i % tile_f;
    const int m = i / tile_f;
    const int lo = __ldg(bands + 2 * m);
    const int hi = __ldg(bands + 2 * m + 1);
    const float* prow = pw + f * n_bins;
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) {
      acc = fmaf(prow[k], __ldg(mapping + static_cast<long long>(k) * n_out + m), acc);
    }
    const float v = apply_amp(acc, amp, eps);
    if (dct != nullptr) {
      feat[f * feat_stride + m] = v;
    } else if (f0 + f < n_frames) {
      out[(static_cast<long long>(b) * n_out + m) * n_frames + f0 + f] = v;
    }
  }
  if (dct == nullptr) return;  // uniform across the block
  __syncthreads();

  // 5. DCT tail.
  for (int i = threadIdx.x; i < tile_f * n_coef; i += kThreads) {
    const int f = i % tile_f;
    const int c = i / tile_f;
    if (f0 + f >= n_frames) continue;
    const float* frow = feat + f * feat_stride;
    float acc = 0.0f;
    for (int m = 0; m < n_out; ++m) {
      acc = fmaf(frow[m], __ldg(dct + m * n_coef + c), acc);
    }
    out[(static_cast<long long>(b) * n_coef + c) * n_frames + f0 + f] = acc;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of the current device, which the
// caller sets to the tensors' device; allocates nothing and does not
// synchronise. Returns cudaGetLastError() after the launch, so a refused
// launch is reported to the caller.
extern "C" int fused_features_launch(
    const float* x, const float* window, const void* twiddle,
    const float* mapping, const int* bands, const float* dct, float* out,
    int batch, long long n, int log2n, int hop, int pad, int n_frames,
    int n_bins, int n_out, int n_coef, int amp, int pre_amp, float eps,
    int tile_f, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_features_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + tile_f - 1) / tile_f, batch);
  fused_features_kernel<<<grid, kThreads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      x, window, static_cast<const float2*>(twiddle), mapping, bands, dct,
      out, n, log2n, hop, pad, n_frames, n_bins, n_out, n_coef, amp, pre_amp,
      eps, tile_f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
