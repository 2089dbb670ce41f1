// The time-domain gammatone bank of erb.py::gammatone_iir_spectrogram, one
// launch a call, for Hopper (sm_90a): gammatone_kernel.
//
// Replaces no Pallas kernel: the JAX package's erb.py runs the bank as
// jax.lax.scan under XLA. The port's plain version, erb.py::_gammatone_impl
// (the scan lowering, which CPU tensors and inputs that require grad take),
// steps through a frame's samples with ~36 torch ops a sample, each one
// launch over a (clips, bands, frames) float64 tensor: at the cochleagram
// cell's batch (32 x 160000 samples, 64 bands, frame 320, hop 160) that is
// 11,531 launches and ~16 MB through device memory an op for arithmetic that
// fits in a thread's registers.
//
// What it computes, for every (clip, band, frame) at once, as the scan does:
// the frame's samples cast to float64 and times the Hann window (an (N - 1)
// denominator, erb.py::_device_tables), then per sample the four DF2T
// sections in the scan's order, from zero state,
//   y = a0 s + z0,   z0' = (a1 s + z1) - b1 y,   z1' = -b2 y,   s = y,
// the shared denominator [1, b1, b2] and the numerators [a0, a1] of the
// band's section (erb.py::_iir_bank_cached), and acc += y4^2; then
// sqrt(acc / frame_size), the dB 10 log10(max(., eps)) with
// eps = 10^(db_floor / 10) when asked, and the cast to the output type.
// The multiply-adds are fused (fma): everything stays float64, with one
// rounding fewer per multiply-add than the scan's separate products and
// sums, so the kernel is held to the scan at 1e-9 relative, not bit for bit.
//
// What bounds it: the FP64 pipe. A filtered sample is 17 FP64 instructions
// (4 a section, 1 for the sum); at the cell's batch 654,704,640 filtered
// samples are 11.1 G instructions, 0.664 ms at the H100 SXM's 16.75 T FP64
// FMA instructions/s (33.5 TFLOP/s), against 28.7 MB of input and output,
// 8.6 us at 3.35 TB/s. Bit-equal __dmul_rn/__dadd_rn would take 29 a sample.
// The design spends the FP64 pipe on the recurrence alone:
// - one thread a (clip, band, frame): its 8 states, its band's 10
//   coefficients and its sum live in registers, and nothing intermediate is
//   written to memory; a thread's chain is serial (two dependent FMAs a
//   sample a section), so the FMA latency is hidden by many warps, not by
//   one thread: ~15 k threads an SM at the cell's batch;
// - a warp is 32 bands of one frame, so every lane reads the same staged
//   sample (a shared-memory broadcast) and the window product is paid once a
//   frame, not once a band; lanes past n_bands run the last band's filter
//   and store nothing;
// - a block is one clip's tile of `tile` consecutive frames times `groups`
//   warps of bands (tile x groups <= 8 warps); it stages its frames' windowed
//   samples in shared memory as float64, at most kChunk samples of each at a
//   time (32 KB at most), read straight from the caller's float32 or float64
//   tensor; grid.y covers the bands past 8 x 32.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;     // warps a block at most
constexpr int kChunk = 512;   // samples of each frame a block stages at a time

template <typename In, typename Out>
__global__ void __launch_bounds__(kWarp * kWarps, 2)
gammatone_kernel(const In* __restrict__ x, const double* __restrict__ window,
                 const double* __restrict__ a, const double* __restrict__ b,
                 Out* __restrict__ out, long long n, int frame_size, int hop, int n_frames,
                 int n_bands, int tile, int groups, int tiles, int db, double eps) {
  extern __shared__ double staged[];  // tile x chunk windowed samples
  const int chunk = min(frame_size, kChunk);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long clip = blockIdx.x / tiles;
  const int f0 = static_cast<int>(blockIdx.x % tiles) * tile;
  const int slot = warp / groups;  // the warp's frame in the tile
  const int frame = f0 + slot;
  const int band = (static_cast<int>(blockIdx.y) * groups + warp % groups) * kWarp + lane;
  const int coef = min(band, n_bands - 1);

  double a0[4], a1[4], z0[4], z1[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a0[s] = a[(coef * 4 + s) * 2];
    a1[s] = a[(coef * 4 + s) * 2 + 1];
    z0[s] = 0.0;
    z1[s] = 0.0;
  }
  const double nb1 = -b[coef * 2];
  const double nb2 = -b[coef * 2 + 1];
  double acc = 0.0;

  const In* xc = x + clip * n;
  const double* mine = staged + slot * chunk;
  for (int c0 = 0; c0 < frame_size; c0 += chunk) {
    const int len = min(chunk, frame_size - c0);
    for (int i = threadIdx.x; i < tile * len; i += blockDim.x) {
      const int fi = i / len;
      const int j = i - fi * len;
      const int f = f0 + fi;
      staged[fi * chunk + j] =
          f < n_frames ? static_cast<double>(xc[static_cast<long long>(f) * hop + c0 + j]) *
                             window[c0 + j]
                       : 0.0;
    }
    __syncthreads();
    // 8 deep: on an H100 at the cell's batch 0.870 ms, against 0.895 at 4 and 1.000 at 2
#pragma unroll 8
    for (int j = 0; j < len; ++j) {
      double v = mine[j];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const double y = fma(a0[s], v, z0[s]);
        z0[s] = fma(nb1, y, fma(a1[s], v, z1[s]));
        z1[s] = nb2 * y;
        v = y;
      }
      acc = fma(v, v, acc);
    }
    __syncthreads();
  }
  if (band < n_bands && frame < n_frames) {
    double r = sqrt(acc / static_cast<double>(frame_size));
    if (db) r = 10.0 * log10(r < eps ? eps : r);  // NaN stays NaN, as torch.clamp_min
    out[(clip * n_bands + band) * n_frames + frame] = static_cast<Out>(r);
  }
}

template <typename In, typename Out>
int launch(const void* x, const void* window, const void* a, const void* b, void* out,
           long long rows, long long n, int frame_size, int hop, int n_frames, int n_bands,
           int db, double eps, cudaStream_t stream) {
  const int band_groups = (n_bands + kWarp - 1) / kWarp;
  const int groups = min(band_groups, kWarps);
  const int tile = kWarps / groups;
  const int tiles = (n_frames + tile - 1) / tile;
  const long long blocks = rows * tiles;
  const int band_blocks = (band_groups + groups - 1) / groups;
  if (blocks > INT_MAX || band_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile) * min(frame_size, kChunk) * sizeof(double);
  gammatone_kernel<In, Out><<<dim3(static_cast<unsigned>(blocks), band_blocks),
                              kWarp * groups * tile, smem, stream>>>(
      static_cast<const In*>(x), static_cast<const double*>(window),
      static_cast<const double*>(a), static_cast<const double*>(b), static_cast<Out*>(out), n,
      frame_size, hop, n_frames, n_bands, tile, groups, tiles, db, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, n) float32 or float64; window (frame_size,), a (n_bands, 4, 2) and
// b (n_bands, 2) float64; out (rows, n_bands, n_frames) float32 or float64,
// all contiguous. Dtype codes: 0 float32, 1 float64 (erb.py::_KERNEL_DTYPES).
// db: 0 the RMS, 1 its dB with the floor eps. Launches on `stream` of the
// current device; returns a cudaError_t.
extern "C" int gammatone_launch(const void* x, const void* window, const void* a,
                                const void* b, void* out, long long rows, long long n,
                                int frame_size, int hop, int n_frames, int n_bands,
                                int in_dtype, int out_dtype, int db, double eps,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows < 0 || frame_size < 1 || hop < 1 || n_frames < 1 || n_bands < 1 ||
      n < frame_size + static_cast<long long>(n_frames - 1) * hop)
    return static_cast<int>(cudaErrorInvalidValue);
  if (in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      return launch<float, float>(x, window, a, b, out, rows, n, frame_size, hop, n_frames,
                                  n_bands, db, eps, s);
    case 1:
      return launch<float, double>(x, window, a, b, out, rows, n, frame_size, hop, n_frames,
                                   n_bands, db, eps, s);
    case 2:
      return launch<double, float>(x, window, a, b, out, rows, n, frame_size, hop, n_frames,
                                   n_bands, db, eps, s);
    case 3:
      return launch<double, double>(x, window, a, b, out, rows, n, frame_size, hop, n_frames,
                                    n_bands, db, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gammatone_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
