// Fused feature kernel for Hopper (sm_90a): signal in, features out, in f32.
//
// Replaces spectrograms_tpu/ops/pallas_factored.py::_kernel, the JAX
// package's only Pallas kernel (its pl.pallas_call is in
// fused_factored_features), at the bf16x3 tier (precision=HIGH). It computes
// the same function:
//
//   frames of the (virtually centre-padded) signal -> window -> real DFT
//   -> |X|^2 (-> sqrt when pre_amp) -> filterbank -> power | magnitude |
//   dB with a floor (-> DCT)  ->  out[b, row, frame]
//
// and keeps what the TPU kernel keeps out of device memory: no frame,
// spectrum or power leaves the SM. All arithmetic is IEEE f32 on the SIMT
// units (more precise than the tier it serves); twiddles come from a host
// table built in f64. Build without --use_fast_math: __log10f would move the
// dB values.
//
// What bounds it. At the flagship shape (32 x 160000 samples, 1024/256,
// mel-128 dB, DCT-40) it must read 20.5 MB and write 3.2 MB (7.2 us at
// 3.35 TB/s) and do ~0.81 GFLOP counting the DFT as a real FFT (12.1 us at
// the 67 TFLOP/s f32 rate): operations bound. The first design (a complex
// radix-2 FFT of the real frame in shared memory, a barrier per stage, a
// global twiddle load per butterfly, each frame reading its samples from
// global memory, one thread per filterbank row) spent its time on
// shared-memory traffic, barriers and idle threads, not on the flops.
//
// This design, per block of tile_f consecutive frames of one signal:
// 1. Stage the span the frames cover, (tile_f-1)*hop + n_fft samples, once:
//    16-byte cp.async chunks from an address aligned down (the span's shift
//    sh in 0..3 is carried in the index), samples outside the row (centre
//    padding, the row's ends) zero-filled.
// 2. A real FFT at half the work: the M = n_fft/2-point complex FFT of
//    z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1], then one split pass.
// 3. The complex FFT is a Stockham autosort FFT in registers: M/8 threads a
//    frame, each holding 8 points. One radix-2/4 pass where log2 M is not a
//    multiple of 3, then radix-8 passes (3 passes at n_fft 1024, 4 at
//    4096), each exchanging through shared memory (8-byte complex values,
//    padded by one in 16 against bank conflicts), two barriers a pass. No
//    bit-reversal. Twiddles come from the host table, laid out so that
//    neighbouring threads read neighbouring entries, read through L1: the
//    table (6 KB at 1024, 24 KB at 4096) stays there across the SM's
//    blocks, where staging it in shared memory cost every block the copy
//    (on chroma more bytes than its signal) and shared memory.
// 4. Power of bins 0..M, then the filterbank by nonzeros: each row's band is
//    cut on the host into pieces of at most 8 bins with their weights
//    packed (longer pieces for a dense mapping such as ERB), every (frame,
//    piece) is one thread's work, and each row sums its pieces' partial
//    sums in a fixed order (deterministic). Mel-128 is 189 pieces, chroma's
//    12 rows x 385 bins 588.
// 5. Amplitude, then the DCT, one (frame, coefficient) per thread, each in
//    four interleaved FMA chains.
// Shared memory is reused across steps (the span becomes the power rows and
// then the DCT input; the FFT buffer becomes the partial sums).
//
// What measurement chose (H100 80GB HBM3, 700 W): occupancy decides more
// than instruction counts. Threads are capped at 40 registers (3 blocks of
// 512 threads, or 6 of 256, an SM; uncapped the compiler takes 48-64 and
// the flagship runs about 10 % slower), and the tile aims at 256-thread
// blocks (4 frames at 1024; 2 at 4096, where one frame a block would stage
// five times its own samples). Measured slower and not used: forms that
// cut instructions but ran on fewer threads (a piece's weights held across
// the tile's frames, 189 threads busy; the DCT by two frames and four
// coefficients, 40 threads), the DCT by row quarters added with shuffles,
// and per-frame named barriers between the radix passes.
//
// Next step: about half the time is the tail (filterbank, dB, DCT), whose
// phases leave warps waiting at the block's barriers. A persistent block
// with specialised warps (one group running the FFT of the next tile while
// another runs this tile's tail) would overlap them. On chroma the radix
// passes themselves come first (4 passes over 2048 points a frame).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
// Blocks of kMaxThreads an SM should hold: caps the registers a thread at
// 65536 / (blocks * 512) in steps of 8. Three (40 registers, 1536 threads
// an SM) measured fastest; uncapped, the compiler takes 48-64.
#ifndef FUSED_MIN_BLOCKS
#define FUSED_MIN_BLOCKS 3
#endif
constexpr float kHalfSqrt2 = 0.70710678118654752440f;

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v >> 1); }

// Radix of the first pass: 2 or 4 where log2 M is not a multiple of 3.
__host__ __device__ constexpr int first_radix(int m) {
  return ilog2(m) % 3 == 0 ? 8 : (1 << (ilog2(m) % 3));
}

// Offset in the twiddle table of the pass that starts at size ns (> 1);
// tw_offset(m, m) is the offset of the split twiddles.
__host__ __device__ constexpr int tw_offset(int m, int ns) {
  int at = 0;
  for (int s = first_radix(m); s < ns; s *= 8) at += 7 * s;
  return at;
}

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }  // -i a

// Index in a frame's complex array, one value of padding in 16: a
// half-warp's 8-byte accesses then fall on distinct bank pairs for the
// unit-stride reads and the first pass's stride-8 writes.
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// Forward R-point DFTs in registers, natural order in and out.
template <int R> struct Dft;
template <> struct Dft<2> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 a = v[0];
    v[0] = add(a, v[1]);
    v[1] = sub(a, v[1]);
  }
};
template <> struct Dft<4> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 t0 = add(v[0], v[2]), t1 = sub(v[0], v[2]);
    const float2 t2 = add(v[1], v[3]), t3 = mul_mi(sub(v[1], v[3]));
    v[0] = add(t0, t2);
    v[2] = sub(t0, t2);
    v[1] = add(t1, t3);
    v[3] = sub(t1, t3);
  }
};
template <> struct Dft<8> {
  static __device__ __forceinline__ void run(float2* v) {
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    Dft<4>::run(e);
    Dft<4>::run(o);
    o[1] = make_float2(kHalfSqrt2 * (o[1].x + o[1].y), kHalfSqrt2 * (o[1].y - o[1].x));
    o[2] = mul_mi(o[2]);
    o[3] = make_float2(kHalfSqrt2 * (o[3].y - o[3].x), -kHalfSqrt2 * (o[3].x + o[3].y));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = add(e[k], o[k]);
      v[k + 4] = sub(e[k], o[k]);
    }
  }
};

// One Stockham pass at size NS and the passes after it. On entry v[s] holds
// point t + s*M/8 of the pass's input. Item j = t + q*M/8 (q < 8/R) reads
// j + r*M/R (slot q + r*8/R), is scaled by W_{NS*R}^{k*r} (k = j mod NS),
// transformed, and written to (j - k)*R + k + r*NS.
template <int M, int NS>
__device__ __forceinline__ void fft_passes(float2 (&v)[8], float2* z,
                                           const float2* tw, int t) {
  constexpr int R = NS == 1 ? first_radix(M) : 8;
  constexpr int Q = 8 / R;
  constexpr int T = M / 8;
  if constexpr (NS > 1) {
    const float2* twp = tw + tw_offset(M, NS);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = (t + q * T) & (NS - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[q + r * Q] = mul(v[q + r * Q], twp[(r - 1) * NS + k]);
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[q + r * Q];
    Dft<R>::run(u);
#pragma unroll
    for (int r = 0; r < R; ++r) v[q + r * Q] = u[r];
  }
  if constexpr (NS > 1) __syncthreads();  // every read of this pass's input is done
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * T;
    const int k = j & (NS - 1);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      z[padded((j - k) * R + k + r * NS)] = v[q + r * Q];
    }
  }
  __syncthreads();
  if constexpr (NS * R < M) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      v[s] = z[padded(t + s * T)];
    }
    fft_passes<M, NS * R>(v, z, tw, t);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ float apply_amp(float v, int amp, float eps) {
  if (amp == 1) return sqrtf(v);
  if (amp == 2) return 10.0f * log10f(fmaxf(v, eps));
  return v;
}

template <int LOG2M>
__global__ void __launch_bounds__(kMaxThreads, FUSED_MIN_BLOCKS)
fused_features_kernel(const float* __restrict__ x,
                      const float* __restrict__ window,
                      const float2* __restrict__ twiddle,
                      const int4* __restrict__ items,
                      const int* __restrict__ first,
                      const float* __restrict__ weights,
                      const float* __restrict__ dct,
                      float* __restrict__ out,
                      long long n, int hop, int pad, int n_frames, int n_items,
                      int n_out, int n_coef, int amp, int pre_amp, float eps,
                      int tile_f, int buf_off) {
  constexpr int M = 1 << LOG2M;
  constexpr int N = 2 * M;
  constexpr int T = M / 8;           // threads a frame
  constexpr int BS = M + M / 16;     // padded length of a frame's complex array
  constexpr int PS = M + 1;          // power row stride (odd: no bank conflicts)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* span = smem;                // region 1: span -> power rows -> DCT input
  float* buf = smem + buf_off;       // region 2: FFT buffer -> partial sums
  const float2* tw = twiddle;  // read through L1, where it stays across blocks

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int f = tid / T;
  const int t = tid % T;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * tile_f;
  const int tile_shift = __ffs(tile_f) - 1;  // tile_f is a power of two
  const float* row = x + static_cast<long long>(b) * n;

  // 1. Stage the tile's span.
  const long long s0 = static_cast<long long>(f0) * hop - pad;
  const int sh = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(row) >> 2) + static_cast<uintptr_t>(s0)) & 3);
  const int n_chunks = (sh + (tile_f - 1) * hop + N + 3) >> 2;
  for (int c = tid; c < n_chunks; c += nthr) {
    const long long s = s0 - sh + 4LL * c;
    float* dst = span + 4 * c;
    if (s >= 0 && s + 4 <= n) {
      cp_async16(dst, row + s);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long u = s + q;
        dst[q] = (u >= 0 && u < n) ? __ldg(row + u) : 0.0f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 2-3. Windowed, even/odd-packed frame -> M-point complex FFT.
  float2* z = reinterpret_cast<float2*>(buf) + f * BS;
  {
    float2 v[8];
    const float* fs = span + sh + f * hop;
    const float2* w2 = reinterpret_cast<const float2*>(window);
    const bool even = ((sh + f * hop) & 1) == 0;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int m = t + s * T;
      const float2 w = __ldg(w2 + m);
      const float2 a = even ? reinterpret_cast<const float2*>(fs)[m]
                            : make_float2(fs[2 * m], fs[2 * m + 1]);
      v[s] = make_float2(a.x * w.x, a.y * w.y);
    }
#ifndef FUSED_SKIP_FFT
    fft_passes<M, 1>(v, z, tw, t);
#endif
  }

  // 4a. Split into bins 0..M and their power (magnitude when pre_amp).
  float* pw = span;
  {
    const float2* tws = tw + tw_offset(M, M);
    float* prow = pw + f * PS;
    for (int k = t; k <= M / 2; k += T) {
      const int kc = (M - k) & (M - 1);
      const float2 zk = z[padded(k)];
      const float2 zc = z[padded(kc)];
      const float2 xe = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
      const float2 xo = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
      const float2 tt = mul(tws[k], xo);
      const float lo_re = xe.x + tt.x, lo_im = xe.y + tt.y;
      const float hi_re = xe.x - tt.x, hi_im = xe.y - tt.y;
      const float p_lo = lo_re * lo_re + lo_im * lo_im;
      const float p_hi = hi_re * hi_re + hi_im * hi_im;
      prow[k] = pre_amp ? sqrtf(p_lo) : p_lo;
      if (k != M / 2) prow[M - k] = pre_amp ? sqrtf(p_hi) : p_hi;
    }
  }
#ifdef FUSED_SKIP_TAIL
  return;
#endif
  __syncthreads();

  // 4b. Filterbank pieces: every (frame, piece) is one thread's work,
  //     frames fastest, so that neighbouring threads share the piece's
  //     weights; partial[piece][frame].
  float* part = buf;
  for (int i = tid; i < tile_f * n_items; i += nthr) {
    const int fi = i & (tile_f - 1);
    const int4 d = __ldg(items + (i >> tile_shift));
    const float* p = pw + fi * PS + d.x;
    const float* w = weights + d.z;
    float acc = 0.0f;
    for (int q = 0; q < d.y; ++q) acc = fmaf(p[q], __ldg(w + q), acc);
    part[i] = acc;
  }
  __syncthreads();

  // 4c. Rows: each sums its pieces (four interleaved chains, added in a
  //     fixed order), then the amplitude scale.
  const bool with_dct = dct != nullptr;
  float* feat = span;
  const int feat_stride = n_out + 1;
  for (int i = tid; i < tile_f * n_out; i += nthr) {
    const int fi = i & (tile_f - 1);
    const int m = i >> tile_shift;
    const int e = __ldg(first + m + 1);
    float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int it = __ldg(first + m);
    for (; it + 4 <= e; it += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s4[j] += part[(it + j) * tile_f + fi];
    }
    for (; it < e; ++it) s4[0] += part[it * tile_f + fi];
    const float v = apply_amp((s4[0] + s4[1]) + (s4[2] + s4[3]), amp, eps);
    if (with_dct) {
      feat[fi * feat_stride + m] = v;
    } else if (f0 + fi < n_frames) {
      out[(static_cast<long long>(b) * n_out + m) * n_frames + f0 + fi] = v;
    }
  }
  if (!with_dct) return;  // uniform across the block
  __syncthreads();

#ifdef FUSED_SKIP_DCT
  return;
#endif
  // 5. DCT tail: one (frame, coefficient) per thread, frames fastest, in
  //    four FMA chains (rows m = j mod 4) so that the chain's latency is a
  //    quarter of n_out FMAs.
  for (int i = tid; i < tile_f * n_coef; i += nthr) {
    const int fi = i & (tile_f - 1);
    const int c = i >> tile_shift;
    if (f0 + fi >= n_frames) continue;
    const float* frow = feat + fi * feat_stride;
    float a4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int m = 0;
    for (; m + 4 <= n_out; m += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a4[j] = fmaf(frow[m + j], __ldg(dct + (m + j) * n_coef + c), a4[j]);
      }
    }
    for (; m < n_out; ++m) a4[0] = fmaf(frow[m], __ldg(dct + m * n_coef + c), a4[0]);
    out[(static_cast<long long>(b) * n_coef + c) * n_frames + f0 + fi] =
        (a4[0] + a4[1]) + (a4[2] + a4[3]);
  }
}

template <int LOG2M>
int launch(const float* x, const float* window, const void* twiddle, const void* items,
           const int* first, const float* weights, const float* dct, float* out, int batch,
           long long n, int hop, int pad, int n_frames, int n_items, int n_out, int n_coef,
           int amp, int pre_amp, float eps, int tile_f, int buf_off,
           int smem_bytes, cudaStream_t stream) {
  auto kernel = fused_features_kernel<LOG2M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + tile_f - 1) / tile_f, batch);
  const int threads = tile_f * ((1 << LOG2M) / 8);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      x, window, static_cast<const float2*>(twiddle), static_cast<const int4*>(items),
      first, weights, dct, out, n, hop, pad, n_frames, n_items, n_out, n_coef, amp,
      pre_amp, eps, tile_f, buf_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of the current device, which the
// caller sets to the tensors' device; allocates nothing and does not
// synchronise. The layout arguments (tile_f, buf_off, smem_bytes)
// come from spectrograms_tpu_torch/ops/f32_layout.py. Returns
// cudaGetLastError() after the launch, so a refused launch is reported.
extern "C" int fused_features_launch(
    const float* x, const float* window, const void* twiddle, const void* items,
    const int* first, const float* weights, const float* dct, float* out,
    int batch, long long n, int log2n, int hop, int pad, int n_frames,
    int n_items, int n_out, int n_coef, int amp, int pre_amp, float eps,
    int tile_f, int buf_off, int smem_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define FUSED_LAUNCH(L)                                                         \
  case L + 1:                                                                   \
    return launch<L>(x, window, twiddle, items, first, weights, dct, out, batch, \
                     n, hop, pad, n_frames, n_items, n_out, n_coef, amp,        \
                     pre_amp, eps, tile_f, buf_off, smem_bytes, s);
  switch (log2n) {
    FUSED_LAUNCH(7)
    FUSED_LAUNCH(8)
    FUSED_LAUNCH(9)
    FUSED_LAUNCH(10)
    FUSED_LAUNCH(11)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FUSED_LAUNCH
}

extern "C" const char* fused_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
