// Fused feature kernel at the bf16 precision tiers, for Hopper (sm_90a).
//
// Replaces spectrograms_tpu/ops/pallas_factored.py::_kernel at its "bf16"
// (1-pass, precision=DEFAULT) and "bf16x2" (method="pallas:x2") tiers. It
// computes what the TPU kernel computes there, with the operands rounded
// to bf16 at the same points (the f32 kernel fused_features.cu serves the
// "bf16x3" tier, more precisely):
//
//   N = 128 r.  B[c, n1] = sum_n2 w x[n1 + 128 n2] W_N^(c (n1 + 128 n2))
//   (the inner r-point DFT and its twiddle, f32)  ->  X[c + r k1] =
//   sum_n1 B[c, n1] W_128^(n1 k1) on tensor cores, classes c = 0..r/2 only
//   (Hermitian fold)  ->  |X|^2 (-> sqrt when pre_amp)  ->  the host-folded
//   filterbank on tensor cores  ->  power | magnitude | dB  (->  DCT on
//   tensor cores)  ->  out[b, row, frame].
//
// The tensor-core products are mma.sync m16n8k16 bf16 x bf16 -> f32, one
// accumulator per pass, summed as the TPU kernel's dot3: (ah bh + ah bl) +
// al bh. Tiers: bf16 = 1 pass everywhere; bf16x2 = 2 passes (ah bh + ah bl)
// on the outer DFT and 3 on the filterbank and DCT. Hi/lo splits are
// round-to-nearest-even (__float2bfloat16_rn). The complex classes use the
// packed product [re | im] @ [[C, -S'], [S', C]] or the Gauss form
// T1 = (a + b) G1, T2 = b G2, T3 = a G3, re = T1 - T2, im = T1 + T3; the
// real classes 0 and r/2 carry their twiddle in their constant.
//
// Layout. Grid (ceil(n_frames / tile_f), batch); 256 threads; tile_f = 16
// or 32 frames (one or two of the mma's 16-row tiles), templated on r.
// Dynamic shared memory, bf16 rows padded by 8 elements so that fragment
// loads hit 32 distinct banks:
//   A    [group][tile_f][ka + 8]  A operands of a group of classes
//                                 (ka = 128 | 256 | 384)
//   P    [tile_f][classes*128+8]  |X|^2 of every class, hi (and lo at x2)
//   feat [tile_f][kd + 8]         filterbank output, hi (and lo), DCT only
// The host picks the tile to fit two blocks on an SM where it can, then
// groups as many classes as shared memory holds without losing a block. For each group of classes: every thread
// owns one n1 and holds its r window values in registers; for each of its
// frames it loads the r samples once (centre padding is an index test, so
// any hop <= n_fft takes this one path), forms the group's classes and
// rounds them into A. The 8 warps then run the outer DFT, a warp's item
// being one class, 16 frames and 8 k1 columns, and write the power to P.
// Then the filterbank (and DCT) products, a warp's item being 16 frames and
// 8 output columns, written straight into the (batch, rows, n_frames)
// layout. The B operands
// (constants) are laid out on the host in fragment order and read from
// global memory, where they stay in L2 (128 KB for the packed G).
//
// Bound on the H100 at the flagship shape (32 x 160000 f32 samples,
// 1024/256, mel-128 dB, DCT-40): bytes 20.5 MB of signal, 3.2 MB out and
// the constants, ~7.2 us at 3.35 TB/s; tensor-core work per frame at the
// 1-pass Gauss tier 300,032 MACs (real classes 65,536, Gauss complex
// classes 147,456, folded mel 81,920, DCT 5,120), 12.0 GFLOP over 20,032
// frames, 12.2 us at 989 TFLOP/s, plus ~4 us of f32 SIMT work at 67
// TFLOP/s; x2 31.5 GFLOP, 31.8 us. So it is bound by operations. This first
// design is simple rather than fast: mma.sync with its B fragments from L2,
// the inner DFT recomputed per group from the signal, two barriers per
// group. TMA or cp.async staging of B, wgmma, and a shared inner DFT are
// the next steps.
// Build without --use_fast_math: log10f and sqrtf must stay exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

typedef __nv_bfloat16 bf16;

struct Params {
  const float* x;
  const float* window;
  const float2* twiddle;  // W_N^k = (cos, -sin)(2 pi k / N), k < N
  const uint2* rw_hi;     // real classes: K 256 (two slots), N 256
  const uint2* rw_lo;
  const uint2* g_hi;      // complex classes: packed K 256 N 256, Gauss K 128 N 384
  const uint2* g_lo;
  const uint2* map_hi;    // folded mapping: K classes*128, N 8 map_ntiles
  const uint2* map_lo;
  const uint2* dct_hi;    // DCT: K 8 map_ntiles, N 8 dct_ntiles (null: no DCT)
  const uint2* dct_lo;
  float* out;
  long long n;
  int log2n, hop, pad, n_frames, n_out, n_coef, map_ntiles, dct_ntiles;
  int amp, pre_amp, x2, gauss, tile_f, group;
  float eps;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// A fragment of rows [row0, row0 + 16), columns [k0, k0 + 16) of a
// row-major bf16 matrix: lane 4g + t holds (g, 2t..2t+1), (g+8, 2t..),
// (g, 2t+8..), (g+8, 2t+8..), the lower column in the lower half.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m, int ld, int row0,
                                       int k0, int lane) {
  const bf16* p = m + (row0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// One 16 x 8 tile of A @ B over `ksteps` k-steps of 16, in `passes` passes
// with one accumulator each, summed (hh + hl) + lh. A rows start at row0
// and columns at a_col0; B fragments start at k-step b_ks0 of n-tile nt in
// a matrix of b_ntiles n-tiles. out[0..1]: row g, columns 2t, 2t+1;
// out[2..3]: row g+8.
__device__ __forceinline__ void tile_dot(float (&out)[4], const bf16* a_hi, const bf16* a_lo,
                                         int lda, int row0, int a_col0, const uint2* b_hi,
                                         const uint2* b_lo, int b_ntiles, int b_ks0, int nt,
                                         int ksteps, int passes, int lane) {
  float hh[4] = {0.f, 0.f, 0.f, 0.f};
  float hl[4] = {0.f, 0.f, 0.f, 0.f};
  float lh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4];
    load_a(a, a_hi, lda, row0, a_col0 + 16 * ks, lane);
    const int bi = ((b_ks0 + ks) * b_ntiles + nt) * 32 + lane;
    const uint2 bh = __ldg(b_hi + bi);
    mma_bf16(hh, a, bh);
    if (passes > 1) mma_bf16(hl, a, __ldg(b_lo + bi));
    if (passes > 2) {
      load_a(a, a_lo, lda, row0, a_col0 + 16 * ks, lane);
      mma_bf16(lh, a, bh);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (hh[i] + hl[i]) + lh[i];
}

// Store the pair (v0, v1) at m[off], m[off + 1] as bf16 hi, and the
// rounding remainders as bf16 lo where lo is kept.
__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, int off, float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  if (lo != nullptr) {
    *reinterpret_cast<__nv_bfloat162*>(lo + off) =
        __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  }
}

__device__ __forceinline__ float apply_amp(float v, int amp, float eps) {
  if (amp == 1) return sqrtf(v);
  if (amp == 2) return 10.0f * log10f(fmaxf(v, eps));
  return v;
}

// The A operands of classes c0..c0+n-1 for the tile, one slot of
// tile_f x lda each, rounded once to bf16: the real classes 0 and r/2 as y
// (128 columns); complex classes as [re | im] or, for Gauss,
// [re + im | im | re]. As in the TPU kernel the inner r-point DFT comes
// first (its W_r^(c n2) is the same for every lane of a warp), then one
// twiddle W_N^(c n1) per value, all in f32. A thread always owns the same
// n1: it holds its r window values w[n2] = window[n1 + 128 n2], and loads
// each frame's r samples once for the whole group.
template <int R>
__device__ __forceinline__ void inner_group(const Params& p, const float (&w)[R], bf16* A, int lda, int c0,
                            int n, int b, int f0) {
  constexpr int kN = 128 * R;
  const float* xb = p.x + static_cast<long long>(b) * p.n;
  const int n1 = threadIdx.x & 127;
  for (int f = threadIdx.x >> 7; f < p.tile_f; f += kThreads / 128) {
    const bool live = f0 + f < p.n_frames;
    const long long base = static_cast<long long>(f0 + f) * p.hop - p.pad + n1;
    float v[R];
#pragma unroll
    for (int n2 = 0; n2 < R; ++n2) {
      const long long s = base + 128 * n2;
      v[n2] = (live && s >= 0 && s < p.n) ? __ldg(xb + s) * w[n2] : 0.0f;
    }
    for (int k = 0; k < n; ++k) {
      const int c = c0 + k;
      bf16* row = A + (k * p.tile_f + f) * lda;
      if (c == 0 || c == R / 2) {
        float y = 0.0f;
#pragma unroll
        for (int n2 = 0; n2 < R; ++n2) y += (c != 0 && (n2 & 1)) ? -v[n2] : v[n2];
        row[n1] = __float2bfloat16_rn(y);
        continue;
      }
      float yr = 0.0f, yi = 0.0f;
#pragma unroll
      for (int n2 = 0; n2 < R; ++n2) {
        const float2 tw = __ldg(p.twiddle + ((128 * c * n2) & (kN - 1)));  // W_r^(c n2)
        yr = fmaf(v[n2], tw.x, yr);
        yi = fmaf(v[n2], tw.y, yi);
      }
      const float2 t = __ldg(p.twiddle + c * n1);  // c n1 < N / 2
      const float re = yr * t.x - yi * t.y;
      const float im = yr * t.y + yi * t.x;
      if (p.gauss) {
        row[n1] = __float2bfloat16_rn(re + im);
        row[128 + n1] = __float2bfloat16_rn(im);
        row[256 + n1] = __float2bfloat16_rn(re);
      } else {
        row[n1] = __float2bfloat16_rn(re);
        row[128 + n1] = __float2bfloat16_rn(im);
      }
    }
  }
}

// Outer 128-point DFT of classes c0..c0+n-1 on tensor cores, |X|^2 into
// P's class blocks. A warp's item is one class, one row tile of 16 frames
// and one k1 block of 8.
__device__ __forceinline__ void outer_group(const Params& p, const bf16* A, int lda,
                                            bf16* p_hi, bf16* p_lo, int ldp, int c0, int n) {
  const int half = (1 << p.log2n) >> 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int passes = p.x2 ? 2 : 1;
  const int m_tiles = p.tile_f >> 4;
  for (int item = warp; item < n * m_tiles * 16; item += kWarps) {
    const int k = item / (m_tiles * 16);
    const int c = c0 + k;
    const int row0 = ((item >> 4) % m_tiles) * 16;
    const int j = item & 15;
    const bf16* a = A + k * p.tile_f * lda;
    float re[4], im[4];
    if (c == 0 || c == half) {
      const int ks0 = c == 0 ? 0 : 8;
      tile_dot(re, a, nullptr, lda, row0, 0, p.rw_hi, p.rw_lo, 32, ks0, j, 8, passes, lane);
      tile_dot(im, a, nullptr, lda, row0, 0, p.rw_hi, p.rw_lo, 32, ks0, j + 16, 8, passes, lane);
    } else if (p.gauss) {
      float t1[4], t2[4], t3[4];
      tile_dot(t1, a, nullptr, lda, row0, 0, p.g_hi, p.g_lo, 48, 0, j, 8, passes, lane);
      tile_dot(t2, a, nullptr, lda, row0, 128, p.g_hi, p.g_lo, 48, 0, 16 + j, 8, passes, lane);
      tile_dot(t3, a, nullptr, lda, row0, 256, p.g_hi, p.g_lo, 48, 0, 32 + j, 8, passes, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        re[i] = t1[i] - t2[i];
        im[i] = t1[i] + t3[i];
      }
    } else {
      tile_dot(re, a, nullptr, lda, row0, 0, p.g_hi, p.g_lo, 32, 0, j, 16, passes, lane);
      tile_dot(im, a, nullptr, lda, row0, 0, p.g_hi, p.g_lo, 32, 0, j + 16, 16, passes, lane);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = re[2 * h] * re[2 * h] + im[2 * h] * im[2 * h];
      float v1 = re[2 * h + 1] * re[2 * h + 1] + im[2 * h + 1] * im[2 * h + 1];
      if (p.pre_amp) {
        v0 = sqrtf(v0);
        v1 = sqrtf(v1);
      }
      const int row = row0 + (lane >> 2) + 8 * h;
      store_split(p_hi, p_lo, row * ldp + c * 128 + 8 * j + 2 * (lane & 3), v0, v1);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads) fused_tier_features_kernel(const Params p) {
  extern __shared__ uint4 smem[];
  const int r = R;
  const int classes = r / 2 + 1;
  const int tile_f = p.tile_f;
  const int m_tiles = tile_f >> 4;
  const int ka = r == 2 ? 128 : (p.gauss ? 384 : 256);
  const int lda = ka + 8;
  const int kp = classes * 128;
  const int ldp = kp + 8;
  const int kd = p.map_ntiles * 8;  // the DCT's rows, when there is one
  const int ldf = kd + 8;
  bf16* A = reinterpret_cast<bf16*>(smem);
  bf16* p_hi = A + p.group * tile_f * lda;
  bf16* p_lo = p.x2 ? p_hi + tile_f * ldp : nullptr;
  bf16* f_hi = p_hi + tile_f * ldp * (p.x2 ? 2 : 1);
  bf16* f_lo = p.x2 ? f_hi + tile_f * ldf : nullptr;
  const int tail = p.x2 ? 3 : 1;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * tile_f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool with_dct = p.dct_hi != nullptr;

  // 1. Classes, p.group at a time: inner DFT into A, outer DFT and power
  //    into P.
  float w[R];
#pragma unroll
  for (int n2 = 0; n2 < R; ++n2) w[n2] = __ldg(p.window + (threadIdx.x & 127) + 128 * n2);
  for (int c0 = 0; c0 < classes; c0 += p.group) {
    const int n = min(p.group, classes - c0);
    inner_group<R>(p, w, A, lda, c0, n, b, f0);
    __syncthreads();
    outer_group(p, A, lda, p_hi, p_lo, ldp, c0, n);
    __syncthreads();
  }

  // 2. Folded filterbank, then the amplitude scale.
  const int n_rows = with_dct ? p.n_coef : p.n_out;
  for (int item = warp; item < m_tiles * p.map_ntiles; item += kWarps) {
    const int row0 = (item % m_tiles) * 16;
    const int nt = item / m_tiles;
    float y[4];
    tile_dot(y, p_hi, p_lo, ldp, row0, 0, p.map_hi, p.map_lo, p.map_ntiles, 0, nt, kp / 16,
             tail, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      const int col = 8 * nt + 2 * t;
      const float v0 = apply_amp(y[2 * h], p.amp, p.eps);
      const float v1 = apply_amp(y[2 * h + 1], p.amp, p.eps);
      if (with_dct) {
        store_split(f_hi, f_lo, row * ldf + col, v0, v1);
      } else if (f0 + row < p.n_frames) {
        float* o = p.out + (static_cast<long long>(b) * n_rows + col) * p.n_frames + f0 + row;
        if (col < p.n_out) o[0] = v0;
        if (col + 1 < p.n_out) o[p.n_frames] = v1;
      }
    }
  }
  if (!with_dct) return;  // uniform across the block
  __syncthreads();

  // 3. DCT tail.
  for (int item = warp; item < m_tiles * p.dct_ntiles; item += kWarps) {
    const int row0 = (item % m_tiles) * 16;
    const int nt = item / m_tiles;
    float y[4];
    tile_dot(y, f_hi, f_lo, ldf, row0, 0, p.dct_hi, p.dct_lo, p.dct_ntiles, 0, nt, kd / 16,
             tail, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1);
      const int col = 8 * nt + 2 * t + (e & 1);
      if (col < p.n_coef && f0 + row < p.n_frames) {
        p.out[(static_cast<long long>(b) * n_rows + col) * p.n_frames + f0 + row] = y[e];
      }
    }
  }
}

template <int R>
int launch(const Params& p, int batch, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_tier_features_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n_frames + p.tile_f - 1) / p.tile_f, batch);
  fused_tier_features_kernel<R><<<grid, kThreads, smem_bytes,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of the current device, which the
// caller sets to the tensors' device; allocates nothing and does not
// synchronise. Returns cudaGetLastError() after the launch, so a refused
// launch is reported to the caller.
extern "C" int fused_tier_features_launch(
    const float* x, const float* window, const void* twiddle, const void* rw_hi,
    const void* rw_lo, const void* g_hi, const void* g_lo, const void* map_hi,
    const void* map_lo, const void* dct_hi, const void* dct_lo, float* out, int batch,
    long long n, int log2n, int hop, int pad, int n_frames, int n_out, int n_coef,
    int map_ntiles, int dct_ntiles, int amp, int pre_amp, int x2, int gauss, int tile_f,
    int group, int smem_bytes, float eps, void* stream) {
  Params p;
  p.x = x;
  p.window = window;
  p.twiddle = static_cast<const float2*>(twiddle);
  p.rw_hi = static_cast<const uint2*>(rw_hi);
  p.rw_lo = static_cast<const uint2*>(rw_lo);
  p.g_hi = static_cast<const uint2*>(g_hi);
  p.g_lo = static_cast<const uint2*>(g_lo);
  p.map_hi = static_cast<const uint2*>(map_hi);
  p.map_lo = static_cast<const uint2*>(map_lo);
  p.dct_hi = static_cast<const uint2*>(dct_hi);
  p.dct_lo = static_cast<const uint2*>(dct_lo);
  p.out = out;
  p.n = n;
  p.log2n = log2n;
  p.hop = hop;
  p.pad = pad;
  p.n_frames = n_frames;
  p.n_out = n_out;
  p.n_coef = n_coef;
  p.map_ntiles = map_ntiles;
  p.dct_ntiles = dct_ntiles;
  p.amp = amp;
  p.pre_amp = pre_amp;
  p.x2 = x2;
  p.gauss = gauss;
  p.tile_f = tile_f;
  p.group = group;
  p.eps = eps;
  switch (log2n) {
    case 8: return launch<2>(p, batch, smem_bytes, stream);
    case 9: return launch<4>(p, batch, smem_bytes, stream);
    case 10: return launch<8>(p, batch, smem_bytes, stream);
    case 11: return launch<16>(p, batch, smem_bytes, stream);
    case 12: return launch<32>(p, batch, smem_bytes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_tier_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
