// Fused feature kernel at the bf16 precision tiers, for Hopper (sm_90a).
//
// Replaces spectrograms_tpu/ops/pallas_factored.py::_kernel at its "bf16"
// (1-pass, precision=DEFAULT) and "bf16x2" (method="pallas:x2") tiers. It
// computes what the TPU kernel computes there, with the operands rounded
// to bf16 at the same points (the f32 kernel fused_features.cu serves the
// "bf16x3" tier, more precisely):
//
//   N = 128 r.  Y[c, n1] = sum_n2 w x[n1 + 128 n2] W_r^(c n2) (the inner
//   r-point DFT, f32), B[c, n1] = Y[c, n1] W_N^(c n1) (f32)  ->  X[c + r k1]
//   = sum_n1 B[c, n1] W_128^(n1 k1) on tensor cores, classes c = 0..r/2
//   only (Hermitian fold)  ->  |X|^2 (-> sqrt when pre_amp)  ->  the
//   host-folded filterbank on tensor cores  ->  power | magnitude | dB  (->
//   DCT on tensor cores)  ->  out[b, row, frame].
//
// The tensor-core products are mma.sync m16n8k16 bf16 x bf16 -> f32, one
// accumulator per pass, summed as the TPU kernel's dot3: (ah bh + ah bl) +
// al bh. Tiers: bf16 = 1 pass everywhere; bf16x2 = 2 passes (ah bh + ah bl)
// on the outer DFT and 3 on the filterbank and DCT. A is rounded once
// (__float2bfloat16_rn). The complex classes use the packed product
// [re | im] @ [[C, -S'], [S', C]] or the Gauss form T1 = (a + b) G1,
// T2 = b G2, T3 = a G3, re = T1 - T2, im = T1 + T3; the real classes 0 and
// r/2 carry their twiddle in their constant.
//
// What bounds it on the H100 (chip_smoke.py's tier_bound, from the run's
// inputs): at the flagship shape (32 x 160000 f32 samples, 1024/256, mel-128
// dB, DCT-40) 20.5 MB of signal and 3.2 MB out, 7.1 us at 3.35 TB/s; per
// frame at the 1-pass Gauss tier the outer DFT over the n-tiles the mapping
// reads (real classes 32,768 MACs, Gauss 147,456), the folded mel over its
// nonzeros (1,009) and the DCT (5,120), 186,353 MACs, 7.5 GFLOP over 20,032
// frames, 7.5 us at 989 TFLOP/s, plus ~4 us of f32 SIMT work at 67 TFLOP/s:
// operations, 11.68 us (13.12 us counting the outer DFT dense, as the first
// design's bound did); x2 23.12 us; the chroma batch 20.91 us at 1 pass.
//
// Design, per block of tile_f (16, or 8) consecutive frames of one signal:
// 1. Stage the tile's signal span once, (tile_f - 1) hop + n_fft samples:
//    16-byte cp.async chunks from an address aligned down, the shift kept in
//    the index, samples outside the row zero-filled (fused_features.cu's
//    scheme). Where the span does not fit beside the rest (large hops at
//    n_fft 4096), samples are read through L1 instead.
// 2. Inner DFT in registers: a thread owns (n1, frame), holds its r
//    windowed samples and runs a radix-2 real FFT over them, in the DIT
//    order of factored_layout.real_fft_classes with its zero and +-1
//    shortcuts decided at compile time, every product and sum rounded on
//    its own (__fmul_rn, __fadd_rn): its f32 values are the plain
//    version's, so the bf16 roundings of A agree with it. One FFT yields
//    every class; the per-class twiddle W_N^(c n1) is read through L1. The
//    classes are rounded into A in shared memory, rows (class, frame)
//    flattened (complex classes in groups when shared memory does not hold
//    them all; the FFT then runs once a group, from the staged span).
// 3. Outer DFT over the 8-column n-tiles that a mapping row reads (host
//    lists: chroma reads 4 of 16 for a complex class, 2 for a real one; the
//    flagship's real classes 8). A warp item is one n-tile of a real class
//    or of all the group's complex classes, with a mask of the 16-row tiles
//    it runs (split so that each warp has two items): its B fragments are
//    loaded into registers once (at 1 pass all of them before the first
//    product), then the row tiles run against them, A by ldmatrix. Items
//    run n-tile major, so that an SM's warps read the same fragments. The
//    power goes to a compact tile P that holds only the n-tiles read.
// 4. Filterbank by nonzero k-steps: for each 8-column n-tile of the
//    compact folded mapping, only the 16-row k-steps that hold a nonzero
//    (mel-128: 149 of 512), with their B fragments packed in list order.
//    Then the amplitude scale; then the DCT, dense.
// Every skip is exact: a zero weight times a finite bf16 power adds 0. The
// tier and form are template parameters, so that each build holds only its
// own fragments.
//
// What measurement chose (tools/tier_stage_times.py, H100 80GB HBM3, 700
// W): 16-frame tiles at n_fft <= 1024 (32 frames ran 25-80 % slower) and 8
// at chroma's 1-pass Gauss, whose 15 complex classes then fit in one group
// (16 frames take two, each running the FFT: 0.26 against 0.22 ms); a
// 128-register cap; B fragments per item, not per (class, n-tile) item
// (which reloaded them for every class); the P slots looked up before an
// item's products (after them, their latency took 40 % of an item, SM
// clocks by phase from the TIER_CLOCKS build). Measured and not kept:
// interleaving the row tiles' mma chains k-step by k-step (8-19 % slower),
// 512-thread blocks at 32 frames, an 85-register cap (with or without the
// 1-pass B fragments loaded a chunk at a time, which alone changed
// nothing). The outer DFT still
// takes the largest share of a block's clocks: next, fragments reused
// across n-tiles (constant as the mma's A operand, or wgmma from shared
// memory), so that each A fragment feeds more than one product.
// Build without --use_fast_math: log10f and sqrtf must stay exact, and the
// inner DFT's roundings must not be contracted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Blocks of 256 threads an SM should hold at n_fft <= 1024: the register
// cap is 65536 / (256 * TIER_MIN_BLOCKS), 128 at 2, which measured fastest
// (85 registers, 3 blocks, spilled and ran 15 % slower at the flagship; 255,
// 1 block, 50 % slower). At n_fft >= 2048 a block has 512 threads and is
// alone on its SM (its shared memory), also at 128 registers.
#ifndef TIER_MIN_BLOCKS
#define TIER_MIN_BLOCKS 2
#endif

template <int R> struct Block {
  static constexpr int kThreads = R >= 16 ? 512 : 256;
  static constexpr int kMinBlocks = R >= 16 ? 1 : TIER_MIN_BLOCKS;
};

namespace {

typedef __nv_bfloat16 bf16;

struct Params {
  const float* x;
  const float* window;
  const float2* twiddle;  // W_N^k = (cos, -sin)(2 pi k / N), k < N
  const uint2* rw_hi;     // real classes: K 256 (two slots), N 256
  const uint2* rw_lo;
  const uint2* g_hi;      // complex classes: packed K 256 N 256, Gauss K 128 N 384
  const uint2* g_lo;
  const int4* items;      // outer DFT: (kind | j << 2, row-tile mask, 0, 0)
  const int* groups;      // per group (c0, c1, first item), then (0, 0, items)
  const int* slots;       // (classes, 16): P slot of (class, n-tile), -1 if unread
  const int* map_first;   // filterbank: k-steps of n-tile nt are
  const int* map_ks;      //   map_ks[map_first[nt] .. map_first[nt + 1])
  const uint2* map_hi;    // their fragments, entry q at q * 32 + lane
  const uint2* map_lo;
  const uint2* dct_hi;    // DCT: K kd, N 8 dct_ntiles (null: no DCT)
  const uint2* dct_lo;
  float* out;
  long long n;
  int hop, pad, n_frames, n_out, n_coef, map_ntiles, dct_ntiles, kc, p_cols, kd;
  int amp, pre_amp, x2, gauss, tile_f, staged, n_groups;
  int p_off, feat_off, ar_off, ac_off;
  float eps;
};

// TIER_CLOCKS (the stage tool's build): thread 0 of each block adds the
// SM clocks between the block's barriers to one counter per phase: 0 the
// staging, 1 the inner FFT, 2 the outer DFT, 3 the filterbank, 4 the DCT;
// and lane 0 of each warp splits its outer DFT items (at 1 pass): 5 from
// the item's start until its B fragments have arrived, 6 its products, 7
// its power stores.
#ifdef TIER_CLOCKS
__device__ unsigned long long g_tier_clocks[8];
#define TIER_TICK(t, dep) asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(dep) : "memory")
#define TIER_MARK(i)                                                        \
  if (threadIdx.x == 0) {                                                   \
    const long long t_now = clock64();                                      \
    atomicAdd(&g_tier_clocks[i], static_cast<unsigned long long>(t_now - t_mark)); \
    t_mark = t_now;                                                         \
  }
#else
#define TIER_MARK(i)
#endif

// ---- the inner DFT -------------------------------------------------------

// f32 (cos, sin)(2 pi k / 32), as numpy rounds them: every W_s^c of the
// levels (s <= 32) is W_32^(c 32 / s), bit for bit.
__host__ __device__ constexpr float cos32(int k) {
  return k > 8 ? -cos32(16 - k)
       : k == 0 ? 0x1.000000p+0f : k == 1 ? 0x1.f6297cp-1f : k == 2 ? 0x1.d906bcp-1f
       : k == 3 ? 0x1.a9b662p-1f : k == 4 ? 0x1.6a09e6p-1f : k == 5 ? 0x1.1c73b4p-1f
       : k == 6 ? 0x1.87de2ap-2f : k == 7 ? 0x1.8f8b84p-3f : 0.0f;
}
__host__ __device__ constexpr float sin32(int k) { return k > 8 ? sin32(16 - k) : cos32(8 - k); }

// Kinds of (cos, -sin)(2 pi c / s), as real_fft_classes snaps them:
// 0 zero, 1 one, 2 minus one, 3 a general value.
__host__ __device__ constexpr int kind_re(int s, int c) {
  return 4 * c == s ? 0 : c == 0 ? 1 : 2 * c == s ? 2 : 3;
}
__host__ __device__ constexpr int kind_im(int s, int c) {
  return (c == 0 || 2 * c == s) ? 0 : 4 * c == s ? 2 : 3;
}
// The kind of +sin, the -wi of mul(o_im, -wi).
__host__ __device__ constexpr int kind_neg_im(int s, int c) {
  return kind_im(s, c) == 2 ? 1 : kind_im(s, c);
}

// Which outputs of a size-s level are exactly zero ("None" in
// real_fft_classes): bit 0 the real part, bit 1 the imaginary part.
__host__ __device__ constexpr int zmask(int s, int c) {
  if (s == 1) return 2;
  const int h = s / 2, ce = c % h;
  const int sub = zmask(h, ce <= h / 2 ? ce : h - ce);  // both halves alike
  const bool zr = (sub & 1) != 0, zi = (sub & 2) != 0;
  const bool tzr = (zr || kind_re(s, c) == 0) && (zi || kind_neg_im(s, c) == 0);
  const bool tzi = (zi || kind_re(s, c) == 0) && (zr || kind_im(s, c) == 0);
  return (zr && tzr ? 1 : 0) | (zi && tzi ? 2 : 0);
}

template <int K> __device__ __forceinline__ float wmul(float x, float w) {
  if constexpr (K == 1) return x;
  else if constexpr (K == 2) return -x;
  else if constexpr (K == 3) return __fmul_rn(x, w);
  else return 0.0f;  // an exact zero: never added
}

template <bool ZA, bool ZB> __device__ __forceinline__ float zadd(float a, float b) {
  if constexpr (ZA) return b;
  else if constexpr (ZB) return a;
  else return __fadd_rn(a, b);
}

// Class C of a size-S level from its two size-S/2 halves (even, odd).
template <int S, int C> struct Combine {
  template <int M>
  static __device__ __forceinline__ void run(const float (&ere)[M], const float (&eim)[M],
                                             const float (&ore)[M], const float (&oim)[M],
                                             float (&re)[S / 2 + 1], float (&im)[S / 2 + 1]) {
    if constexpr (C <= S / 2) {
      constexpr int H = S / 2, CE = C % H;
      constexpr bool MIR = CE > H / 2;
      constexpr int EI = MIR ? H - CE : CE;
      constexpr int ZM = zmask(H, EI);
      constexpr bool ZR = ZM & 1, ZI = (ZM & 2) != 0;
      constexpr int KR = kind_re(S, C), KI = kind_im(S, C), NKI = kind_neg_im(S, C);
      constexpr int K = C * 32 / S;
      const float e_im = MIR ? -eim[EI] : eim[EI];
      const float o_im = MIR ? -oim[EI] : oim[EI];
      constexpr bool A1 = ZR || KR == 0, A2 = ZI || NKI == 0;  // o_re wr, o_im (-wi)
      constexpr bool B1 = ZI || KR == 0, B2 = ZR || KI == 0;   // o_im wr, o_re wi
      const float t_re = zadd<A1, A2>(wmul<KR>(ore[EI], cos32(K)), wmul<NKI>(o_im, sin32(K)));
      const float t_im = zadd<B1, B2>(wmul<KR>(o_im, cos32(K)), wmul<KI>(ore[EI], -sin32(K)));
      re[C] = zadd<ZR, A1 && A2>(ere[EI], t_re);
      im[C] = zadd<ZI, B1 && B2>(e_im, t_im);
      static_assert(zmask(S, C) == ((ZR && A1 && A2 ? 1 : 0) | (ZI && B1 && B2 ? 2 : 0)),
                    "zero pattern");
      Combine<S, C + 1>::run(ere, eim, ore, oim, re, im);
    }
  }
};

// real_fft_classes over v[OFF], v[OFF + ST], ...: S values, classes
// 0..S/2 into (re, im); an entry that zmask marks zero is not read.
template <int S, int ST, int OFF> struct RealDft {
  template <int N>
  static __device__ __forceinline__ void run(const float (&v)[N], float (&re)[S / 2 + 1],
                                             float (&im)[S / 2 + 1]) {
    if constexpr (S == 1) {
      re[0] = v[OFF];
      im[0] = 0.0f;
    } else {
      constexpr int M = S / 4 + 1;
      float ere[M], eim[M], ore[M], oim[M];
      RealDft<S / 2, 2 * ST, OFF>::run(v, ere, eim);
      RealDft<S / 2, 2 * ST, OFF + ST>::run(v, ore, oim);
      Combine<S, 0>::run(ere, eim, ore, oim, re, im);
    }
  }
};

// Round class C of one (n1, frame) into A: real classes into their slot of
// A_real (first group only), complex classes in [c0, c1) into A_c.
template <int R, bool GAUSS, int C> struct WriteClasses {
  // real0, real_half: the frame's row of the real classes' slots; a_c: the
  // frame's row of class c0 (a class's rows lie tile_f rows apart)
  static __device__ __forceinline__ void run(const Params& p, const float (&re)[R / 2 + 1],
                                             const float (&im)[R / 2 + 1], bf16* real0,
                                             bf16* real_half, bf16* a_c, int lda, int c0, int c1,
                                             bool first, int n1) {
    if constexpr (C <= R / 2) {
      if constexpr (C == 0 || C == R / 2) {
        if (first) (C == 0 ? real0 : real_half)[n1] = __float2bfloat16_rn(re[C]);
      } else {
        static_assert(zmask(R, C) == 0, "a complex class has both parts");
        if (C >= c0 && C < c1) {
          const float2 t = __ldg(p.twiddle + C * n1);  // c n1 < N / 2
          const float a_re = __fsub_rn(__fmul_rn(re[C], t.x), __fmul_rn(im[C], t.y));
          const float a_im = __fadd_rn(__fmul_rn(re[C], t.y), __fmul_rn(im[C], t.x));
          bf16* row = a_c + (C - c0) * p.tile_f * lda;
          if constexpr (GAUSS) {
            row[n1] = __float2bfloat16_rn(__fadd_rn(a_re, a_im));
            row[128 + n1] = __float2bfloat16_rn(a_im);
            row[256 + n1] = __float2bfloat16_rn(a_re);
          } else {
            row[n1] = __float2bfloat16_rn(a_re);
            row[128 + n1] = __float2bfloat16_rn(a_im);
          }
        }
      }
      WriteClasses<R, GAUSS, C + 1>::run(p, re, im, real0, real_half, a_c, lda, c0, c1, first,
                                         n1);
    }
  }
};

// ---- tensor-core helpers ---------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The A fragment of rows [row0, row0 + 16), columns [k0, k0 + 16) of a
// row-major bf16 matrix in shared memory (rows 16-byte aligned).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m, int ld, int row0,
                                       int k0, int lane) {
  const bf16* q = m + (row0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3);
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(q));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// The B fragments of one chunk of 8 k-steps of the outer DFT: NB columns
// (n-tiles nt[q]) from k-step ks0 of a constant of b_ntiles n-tiles, hi (and
// lo at x2).
template <int NB, bool X2>
struct BChunk {
  uint2 hi[NB][8], lo[NB][8];
  // every fragment's bits folded, so that a clock read can wait on them
  __device__ __forceinline__ unsigned fold() const {
    unsigned v = 0;
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int k = 0; k < 8; ++k) v ^= hi[q][k].x ^ hi[q][k].y;
    return v;
  }
  __device__ __forceinline__ void load(const uint2* b_hi, const uint2* b_lo, int b_ntiles,
                                       int ks0, const int (&nt)[NB], int lane) {
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int bi = ((ks0 + k) * b_ntiles + nt[q]) * 32 + lane;
        hi[q][k] = __ldg(b_hi + bi);
        if constexpr (X2) lo[q][k] = __ldg(b_lo + bi);
      }
  }
};

// A batch of TB row tiles against a loaded chunk: row tile u (rows 16u..,
// A columns a_col + 16k) runs against every column, column q into
// accumulator D0 (q = 0) or D1 (q = 1); the lo pass into its own. Row tile
// by row tile, k-steps inside: interleaving the row tiles' chains measured
// slower (the flagship 8 % at 1 pass, 19 % at x2).
template <int TB, int NACC, bool X2, int NB, int D0, int D1>
__device__ __forceinline__ void outer_chunk(float (&acc)[TB][NACC][4],
                                            float (&accl)[TB][NACC][4], const bf16* a, int ld,
                                            const int (&tiles)[TB], int a_col,
                                            const BChunk<NB, X2>& bc, int lane) {
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    if (tiles[b] < 0) break;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t af[4];
      load_a(af, a, ld, 16 * tiles[b], a_col + 16 * k, lane);
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        mma_bf16(acc[b][q == 0 ? D0 : D1], af, bc.hi[q][k]);
        if constexpr (X2) mma_bf16(accl[b][q == 0 ? D0 : D1], af, bc.lo[q][k]);
      }
    }
  }
}

// The outer DFT of a group's items, |X|^2 (-> sqrt) into the compact P.
// An item is one n-tile j of the real class 0 (kind 0), r/2 (kind 1) or of
// the group's complex classes (kind 2), with a mask of the row tiles of its
// A region that read j. Rows of A are (class, frame) flattened, tile_f
// frames a class, so a 16-row tile holds one class (tile_f >= 16) or two
// (tile_f = 8). Row tiles go in batches of TB, each batch loading every
// B fragment of the item once.
template <int R, bool X2, bool GAUSS>
__device__ __forceinline__ void outer_group(const Params& p, const bf16* a_real, const bf16* a_c,
                                            int lda, int c0, int c1, int it0, int it1,
                                            bf16* p_hi, bf16* p_lo, int ldp, int warp, int lane) {
  constexpr int TB = X2 ? 2 : 4;
  constexpr int NACC = GAUSS ? 3 : 2;
  const int tile_f = p.tile_f;
  const int rf = tile_f < 16 ? 16 : tile_f;
  const int g = lane >> 2, tq = lane & 3;
  const int log2_f = __ffs(tile_f) - 1;  // tile_f is a power of two
  constexpr int kWarps = Block<R>::kThreads / 32;
  for (int it = it0 + warp; it < it1; it += kWarps) {
    const int4 item = __ldg(p.items + it);
    const int kind = item.x & 3, j = item.x >> 2;
    unsigned mask = static_cast<unsigned>(item.y);
    const bf16* a = kind < 2 ? a_real + kind * rf * 136 : a_c;
    const int ld = kind < 2 ? 136 : lda;
    while (mask != 0) {
      int tiles[TB];
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        tiles[b] = mask != 0 ? __ffs(mask) - 1 : -1;
        mask &= mask - 1;
      }
      // The P slot and frame of each row this lane stores (rows g and g + 8
      // of each tile), looked up before the products so that the table's
      // latency hides behind them: waiting on it after them took 40 % of
      // an item (TIER_CLOCKS).
      int slot[TB][2], frame[TB][2];
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int flat = 16 * tiles[b] + g + 8 * h;
          frame[b][h] = kind < 2 ? flat : flat & (tile_f - 1);
          const int c = kind == 0 ? 0 : kind == 1 ? R / 2 : c0 + (flat >> log2_f);
          const bool live = tiles[b] >= 0 && frame[b][h] < tile_f && (kind < 2 || c < c1);
          slot[b][h] = live ? __ldg(p.slots + c * 16 + j) : -1;
        }
      float acc[TB][NACC][4], accl[TB][NACC][4];
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int q = 0; q < NACC; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[b][q][i] = accl[b][q][i] = 0.0f;
#ifdef TIER_CLOCKS
      long long tk[4];
      unsigned dep = 0;
      TIER_TICK(tk[0], dep);
#endif
      // At 1 pass every chunk's fragments are loaded before the first
      // product, so that their L2 latencies overlap; at x2 (twice the
      // fragments) one chunk at a time.
      if (kind < 2) {
        // rw: [re | im] columns of the class's slot, 8 k-steps
        const int nts[2] = {j, j + 16};
        BChunk<2, X2> b0;
        b0.load(p.rw_hi, p.rw_lo, 32, 8 * kind, nts, lane);
#ifdef TIER_CLOCKS
        TIER_TICK(tk[1], b0.fold());
#endif
        outer_chunk<TB, NACC, X2, 2, 0, 1>(acc, accl, a, ld, tiles, 0, b0, lane);
      } else if constexpr (GAUSS) {
        // T1 = (a + b) G1, T2 = b G2, T3 = a G3
        const int n1[1] = {j}, n2[1] = {16 + j}, n3[1] = {32 + j};
        BChunk<1, X2> b0, b1, b2;
        b0.load(p.g_hi, p.g_lo, 48, 0, n1, lane);
        if constexpr (!X2) {
          b1.load(p.g_hi, p.g_lo, 48, 0, n2, lane);
          b2.load(p.g_hi, p.g_lo, 48, 0, n3, lane);
        }
#ifdef TIER_CLOCKS
        TIER_TICK(tk[1], b0.fold() ^ (X2 ? 0u : b1.fold() ^ b2.fold()));
#endif
        outer_chunk<TB, NACC, X2, 1, 0, 0>(acc, accl, a, ld, tiles, 0, b0, lane);
        if constexpr (X2) b1.load(p.g_hi, p.g_lo, 48, 0, n2, lane);
        outer_chunk<TB, NACC, X2, 1, 1, 1>(acc, accl, a, ld, tiles, 128, b1, lane);
        if constexpr (X2) b2.load(p.g_hi, p.g_lo, 48, 0, n3, lane);
        outer_chunk<TB, NACC, X2, 1, 2, 2>(acc, accl, a, ld, tiles, 256, b2, lane);
      } else {
        // packed [re | im] @ [[C, -S'], [S', C]]: 16 k-steps, in two chunks
        const int nts[2] = {j, j + 16};
        BChunk<2, X2> b0, b1;
        b0.load(p.g_hi, p.g_lo, 32, 0, nts, lane);
        if constexpr (!X2) b1.load(p.g_hi, p.g_lo, 32, 8, nts, lane);
#ifdef TIER_CLOCKS
        TIER_TICK(tk[1], b0.fold() ^ (X2 ? 0u : b1.fold()));
#endif
        outer_chunk<TB, NACC, X2, 2, 0, 1>(acc, accl, a, ld, tiles, 0, b0, lane);
        if constexpr (X2) b1.load(p.g_hi, p.g_lo, 32, 8, nts, lane);
        outer_chunk<TB, NACC, X2, 2, 0, 1>(acc, accl, a, ld, tiles, 128, b1, lane);
      }
#ifdef TIER_CLOCKS
#pragma unroll
      for (int b = 0; b < TB; ++b)
#pragma unroll
        for (int q = 0; q < NACC; ++q) dep ^= __float_as_uint(acc[b][q][0] + accl[b][q][3]);
      TIER_TICK(tk[2], dep);
#endif
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        if (tiles[b] < 0) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (slot[b][h] < 0) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * h + e;
            float re, im;
            if (GAUSS && kind == 2) {
              const float t1 = acc[b][0][i] + accl[b][0][i];
              re = t1 - (acc[b][1][i] + accl[b][1][i]);
              im = t1 + (acc[b][NACC - 1][i] + accl[b][NACC - 1][i]);
            } else {
              re = acc[b][0][i] + accl[b][0][i];
              im = acc[b][1][i] + accl[b][1][i];
            }
            v[e] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
            if (p.pre_amp) v[e] = sqrtf(v[e]);
          }
          store_split(p_hi, p_lo, frame[b][h] * ldp + 8 * slot[b][h] + 2 * tq, v[0], v[1]);
        }
      }
#ifdef TIER_CLOCKS
      TIER_TICK(tk[3], 0u);
      if (lane == 0 && !X2) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          atomicAdd(&g_tier_clocks[5 + i], static_cast<unsigned long long>(tk[i + 1] - tk[i]));
      }
#endif
    }
  }
}

// ---- the kernel ------------------------------------------------------------



template <int R, bool X2, bool GAUSS>
__global__ void __launch_bounds__(Block<R>::kThreads, Block<R>::kMinBlocks)
fused_tier_features_kernel(const Params p) {
  constexpr int kThreads = Block<R>::kThreads;
  constexpr int kWarps = kThreads / 32;
  constexpr int kN = 128 * R;
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  const int tile_f = p.tile_f;
  const int rf = tile_f < 16 ? 16 : tile_f;  // rows of P, the DCT input and a real slot
  const int lda = R == 2 ? 136 : (GAUSS ? 392 : 264);
  const int ldp = p.kc + 8;
  const int ldf = p.kd + 8;
  float* span = reinterpret_cast<float*>(base);
  bf16* p_hi = reinterpret_cast<bf16*>(base + p.p_off);
  bf16* p_lo = X2 ? p_hi + rf * ldp : nullptr;
  bf16* f_hi = reinterpret_cast<bf16*>(base + p.feat_off);
  bf16* f_lo = X2 ? f_hi + rf * ldf : nullptr;
  bf16* a_real = reinterpret_cast<bf16*>(base + p.ar_off);
  bf16* a_c = reinterpret_cast<bf16*>(base + p.ac_off);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * tile_f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const float* row = p.x + static_cast<long long>(b) * p.n;
  const long long s0 = static_cast<long long>(f0) * p.hop - p.pad;
#ifdef TIER_CLOCKS
  long long t_mark = clock64();
#endif

  // 1. Stage the tile's span (the block's branch is uniform).
  int sh = 0;
  if (p.staged) {
    sh = static_cast<int>(((reinterpret_cast<uintptr_t>(row) >> 2) + static_cast<uintptr_t>(s0)) & 3);
    const int n_chunks = (sh + (tile_f - 1) * p.hop + kN + 3) >> 2;
    for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
      const long long s = s0 - sh + 4LL * c;
      float* dst = span + 4 * c;
      if (s >= 0 && s + 4 <= p.n) {
        cp_async16(dst, row + s);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long u = s + q;
          dst[q] = (u >= 0 && u < p.n) ? __ldg(row + u) : 0.0f;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  TIER_MARK(0)

  for (int gi = 0; gi < p.n_groups; ++gi) {
    const int c0 = __ldg(p.groups + 3 * gi), c1 = __ldg(p.groups + 3 * gi + 1);
    // 2. Inner DFT of every (n1, frame) in registers; the group's classes
    //    into A.
#ifndef TIER_SKIP_INNER
    {
      const int n1 = threadIdx.x & 127;
      for (int f = threadIdx.x >> 7; f < tile_f; f += kThreads / 128) {
        float v[R];
        if (p.staged) {
          const float* fs = span + sh + f * p.hop + n1;
#pragma unroll
          for (int q = 0; q < R; ++q) v[q] = __fmul_rn(fs[128 * q], __ldg(p.window + n1 + 128 * q));
        } else {
          const long long s = s0 + static_cast<long long>(f) * p.hop + n1;
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const long long u = s + 128 * q;
            const float xv = (u >= 0 && u < p.n) ? __ldg(row + u) : 0.0f;
            v[q] = __fmul_rn(xv, __ldg(p.window + n1 + 128 * q));
          }
        }
        float re[R / 2 + 1], im[R / 2 + 1];
        RealDft<R, 1, 0>::run(v, re, im);
        WriteClasses<R, GAUSS, 0>::run(p, re, im, a_real + f * 136, a_real + (rf + f) * 136,
                                       a_c + f * lda, lda, c0, c1, gi == 0, n1);
      }
    }
#endif
    __syncthreads();
    TIER_MARK(1)

    // P's columns past the last slot pad it to a whole k-step; the
    // filterbank multiplies them by zero weights, so they must be finite.
    if (gi == 0) {
      const int pad_w = p.kc - p.p_cols;
      for (int i = threadIdx.x; i < rf * pad_w; i += kThreads) {
        const int off = (i / pad_w) * ldp + p.p_cols + i % pad_w;
        p_hi[off] = __float2bfloat16_rn(0.0f);
        if (X2) p_lo[off] = __float2bfloat16_rn(0.0f);
      }
    }

    // 3. Outer DFT of the group's items, |X|^2 into the compact P.
#ifndef TIER_SKIP_OUTER
    outer_group<R, X2, GAUSS>(p, a_real, a_c, lda, c0, c1, __ldg(p.groups + 3 * gi + 2),
                                      __ldg(p.groups + 3 * gi + 5), p_hi, p_lo, ldp, warp, lane);
#endif
    __syncthreads();
    TIER_MARK(2)
  }

#ifndef TIER_SKIP_TAIL
  // 4. Filterbank over the nonzero k-steps of each n-tile, then the
  //    amplitude scale. Row tiles of 16 frames; at tile_f = 8 the second
  //    half of P's rows is never read out.
  const int r_tiles = rf >> 4;
  const bool with_dct = p.dct_hi != nullptr;
  const int n_rows = with_dct ? p.n_coef : p.n_out;
  for (int item = warp; item < r_tiles * p.map_ntiles; item += kWarps) {
    const int row0 = (item % r_tiles) * 16;
    const int nt = item / r_tiles;
    float hh[4] = {0.f, 0.f, 0.f, 0.f}, hl[4] = {0.f, 0.f, 0.f, 0.f},
          lh[4] = {0.f, 0.f, 0.f, 0.f};
    const int q1 = __ldg(p.map_first + nt + 1);
#pragma unroll 4
    for (int q = __ldg(p.map_first + nt); q < q1; ++q) {
      const int ks = __ldg(p.map_ks + q);
      const uint2 bh = __ldg(p.map_hi + q * 32 + lane);
      uint32_t a[4];
      load_a(a, p_hi, ldp, row0, 16 * ks, lane);
      mma_bf16(hh, a, bh);
      if constexpr (X2) {
        mma_bf16(hl, a, __ldg(p.map_lo + q * 32 + lane));
        load_a(a, p_lo, ldp, row0, 16 * ks, lane);
        mma_bf16(lh, a, bh);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = row0 + g + 8 * h;
      const int col = 8 * nt + 2 * tq;
      const float v0 = apply_amp((hh[2 * h] + hl[2 * h]) + lh[2 * h], p.amp, p.eps);
      const float v1 = apply_amp((hh[2 * h + 1] + hl[2 * h + 1]) + lh[2 * h + 1], p.amp, p.eps);
      if (with_dct) {
        store_split(f_hi, f_lo, r0 * ldf + col, v0, v1);
      } else if (r0 < tile_f && f0 + r0 < p.n_frames) {
        float* o = p.out + (static_cast<long long>(b) * n_rows + col) * p.n_frames + f0 + r0;
        if (col < p.n_out) o[0] = v0;
        if (col + 1 < p.n_out) o[p.n_frames] = v1;
      }
    }
  }
#ifdef TIER_CLOCKS
  __syncthreads();
  TIER_MARK(3)
#endif
  if (!with_dct) return;  // uniform across the block
  __syncthreads();

  // 5. DCT tail, dense.
  for (int item = warp; item < r_tiles * p.dct_ntiles; item += kWarps) {
    const int row0 = (item % r_tiles) * 16;
    const int nt = item / r_tiles;
    float hh[4] = {0.f, 0.f, 0.f, 0.f}, hl[4] = {0.f, 0.f, 0.f, 0.f},
          lh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int ks = 0; ks < p.kd / 16; ++ks) {
      const int bi = (ks * p.dct_ntiles + nt) * 32 + lane;
      const uint2 bh = __ldg(p.dct_hi + bi);
      uint32_t a[4];
      load_a(a, f_hi, ldf, row0, 16 * ks, lane);
      mma_bf16(hh, a, bh);
      if constexpr (X2) {
        mma_bf16(hl, a, __ldg(p.dct_lo + bi));
        load_a(a, f_lo, ldf, row0, 16 * ks, lane);
        mma_bf16(lh, a, bh);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r0 = row0 + g + 8 * (e >> 1);
      const int col = 8 * nt + 2 * tq + (e & 1);
      if (col < p.n_coef && r0 < tile_f && f0 + r0 < p.n_frames) {
        p.out[(static_cast<long long>(b) * n_rows + col) * p.n_frames + f0 + r0] =
            (hh[e] + hl[e]) + lh[e];
      }
    }
  }
#ifdef TIER_CLOCKS
  __syncthreads();
  TIER_MARK(4)
#endif
#endif
}

template <int R, bool X2, bool GAUSS>
int launch(const Params& p, int batch, int smem_bytes, void* stream) {
  auto kernel = fused_tier_features_kernel<R, X2, GAUSS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.n_frames + p.tile_f - 1) / p.tile_f, batch);
  kernel<<<grid, Block<R>::kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_tier(const Params& p, int x2, int gauss, int batch, int smem_bytes, void* stream) {
  if (x2) {
    return gauss ? launch<R, true, true>(p, batch, smem_bytes, stream)
                 : launch<R, true, false>(p, batch, smem_bytes, stream);
  }
  return gauss ? launch<R, false, true>(p, batch, smem_bytes, stream)
               : launch<R, false, false>(p, batch, smem_bytes, stream);
}

}  // namespace

// Launches on `stream` (a cudaStream_t) of the current device, which the
// caller sets to the tensors' device; allocates nothing and does not
// synchronise. The layout arguments (tile_f, staged, the groups, the
// shared-memory offsets and size) and the tables come from
// spectrograms_tpu_torch/ops/tier_layout.py. Returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.
extern "C" int fused_tier_features_launch(
    const float* x, const float* window, const void* twiddle, const void* rw_hi,
    const void* rw_lo, const void* g_hi, const void* g_lo, const void* items,
    const int* groups, const int* slots, const int* map_first, const int* map_ks, const void* map_hi,
    const void* map_lo, const void* dct_hi, const void* dct_lo, float* out, int batch,
    long long n, int log2n, int hop, int pad, int n_frames, int n_out, int n_coef,
    int map_ntiles, int dct_ntiles, int kc, int p_cols, int kd, int amp, int pre_amp, int x2, int gauss,
    int tile_f, int staged, int n_groups, int p_off, int feat_off, int ar_off, int ac_off,
    int smem_bytes, float eps, void* stream) {
  Params p;
  p.x = x;
  p.window = window;
  p.twiddle = static_cast<const float2*>(twiddle);
  p.rw_hi = static_cast<const uint2*>(rw_hi);
  p.rw_lo = static_cast<const uint2*>(rw_lo);
  p.g_hi = static_cast<const uint2*>(g_hi);
  p.g_lo = static_cast<const uint2*>(g_lo);
  p.items = static_cast<const int4*>(items);
  p.groups = groups;
  p.slots = slots;
  p.map_first = map_first;
  p.map_ks = map_ks;
  p.map_hi = static_cast<const uint2*>(map_hi);
  p.map_lo = static_cast<const uint2*>(map_lo);
  p.dct_hi = static_cast<const uint2*>(dct_hi);
  p.dct_lo = static_cast<const uint2*>(dct_lo);
  p.out = out;
  p.n = n;
  p.hop = hop;
  p.pad = pad;
  p.n_frames = n_frames;
  p.n_out = n_out;
  p.n_coef = n_coef;
  p.map_ntiles = map_ntiles;
  p.dct_ntiles = dct_ntiles;
  p.kc = kc;
  p.p_cols = p_cols;
  p.kd = kd;
  p.amp = amp;
  p.pre_amp = pre_amp;
  p.x2 = x2;
  p.gauss = gauss;
  p.tile_f = tile_f;
  p.staged = staged;
  p.n_groups = n_groups;
  p.p_off = p_off;
  p.feat_off = feat_off;
  p.ar_off = ar_off;
  p.ac_off = ac_off;
  p.eps = eps;
  switch (log2n) {
    case 8: return launch_tier<2>(p, x2, gauss, batch, smem_bytes, stream);
    case 9: return launch_tier<4>(p, x2, gauss, batch, smem_bytes, stream);
    case 10: return launch_tier<8>(p, x2, gauss, batch, smem_bytes, stream);
    case 11: return launch_tier<16>(p, x2, gauss, batch, smem_bytes, stream);
    case 12: return launch_tier<32>(p, x2, gauss, batch, smem_bytes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fused_tier_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef TIER_CLOCKS
// The counters into out[0..8); reset to zero after reading.
extern "C" int fused_tier_features_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_tier_clocks, sizeof(g_tier_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_tier_clocks, zero, sizeof(zero)));
}
#endif
