// One iteration of fast Griffin-Lim as one launch, for Hopper (sm_90a): gl_step.
//
// Replaces no Pallas kernel: the JAX package's reconstruct.py::griffin_lim runs
// its iteration as XLA ops (dense (i)rDFT products at float32, jnp.fft above
// 4096), and so did the port: at the TTS batch (32 x 220500 samples, 1024/256,
// 27,584 frames) an iteration was two dense float32 GEMMs against the [C | S]
// and [Ci; Si] matrices (~41x the arithmetic of an FFT) and ~37 elementwise
// launches, each reading and writing a 113 MB spectrum or frame tensor:
// 4.99 ms an iteration, 3.4 % of its bytes bound. This kernel was added for
// that step; its torch twin is reconstruct.py::griffin_lim_kernel_twin.
//
// What one launch computes (reconstruct.py::_kernel_run is the host loop; mode 1 and 2):
//   cand = rfft(w * frame_f(y_prev))                        every frame f
//   acc  = cand + momentum (cand - prev) ;  ri = mag acc / max(|acc|, 1e-16)
//   prev' = cand                                            (mode 2, the last: not stored)
//   y    = (sum_f irfft(ri_f) w shifted by f hop) * inv_norm
// and the start (mode 0): ri = prev' = mag (cos a, sin a) from the initial
// phase a, y = its overlap-add. inv_norm is 1 / the overlap-added w^2 where
// that exceeds 1e-10, else 1. The window, w / N (the irfft's 1/N), the
// twiddles and inv_norm are computed in float64 on the host and rounded to
// float32 once (reconstruct.py::_kernel_tables_np). Every product and sum is
// float32 on the FMA units: no tensor core, no TF32, no reduced precision.
//
// The real N-point transforms are M = N/2-point complex FFTs: the forward
// takes z[m] = x[2m] + i x[2m+1], then splits Z into the bins
//   X[k] = E + W^k O,  X[M-k] = conj(E - W^k O),
//   E = (Z[k] + conj Z[M-k]) / 2,  O = -i (Z[k] - conj Z[M-k]) / 2,  W = exp(-2 pi i / N);
// the inverse merges Z''[k] = (X[k] + conj X[M-k]) + i W^-k (X[k] - conj X[M-k])
// (the imaginary parts of X[0] and X[M] dropped, as irfft does), runs the
// inverse FFT and reads x[2m] + i x[2m+1] = z[m] / N. A lane holds both bins
// of the pairs (k, M-k) it splits, so the split, the projection and the merge
// never leave its registers. The FFTs are radix-4 Stockham steps (a radix-2
// step last when log2 M is odd), from csrc/mdct.cu's, ping-ponged between
// two buffers so that a step takes one barrier.
//
// What bounds it: bytes. At the TTS batch an iteration reads mag (56.6 MB),
// reads and writes prev as complex float32 (226 MB) and reads and writes the
// signal (~62 MB with the halo): ~345 MB, 0.10 ms at 3.35 TB/s, against
// ~1.4 GFLOP of FFTs (0.02 ms at 67 TFLOP/s). The design moves each byte once:
// - a team of M/4 threads computes one frame at a time (4 warps at N = 1024)
//   with its own barrier (a named barrier, __syncwarp, or a part of a warp);
// - a team's item is a run of hop-segments of one row and the frames that
//   start in them: it recomputes the k - 1 frames before its run (k = N/hop),
//   the halo, so that each output segment is written once, by one team, with
//   no atomics and the same result on every run; the launch sizes the run so
//   that the items fill the resident teams in as few rounds as it can;
// - the old signal's segments stream through a ring in shared memory by
//   cp.async, two segments ahead of the frame; each sample is read from
//   device memory once a team (the halo's k - 1 segments twice);
// - the overlap-add sums into a ring of k segments in shared memory, frame by
//   frame in frame order; a segment is scaled by inv_norm and stored once the
//   last frame that covers it is in;
// - everything a frame reads (its magnitude, its stored spectrum or initial
//   phase, the new segment of the old signal, the segment of 1/norm it
//   completes) is copied into shared memory by cp.async one frame ahead;
//   prev is read and written once a frame, mag read once; the previous
//   iteration's prev and signal are read from buffers other than those
//   written (the host loop ping-pongs them), since a halo frame of one team is
//   an owned frame of another;
// - the FFT buffers are swizzled (sw) so that the Stockham steps' strided
//   stores do not collide on the banks.
// On an H100 at the TTS batch an iteration takes 0.285 ms, 36 % of that
// bound; the two FFTs are about 45 % of it, the rest within 1.6x of the bytes
// bound (PERF.md, the kernel table).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOverlap = 16;  // the largest k = N / hop
constexpr int kMaxRun = 1024;    // the longest run of segments a team's item takes
constexpr int kDevices = 64;     // devices whose shared-memory limits are remembered

// The geometry at N = 2^kLogN: a team of N/8 threads a frame, a block of at
// least 256 threads.
template <int kLogN>
struct Geo {
  static constexpr int n = 1 << kLogN;
  static constexpr int m = n / 2;        // the complex FFT's points
  static constexpr int bins = m + 1;
  static constexpr int mag_stride = m + 4;   // floats a frame of mag or angles: 16-byte rows
  static constexpr int prev_stride = m + 2;  // complex values a frame of prev
  static constexpr int team = m / 4;     // one radix-4 butterfly a thread a step
  static constexpr int threads = team > 256 ? team : 256;
  static constexpr int teams = threads / team;
  // blocks of 256 threads an SM: three (80 registers a thread, a little
  // spilled; 70 KB of shared memory at N = 1024) ran 1 % faster on the H100
  // at the TTS batch than two (128 registers) and 8 % faster than four (64,
  // more spilled)
  static constexpr int min_blocks = threads > 256 ? 1 : 3;
  static constexpr int n4 = (kLogN - 1) / 2;  // radix-4 steps
  static constexpr bool odd = (kLogN - 1) & 1;
  static constexpr int steps = n4 + (odd ? 1 : 0);
  static_assert(n4 >= 2, "N >= 32");
  static_assert(team >= 64 || 32 % team == 0, "a team's lanes lie in one warp, or whole warps");
  static_assert(team < 64 || teams <= 15, "named barriers 1..teams");
  static_assert(threads <= 512 && teams * team == threads, "whole teams in a block");
};

// The signal ring's segments: a power of two holding the frame's k, the one
// in flight and the one being replaced.
__host__ __device__ inline int ring_segments(int k) {
  int r = 1;
  while (r < k + 2) r *= 2;
  return r;
}

// The team's barrier: its lanes of one warp, its warp, or a named barrier
// (ids 1..teams; 0 is the block's).
template <class G>
__device__ __forceinline__ void team_sync(int slot) {
  if constexpr (G::team >= 64) {
    asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "n"(G::team) : "memory");
  } else if constexpr (G::team == 32) {
    __syncwarp();
  } else {
    const unsigned first = (threadIdx.x & 31u) & ~static_cast<unsigned>(G::team - 1);
    __syncwarp(((1u << G::team) - 1u) << first);
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// (v0, v1, v2, v3) <- their 4-point DFT, X[k] = sum_r v[r] exp(-+2 pi i r k / 4)
// (the sign + for the inverse).
template <bool kInv>
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 a0 = cadd(v0, v2), a1 = csub(v0, v2), a2 = cadd(v1, v3), d = csub(v1, v3);
  // (v1 - v3) * -i forward, * i inverse
  const float2 a3 = kInv ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
  v0 = cadd(a0, a2);
  v1 = cadd(a1, a3);
  v2 = csub(a0, a2);
  v3 = csub(a1, a3);
}

// W_M^t, conjugated for the inverse.
template <bool kInv>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw, int t) {
  const float2 w = __ldg(tw + t);
  return kInv ? make_float2(w.x, -w.y) : w;
}

// Where complex value i of an FFT buffer lives: i with its bits 0-3 XORed
// with 5 times bits 4-5, a permutation within each aligned group of 16
// values (128 bytes, the 32 banks) under which the first two Stockham steps'
// stores (stride 4 and 16 values) hit 16 distinct bank pairs a half-warp, and
// every load of 16 neighbouring values stays conflict-free.
__device__ __forceinline__ int sw(int i) { return i ^ (((i >> 4) & 3) * 5); }

// The M-point FFT of one frame by the team (`lane` of G::team): input r of
// the first step is in(r), the point m = lane + r M/4; Stockham steps (radix
// 4, then radix 2 when log2 M is odd: step s reads v[j + r M/R], twiddles by
// W_M^(r (j mod Ns) M/(R Ns)), writes (j - j mod Ns) R + j mod Ns + r Ns);
// step s writes buf[(first + s) & 1] and reads what step s - 1 wrote, one
// barrier a step; the last step hands its outputs to out(r, k, X[k]) instead,
// r = 0..3 at k = lane + r M/4 (radix 4 last) or lane, lane + M/2, lane + M/4,
// lane + 3M/4 (radix 2 last). Ends with a barrier.
template <class G, bool kInv, class In, class Out>
__device__ __forceinline__ void fft(In in, Out out, float2* z0, float2* z1, int first,
                                    const float2* __restrict__ tw, int lane, int slot) {
  constexpr int q = G::team, m = G::m;
  float2* buf[2] = {z0, z1};
  {
    float2 v0 = in(0), v1 = in(1), v2 = in(2), v3 = in(3);
    dft4<kInv>(v0, v1, v2, v3);
    float2* dst = buf[first & 1];
    dst[sw(4 * lane)] = v0;
    dst[sw(4 * lane + 1)] = v1;
    dst[sw(4 * lane + 2)] = v2;
    dst[sw(4 * lane + 3)] = v3;
    team_sync<G>(slot);
  }
#pragma unroll
  for (int s = 1; s < G::n4; ++s) {
    const float2* src = buf[(first + s - 1) & 1];
    float2* dst = buf[(first + s) & 1];
    const int ns = 1 << (2 * s);
    float2 v0 = src[sw(lane)], v1 = src[sw(lane + q)], v2 = src[sw(lane + 2 * q)],
           v3 = src[sw(lane + 3 * q)];
    const int jm = lane & (ns - 1);
    const int stride = m / (4 * ns);
    v1 = cmul(v1, twiddle<kInv>(tw, jm * stride));
    v2 = cmul(v2, twiddle<kInv>(tw, 2 * jm * stride));
    v3 = cmul(v3, twiddle<kInv>(tw, 3 * jm * stride));
    dft4<kInv>(v0, v1, v2, v3);
    const int d = (lane - jm) * 4 + jm;
    if (s == G::n4 - 1 && !G::odd) {
      out(0, d, v0);
      out(1, d + ns, v1);
      out(2, d + 2 * ns, v2);
      out(3, d + 3 * ns, v3);
    } else {
      dst[sw(d)] = v0;
      dst[sw(d + ns)] = v1;
      dst[sw(d + 2 * ns)] = v2;
      dst[sw(d + 3 * ns)] = v3;
    }
    team_sync<G>(slot);
  }
  if constexpr (G::odd) {  // the radix-2 step, Ns = M/2: butterflies j = lane and lane + M/4
    const float2* src = buf[(first + G::n4 - 1) & 1];
    float2 a0 = src[sw(lane)], a1 = src[sw(lane + m / 2)], b0 = src[sw(lane + q)],
           b1 = src[sw(lane + q + m / 2)];
    a1 = cmul(a1, twiddle<kInv>(tw, lane));
    b1 = cmul(b1, twiddle<kInv>(tw, lane + q));
    out(0, lane, cadd(a0, a1));
    out(1, lane + m / 2, csub(a0, a1));
    out(2, lane + q, cadd(b0, b1));
    out(3, lane + q + m / 2, csub(b0, b1));
    team_sync<G>(slot);
  }
}

// The k at which the lane's r-th output of the last FFT step lands.
template <class G>
__device__ __forceinline__ int last_k(int lane, int r) {
  if constexpr (G::odd) return lane + (r & 1) * (G::m / 2) + (r >> 1) * G::team;
  return lane + r * G::team;
}

// The forward split of the pair (k, M-k): X[k] and X[M-k] from Z[k], Z[M-k]
// and w = W_N^k.
__device__ __forceinline__ void split(float2 zk, float2 zm, float2 w, float2& xk, float2& xm) {
  const float2 e = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
  const float2 o = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
  const float2 wo = cmul(w, o);
  xk = cadd(e, wo);
  xm = make_float2(e.x - wo.x, wo.y - e.y);
}

// The inverse merge of the pair (k, M-k): Z''[k] and Z''[M-k] from X[k] = a,
// X[M-k] = b and w = W_N^k.
__device__ __forceinline__ void merge(float2 a, float2 b, float2 w, float2& zk, float2& zm) {
  const float2 s = make_float2(a.x + b.x, a.y - b.y);        // a + conj b
  const float2 d = make_float2(a.x - b.x, a.y + b.y);        // a - conj b
  const float2 t = cmul(make_float2(w.x, -w.y), d);          // W^-k d
  zk = make_float2(s.x - t.y, s.y + t.x);                    // s + i t
  zm = make_float2(s.x + t.y, t.x - s.y);                    // conj s + i conj t
}

// ri of one bin: the momentum step from prev and the projection onto mag.
__device__ __forceinline__ float2 project(float2 cand, float2 prev, float mag, float momentum) {
  const float2 acc = make_float2(cand.x + momentum * (cand.x - prev.x),
                                 cand.y + momentum * (cand.y - prev.y));
  const float a = fmaxf(sqrtf(acc.x * acc.x + acc.y * acc.y), 1e-16f);
  return make_float2(mag * acc.x / a, mag * acc.y / a);
}

// tables (reconstruct.py::_kernel_tables_np): w (N), w / N (N), W_M^t (M
// complex), W_N^k for k = 0..M/2 (M/2 + 1 complex), 2 zeros, inv_norm (the
// row's samples); float32.
struct Tables {
  const float* w;
  const float* w_syn;
  const float2* tw;
  const float2* rs;
  const float* inv_norm;

  __device__ Tables(const float* t, int n) {
    w = t;
    w_syn = t + n;
    tw = reinterpret_cast<const float2*>(t + 2 * n);
    rs = reinterpret_cast<const float2*>(t + 3 * n);
    inv_norm = t + 3 * n + n / 2 + 4;
  }
};

// 16 bytes from device memory to shared memory, asynchronously.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most `kPending` of this thread's latest groups of copies are
// still in flight.
template <int kPending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// The bins of a lane: pairs (lane, M - lane) and (M/2 - lane, M/2 + lane);
// lane 0 holds (0, M), the lone bin M/2 (twice) and the pair (M/4, 3M/4).
template <class G>
__device__ __forceinline__ void bin_index(int lane, int (&k)[6]) {
  k[0] = lane;
  k[1] = G::m - lane;
  k[2] = G::m / 2 - lane;
  k[3] = G::m / 2 + lane;
  k[4] = G::m / 4;
  k[5] = 3 * G::m / 4;
}

// A team's shared floats: the old signal's ring (runtime: its segments and
// hop), the two FFT buffers, the overlap-add ring, and twice (one frame
// being computed, the next in flight) a frame's magnitude and its stored
// spectrum or initial phase, and a segment of 1/norm.
template <class G>
__host__ __device__ inline int team_floats(int hop) {
  return ring_segments(G::n / hop) * hop + 3 * G::n +
         2 * (G::mag_stride + 2 * G::prev_stride + hop);
}

// mode 0: start; 1: iterate; 2: iterate, the last (prev not stored).
//
// mag (rows, n_frames, M + 4), the bins then zeros; angles (start): (., n_frames,
// M + 4), row r at r * angle_stride; prev_in / prev_out (rows, n_frames, M + 2)
// complex; y_in / y_out (rows, (n_frames + k - 1) hop), hop-segments of the
// overlap-added signal. A team's item: segments [s0, s1) of row r (s0 = run
// times its index) and the frames [max(0, s0 - k + 1), min(s1, n_frames)),
// walked in order; step g of the walk computes frame g (if there is one) and
// stores segment g (if the run owns it), while the copies of what step g + 1
// reads are in flight: one group a step.
template <int kLogN>
__global__ void __launch_bounds__(Geo<kLogN>::threads, Geo<kLogN>::min_blocks)
gl_step(const float* __restrict__ mag, const float* __restrict__ angles, long long angle_stride,
        const float2* __restrict__ prev_in, float2* __restrict__ prev_out,
        const float* __restrict__ y_in, float* __restrict__ y_out,
        const float* __restrict__ tables, long long rows, int n_frames, int hop, float momentum,
        int mode, int run, int runs) {
  using G = Geo<kLogN>;
  constexpr int n = G::n, m = G::m, q = G::team, ms = G::mag_stride, ps = G::prev_stride;
  const int k = n / hop;
  const int segs = n_frames + k - 1;
  const long long len = static_cast<long long>(segs) * hop;
  const int ring = ring_segments(k) * hop;  // floats, a power of two
  const int vecs = hop / 4;                 // 16-byte vectors of a segment
  extern __shared__ __align__(16) float smem[];
  const int slot = threadIdx.x / q, lane = threadIdx.x % q;
  float* yring = smem + slot * team_floats<G>(hop);
  float2* z0 = reinterpret_cast<float2*>(yring + ring);
  float2* z1 = z0 + m;
  float* ola = reinterpret_cast<float*>(z1 + m);
  float* smag = ola + n;               // [2][ms]
  float* sspec = smag + 2 * ms;        // [2][2 ps]: prev (complex) or angles
  float* sinv = sspec + 4 * ps;        // [2][hop]
  float2* zf = G::steps & 1 ? z0 : z1;  // where the forward FFT leaves Z: buf[(steps - 1) & 1]
  const Tables t(tables, n);
  const bool start = mode == 0;

  int kb[6];
  bin_index<G>(lane, kb);
  const int nb = lane == 0 ? 6 : 4;
  // The lane's constants: the analysis window at its first-step inputs
  // x[2m], x[2m+1] (m = lane + r M/4), the synthesis window at its last-step
  // outputs, the split's twiddles.
  float2 wa[4], ws[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    wa[r] = __ldg(reinterpret_cast<const float2*>(t.w) + lane + r * q);
    ws[r] = __ldg(reinterpret_cast<const float2*>(t.w_syn) + last_k<G>(lane, r));
  }
  const float2 rs0 = __ldg(t.rs + lane), rs1 = __ldg(t.rs + m / 2 - lane),
               rs2 = __ldg(t.rs + m / 4);

  const long long items = rows * runs;
  for (long long item = static_cast<long long>(blockIdx.x) * G::teams + slot; item < items;
       item += static_cast<long long>(gridDim.x) * G::teams) {
    const long long r = item / runs;
    const int s0 = static_cast<int>(item - r * runs) * run;
    const int s1 = min(s0 + run, segs);
    const int fa = max(0, s0 - k + 1), fb = min(s1, n_frames);  // frames [fa, fb)
    const float* yrow = y_in + r * len;
    const int last_seg = fb + k - 2;  // the last segment the frames read
    // the copies step g reads: frame g's magnitude and stored spectrum (or
    // initial phase), segment g of 1/norm, and segment g + k - 1 of the old
    // signal (step fa: all of fa .. fa + k - 1)
    auto stage = [&](int g) {
      const int b = g & 1;
      if (!start) {
        for (int s = g == fa ? fa : g + k - 1; s <= g + k - 1 && s <= last_seg; ++s) {
          float* dst = yring + ((s * hop) & (ring - 1));
          const float* src = yrow + static_cast<long long>(s) * hop;
          for (int v = lane; v < vecs; v += q) copy16(dst + 4 * v, src + 4 * v);
        }
      }
      if (g < fb) {
        const long long fr = r * n_frames + g;
        for (int v = lane; v < ms / 4; v += q)
          copy16(smag + b * ms + 4 * v, mag + fr * ms + 4 * v);
        if (start) {
          const float* src = angles + r * angle_stride + static_cast<long long>(g) * ms;
          for (int v = lane; v < ms / 4; v += q) copy16(sspec + b * 2 * ps + 4 * v, src + 4 * v);
        } else {
          const float2* src = prev_in + fr * ps;
          for (int v = lane; v < ps / 2; v += q)
            copy16(sspec + b * 2 * ps + 4 * v, src + 2 * v);
        }
      }
      if (g >= s0 && g < s1) {
        const float* src = t.inv_norm + static_cast<long long>(g) * hop;
        for (int v = lane; v < vecs; v += q) copy16(sinv + b * hop + 4 * v, src + 4 * v);
      }
      copies_commit();
    };
    for (int i = lane; i < n / 4; i += q)
      reinterpret_cast<float4*>(ola)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    stage(fa);
    for (int g = fa; g < s1; ++g) {
      copies_wait<0>();  // what step g reads is in
      team_sync<G>(slot);
      if (g + 1 < s1) stage(g + 1);  // into the slots that step g - 1 read
      const int b = g & 1;
      if (g < fb) {  // frame g into the overlap-add ring
        const float* fmag = smag + b * ms;
        const float2* fspec = reinterpret_cast<const float2*>(sspec + b * 2 * ps);
        float2 v[6];
        if (start) {
          const float* fang = sspec + b * 2 * ps;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            if (i < nb) {
              float sn, cs;
              sincosf(fang[kb[i]], &sn, &cs);
              v[i] = make_float2(fmag[kb[i]] * cs, fmag[kb[i]] * sn);
            }
          }
          if (g >= s0) {
            float2* pout = prev_out + (r * n_frames + g) * ps;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              if (i < nb) pout[kb[i]] = v[i];
            }
          }
        } else {
          const int base = g * hop;
          auto in = [&](int e) {
            const float2 s = *reinterpret_cast<const float2*>(
                yring + ((base + 2 * (lane + e * q)) & (ring - 1)));
            return make_float2(s.x * wa[e].x, s.y * wa[e].y);
          };
          auto out = [&](int, int kk, float2 x) { zf[sw(kk)] = x; };
          fft<G, false>(in, out, z0, z1, 0, t.tw, lane, slot);
          // the split, then the projection, bin by bin
          split(zf[sw(kb[0])], zf[sw(kb[1] & (m - 1))], rs0, v[0], v[1]);
          split(zf[sw(kb[2])], zf[sw(kb[3])], rs1, v[2], v[3]);
          if (lane == 0) split(zf[sw(kb[4])], zf[sw(kb[5])], rs2, v[4], v[5]);
          float2* pout = prev_out + (r * n_frames + g) * ps;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            if (i < nb) {
              if (mode == 1 && g >= s0) pout[kb[i]] = v[i];
              v[i] = project(v[i], fspec[kb[i]], fmag[kb[i]], momentum);
            }
          }
        }
        if (lane == 0) {  // irfft reads the real parts of bins 0 and M only
          v[0].y = 0.f;
          v[1].y = 0.f;
        }
        // the merge, into the buffer the inverse FFT starts from
        float2 za, zb;
        merge(v[0], v[1], rs0, za, zb);
        zf[sw(kb[0])] = za;
        if (lane != 0) zf[sw(kb[1])] = zb;
        merge(v[2], v[3], rs1, za, zb);
        zf[sw(kb[2])] = za;
        if (lane != 0) zf[sw(kb[3])] = zb;
        if (lane == 0) {
          merge(v[4], v[5], rs2, za, zb);
          zf[sw(kb[4])] = za;
          zf[sw(kb[5])] = zb;
        }
        team_sync<G>(slot);
        const int base = (g * hop) & (n - 1);
        auto in = [&](int e) { return zf[sw(lane + e * q)]; };
        auto out = [&](int e, int kk, float2 x) {
          float2* o = reinterpret_cast<float2*>(ola + ((base + 2 * kk) & (n - 1)));
          float2 a = *o;
          a.x += x.x * ws[e].x;
          a.y += x.y * ws[e].y;
          *o = a;
        };
        fft<G, true>(in, out, z0, z1, G::steps & 1, t.tw, lane, slot);
      }
      // segment g is whole: stored if the run owns it, and its slot cleared
      float4* acc = reinterpret_cast<float4*>(ola + ((g * hop) & (n - 1)));
      const float4* inv = reinterpret_cast<const float4*>(sinv + b * hop);
      float4* dst = reinterpret_cast<float4*>(y_out + r * len + static_cast<long long>(g) * hop);
      for (int v = lane; v < vecs; v += q) {
        if (g >= s0) {
          const float4 a = acc[v], s = inv[v];
          dst[v] = make_float4(a.x * s.x, a.y * s.y, a.z * s.z, a.w * s.w);
        }
        acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    team_sync<G>(slot);
  }
}

// Raises `kernel`'s shared-memory limit to `smem_bytes` on `dev`, once: `set`
// (one per kernel) records what each device was given.
template <class K>
int prepare(K kernel, int smem_bytes, int dev, int (&set)[kDevices]) {
  if (smem_bytes <= 48 * 1024 || (dev < kDevices && set[dev] >= smem_bytes)) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess && dev < kDevices) set[dev] = smem_bytes;
  return static_cast<int>(e);
}

// The run of segments a team's item takes: of the runs that cover a row,
// the one whose items (rows x runs) fill `teams` resident teams in the
// fewest frame-times, each round costing the run, its k - 1 halo frames and
// the copies staged before the first frame.
int run_length(long long rows, int segs, int k, long long teams) {
  int best = 1;
  long long best_cost = -1;
  const int top = segs < kMaxRun ? segs : kMaxRun;
  for (int run = 1; run <= top; ++run) {
    const long long items = rows * ((segs + run - 1) / run);
    const long long cost = ((items + teams - 1) / teams) * (run + k);
    if (best_cost < 0 || cost < best_cost) {
      best = run;
      best_cost = cost;
    }
  }
  return best;
}

template <int kLogN>
int launch(const float* mag, const float* angles, long long angle_stride, const float2* prev_in,
           float2* prev_out, const float* y_in, float* y_out, const float* tables,
           long long rows, int n_frames, int hop, float momentum, int mode,
           cudaStream_t stream) {
  using G = Geo<kLogN>;
  const int k = G::n / hop;
  const int smem_bytes = 4 * G::teams * team_floats<G>(hop);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int set[kDevices] = {};
  const int rc = prepare(gl_step<kLogN>, smem_bytes, dev, set);
  if (rc != 0) return rc;
  // resident blocks an SM at this shared memory, remembered for the last size asked
  static int occ_dev = -1, occ_smem = -1, occ_blocks = 0;
  if (occ_dev != dev || occ_smem != smem_bytes) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, gl_step<kLogN>, G::threads,
                                                      smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    occ_dev = dev;
    occ_smem = smem_bytes;
  }
  const int per_sm = occ_blocks > 0 ? occ_blocks : 1;
  const int segs = n_frames + k - 1;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int run = run_length(rows, segs, k, resident * G::teams);
  const int runs = (segs + run - 1) / run;
  const long long want = (rows * runs + G::teams - 1) / G::teams;
  const int grid = static_cast<int>(want < resident ? want : resident);
  gl_step<kLogN><<<grid, G::threads, smem_bytes, stream>>>(
      mag, angles, angle_stride, prev_in, prev_out, y_in, y_out, tables, rows, n_frames, hop,
      momentum, mode, run, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch: mode 0 (start) reads mag and angles and writes prev_out and
// y_out; mode 1 reads mag, prev_in and y_in and writes prev_out and y_out;
// mode 2 as 1 without prev_out. n_fft a power of two from 64 to 4096, hop =
// n_fft / k with k a power of two up to 16, rows of fewer than 2**31
// samples; every pointer 16-byte aligned. Launches on `stream` of the
// current device; returns a cudaError_t.
extern "C" int griffin_lim_launch(const void* mag, const void* angles, long long angle_stride,
                                  const void* prev_in, void* prev_out, const void* y_in,
                                  void* y_out, const void* tables, long long rows, int n_frames,
                                  int n_fft, int hop, float momentum, int mode, void* stream) {
  if (mode < 0 || mode > 2 || hop <= 0 || n_fft % hop != 0 || n_fft / hop > kMaxOverlap ||
      (n_fft / hop & (n_fft / hop - 1)) != 0 || n_frames <= 0 || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* mg = static_cast<const float*>(mag);
  const auto* an = static_cast<const float*>(angles);
  const auto* pin = static_cast<const float2*>(prev_in);
  auto* po = static_cast<float2*>(prev_out);
  const auto* yi = static_cast<const float*>(y_in);
  auto* yo = static_cast<float*>(y_out);
  const auto* t = static_cast<const float*>(tables);
#define GL_CASE(LOGN)                                                                        \
  case 1 << LOGN:                                                                            \
    return launch<LOGN>(mg, an, angle_stride, pin, po, yi, yo, t, rows, n_frames, hop,        \
                        momentum, mode, s);
  switch (n_fft) {
    GL_CASE(6)
    GL_CASE(7)
    GL_CASE(8)
    GL_CASE(9)
    GL_CASE(10)
    GL_CASE(11)
    GL_CASE(12)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GL_CASE
}

extern "C" const char* griffin_lim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
