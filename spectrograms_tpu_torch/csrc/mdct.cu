// MDCT and IMDCT of frames of 2N samples at hop N (50 % overlap, TDAC), one
// launch each direction, for Hopper (sm_90a): mdct_forward and mdct_inverse.
//
// Replaces no Pallas kernel: the JAX package's mdct.py computes the MDCT with
// XLA ops, a dense (2N x N) basis product, because on the TPU the folded form
// below, as many small elementwise ops around a matrix unit, ran 2.5x slower
// than the dense product at config 4's shapes. The port's plain version is the
// same dense product (ops/framing.py::framed_matmul forward,
// ops/ola.py::ola_matmul inverse): at config 4's batch (64 x 220500, N = 256)
// that is 28.9 GFLOP of float32 GEMMs a round trip, 8-16x the arithmetic the
// transform needs, and their pads and adds besides.
//
// What it computes (mdct.py::_folded_consts has the identities; the torch twin
// of exactly this factorization is mdct.py::mdct_kernel_twin and
// imdct_kernel_twin). With h = N/2, M = N/2 and w the window:
//   forward, frame s[0, 2N):  the TDAC fold
//     u[i]     = -s[N+h-1-i] w[N+h-1-i] - s[N+h+i] w[N+h+i]      (i < h)
//     u[h+i]   =  s[i] w[i] - s[N-1-i] w[N-1-i]
//   then the DCT-IV C[k] = sum_n u[n] cos(pi (2n+1)(2k+1) / (4N)) as
//     z[m] = (u[2m] + i u[N-1-2m]) pre[m],      pre[m]  = exp(-i pi m / N)
//     Y[k] = post[k] FFT_M(z)[k],               post[k] = exp(-i pi (k + 1/4) / N)
//     C[2k] = Re Y[k],  C[N-1-2k] = -Im Y[k];
//   inverse: v = (2/N) DCT-IV(C) (the same transform, 2/N folded into its post
//   twiddle), each frame unfolded as [v2, -rev(v2), -rev(v1), -v1] w
//   (v = [v1 | v2]) and overlap-added: output hop-block b is the second half
//   of frame b-1 plus the first half of frame b, hop*(n_frames-1) + 2N samples.
// The window and the twiddles are computed in float64 on the host and rounded
// to float32 once (mdct.py::_kernel_tables). Every product and sum is float32
// on the FMA units: no tensor core, no TF32.
//
// What bounds it: bytes. At config 4's batch each direction reads 56.4 MB and
// writes 56.4 MB, 0.034 ms at 3.35 TB/s, against ~6-8 k flops a frame
// (55,040 frames, ~0.4 GFLOP). The design moves each byte once and keeps the
// teams that compute independent of each other:
// - a team of M/4 threads transforms one frame at a time (one warp at
//   N = 256): it runs the M-point FFT as radix-4 Stockham steps (one radix-2
//   step last when log2 M is odd) in its own shared memory, each thread one
//   4-point butterfly a step, with the team's own barrier (__syncwarp, or a
//   named barrier for teams of several warps), never the block's;
// - a team owns a run of consecutive frames of one row and walks it in order;
//   the frames' geometry is a template parameter (N), so every index is a
//   constant, and the launch derives the block, its shared memory and the
//   grid from N alone; blocks are persistent, each team taking runs in turn;
// - forward: the team keeps the frame's two hop-blocks of samples in a ring
//   and reads each hop-block of the run from device memory once, as 16-byte
//   vectors, the next one fetched into registers while the current frame is
//   transformed (frames overlap by half, so a sample is read once, not
//   twice); it folds straight out of the ring into the first FFT step, the
//   last step writes the post-twiddled coefficients, and the team stores the
//   frame's N coefficients as 16-byte vectors;
// - inverse: the team recomputes the DCT-IV of the frame before its run (the
//   halo, not exchanged), keeps the previous frame's output, and writes each
//   output hop-block as the second half of frame b-1 plus the first half of
//   frame b: every output sample exactly once, no atomics, the same result on
//   every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Hop-blocks (forward) or frames (inverse) a team's ring holds: the two a
// frame reads, and two more in flight from device memory while it is
// transformed.
constexpr int kRing = 4;
static_assert((kRing & (kRing - 1)) == 0, "slots are indexed by b & (kRing - 1)");

// Frames (forward) or output hop-blocks (inverse) of one row a team walks in a
// row: the inverse recomputes one halo frame a run.
constexpr int kRun = 8;

constexpr int kDevices = 64;  // devices whose shared-memory limits are remembered

// The geometry at N = 2^kLogN: a team of N/8 threads a frame, a block of at
// least 256 threads.
template <int kLogN>
struct Geo {
  static constexpr int n = 1 << kLogN;
  static constexpr int h = n / 2;            // a quarter of the frame
  static constexpr int m = n / 2;            // the FFT's points
  static constexpr int team = m / 4;         // threads a frame: one radix-4 butterfly each
  static constexpr int threads = team > 256 ? team : 256;
  static constexpr int teams = threads / team;
  // blocks an SM: two of 256 threads (at most 128 registers a thread; three,
  // at 85, ran 5 % slower at N = 256 on the H100), or one of 512
  static constexpr int min_blocks = threads > 256 ? 1 : 2;
  static constexpr int n4 = (kLogN - 1) / 2;  // radix-4 steps
  static constexpr bool odd = (kLogN - 1) & 1;
  static constexpr int vecs = n / 4;         // 16-byte vectors of a hop-block
  static constexpr int fetch = (vecs + 1 + team - 1) / team;  // a lane's vectors of a hop-block
  // shared floats of a team: a ring of kRing hop-blocks (N + 4 each) and N of
  // scratch (forward); a ring of kRing frames of coefficients, two of v and N
  // of scratch (inverse)
  static constexpr int fwd_floats = kRing * (n + 4) + n;
  static constexpr int inv_floats = (kRing + 3) * n;
  static_assert(team >= 64 || 32 % team == 0, "a team's lanes lie in one warp, or whole warps");
  static_assert(team < 64 || teams <= 15, "named barriers 1..teams");
  static_assert(threads <= 512 && teams * team == threads, "whole teams in a block");
  static_assert(4 * teams * (fwd_floats > inv_floats ? fwd_floats : inv_floats) <= 232448,
                "a block's shared memory within the SM's 227 KB");
};

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

// (v0, v1, v2, v3) <- their 4-point DFT, X[k] = sum_r v[r] exp(-2 pi i r k / 4).
__device__ __forceinline__ void dft4(float2& v0, float2& v1, float2& v2, float2& v3) {
  const float2 a0 = make_float2(v0.x + v2.x, v0.y + v2.y);
  const float2 a1 = make_float2(v0.x - v2.x, v0.y - v2.y);
  const float2 a2 = make_float2(v1.x + v3.x, v1.y + v3.y);
  const float2 a3 = make_float2(v1.y - v3.y, v3.x - v1.x);  // (v1 - v3) * -i
  v0 = make_float2(a0.x + a2.x, a0.y + a2.y);
  v1 = make_float2(a1.x + a3.x, a1.y + a3.y);
  v2 = make_float2(a0.x - a2.x, a0.y - a2.y);
  v3 = make_float2(a1.x - a3.x, a1.y - a3.y);
}

// An FFT step's output X[k]: into the scratch z, or, from the last step, the
// DCT-IV outputs c[2k] = Re(X[k] post[k]) and c[N-1-2k] = -Im(X[k] post[k]).
template <class G, bool kLast>
__device__ __forceinline__ void put(float2* z, float* c, float2 post, int k, float2 x) {
  if constexpr (kLast) {
    const float2 y = cmul(x, post);
    c[2 * k] = y.x;
    c[G::n - 1 - 2 * k] = -y.y;
  } else {
    z[k] = x;
  }
}

// The k at which the lane's r-th output of the last FFT step lands (its post
// twiddle's index): lane + r M/4, or for a radix-2 last step lane, lane + M/2,
// lane + M/4, lane + 3M/4.
template <class G>
__device__ __forceinline__ int last_k(int lane, int r) {
  if constexpr (G::odd) return lane + (r & 1) * (G::m / 2) + (r >> 1) * G::team;
  return lane + r * G::team;
}

// The DCT-IV of one frame by the team (`lane` of G::team): z[m] = in(r) for
// m = lane + r M/4, the pre-twiddled input; its M-point FFT by Stockham steps
// (radix 4, then radix 2 when log2 M is odd: step s reads v[j + r M/R],
// twiddles by W_M^(r (j mod Ns) M/(R Ns)), writes (j - j mod Ns) R + j mod Ns
// + r Ns); the last step through the post twiddle (`post[r]` at last_k) into
// c, which may overlay z: each step reads everything before the barrier that
// precedes its writes. `after` runs once step 0 has read the input, for the
// next frame's staging.
template <class G, class In, class After>
__device__ __forceinline__ void dct4(In in, After after, float2* z, float* c,
                                     const float2 (&post)[4], const float2* __restrict__ tw,
                                     int lane, int slot) {
  constexpr int q = G::team, m = G::m;
  {
    float2 v0 = in(0), v1 = in(1), v2 = in(2), v3 = in(3);
    dft4(v0, v1, v2, v3);
    constexpr bool last = G::n4 == 1 && !G::odd;
    put<G, last>(z, c, post[0], 4 * lane, v0);
    put<G, last>(z, c, post[1], 4 * lane + 1, v1);
    put<G, last>(z, c, post[2], 4 * lane + 2, v2);
    put<G, last>(z, c, post[3], 4 * lane + 3, v3);
    team_sync<G>(slot);
  }
  after();
#pragma unroll
  for (int s = 1; s < G::n4; ++s) {
    const int ns = 1 << (2 * s);
    float2 v0 = z[lane], v1 = z[lane + q], v2 = z[lane + 2 * q], v3 = z[lane + 3 * q];
    team_sync<G>(slot);
    const int jm = lane & (ns - 1);
    const int stride = m / (4 * ns);
    v1 = cmul(v1, __ldg(tw + jm * stride));
    v2 = cmul(v2, __ldg(tw + 2 * jm * stride));
    v3 = cmul(v3, __ldg(tw + 3 * jm * stride));
    dft4(v0, v1, v2, v3);
    const int d = (lane - jm) * 4 + jm;
    if (s == G::n4 - 1 && !G::odd) {
      put<G, true>(z, c, post[0], d, v0);
      put<G, true>(z, c, post[1], d + ns, v1);
      put<G, true>(z, c, post[2], d + 2 * ns, v2);
      put<G, true>(z, c, post[3], d + 3 * ns, v3);
    } else {
      put<G, false>(z, c, post[0], d, v0);
      put<G, false>(z, c, post[1], d + ns, v1);
      put<G, false>(z, c, post[2], d + 2 * ns, v2);
      put<G, false>(z, c, post[3], d + 3 * ns, v3);
    }
    team_sync<G>(slot);
  }
  if constexpr (G::odd) {  // the radix-2 step, Ns = M/2: butterflies j = lane and lane + M/4
    float2 a0 = z[lane], a1 = z[lane + m / 2], b0 = z[lane + q], b1 = z[lane + q + m / 2];
    team_sync<G>(slot);
    a1 = cmul(a1, __ldg(tw + lane));
    b1 = cmul(b1, __ldg(tw + lane + q));
    put<G, true>(z, c, post[0], lane, make_float2(a0.x + a1.x, a0.y + a1.y));
    put<G, true>(z, c, post[1], lane + m / 2, make_float2(a0.x - a1.x, a0.y - a1.y));
    put<G, true>(z, c, post[2], lane + q, make_float2(b0.x + b1.x, b0.y + b1.y));
    put<G, true>(z, c, post[3], lane + q + m / 2, make_float2(b0.x - b1.x, b0.y - b1.y));
    team_sync<G>(slot);
  }
}

// tables: w (2N floats), then pre, post, (2/N) post and the FFT's W_M^t, M
// complex values each (mdct.py::_kernel_tables).
struct Tables {
  const float* w;
  const float2* pre;
  const float2* post;
  const float2* post_inv;
  const float2* tw;

  __device__ Tables(const float* t, int n) {
    const int m = n / 2;
    w = t;
    pre = reinterpret_cast<const float2*>(t + 2 * n);
    post = pre + m;
    post_inv = pre + 2 * m;
    tw = pre + 3 * m;
  }
};

// 16 bytes from device memory to shared memory, asynchronously: `bytes` of
// them read (0 to 16), the rest zeros.
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
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

// The lane's copies of hop-block b of a row into a ring slot (`mis`: the
// row's float offset in its 16-byte vector): vector v holds the row's samples
// b N + 4 v - mis + 0..3 and lands at slot[4 v], so sample j of the block is
// at slot[mis + j]; samples at or past `length` are zeros. Only a vector
// holding a sample of the row is read: an aligned 16-byte vector never leaves
// the page, nor the allocation, of that sample.
template <class G>
__device__ __forceinline__ void copy_block(float* slot_buf, const float* row, int mis,
                                           long long length, int b, int lane) {
  const int nv = G::vecs + (mis > 0);
#pragma unroll
  for (int k = 0; k < G::fetch; ++k) {
    const int v = lane + k * G::team;
    if (v < nv) {
      const long long j0 = static_cast<long long>(b) * G::n + 4 * v - mis;
      const long long valid = length - j0;
      const int bytes = valid >= 4 ? 16 : valid > 0 ? static_cast<int>(valid) * 4 : 0;
      // a vector wholly past the row reads nothing, from an aligned address
      copy16(slot_buf + 4 * v, bytes > 0 ? row + j0 : row - mis, bytes);
    }
  }
}

// x (rows, length) -> out (rows, n_frames, N). A team's item is a run of
// kRun frames of one row: frame f reads hop-blocks f and f + 1 of the
// team's ring, whose slot b % kRing holds hop-block b, while hop-blocks
// f + 2 and f + 3 are in flight.
template <int kLogN>
__global__ void __launch_bounds__(Geo<kLogN>::threads, Geo<kLogN>::min_blocks)
mdct_forward(const float* __restrict__ x, float* __restrict__ out,
             const float* __restrict__ tables, long long rows, int length, int n_frames,
             int runs) {
  using G = Geo<kLogN>;
  constexpr int n = G::n, h = G::h, team = G::team, ring = n + 4;
  extern __shared__ __align__(16) float smem[];
  const int slot = threadIdx.x / team, lane = threadIdx.x % team;
  float* buf = smem + slot * G::fwd_floats;
  float2* z = reinterpret_cast<float2*>(buf + kRing * ring);
  const Tables t(tables, n);
  // The lane's constants, the same for every frame: input r (k = lane + r M/4)
  // folds u(2k) and u(N-1-2k), each two windowed samples; for r < 2 u(2k) reads
  // the second hop-block at h-1-2k, h+2k and u(N-1-2k) the first at h-1-2k,
  // h+2k; for r >= 2 u(2k) reads the first at 2k-h, N+h-1-2k and u(N-1-2k) the
  // second at h+2k-N, N+h-1-2k.
  float wa[4], wb[4], wc[4], wd[4];
  float2 pre[4], post[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = lane + r * team;
    if (r < 2) {
      wa[r] = __ldg(t.w + n + h - 1 - 2 * k);
      wb[r] = __ldg(t.w + n + h + 2 * k);
      wc[r] = __ldg(t.w + h - 1 - 2 * k);
      wd[r] = __ldg(t.w + h + 2 * k);
    } else {
      wa[r] = __ldg(t.w + 2 * k - h);
      wb[r] = __ldg(t.w + n + h - 1 - 2 * k);
      wc[r] = __ldg(t.w + h + 2 * k);
      wd[r] = __ldg(t.w + 2 * n + h - 1 - 2 * k);
    }
    pre[r] = __ldg(t.pre + k);
    post[r] = __ldg(t.post + last_k<G>(lane, r));
  }
  const long long items = rows * runs;
  for (long long item = static_cast<long long>(blockIdx.x) * G::teams + slot; item < items;
       item += static_cast<long long>(gridDim.x) * G::teams) {
    const long long r = item / runs;
    const int f0 = static_cast<int>(item - r * runs) * kRun;
    const int f1 = min(f0 + kRun, n_frames);
    const float* row = x + r * length;
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
    // hop-blocks f0 .. f1 are read; one group of copies a hop-block, empty past f1
#pragma unroll
    for (int b = 0; b < kRing; ++b) {
      if (f0 + b <= f1)
        copy_block<G>(buf + ((f0 + b) & (kRing - 1)) * ring, row, mis, length, f0 + b, lane);
      copies_commit();
    }
    for (int f = f0; f < f1; ++f) {
      copies_wait<kRing - 2>();  // hop-blocks f and f + 1 are in
      team_sync<G>(slot);
      // samples f N .. f N + N, and f N + N .. f N + 2N
      const float* s0 = buf + (f & (kRing - 1)) * ring + mis;
      const float* s1 = buf + ((f + 1) & (kRing - 1)) * ring + mis;
      auto in = [&](int e) {
        const int k = lane + e * team;
        float u0, u1;
        if (e < 2) {
          u0 = -(s1[h - 1 - 2 * k] * wa[e]) - s1[h + 2 * k] * wb[e];
          u1 = s0[h - 1 - 2 * k] * wc[e] - s0[h + 2 * k] * wd[e];
        } else {
          u0 = s0[2 * k - h] * wa[e] - s0[n + h - 1 - 2 * k] * wb[e];
          u1 = -(s1[h + 2 * k - n] * wc[e]) - s1[n + h - 1 - 2 * k] * wd[e];
        }
        return cmul(make_float2(u0, u1), pre[e]);
      };
      auto after = [&] {  // hop-block f is read: its slot takes hop-block f + kRing
        if (f + kRing <= f1)
          copy_block<G>(buf + (f & (kRing - 1)) * ring, row, mis, length, f + kRing, lane);
        copies_commit();
      };
      dct4<G>(in, after, z, reinterpret_cast<float*>(z), post, t.tw, lane, slot);
      float4* dst = reinterpret_cast<float4*>(out + (r * n_frames + f) * n);
      const float4* src = reinterpret_cast<const float4*>(z);
#pragma unroll
      for (int i = lane; i < G::vecs; i += team) dst[i] = src[i];
      team_sync<G>(slot);
    }
  }
}

// coef (rows, n_frames, N), 16-byte aligned -> out (rows, (n_frames + 1) N).
// A team's item is a run of kRun output hop-blocks [b0, b1) of one row, from
// frames b0-1 .. b1-1 (the halo frame b0-1 recomputed; frames outside
// [0, n_frames) are zeros). The team's ring slot g % kRing holds frame g's
// coefficients, frames g + 1 .. g + 3 in flight while g is transformed; two
// frames of v (the previous frame's and this one's) and N floats of scratch.
template <int kLogN>
__global__ void __launch_bounds__(Geo<kLogN>::threads, Geo<kLogN>::min_blocks)
mdct_inverse(const float* __restrict__ coef, float* __restrict__ out,
             const float* __restrict__ tables, long long rows, int n_frames, int runs) {
  using G = Geo<kLogN>;
  constexpr int n = G::n, h = G::h, team = G::team;
  static_assert(G::vecs == 2 * G::team, "two vectors a lane a frame");
  extern __shared__ __align__(16) float smem[];
  const int slot = threadIdx.x / team, lane = threadIdx.x % team;
  float* cring = smem + slot * G::inv_floats;
  float* vring = cring + kRing * n;
  float2* z = reinterpret_cast<float2*>(vring + 2 * n);
  const Tables t(tables, n);
  // The lane's constants: input r reads coefficients 2k and N-1-2k (k = lane
  // + r M/4); output vector i = lane + e team (e < 2) is p = 4i .. 4i+3 of a
  // hop-block, each the second half of the previous frame times w[N + p] plus
  // the first half of this one times w[p].
  float2 pre[4], post[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    pre[r] = __ldg(t.pre + lane + r * team);
    post[r] = __ldg(t.post_inv + last_k<G>(lane, r));
  }
  float4 w_first[2], w_second[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = lane + e * team;
    w_first[e] = __ldg(reinterpret_cast<const float4*>(t.w) + i);
    w_second[e] = __ldg(reinterpret_cast<const float4*>(t.w + n) + i);
  }
  const long long out_len = static_cast<long long>(n_frames + 1) * n;
  const long long items = rows * runs;
  for (long long item = static_cast<long long>(blockIdx.x) * G::teams + slot; item < items;
       item += static_cast<long long>(gridDim.x) * G::teams) {
    const long long r = item / runs;
    const int b0 = static_cast<int>(item - r * runs) * kRun;
    const int b1 = min(b0 + kRun, n_frames + 1);
    const float* frames = coef + r * n_frames * n;
    // frame g's copies: its two vectors a lane, zeros outside [0, n_frames)
    auto copy_frame = [&](int g) {
      const bool in_row = g >= 0 && g < n_frames;
      float* dst = cring + (g & (kRing - 1)) * n;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = lane + e * team;
        copy16(dst + 4 * i, in_row ? frames + static_cast<long long>(g) * n + 4 * i : frames,
               in_row ? 16 : 0);
      }
    };
#pragma unroll
    for (int j = 0; j < kRing; ++j) {
      if (b0 - 1 + j < b1) copy_frame(b0 - 1 + j);
      copies_commit();
    }
    for (int g = b0 - 1; g < b1; ++g) {
      copies_wait<kRing - 1>();  // frame g is in
      team_sync<G>(slot);
      const float* cb = cring + (g & (kRing - 1)) * n;
      float* vprev = vring + (g & 1) * n;
      float* vcur = vring + ((g + 1) & 1) * n;
      auto in = [&](int e) {
        const int k = lane + e * team;
        return cmul(make_float2(cb[2 * k], cb[n - 1 - 2 * k]), pre[e]);
      };
      auto after = [&] {  // frame g is read: its slot takes frame g + kRing
        if (g + kRing < b1) copy_frame(g + kRing);
        copies_commit();
      };
      dct4<G>(in, after, z, vcur, post, t.tw, lane, slot);
      if (g >= b0) {  // hop-block g: the second half of frame g-1, the first half of frame g
        float4* dst =
            reinterpret_cast<float4*>(out + r * out_len + static_cast<long long>(g) * n);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = lane + e * team;
          float o[4];
          const float* ws = &w_second[e].x;
          const float* wf = &w_first[e].x;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = 4 * i + k;
            const float prev = (p < h ? -vprev[h - 1 - p] : -vprev[p - h]) * ws[k];
            const float cur = (p < h ? vcur[h + p] : -vcur[n - 1 - p + h]) * wf[k];
            o[k] = prev + cur;
          }
          dst[i] = make_float4(o[0], o[1], o[2], o[3]);
        }
      }
      team_sync<G>(slot);
    }
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

template <int kLogN>
int launch(const void* in, void* out, const float* tables, long long rows, int length,
           int n_frames, int inverse, cudaStream_t stream) {
  using G = Geo<kLogN>;
  const int smem_bytes = 4 * G::teams * (inverse ? G::inv_floats : G::fwd_floats);
  const long long runs = ((inverse ? n_frames + 1LL : n_frames) + kRun - 1) / kRun;
  // persistent blocks: as many as can be resident at once, at most one a team's item
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long want = (rows * runs + G::teams - 1) / G::teams;
  const int grid = static_cast<int>(want < sms * G::min_blocks ? want : sms * G::min_blocks);
  static int fwd_set[kDevices] = {}, inv_set[kDevices] = {};
  int rc;
  if (inverse == 0) {
    rc = prepare(mdct_forward<kLogN>, smem_bytes, dev, fwd_set);
    if (rc != 0) return rc;
    mdct_forward<kLogN><<<grid, G::threads, smem_bytes, stream>>>(
        static_cast<const float*>(in), static_cast<float*>(out), tables, rows, length,
        n_frames, static_cast<int>(runs));
  } else {
    rc = prepare(mdct_inverse<kLogN>, smem_bytes, dev, inv_set);
    if (rc != 0) return rc;
    mdct_inverse<kLogN><<<grid, G::threads, smem_bytes, stream>>>(
        static_cast<const float*>(in), static_cast<float*>(out), tables, rows, n_frames,
        static_cast<int>(runs));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// inverse 0: in = x (rows, length), out = (rows, n_frames, N);
// inverse 1: in = coefficients (rows, n_frames, N), 16-byte aligned,
// out = (rows, (n_frames + 1) N). N a power of two from 8 to 4096; `length`
// is read by the forward only. Launches on `stream` of the current device;
// returns a cudaError_t.
extern "C" int mdct_launch(const void* in, void* out, const void* tables, long long rows,
                           int length, int n_frames, int n, int inverse, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tables);
  if (inverse != 0 && inverse != 1) return static_cast<int>(cudaErrorInvalidValue);
#define MDCT_CASE(LOGN)                                                                      \
  case 1 << LOGN:                                                                            \
    return launch<LOGN>(in, out, t, rows, length, n_frames, inverse, s);
  switch (n) {
    MDCT_CASE(3)
    MDCT_CASE(4)
    MDCT_CASE(5)
    MDCT_CASE(6)
    MDCT_CASE(7)
    MDCT_CASE(8)
    MDCT_CASE(9)
    MDCT_CASE(10)
    MDCT_CASE(11)
    MDCT_CASE(12)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MDCT_CASE
}

extern "C" const char* mdct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
