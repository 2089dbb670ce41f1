"""Plain reference of ``music_cqt84``: CQT-84 power, the multirate chromagram
and the MDCT/IMDCT round trip over one shared decimation cascade.

Written from the definitions that the configuration states, in plain PyTorch;
it imports nothing of the program and builds its own taps, kernels, window,
filterbank and bases:

- cascade: the signal zero-padded by ``n_fft // 2`` each side, then decimated
  by 4 per stage, each stage one zero-phase FIR equal to two cascaded
  half-band filters (63 taps, Kaiser β = 9, centre tap ½, even taps 0, unit
  DC gain), samples outside the signal taken as zeros;
- CQT: the octave-stacked, untruncated constant-Q transform: bin ``b`` at
  ``f_min·2^(b/12)``, ``Q = 1/(2^(1/12) − 1)``, computed at rate ``sr/2^d``
  for the depth ``d`` that the configuration's rule gives it (``cqt_depths``);
  its kernel is ``round(Q·sr_d/f)`` samples of a symmetric Hann times
  ``exp(2πi·f·t)``, entries under 1 % of the peak zeroed, scaled to unit
  energy, right-aligned on the frame's end and scaled by ``√2^d``; the
  output is ``|Σ x·conj(k)|²``;
- chroma: the magnitude STFT of the cascade's level ``d_c`` (``n_fft/2^d_c``
  points, hop ``hop/2^d_c``, the full-rate symmetric Hann taken every
  ``2^d_c``-th point), times ``2^d_c``, through Gaussian pitch-class weights
  (σ one semitone, A4 = 440 Hz, 32.7–4186 Hz, each class's row summed to 1),
  each frame scaled to unit L2 norm over the 12 classes;
- MDCT round trip: frames of ``window_size`` at hop ``window_size/2``, the
  sine window, ``X_k = Σ x·w·cos(π(2m + 1 + N)(2k + 1)/(4N))``, back by
  ``(2/N)·Σ_k X_k·cos(…)·w`` and overlap-add, cut to the input's length.

``outputs(..., tf32=True)`` is the control: the same in float32, each
product's operands rounded to TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness.judge import rel_err
from harness.precision import tf32_round

PASSBAND_FRAC = 0.80  # the half-band stage is flat to ~2e-5 below 0.8 of the decimated Nyquist


def hann(n: int) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


def halfband() -> np.ndarray:
    n = np.arange(-31, 32, dtype=np.float64)
    h = 0.5 * np.sinc(n / 2.0) * np.kaiser(63, 9.0)
    h[(n % 2 == 0) & (n != 0)] = 0.0
    return h / h.sum()


def stage4_taps() -> np.ndarray:
    """Two half-band stages as one FIR at the higher rate: h ⊛ (h upsampled by 2)."""
    h = halfband()
    up = np.zeros(2 * (h.size - 1) + 1)
    up[::2] = h
    return np.convolve(h, up)


def _mm(a, b, tf32: bool):
    return tf32_round(a) @ tf32_round(b) if tf32 else a @ b


def decimate4(z: torch.Tensor, taps: torch.Tensor, tf32: bool) -> torch.Tensor:
    """(..., n) → (..., ceil(n/4)): y[i] = Σ_k taps[k]·z[4i + k − m], zeros outside."""
    m = (taps.numel() - 1) // 2
    n_out = -(-z.shape[-1] // 4)
    zp = torch.nn.functional.pad(z, (m, m + 4))
    return _mm(zp.unfold(-1, taps.numel(), 4)[..., :n_out, :], taps, tf32)


def cqt_depths(cfg: dict) -> list:
    """(frequency, depth) of each bin below Nyquist: the least depth at which
    the bin's kernel fits the frame, deepened while the bin's band
    (``f·(1 + 2.5/Q)``) stays under 0.8 of the next level's Nyquist, and an
    odd depth taken one shallower where the kernel still fits (levels are
    built four to a stage)."""
    sr, n_fft, hop = cfg["sr"], int(cfg["n_fft"]), int(cfg["hop"])
    bpo = int(cfg["bins_per_octave"])
    q = 1.0 / (2.0 ** (1.0 / bpo) - 1.0)
    offset = n_fft // 2
    d_max = 0
    while d_max < 16 and hop % (2 << d_max) == 0 and offset % (2 << d_max) == 0:
        d_max += 1
    out = []
    for b in range(bpo * int(cfg["n_octaves"])):
        f = cfg["f_min"] * 2.0 ** (b / bpo)
        if f >= sr / 2.0:
            break
        full = int(np.round(q * sr / f))
        d = 0
        while full > n_fft * (1 << d) and d < d_max:
            d += 1
        while d < d_max and f * (1.0 + 2.5 / q) <= PASSBAND_FRAC * sr / (1 << (d + 2)):
            d += 1
        if d % 2 == 1 and full <= n_fft * (1 << (d - 1)):
            d -= 1
        out.append((f, d))
    return out


def cqt_kernel(f: float, sr: float, q: float, n_max: int) -> np.ndarray:
    n = max(1, min(int(np.round(q * sr / f)), n_max))
    w = hann(n)
    k = np.exp(2j * np.pi * f * np.arange(n) / sr) * w
    mags = np.abs(k)
    k = np.where(mags < mags.max() * 0.01, 0.0, k)
    return k / np.sqrt(np.sum(np.abs(k) ** 2))


def chroma_weights(sr: float, n_fft: int) -> np.ndarray:
    freqs = np.arange(n_fft // 2 + 1) * (sr / n_fft)
    ok = (freqs >= 32.7) & (freqs <= 4186.0) & (freqs > 0.0)
    pc = np.mod(69.0 + 12.0 * np.log2(np.maximum(freqs, 1e-300) / 440.0), 12.0)
    dist = np.abs(pc[None, :] - np.arange(12)[:, None])
    dist = np.minimum(dist, 12.0 - dist)
    fb = np.where(ok[None, :], np.exp(-0.5 * dist ** 2), 0.0)
    return fb / fb.sum(axis=1, keepdims=True)


def chroma_depth(cfg: dict) -> int:
    """The deepest 2^d (d ≤ 3) at which 4186 Hz stays under 0.8 of the
    decimated Nyquist and the frame (≥ 32 points) and hop stay whole."""
    d = 0
    sr, n_fft, hop = cfg["sr"], int(cfg["n_fft"]), int(cfg["hop"])
    while d < 3:
        c = d + 1
        if (n_fft % 2 ** c == 0 and hop % 2 ** c == 0 and n_fft // 2 ** c >= 32
                and 4186.0 <= PASSBAND_FRAC * sr / 2 ** (c + 1)):
            d = c
        else:
            break
    return d


def _frames_ending(y: torch.Tensor, ends: np.ndarray, length: int) -> torch.Tensor:
    """(rows, len(ends), length) windows of (rows, n) ``y`` ending (exclusive)
    at each end, zeros outside."""
    yp = torch.nn.functional.pad(y, (length, max(0, int(ends.max()) - y.shape[-1])))
    idx = torch.as_tensor(ends[:, None] + np.arange(length)[None, :], device=y.device)
    return yp[:, idx]


def _block(cfg: dict, x: torch.Tensor, tf32: bool, consts: dict) -> dict:
    """The three outputs of a block of rows (rows, n)."""
    rows, n = x.shape
    n_fft, hop = int(cfg["n_fft"]), int(cfg["hop"])
    pad = n_fft // 2
    nf = (n + 2 * pad - n_fft) // hop + 1
    taps = consts["taps"]

    # the shared cascade: even levels of the padded signal, four to a stage
    levels = {0: torch.nn.functional.pad(x, (pad, pad))}
    for d in range(2, max(list(consts["groups"]) + [consts["d_c"]]) + 1, 2):
        levels[d] = decimate4(levels[d - 2], taps, tf32)

    def level(d, keep_pad):
        D = 1 << d
        y = levels[d][:, (pad - keep_pad) // D:]
        length = -(-(n + 2 * keep_pad) // D)
        return torch.nn.functional.pad(y, (0, max(0, length - y.shape[-1])))[:, :length]

    # CQT: the bins of one depth share a level; kernels right-aligned on the frame end
    parts = []
    for d in sorted(consts["groups"], reverse=True):
        k_ri = consts["groups"][d]  # (longest kernel, 2·bins) [re | −im]
        D = 1 << d
        ends = pad // D + np.arange(nf) * (hop // D)
        ri = _mm(_frames_ending(level(d, 0), ends, k_ri.shape[0]), k_ri, tf32) * math.sqrt(D)
        nb = k_ri.shape[1] // 2
        parts.append(ri[..., :nb] ** 2 + ri[..., nb:] ** 2)
    cqt = torch.cat(parts, dim=-1).transpose(-1, -2)  # (rows, bins, frames)

    # chroma on level d_c, centre padding at the full rate
    d_c = consts["d_c"]
    Dc = 1 << d_c
    yc = level(d_c, pad) * Dc
    nfft_c, hop_c = n_fft // Dc, hop // Dc
    fr = torch.nn.functional.pad(yc, (0, nfft_c)).unfold(-1, nfft_c, hop_c)[:, :nf]
    re = _mm(fr, consts["cos_c"], tf32)
    im = _mm(fr, consts["sin_c"], tf32)
    mag = torch.sqrt(re * re + im * im)
    ch = _mm(mag, consts["chroma_t"], tf32) * Dc  # (rows, frames, 12)
    norm = torch.sqrt((ch * ch).sum(dim=-1, keepdim=True))
    chroma = torch.where(norm > 0, ch / torch.where(norm == 0, torch.ones_like(norm), norm),
                         ch).transpose(-1, -2)

    # MDCT round trip
    two_n = int(cfg["mdct_window"])
    h = two_n // 2
    nfm = (n - two_n) // h + 1
    frm = x[:, : (nfm - 1) * h + two_n].unfold(-1, two_n, h)
    back = _mm(_mm(frm, consts["mdct_fwd"], tf32), consts["mdct_inv"], tf32)  # (rows, nfm, 2N)
    out = torch.zeros(rows, (nfm - 1) * h + two_n, dtype=x.dtype, device=x.device)
    for j in range(two_n // h):
        seg = back[..., j * h:(j + 1) * h].reshape(rows, -1)
        out[:, j * h:j * h + seg.shape[-1]] += seg
    return {"cqt": cqt, "chroma": chroma, "mdct_rt": out[:, :n]}


def constants(cfg: dict, dt, dev) -> dict:
    sr, n_fft = float(cfg["sr"]), int(cfg["n_fft"])
    q = 1.0 / (2.0 ** (1.0 / int(cfg["bins_per_octave"])) - 1.0)
    by_depth: dict = {}
    for f, d in cqt_depths(cfg):  # ascending frequency, descending depth
        by_depth.setdefault(d, []).append(cqt_kernel(f, sr / (1 << d), q, n_fft))
    groups = {}
    for d, ks in by_depth.items():
        longest = max(k.size for k in ks)
        mat = np.zeros((longest, 2 * len(ks)))
        for b, k in enumerate(ks):
            mat[longest - k.size:, b] = k.real
            mat[longest - k.size:, len(ks) + b] = -k.imag
        groups[d] = torch.tensor(mat, dtype=dt, device=dev)
    d_c = chroma_depth(cfg)
    nfft_c = n_fft // (1 << d_c)
    win_c = hann(n_fft)[:: 1 << d_c][:, None]
    ang = 2.0 * np.pi * np.outer(np.arange(nfft_c), np.arange(nfft_c // 2 + 1)) / nfft_c
    two_n = int(cfg["mdct_window"])
    half = two_n // 2
    m = np.arange(two_n)[:, None]
    k = np.arange(half)[None, :]
    basis = np.cos(np.pi * (2.0 * m + 1.0 + half) * (2.0 * k + 1.0) / (4.0 * half))
    w = np.sin(np.pi * (np.arange(two_n) + 0.5) / two_n)[:, None]

    def t(a):
        return torch.tensor(a, dtype=dt, device=dev)

    return {"taps": t(stage4_taps()), "groups": groups, "d_c": d_c,
            "cos_c": t(win_c * np.cos(ang)), "sin_c": t(win_c * np.sin(ang)),
            "chroma_t": t(chroma_weights(sr / (1 << d_c), nfft_c).T),
            "mdct_fwd": t(basis * w), "mdct_inv": t((2.0 / half) * basis.T * w.T)}


ROWS_PER_BLOCK = 8


def outputs(cfg: dict, x: torch.Tensor, tf32: bool = False) -> dict:
    """(B, n) → {"cqt": (B, bins, frames), "chroma": (B, 12, frames),
    "mdct_rt": (B, ≤ n)}, in blocks of rows that fit."""
    dt = torch.float32 if tf32 else torch.float64
    consts = constants(cfg, dt, x.device)
    blocks = [_block(cfg, x[i:i + ROWS_PER_BLOCK].to(dt), tf32, consts)
              for i in range(0, x.shape[0], ROWS_PER_BLOCK)]
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def check(cfg: dict, traffic: dict, x: torch.Tensor, out: dict, lengths=None,
          frame_mask=None, pcm: bool = False) -> dict:
    """Each member against the reference: the CQT per bin, the chroma per
    pitch class (each on its own scale), the round trip per row."""
    ref = outputs(cfg, x)
    return {"cqt_err": rel_err(out["cqt"], ref["cqt"], axis=1),
            "chroma_err": rel_err(out["chroma"], ref["chroma"], axis=1),
            "mdct_rt_err": rel_err(out["mdct_rt"], ref["mdct_rt"], axis=0)}
