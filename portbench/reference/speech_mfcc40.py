"""Plain reference of ``speech_mfcc40``: MFCC-40 and its first-order deltas.

Written from the published definitions, in plain PyTorch; it imports nothing
of the program and builds its own window, mel filterbank and DCT:

- frames: centred, ``n_fft // 2`` zeros each side (and on the right as many
  as the last frame needs), hop ``hop``;
- window: symmetric Hann, ``0.5 − 0.5·cos(2πi/(n_fft − 1))``;
- power: ``|DFT|²`` of each windowed frame, taken as one product with the
  cosine and sine bases;
- mel: Slaney's mel scale (linear below 1 kHz, logarithmic above), triangles
  in Hz, Slaney area normalisation ``2 / (f_right − f_left)``;
- dB: ``10·log10(max(mel, 10^(floor_db/10)))``;
- MFCC: the unnormalised DCT-II ``Σ_i dB_i·cos(πk(i + ½)/n_mels)``, C0 kept,
  times the lifter ``1 + (L/2)·sin(πk/L)``;
- delta: librosa's regression ``Σ_j j·c[t + j] / Σ_j j²`` over ``j = −w/2..w/2``
  with the edge frames repeated.

``outputs(..., tf32=True)`` is the control: the same in float32, each
product's operands rounded to TF32 (10 mantissa bits), the step below the
float32 that the configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness.judge import rel_err
from harness.precision import tf32_round


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1e-300) / 1000.0) / (math.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    lin = (200.0 / 3.0) * m
    log = 1000.0 * np.exp((math.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filterbank(sr: float, n_fft: int, n_mels: int, f_min: float, f_max: float) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) Slaney triangles with Slaney area normalisation."""
    edges = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    freqs = np.arange(n_fft // 2 + 1) * (sr / n_fft)
    fb = np.zeros((n_mels, freqs.size))
    for m in range(n_mels):
        lo, c, hi = edges[m], edges[m + 1], edges[m + 2]
        up = (freqs - lo) / (c - lo)
        down = (hi - freqs) / (hi - c)
        fb[m] = np.clip(np.minimum(up, down), 0.0, 1.0) * (2.0 / (hi - lo))
    return fb


def dct_lifter(n_mels: int, n_mfcc: int, lifter: int) -> np.ndarray:
    i = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    basis = np.cos(np.pi * k * (i + 0.5) / n_mels)
    if lifter > 0:
        basis = basis * (1.0 + (lifter / 2.0) * np.sin(np.pi * np.arange(n_mfcc) / lifter))[None]
    return basis


def n_frames(n: int, n_fft: int, hop: int) -> int:
    return (n + 2 * (n_fft // 2) - n_fft) // hop + 1


def frames_of(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, n) → (B, frames, n_fft), centred with zeros."""
    n = x.shape[-1]
    nf = n_frames(n, n_fft, hop)
    left = n_fft // 2
    right = max(0, (nf - 1) * hop + n_fft - left - n)
    xp = torch.nn.functional.pad(x, (left, right))
    return xp.unfold(-1, n_fft, hop)[:, :nf]


def _mm(a, b, tf32: bool):
    return tf32_round(a) @ tf32_round(b) if tf32 else a @ b


def mfcc(cfg: dict, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """(B, n) signal → (B, n_mfcc, frames), float64 (float32 under ``tf32``)."""
    dt = torch.float32 if tf32 else torch.float64
    dev = x.device
    n_fft, hop = int(cfg["n_fft"]), int(cfg["hop"])
    k = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), k) / n_fft
    win = hann(n_fft)[:, None]
    cos_b = torch.tensor(win * np.cos(ang), dtype=dt, device=dev)
    sin_b = torch.tensor(win * np.sin(ang), dtype=dt, device=dev)
    fb_t = torch.tensor(mel_filterbank(cfg["sr"], n_fft, cfg["n_mels"], cfg["f_min"],
                                       cfg["f_max"]).T, dtype=dt, device=dev)
    basis = torch.tensor(dct_lifter(cfg["n_mels"], cfg["n_mfcc"], cfg["lifter"]),
                         dtype=dt, device=dev)
    floor = 10.0 ** (cfg["floor_db"] / 10.0)
    out = []
    for row in range(x.shape[0]):  # one row at a time: a block that fits
        fr = frames_of(x[row:row + 1].to(dt), n_fft, hop)[0]
        re = _mm(fr, cos_b, tf32)
        im = _mm(fr, sin_b, tf32)
        power = re * re + im * im
        db = 10.0 * torch.log10(torch.clamp_min(_mm(power, fb_t, tf32), floor))
        out.append(_mm(db, basis, tf32).T)
    return torch.stack(out)


def delta(c: torch.Tensor, width: int, order: int) -> torch.Tensor:
    half = width // 2
    w = torch.arange(-half, half + 1, dtype=c.dtype, device=c.device)
    w = w / (w * w).sum()
    out = c
    for _ in range(order):
        n = out.shape[-1]
        fp = torch.cat([out[..., :1].expand(*out.shape[:-1], half), out,
                        out[..., -1:].expand(*out.shape[:-1], half)], dim=-1)
        out = sum(fp[..., j:j + n] * w[j] for j in range(width))
    return out


def outputs(cfg: dict, x: torch.Tensor, tf32: bool = False) -> dict:
    m = mfcc(cfg, x, tf32)
    return {"mfcc": m, "delta": delta(m, int(cfg["delta_width"]), int(cfg["delta_order"]))}


def check(cfg: dict, traffic: dict, x: torch.Tensor, out: dict, lengths=None,
          frame_mask=None, pcm: bool = False) -> dict:
    """The numbers compared for one answer: each output against the reference,
    per coefficient on its own scale; served from files, the rows' lengths
    and frame masks too (every clip is whole, so every frame is real)."""
    if pcm:
        x = x.to(torch.float64) / 32768.0
    ref = outputs(cfg, x)
    nums = {f"{k}_err": rel_err(out[k], ref[k], axis=1) for k in ref}
    if lengths is not None:
        n = x.shape[-1]
        bad = int(np.sum(np.asarray(lengths) != n)) + int(np.sum(~np.asarray(frame_mask)))
        nums["mask_err"] = float(bad)
    return nums


def f32_task(cfg: dict, traffic: dict) -> tuple:
    """(operations, bytes) of one batch's MFCC, the task the f32 kernel does:
    the real FFT of each frame at 2.5·n·log2(n), |X|² at 3 a bin, the mel
    mapping at 2 a nonzero of the filterbank, the log at 1 a band, the DCT-II
    at 2·n_mels a coefficient and the lifter at 1 a coefficient. Bytes: the
    float32 input read once and the float32 coefficients written once."""
    n_fft = int(cfg["n_fft"])
    rows = int(traffic["clips"]) if "clips" in traffic else int(traffic["batch_size"])
    n = int(round(traffic["clip_s"] * traffic["sr"]))
    frames = rows * n_frames(n, n_fft, int(cfg["hop"]))
    nnz = int(np.count_nonzero(mel_filterbank(cfg["sr"], n_fft, cfg["n_mels"], cfg["f_min"],
                                              cfg["f_max"])))
    n_bins = n_fft // 2 + 1
    per_frame = (2.5 * n_fft * math.log2(n_fft) + 3 * n_bins + 2 * nnz + cfg["n_mels"]
                 + 2 * cfg["n_mels"] * cfg["n_mfcc"] + cfg["n_mfcc"])
    nbytes = 4 * rows * n + 4 * frames * cfg["n_mfcc"]
    return per_frame * frames, nbytes
