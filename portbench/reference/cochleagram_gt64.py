"""Plain reference of ``cochleagram_gt64``: the 64-band gammatone cochleagram,
in float64, written from the published definitions in plain PyTorch and
numpy; it imports nothing of the program.

- centres: ``n_bands`` frequencies uniform on the ERB-rate scale
  ``E(f) = ln(1 + f / (EarQ·minBW))`` (Glasberg and Moore 1990, with
  Slaney's EarQ 9.26449 and minBW 24.7), both ends of ``cf_range_hz``
  included (Wang, Narayanan and Wang 2014);
- each band: the 4th-order gammatone as Slaney's four second-order sections
  (Apple TR #35). With ``T = 1/sr``, ``ERB = cf/EarQ + minBW``,
  ``B = 2π·1.019·ERB``, ``ω = 2π·cf·T``: the denominator
  ``1 − 2e^(−BT)cos ω z⁻¹ + e^(−2BT) z⁻²`` in every section and the
  numerators ``T − T·e^(−BT)(cos ω ± √(3 ± 2^(3/2)) sin ω) z⁻¹``, one sign
  pair a section; the gain is the modulus of that cascade's response at
  ``z = e^(jω)``, by which the output is divided, so that the band passes
  its centre at unit gain;
- frames: ``frame_size`` samples every ``hop_size``, as many as fit, times a
  Hann window ``0.5 − 0.5·cos(2πi/(N − 1))``;
- each (clip, band, frame): the cascade run over the windowed frame from
  zero state, one sample at a time, each section as the direct-form-I
  difference equation ``y = b0·v + b1·v₋₁ − a1·y₋₁ − a2·y₋₂``; the RMS of
  the last section's output over the frame, divided by the gain;
- dB: ``10·log10(max(RMS, 10^(db_floor/10)))``.

``outputs(..., tf32=True)`` is the control: the same recurrence with every
coefficient, sample and sum in float32, one precision below the float64
filter the configuration states.

``check`` compares one number: ``gt_db_err``, the largest |Δ| in dB over
every clip, band and frame. ``gt_task`` is the frozen least work of one
call at the traffic's shape.
"""

from __future__ import annotations

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EAR_Q = 9.26449
MIN_BW = 24.7
OPS_PER_FILTERED_SAMPLE = 34  # 4 sections × 4 multiply-adds (8 operations), then a square and a sum


def centre_frequencies(cfg: dict) -> np.ndarray:
    """(n_bands,) Hz, low to high, uniform on the ERB-rate scale."""
    lo, hi = (float(f) for f in cfg["cf_range_hz"])
    s = EAR_Q * MIN_BW
    e = np.linspace(math.log1p(lo / s), math.log1p(hi / s), int(cfg["n_bands"]))
    return s * np.expm1(e)


def sections(cfg: dict) -> tuple:
    """(b0 (n_bands,), b1 (n_bands, 4), a1 (n_bands,), a2 (n_bands,), gain
    (n_bands,)) of each band's four sections, float64."""
    cf = centre_frequencies(cfg)
    t = 1.0 / float(cfg["sr"])
    bw = 2.0 * math.pi * 1.019 * (cf / EAR_Q + MIN_BW)
    w = 2.0 * math.pi * cf * t
    decay = np.exp(-bw * t)
    root_lo, root_hi = math.sqrt(3.0 - 2.0 ** 1.5), math.sqrt(3.0 + 2.0 ** 1.5)
    b1 = np.stack([-t * decay * (np.cos(w) + sign * r * np.sin(w))
                   for r in (root_hi, root_lo) for sign in (1.0, -1.0)], axis=-1)
    a1 = -2.0 * decay * np.cos(w)
    a2 = decay * decay
    zi = np.exp(-1j * w)  # z⁻¹ at the centre
    response = np.prod(t + b1 * zi[:, None], axis=-1) / (1.0 + a1 * zi + a2 * zi * zi) ** 4
    return np.full_like(cf, t), b1, a1, a2, np.abs(response)


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


def n_frames(cfg: dict, n: int) -> int:
    return 1 + (n - int(cfg["frame_size"])) // int(cfg["hop_size"])


def cochleagram(cfg: dict, x: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(B, n) signal → (B, n_bands, n_frames) dB, every step in ``dtype``."""
    frame, hop = int(cfg["frame_size"]), int(cfg["hop_size"])
    dev = x.device

    def col(v):  # (n_bands,) → (n_bands, 1), broadcast over (B, n_bands, n_frames)
        return torch.tensor(v, dtype=dtype, device=dev)[:, None]

    b0, b1, a1, a2, gain = sections(cfg)
    b0, a1, a2, gain = col(b0), col(a1), col(a2), col(gain)
    b1 = [col(b1[:, k]) for k in range(4)]
    f = n_frames(cfg, x.shape[-1])
    starts = torch.arange(f, device=dev) * hop
    frames = x.to(dtype)[:, starts[:, None] + torch.arange(frame, device=dev)]  # (B, f, frame)
    frames = frames * torch.tensor(hann(frame), dtype=dtype, device=dev)
    shape = (x.shape[0], gain.shape[0], f)
    v_prev = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(4)]
    y1 = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(4)]
    y2 = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(4)]
    energy = torch.zeros(shape, dtype=dtype, device=dev)
    for i in range(frame):
        v = frames[:, None, :, i]  # (B, 1, f): every band reads the same sample
        for k in range(4):
            y = b0 * v + b1[k] * v_prev[k] - a1 * y1[k] - a2 * y2[k]
            v_prev[k], y2[k], y1[k] = v, y1[k], y
            v = y
        energy = energy + v * v
    rms = torch.sqrt(energy / frame) / gain
    floor = 10.0 ** (float(cfg["db_floor"]) / 10.0)
    return 10.0 * torch.log10(torch.clamp_min(rms, floor))


def outputs(cfg: dict, x: torch.Tensor, tf32: bool = False) -> dict:
    """{"cochleagram"} of the (B, n) signal ``x``: float64, or under ``tf32``
    the control, the same recurrence in float32."""
    return {"cochleagram": cochleagram(cfg, x, torch.float32 if tf32 else torch.float64)}


def check(cfg: dict, traffic: dict, x: torch.Tensor, out: dict) -> dict:
    """``gt_db_err``: max |program − reference| in dB over every clip, band
    and frame of the answer (NaN where the shapes differ)."""
    got = out["cochleagram"]
    ref = cochleagram(cfg, x)
    if tuple(got.shape) != tuple(ref.shape):
        return {"gt_db_err": math.nan}
    return {"gt_db_err": float((got.to(torch.float64) - ref).abs().max())}


def filtered_samples(cfg: dict, traffic: dict) -> int:
    """B × n_bands × n_frames × frame_size of one call at the traffic's shape."""
    n = int(round(traffic["clip_s"] * traffic["sr"]))
    return (int(traffic["clips"]) * int(cfg["n_bands"]) * n_frames(cfg, n)
            * int(cfg["frame_size"]))


def gt_task(cfg: dict, traffic: dict) -> tuple:
    """(operations, bytes) of one call over one batch, the least the bank
    needs, whatever route the program takes.

    Operations: 34 float64 operations a filtered sample (each of the four
    sections four multiply-adds, 8 operations; the square and the sum) and
    one window product a sample of each frame. Bytes: the float32 input read
    once and the float32 output written once."""
    rows = int(traffic["clips"])
    n = int(round(traffic["clip_s"] * traffic["sr"]))
    frames = n_frames(cfg, n)
    ops = (OPS_PER_FILTERED_SAMPLE * filtered_samples(cfg, traffic)
           + rows * frames * int(cfg["frame_size"]))
    nbytes = 4 * rows * n + 4 * rows * int(cfg["n_bands"]) * frames
    return ops, nbytes
