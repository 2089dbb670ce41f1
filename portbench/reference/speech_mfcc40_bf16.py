"""Plain reference of ``speech_mfcc40_bf16``: MFCC-40 and its first-order
deltas, held to the 1-pass bf16 tier's contract.

The float64 definitions (framing, symmetric Hann, Slaney mel-128, dB with
its floor, the DCT-II with the lifter, librosa's delta) are
``reference/speech_mfcc40.py``'s, loaded from that file; nothing here
imports the program.

``outputs(..., tf32=True)`` is the control one precision below the
configuration's bf16: the same in float32, every product's operands (the
DFT, the filterbank, the DCT and the delta's weights) rounded to 3 explicit
mantissa bits, E4M3's, the card's next format below bf16, with float32's
exponent range and float32 sums.

``check`` compares three numbers, each per coefficient on its own scale:
the MFCC and the delta against the float64 reference, and the program's
delta against the float64 delta of the program's own MFCC, which holds the
float32 delta stage to float32 whatever the tier's rounding.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from harness.judge import rel_err
from harness.manifest import load_module

_f64 = load_module(Path(__file__).with_name("speech_mfcc40.py"), "reference")
MANTISSA_BITS = 3  # E4M3's explicit mantissa bits


def mantissa_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to ``MANTISSA_BITS`` explicit mantissa bits, to
    nearest with ties to even, keeping float32's exponent range."""
    drop = 23 - MANTISSA_BITS
    t = t.contiguous().to(torch.float32)
    i = t.view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, drop), 1)
    r = torch.bitwise_and(i + ((1 << (drop - 1)) - 1) + lsb, ~((1 << drop) - 1))
    return r.view(torch.float32)


def _mm(a, b):
    return mantissa_round(a) @ mantissa_round(b)


def control_mfcc(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, n) signal → (B, n_mfcc, frames) float32, each product's operands
    rounded by ``mantissa_round``."""
    dt, dev = torch.float32, x.device
    n_fft, hop = int(cfg["n_fft"]), int(cfg["hop"])
    k = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), k) / n_fft
    win = _f64.hann(n_fft)[:, None]
    cos_b = torch.tensor(win * np.cos(ang), dtype=dt, device=dev)
    sin_b = torch.tensor(win * np.sin(ang), dtype=dt, device=dev)
    fb_t = torch.tensor(_f64.mel_filterbank(cfg["sr"], n_fft, cfg["n_mels"], cfg["f_min"],
                                            cfg["f_max"]).T, dtype=dt, device=dev)
    basis = torch.tensor(_f64.dct_lifter(cfg["n_mels"], cfg["n_mfcc"], cfg["lifter"]),
                         dtype=dt, device=dev)
    floor = 10.0 ** (cfg["floor_db"] / 10.0)
    out = []
    for row in range(x.shape[0]):  # one row at a time: a block that fits
        fr = _f64.frames_of(x[row:row + 1].to(dt), n_fft, hop)[0]
        re, im = _mm(fr, cos_b), _mm(fr, sin_b)
        power = re * re + im * im
        db = 10.0 * torch.log10(torch.clamp_min(_mm(power, fb_t), floor))
        out.append(_mm(db, basis).T)
    return torch.stack(out)


def control_delta(c: torch.Tensor, width: int, order: int) -> torch.Tensor:
    """librosa's delta with its weights and the coefficients rounded by
    ``mantissa_round``, summed in float32."""
    half = width // 2
    w = torch.arange(-half, half + 1, dtype=torch.float32, device=c.device)
    w = mantissa_round(w / (w * w).sum())
    out = c
    for _ in range(order):
        n = out.shape[-1]
        fp = mantissa_round(torch.cat([out[..., :1].expand(*out.shape[:-1], half), out,
                                       out[..., -1:].expand(*out.shape[:-1], half)], dim=-1))
        out = sum(fp[..., j:j + n] * w[j] for j in range(width))
    return out


def outputs(cfg: dict, x: torch.Tensor, tf32: bool = False) -> dict:
    """The float64 reference, or under ``tf32`` the control below bf16."""
    if not tf32:
        return _f64.outputs(cfg, x)
    m = control_mfcc(cfg, x)
    return {"mfcc": m, "delta": control_delta(m, int(cfg["delta_width"]),
                                              int(cfg["delta_order"]))}


def check(cfg: dict, traffic: dict, x: torch.Tensor, out: dict) -> dict:
    """The numbers compared for one answer (see the module's docstring)."""
    ref = _f64.outputs(cfg, x)
    nums = {f"{k}_err": rel_err(out[k], ref[k], axis=1) for k in ref}
    own = _f64.delta(out["mfcc"].to(torch.float64), int(cfg["delta_width"]),
                     int(cfg["delta_order"]))
    nums["delta_self_err"] = rel_err(out["delta"], own, axis=1)
    return nums


def tier_task(cfg: dict, traffic: dict) -> tuple:
    """(product operations, elementwise operations, bytes) of one batch's
    MFCC: ``f32_task``'s counts split by the unit that may do them. Products:
    the real FFT of each frame at 2.5·n·log2(n), the mel mapping at 2 a
    nonzero of the filterbank, the DCT-II at 2·n_mels a coefficient.
    Elementwise: |X|² at 3 a bin, the log at 1 a band, the lifter at 1 a
    coefficient. Bytes: the float32 input read once and the float32
    coefficients written once."""
    n_fft = int(cfg["n_fft"])
    rows = int(traffic["clips"])
    n = int(round(traffic["clip_s"] * traffic["sr"]))
    frames = rows * _f64.n_frames(n, n_fft, int(cfg["hop"]))
    nnz = int(np.count_nonzero(_f64.mel_filterbank(cfg["sr"], n_fft, cfg["n_mels"],
                                                   cfg["f_min"], cfg["f_max"])))
    products = 2.5 * n_fft * math.log2(n_fft) + 2 * nnz + 2 * cfg["n_mels"] * cfg["n_mfcc"]
    elementwise = 3 * (n_fft // 2 + 1) + cfg["n_mels"] + cfg["n_mfcc"]
    nbytes = 4 * rows * n + 4 * frames * cfg["n_mfcc"]
    return products * frames, elementwise * frames, nbytes
