"""Signal reconstruction: Griffin-Lim phase recovery and mel inversion.

Counterpart of ``spectrograms_tpu.reconstruct``: Griffin-Lim with the
momentum of Perraudin et al., "A fast Griffin-Lim algorithm" (WASPAA 2013),
and mel inversion through the non-negative pseudo-inverse of the filterbank,
so that ``mel_db → audio`` works end to end.

The iteration is a Python loop of torch ops on the device: nothing in it
reads a value back to the host. Like the JAX package it takes one of two
routes: at float32 and ``n_fft ≤ MATMUL_MAX_N_FFT`` the analysis and
synthesis transforms are matmuls against the (i)rDFT matrices of
``ops/dft.py``, the spectrum carried as [re | im]; at float64 or larger
sizes they are ``torch.fft.rfft``/``irfft``. The initial phase is uniform
in [-π, π), drawn on the host from a fixed seed (so a CUDA run and a CPU run
start alike, as the JAX package's fixed key does), or given as
``init_angles``.

Spans ``tg.op.reconstruct.griffin_lim`` (set-up, the iteration loop and the
last synthesis) and ``tg.op.reconstruct.mel_to_linear``. Counters, summed
over calls: ``gl_iterations`` the iterations run, ``gl_matmul_calls`` and
``gl_fft_calls`` the calls by route.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .dtypes import check_true_f32, resolve_device, result_data
from .errors import InvalidInputError
from .ops.dft import MATMUL_MAX_N_FFT, irdft_matrices, rdft_matrices
from .ops.filterbanks import mel_filterbank
from .ops.framing import frame_signal, framed_matmul
from .ops.ola import overlap_add
from .params import MelParams, r2c_output_size
from .spans import span
from .windows import WindowType, make_window

__all__ = ["griffin_lim", "mel_to_linear", "mel_filterbank_pinv", "invert_mel_db"]

gl_iterations = 0    # Griffin-Lim iterations run
gl_matmul_calls = 0  # griffin_lim calls that took the matmul route
gl_fft_calls = 0     # griffin_lim calls that took the fft route


def _initial_angles(init_angles, shape, dtype, device) -> torch.Tensor:
    """(..., n_frames, n_bins) initial phase from ``init_angles`` (laid out
    like the magnitude, (…, n_bins, n_frames)) or drawn from seed 0."""
    if init_angles is None:
        gen = torch.Generator().manual_seed(0)
        angles = torch.rand(shape[-2:], generator=gen, dtype=torch.float64) * (2 * np.pi) - np.pi
    else:
        if not isinstance(init_angles, torch.Tensor):
            init_angles = torch.from_numpy(np.array(init_angles, dtype=np.float64))
        angles = init_angles.to(torch.float64).transpose(-1, -2)
        if angles.shape[-2:] != shape[-2:]:
            raise InvalidInputError(
                f"init_angles must be laid out like the magnitude (n_bins, n_frames) = "
                f"{tuple(reversed(shape[-2:]))}, got {tuple(angles.shape)}"
            )
    return angles.to(dtype).to(device)


def griffin_lim(
    magnitude,
    n_fft: int,
    hop_size: int,
    window: WindowType = WindowType.HANNING,
    centre: bool = True,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: Optional[int] = None,
    *,
    init_angles=None,
    device=None,
) -> torch.Tensor:
    """Reconstruct a waveform from an STFT magnitude (n_bins, n_frames).

    A (B, n_bins, n_frames) batch runs as one batched iteration, each item
    from the same initial phase (the JAX package vmaps one key). ``momentum=0``
    gives classic Griffin-Lim; the default 0.99 is the fast variant.
    """
    mag = torch.as_tensor(result_data(magnitude), device=resolve_device(device))
    if mag.ndim not in (2, 3):
        raise InvalidInputError(f"magnitude must be 2-D or 3-D, got {tuple(mag.shape)}")
    expected = r2c_output_size(n_fft)
    if mag.shape[-2] != expected:
        raise InvalidInputError(
            f"magnitude has {mag.shape[-2]} bins, expected {expected} for n_fft={n_fft}"
        )
    if hop_size > n_fft:
        raise InvalidInputError("hop_size must be <= n_fft")
    if not (0.0 <= momentum < 1.0):
        raise InvalidInputError("momentum must be in [0, 1)")
    global gl_iterations, gl_matmul_calls, gl_fft_calls
    with span("tg.op.reconstruct.griffin_lim"):
        n_frames = mag.shape[-1]
        pad = n_fft // 2 if centre else 0
        full_len = (n_frames - 1) * hop_size + n_fft
        out_len = full_len - 2 * pad if length is None else int(length)
        out_len = max(1, min(out_len, full_len - pad))
        real_dt = torch.float64 if mag.dtype == torch.float64 else torch.float32
        dev = mag.device
        mag_t = mag.to(real_dt).transpose(-1, -2)  # (..., n_frames, n_bins)
        angles = _initial_angles(init_angles, mag_t.shape, real_dt, dev)
        w64 = make_window(window, n_fft, np.float64)
        w = torch.tensor(w64, dtype=real_dt, device=dev)

        norm = overlap_add((w * w).expand(n_frames, n_fft), hop_size)
        safe_norm = torch.where(norm > 1e-10, norm, 1.0)

        def ola(frames):
            out = overlap_add(frames, hop_size)
            return torch.where(norm > 1e-10, out / safe_norm, out)

        if real_dt == torch.float32 and n_fft <= MATMUL_MAX_N_FFT:
            if dev.type == "cuda":
                check_true_f32()
            # Analysis [C | S] with the window folded in; synthesis [Ci; Si],
            # the window applied after. The spectrum rides as [re | im].
            cs_f = torch.cat(rdft_matrices(n_fft, w64, real_dt, dev), dim=1)
            cs_i = torch.cat(irdft_matrices(n_fft, real_dt, dev), dim=0)

            def istft(ri):
                return ola((ri @ cs_i) * w)

            ri = torch.cat([mag_t * torch.cos(angles), mag_t * torch.sin(angles)], dim=-1)
            prev = ri
            for _ in range(n_iter):
                cand = framed_matmul(istft(ri), cs_f, n_fft, hop_size, centre=False)
                acc = cand + momentum * (cand - prev)
                acc_re, acc_im = acc.chunk(2, dim=-1)
                a = torch.clamp_min(torch.sqrt(acc_re * acc_re + acc_im * acc_im), 1e-16)
                ri = torch.cat([mag_t * acc_re / a, mag_t * acc_im / a], dim=-1)
                prev = cand
            x = istft(ri)
            gl_matmul_calls += 1
        else:

            def istft(spec_t):
                return ola(torch.fft.irfft(spec_t, n=n_fft, dim=-1) * w)

            def stft(x):
                # x is the padded overlap-add signal, (n_frames-1)*hop + n_fft long
                return torch.fft.rfft(frame_signal(x, n_fft, hop_size, centre=False) * w, dim=-1)

            spec = mag_t * torch.exp(1j * angles)
            prev = spec
            for _ in range(n_iter):
                cand = stft(istft(spec))
                accel = cand + momentum * (cand - prev)
                spec, prev = mag_t * (accel / torch.clamp_min(accel.abs(), 1e-16)), cand
            x = istft(spec)
            gl_fft_calls += 1
        gl_iterations += n_iter
        return x[..., pad : pad + out_len]


@lru_cache(maxsize=32)
def _pinv_np(mel_key, sr: float, n_fft: int):
    m = mel_filterbank(sr, n_fft, MelParams(*mel_key))  # (n_mels, n_bins)
    # Least-squares pseudo-inverse clamped non-negative (power domain):
    # better conditioned than the row-normalized transpose for overlapping
    # triangles.
    return np.maximum(np.linalg.pinv(m), 0.0)  # (n_bins, n_mels)


def mel_filterbank_pinv(mel_params: MelParams, sample_rate_hz: float, n_fft: int) -> np.ndarray:
    """Non-negative pseudo-inverse of the mel filterbank, (n_bins, n_mels), f64."""
    key = (mel_params.n_mels, mel_params.f_min, mel_params.f_max, mel_params.norm)
    return _pinv_np(key, float(sample_rate_hz), int(n_fft))


def mel_to_linear(mel_power, mel_params: MelParams, sample_rate_hz: float, n_fft: int,
                  device=None) -> torch.Tensor:
    """Mel power (n_mels, n_frames) → approximate linear power (n_bins, n_frames)."""
    m = torch.as_tensor(result_data(mel_power), device=resolve_device(device))
    if m.is_cuda and m.dtype == torch.float32:
        check_true_f32()
    with span("tg.op.reconstruct.mel_to_linear"):
        pinv = torch.tensor(mel_filterbank_pinv(mel_params, sample_rate_hz, n_fft),
                            dtype=m.dtype, device=m.device)
        return torch.clamp_min(pinv @ m, 0.0)


def invert_mel_db(
    mel_db,
    mel_params: MelParams,
    sample_rate_hz: float,
    n_fft: int,
    hop_size: int,
    window: WindowType = WindowType.HANNING,
    centre: bool = True,
    n_iter: int = 32,
    length: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Mel-dB spectrogram → waveform (dB → power → linear power → Griffin-Lim)."""
    db = torch.as_tensor(result_data(mel_db), device=resolve_device(device))
    linear_power = mel_to_linear(torch.pow(10.0, db / 10.0), mel_params, sample_rate_hz, n_fft,
                                 device=db.device)
    return griffin_lim(torch.sqrt(linear_power), n_fft, hop_size, window, centre,
                       n_iter=n_iter, length=length, device=db.device)
