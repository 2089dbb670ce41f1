"""ERB / gammatone filterbanks: frequency domain and the exact time-domain IIR, in PyTorch.

Counterpart of ``spectrograms_tpu.erb``, with the reference's two forms
(``erb.rs``):

(a) the frequency-domain ``ErbFilterbank`` (|H(f)|² gammatone responses on
    power spectra); its constants are ``ops.filterbanks.erb_filterbank``
    and the integrated path is the ``FreqScale.ERB`` plans;

(b) the time-domain 4th-order cascaded IIR gammatone (``:410-654``): a
    biquad cascade per band (DF2T, shared denominator [1, b1, b2],
    numerators [a0ᵢ, a1ᵢ, 0], the first section gain-normalised), the RMS
    of each frame with the state reset, a Hann window.

(b) runs in float64 on every device, as the JAX package does under x64. Its
``scan`` lowering steps through the frame's samples in the reference's
order, all (band, frame) pairs at once (the state reset keeps frames
independent, ``erb.rs:529-541``); its ``parallel`` lowering is a log-depth
doubling scan over time.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .dtypes import parse_dtype, resolve_device
from .errors import InvalidInputError
from .ops.filterbanks import erb_center_frequencies, erb_filterbank
from .params import ErbParams

__all__ = [
    "ErbFilterbank",
    "gammatone_center_frequencies",
    "gammatone_iir_spectrogram",
    "make_iir_bank",
]

_EAR_Q = 9.26449
_MIN_BW = 24.7


class ErbFilterbank:
    """Frequency-domain gammatone filterbank (|H|² on power spectra).

    API parity with ``ErbFilterbank`` (erb.rs:475-608).
    """

    def __init__(self, params: ErbParams, sample_rate: float, n_fft: int):
        if sample_rate <= 0.0:
            raise InvalidInputError("sample_rate must be > 0")
        response, cfs = erb_filterbank(sample_rate, n_fft, params)
        self._response = response  # (n_filters, n_bins) f64
        self._cfs = cfs

    @property
    def center_frequencies(self) -> np.ndarray:
        return self._cfs

    @property
    def num_filters(self) -> int:
        return self._response.shape[0]

    @property
    def response_matrix(self) -> np.ndarray:
        return self._response

    def apply_to_power_spectrum(self, power_spectrum):
        """(n_bins, ...) power spectra → (n_filters, ...) band energies, on
        the device and in the dtype of ``power_spectrum``."""
        ps = torch.as_tensor(power_spectrum)
        return torch.tensor(self._response, dtype=ps.dtype, device=ps.device) @ ps


def gammatone_center_frequencies(erb_params: ErbParams) -> np.ndarray:
    """Band centre frequencies (Hz, low→high) per the spacing strategy."""
    return erb_center_frequencies(erb_params)


@lru_cache(maxsize=32)
def _iir_bank_cached(cfs_key, sample_rate: float):
    """Per-band coefficients: a (4, 2) numerator pairs, b (2,) shared denominator.

    The derivation of ``make_iir_bank`` / ``iir_gain`` (erb.rs:426-497).
    """
    cfs = np.asarray(cfs_key, dtype=np.float64)
    t = 1.0 / sample_rate
    erb = cfs / _EAR_Q + _MIN_BW
    b_val = 1.019 * 2.0 * np.pi * erb

    exp_bt = np.exp(-b_val * t)
    angle = 2.0 * np.pi * cfs * t
    cos1, sin1 = np.cos(angle), np.sin(angle)

    b1 = -2.0 * cos1 * exp_bt
    b2 = np.exp(-2.0 * b_val * t)

    s1 = np.sqrt(3.0 - 2.0 * np.sqrt(2.0))
    s2 = np.sqrt(3.0 + 2.0 * np.sqrt(2.0))
    b_sin = sin1 * t

    a11 = -exp_bt * (t * cos1 + b_sin * s2)
    a12 = -exp_bt * (t * cos1 - b_sin * s2)
    a13 = -exp_bt * (t * cos1 + b_sin * s1)
    a14 = -exp_bt * (t * cos1 - b_sin * s1)

    # gain normalisation (iir_gain): |Πᵢ xᵢ / x5⁴| in complex f64
    x_exp = np.exp(2j * angle)
    x01 = x_exp * (-2.0 * t)
    x02 = (cos1 + 1j * sin1) * (2.0 * t * exp_bt)
    x1 = x01 + x02 * (cos1 - s1 * sin1)
    x2 = x01 + x02 * (cos1 + s1 * sin1)
    x3 = x01 + x02 * (cos1 - s2 * sin1)
    x4 = x01 + x02 * (cos1 + s2 * sin1)
    x5 = -2.0 * exp_bt**2 - 2.0 * x_exp + (1.0 + x_exp) * (2.0 * exp_bt)
    gain = np.abs((x1 * x2 * x3 * x4) / x5**4)

    a0 = t
    # (n_bands, 4 sections, 2 numerator taps); section 1 gain-normalised
    a = np.stack(
        [
            np.stack([np.full_like(cfs, a0) / gain, a11 / gain], axis=-1),
            np.stack([np.full_like(cfs, a0), a12], axis=-1),
            np.stack([np.full_like(cfs, a0), a13], axis=-1),
            np.stack([np.full_like(cfs, a0), a14], axis=-1),
        ],
        axis=1,
    )
    b = np.stack([b1, b2], axis=-1)  # (n_bands, 2)
    a.setflags(write=False)
    b.setflags(write=False)
    return a, b


def make_iir_bank(center_freqs, sample_rate: float):
    """(a (n_bands, 4, 2), b (n_bands, 2)) gammatone IIR coefficients, f64."""
    key = tuple(np.asarray(center_freqs, dtype=np.float64).tolist())
    return _iir_bank_cached(key, float(sample_rate))


def _gammatone_frames_t(x, window, frame_size: int, hop_size: int, n_frames: int):
    """(frame_size, n_frames) windowed frames, time-major: the framing that
    both lowerings share."""
    frames = x.unfold(0, frame_size, hop_size)[:n_frames]
    return (frames * window).T


def _gammatone_impl(x, window, a, b, frame_size: int, hop_size: int, n_frames: int):
    """The cascade one sample at a time, in the reference's order, for every
    (band, frame) pair at once; the squared output accumulates as it goes."""
    xs = _gammatone_frames_t(x, window, frame_size, hop_size, n_frames)
    n_bands = a.shape[0]
    a0, a1 = a[:, :, 0, None], a[:, :, 1, None]  # (n_bands, 4, 1)
    b1, b2 = b[:, 0, None], b[:, 1, None]  # (n_bands, 1)
    z0 = x.new_zeros((4, n_bands, n_frames))
    z1 = x.new_zeros((4, n_bands, n_frames))
    acc = x.new_zeros((n_bands, n_frames))
    for t in range(frame_size):
        sig = xs[t].expand(n_bands, n_frames)
        new_z0, new_z1 = [], []
        for s in range(4):
            y = a0[:, s] * sig + z0[s]
            new_z0.append(a1[:, s] * sig + z1[s] - b1 * y)
            new_z1.append(-b2 * y)
            sig = y
        z0, z1 = torch.stack(new_z0), torch.stack(new_z1)
        acc = acc + sig * sig
    return torch.sqrt(acc / frame_size)


def _gammatone_parallel_impl(x, window, a, b, frame_size: int, hop_size: int, n_frames: int):
    """The cascade as a log-depth doubling scan over time.

    Each DF2T section is the linear recurrence ``z[t] = A·z[t−1] + B·x[t]``
    with (per band)

        A = [[−b1, 1], [−b2, 0]],   B = [a1 − b1·a0,  −b2·a0],
        y[t] = a0·x[t] + z0[t−1].

    A is the same at every step, so after the passes with offsets 1, 2, …, k
    each ``z[t]`` holds the sum over its last 2k inputs, and the pass at
    offset 2k adds ``A^(2k)·z[t−2k]``: log2(T) passes of whole-array work
    instead of T steps. The four sections chain, each over the output of
    the one before.
    """
    xs = _gammatone_frames_t(x, window, frame_size, hop_size, n_frames)
    n_bands = a.shape[0]
    sig = xs[:, None, :].expand(frame_size, n_bands, n_frames)
    b1, b2 = b[:, 0], b[:, 1]
    a_band = torch.stack([torch.stack([-b1, torch.ones_like(b1)], dim=-1),
                          torch.stack([-b2, torch.zeros_like(b2)], dim=-1)],
                         dim=-2)  # (n_bands, 2, 2)
    for s in range(4):
        a0 = a[:, s, 0, None]  # (n_bands, 1)
        a1 = a[:, s, 1, None]
        bvec = torch.stack([a1 - b1[:, None] * a0, -b2[:, None] * a0], dim=-1)  # (n_bands, 1, 2)
        z = sig[..., None] * bvec  # (T, n_bands, n_frames, 2)
        power, k = a_band, 1
        while k < frame_size:
            z = torch.cat([z[:k], z[k:] + torch.einsum("bij,tbfj->tbfi", power, z[:-k])])
            power, k = power @ power, 2 * k
        # y[t] reads the state before step t: shift the inclusive scan
        z0_prev = torch.cat([torch.zeros_like(z[:1, ..., 0]), z[:-1, ..., 0]])
        sig = a0 * sig + z0_prev
    return torch.sqrt((sig * sig).sum(dim=0) / frame_size)


def gammatone_iir_spectrogram(samples, sample_rate: float, frame_size: int, hop_size: int,
                              erb_params: ErbParams, dtype=None, method: str = "auto",
                              device=None):
    """(spectrogram (n_bands, n_frames), center_freqs) through the exact IIR bank.

    Frames take a Hann window with an (N−1) denominator; each band's output
    is the RMS of the 4th-order cascade with the state reset every frame;
    ``erb_params.db_floor`` converts to dB. The filter runs in float64 and
    the result is cast to ``dtype``. Computes on CUDA unless
    ``device="cpu"``.

    ``method``: ``"scan"`` steps through the frame's samples in the
    reference's order (a handful of small operations a sample, so
    ``frame_size`` × a few dozen launches on the card); ``"parallel"`` is the
    log-depth doubling scan; ``"auto"`` is ``"scan"``, as in JAX.
    """
    if sample_rate <= 0.0:
        raise InvalidInputError("sample_rate must be > 0")
    if method not in ("auto", "scan", "parallel"):
        raise InvalidInputError(f"method must be auto/scan/parallel, got {method!r}")
    dt = parse_dtype(dtype if dtype is not None else getattr(samples, "dtype", None))
    dev = resolve_device(device)
    x = torch.as_tensor(samples).to(device=dev, dtype=torch.float64).reshape(-1)
    if x.shape[0] < frame_size:
        raise InvalidInputError("signal is shorter than frame_size")

    cfs = gammatone_center_frequencies(erb_params)
    a, b = make_iir_bank(cfs, sample_rate)
    n1 = frame_size - 1
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(frame_size) / n1)

    n_frames = 1 + (x.shape[0] - frame_size) // hop_size
    impl = _gammatone_parallel_impl if method == "parallel" else _gammatone_impl
    f64 = dict(dtype=torch.float64, device=dev)
    out = impl(x, torch.tensor(window, **f64), torch.tensor(a, **f64), torch.tensor(b, **f64),
               int(frame_size), int(hop_size), int(n_frames))

    if erb_params.db_floor is not None:
        eps = 10.0 ** (erb_params.db_floor / 10.0)
        out = 10.0 * torch.log10(torch.clamp_min(out, eps))
    return out.to(dt), cfs
