"""Chromagram: 12 pitch-class energy profiles, in PyTorch.

Counterpart of ``spectrograms_tpu.chroma``: the Gaussian pitch-class
filterbank (``ops.filterbanks.chroma_filterbank``) applied to the magnitude
spectrogram, then per-frame None/L1/L2/Max normalization.

:class:`ChromaPlan` is the fused kernel's second caller: with
``method="pallas[:opt]"`` (or ``auto`` for a float32 plan on CUDA, where the
JAX package picks the kernel on a TPU) one launch computes signal →
|X| → chroma filterbank (``pre_amp="magnitude"``), at the plan's tier:
``precision=HIGH`` runs the f32 kernel, ``DEFAULT`` and ``pallas:x2`` the
bf16 tensor-core kernel. Gradients flow through the plain path.

``ChromaParams(multirate=True)``: the bank is zero outside [f_min, f_max],
so the plan computes on an anti-aliased 2^d-decimated copy at n_fft/2^d and
hop/2^d (the same bin and frame grids), with the full-rate window sampled
every 2^d-th point, the centre padding applied at the full rate, and the
chroma scaled by 2^d; the kernel runs at that geometry.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .dtypes import (
    Precision,
    check_true_f32,
    dlpack_export,
    parse_dtype,
    real_dtype_name,
    resolve_device,
    result_data,
)
from .errors import DimensionMismatchError, InvalidInputError
from .params import ChromaNorm, ChromaParams, SpectrogramParams, StftParams, r2c_output_size
from .pipeline import AmpScale, FreqScale, SpectrogramPlan, kernel_kwargs
from .windows import WindowType, make_window
from .ops.decimate import band_limited_decimation_depth, decimate_pow2_framed
from .ops.filterbanks import chroma_filterbank
from .ops.framing import frame_count, frame_signal
from .ops.fused_factored import KernelConst, fused_factored_features, supports_factored_fusion
from .ops.gradients import kernel_forward_twin_grad
from .spans import span

__all__ = [
    "Chromagram",
    "chromagram",
    "chromagram_from_spectrogram",
    "compute_chromagram",
    "ChromaPlan",
    "apply_chroma_normalization",
]


@dataclass
class Chromagram:
    """Chromagram result: (12, n_frames) + params."""

    data: torch.Tensor
    params: ChromaParams

    labels = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")

    @property
    def n_bins(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> str:
        return real_dtype_name(self.data.dtype)

    @property
    def n_frames(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self):
        return tuple(self.data.shape)

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.to_numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __dlpack__(self, stream=None, max_version=None, dl_device=None, copy=None):
        """DLPack export, the Array-API arguments checked (``dlpack_export``)."""
        return dlpack_export(self.data, stream, max_version, dl_device, copy)

    def __dlpack_device__(self):
        return self.data.__dlpack_device__()


def apply_chroma_normalization(chroma_t, norm: ChromaNorm):
    """Per-frame normalization over the last (12 pitch classes) axis.

    Zero frames are left unchanged (guarded divides), as in the JAX package.
    """
    if norm == ChromaNorm.NONE:
        return chroma_t
    if norm == ChromaNorm.L1:
        denom = torch.sum(chroma_t, dim=-1, keepdim=True)
    elif norm == ChromaNorm.L2:
        denom = torch.sqrt(torch.sum(chroma_t * chroma_t, dim=-1, keepdim=True))
    elif norm == ChromaNorm.MAX:
        denom = torch.amax(chroma_t, dim=-1, keepdim=True)
    else:  # pragma: no cover
        raise InvalidInputError(f"unknown ChromaNorm {norm}")
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.where(denom > 0, chroma_t / safe, chroma_t)


def chromagram_from_spectrogram(
    spectrogram,
    sample_rate: float,
    n_fft: int,
    params: ChromaParams = ChromaParams.music_standard(),
) -> Chromagram:
    """Chromagram from a (n_bins, n_frames) magnitude/power spectrogram.

    Computes on the device the input lies on (numpy input: the CPU).
    """
    spec = torch.as_tensor(result_data(spectrogram))
    if spec.ndim != 2:
        raise InvalidInputError(f"spectrogram must be 2-D, got {tuple(spec.shape)}")
    expected = r2c_output_size(n_fft)
    if spec.shape[0] != expected:
        raise DimensionMismatchError(expected, spec.shape[0])
    if spec.is_cuda and spec.dtype == torch.float32:
        check_true_f32()
    fb = torch.tensor(chroma_filterbank(sample_rate, n_fft, params).T,
                      dtype=spec.dtype, device=spec.device)
    chroma_t = apply_chroma_normalization(spec.T @ fb, params.norm)
    return Chromagram(data=chroma_t.T, params=params)


class ChromaPlan:
    """Signal → magnitude STFT → chroma, one fused launch on the kernel route.

    ``compute`` runs it over a 1-D signal, ``compute_batch`` over a (B, n)
    batch. Constants live on ``device`` (CUDA unless ``device="cpu"``).
    """

    _span = "tg.plan.ChromaPlan"

    def __init__(
        self,
        stft_params: StftParams,
        sample_rate_hz: float,
        chroma_params: ChromaParams = ChromaParams.music_standard(),
        dtype=None,
        method: str = "auto",
        precision=None,
        device=None,
    ):
        self.params = chroma_params
        self._method_arg = method  # what a copy on another device resolves anew
        self._dtype = parse_dtype(dtype)
        self._stft = stft_params
        self._sample_rate_hz = float(sample_rate_hz)
        dev = resolve_device(device)
        d = (band_limited_decimation_depth(sample_rate_hz, stft_params.n_fft,
                                           stft_params.hop_size, chroma_params.f_max)
             if chroma_params.multirate else 0)
        self._decimation = d
        window64 = make_window(stft_params.window, stft_params.n_fft, np.float64)
        if d:
            # Each decimated frame is the continuous windowed frame sampled
            # coarser (w[2^d·m]·x(t₀+2^d·m·T)); centre padding is applied at
            # the full rate, so the decimator's edge transient sits under
            # the window's tails.
            window64 = np.ascontiguousarray(window64[:: 2**d])
            self._stft_eff = StftParams(stft_params.n_fft // 2**d, stft_params.hop_size // 2**d,
                                        WindowType.custom(window64), centre=False)
        else:
            self._stft_eff = stft_params
        sr_eff = sample_rate_hz / 2**d
        self._centre_pad = stft_params.n_fft // 2 if (d and stft_params.centre) else 0
        self._decim_prec = Precision.HIGHEST if precision == Precision.HIGHEST else Precision.HIGH
        is_pallas = method.startswith("pallas")
        self._pallas_factored = (
            (method == "auto" or is_pallas)
            and self._dtype == torch.float32
            and precision != Precision.HIGHEST
            and supports_factored_fusion(self._stft_eff.n_fft, self._stft_eff.hop_size,
                                         self._dtype)
            and (is_pallas or dev.type == "cuda")
        )
        # The linear-magnitude helper plan (at the decimated geometry under
        # multirate) backs the plain path; the fused kernel replaces it.
        self._mag_plan = SpectrogramPlan(
            SpectrogramParams(self._stft_eff, sr_eff),
            FreqScale.LINEAR,
            AmpScale.MAGNITUDE,
            dtype=self._dtype,
            method="auto" if self._pallas_factored else method,
            precision=precision,
            device=dev,
        )
        self.device = self._mag_plan.device
        self.precision = self._mag_plan.precision
        if self._pallas_factored:
            self.method = method if is_pallas else "pallas"
        else:
            self.method = self._mag_plan.method
        self._install_constants(window64, chroma_filterbank(sr_eff, self._stft_eff.n_fft,
                                                            chroma_params))

    def _install_constants(self, window64, fb64):
        """(Re)build the device constants from the f64 window (n_fft,) and
        chroma filterbank (12, n_bins), at the decimated geometry under
        multirate."""
        self._mag_plan._install_constants(window64, None)
        self._fb_t = torch.tensor(fb64.T, dtype=self._dtype, device=self.device)
        if not self._pallas_factored:
            self._forward = self._plain_forward
            return
        st = self._stft_eff
        self._kernel_run = fused_factored_features(
            st.n_fft,
            st.hop_size,
            tuple(np.asarray(window64, dtype=np.float64).tolist()),
            KernelConst(fb64),
            amp="power",
            pre_amp="magnitude",
            centre=st.centre,
            device=str(self.device),
            **kernel_kwargs(self.method, self.precision),
        )
        self._forward = kernel_forward_twin_grad(
            lambda x: self._kernel_post(self._pre(x), self._n_frames(x.shape[-1])),
            self._plain_forward)

    def _pre(self, x):
        """Full-rate centre pad and anti-aliased 2^d decimation (none at d=0)."""
        if not self._decimation:
            return x
        if self._centre_pad:
            x = F.pad(x, (self._centre_pad, self._centre_pad))
        return decimate_pow2_framed(x, self._decimation, self._decim_prec)

    def _n_frames(self, n: int) -> int:
        """The full-rate frame count (the decimated grid can gain a frame)."""
        return frame_count(n, self._stft.n_fft, self._stft.hop_size, self._stft.centre)

    def _normalize(self, chroma):
        """(..., 12, n_frames) → scaled by 2^d, normalized over the 12 classes."""
        with span("tg.op.chroma._normalize"):
            if self._decimation:
                chroma = chroma * float(2**self._decimation)
            norm = self.params.norm
            return apply_chroma_normalization(chroma.transpose(-1, -2), norm).transpose(-1, -2)

    def _kernel_post(self, y, nf: int):
        """The kernel on a (pre-decimated) signal, trimmed and normalized."""
        return self._normalize(self._kernel_run(y)[..., :nf])

    def _plain_post(self, y, nf: int):
        """The plain path on a (pre-decimated) signal: (..., 12, nf)."""
        with span("tg.op.chroma._plain_post"):
            if y.is_cuda and y.dtype == torch.float32:
                check_true_f32()
            st = self._stft_eff
            frames = frame_signal(y, st.n_fft, st.hop_size, st.centre)
            mag_t = self._mag_plan._frames_to_bins(frames)[..., :nf, :]   # (..., nf, n_bins)
            return self._normalize((mag_t @ self._fb_t).transpose(-1, -2))

    def _plain_forward(self, x):
        """The plain path: (..., n) → (..., 12, n_frames)."""
        return self._plain_post(self._pre(x), self._n_frames(x.shape[-1]))

    # ---- FeatureSet hooks (shared decimation cascade) ----------------------
    def _fs_cascade_spec(self):
        """``(composite, precision, pad, depths)`` or None (see ``SpectrogramPlan``)."""
        if not self._decimation:
            return None
        return (True, self._decim_prec, self._centre_pad, (self._decimation,))

    def _fs_forward_batch(self, xb, cascade=None):
        """Batched forward for a ``FeatureSet``, on its shared cascade."""
        if cascade is None or not self._decimation:
            return self._forward(xb)
        d, n = self._decimation, xb.shape[-1]
        nf = self._n_frames(n)
        y = cascade.level_slice(d, self._centre_pad, -(-(n + 2 * self._centre_pad) // (1 << d)))
        if not self._pallas_factored:
            return self._plain_post(y, nf)
        return kernel_forward_twin_grad(lambda yb: self._kernel_post(yb, nf),
                                        lambda yb: self._plain_post(yb, nf))(y)

    def compute(self, samples) -> Chromagram:
        with span(self._span):
            x = torch.as_tensor(samples, dtype=self._dtype, device=self.device)
            if x.ndim != 1 or x.shape[0] == 0:
                raise InvalidInputError("expected a non-empty 1-D signal")
            return Chromagram(data=self._forward(x), params=self.params)

    def compute_batch(self, batch) -> torch.Tensor:
        with span(self._span):
            xb = torch.as_tensor(batch, dtype=self._dtype, device=self.device)
            if xb.ndim != 2 or xb.shape[1] == 0:
                raise InvalidInputError(f"expected (batch, samples), got {tuple(xb.shape)}")
            return self._forward(xb)


def chromagram(
    samples,
    stft_params: StftParams,
    sample_rate: float,
    chroma_params: ChromaParams = ChromaParams.music_standard(),
    dtype=None,
    device=None,
) -> Chromagram:
    """Chromagram straight from audio via the magnitude spectrogram."""
    plan = ChromaPlan(stft_params, sample_rate, chroma_params, dtype=dtype, device=device)
    return plan.compute(samples)


def compute_chromagram(
    samples,
    stft_params: StftParams,
    sample_rate: float,
    chroma_params: ChromaParams = ChromaParams.music_standard(),
    dtype=None,
    device=None,
) -> Chromagram:
    """One-shot chromagram (the JAX package's ``compute_chromagram``).

    Examples
    --------
    A pure A4 (440 Hz) concentrates its energy in pitch class A (index 9):

    >>> import numpy as np
    >>> from spectrograms_tpu_torch import StftParams, compute_chromagram
    >>> x = np.sin(2 * np.pi * 440 * np.arange(44100) / 44100)
    >>> ch = compute_chromagram(x, StftParams(4096, 1024), 44100.0, device="cpu")
    >>> ch.data.shape[0]
    12
    >>> int(ch.data.mean(dim=1).argmax())
    9
    """
    return chromagram(samples, stft_params, sample_rate, chroma_params, dtype, device)
