"""Spectrogram plans and the result type, in PyTorch.

Counterpart of ``spectrograms_tpu.pipeline`` for LINEAR / MEL / LOG_HZ / ERB
/ CQT × POWER / MAGNITUDE / DECIBELS. A plan builds its constants once (window,
window-folded DFT matrices, filterbank, frequency axis) on its device and
runs one of these methods:

- ``matmul``: the windowed real DFT as a matmul over hop slices of the
  signal (``framed_matmul``) → |·|² → filterbank matmul → amplitude;
- ``fft``: frames → ``torch.fft.rfft`` → |·|² → filterbank → amplitude;
- ``pallas`` and ``pallas:<opt>``: a fused CUDA kernel (``ops.fused_factored``);
  gradients flow through the plain path (``ops.gradients``). The names are
  the JAX package's. ``precision=HIGH`` (the default) runs the f32 kernel,
  ``precision=DEFAULT`` the 1-pass bf16 tier and ``pallas:x2`` the 2-pass
  tier on tensor cores, as the JAX package's tiers do on the MXU;
- ``factored``: frames → the two-stage Cooley-Tukey rFFT of
  ``ops.fft_factored`` (a 128-point DFT product, then radix 2) → |·|² →
  filterbank → amplitude (n_fft = 128·2^k in 256..4096);
- ``f32x2``: the f64-grade tier of a float32 plan. ``compute_raw_x2``
  returns each value as an (hi, lo) float32 pair; the JAX package computes
  it in double-double on f32 hardware, the port in native float64 on the
  device (window, rFFT, |·|², filterbank, amplitude), split as hi =
  the correctly rounded f32, lo = the f32 of the remainder. ``compute``
  returns hi. ``_bins_x2_dd`` keeps JAX's op-for-op dd arithmetic
  (``ops/dd.py``) as the plain version.

``auto`` mirrors the JAX rule: the fused kernel for MEL/LOG_HZ/ERB float32
plans on a CUDA device (where the JAX package requires a TPU), unless
``precision=HIGHEST``; ``fft`` for float64 or n_fft > 4096; else ``matmul``.
It never picks ``factored`` or ``f32x2``.

The JAX package's ``vmap`` becomes an explicit batch axis: ``compute_batch``
runs the same function on a (B, n) tensor. Entry points compute on CUDA
unless given ``device="cpu"``.

``StftPlan`` is the complex STFT (``StftResult``) and ``SpectrogramPlanner``
the plan factory, with the 15 named ``{scale}_{amp}_plan`` builders that
return the typed plans of ``plans.py``.

CQT plans (``FreqScale.CQT``) correlate unwindowed frames with the
``[re | −im]`` kernels of ``ops/cqt.py`` in one framed matmul, or, when the
truncation policy elects it, run the octave-stacked multirate CQT
(``cqt.multirate_ri_blocks``) on a lazy decimation cascade; ``method`` does
not change their arithmetic, and ``pallas`` and ``f32x2`` refuse them, as in
JAX.

``MelParams``/``LogHzParams(multirate=True)`` run the band-limited multirate
route: an inner plan at n_fft/2^d, hop/2^d and sr/2^d (the same bin and
frame grids) computes on an anti-aliased 2^d-decimated copy of the signal
(``ops.decimate``), scaled by 2^d, and on CUDA launches the same kernels at
that geometry; an ``f32x2`` plan stays at the full rate, as in JAX.
``compute_frame`` is the streaming single-frame path.
"""

from __future__ import annotations

import enum
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cqt import multirate_ri_blocks
from .dtypes import (
    Precision,
    check_true_f32,
    dlpack_export,
    ensure_plan_dtype,
    parse_dtype,
    real_dtype_name,
    resolve_device,
)
from .errors import DimensionMismatchError, InvalidInputError
from .params import (
    CqtParams,
    ErbParams,
    LogHzParams,
    LogParams,
    MelParams,
    SpectrogramParams,
    StftParams,
    r2c_output_size,
)
from .spans import span
from .windows import WindowType, make_window
from .ops import filterbanks as fb
from .ops.decimate import band_limited_decimation_depth, decimate_pow2_framed
from .ops import dd as dd_ops
from .ops.dft import MATMUL_MAX_N_FFT, rdft_matrices
from .ops.fft_factored import FactoredRfft, supports_factored
from .ops import cqt as cqt_ops
from .ops.framing import frame_count, frame_signal, framed_matmul, tail_framed_matmul
from .ops import stft as stft_ops
from .ops.fused_factored import (
    KernelConst,
    fused_factored_features,
    parse_pallas_method,
    supports_factored_fusion,
)
from .ops.gradients import kernel_forward_twin_grad

__all__ = [
    "FreqScale",
    "AmpScale",
    "Spectrogram",
    "SpectrogramPlan",
    "SpectrogramPlanner",
    "StftPlan",
    "StftResult",
]


class FreqScale(enum.Enum):
    """Frequency axis scale (reference marker types LinearHz/Mel/LogHz/Erb/Cqt)."""

    LINEAR = "linear"
    MEL = "mel"
    LOG_HZ = "log_hz"
    ERB = "erb"
    CQT = "cqt"


class AmpScale(enum.Enum):
    """Amplitude scale (reference marker types Power/Magnitude/Decibels)."""

    POWER = "power"
    MAGNITUDE = "magnitude"
    DECIBELS = "decibels"


def _apply_amp(mapped, amp: AmpScale, floor_db: Optional[float]):
    """Power-domain → requested amplitude scale (``spectrogram.rs:2068-2080``)."""
    if amp == AmpScale.POWER:
        return mapped
    if amp == AmpScale.MAGNITUDE:
        return torch.sqrt(mapped)
    fd = -80.0 if floor_db is None else float(floor_db)
    return 10.0 * torch.log10(torch.clamp_min(mapped, 10.0 ** (fd / 10.0)))


@dataclass
class Spectrogram:
    """Computed spectrogram: data (n_bins × n_frames) + axes + params.

    ``data`` is a torch tensor on the plan's device; the axes are host
    float64 numpy.
    """

    data: torch.Tensor
    frequencies: np.ndarray
    times: np.ndarray
    params: SpectrogramParams
    freq_scale: FreqScale
    amp_scale: AmpScale
    floor_db: Optional[float] = None

    @property
    def n_bins(self) -> int:
        return self.data.shape[0]

    @property
    def n_frames(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def T(self) -> torch.Tensor:
        """(n_frames, n_bins) transposed view of the data."""
        return self.data.T

    def astype(self, dtype) -> torch.Tensor:
        """The data cast to ``dtype``: a tensor, not a Spectrogram."""
        if not isinstance(dtype, torch.dtype):
            try:
                dtype = parse_dtype(dtype)  # the float spellings, bfloat16 included
            except InvalidInputError:
                dtype = torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype
        return self.data.to(dtype)

    def __getitem__(self, idx):
        """Index straight into the (n_bins, n_frames) data."""
        return self.data[idx]

    def __iter__(self):
        """Rows of the data, stopping at ``n_bins``."""
        return iter(self.data)

    def __len__(self) -> int:
        """Number of time frames (the reference's contract). It counts
        frames, while ``__getitem__``/``__iter__`` index the (bins, frames)
        data: the same asymmetry the reference ships."""
        return self.n_frames

    def duration(self) -> float:
        """Duration spanned by the time axis (last frame time), seconds."""
        return float(self.times[-1]) if len(self.times) else 0.0

    def frequency_range(self) -> Tuple[float, float]:
        """(f_min, f_max) of the bin axis."""
        if len(self.frequencies) == 0:
            return (0.0, 0.0)
        return (float(self.frequencies[0]), float(self.frequencies[-1]))

    def db_range(self) -> Optional[Tuple[float, float]]:
        """(min, max) of the data when in decibels, else None."""
        if self.amp_scale != AmpScale.DECIBELS:
            return None
        return (float(self.data.min()), float(self.data.max()))

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

    def block_until_ready(self) -> "Spectrogram":
        """Wait for the work that produces the data: a synchronize of the
        data's current CUDA stream (nothing to wait for on the CPU)."""
        if self.data.is_cuda:
            torch.cuda.current_stream(self.data.device).synchronize()
        return self

    def __repr__(self) -> str:
        return (
            f"Spectrogram({self.freq_scale.value}/{self.amp_scale.value}, "
            f"{self.n_bins} bins x {self.n_frames} frames, dtype={self.dtype})"
        )


def kernel_kwargs(method: str, precision: Precision) -> dict:
    """``fused_factored_features`` kwargs of a ``pallas[:opt]`` plan: the
    variant options, and the tier (an explicit ``x2`` wins over the plan's
    ``DEFAULT`` → bf16 / otherwise bf16x3), as the JAX plans pop it."""
    if not method.startswith("pallas"):
        return {}
    kw = parse_pallas_method(method)
    kw.setdefault("precision", "bf16" if precision == Precision.DEFAULT else "bf16x3")
    return kw


def _resolve_method(method: str, n_fft: int, hop: int, dtype, freq_scale,
                    precision, device: torch.device) -> str:
    if method.startswith("pallas:"):
        parse_pallas_method(method)  # validates the options eagerly
    elif method not in ("auto", "matmul", "factored", "fft", "pallas", "f32x2"):
        raise InvalidInputError(
            f"unknown method {method!r}; expected "
            "auto/matmul/factored/fft/pallas[:variant]/f32x2"
        )
    if method == "f32x2":
        if dtype != torch.float32:
            raise InvalidInputError("method='f32x2' is the f64-grade tier of a float32 "
                                    "plan; use dtype='float32' (a float64 plan already "
                                    "computes in f64)")
        if n_fft & (n_fft - 1):
            raise InvalidInputError(
                f"method='f32x2' requires a power-of-two n_fft, got {n_fft}"
            )
        if freq_scale == FreqScale.CQT:
            raise InvalidInputError("method='f32x2' does not cover CQT plans")
    if method == "auto":
        if dtype == torch.float64 or n_fft > MATMUL_MAX_N_FFT:
            return "fft"
        if (
            freq_scale in (FreqScale.MEL, FreqScale.LOG_HZ, FreqScale.ERB)
            and supports_factored_fusion(n_fft, hop, dtype)
            and device.type == "cuda"
            # As in the JAX package, auto never picks the kernel under an
            # explicit HIGHEST request (a pallas plan rejects it).
            and precision != Precision.HIGHEST
        ):
            return "pallas"
        return "matmul"
    if method == "factored" and not supports_factored(n_fft):
        raise InvalidInputError(
            f"method='factored' requires n_fft = 128 * 2^k in 256..4096, got {n_fft}"
        )
    return method


class SpectrogramPlan:
    """A reusable spectrogram pipeline for one configuration.

    ``compute`` runs it over a 1-D signal, ``compute_batch`` over a (B, n)
    batch. Constants live on ``device`` (CUDA unless ``device="cpu"``).
    """

    _span = "tg.plan.SpectrogramPlan"

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._span = "tg.plan." + cls.__name__

    def __init__(
        self,
        params: SpectrogramParams,
        freq_scale: FreqScale,
        amp_scale: AmpScale,
        scale_params=None,
        log_params: Optional[LogParams] = None,
        dtype=None,
        method: str = "auto",
        precision: Optional[Precision] = None,
        device=None,
    ):
        self.params = params
        self.freq_scale = freq_scale
        self.amp_scale = amp_scale
        self.scale_params = scale_params
        self.log_params = log_params
        self.device = resolve_device(device)
        self._dtype = parse_dtype(dtype)
        ensure_plan_dtype(self._dtype)
        if precision is None:
            precision = (
                Precision.HIGHEST if self._dtype == torch.float64 else Precision.HIGH
            )
        if not isinstance(precision, Precision):
            raise InvalidInputError(f"precision must be a Precision, got {precision!r}")
        self.precision = precision

        stft_p = params.stft
        n_fft, hop = stft_p.n_fft, stft_p.hop_size
        sr = params.sample_rate_hz
        self.method = _resolve_method(
            method, n_fft, hop, self._dtype, freq_scale, self.precision, self.device
        )
        self._method_arg = method  # what a copy on another device resolves anew

        mapping = None  # (n_out, n_bins) f64, or None for identity
        self._cqt_bands = self._cqt_multirate = None
        if freq_scale == FreqScale.LINEAR:
            freqs = np.arange(r2c_output_size(n_fft), dtype=np.float64) * (sr / n_fft)
        elif freq_scale == FreqScale.MEL:
            if not isinstance(scale_params, MelParams):
                raise InvalidInputError("mel plan requires MelParams")
            if scale_params.f_max > params.nyquist_hz():
                raise InvalidInputError("f_max must be <= Nyquist")
            mapping = fb.mel_filterbank(sr, n_fft, scale_params)
            freqs = fb.mel_band_centres_hz(scale_params.n_mels, sr, params.nyquist_hz())
        elif freq_scale == FreqScale.LOG_HZ:
            if not isinstance(scale_params, LogHzParams):
                raise InvalidInputError("log-hz plan requires LogHzParams")
            mapping, freqs = fb.loghz_matrix(sr, n_fft, scale_params)
        elif freq_scale == FreqScale.ERB:
            if not isinstance(scale_params, ErbParams):
                raise InvalidInputError("erb plan requires ErbParams")
            if scale_params.f_max > params.nyquist_hz():
                raise InvalidInputError("f_max must be <= Nyquist")
            mapping, freqs = fb.erb_filterbank(sr, n_fft, scale_params)
        elif freq_scale == FreqScale.CQT:
            freqs = self._init_cqt(scale_params, stft_p.centre)
        else:
            raise InvalidInputError(f"unknown freq scale {freq_scale}")
        self.frequencies = np.asarray(freqs, dtype=np.float64)
        self.n_output_bins = len(self.frequencies)

        self._floor_db = None if log_params is None else log_params.floor_db
        if amp_scale == AmpScale.DECIBELS and self._floor_db is None:
            self._floor_db = -80.0
        self._n_fft, self._hop, self._centre = n_fft, hop, stft_p.centre

        if self.method.startswith("pallas"):
            if freq_scale == FreqScale.CQT:
                raise InvalidInputError("method='pallas' does not cover CQT plans")
            if self.precision == Precision.HIGHEST:
                raise InvalidInputError(
                    "method='pallas' keeps the JAX package's precision contract "
                    "(DEFAULT/HIGH tiers) and does not take precision=HIGHEST; "
                    "use method='fft' or 'matmul' for it"
                )
            if not supports_factored_fusion(n_fft, hop, self._dtype):
                raise InvalidInputError(
                    "method='pallas' requires float32 and n_fft = 128·2^k in "
                    f"256..4096 (any hop); got n_fft={n_fft}, hop={hop}. Use "
                    "method='auto' or 'matmul' for other sizes"
                )
        self._kernel_kwargs = kernel_kwargs(self.method, self.precision)
        window64 = make_window(stft_p.window, n_fft, np.float64)
        self._multirate_inner = None
        self._install_constants(window64, mapping)
        if (freq_scale in (FreqScale.MEL, FreqScale.LOG_HZ) and scale_params.multirate
                and self.method != "f32x2"):  # the f64-grade tier stays at the full rate
            self._init_multirate(method, window64)

    def _init_cqt(self, scale_params, centre: bool) -> np.ndarray:
        """The CQT constants (``pipeline.py:398-485`` of the JAX package);
        returns the bin frequencies.

        The truncation policy (``ops.cqt.resolve_cqt_policy``) may elect the
        full-Q octave stack, and ``self.scale_params`` then says so. The
        fused ``[re | −im]`` kernel ``_cqt_ri`` (n_fft, 2·n_out) gives re and
        im from one pass over the frames; it is also the single-rate
        fallback of ``compute_frame`` on a multirate plan. Bands
        (``CQT_BANDING``) contract each bin band against its frame tail
        only. Built in f64 and cast to the plan's dtype."""
        if not isinstance(scale_params, CqtParams):
            raise InvalidInputError("cqt plan requires CqtParams")
        stft_p = self.params.stft
        n_fft, hop, sr = stft_p.n_fft, stft_p.hop_size, self.params.sample_rate_hz
        if scale_params.bin_frequency(scale_params.num_bins - 1) >= sr / 2.0:
            raise InvalidInputError("CQT maximum frequency must be below Nyquist frequency")
        scale_params = cqt_ops.resolve_cqt_policy(scale_params, sr, n_fft, hop, centre)
        self.scale_params = scale_params
        k_re, k_im, freqs = cqt_ops.cqt_kernel_matrices(scale_params, sr, n_fft)
        self._cqt_n_out = k_re.shape[0]
        bands = (
            cqt_ops.plan_cqt_bands(cqt_ops.cqt_kernel_lengths(scale_params, sr, n_fft), n_fft, hop)
            if cqt_ops.CQT_BANDING else [(0, self._cqt_n_out, n_fft)]
        )
        groups = None
        if scale_params.multirate:
            groups, _ = cqt_ops.multirate_cqt_groups(scale_params, sr, n_fft, hop, centre,
                                                     depth=scale_params.multirate_depth)
            self._cqt_mr_composite = scale_params.multirate_depth == "max"
        self._install_cqt_constants(
            np.concatenate([k_re.T, k_im.T], axis=1),
            None if len(bands) == 1 else [
                (start, stop, s, np.concatenate([k_re[start:stop, n_fft - s:].T,
                                                 k_im[start:stop, n_fft - s:].T], axis=1))
                for start, stop, s in bands],
            groups,
        )
        return freqs

    def _install_cqt_constants(self, ri64: np.ndarray, bands64, groups64) -> None:
        """(Re)build the CQT's device constants from f64 arrays: the
        (n_fft, 2·n_out) kernel, the bands ``(start, stop, s, k_ri)`` or
        None, and the multirate groups ``(d, k_ri, e0, flen, jp)`` or None."""
        dt, dev = self._dtype, self.device
        self._cqt_ri = torch.tensor(ri64, dtype=dt, device=dev)
        self._cqt_bands = None if bands64 is None else [
            (start, stop, s, torch.tensor(k, dtype=dt, device=dev))
            for start, stop, s, k in bands64]
        self._cqt_multirate = None if groups64 is None else [
            (d, torch.tensor(k, dtype=dt, device=dev), e0, flen, jp)
            for d, k, e0, flen, jp in groups64]

    def _init_multirate(self, method: str, window64: np.ndarray) -> None:
        """The band-limited multirate route (``pipeline.py:605-690`` of the
        JAX package). The mapping is zero above f_max, so an inner plan at
        sr/2^d over n_fft/2^d (the same bin grid) with the full-rate window
        sampled every 2^d-th point and ``centre=False`` computes on the
        decimated copy of the signal, centre-padded at the full rate; the
        2^d gain restores the full-rate DFT scale (X_full = 2^d · X_dec)."""
        d = band_limited_decimation_depth(self.params.sample_rate_hz, self._n_fft, self._hop,
                                          self.scale_params.f_max)
        if method.startswith("pallas"):
            # An explicit kernel request stays buildable at the inner
            # geometry (n_fft >= 256): cap the depth instead of raising.
            while d and self._n_fft // 2**d < 256:
                d -= 1
        if not d:
            return
        D = 2**d
        inner = SpectrogramPlan(
            SpectrogramParams(
                StftParams(self._n_fft // D, self._hop // D,
                           WindowType.custom(np.ascontiguousarray(window64[::D])), centre=False),
                self.params.sample_rate_hz / D,
            ),
            self.freq_scale,
            self.amp_scale,
            scale_params=self.scale_params.with_multirate(False),
            log_params=self.log_params,
            dtype=self._dtype,
            method=method,
            precision=self.precision,
            device=self.device,
        )
        self._multirate_inner = (d, inner)
        self._mr_pad = self._n_fft // 2 if self._centre else 0
        self._mr_gain = float(D)
        # The decimator's flavour key (FeatureSet); its products are f32.
        self._mr_decim_prec = (
            Precision.HIGHEST if self.precision == Precision.HIGHEST else Precision.HIGH
        )
        self._forward = self._mr_forward

    def _mr_pre(self, x):
        """Full-rate centre pad, anti-aliased 2^d decimation, 2^d gain."""
        d, _ = self._multirate_inner
        if self._mr_pad:
            x = F.pad(x, (self._mr_pad, self._mr_pad))
        return decimate_pow2_framed(x, d, self._mr_decim_prec) * self._mr_gain

    def _mr_frames(self, n: int) -> int:
        """The full-rate frame count: the decimated grid can gain a trailing
        frame when n is not a multiple of 2^d."""
        return frame_count(n, self._n_fft, self._hop, self._centre)

    def _mr_forward(self, x):
        """Multirate forward: the inner plan's (kernel) forward on the
        decimated signal, trimmed to the full-rate frames."""
        return self._multirate_inner[1]._forward(self._mr_pre(x))[..., : self._mr_frames(x.shape[-1])]

    def _install_constants(self, window64: np.ndarray, mapping64: Optional[np.ndarray]):
        """(Re)build every device constant from the f64 window and mapping."""
        dt, dev = self._dtype, self.device
        self._window = torch.tensor(window64, dtype=dt, device=dev)
        self._mapping_t = (
            None if mapping64 is None
            else torch.tensor(mapping64.T, dtype=dt, device=dev)  # (n_bins, n_out)
        )
        if self.freq_scale == FreqScale.CQT:  # the kernels carry their own window
            self._forward = self._forward_impl
            return
        if self.method == "matmul" or self.method.startswith("pallas"):
            c, s = rdft_matrices(self._n_fft, window64, dt, dev)
            # One (n_fft, 2·n_bins) [C | S] constant: one product gives re and im.
            self._dft_cs = torch.cat([c, s], dim=1)
        if self.method == "factored":
            self._factored = FactoredRfft(self._n_fft, window64, dt, dev)
        if self.method == "f32x2":
            self._window64 = torch.tensor(window64, dtype=torch.float64, device=dev)
            self._mapping64_t = (None if mapping64 is None else
                                 torch.tensor(mapping64.T, dtype=torch.float64, device=dev))
        if self.method.startswith("pallas"):
            self._kernel_run = fused_factored_features(
                self._n_fft,
                self._hop,
                tuple(np.asarray(window64, dtype=np.float64).tolist()),
                "identity" if mapping64 is None else KernelConst(mapping64),
                amp=self.amp_scale.value,
                floor_db=self._floor_db if self._floor_db is not None else -80.0,
                centre=self._centre,
                device=str(dev),
                **self._kernel_kwargs,
            )
            self._forward = kernel_forward_twin_grad(self._kernel_run, self._forward_impl)
        else:
            self._forward = self._forward_impl
        if self._multirate_inner is not None:
            self._forward = self._mr_forward

    # ---- core math ------------------------------------------------------
    def _bins(self, re, im):
        """DFT re, im (..., n_frames, n_bins) → (..., n_frames, n_out) features."""
        power = re * re + im * im
        mapped = power if self._mapping_t is None else power @ self._mapping_t
        return _apply_amp(mapped, self.amp_scale, self._floor_db)

    def _frames_to_bins(self, frames):
        """(..., n_frames, n_fft) raw frames → (..., n_frames, n_out) features."""
        if self.freq_scale == FreqScale.CQT:
            # Unwindowed frames: the kernels carry their own window.
            if self._cqt_bands is not None:
                mapped = torch.cat([
                    self._cqt_power(frames[..., self._n_fft - s:] @ k_ri, stop - start)
                    for start, stop, s, k_ri in self._cqt_bands], dim=-1)
            else:
                mapped = self._cqt_power(frames @ self._cqt_ri)
            return _apply_amp(mapped, self.amp_scale, self._floor_db)
        if self.method == "f32x2":
            return self._bins_x2(frames)[0]  # hi: the correctly rounded f32
        if self.method == "fft":
            spec = torch.fft.rfft(frames * self._window, dim=-1)
            return self._bins(spec.real, spec.imag)
        if self.method == "factored":
            return self._bins(*self._factored(frames))
        return self._bins(*(frames @ self._dft_cs).chunk(2, dim=-1))

    def _bins_x2(self, frames):
        """The f32x2 tier: (..., n_frames, n_fft) f32 frames → the (hi, lo)
        pair of (..., n_frames, n_out), computed in float64 on the device
        and split (``ops.dd.dd_from_f64``). Decibels are 10·log10 in f64
        too, so lo carries their f64 remainder (JAX's dd tier returns lo = 0
        and an f32 log with a first-order correction)."""
        spec = torch.fft.rfft(frames.double() * self._window64, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        mapped = power if self._mapping64_t is None else power @ self._mapping64_t
        return dd_ops.dd_from_f64(_apply_amp(mapped, self.amp_scale, self._floor_db))

    def _bins_x2_dd(self, frames):
        """The plain version of :meth:`_bins_x2`: the JAX package's
        double-double arithmetic op for op (``ops/dd.py``), from f32 ops
        alone, its dB included (an f32 log10 with a first-order correction,
        lo = 0)."""
        D = dd_ops
        fr = (frames.float(), torch.zeros(frames.shape, dtype=torch.float32,
                                          device=frames.device))
        xw = D.dd_mul(fr, D.dd_from_f64(self._window64))
        re, im = D.dd_rfft(xw, self._n_fft)
        p = D.dd_add(D.dd_mul(re, re), D.dd_mul(im, im))
        if self._mapping64_t is not None:
            p = D.dd_matvec(D.dd_from_f64(self._mapping64_t.T), p)
        if self.amp_scale == AmpScale.MAGNITUDE:
            p = D.dd_sqrt(p)
        elif self.amp_scale == AmpScale.DECIBELS:
            eps = float(np.float32(10.0 ** (self._floor_db / 10.0)))
            hi = torch.clamp_min(p[0], eps)
            corr = torch.where(p[0] > eps, p[1] / (hi * float(np.float32(np.log(10.0)))), 0.0)
            db = 10.0 * (torch.log10(hi) + corr)
            p = (db, torch.zeros_like(db))
        return p

    def compute_raw_x2(self, samples):
        """The f64-grade result as an (hi, lo) float32 pair, each
        (n_bins, n_frames); only on ``method='f32x2'`` plans. ``hi`` alone
        is :meth:`compute_raw`; ``ops.dd.dd_to_f64`` recombines the pair."""
        if self.method != "f32x2":
            raise InvalidInputError("compute_raw_x2 requires a method='f32x2' plan")
        frames = frame_signal(self._validate_signal(samples), self._n_fft, self._hop,
                              self._centre)
        hi, lo = self._bins_x2(frames)
        return hi.T, lo.T

    def _forward_frames(self, frames):
        """(..., n_frames, n_fft) raw frames → (..., n_frames, n_out): the
        full-rate frames step of ``compute_frame`` and streaming."""
        if frames.is_cuda and frames.dtype == torch.float32:
            check_true_f32()
        return self._frames_to_bins(frames)

    def _cqt_power(self, ri, n_out: Optional[int] = None):
        """|re|² + |im|² of a [re | −im] product."""
        n_out = self._cqt_n_out if n_out is None else n_out
        re, im = ri[..., :n_out], ri[..., n_out:]
        return re * re + im * im

    def _cqt_mr_forward(self, x, level_provider=None):
        """The octave-stacked CQT, (..., n) → (..., n_out, n_frames).
        ``level_provider`` lets a ``FeatureSet`` hand in its shared cascade."""
        with span("tg.op.pipeline._cqt_mr_forward"):
            if x.is_cuda and x.dtype == torch.float32:
                check_true_f32()
            nf = frame_count(x.shape[-1], self._n_fft, self._hop, self._centre)
            blocks = multirate_ri_blocks(x, self._cqt_multirate, self._hop, nf, self.precision,
                                         composite=self._cqt_mr_composite,
                                         level_provider=level_provider)
            mapped = torch.cat([self._cqt_power(ri, ri.shape[-1] // 2) for ri in blocks], dim=-1)
            return _apply_amp(mapped, self.amp_scale, self._floor_db).transpose(-1, -2)

    def _cqt_forward(self, x):
        """The CQT plan's forward: the octave stack, or the framed matmul of
        the dense kernels (of each band against its frame tail when banded)."""
        if self._cqt_multirate is not None:
            return self._cqt_mr_forward(x)
        if self._cqt_bands is not None:
            mapped = torch.cat([
                self._cqt_power(tail_framed_matmul(x, k_ri, self._n_fft, self._hop, s,
                                                   self._centre), stop - start)
                for start, stop, s, k_ri in self._cqt_bands], dim=-1)
        else:
            mapped = self._cqt_power(framed_matmul(x, self._cqt_ri, self._n_fft, self._hop,
                                                   self._centre))
        return _apply_amp(mapped, self.amp_scale, self._floor_db).transpose(-1, -2)

    def _forward_impl(self, x):
        """The plain path: (..., n) → (..., n_out, n_frames)."""
        with span("tg.op.pipeline._forward_impl"):
            if self._multirate_inner is not None:
                inner = self._multirate_inner[1]
                return inner._forward_impl(self._mr_pre(x))[..., : self._mr_frames(x.shape[-1])]
            if x.is_cuda and x.dtype == torch.float32:
                check_true_f32()
            if self.freq_scale == FreqScale.CQT:
                return self._cqt_forward(x)
            if self.method == "matmul":
                # Window folded into [C | S], so frames stay raw: one pass over
                # the signal's hop slices gives re and im together.
                ri = framed_matmul(x, self._dft_cs, self._n_fft, self._hop, self._centre)
                return self._bins(*ri.chunk(2, dim=-1)).transpose(-1, -2)
            frames = frame_signal(x, self._n_fft, self._hop, self._centre)
            return self._frames_to_bins(frames).transpose(-1, -2)

    # ---- public API -------------------------------------------------------
    @property
    def dtype(self) -> str:
        return str(self._dtype).removeprefix("torch.")

    def output_shape(self, n_samples: int) -> Tuple[int, int]:
        """(n_bins, n_frames) for a signal of the given length."""
        return (
            self.n_output_bins,
            frame_count(n_samples, self._n_fft, self._hop, self._centre),
        )

    def _times(self, n_frames: int) -> np.ndarray:
        return np.arange(n_frames, dtype=np.float64) * self.params.frame_period_seconds()

    def _as_tensor(self, samples):
        return torch.as_tensor(samples, dtype=self._dtype, device=self.device)

    def _validate_signal(self, samples):
        x = self._as_tensor(samples)
        if x.ndim != 1:
            raise InvalidInputError(f"expected 1-D signal, got shape {tuple(x.shape)}")
        if x.shape[0] == 0:
            raise InvalidInputError("signal must be non-empty")
        return x

    def compute(self, samples) -> Spectrogram:
        """Full spectrogram of a 1-D signal."""
        with span(self._span):
            data = self._forward(self._validate_signal(samples))
            return Spectrogram(
                data=data,
                frequencies=self.frequencies,
                times=self._times(data.shape[1]),
                params=self.params,
                freq_scale=self.freq_scale,
                amp_scale=self.amp_scale,
                floor_db=self._floor_db,
            )

    def compute_raw(self, samples) -> torch.Tensor:
        """Like :meth:`compute` but returns only the (n_bins, n_frames) tensor."""
        with span(self._span):
            return self._forward(self._validate_signal(samples))

    def compute_batch(self, batch) -> torch.Tensor:
        """(B, n) signal batch → (B, n_bins, n_frames)."""
        with span(self._span):
            xb = self._as_tensor(batch)
            if xb.ndim != 2:
                raise InvalidInputError(f"expected (batch, samples), got {tuple(xb.shape)}")
            if xb.shape[1] == 0:
                raise InvalidInputError("signal must be non-empty")
            return self._forward(xb)

    def compute_frame(self, samples, frame_idx: int) -> torch.Tensor:
        """Frame ``frame_idx`` of the signal's spectrogram, (n_bins,): the
        streaming single-frame path (``compute_frame``, spectrogram.rs:335).

        A multirate plan runs the full-rate path here and warns once: its
        frames match ``compute()``'s decimated route to ~1e-5 relative, not
        bit for bit. A multirate CQT plan falls back to the truncated
        single-rate kernels (one frame lacks the low octaves' context), and
        warns once that its low bins will not match ``compute()``.
        """
        x = self._validate_signal(samples)
        if (self.freq_scale == FreqScale.CQT and self._cqt_multirate is not None
                and not getattr(self, "_warned_multirate_frame", False)):
            warnings.warn(
                "compute_frame on a multirate CQT plan uses the truncated "
                "single-rate kernels (a lone frame lacks the low-octave "
                "context); low-bin values will not match compute()",
                stacklevel=2,
            )
            self._warned_multirate_frame = True
        if self._multirate_inner is not None and not getattr(self, "_warned_multirate_frame", False):
            warnings.warn(
                "compute_frame on a multirate mel/log-Hz plan runs the "
                "full-rate path; values match compute()'s decimated path to "
                "~1e-5 relative, not bitwise",
                stacklevel=2,
            )
            self._warned_multirate_frame = True
        frame = _extract_frame(x, frame_idx, self._n_fft, self._hop, self._centre)
        return self._forward_frames(frame[None, :])[0]

    def compute_into(self, samples, out: np.ndarray) -> np.ndarray:
        """Compute into a preallocated numpy array (``compute_into``,
        spectrogram.rs:414): a copy from the device into ``out``. Prefer
        :meth:`compute` for on-device pipelines."""
        with span(self._span):
            x = self._validate_signal(samples)
            expected = self.output_shape(x.shape[0])
            if tuple(out.shape) != expected:
                raise DimensionMismatchError(expected, tuple(out.shape))
            np.copyto(out, self._forward(x).detach().cpu().numpy())
            return out

    # ---- FeatureSet hooks (shared decimation cascade) ----------------------
    def _fs_cascade_spec(self):
        """``(composite, precision, pad, depths)`` of the decimation front
        end, or None: members of a ``FeatureSet`` with equal (composite,
        precision) share one ``DecimationCascade``. A multirate CQT reads
        its levels unpadded, at its own composite mode and its precision."""
        if self._cqt_multirate is not None:
            depths = tuple(sorted({g[0] for g in self._cqt_multirate if g[0]}))
            if not depths:
                return None
            return (self._cqt_mr_composite, self.precision, 0, depths)
        if self._multirate_inner is None:
            return None
        return (True, self._mr_decim_prec, self._mr_pad, (self._multirate_inner[0],))

    def _fs_forward_batch(self, xb, cascade=None):
        """Batched forward for a ``FeatureSet``, on its shared cascade."""
        if cascade is None or self._fs_cascade_spec() is None:
            return self._forward(xb)
        n = xb.shape[-1]
        if self._cqt_multirate is not None:
            return self._cqt_mr_forward(
                xb, level_provider=lambda d: cascade.level_slice(d, 0, -(-n // (1 << d))))
        d, inner = self._multirate_inner
        y = cascade.level_slice(d, self._mr_pad, -(-(n + 2 * self._mr_pad) // (1 << d)))
        return inner._forward(y * self._mr_gain)[..., : self._mr_frames(n)]


def _extract_frame(x, frame_idx: int, n_fft: int, hop: int, centre: bool):
    """Frame ``frame_idx`` of a 1-D signal, (n_fft,): the signal padded by
    ``n_fft//2`` in front under ``centre`` and by a whole frame behind, so a
    frame that runs past the end reads zeros."""
    nf = frame_count(x.shape[0], n_fft, hop, centre)
    if frame_idx < 0 or frame_idx >= nf:
        raise InvalidInputError(f"frame_idx {frame_idx} out of range (n_frames={nf})")
    pad = n_fft // 2 if centre else 0
    start = frame_idx * hop
    return F.pad(x, (pad, pad + n_fft))[start : start + n_fft]


@dataclass
class StftResult:
    """Complex STFT matrix and its axes (``StftResult``, spectrogram.rs and
    python/params.rs:319). ``data`` is ([channels,] n_bins, n_frames)
    complex, on the plan's device."""

    data: torch.Tensor
    frequencies: np.ndarray
    sample_rate: float
    params: StftParams

    @property
    def n_bins(self) -> int:
        return self.data.shape[-2]

    @property
    def n_frames(self) -> int:
        return self.data.shape[-1]

    @property
    def n_channels(self) -> int:
        return self.data.shape[0] if self.data.ndim == 3 else 1

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self) -> str:
        """Real-precision dtype name (reference getter, params.rs:362)."""
        return real_dtype_name(self.data.dtype)

    @property
    def frequency_resolution(self) -> float:
        """Hz per bin = sample_rate / n_fft."""
        return float(self.sample_rate) / self.params.n_fft

    @property
    def time_resolution(self) -> float:
        """Seconds per frame = hop_size / sample_rate."""
        return self.params.hop_size / float(self.sample_rate)

    def norm(self) -> torch.Tensor:
        """Magnitude |X| at the matching real precision."""
        return self.data.abs()

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


class StftPlan:
    """Reusable complex STFT plan (``StftPlan``, spectrogram.rs:1173-1636).

    ``compute`` takes a 1-D signal or a (channels, n) matrix; the window
    lives on ``device`` (CUDA unless ``device="cpu"``).
    """

    def __init__(self, params: SpectrogramParams, dtype=None, device=None):
        self.params = params
        self.device = resolve_device(device)
        self._dtype = parse_dtype(dtype)
        ensure_plan_dtype(self._dtype)
        stft_p = params.stft
        self._n_fft, self._hop, self._centre = stft_p.n_fft, stft_p.hop_size, stft_p.centre
        self._window = torch.tensor(make_window(stft_p.window, self._n_fft, np.float64),
                                    dtype=self._dtype, device=self.device)

    @property
    def dtype(self) -> str:
        return str(self._dtype).removeprefix("torch.")

    def frame_count(self, n_samples: int) -> int:
        return frame_count(n_samples, self._n_fft, self._hop, self._centre)

    def compute(self, samples) -> StftResult:
        spec = stft_ops.stft(samples, self._n_fft, self._hop, self.params.stft.window,
                             self._centre, dtype=self._dtype, device=self.device)
        freqs = np.arange(spec.shape[-2], dtype=np.float64) * (
            self.params.sample_rate_hz / self._n_fft
        )
        return StftResult(data=spec, frequencies=freqs,
                          sample_rate=self.params.sample_rate_hz, params=self.params.stft)

    def compute_frame(self, samples, frame_idx: int) -> torch.Tensor:
        """Complex spectrum of one frame, (n_bins,): the streaming path."""
        x = torch.as_tensor(samples, dtype=self._dtype, device=self.device)
        frame = _extract_frame(x, frame_idx, self._n_fft, self._hop, self._centre)
        return torch.fft.rfft(frame * self._window, n=self._n_fft)


class SpectrogramPlanner:
    """Plan factory (``SpectrogramPlanner``, spectrogram.rs:640-1153, and
    the 15 PyO3 plan builders, python/planner.rs:107-668). It carries a
    default dtype, method and device for the plans it builds."""

    def __init__(self, dtype=None, method: str = "auto", device=None):
        self._default_dtype = dtype
        self._default_method = method
        self._default_device = device

    def _pick(self, dtype, method, device):
        return (dtype if dtype is not None else self._default_dtype,
                method if method is not None else self._default_method,
                device if device is not None else self._default_device)

    # ---- generic builders -------------------------------------------------
    def linear_plan(self, params, amp=AmpScale.POWER, db=None, dtype=None, method=None,
                    device=None):
        return self._plan(params, FreqScale.LINEAR, amp, None, db, dtype, method, device)

    def mel_plan(self, params, mel: MelParams, amp=AmpScale.POWER, db=None, dtype=None,
                 method=None, device=None):
        return self._plan(params, FreqScale.MEL, amp, mel, db, dtype, method, device)

    def log_hz_plan(self, params, loghz: LogHzParams, amp=AmpScale.POWER, db=None, dtype=None,
                    method=None, device=None):
        return self._plan(params, FreqScale.LOG_HZ, amp, loghz, db, dtype, method, device)

    def erb_plan(self, params, erb: ErbParams, amp=AmpScale.POWER, db=None, dtype=None,
                 method=None, device=None):
        return self._plan(params, FreqScale.ERB, amp, erb, db, dtype, method, device)

    def cqt_plan(self, params, cqt: CqtParams, amp=AmpScale.POWER, db=None, dtype=None,
                 method=None, device=None):
        return self._plan(params, FreqScale.CQT, amp, cqt, db, dtype, method, device)

    def _plan(self, params, scale, amp, scale_params, db, dtype, method, device):
        dtype, method, device = self._pick(dtype, method, device)
        return SpectrogramPlan(params, scale, amp, scale_params=scale_params, log_params=db,
                               dtype=dtype, method=method, device=device)

    # ---- STFT plan ----------------------------------------------------------
    def stft_plan(self, params, dtype=None, device=None) -> StftPlan:
        dtype, _, device = self._pick(dtype, None, device)
        return StftPlan(params, dtype=dtype, device=device)

    # ---- one-shots (the planner's compute_* methods) -----------------------
    def compute_stft(self, samples, params: SpectrogramParams, dtype=None,
                     device=None) -> StftResult:
        return self.stft_plan(params, dtype, device).compute(samples)

    def compute_power_spectrum(self, samples, n_fft, window=None, dtype=None, device=None):
        dtype, _, device = self._pick(dtype, None, device)
        return stft_ops.power_spectrum(samples, n_fft, window, dtype, device)

    def compute_magnitude_spectrum(self, samples, n_fft, window=None, dtype=None, device=None):
        dtype, _, device = self._pick(dtype, None, device)
        return stft_ops.magnitude_spectrum(samples, n_fft, window, dtype, device)


# The 15 named {scale}_{amp}_plan builders on SpectrogramPlanner (the PyO3
# matrix, planner.rs:107-668). Each returns the typed plan class of
# ``plans.py`` (MelDbPlan, LinearPowerPlan, ...), imported at call time: that
# module imports this one.
def _install_named_builders():
    amp_map = {"power": ("Power", AmpScale.POWER), "magnitude": ("Magnitude", AmpScale.MAGNITUDE),
               "db": ("Db", AmpScale.DECIBELS)}
    scale_info = {"linear": ("Linear", False), "mel": ("Mel", True), "erb": ("Erb", True),
                  "loghz": ("LogHz", True), "cqt": ("Cqt", True)}
    for scale_name, (cls_scale, needs_params) in scale_info.items():
        for amp_name, (cls_amp, amp) in amp_map.items():
            cls_name = f"{cls_scale}{cls_amp}Plan"

            def build(self, params, scale_args, db, dtype, method, device,
                      _cls_name=cls_name, _amp=amp):
                from . import plans

                dtype, method, device = self._pick(dtype, method, device)
                return getattr(plans, _cls_name)(
                    params, *scale_args, db=db if _amp == AmpScale.DECIBELS else None,
                    dtype=dtype, method=method, device=device,
                )

            if needs_params:
                def builder(self, params, scale_params, db=None, dtype=None, method=None,
                            device=None, _build=build):
                    return _build(self, params, (scale_params,), db, dtype, method, device)
            else:
                def builder(self, params, db=None, dtype=None, method=None, device=None,
                            _build=build):
                    return _build(self, params, (), db, dtype, method, device)
            name = f"{scale_name}_{amp_name}_plan"
            builder.__name__ = name
            builder.__doc__ = f"Build a {scale_name} {amp_name} spectrogram plan."
            setattr(SpectrogramPlanner, name, builder)


_install_named_builders()
