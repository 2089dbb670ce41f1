"""MFCC: log-mel → DCT-II → sinusoidal liftering → optional C0 drop.

Counterpart of ``spectrograms_tpu.mfcc`` (math of the reference's
``src/mfcc.rs``): an unnormalized DCT-II basis with the lifter weights
``1 + (L/2)·sin(π·i/L)`` folded in, applied as one matmul over frames.

:class:`MfccPlan` is the flagship path. On the fused route the DCT (with C0
dropped when ``include_c0=False``) is folded into the CUDA kernel: signal in,
liftered coefficients out, one launch per ``compute_batch``, at the plan's
tier (``precision=DEFAULT`` and ``pallas:x2`` take the bf16 tensor-core
kernel). Gradients flow through the plain path. ``mfcc``/``compute_mfcc``
are the one-shots and ``delta`` the regression deltas.

With a multirate mel front end (``MelParams(multirate=True)``) the kernel is
built at the inner (decimated) geometry of the mel plan and fed the
decimated, 2^d-scaled signal; the DCT tail does not depend on the rate.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .dtypes import (check_true_f32, dlpack_export, numpy_dtype, parse_dtype, real_dtype_name,
                     result_data)
from .errors import InvalidInputError
from .params import LogParams, MelParams, MfccParams, SpectrogramParams, StftParams
from .pipeline import AmpScale, FreqScale, Spectrogram, SpectrogramPlan
from .windows import make_window
from .ops.filterbanks import mel_filterbank
from .ops.framing import frame_signal
from .ops.fused_factored import KernelConst, fused_factored_features
from .ops.gradients import kernel_forward_twin_grad
from .spans import span

__all__ = [
    "Mfcc",
    "MfccPlan",
    "mfcc",
    "compute_mfcc",
    "mfcc_from_log_mel",
    "delta",
    "dct_ii_matrix",
]


@lru_cache(maxsize=64)
def _dct_lifter_matrix(n_mels: int, n_mfcc: int, lifter: int):
    """(n_mels, n_mfcc) DCT-II basis with lifter weights folded in, f64."""
    i = np.arange(n_mels, dtype=np.float64)[:, None]
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    basis = np.cos(np.pi * k * (i + 0.5) / n_mels)
    if lifter > 0:
        w = 1.0 + (lifter / 2.0) * np.sin(np.pi * np.arange(n_mfcc) / lifter)
        basis = basis * w[None, :]
    basis.setflags(write=False)
    return basis


def dct_ii_matrix(n: int, n_out: Optional[int] = None) -> np.ndarray:
    """Unnormalized DCT-II basis matrix (n, n_out), f64."""
    return _dct_lifter_matrix(n, n_out if n_out is not None else n, 0)


@dataclass
class Mfcc:
    """MFCC result: data (n_mfcc[, -1 if C0 dropped] × n_frames) + params."""

    data: torch.Tensor
    params: MfccParams

    @property
    def n_coefficients(self) -> int:
        return self.data.shape[0]

    @property
    def n_bins(self) -> int:
        """Alias of n_coefficients (the reference's attribute name)."""
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


def _mfcc_core(log_mel_t, basis, include_c0: bool, n_mfcc: int):
    """(..., n_frames, n_mels) log-mel → (..., n_frames, n_out) MFCC."""
    coeffs = log_mel_t @ basis
    if not include_c0 and n_mfcc > 1:
        coeffs = coeffs[..., 1:]
    return coeffs


def mfcc_from_log_mel(log_mel_spec, params: MfccParams = MfccParams()) -> Mfcc:
    """MFCCs from a (n_mels, n_frames) log-mel (dB) spectrogram.

    Computes on the device the input lies on (numpy input: the CPU).
    """
    if isinstance(log_mel_spec, Spectrogram):
        log_mel_spec = log_mel_spec.data
    lm = torch.as_tensor(log_mel_spec)
    if lm.ndim != 2:
        raise InvalidInputError(f"log_mel_spec must be 2-D, got {tuple(lm.shape)}")
    n_mels = lm.shape[0]
    if params.n_mfcc > n_mels:
        raise InvalidInputError("n_mfcc must be <= n_mels")
    if lm.is_cuda and lm.dtype == torch.float32:
        check_true_f32()
    basis = torch.tensor(
        _dct_lifter_matrix(n_mels, params.n_mfcc, params.lifter),
        dtype=lm.dtype, device=lm.device,
    )
    out = _mfcc_core(lm.T, basis, params.include_c0, params.n_mfcc).T
    return Mfcc(data=out, params=params)


class MfccPlan:
    """Signal → mel-dB → DCT MFCC pipeline.

    With ``method="pallas[:opt]"`` (or ``auto`` for a float32 plan on CUDA)
    the whole chain is one launch of a fused kernel.
    """

    _span = "tg.plan.MfccPlan"

    def __init__(
        self,
        stft_params: StftParams,
        sample_rate_hz: float,
        n_mels: int = 40,
        mfcc_params: MfccParams = MfccParams(),
        mel_params: Optional[MelParams] = None,
        log_params: LogParams = LogParams(-80.0),
        dtype=None,
        method: str = "auto",
        precision=None,
        device=None,
    ):
        if mel_params is None:
            mel_params = MelParams(n_mels, 0.0, sample_rate_hz / 2.0)
        if mfcc_params.n_mfcc > mel_params.n_mels:
            raise InvalidInputError("n_mfcc must be <= n_mels")
        self.mfcc_params = mfcc_params
        self._method_arg = method  # what a copy on another device resolves anew
        self._dtype = parse_dtype(dtype)
        self._stft = stft_params
        self._log_params = log_params
        self._mel_plan = SpectrogramPlan(
            SpectrogramParams(stft_params, sample_rate_hz),
            FreqScale.MEL,
            AmpScale.DECIBELS,
            scale_params=mel_params,
            log_params=log_params,
            dtype=self._dtype,
            method=method,
            precision=precision,
            device=device,
        )
        self.device = self._mel_plan.device
        self.method = self._mel_plan.method
        kp = self._kernel_plan
        self._install_constants(
            make_window(kp.params.stft.window, kp._n_fft, np.float64),
            mel_filterbank(kp.params.sample_rate_hz, kp._n_fft, mel_params.with_multirate(False)),
            _dct_lifter_matrix(mel_params.n_mels, mfcc_params.n_mfcc, mfcc_params.lifter),
        )

    @property
    def _kernel_plan(self) -> SpectrogramPlan:
        """The mel plan whose geometry the kernel runs at: the multirate
        inner plan, or the mel plan itself."""
        mr = self._mel_plan._multirate_inner
        return self._mel_plan if mr is None else mr[1]

    def _install_constants(self, window64, mapping64, basis64):
        """(Re)build the device constants from the f64 window, mel matrix
        (n_mels, n_bins) and DCT-lifter basis (n_mels, n_mfcc). The window
        and the matrix are at the kernel's geometry: the inner plan's under
        multirate."""
        kp = self._kernel_plan
        kp._install_constants(window64, mapping64)
        self._basis = torch.tensor(basis64, dtype=self._dtype, device=self.device)
        if not kp.method.startswith("pallas"):
            self._forward = self._plain_forward
            return
        p = self.mfcc_params
        kernel_basis = basis64[:, 1:] if not p.include_c0 and p.n_mfcc > 1 else basis64
        run = fused_factored_features(
            kp._n_fft,
            kp._hop,
            tuple(np.asarray(window64, dtype=np.float64).tolist()),
            KernelConst(mapping64),
            amp="decibels",
            floor_db=float(self._log_params.floor_db),
            centre=kp._centre,
            dct_key=KernelConst(kernel_basis),
            device=str(self.device),
            **kp._kernel_kwargs,
        )
        self._kernel_run = run
        if kp is self._mel_plan:
            self._forward = kernel_forward_twin_grad(run, self._plain_forward)
            return
        mp = self._mel_plan

        def multirate_run(x):
            return run(mp._mr_pre(x))[..., : mp._mr_frames(x.shape[-1])]

        self._forward = kernel_forward_twin_grad(multirate_run, self._plain_forward)

    def _mfcc_tail(self, log_mel):
        """(..., n_mels, n_frames) log-mel → (..., n_out, n_frames)."""
        p = self.mfcc_params
        return _mfcc_core(log_mel.transpose(-1, -2), self._basis, p.include_c0,
                          p.n_mfcc).transpose(-1, -2)

    def _plain_forward(self, x):
        """The plain path: (..., n) → (..., n_out, n_frames)."""
        with span("tg.op.mfcc._plain_forward"):
            if self._mel_plan._multirate_inner is not None:
                return self._mfcc_tail(self._mel_plan._forward_impl(x))
            if x.is_cuda and x.dtype == torch.float32:
                check_true_f32()
            frames = frame_signal(x, self._stft.n_fft, self._stft.hop_size, self._stft.centre)
            log_mel_t = self._mel_plan._frames_to_bins(frames)
            p = self.mfcc_params
            return _mfcc_core(log_mel_t, self._basis, p.include_c0, p.n_mfcc).transpose(-1, -2)

    # ---- FeatureSet hooks (shared decimation cascade) ----------------------
    def _fs_cascade_spec(self):
        """The mel front end's decimation signature (``SpectrogramPlan``)."""
        return self._mel_plan._fs_cascade_spec()

    def _fs_forward_batch(self, xb, cascade=None):
        """Batched forward for a ``FeatureSet``, on its shared cascade."""
        mp = self._mel_plan
        if cascade is None or mp._multirate_inner is None:
            return self._forward(xb)
        d, inner = mp._multirate_inner
        n = xb.shape[-1]
        nf = mp._mr_frames(n)
        y = cascade.level_slice(d, mp._mr_pad, -(-(n + 2 * mp._mr_pad) // (1 << d))) * mp._mr_gain

        def plain(yb):
            return self._mfcc_tail(inner._forward_impl(yb)[..., :nf])

        if not inner.method.startswith("pallas"):
            return plain(y)
        return kernel_forward_twin_grad(lambda yb: self._kernel_run(yb)[..., :nf], plain)(y)

    def compute(self, samples) -> Mfcc:
        with span(self._span):
            x = torch.as_tensor(samples, dtype=self._dtype, device=self.device)
            if x.ndim != 1 or x.shape[0] == 0:
                raise InvalidInputError("expected a non-empty 1-D signal")
            return Mfcc(data=self._forward(x), params=self.mfcc_params)

    def compute_batch(self, batch) -> torch.Tensor:
        with span(self._span):
            xb = torch.as_tensor(batch, dtype=self._dtype, device=self.device)
            if xb.ndim != 2 or xb.shape[1] == 0:
                raise InvalidInputError(f"expected (batch, samples), got {tuple(xb.shape)}")
            return self._forward(xb)


def mfcc(
    samples,
    stft_params: StftParams,
    sample_rate: float,
    n_mels: int,
    mfcc_params: MfccParams = MfccParams(),
    dtype=None,
    device=None,
) -> Mfcc:
    """MFCCs straight from audio (the JAX package's ``mfcc``)."""
    plan = MfccPlan(stft_params, sample_rate, n_mels, mfcc_params, dtype=dtype, device=device)
    return plan.compute(samples)


def compute_mfcc(
    samples,
    stft_params: StftParams,
    sample_rate: float,
    n_mels: int = 40,
    mfcc_params: MfccParams = MfccParams(),
    dtype=None,
    device=None,
) -> Mfcc:
    """One-shot MFCC (the JAX package's ``compute_mfcc``).

    Examples
    --------
    >>> import numpy as np
    >>> from spectrograms_tpu_torch import MfccParams, StftParams, compute_mfcc
    >>> x = np.sin(2 * np.pi * 440 * np.arange(16000) / 16000)
    >>> m = compute_mfcc(x, StftParams(512, 256), 16000.0, n_mels=40,
    ...                  mfcc_params=MfccParams(n_mfcc=13), device="cpu")
    >>> tuple(m.data.shape)
    (13, 63)
    """
    return mfcc(samples, stft_params, sample_rate, n_mels, mfcc_params, dtype, device)


def delta(features, width: int = 9, order: int = 1):
    """Delta features by local linear regression with edge replication
    (librosa's ``feature.delta``), along the last axis.

    Computes on the device the input lies on (numpy input: the CPU).
    """
    with span("tg.op.mfcc.delta"):
        if width < 3 or width % 2 != 1:
            raise InvalidInputError("width must be an odd integer >= 3")
        if order < 1:
            raise InvalidInputError("order must be >= 1")
        x = torch.as_tensor(result_data(features))
        half = width // 2
        n = np.arange(-half, half + 1, dtype=np.float64)
        k = (n / np.sum(n * n)).astype(numpy_dtype(x.dtype))
        out = x
        for _ in range(order):
            fp = torch.cat([out[..., :1].expand(*out.shape[:-1], half), out,
                            out[..., -1:].expand(*out.shape[:-1], half)], dim=-1)
            # correlate along time: d[t] = sum_j k[j] f[t + j - half]
            out = sum(fp[..., i:i + out.shape[-1]] * float(k[i]) for i in range(width))
        return out
