"""FFT-based 1-D linear convolution, deconvolution and streaming overlap-save.

Counterpart of ``spectrograms_tpu.convolution`` (the reference's
``convolution.rs``):

- ``fft_convolve``: both signals zero-padded to ``next_pow2(la + lb − 1)``,
  spectra multiplied, the result cut to ``la + lb − 1``;
- ``fft_deconvolve``: regularized spectral division
  ``N·conj(D) / (|D|² + ε)``, ``ε = regularization · max|D|²``; output length
  ``la − lb + 1``, at least 1;
- ``OverlapSaveConvolver``: the impulse response's spectrum is built once;
  each block transforms ``[history | block]``, multiplies and keeps the
  alias-free tail. ``step(history, block)`` is the pure step,
  ``process_block`` carries the history on the device, and
  ``process_signal`` filters a whole signal.

The carried state is input history only, so every output block depends on
the input alone: ``process_signal`` frames the zero-prefixed signal at hop
= block and runs one batched ``rfft``/``irfft`` over all blocks, where the
JAX package scans the step. Entry points compute on CUDA unless given
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .dtypes import complex_dtype, parse_dtype, resolve_device
from .errors import InvalidInputError

__all__ = [
    "fft_convolve",
    "fft_deconvolve",
    "OverlapSaveConvolver",
    "next_power_of_two",
]


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _signals(a, b, dtype, device, what: str):
    dt = parse_dtype(dtype if dtype is not None else getattr(a, "dtype", None))
    dev = resolve_device(device)
    xa = torch.as_tensor(a, dtype=dt, device=dev)
    xb = torch.as_tensor(b, dtype=dt, device=dev)
    if xa.ndim != 1 or xb.ndim != 1 or xa.shape[0] == 0 or xb.shape[0] == 0:
        raise InvalidInputError(f"{what} expects non-empty 1-D signals")
    return xa, xb


def fft_convolve(a, b, dtype=None, device=None) -> torch.Tensor:
    """Linear convolution via FFT; output length ``len(a)+len(b)−1``."""
    xa, xb = _signals(a, b, dtype, device, "fft_convolve")
    out_len = xa.shape[0] + xb.shape[0] - 1
    n_fft = next_power_of_two(out_len)
    spec = torch.fft.rfft(xa, n=n_fft) * torch.fft.rfft(xb, n=n_fft)
    return torch.fft.irfft(spec, n=n_fft)[:out_len]


def fft_deconvolve(numerator, denominator, regularization: float = 1e-6, dtype=None,
                   device=None) -> torch.Tensor:
    """Regularized spectral-division deconvolution.

    Output length ``len(numerator) − len(denominator) + 1`` (≥ 1); pass the
    full linear-convolution output as the numerator to avoid circular
    aliasing.
    """
    xn, xd = _signals(numerator, denominator, dtype, device, "fft_deconvolve")
    n_len, d_len = xn.shape[0], xd.shape[0]
    n_fft = next_power_of_two(max(n_len, d_len))
    out_len = max(1, n_len - d_len + 1) if n_len >= d_len else n_len
    fn_ = torch.fft.rfft(xn, n=n_fft)
    fd = torch.fft.rfft(xd, n=n_fft)
    d2 = fd.real ** 2 + fd.imag ** 2
    denom = d2 + float(regularization) * d2.max()
    zero = denom == 0
    quotient = torch.where(zero, 0.0, fn_ * fd.conj() / torch.where(zero, 1.0, denom))
    return torch.fft.irfft(quotient, n=n_fft)[:out_len]


class OverlapSaveConvolver:
    """Streaming overlap-save FIR convolution with carried history state.

    ``process_block`` keeps the reference's mutable-object API; ``step`` is
    the pure ``(history, block) → (history', out)`` function, and
    ``process_signal`` filters a whole signal in one batched transform.
    """

    def __init__(self, ir, block: int, dtype=None, device=None):
        ir = np.asarray(ir, dtype=np.float64).ravel()
        if ir.size == 0:
            raise InvalidInputError("impulse response must not be empty")
        if block <= 0:
            raise InvalidInputError("block size must be > 0")
        self._dtype = parse_dtype(dtype)
        self.device = resolve_device(device)
        self._block = int(block)
        self._n_fft = next_power_of_two(self._block + ir.size - 1)
        self._overlap = self._n_fft - self._block
        h = np.zeros(self._n_fft, dtype=np.float64)
        h[: ir.size] = ir
        self._install(np.fft.rfft(h), np.zeros(self._overlap))

    def _install(self, h_spec: np.ndarray, history: np.ndarray) -> None:
        """(Re)build the IR spectrum (n_fft//2+1,) and the history (overlap,)
        on the device, from numpy arrays (``convert.convolver_state_from_numpy``)."""
        self._h_spec = torch.tensor(np.asarray(h_spec), dtype=complex_dtype(self._dtype),
                                    device=self.device)
        self._history = torch.tensor(np.asarray(history), dtype=self._dtype, device=self.device)

    @property
    def block_size(self) -> int:
        return self._block

    @property
    def fft_size(self) -> int:
        return self._n_fft

    def reset(self) -> None:
        """Clear the overlap history to silence."""
        self._history = self.initial_state

    @property
    def initial_state(self) -> torch.Tensor:
        return torch.zeros(self._overlap, dtype=self._dtype, device=self.device)

    def _filter(self, windows):
        """(..., n_fft) windows → (..., block) alias-free outputs."""
        spec = torch.fft.rfft(windows, dim=-1) * self._h_spec
        return torch.fft.irfft(spec, n=self._n_fft, dim=-1)[..., self._overlap:]

    def step(self, history, block_in):
        """Pure functional step: (history, block) → (history', output)."""
        history = torch.as_tensor(history, device=self.device)
        block_in = torch.as_tensor(block_in, device=self.device)
        window = torch.cat([history, block_in])  # (n_fft,)
        new_history = window[self._block:] if self._overlap > 0 else history
        return new_history, self._filter(window).to(block_in.dtype)

    def process_block(self, block_in) -> torch.Tensor:
        """Filter one block, carrying internal history. Returns the output block."""
        x = torch.as_tensor(block_in, dtype=self._dtype, device=self.device)
        if tuple(x.shape) != (self._block,):
            raise InvalidInputError(
                f"process_block expects input of length {self._block} (got {tuple(x.shape)})"
            )
        self._history, out = self.step(self._history, x)
        return out

    def process_signal(self, signal) -> torch.Tensor:
        """Filter a whole signal from silence (the internal history is not
        read or changed): every block's window at once, one batched FFT.

        Signal length must be a multiple of the block size.
        """
        x = torch.as_tensor(signal, dtype=self._dtype, device=self.device)
        if x.ndim != 1 or x.shape[0] % self._block != 0:
            raise InvalidInputError(
                f"signal length must be a multiple of block size {self._block}"
            )
        windows = F.pad(x, (self._overlap, 0)).unfold(0, self._n_fft, self._block)
        return self._filter(windows).reshape(-1)
