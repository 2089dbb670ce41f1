"""MDCT / IMDCT, the lapped orthogonal transform of MP3/AAC/Vorbis/Opus, in PyTorch.

Counterpart of ``spectrograms_tpu.mdct``, with the reference's definitions
(``mdct.rs``):

- forward: ``C[k] = Σ_{n=0}^{2N-1} x[n]·w[n]·cos(π(2n+1+N)(2k+1)/(4N))``
- inverse frame: ``y[m] = (2/N)·Σ_k C[k]·cos(π(2m+1+N)(2k+1)/(4N))``, then
  the synthesis window and overlap-add (``imdct_frame``, ``:328-365``)
- ``MdctParams.sine_window``: ``w[n] = sin(π(n+½)/2N)`` at 50 % hop, which
  reconstructs perfectly (TDAC), ``:104-127``
- framing: no centre padding, ``n_frames = (len − 2N)//hop + 1``; the
  inverse gives ``hop·n_frames + 2N − hop`` samples, optionally cut.

The default (``method="auto"``, as in JAX) is the dense (2N × N) cosine
basis with the window folded in, one framed matmul over all frames; the
inverse folds overlap-add into its matmul when ``hop | 2N``
(``ops.ola.ola_matmul``). ``method="folded"`` is the TDAC-folded (N × N)
DCT-IV form, half the multiply-adds. The public functions take a 1-D signal
(2-D coefficients); the private ``_mdct_impl``/``_imdct_impl`` and their
folded twins take leading batch dimensions.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .dtypes import check_precision, check_true_f32, parse_dtype, resolve_device
from .errors import InvalidInputError
from .ops.framing import frame_count, frame_signal, framed_matmul
from .ops.ola import ola_matmul, overlap_add
from .windows import WindowType, make_window, parse_window
from .spans import span

__all__ = ["MdctParams", "mdct", "imdct", "compute_mdct", "compute_imdct"]


@dataclass(frozen=True)
class MdctParams:
    """MDCT parameters: window_size (=2N, even, ≥4), hop_size, window."""

    window_size: int
    hop_size: int
    window: WindowType = WindowType.HANNING

    def __post_init__(self):
        ws, hop = self.window_size, self.hop_size
        if not isinstance(ws, int) or ws % 2 != 0:
            raise InvalidInputError(f"window_size must be even, got {ws}")
        if ws < 4:
            raise InvalidInputError(f"window_size must be >= 4, got {ws}")
        if not isinstance(hop, int) or hop <= 0:
            raise InvalidInputError("hop_size must be > 0")
        if isinstance(self.window, str):
            object.__setattr__(self, "window", parse_window(self.window))

    @staticmethod
    def sine_window(window_size: int) -> "MdctParams":
        """Sine window + 50 % hop → perfect reconstruction (TDAC)."""
        n = int(window_size)
        if n % 2 != 0:
            raise InvalidInputError(f"window_size must be even, got {n}")
        if n < 4:
            raise InvalidInputError(f"window_size must be >= 4, got {n}")
        coeffs = np.sin(np.pi * (np.arange(n, dtype=np.float64) + 0.5) / n)
        return MdctParams(n, n // 2, WindowType.custom(coeffs.tolist()))

    @property
    def n_coefficients(self) -> int:
        return self.window_size // 2


@lru_cache(maxsize=32)
def _mdct_basis(two_n: int, window_key):
    """(2N, N) cosine basis with the analysis window folded in, and the
    (N, 2N) inverse basis (2/N)·basisᵀ with the synthesis window, f64."""
    n = two_n // 2
    m = np.arange(two_n, dtype=np.float64)[:, None]
    k = np.arange(n, dtype=np.float64)[None, :]
    basis = np.cos(np.pi * (2.0 * m + 1.0 + n) * (2.0 * k + 1.0) / (4.0 * n))
    w = np.asarray(window_key, dtype=np.float64)[:, None]
    fwd, inv = basis * w, (2.0 / n) * basis.T * w.T
    for a in (fwd, inv):
        a.setflags(write=False)
    return fwd, inv


@lru_cache(maxsize=32)
def _folded_consts(two_n: int, window_key):
    """DCT-IV matrix and the fold's window parts, f64.

    TDAC fold (from the basis symmetry; quarters a|b|c|d of the windowed 2N
    frame, h = N/2):

        u[0:h]  = −rev(c·w_c) − d·w_d
        u[h:N]  =      a·w_a  − rev(b·w_b)
        C       = u @ D4,   D4[n,k] = cos(π(2n+1)(2k+1)/(4N))  (symmetric)

    and the inverse unfold of v = (2/N)·C @ D4:

        frame = [v₂, −rev(v₂), −rev(v₁), −v₁] · w     (v = [v₁ | v₂])
    """
    n = two_n // 2
    h = n // 2
    i = np.arange(n, dtype=np.float64)
    d4 = np.cos(np.pi * (2.0 * i[:, None] + 1.0) * (2.0 * i[None, :] + 1.0) / (4.0 * n))
    w = np.asarray(window_key, dtype=np.float64)
    out = (d4, w[0:h].copy(), w[h:n][::-1].copy(), w[n:n + h][::-1].copy(), w[n + h:].copy(), w)
    for a in out:
        a.setflags(write=False)
    return out


def _window_key(params: MdctParams) -> tuple:
    """The f64 window as a hashable cache key."""
    return tuple(make_window(params.window, params.window_size, np.float64).tolist())


@lru_cache(maxsize=32)
def _device_consts(two_n: int, window_key, folded: bool, dtype: torch.dtype,
                   device: torch.device):
    """The dense bases or the folded constants as tensors on ``device``."""
    arrays = (_folded_consts if folded else _mdct_basis)(two_n, window_key)
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in arrays)


def _consts_for(params: MdctParams, folded: bool, dtype: torch.dtype, device: torch.device):
    return _device_consts(params.window_size, _window_key(params), folded, dtype, device)


def _quarters(x, two_n: int, hop: int, n_frames: int):
    """The four (..., n_frames, N/2) quarters of every frame: strided row
    slices of one reshape when N/2 divides hop, else slices of the frame
    matrix."""
    h = two_n // 4
    if hop % h == 0:
        s = hop // h
        rows = (n_frames - 1) * s + 4
        xp = torch.nn.functional.pad(x, (0, max(0, rows * h - x.shape[-1])))[..., : rows * h]
        xr = xp.reshape(*x.shape[:-1], rows, h)
        end = (n_frames - 1) * s + 1
        return tuple(xr[..., q : q + end : s, :] for q in range(4))
    frames = frame_signal(x, two_n, hop, centre=False)
    return tuple(frames[..., q * h : (q + 1) * h] for q in range(4))


def _mdct_folded_impl(x, d4, wa, wb_r, wc_r, wd, two_n: int, hop: int):
    """(..., n) → (..., N, n_frames) through the TDAC fold and one DCT-IV matmul."""
    n_frames = frame_count(x.shape[-1], two_n, hop, centre=False)
    a, b, c, d = _quarters(x, two_n, hop, n_frames)
    u_first = torch.flip(c, dims=(-1,)) * (-wc_r) - d * wd
    u_second = a * wa - torch.flip(b, dims=(-1,)) * wb_r
    u = torch.cat([u_first, u_second], dim=-1)  # (..., n_frames, N)
    return (u @ d4).transpose(-1, -2)


def _imdct_folded_impl(coeffs_t, d4, w, two_n: int, hop: int):
    """(..., n_frames, N) → (..., hop·(n_frames−1) + 2N): DCT-IV, unfold, window, OLA."""
    n = two_n // 2
    v = (coeffs_t @ d4) * (2.0 / n)
    v1, v2 = v[..., : n // 2], v[..., n // 2:]
    frames = torch.cat([v2, -torch.flip(v2, dims=(-1,)), -torch.flip(v1, dims=(-1,)), -v1],
                       dim=-1) * w
    return overlap_add(frames, hop)


def _mdct_impl(x, fwd_basis, two_n: int, hop: int):
    """(..., n) → (..., N, n_frames): one framed matmul against the windowed
    basis (``frame_count(centre=False)`` is the MDCT framing exactly)."""
    with span("tg.op.mdct._mdct_impl"):
        return framed_matmul(x, fwd_basis, two_n, hop, centre=False).transpose(-1, -2)


def _imdct_impl(coeffs_t, inv_basis, two_n: int, hop: int):
    """(..., n_frames, N) → (..., hop·(n_frames−1) + 2N): the inverse basis
    with overlap-add fused into the matmul when ``hop | 2N``."""
    with span("tg.op.mdct._imdct_impl"):
        if two_n % hop == 0 and two_n > hop:
            return ola_matmul(coeffs_t, inv_basis, hop)
        return overlap_add(coeffs_t @ inv_basis, hop)


def _use_folded(two_n: int, method: str) -> bool:
    """``auto`` is the dense basis, as in JAX (where the fold measured
    slower); ``folded`` needs 2N % 4 == 0."""
    if method == "folded":
        if two_n % 4 != 0:
            raise InvalidInputError(f"folded MDCT requires window_size % 4 == 0, got {two_n}")
        return True
    if method == "matmul":
        return False
    if method != "auto":
        raise InvalidInputError(f"unknown mdct method {method!r}")
    return False


def mdct(samples, params: MdctParams, dtype=None, precision=None, method: str = "auto",
         device=None) -> torch.Tensor:
    """MDCT coefficients, shape (N, n_frames). Computes on CUDA unless
    ``device="cpu"``.

    >>> import numpy as np
    >>> from spectrograms_tpu_torch import MdctParams, imdct, mdct
    >>> p = MdctParams.sine_window(64)
    >>> x = np.cos(np.arange(512) / 7.0)
    >>> c = mdct(x, p, device="cpu")
    >>> tuple(c.shape)
    (32, 15)
    >>> y = imdct(c, p, original_length=512, device="cpu").numpy()
    >>> bool(np.allclose(y[32:-32], x[32:-32], atol=1e-10))
    True
    """
    dt = parse_dtype(dtype if dtype is not None else getattr(samples, "dtype", None))
    dev = resolve_device(device)
    check_precision(precision)
    x = torch.as_tensor(samples).to(device=dev, dtype=dt)
    if x.ndim != 1 or x.shape[0] == 0:
        raise InvalidInputError("expected a non-empty 1-D signal")
    two_n = params.window_size
    if x.shape[0] < two_n:
        raise InvalidInputError(f"samples length ({x.shape[0]}) must be >= window_size ({two_n})")
    if x.is_cuda and dt == torch.float32:
        check_true_f32()
    if _use_folded(two_n, method):
        d4, wa, wb_r, wc_r, wd, _ = _consts_for(params, True, dt, dev)
        return _mdct_folded_impl(x, d4, wa, wb_r, wc_r, wd, two_n, params.hop_size)
    fwd, _ = _consts_for(params, False, dt, dev)
    return _mdct_impl(x, fwd, two_n, params.hop_size)


def imdct(coefficients, params: MdctParams, original_length=None, dtype=None, precision=None,
          method: str = "auto", device=None) -> torch.Tensor:
    """Inverse MDCT by synthesis-windowed overlap-add. Computes on CUDA
    unless ``device="cpu"``."""
    dev = resolve_device(device)
    check_precision(precision)
    c = torch.as_tensor(coefficients).to(dev)
    if dtype is not None:
        c = c.to(parse_dtype(dtype))
    if c.ndim != 2:
        raise InvalidInputError(f"coefficients must be 2-D, got {tuple(c.shape)}")
    n = params.n_coefficients
    if c.shape[0] != n:
        raise InvalidInputError(
            f"coefficients has {c.shape[0]} rows but params.n_coefficients = {n}"
        )
    if c.shape[1] == 0:
        return torch.zeros(0, dtype=c.dtype, device=dev)
    if c.is_cuda and c.dtype == torch.float32:
        check_true_f32()
    if _use_folded(params.window_size, method):
        d4, *_, w = _consts_for(params, True, c.dtype, dev)
        out = _imdct_folded_impl(c.T, d4, w, params.window_size, params.hop_size)
    else:
        _, inv = _consts_for(params, False, c.dtype, dev)
        out = _imdct_impl(c.T, inv, params.window_size, params.hop_size)
    if original_length is not None:
        out = out[: int(original_length)]
    return out


# The reference's Python names (python/mdct.rs:130,178)
compute_mdct = mdct
compute_imdct = imdct
