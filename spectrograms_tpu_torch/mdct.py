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

On a float32 CUDA tensor at hop = N, with N/2 a power of two from 4 to 2048
and a dense basis that ``_device_consts`` built (known by identity),
``_mdct_impl`` and ``_imdct_impl`` launch ``csrc/mdct.cu`` once each: the
TDAC fold and a DCT-IV by an N/2-point FFT, bound by bytes, in place of the
dense products. ``mdct_kernel_twin`` and ``imdct_kernel_twin`` compute that
factorization in torch ops. Every other call (CPU tensors, float64, other
hops, any other matrix) takes the dense chain. When the input requires
grad, the kernel's result carries the dense chain's gradient
(``ops.gradients.kernel_forward_twin_grad``). ``launches`` counts the
kernel's launches (``ops/_build.py::Source.launch`` adds to it),
``chain_calls`` the CUDA calls that took the chain.
"""

from __future__ import annotations

import math
import sys
import weakref
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .dtypes import check_precision, check_true_f32, parse_dtype, resolve_device
from .errors import InvalidInputError
from .ops._build import SOURCES
from .ops.framing import frame_count, frame_signal, framed_matmul
from .ops.gradients import kernel_forward_twin_grad
from .ops.ola import ola_matmul, overlap_add
from .windows import WindowType, make_window, parse_window
from .spans import span

__all__ = ["MdctParams", "mdct", "imdct", "compute_mdct", "compute_imdct"]

launches = 0        # csrc/mdct.cu launches, counted as each returns
chain_calls = 0     # CUDA calls of _mdct_impl/_imdct_impl that took the dense chain
SOURCES["mdct"].counter = sys.modules[__name__]

KERNEL_N = (8, 4096)    # the kernel's N = window_size/2: N/2 a power of two in this range


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
def _kernel_tables(two_n: int, window_key) -> np.ndarray:
    """``csrc/mdct.cu``'s constants in float64, 6N values (M = N/2): the
    window (2N), then M complex values (re, im) each of ``pre[m] =
    exp(−iπm/N)``, ``post[k] = exp(−iπ(k+¼)/N)``, ``(2/N)·post`` (the
    inverse's) and the FFT's ``W[t] = exp(−2πit/M)``."""
    n = two_n // 2
    i = np.arange(n // 2, dtype=np.float64)
    post = np.exp(-1j * np.pi * (i + 0.25) / n)
    parts = [np.exp(-1j * np.pi * i / n), post, (2.0 / n) * post,
             np.exp(-2j * np.pi * i / (n // 2))]
    out = np.concatenate([np.asarray(window_key, dtype=np.float64)]
                         + [np.stack([z.real, z.imag], axis=-1).ravel() for z in parts])
    out.setflags(write=False)
    return out


# id(dense basis) -> (a weak reference to it, its window_size, whether it is the
# inverse's, the kernel's float32 tables on its device), filled by
# _device_consts: the kernel computes only with the bases it built.
_kernel_bases: dict = {}


def _register(basis: torch.Tensor, two_n: int, inverse: bool, tables: torch.Tensor) -> None:
    key = id(basis)

    def forget(ref, key=key):
        if _kernel_bases.get(key, (None,))[0] is ref:
            del _kernel_bases[key]

    _kernel_bases[key] = (weakref.ref(basis, forget), two_n, inverse, tables)


@lru_cache(maxsize=32)
def _device_consts(two_n: int, window_key, folded: bool, dtype: torch.dtype,
                   device: torch.device):
    """The dense bases or the folded constants as tensors on ``device``; a
    float32 pair of dense bases is registered with the kernel's tables."""
    arrays = (_folded_consts if folded else _mdct_basis)(two_n, window_key)
    out = tuple(torch.tensor(a, dtype=dtype, device=device) for a in arrays)
    if not folded and dtype == torch.float32:
        tables = torch.tensor(_kernel_tables(two_n, window_key), dtype=dtype, device=device)
        for basis, inverse in zip(out, (False, True)):
            _register(basis, two_n, inverse, tables)
    return out


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


def _kernel_tables_for(t: torch.Tensor, basis, two_n: int, hop: int, inverse: bool):
    """The kernel's tables when ``csrc/mdct.cu`` computes this call, else
    None: ``t`` float32 at hop = N in the kernel's N, and ``basis`` the
    forward's (``inverse`` False) or the inverse's dense basis of this
    window_size that ``_device_consts`` built, on ``t``'s device."""
    n = two_n // 2
    if t.dtype != torch.float32 or hop != n or not KERNEL_N[0] <= n <= KERNEL_N[1] or n & (n - 1):
        return None
    entry = _kernel_bases.get(id(basis))
    if entry is None or entry[0]() is not basis or entry[1:3] != (two_n, inverse):
        return None
    return entry[3] if entry[3].device == t.device else None


def _launch(t: torch.Tensor, tables: torch.Tensor, two_n: int, inverse: bool) -> torch.Tensor:
    """One launch of ``csrc/mdct.cu`` on a float32 CUDA tensor: the forward
    (..., L) → (..., n_frames, N), or the inverse (..., n_frames, N) →
    (..., N·(n_frames + 1)). The kernel derives its block, shared memory
    and grid from N, the rows and the frames."""
    n = two_n // 2
    if inverse and (t.ndim < 2 or t.shape[-1] != n):
        raise InvalidInputError(f"the inverse takes (..., n_frames, {n}) coefficients, got "
                                f"{tuple(t.shape)}")
    t = t.contiguous()
    if inverse:
        if t.data_ptr() % 16:   # the kernel reads each frame as 16-byte vectors
            t = t.clone()
        lead, nf, length = t.shape[:-2], t.shape[-2], 0
        out = torch.empty((*lead, n * (nf + 1)), dtype=t.dtype, device=t.device)
    else:
        lead, length = t.shape[:-1], t.shape[-1]
        nf = frame_count(length, two_n, n, centre=False)
        out = torch.empty((*lead, nf, n), dtype=t.dtype, device=t.device)
    rows = math.prod(lead)
    if rows == 0:
        return out
    if max(length, nf + 1) >= 2**31:
        raise InvalidInputError("mdct's kernel takes rows of fewer than 2**31 samples or frames")
    SOURCES["mdct"].launch(t.device, t.data_ptr(), out.data_ptr(), tables.data_ptr(), rows,
                           length, nf, n, int(inverse))
    return out


def _kernel_call(kernel, chain, t: torch.Tensor) -> torch.Tensor:
    """``kernel(t)``; when ``t`` requires grad, through
    ``kernel_forward_twin_grad``, so the gradient is the dense ``chain``'s."""
    if t.requires_grad and torch.is_grad_enabled():
        return kernel_forward_twin_grad(kernel, chain)(t)
    return kernel(t)


def _mdct_impl(x, fwd_basis, two_n: int, hop: int):
    """(..., n) → (..., N, n_frames): one framed matmul against the windowed
    basis (``frame_count(centre=False)`` is the MDCT framing exactly), or on
    CUDA one launch of ``csrc/mdct.cu`` (see the module's docstring)."""
    global chain_calls
    with span("tg.op.mdct._mdct_impl"):
        if x.is_cuda:
            tables = _kernel_tables_for(x, fwd_basis, two_n, hop, False)
            if tables is not None:
                return _kernel_call(
                    lambda t: _launch(t, tables, two_n, inverse=False),
                    lambda t: framed_matmul(t, fwd_basis, two_n, hop, centre=False),
                    x).transpose(-1, -2)
            chain_calls += 1
        return framed_matmul(x, fwd_basis, two_n, hop, centre=False).transpose(-1, -2)


def _imdct_impl(coeffs_t, inv_basis, two_n: int, hop: int):
    """(..., n_frames, N) → (..., hop·(n_frames−1) + 2N): the inverse basis
    with overlap-add fused into the matmul when ``hop | 2N``, or on CUDA one
    launch of ``csrc/mdct.cu`` (see the module's docstring)."""
    global chain_calls
    with span("tg.op.mdct._imdct_impl"):
        if coeffs_t.is_cuda:
            tables = _kernel_tables_for(coeffs_t, inv_basis, two_n, hop, True)
            if tables is not None:
                return _kernel_call(lambda t: _launch(t, tables, two_n, inverse=True),
                                    lambda t: ola_matmul(t, inv_basis, hop), coeffs_t)
            chain_calls += 1
        if two_n % hop == 0 and two_n > hop:
            return ola_matmul(coeffs_t, inv_basis, hop)
        return overlap_add(coeffs_t @ inv_basis, hop)


def _twin_parts(tables: torch.Tensor, n: int) -> tuple:
    """(window, pre, post, (2/N)·post) of the kernel's tables, complex in
    the tables' precision."""
    z = tables[2 * n:].reshape(4, n // 2, 2)
    z = torch.complex(z[..., 0], z[..., 1])
    return tables[: 2 * n], z[0], z[1], z[2]


def _dct4_twin(u: torch.Tensor, pre: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """The kernel's DCT-IV of the last axis: ``z[m] = (u[2m] + i·u[N−1−2m])·
    pre[m]``, an N/2-point FFT, ``Y = post·Z``, ``C[2k] = Re Y[k]``,
    ``C[N−1−2k] = −Im Y[k]``."""
    y = torch.fft.fft(torch.complex(u[..., 0::2], u.flip(-1)[..., 0::2]) * pre) * post
    return torch.stack([y.real, (-y.imag).flip(-1)], dim=-1).reshape(u.shape)


def mdct_kernel_twin(x: torch.Tensor, tables: torch.Tensor, two_n: int) -> torch.Tensor:
    """What ``csrc/mdct.cu``'s forward computes, in torch ops and in the
    tables' precision: (..., L) → (..., n_frames, N) at hop N; the TDAC fold
    of each frame (a signal shorter than a frame zero-padded to it), then
    ``_dct4_twin``."""
    n, h = two_n // 2, two_n // 4
    w, pre, post, _ = _twin_parts(tables, n)
    nf = frame_count(x.shape[-1], two_n, n, centre=False)
    need = (nf + 1) * n
    xp = torch.nn.functional.pad(x, (0, max(0, need - x.shape[-1])))[..., :need]
    s = xp.unfold(-1, two_n, n) * w
    u = torch.cat([-s[..., n:n + h].flip(-1) - s[..., n + h:],
                   s[..., :h] - s[..., h:n].flip(-1)], dim=-1)
    return _dct4_twin(u, pre, post)


def imdct_kernel_twin(coeffs_t: torch.Tensor, tables: torch.Tensor, two_n: int) -> torch.Tensor:
    """What ``csrc/mdct.cu``'s inverse computes, in torch ops and in the
    tables' precision: (..., n_frames, N) → (..., N·(n_frames + 1)). The
    frames −1 .. n_frames (the two outside the signal zeros) through the
    DCT-IV with ``(2/N)·post``, unfolded as ``[v₂, −rev(v₂), −rev(v₁),
    −v₁]·w``; hop-block b is the second half of frame b−1 plus the first
    half of frame b. The kernel's teams recompute a run's halo frame b0−1,
    which gives the same values as the frame computed once here."""
    n, h = two_n // 2, two_n // 4
    w, pre, _, post_inv = _twin_parts(tables, n)
    frames = torch.nn.functional.pad(coeffs_t, (0, 0, 1, 1))
    v = _dct4_twin(frames, pre, post_inv)
    v1, v2 = v[..., :h], v[..., h:]
    first = torch.cat([v2, -v2.flip(-1)], dim=-1) * w[:n]
    second = torch.cat([-v1.flip(-1), -v1], dim=-1) * w[n:]
    return (second[..., :-1, :] + first[..., 1:, :]).flatten(-2)


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
