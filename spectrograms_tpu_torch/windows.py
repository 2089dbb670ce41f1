"""Window functions.

Behavioral parity with the reference's window layer
(``src/window.rs:19-338`` and ``make_window`` at
``src/spectrogram.rs:2159-2259``): six analytic window types
plus custom coefficients, all generated in float64 and cast to the compute
dtype at the edge. Windows are *periodic-symmetric with (N-1) denominators*
(matching the reference, not scipy's ``sym=False``).

A copy of ``spectrograms_tpu.windows``: the port imports nothing of the JAX
package. The window is folded into the DFT matrices of the plain path (see
``spectrograms_tpu_torch.ops.dft``) and multiplied in on load by the fused
kernel; the coefficients here are the single source of truth.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from .errors import InvalidInputError

__all__ = [
    "WindowType",
    "make_window",
    "parse_window",
    "hanning_window",
    "hamming_window",
    "blackman_window",
    "rectangular_window",
    "kaiser_window",
    "gaussian_window",
]


@dataclass(frozen=True)
class WindowType:
    """A window specification.

    Mirrors the reference's ``WindowType`` enum
    (``src/window.rs:19-50``): Rectangular / Hanning /
    Hamming / Blackman / Kaiser{beta} / Gaussian{std} / Custom{coefficients}.

    Instances are immutable and hashable (hashable specs let plans key their
    jit caches on the window). Use the classmethod constructors or the module
    constants ``WindowType.RECTANGULAR`` … for the non-parameterized kinds.
    """

    kind: str
    param: Optional[float] = None
    coefficients: Optional[Tuple[float, ...]] = field(default=None, repr=False)

    _KINDS = ("rectangular", "hanning", "hamming", "blackman", "kaiser", "gaussian", "custom")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise InvalidInputError(
                f"unknown window kind {self.kind!r}; expected one of {self._KINDS}"
            )
        if self.kind in ("kaiser", "gaussian") and self.param is None:
            raise InvalidInputError(f"{self.kind} window requires a parameter")
        if self.kind == "custom" and not self.coefficients:
            raise InvalidInputError("Custom window coefficients cannot be empty")

    # ---- constructors -------------------------------------------------
    # The four parameterless kinds are CLASS ATTRIBUTES holding instances
    # (assigned below) — the reference exposes them as PyO3 classattrs
    # (params.rs:43-78), so `window=WindowType.hanning` (no call) must work.
    # __call__ returns self so the callable spelling keeps working too.
    def __call__(self) -> "WindowType":
        return self

    @classmethod
    def kaiser(cls, beta: float) -> "WindowType":
        return cls("kaiser", param=float(beta))

    @classmethod
    def gaussian(cls, std: float) -> "WindowType":
        return cls("gaussian", param=float(std))

    @classmethod
    def custom(cls, coefficients, normalize: Optional[str] = None) -> "WindowType":
        """Custom pre-computed window, optionally normalized.

        ``normalize`` ∈ {None, "sum", "peak"/"max", "energy"/"rms"} — parity
        with ``custom_with_normalization``
        (``src/window.rs:134-203``).
        """
        coeffs = np.asarray(coefficients, dtype=np.float64).ravel()
        if coeffs.size == 0:
            raise InvalidInputError("Custom window coefficients cannot be empty")
        if not np.all(np.isfinite(coeffs)):
            bad = int(np.flatnonzero(~np.isfinite(coeffs))[0])
            raise InvalidInputError(
                f"Window coefficient at index {bad} is not finite: {coeffs[bad]}"
            )
        if normalize is not None:
            if normalize == "sum":
                s = coeffs.sum()
                if s == 0.0:
                    raise InvalidInputError("Cannot normalize window by sum: sum is zero")
                coeffs = coeffs / s
            elif normalize in ("peak", "max"):
                m = coeffs.max()
                if m == 0.0:
                    raise InvalidInputError("Cannot normalize window by peak: maximum is zero")
                coeffs = coeffs / m
            elif normalize in ("energy", "rms"):
                e = float(np.square(coeffs).sum())
                if e == 0.0:
                    raise InvalidInputError("Cannot normalize window by energy: energy is zero")
                coeffs = coeffs / np.sqrt(e)
            else:
                raise InvalidInputError(
                    f"Unknown normalization mode '{normalize}'. "
                    "Valid modes: 'sum', 'peak', 'energy'"
                )
        return cls("custom", coefficients=tuple(float(c) for c in coeffs))

    # ---- introspection -------------------------------------------------
    @property
    def size(self) -> Optional[int]:
        """Size of a custom window, else None."""
        return len(self.coefficients) if self.coefficients is not None else None

    def is_parameterized(self) -> bool:
        return self.kind in ("kaiser", "gaussian")

    def parameter_value(self) -> Optional[float]:
        return self.param if self.is_parameterized() else None

    def __str__(self) -> str:
        if self.kind == "kaiser":
            return f"Kaiser(beta={self.param})"
        if self.kind == "gaussian":
            return f"Gaussian(std={self.param})"
        if self.kind == "custom":
            return f"Custom(n={self.size})"
        return self.kind.capitalize()

    @classmethod
    def from_str(cls, s: str) -> "WindowType":
        return parse_window(s)

    # ---- coefficient generators (reference staticmethods, params.rs:190-320)
    @staticmethod
    def make_rectangular(n: int, dtype=None) -> np.ndarray:
        """Rectangular window coefficients of length n."""
        return make_window(WindowType("rectangular"), n, _gen_dtype(dtype))

    @staticmethod
    def make_hanning(n: int, dtype=None) -> np.ndarray:
        """Hanning window coefficients of length n."""
        return make_window(WindowType("hanning"), n, _gen_dtype(dtype))

    @staticmethod
    def make_hamming(n: int, dtype=None) -> np.ndarray:
        """Hamming window coefficients of length n."""
        return make_window(WindowType("hamming"), n, _gen_dtype(dtype))

    @staticmethod
    def make_blackman(n: int, dtype=None) -> np.ndarray:
        """Blackman window coefficients of length n."""
        return make_window(WindowType("blackman"), n, _gen_dtype(dtype))

    @staticmethod
    def make_kaiser(n: int, beta: float, dtype=None) -> np.ndarray:
        """Kaiser window coefficients of length n with shape beta."""
        return make_window(WindowType("kaiser", param=float(beta)), n, _gen_dtype(dtype))

    @staticmethod
    def make_gaussian(n: int, std: float, dtype=None) -> np.ndarray:
        """Gaussian window coefficients of length n with width std."""
        return make_window(WindowType("gaussian", param=float(std)), n, _gen_dtype(dtype))


# Classattr instances (parity with the reference pyclass classattrs,
# src/python/params.rs:43-78): both `WindowType.hanning` and
# `WindowType.hanning()` yield the hanning spec. Uppercase aliases kept.
WindowType.rectangular = WindowType("rectangular")
WindowType.hanning = WindowType("hanning")
WindowType.hamming = WindowType("hamming")
WindowType.blackman = WindowType("blackman")
WindowType.RECTANGULAR = WindowType("rectangular")
WindowType.HANNING = WindowType("hanning")
WindowType.HAMMING = WindowType("hamming")
WindowType.BLACKMAN = WindowType("blackman")


def _gen_dtype(dtype):
    """Reference generator dtype semantics: default float64, strings parsed."""
    if dtype is None:
        return np.float64
    from .dtypes import numpy_dtype, parse_dtype

    return numpy_dtype(parse_dtype(dtype))


_WINDOW_RE = re.compile(
    r"^(?:(?P<name>rect|rectangle|hann|hanning|hamm|hamming|blackman)"
    r"|(?P<param_name>kaiser|gaussian)=(?P<param>\d+(\.\d+)?))$",
    re.IGNORECASE,
)

_NAME_MAP = {
    "rect": "rectangular",
    "rectangle": "rectangular",
    "hann": "hanning",
    "hanning": "hanning",
    "hamm": "hamming",
    "hamming": "hamming",
    "blackman": "blackman",
}


def parse_window(s: str) -> WindowType:
    """Parse a window spec string ("hann", "kaiser=8.0", …).

    Grammar parity with the reference's ``FromStr``
    (``src/window.rs:274-338``).

    Examples
    --------
    >>> from spectrograms_tpu_torch import parse_window
    >>> parse_window("hann").kind
    'hanning'
    >>> parse_window("kaiser=8.0").param
    8.0
    """
    if not isinstance(s, str) or not s:
        raise InvalidInputError(
            "Input must not be empty. Must be one of ['rectangular', 'hanning', "
            "'hamming', 'blackman', 'gaussian', 'kaiser']"
        )
    m = _WINDOW_RE.match(s.strip())
    if m is None:
        raise InvalidInputError(f"Invalid window specification '{s}'")
    if m.group("name"):
        return WindowType(_NAME_MAP[m.group("name").lower()])
    value = float(m.group("param"))
    pname = m.group("param_name").lower()
    if pname == "kaiser":
        return WindowType.kaiser(value)
    return WindowType.gaussian(value)


def make_window(window: WindowType, n_fft: int, dtype=np.float64) -> np.ndarray:
    """Generate window coefficients of length ``n_fft``.

    Formulas match ``make_window`` in the reference
    (``src/spectrogram.rs:2159-2259``): cosine windows use
    (N-1) denominators; Kaiser centers at (N-1)/2 with I0 Bessel; Gaussian is
    exp(-((n-c)/std)^2 / 2). Computed in float64, cast to ``dtype``.

    Examples
    --------
    >>> from spectrograms_tpu_torch import WindowType, make_window
    >>> w = make_window(WindowType.hanning, 8)
    >>> w.shape, float(w[0]), round(float(w.max()), 6)
    ((8,), 0.0, 0.950484)
    >>> make_window("rect", 4).tolist()
    [1.0, 1.0, 1.0, 1.0]
    """
    if isinstance(window, str):
        window = parse_window(window)
    n = int(n_fft)
    if n <= 0:
        raise InvalidInputError("n_fft must be > 0")

    kind = window.kind
    if kind == "rectangular":
        w = np.ones(n, dtype=np.float64)
    elif kind in ("hanning", "hamming", "blackman"):
        if n == 1:
            # (N-1)=0: the reference divides by zero giving cos(nan)? No — for
            # n_fft=1 the loop runs once with n=0 so the numerator is 0; treat
            # the limit as the peak value.
            w = np.ones(1, dtype=np.float64)
        else:
            t = 2.0 * np.pi * np.arange(n, dtype=np.float64) / (n - 1)
            if kind == "hanning":
                w = 0.5 - 0.5 * np.cos(t)
            elif kind == "hamming":
                w = 0.54 - 0.46 * np.cos(t)
            else:
                w = 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2.0 * t)
    elif kind == "kaiser":
        beta = float(window.param)
        if n == 1:
            w = np.ones(1, dtype=np.float64)
        else:
            denom = float(np.i0(beta))
            n_max = (n - 1) / 2.0
            x = np.arange(n, dtype=np.float64) - n_max
            if n_max == 0.0:
                ratio = np.zeros_like(x)
            else:
                normalized = x / n_max
                ratio = np.maximum(1.0 - normalized * normalized, 0.0)
            w = np.i0(beta * np.sqrt(ratio)) / denom if denom != 0.0 else np.zeros(n)
    elif kind == "gaussian":
        std = float(window.param)
        center = (n - 1) / 2.0
        x = np.arange(n, dtype=np.float64) - center
        w = np.exp(-0.5 * np.square(x / std))
    elif kind == "custom":
        if window.size != n:
            raise InvalidInputError(
                f"Custom window size mismatch: expected {n}, got {window.size}. "
                "Custom windows must be pre-computed with the exact FFT size."
            )
        w = np.asarray(window.coefficients, dtype=np.float64)
    else:  # pragma: no cover
        raise InvalidInputError(f"unknown window kind {kind!r}")

    return w.astype(dtype, copy=False)


# ---- convenience generators (parity with src/window.rs:225-263)
def hanning_window(n: int, dtype=np.float64) -> np.ndarray:
    return make_window(WindowType.HANNING, n, dtype)


def hamming_window(n: int, dtype=np.float64) -> np.ndarray:
    return make_window(WindowType.HAMMING, n, dtype)


def blackman_window(n: int, dtype=np.float64) -> np.ndarray:
    return make_window(WindowType.BLACKMAN, n, dtype)


def rectangular_window(n: int, dtype=np.float64) -> np.ndarray:
    return make_window(WindowType.RECTANGULAR, n, dtype)


def kaiser_window(n: int, beta: float, dtype=np.float64) -> np.ndarray:
    return make_window(WindowType.kaiser(beta), n, dtype)


def gaussian_window(n: int, std: float, dtype=np.float64) -> np.ndarray:
    return make_window(WindowType.gaussian(std), n, dtype)
