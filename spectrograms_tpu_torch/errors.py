"""Error taxonomy for spectrograms_tpu_torch (a copy of ``spectrograms_tpu.errors``).

Mirrors the error surface of the reference crate
(``src/error.rs:13-90`` and the Python exception hierarchy in
``src/python/error.rs``): a base :class:`SpectrogramError`
with four concrete kinds. Validation is eager and Python-side — the
analog of the reference's ``NonZeroUsize`` / non-empty-slice compile-time
guarantees.
"""

from __future__ import annotations

__all__ = [
    "SpectrogramError",
    "InvalidInputError",
    "DimensionMismatchError",
    "FftBackendError",
    "InternalError",
]


class SpectrogramError(Exception):
    """Base class for all spectrograms_tpu_torch errors."""


class InvalidInputError(SpectrogramError, ValueError):
    """Raised when user-supplied parameters or signals are invalid."""


class DimensionMismatchError(SpectrogramError, ValueError):
    """Raised when an array has the wrong shape for an operation.

    Mirrors ``SpectrogramError::DimensionMismatch { expected, got }``.
    """

    def __init__(self, expected, got, message: str | None = None):
        self.expected = expected
        self.got = got
        if message is None:
            message = f"dimension mismatch: expected {expected}, got {got}"
        super().__init__(message)


class FftBackendError(SpectrogramError, RuntimeError):
    """Raised when the FFT/XLA backend fails."""


class InternalError(SpectrogramError, RuntimeError):
    """Raised on internal invariant violations (bugs)."""


# The reference's Python package spells this name ``FFTBackendError``
# (``python/spectrograms/__init__.py:62``); keep both.
FFTBackendError = FftBackendError
__all__.append("FFTBackendError")


def invalid_input(msg: str) -> InvalidInputError:
    """Constructor helper mirroring ``SpectrogramError::invalid_input``."""
    return InvalidInputError(msg)


def dimension_mismatch(expected, got) -> DimensionMismatchError:
    """Constructor helper mirroring ``SpectrogramError::dimension_mismatch``."""
    return DimensionMismatchError(expected, got)
