"""Carry a JAX plan's constants into a port plan.

A plan's constants play the part that weights play in a model: the window,
the filterbank (for chroma, the chroma filterbank) and, for MFCC, the
DCT-lifter basis. Taking them from a ``spectrograms_tpu`` plan as numpy
arrays (``plan._window``, ``plan._mapping_t.T``, ``ChromaPlan._fb_t.T``,
``MfccPlan._basis``) and installing them here shows
that both packages compute the same function from the same constants,
independently of whether the port's own builders produce the same arrays.

A multirate plan computes at its inner (decimated) geometry, so it takes
the inner plan's constants: a JAX plan's ``_multirate_inner[1]._window`` and
``._mapping_t.T`` (an ``MfccPlan``'s through its ``_mel_plan``, a
``ChromaPlan``'s ``_mag_plan._window`` and ``_fb_t.T``, already decimated).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .chroma import ChromaPlan
from .errors import DimensionMismatchError, InvalidInputError
from .mfcc import MfccPlan
from .pipeline import SpectrogramPlan

__all__ = ["plan_constants_from_numpy"]


def _f64(name, array, shape):
    a = np.asarray(array, dtype=np.float64)
    if a.shape != shape:
        raise DimensionMismatchError(shape, a.shape, f"{name}: expected {shape}, got {a.shape}")
    return a


def plan_constants_from_numpy(plan, window, mapping=None, dct_basis: Optional[np.ndarray] = None):
    """Install ``window`` (n_fft,), ``mapping`` (n_out, n_bins) and, for an
    :class:`MfccPlan`, ``dct_basis`` (n_mels, n_mfcc) into ``plan``.

    Every derived constant (DFT matrices, the kernel's constants at the
    plan's tier) is rebuilt from them. ``mapping`` is None for a linear
    plan, and the (12, n_bins) chroma filterbank for a :class:`ChromaPlan`.
    A multirate plan takes them at its inner geometry (n_fft/2^d).
    Returns ``plan``.
    """
    if isinstance(plan, ChromaPlan):
        if dct_basis is not None:
            raise InvalidInputError("only an MfccPlan takes dct_basis")
        n_fft = plan._stft_eff.n_fft
        fb = _f64("mapping", mapping, (plan._fb_t.shape[1], n_fft // 2 + 1))
        plan._install_constants(_f64("window", window, (n_fft,)), fb)
        return plan
    if isinstance(plan, MfccPlan):
        spec_plan = plan._kernel_plan
    elif isinstance(plan, SpectrogramPlan):
        spec_plan = plan if plan._multirate_inner is None else plan._multirate_inner[1]
    else:
        raise InvalidInputError(f"not a port plan: {type(plan).__name__}")
    n_fft = spec_plan._n_fft
    window64 = _f64("window", window, (n_fft,))
    n_bins = n_fft // 2 + 1
    if spec_plan._mapping_t is None:
        if mapping is not None:
            raise InvalidInputError("a linear plan takes no mapping")
        mapping64 = None
    else:
        mapping64 = _f64("mapping", mapping, (spec_plan.n_output_bins, n_bins))
    if isinstance(plan, MfccPlan):
        if dct_basis is None:
            raise InvalidInputError("an MfccPlan needs dct_basis")
        p = plan.mfcc_params
        basis64 = _f64("dct_basis", dct_basis, (spec_plan.n_output_bins, p.n_mfcc))
        plan._install_constants(window64, mapping64, basis64)
    else:
        if dct_basis is not None:
            raise InvalidInputError("only an MfccPlan takes dct_basis")
        spec_plan._install_constants(window64, mapping64)
    return plan
