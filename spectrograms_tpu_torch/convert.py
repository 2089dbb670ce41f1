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

A CQT plan's constants are its kernels: the fused ``[re | −im]`` matrix
(``_cqt_ri``), its bands (``_cqt_bands``) when banding is on, and its
multirate groups (``_cqt_multirate``, ``(d, k_ri, e0, flen, jp)``) when the
plan runs the octave stack; a CQT plan takes no window or mapping.

Two objects outside the plans carry state of their own: a
``FactoredRfft``'s constants (the 128-point DFT matrices ``_c``/``_s``, the
twiddles ``_tw_re``/``_tw_im``, the radix-2 butterflies ``_bfs`` and the
window) and an ``OverlapSaveConvolver``'s impulse-response spectrum
``_h_spec`` and carried history ``_history``; ``factored_constants_from_numpy``
and ``convolver_state_from_numpy`` install a JAX object's arrays into the
port's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .cache import constants_changed
from .chroma import ChromaPlan
from .convolution import OverlapSaveConvolver
from .errors import DimensionMismatchError, InvalidInputError
from .mfcc import MfccPlan
from .ops.fft_factored import FactoredRfft
from .pipeline import FreqScale, SpectrogramPlan

__all__ = [
    "plan_constants_from_numpy",
    "factored_constants_from_numpy",
    "convolver_state_from_numpy",
]


def _f64(name, array, shape):
    a = np.asarray(array, dtype=np.float64)
    if a.shape != shape:
        raise DimensionMismatchError(shape, a.shape, f"{name}: expected {shape}, got {a.shape}")
    return a


def plan_constants_from_numpy(plan, window=None, mapping=None,
                              dct_basis: Optional[np.ndarray] = None, cqt_ri=None, cqt_bands=None,
                              cqt_groups=None):
    """Install ``window`` (n_fft,), ``mapping`` (n_out, n_bins) and, for an
    :class:`MfccPlan`, ``dct_basis`` (n_mels, n_mfcc) into ``plan``.

    Every derived constant (DFT matrices, the kernel's constants at the
    plan's tier) is rebuilt from them. ``mapping`` is None for a linear
    plan, and the (12, n_bins) chroma filterbank for a :class:`ChromaPlan`.
    A multirate plan takes them at its inner geometry (n_fft/2^d).

    A CQT plan takes ``cqt_ri`` (n_fft, 2·n_out) instead, and ``cqt_bands``
    (``(start, stop, s, k_ri)`` each) and ``cqt_groups`` (``(d, k_ri, e0,
    flen, jp)`` each) exactly when the plan has them. Returns ``plan``.
    """
    constants_changed()  # a CUDA graph captured before reads the old constants
    cqt_args = (cqt_ri, cqt_bands, cqt_groups)
    if isinstance(plan, SpectrogramPlan) and plan.freq_scale == FreqScale.CQT:
        return _install_cqt(plan, window, mapping, dct_basis, *cqt_args)
    if any(a is not None for a in cqt_args):
        raise InvalidInputError("only a CQT plan takes cqt_ri, cqt_bands or cqt_groups")
    if window is None:
        raise InvalidInputError("a plan other than CQT needs its window")
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


def _install_cqt(plan, window, mapping, dct_basis, cqt_ri, cqt_bands, cqt_groups):
    if window is not None or mapping is not None or dct_basis is not None:
        raise InvalidInputError("a CQT plan takes only cqt_ri, cqt_bands and cqt_groups")
    if cqt_ri is None:
        raise InvalidInputError("a CQT plan needs cqt_ri")
    ri64 = _f64("cqt_ri", cqt_ri, tuple(plan._cqt_ri.shape))
    if (cqt_bands is None) != (plan._cqt_bands is None):
        raise InvalidInputError("cqt_bands must be given exactly when the plan is banded")
    if (cqt_groups is None) != (plan._cqt_multirate is None):
        raise InvalidInputError("cqt_groups must be given exactly when the plan is multirate")
    bands64 = None
    if cqt_bands is not None:
        if len(cqt_bands) != len(plan._cqt_bands):
            raise DimensionMismatchError(len(plan._cqt_bands), len(cqt_bands))
        bands64 = [(int(start), int(stop), int(s), _f64("cqt_bands", k, tuple(mine[3].shape)))
                   for (start, stop, s, k), mine in zip(cqt_bands, plan._cqt_bands)]
    groups64 = None
    if cqt_groups is not None:
        if len(cqt_groups) != len(plan._cqt_multirate):
            raise DimensionMismatchError(len(plan._cqt_multirate), len(cqt_groups))
        groups64 = [(int(d), _f64("cqt_groups", k, tuple(mine[1].shape)), int(e0), int(flen),
                     int(jp))
                    for (d, k, e0, flen, jp), mine in zip(cqt_groups, plan._cqt_multirate)]
    plan._install_cqt_constants(ri64, bands64, groups64)
    return plan


def factored_constants_from_numpy(fk, c, s, tw_re, tw_im, butterflies, window=None):
    """Install a factored rFFT's constants into ``fk`` (a port
    ``FactoredRfft``): ``c``/``s`` (128, 128), ``tw_re``/``tw_im`` (r, 128),
    ``butterflies`` a sequence of (re, im) (L/2, 1) pairs, one per radix-2
    level, and the (n_fft,) window or None. Returns ``fk``."""
    if not isinstance(fk, FactoredRfft):
        raise InvalidInputError(f"not a port FactoredRfft: {type(fk).__name__}")
    dt, dev = fk._c.dtype, fk._c.device
    arrays = [_f64("c", c, (128, 128)), _f64("s", s, (128, 128)),
              _f64("tw_re", tw_re, (fk.r, 128)), _f64("tw_im", tw_im, (fk.r, 128))]
    if len(butterflies) != len(fk._bfs):
        raise DimensionMismatchError(len(fk._bfs), len(butterflies))
    bfs = [(_f64("butterflies", re, tuple(mine[0].shape)),
            _f64("butterflies", im, tuple(mine[1].shape)))
           for (re, im), mine in zip(butterflies, fk._bfs)]
    w = None if window is None else _f64("window", window, (fk.n_fft,))
    constants_changed()  # a CUDA graph captured before reads the old constants
    fk._install(*arrays, bfs, w, dt, dev)
    return fk


def convolver_state_from_numpy(conv, h_spec, history):
    """Install an overlap-save convolver's impulse-response spectrum
    (fft_size//2+1,) complex and its carried history (fft_size −
    block_size,) into ``conv`` (a port ``OverlapSaveConvolver``). Returns
    ``conv``."""
    if not isinstance(conv, OverlapSaveConvolver):
        raise InvalidInputError(f"not a port OverlapSaveConvolver: {type(conv).__name__}")
    spec = np.asarray(h_spec, dtype=np.complex128)
    if spec.shape != (conv.fft_size // 2 + 1,):
        raise DimensionMismatchError((conv.fft_size // 2 + 1,), spec.shape)
    hist = _f64("history", history, (conv.fft_size - conv.block_size,))
    conv._install(spec, hist)
    return conv
