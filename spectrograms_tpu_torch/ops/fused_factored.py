"""Fused feature kernel: signal → windowed real DFT → |·|² → filterbank
(→ dB → DCT) in one CUDA kernel.

Counterpart of ``spectrograms_tpu.ops.pallas_factored``, the JAX package's
one Pallas kernel (``_kernel``, built by ``fused_factored_features``). The
kernel is ``csrc/fused_features.cu``, hand-written for Hopper (sm_90a); its
source note gives its bound on the H100 and what the design does about it.
This module holds, under the JAX module's public names:

- ``fused_features_reference``: the plain PyTorch version of the same
  function (the CPU tests and the on-card comparison use it);
- ``fused_factored_features``: the factory that builds a plan's kernel
  constants once and returns the runner. The runner launches the kernel on a
  CUDA tensor (or raises) and runs the plain version on a CPU tensor, the only
  case in which it does. ``fused_factored_features.launches`` counts launches.

Modes covered: any hop ≤ n_fft (frames are read straight from the signal,
so the TPU kernel's halo and frames-input modes are one code path), mel /
log-Hz / ERB / identity mappings, power / magnitude / dB, ``pre_amp=
"magnitude"`` and the DCT tail. The arithmetic is f32 throughout, more
precise than the TPU tiers; the bf16 tiers and the ``pallas:<opt>`` variant
forms are not ported yet (``parse_pallas_method`` says so).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib

import numpy as np
import torch

from ..dtypes import parse_dtype, resolve_device
from ..errors import FftBackendError, InvalidInputError
from .framing import frame_count, frame_signal

__all__ = [
    "fused_factored_features",
    "fused_features_reference",
    "supports_factored_fusion",
    "parse_pallas_method",
    "KernelConst",
]

_AMPS = {"power": 0, "magnitude": 1, "decibels": 2}
_PRE_AMPS = {"none": 0, "magnitude": 1}
# The TPU kernel's method-string variants, not ported yet.
_METHOD_OPTIONS = ("dif", "stack", "gauss", "prune", "x2")
# Shared memory a block may use on sm_90 (227 KB).
_MAX_SMEM = 232448
_MAX_TILE_FRAMES = 16


class KernelConst:
    """Hashable ndarray wrapper for the ``fused_factored_features`` cache key.

    Keys the cache on a content digest; the f64 array rides along.
    """

    __slots__ = ("array", "_digest")

    def __init__(self, array):
        self.array = np.asarray(array, dtype=np.float64)
        self.array.setflags(write=False)
        self._digest = hashlib.sha1(
            self.array.tobytes() + str(self.array.shape).encode()
        ).digest()

    def __hash__(self):
        return hash(self._digest)

    def __eq__(self, other):
        return isinstance(other, KernelConst) and self._digest == other._digest


def supports_factored_fusion(n_fft: int, hop: int, dtype) -> bool:
    """f32, n_fft = 128·2^k in [256, 4096], any hop ≤ n_fft (the JAX predicate)."""
    try:
        if parse_dtype(dtype) != torch.float32:
            return False
    except InvalidInputError:
        return False
    if n_fft % 128 != 0 or not (256 <= n_fft <= 4096):
        return False
    r = n_fft // 128
    return (r & (r - 1)) == 0 and 0 < hop <= n_fft


def parse_pallas_method(method: str) -> dict:
    """``"pallas"`` → ``{}``; the ``pallas:<opt>`` variants raise.

    The JAX package's variant forms (``dif``/``stack``/``gauss``/``prune``
    and the ``x2`` tier) are not ported yet: a known option raises "not yet
    ported", an unknown one raises as in the JAX package.
    """
    if method == "pallas":
        return {}
    if not method.startswith("pallas:"):
        raise InvalidInputError(f"not a pallas method string: {method!r}")
    for opt in method[len("pallas:"):].split("+"):
        if opt not in _METHOD_OPTIONS:
            raise InvalidInputError(
                f"unknown pallas option {opt!r}; expected one of "
                f"{sorted(_METHOD_OPTIONS)} joined with '+'"
            )
    raise InvalidInputError(f"method {method!r} is not yet ported; use 'pallas'")


def fused_features_reference(x, window, mapping, amp, floor_db, pre_amp, dct,
                             centre, n_fft, hop):
    """Plain PyTorch version of the kernel: (..., n) → (..., n_out, n_frames).

    pad → frames → window → ``torch.fft.rfft`` → |X|² → (sqrt if
    ``pre_amp == "magnitude"``) → ``@ mapping.T`` → amp → (``@ dct``).
    ``mapping`` is (n_out, n_bins); ``dct`` is (n_out, n_coef) or None.
    """
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop, centre) * window, dim=-1)
    p = spec.real * spec.real + spec.imag * spec.imag
    if pre_amp == "magnitude":
        p = torch.sqrt(p)
    feat = p @ mapping.T
    if amp == "magnitude":
        feat = torch.sqrt(feat)
    elif amp == "decibels":
        feat = 10.0 * torch.log10(torch.clamp_min(feat, 10.0 ** (floor_db / 10.0)))
    if dct is not None:
        feat = feat @ dct
    return feat.transpose(-1, -2).contiguous()


def _smem_bytes(tile_f: int, n_fft: int, n_bins: int, n_out: int, with_dct: bool) -> int:
    feat = tile_f * (n_out + 1) * 4 if with_dct else 0
    return tile_f * n_fft * 8 + tile_f * n_bins * 4 + feat


def _tile_frames(n_fft: int, n_bins: int, n_out: int, with_dct: bool) -> int:
    """Frames per block: 64 KB of complex FFT space, less where n_out is large."""
    tile = max(1, min(_MAX_TILE_FRAMES, 65536 // (8 * n_fft)))
    while tile > 1 and _smem_bytes(tile, n_fft, n_bins, n_out, with_dct) > _MAX_SMEM:
        tile //= 2
    if _smem_bytes(tile, n_fft, n_bins, n_out, with_dct) > _MAX_SMEM:
        raise InvalidInputError(
            f"n_out={n_out} leaves no room in shared memory for the fused kernel"
        )
    return tile


def mapping_bands(fb: np.ndarray) -> np.ndarray:
    """(n_out, 2) int32 [first, last + 1) nonzero bin of each mapping row.

    The kernel sums only these bins; the rest of a row is exactly zero, so
    the sum equals the dense product for finite spectra. An all-zero row
    gets the empty band (0, 0).
    """
    nz = fb != 0.0
    any_nz = nz.any(axis=1)
    lo = np.where(any_nz, nz.argmax(axis=1), 0)
    hi = np.where(any_nz, fb.shape[1] - nz[:, ::-1].argmax(axis=1), 0)
    return np.stack([lo, hi], axis=1).astype(np.int32)


_SIGNATURES = {
    "fused_features_launch": (
        [ctypes.c_void_p] * 7
        + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "fused_features_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


@functools.lru_cache(maxsize=32)
def fused_factored_features(
    n_fft: int,
    hop: int,
    window_key,                # tuple(f64 window) or None
    mapping_key,               # KernelConst (n_out, n_bins) or "identity"
    amp: str = "power",
    floor_db: float = -80.0,
    centre: bool = True,
    dct_key=None,              # optional KernelConst (n_out, n_coef), after amp
    pre_amp: str = "none",     # "magnitude" applies sqrt BEFORE the filterbank
    device: str = "cuda",
):
    """Build the fused program: (n,) or (B, n) f32 signal → (B, n_out, n_frames).

    Constants are built once here, in f64 and cast to f32 on ``device``.
    The returned runner takes tensors on that device only.
    """
    if not supports_factored_fusion(n_fft, hop, torch.float32):
        raise InvalidInputError(
            f"the fused kernel requires n_fft = 128·2^k in 256..4096 and "
            f"hop <= n_fft; got n_fft={n_fft}, hop={hop}"
        )
    if mapping_key is None:
        raise InvalidInputError(
            "the fused kernel requires a mapping matrix; pass "
            "mapping_key='identity' for linear spectrograms"
        )
    if amp not in _AMPS:
        raise InvalidInputError(f"unknown amp {amp!r}")
    if pre_amp not in _PRE_AMPS:
        raise InvalidInputError(f"unknown pre_amp {pre_amp!r}")
    n_bins = n_fft // 2 + 1
    if isinstance(mapping_key, str):
        if mapping_key != "identity":
            raise InvalidInputError(f"unknown mapping_key {mapping_key!r}")
        fb = np.eye(n_bins, dtype=np.float64)
    else:
        fb = mapping_key.array                               # (n_out, n_bins)
    if fb.shape[1] != n_bins:
        raise InvalidInputError(f"mapping has {fb.shape[1]} bins, expected {n_bins}")
    n_out = fb.shape[0]
    dct = None if dct_key is None else dct_key.array        # (n_out, n_coef)
    if dct is not None and dct.shape[0] != n_out:
        raise InvalidInputError(f"dct matrix has {dct.shape[0]} rows, expected {n_out}")
    n_final = n_out if dct is None else dct.shape[1]

    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise InvalidInputError(
            f"the fused kernel runs on CUDA (its plain version on the CPU), not {dev}"
        )
    f32 = dict(dtype=torch.float32, device=dev)
    win = np.ones(n_fft) if window_key is None else np.asarray(window_key, np.float64)
    window_t = torch.tensor(win, **f32)
    mapping_t = torch.tensor(fb, **f32)
    dct_t = None if dct is None else torch.tensor(dct, **f32)
    floor_db = float(floor_db)

    if dev.type == "cuda":
        k = np.arange(n_fft // 2, dtype=np.float64)
        ang = 2.0 * np.pi * k / n_fft
        twiddle_t = torch.tensor(np.stack([np.cos(ang), -np.sin(ang)], axis=1), **f32)
        mapping_nat = mapping_t.T.contiguous()               # (n_bins, n_out)
        bands_t = torch.tensor(mapping_bands(fb), device=dev)
        tile_f = _tile_frames(n_fft, n_bins, n_out, dct is not None)
        smem = _smem_bytes(tile_f, n_fft, n_bins, n_out, dct is not None)
        log2n = n_fft.bit_length() - 1
        eps = 10.0 ** (floor_db / 10.0)

    def launch(xb):
        from ._build import load_library

        lib = load_library("fused_features", _SIGNATURES)
        batch, n = xb.shape
        if batch > 65535:
            raise InvalidInputError(f"batch {batch} exceeds the kernel's grid limit 65535")
        nf = frame_count(n, n_fft, hop, centre)
        out = torch.empty((batch, n_final, nf), **f32)
        # The C entry launches on the current device; the guard sets it to
        # the tensors' and restores the caller's.
        with torch.cuda.device(xb.device):
            rc = lib.fused_features_launch(
                xb.data_ptr(), window_t.data_ptr(), twiddle_t.data_ptr(),
                mapping_nat.data_ptr(), bands_t.data_ptr(),
                None if dct_t is None else dct_t.data_ptr(), out.data_ptr(),
                batch, n, log2n, hop, n_fft // 2 if centre else 0, nf,
                n_bins, n_out, 0 if dct_t is None else n_final,
                _AMPS[amp], _PRE_AMPS[pre_amp], eps, tile_f, smem,
                torch.cuda.current_stream(xb.device).cuda_stream,
            )
        if rc != 0:
            msg = lib.fused_features_error_string(rc).decode()
            raise FftBackendError(f"fused_features kernel launch failed: {msg} ({rc})")
        fused_factored_features.launches += 1
        return out

    def run(x):
        if x.dtype != torch.float32:
            raise InvalidInputError(f"the fused kernel takes float32, got {x.dtype}")
        if x.device != dev:
            raise InvalidInputError(f"signal is on {x.device}, the kernel's constants on {dev}")
        if x.device.type == "cpu":
            return fused_features_reference(
                x, window_t, mapping_t, amp, floor_db, pre_amp, dct_t, centre, n_fft, hop
            )
        if x.ndim == 1:
            return launch(x.contiguous()[None, :])[0]
        if x.ndim != 2:
            raise InvalidInputError(f"expected (n,) or (batch, n), got {tuple(x.shape)}")
        return launch(x.contiguous())

    return run


fused_factored_features.launches = 0
