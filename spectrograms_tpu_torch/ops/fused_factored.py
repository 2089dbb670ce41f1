"""Fused feature kernels: signal → windowed real DFT → |·|² → filterbank
(→ dB → DCT) in one CUDA launch.

Counterpart of ``spectrograms_tpu.ops.pallas_factored``, the JAX package's
one Pallas kernel (``_kernel``, built by ``fused_factored_features``). Its
precision tiers map onto two kernels hand-written for Hopper (sm_90a):

- ``bf16x3`` (``precision=HIGH``, the default): ``csrc/fused_features.cu``,
  all f32, more precise than the tier. ``fused_factored_features.launches``
  counts its launches.
- ``bf16`` (``precision=DEFAULT``) and ``bf16x2`` (``method="pallas:x2"``):
  ``csrc/fused_tier_features.cu``, the TPU kernel's factorization with its
  outer DFT, filterbank and DCT on bf16 tensor cores (``mma.sync``), rounded
  at the same points as the TPU tiers. ``fused_tier_features.launches``
  counts its launches.

Each kernel's source note gives its bound on the H100. This module holds,
under the JAX module's public names:

- ``parse_pallas_method`` and the factory ``fused_factored_features`` with
  the JAX factory's variant arguments and errors. The variant forms map onto
  the two kernels: ``gauss`` is a form of the tier kernel; ``dif``,
  ``prune`` and ``stack`` are exact rearrangements of the packed product and
  run it (in the tier kernel, or in the f32 kernel at ``bf16x3``);
- ``fused_features_reference`` and ``fused_tier_features_reference``, the
  plain PyTorch versions. A runner launches its kernel on a CUDA tensor (or
  raises) and runs the plain version on a CPU tensor, the only case in
  which it does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..dtypes import parse_dtype, resolve_device
from ..errors import FftBackendError, InvalidInputError
from ..spans import span
from . import f32_layout as fl32
from . import factored_layout as fl
from . import tier_layout as tl
from .framing import frame_count, frame_signal

__all__ = [
    "fused_factored_features",
    "fused_tier_features",
    "fused_features_reference",
    "fused_tier_features_reference",
    "tier_constants",
    "tier_geometry",
    "supports_factored_fusion",
    "parse_pallas_method",
    "build_kernels",
    "KernelConst",
]

_AMPS = {"power": 0, "magnitude": 1, "decibels": 2}
_PRE_AMPS = {"none": 0, "magnitude": 1}
_PRECISIONS = ("bf16", "bf16x2", "bf16x3")
_METHOD_OPTIONS = {
    # method-string suffix -> fused_factored_features kwarg (the JAX table)
    "dif": ("dif", True),
    "stack": ("x3_stack", True),
    "gauss": ("gauss", True),
    "prune": ("column_prune", True),
    # a precision tier, unlike the equivalent forms above: callers pop
    # "precision" so that it wins over the plan's DEFAULT/HIGH tier
    "x2": ("precision", "bf16x2"),
}
# Shared memory a block may use on sm_90 (227 KB).
_MAX_SMEM = fl32.MAX_SMEM


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
    """``"pallas[:opt[+opt...]]"`` → ``fused_factored_features`` kwargs.

    The JAX package's parse: ``"pallas:x2+dif"`` gives
    ``{"precision": "bf16x2", "dif": True}``. Raises on a string that is not
    a pallas method and on unknown options; the factory checks combinations.
    """
    if method == "pallas":
        return {}
    if not method.startswith("pallas:"):
        raise InvalidInputError(f"not a pallas method string: {method!r}")
    kwargs = {}
    for opt in method[len("pallas:"):].split("+"):
        if opt not in _METHOD_OPTIONS:
            raise InvalidInputError(
                f"unknown pallas option {opt!r}; expected one of "
                f"{sorted(_METHOD_OPTIONS)} joined with '+'"
            )
        k, v = _METHOD_OPTIONS[opt]
        kwargs[k] = v
    return kwargs


def fused_features_reference(x, window, mapping, amp, floor_db, pre_amp, dct,
                             centre, n_fft, hop):
    """Plain PyTorch version of the f32 kernel: (..., n) → (..., n_out, n_frames).

    pad → frames → window → ``torch.fft.rfft`` → |X|² → (sqrt if
    ``pre_amp == "magnitude"``) → ``@ mapping.T`` → amp → (``@ dct``).
    ``mapping`` is (n_out, n_bins); ``dct`` is (n_out, n_coef) or None.
    """
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop, centre) * window, dim=-1)
    p = spec.real * spec.real + spec.imag * spec.imag
    if pre_amp == "magnitude":
        p = torch.sqrt(p)
    feat = p @ mapping.T
    return _amp_dct(feat, amp, floor_db, dct, lambda a, b: a @ b)


def _amp_dct(feat, amp, floor_db, dct, dot):
    """Amplitude scale, then the optional DCT product; (..., n_frames, ·) →
    (..., ·, n_frames)."""
    if amp == "magnitude":
        feat = torch.sqrt(feat)
    elif amp == "decibels":
        feat = 10.0 * torch.log10(torch.clamp_min(feat, 10.0 ** (floor_db / 10.0)))
    if dct is not None:
        feat = dot(feat, dct)
    return feat.transpose(-1, -2).contiguous()


# ---- the bf16 tiers -------------------------------------------------------

@dataclass(frozen=True)
class TierConstants:
    """A tier plan's constants as f32 tensors (bf16 values where split).

    ``rw_*`` (256, 256) real-class outer constants, ``g_*`` the complex-class
    constant (packed (256, 256) or Gauss (128, 384)), ``map_*`` the folded
    mapping (classes·128, n_out), ``dct_*`` (n_out, n_coef) or None.
    """

    n_fft: int
    precision: str
    gauss: bool
    window: torch.Tensor
    twiddle: torch.Tensor
    rw_hi: torch.Tensor
    rw_lo: torch.Tensor
    g_hi: torch.Tensor
    g_lo: torch.Tensor
    map_hi: torch.Tensor
    map_lo: torch.Tensor
    dct_hi: Optional[torch.Tensor]
    dct_lo: Optional[torch.Tensor]


def tier_constants(n_fft, window, mapping, dct, precision, gauss, device) -> TierConstants:
    """Build a tier's constants from the f64 window (n_fft,), natural
    mapping (n_out, n_bins) and DCT (n_out, n_coef) or None, on ``device``."""
    rw, G = fl.outer_constants(n_fft, gauss)
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    pair = lambda a: tuple(t(h) for h in fl.split_bf16(a))
    dct_hi, dct_lo = (None, None) if dct is None else pair(dct)
    return TierConstants(
        n_fft, precision, bool(gauss), t(window), t(fl.class_twiddles(n_fft)),
        *pair(rw), *pair(G), *pair(fl.fold_mapping(mapping, n_fft)), dct_hi, dct_lo,
    )


def _bf16(a):
    return a.to(torch.bfloat16).to(torch.float32)


def _tier_dot(a, b_hi, b_lo, passes: int):
    """The JAX kernel's ``dot3`` on bf16-rounded operands, f32 sums.

    1 pass aₕbₕ; 2 passes aₕbₕ + aₕbₗ; 3 passes (aₕbₕ + aₕbₗ) + aₗbₕ.
    Each product of two bf16 values is exact in f32.
    """
    a_hi = _bf16(a)
    y = a_hi @ b_hi
    if passes > 1:
        y = y + a_hi @ b_lo
    if passes > 2:
        y = y + _bf16(a - a_hi) @ b_hi
    return y


def fused_tier_features_reference(x, consts: TierConstants, amp, floor_db, pre_amp,
                                  centre, hop):
    """Plain PyTorch version of the tier kernel: (..., n) → (..., n_out, n_frames).

    The TPU kernel's factorization at the ``bf16`` / ``bf16x2`` tier:
    frames → window → 128-sample chunks → inner r-point DFT in f32 →
    twiddle → outer 128-point DFT as products of bf16-rounded operands
    (1 pass at bf16, 2 at bf16x2; Gauss or packed complex form) → |X|² in
    the (c, k₁) layout → (sqrt) → folded filterbank → amp → (DCT), the tail
    products in 1 pass at bf16 and 3 at bf16x2.
    """
    c = consts
    r = c.n_fft // 128
    outer, tail = (2, 3) if c.precision == "bf16x2" else (1, 1)
    dot = lambda a, b_hi, b_lo: _tier_dot(a, b_hi, b_lo, outer)
    frames = frame_signal(x, c.n_fft, hop, centre) * c.window
    ys = fl.real_fft_classes([frames[..., n2 * 128:(n2 + 1) * 128] for n2 in range(r)])
    ps = [None] * (r // 2 + 1)
    for slot, cls in enumerate((0, r // 2)):
        rows = slice(slot * 128, (slot + 1) * 128)
        xx = dot(ys[cls][0], c.rw_hi[rows], c.rw_lo[rows])
        ps[cls] = xx[..., :128] * xx[..., :128] + xx[..., 128:] * xx[..., 128:]
    for cls in range(1, r // 2):
        y_re, y_im = ys[cls]
        tw_re, tw_im = c.twiddle[cls, :128], c.twiddle[cls, 128:]
        a_re = y_re * tw_re - y_im * tw_im
        a_im = y_re * tw_im + y_im * tw_re
        if c.gauss:
            g = lambda j: (c.g_hi[:, j * 128:(j + 1) * 128], c.g_lo[:, j * 128:(j + 1) * 128])
            t1 = dot(a_re + a_im, *g(0))
            t2 = dot(a_im, *g(1))
            t3 = dot(a_re, *g(2))
            p, q = t1 - t2, t1 + t3
        else:
            xx = dot(torch.cat([a_re, a_im], dim=-1), c.g_hi, c.g_lo)
            p, q = xx[..., :128], xx[..., 128:]
        ps[cls] = p * p + q * q
    power = torch.cat(ps, dim=-1)
    if pre_amp == "magnitude":
        power = torch.sqrt(power)
    feat = _tier_dot(power, c.map_hi, c.map_lo, tail)
    dct = None if c.dct_hi is None else (c.dct_hi, c.dct_lo)
    return _amp_dct(feat, amp, floor_db, dct, lambda a, d: _tier_dot(a, *d, tail))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tier_geometry(fb: np.ndarray, dct, n_fft: int) -> tuple:
    """(ntiles, slots, kc, map_cols, kd): what the tier kernel's block is
    sized by. The mapping reads some outer n-tiles only: P holds those
    (``kc`` columns), and the filterbank runs over the nonzero k-steps of
    the compact mapping (``map_cols`` columns). With a DCT the filterbank's
    columns are the DCT's rows, 16 to a k-step (``kd``; 0 without)."""
    ntiles = tl.class_ntiles(fb, n_fft)
    slots, kc = tl.power_slots(ntiles)
    map_cols = _round_up(fb.shape[0], 16 if dct is not None else 8)
    return ntiles, slots, kc, map_cols, map_cols if dct is not None else 0


def _fragments(b, rows: int, cols: int, x2: bool, device):
    """Zero-pad (K, N) to (rows, cols), split to bf16 and lay out as mma B
    fragments: (hi, lo) int16 tensors of the bf16 bits, lo None at 1 pass."""
    padded = np.zeros((rows, cols), dtype=np.float64)
    padded[: b.shape[0], : b.shape[1]] = b
    hi, lo = fl.split_bf16(padded)
    frag = lambda a: torch.from_numpy(fl.mma_b_fragments(a).view(np.int16)).to(device)
    return frag(hi), (frag(lo) if x2 else None)


_SIGNATURES = {
    "fused_features_launch": (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 9
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
    "fused_features_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

_TIER_SIGNATURES = {
    "fused_tier_features_launch": (
        [ctypes.c_void_p] * 17
        + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 23
        + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "fused_tier_features_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


# csrc source of each kernel -> the signatures of its C entry points
_SOURCES = {"fused_features": _SIGNATURES, "fused_tier_features": _TIER_SIGNATURES}


def build_kernels(sources) -> None:
    """Build and load the named kernel sources (``run.source`` of a
    runner) without launching them: one ``nvcc`` each, all started
    together; a built source is loaded as it is."""
    from ._build import build_all, load_library

    sources = sorted(set(sources))
    build_all(sources)
    for name in sources:
        load_library(name, _SOURCES[name])


def _geometry(n_fft, hop, mapping_key, amp, pre_amp, dct_key):
    """Validate a kernel request; (mapping (n_out, n_bins), dct or None) f64."""
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
    dct = None if dct_key is None else dct_key.array        # (n_out, n_coef)
    if dct is not None and dct.shape[0] != fb.shape[0]:
        raise InvalidInputError(f"dct matrix has {dct.shape[0]} rows, expected {fb.shape[0]}")
    return fb, dct


def _kernel_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise InvalidInputError(
            f"the fused kernel runs on CUDA (its plain version on the CPU), not {dev}"
        )
    return dev


def _runner(dev, plain, launch, source, **work):
    """The runner of a factory: plain version on a CPU tensor, else the
    kernel of ``csrc/<source>.cu`` (``run.source``). ``work`` (the f64
    ``mapping`` and ``dct``, ``pre_amp``, and for the tier kernel its
    ``precision`` and ``gauss`` form) rides along as attributes, for the
    cost model (``profiling.plan_cost``). ``run.plain`` is the plain
    version on the runner's constants, on any device: what a check on the
    card holds the kernel against. A launch is the span ``tg.kernel.<source>``."""
    span_name = "tg.kernel." + source

    def run(x):
        if x.dtype != torch.float32:
            raise InvalidInputError(f"the fused kernel takes float32, got {x.dtype}")
        if x.device != dev:
            raise InvalidInputError(f"signal is on {x.device}, the kernel's constants on {dev}")
        if x.device.type == "cpu":
            return plain(x)
        if x.ndim == 1:
            with span(span_name):
                return launch(x.contiguous()[None, :])[0]
        if x.ndim != 2:
            raise InvalidInputError(f"expected (n,) or (batch, n), got {tuple(x.shape)}")
        if x.shape[0] > 65535:
            raise InvalidInputError(f"batch {x.shape[0]} exceeds the kernel's grid limit 65535")
        with span(span_name):
            return launch(x.contiguous())

    run.source, run.plain = source, plain
    run.__dict__.update(work)
    return run


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
    precision: str = "bf16x3",
    gauss=None,                # complex product: True Gauss, False packed,
                               # None = Gauss at bf16, packed otherwise
    dif: bool = False,         # the JAX radix-2 DIF form: runs the packed one
    x3_stack: bool = False,    # the JAX stacked x3 form: runs the f32 kernel
    column_prune: bool = False,  # the JAX pruned form: runs the packed one
):
    """Build the fused program: (n,) or (B, n) f32 signal → (B, n_out, n_frames).

    ``precision`` picks the kernel: ``"bf16x3"`` the f32 kernel, ``"bf16"``
    and ``"bf16x2"`` the tier kernel (``fused_tier_features``). The variant
    arguments are the JAX factory's, with its errors on bad combinations.
    Constants are built once here, in f64 and cast on ``device``. The
    returned runner takes tensors on that device only.
    """
    fb, dct = _geometry(n_fft, hop, mapping_key, amp, pre_amp, dct_key)
    if precision not in _PRECISIONS:
        raise InvalidInputError(f"unknown precision {precision!r}")
    r = n_fft // 128
    x3 = precision == "bf16x3"
    ks = fl.needed_complex_k1(fb, r) if column_prune else None
    trunc = ks is not None and r >= 4
    if dif and trunc:
        raise InvalidInputError("dif and column_prune truncation are mutually exclusive")
    if gauss and (trunc or dif):
        raise InvalidInputError(
            "gauss=True is incompatible with column_prune truncation / dif "
            "(those paths use their own outer constants)"
        )
    if x3_stack and not x3:
        raise InvalidInputError("x3_stack requires the bf16x3 tier")
    if not x3:
        use_gauss = False if (trunc or dif) else (
            precision == "bf16" if gauss is None else bool(gauss))
        return fused_tier_features(n_fft, hop, window_key, mapping_key, amp, floor_db,
                                   centre, dct_key, pre_amp, device, precision, use_gauss)

    n_out = fb.shape[0]
    n_final = n_out if dct is None else dct.shape[1]
    dev = _kernel_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    win = np.ones(n_fft) if window_key is None else np.asarray(window_key, np.float64)
    window_t = torch.tensor(win, **f32)
    mapping_t = torch.tensor(fb, **f32)
    dct_t = None if dct is None else torch.tensor(dct, **f32)
    floor_db = float(floor_db)

    if dev.type == "cuda":
        twiddle_t = torch.tensor(fl32.twiddle_table(n_fft), **f32)
        items, first, weights = fl32.kernel_pieces(fb)
        items_t = torch.tensor(items, device=dev)
        first_t = torch.tensor(first, device=dev)
        weights_t = torch.tensor(weights, **f32)
        n_items = len(items)
        tile = fl32.tile_frames(n_fft, hop, n_items, n_out, dct is not None)
        layout = fl32.smem_layout(tile, n_fft, hop, n_items, n_out, dct is not None)
        log2n = n_fft.bit_length() - 1
        eps = 10.0 ** (floor_db / 10.0)

    def launch(xb, lib=None, tile_f=None):
        """Launch on (batch, n) ``xb``. ``lib`` is another build of the
        source (a stage variant), whose launches are not counted; ``tile_f``
        overrides the tile."""
        from ._build import load_library

        own = lib is None
        lib = load_library("fused_features", _SIGNATURES) if own else lib
        tile_f = tile if tile_f is None else tile_f
        if tile_f & (tile_f - 1):
            raise InvalidInputError(f"the kernel's tile is a power of two, not {tile_f}")
        buf_off, smem = layout if tile_f == tile else fl32.smem_layout(
            tile_f, n_fft, hop, n_items, n_out, dct is not None)
        batch, n = xb.shape
        nf = frame_count(n, n_fft, hop, centre)
        out = torch.empty((batch, n_final, nf), **f32)
        # The C entry launches on the current device; the guard sets it to
        # the tensors' and restores the caller's.
        with torch.cuda.device(xb.device):
            rc = lib.fused_features_launch(
                xb.data_ptr(), window_t.data_ptr(), twiddle_t.data_ptr(),
                items_t.data_ptr(), first_t.data_ptr(), weights_t.data_ptr(),
                None if dct_t is None else dct_t.data_ptr(), out.data_ptr(),
                batch, n, log2n, hop, n_fft // 2 if centre else 0, nf,
                n_items, n_out, 0 if dct_t is None else n_final,
                _AMPS[amp], _PRE_AMPS[pre_amp], eps, tile_f, buf_off, smem,
                torch.cuda.current_stream(xb.device).cuda_stream,
            )
        if rc != 0:
            msg = lib.fused_features_error_string(rc).decode()
            raise FftBackendError(f"fused_features kernel launch failed: {msg} ({rc})")
        if own:
            fused_factored_features.launches += 1
        return out

    def plain(x):
        return fused_features_reference(
            x, window_t, mapping_t, amp, floor_db, pre_amp, dct_t, centre, n_fft, hop
        )

    run = _runner(dev, plain, launch, "fused_features", mapping=fb, dct=dct, pre_amp=pre_amp)
    if dev.type == "cuda":
        run.launch, run.tile_f = launch, tile
    return run


fused_factored_features.launches = 0


@functools.lru_cache(maxsize=32)
def fused_tier_features(
    n_fft: int,
    hop: int,
    window_key,                # tuple(f64 window) or None
    mapping_key,               # KernelConst (n_out, n_bins) or "identity"
    amp: str = "power",
    floor_db: float = -80.0,
    centre: bool = True,
    dct_key=None,              # optional KernelConst (n_out, n_coef), after amp
    pre_amp: str = "none",
    device: str = "cuda",
    precision: str = "bf16",   # "bf16" (1 pass) or "bf16x2"
    gauss: bool = True,        # complex classes: Gauss 3-mult, else packed
):
    """The tier kernel's factory (``csrc/fused_tier_features.cu``).

    Same contract as ``fused_factored_features``, whose ``bf16`` and
    ``bf16x2`` requests land here; ``fused_tier_features.launches`` counts
    the kernel's launches.
    """
    fb, dct = _geometry(n_fft, hop, mapping_key, amp, pre_amp, dct_key)
    if precision not in ("bf16", "bf16x2"):
        raise InvalidInputError(f"the tier kernel runs bf16 and bf16x2, not {precision!r}")
    dev = _kernel_device(device)
    win = np.ones(n_fft) if window_key is None else np.asarray(window_key, np.float64)
    consts = tier_constants(n_fft, win, fb, dct, precision, gauss, dev)
    floor_db = float(floor_db)
    n_out = fb.shape[0]
    n_final = n_out if dct is None else dct.shape[1]
    x2 = precision == "bf16x2"

    if dev.type == "cuda":
        ntiles, slots, kc, map_cols, kd = tier_geometry(fb, dct, n_fft)
        rw, G = fl.outer_constants(n_fft, gauss)
        rw_f = _fragments(rw, 256, 256, x2, dev)
        g_f = _fragments(G, *G.shape, x2, dev)
        compact = np.zeros((kc, map_cols))
        compact[:, :n_out] = tl.compact_mapping(fb, n_fft, ntiles)
        map_first, map_ks = tl.sparse_ksteps(compact)
        frag = lambda a: torch.from_numpy(
            tl.packed_fragments(a, map_first, map_ks).view(np.int16)).to(dev)
        m_hi, m_lo = fl.split_bf16(compact)
        map_f = (frag(m_hi), frag(m_lo) if x2 else None)
        dct_f = (None, None) if dct is None else _fragments(
            dct, kd, _round_up(dct.shape[1], 8), x2, dev)
        k = np.arange(n_fft, dtype=np.float64)
        twiddle_t = torch.tensor(
            np.stack([np.cos(2.0 * np.pi * k / n_fft), -np.sin(2.0 * np.pi * k / n_fft)], 1),
            dtype=torch.float32, device=dev)
        ints = lambda a: torch.tensor(np.ascontiguousarray(a, dtype=np.int32), device=dev)
        first_t, ks_t, slots_t = ints(map_first), ints(map_ks), ints(slots)
        p_cols = 8 * int((slots >= 0).sum())
        ptr = lambda t: None if t is None else t.data_ptr()
        eps = 10.0 ** (floor_db / 10.0)
        blocks = {}

        def block(tile_f):
            """(layout, items, groups) of a tile of ``tile_f`` frames (None:
            the layout's own choice)."""
            if tile_f not in blocks:
                lay = tl.tier_layout(n_fft, hop, gauss, x2, kc, kd, tile_f)
                items, first = tl.outer_items(ntiles, lay.groups, lay.tile_f,
                                              tl.block_threads(n_fft) // 32)
                table = [v for (c0, c1), f in zip(lay.groups, first) for v in (c0, c1, f)]
                blocks[tile_f] = (lay, ints(items if len(items) else np.zeros((1, 4))),
                                  ints(table + [0, 0, first[-1]]))
            return blocks[tile_f]

        tile = block(None)[0].tile_f

    def launch(xb, lib=None, tile_f=None):
        """Launch on (batch, n) ``xb``. ``lib`` is another build of the
        source (a stage variant), whose launches are not counted; ``tile_f``
        overrides the tile (8 or 16 frames)."""
        from ._build import load_library

        own = lib is None
        lib = load_library("fused_tier_features", _TIER_SIGNATURES) if own else lib
        lay, items_t, groups_t = block(tile_f)
        batch, n = xb.shape
        nf = frame_count(n, n_fft, hop, centre)
        out = torch.empty((batch, n_final, nf), dtype=torch.float32, device=dev)
        with torch.cuda.device(xb.device):
            rc = lib.fused_tier_features_launch(
                xb.data_ptr(), consts.window.data_ptr(), twiddle_t.data_ptr(),
                *map(ptr, rw_f + g_f), items_t.data_ptr(), groups_t.data_ptr(),
                slots_t.data_ptr(), first_t.data_ptr(), ks_t.data_ptr(),
                *map(ptr, map_f + dct_f), out.data_ptr(),
                batch, n, n_fft.bit_length() - 1, hop, n_fft // 2 if centre else 0, nf,
                n_out, 0 if dct is None else n_final, map_cols // 8,
                0 if dct is None else _round_up(n_final, 8) // 8, kc, p_cols, kd,
                _AMPS[amp], _PRE_AMPS[pre_amp], int(x2), int(gauss), lay.tile_f,
                int(lay.staged), len(lay.groups),
                lay.p_off, lay.feat_off, lay.ar_off, lay.ac_off, lay.smem, eps,
                torch.cuda.current_stream(xb.device).cuda_stream,
            )
        if rc != 0:
            msg = lib.fused_tier_features_error_string(rc).decode()
            raise FftBackendError(f"fused_tier_features kernel launch failed: {msg} ({rc})")
        if own:
            fused_tier_features.launches += 1
        return out

    def plain(x):
        return fused_tier_features_reference(x, consts, amp, floor_db, pre_amp, centre, hop)

    run = _runner(dev, plain, launch, "fused_tier_features", mapping=fb, dct=dct,
                  pre_amp=pre_amp, precision=precision, gauss=gauss)
    if dev.type == "cuda":
        run.launch, run.tile_f = launch, tile
    return run


fused_tier_features.launches = 0
