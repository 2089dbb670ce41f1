"""G.711 μ-law companding for the 8-bit serving transport.

Counterpart of ``spectrograms_tpu.runtime.ulaw``. ``transport="ulaw"`` ships
one byte per sample to the card, a quarter of the float32 bytes, at G.711's
logarithmic resolution (≈ 38 dB SQNR on full-scale material, ~13-bit near
zero). Bytes are the **uncomplemented** μ-law code, so silence is 0x00 and
zero-padded rows decode to exactly 0.

Encode (host, through a 65536-entry LUT):
    v = min(|s|, 32635) + 0x84;  exp = msb(v) − 7;
    mant = (v >> (exp+3)) & 0xF;  code = sign<<7 | exp<<4 | mant
Decode (``ulaw_decode_torch`` on the card, or the LUT on the host):
    mag = (((mant<<3) + 0x84) << exp) − 0x84;  s = ±mag   (≤ 32124)

The native loader applies the same LUT in its decode workers
(``native/sgtpu.cpp::sg_wav_decode_into_ulaw``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["ulaw_encode", "ulaw_decode_i16", "ulaw_decode_torch"]

_BIAS = 0x84
_CLIP = 32635


@lru_cache(maxsize=1)
def _encode_lut() -> np.ndarray:
    """uint16 PCM pattern (int16 viewed unsigned) → uncomplemented code."""
    s = np.arange(65536, dtype=np.uint16).astype(np.int16).astype(np.int32)
    sign = np.where(s < 0, 0x80, 0).astype(np.int32)
    v = np.minimum(np.abs(s), _CLIP) + _BIAS
    # exponent = bit length of v minus 8 (v ∈ [0x84, 0x7FFF+0x84] ⇒ 0..7)
    exp = np.clip(np.floor(np.log2(v)).astype(np.int32) - 7, 0, 7)
    mant = (v >> (exp + 3)) & 0xF
    lut = (sign | (exp << 4) | mant).astype(np.uint8)
    lut.setflags(write=False)
    return lut


@lru_cache(maxsize=1)
def _decode_lut() -> np.ndarray:
    """code byte → int16 sample."""
    b = np.arange(256, dtype=np.int32)
    sign, exp, mant = b >> 7, (b >> 4) & 0x7, b & 0xF
    mag = (((mant << 3) + _BIAS) << exp) - _BIAS
    out = np.where(sign == 1, -mag, mag).astype(np.int16)
    out.setflags(write=False)
    return out


def ulaw_encode(x) -> np.ndarray:
    """int16 PCM (or float in [−1, 1]) → uncomplemented μ-law bytes."""
    x = np.asarray(x)
    if x.dtype != np.int16:
        x = np.clip(np.rint(x.astype(np.float64) * 32768.0), -32768, 32767).astype(np.int16)
    return _encode_lut()[x.view(np.uint16)]


def ulaw_decode_i16(b) -> np.ndarray:
    """μ-law bytes → int16 samples (the host reference decode)."""
    return _decode_lut()[np.asarray(b, dtype=np.uint8)]


def ulaw_decode_torch(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """μ-law bytes (uint8 tensor) → float samples on the tensor's device.

    The integer decode of :func:`ulaw_decode_i16`, exactly, scaled by
    1/32768 as the int16 transport is. The bytes are widened to int32
    first: a uint8 shift overflows.
    """
    u = b.to(torch.int32)
    exp = (u >> 4) & 0x7
    mag = ((((u & 0xF) << 3) + _BIAS) << exp) - _BIAS
    val = torch.where((u >> 7) == 1, -mag, mag)
    return val.to(dtype) * (1.0 / 32768.0)
