"""WAV read/write through the native codec, with a stdlib ``wave`` fallback.

Counterpart of ``spectrograms_tpu.runtime.wav``: the same files, the same
float32 values.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from .native import NativeUnavailable, load_library

__all__ = ["read_wav", "write_wav"]


def read_wav(path: Union[str, Path], mono: bool = False) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 array in [-1, 1], sample_rate).

    Shape is (n,) for mono files, (n, channels) otherwise. ``mono=True``
    averages channels. Decoding runs in C++ (PCM 8/16/24/32 + float32/64).
    """
    path = str(path)
    try:
        lib = load_library()
    except NativeUnavailable:
        return _read_wav_py(path, mono)

    out = ctypes.POINTER(ctypes.c_float)()
    n_frames = ctypes.c_int64()
    n_ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    rc = lib.sg_wav_read(
        path.encode(), ctypes.byref(out), ctypes.byref(n_frames),
        ctypes.byref(n_ch), ctypes.byref(sr),
    )
    if rc != 0:
        raise IOError(lib.sg_last_error().decode("utf-8", "replace"))
    n, ch = n_frames.value, n_ch.value
    try:
        arr = np.ctypeslib.as_array(out, shape=(n * ch,)).copy()
    finally:
        lib.sg_free(out)
    data = arr.reshape(n, ch)
    if ch == 1:
        data = data[:, 0]
    elif mono:
        data = data.mean(axis=1)
    return data, sr.value


def write_wav(path: Union[str, Path], data, sample_rate: int, bits: int = 16) -> None:
    """Write float32 data in [-1, 1] as WAV (bits=16 PCM or 32 IEEE float)."""
    arr = np.asarray(data, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2:
        raise ValueError(f"expected (n,) or (n, channels), got {arr.shape}")
    arr = np.ascontiguousarray(arr)
    try:
        lib = load_library()
    except NativeUnavailable:
        return _write_wav_py(str(path), arr, sample_rate, bits)
    rc = lib.sg_wav_write(
        str(path).encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        arr.shape[0], arr.shape[1], int(sample_rate), int(bits),
    )
    if rc != 0:
        raise IOError(lib.sg_last_error().decode("utf-8", "replace"))


# ---- pure-Python fallbacks (stdlib wave: PCM16 only) -----------------------

def _read_wav_py(path: str, mono: bool) -> Tuple[np.ndarray, int]:
    import wave

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise IOError(f"unsupported sample width {width}")
    data = data.reshape(-1, ch)
    if ch == 1:
        data = data[:, 0]
    elif mono:
        data = data.mean(axis=1)
    return data, sr


def _write_wav_py(path: str, arr: np.ndarray, sample_rate: int, bits: int) -> None:
    import wave

    if bits != 16:
        raise ValueError("the pure-Python fallback only writes PCM16; build the native library")
    pcm = np.rint(np.clip(arr, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(arr.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
