"""Prefetching audio batch loader: C++ worker threads → padded batches.

Counterpart of ``spectrograms_tpu.runtime.loader``: the same native loader
(``native/sgtpu.cpp``), the same batches, lengths and rates, and the same
rate policies and transports.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..errors import InvalidInputError
from .native import NativeUnavailable, load_library
from .resample import resample
from .ulaw import ulaw_encode
from .wav import read_wav

__all__ = ["AudioBatchLoader"]

_RATE_POLICIES = ("error", "resample", "ignore")
_DTYPES = ("float32", "int16", "ulaw")


def _quantize_i16(x: np.ndarray) -> np.ndarray:
    """Nearest-LSB full-scale quantization (the native int16 decode's).

    Round-trips PCM16-decoded floats exactly: read_wav gives v/32768, and
    rint(v/32768 · 32768) = v.
    """
    return np.clip(np.rint(np.asarray(x) * 32768.0), -32768, 32767).astype(np.int16)


def _check_args(batch_size, target_len, on_rate_mismatch, dtype):
    if batch_size <= 0 or target_len <= 0:
        raise InvalidInputError("batch_size and target_len must be positive")
    if on_rate_mismatch not in _RATE_POLICIES:
        raise InvalidInputError(
            f"on_rate_mismatch must be one of {_RATE_POLICIES}, got {on_rate_mismatch!r}"
        )
    if dtype not in _DTYPES:
        raise InvalidInputError(
            f"loader dtype must be 'float32', 'int16' or 'ulaw', got {dtype!r}"
        )


class AudioBatchLoader:
    """Iterate padded ``(batch, target_len)`` batches decoded off-thread.

    Worker threads in the native library decode WAV files, downmix to mono
    and fill fixed-shape rows with per-item lengths while the card computes
    the previous batch. Without the native library a synchronous numpy loop
    gives the same batches; ``_lib`` says which one runs.

    ``expected_sample_rate`` enforces the decoded rate:
    ``on_rate_mismatch='error'`` (default) raises on the first file at
    another rate, ``'resample'`` converts the row with a Kaiser-sinc
    resampler, ``'ignore'`` accepts it. :meth:`iter_with_rates` shows the
    per-row rates.

    ``dtype='int16'`` gives raw PCM rows (half the bytes of float32; the
    consumer dequantizes with the exact ``x * (1/32768)``, bit-equal to the
    float rows for PCM16 sources); ``dtype='ulaw'`` gives μ-law bytes
    (``runtime/ulaw.py``).
    """

    def __init__(
        self,
        paths: Sequence[Union[str, Path]],
        batch_size: int,
        target_len: int,
        n_threads: int = 4,
        prefetch_batches: int = 4,
        expected_sample_rate: Optional[int] = None,
        on_rate_mismatch: str = "error",
        dtype: str = "float32",
    ):
        _check_args(batch_size, target_len, on_rate_mismatch, dtype)
        self.dtype = dtype
        self._i16 = dtype == "int16"
        self._u8 = dtype == "ulaw"
        self.paths: List[str] = [str(p) for p in paths]
        if not self.paths:
            raise InvalidInputError("paths must be non-empty")
        self.batch_size = int(batch_size)
        self.target_len = int(target_len)
        self.expected_sample_rate = (
            None if expected_sample_rate is None else int(expected_sample_rate)
        )
        self.on_rate_mismatch = on_rate_mismatch
        self._n_threads = int(n_threads)
        self._prefetch = int(prefetch_batches)
        self._memory = None
        self._rates = None
        try:
            self._lib = load_library()
        except NativeUnavailable:
            self._lib = None

    @classmethod
    def from_arrays(
        cls,
        arrays: Sequence,
        batch_size: int,
        target_len: int,
        *,
        sample_rates=None,
        expected_sample_rate: Optional[int] = None,
        on_rate_mismatch: str = "error",
        dtype: str = "float32",
    ) -> "AudioBatchLoader":
        """Memory-source loader: decoded signals instead of WAV paths.

        Decode any codec with any library and get the same fixed-shape
        batches, lengths, rate policy and transports as the file loader
        (f32/f64 rows are quantized once on the host for ``int16`` and
        ``ulaw``; int16 rows pass through verbatim). ``sample_rates`` is a
        scalar or per-array sequence of decoded rates (omit it to skip the
        rate check).
        """
        _check_args(batch_size, target_len, on_rate_mismatch, dtype)
        mem = [np.asarray(a).ravel() for a in arrays]
        if not mem:
            raise InvalidInputError("arrays must be non-empty")
        if any(a.shape[0] == 0 for a in mem):
            raise InvalidInputError("signals must be non-empty")
        n = len(mem)
        if sample_rates is None:
            rates = np.zeros(n, dtype=np.int32)  # 0 = unknown, the policy skips it
        elif np.ndim(sample_rates) == 0:
            rates = np.full(n, int(sample_rates), dtype=np.int32)
        else:
            rates = np.asarray(sample_rates, dtype=np.int32)
            if rates.shape != (n,):
                raise InvalidInputError(
                    f"sample_rates must be a scalar or length-{n} sequence, "
                    f"got shape {rates.shape}"
                )
        self = cls.__new__(cls)
        self.dtype = dtype
        self._i16 = dtype == "int16"
        self._u8 = dtype == "ulaw"
        self.paths = []
        self.batch_size = int(batch_size)
        self.target_len = int(target_len)
        self.expected_sample_rate = (
            None if expected_sample_rate is None else int(expected_sample_rate)
        )
        self.on_rate_mismatch = on_rate_mismatch
        self._n_threads = 0
        self._prefetch = 0
        self._memory = mem
        self._rates = rates
        self._lib = None  # nothing to decode
        return self

    # ---- iteration ---------------------------------------------------------
    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for data, lengths, _ in self.iter_with_rates():
            yield data, lengths

    def iter_with_rates(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Like iteration, but yields ``(data, lengths, sample_rates)``.

        ``sample_rates`` is ``(B,)`` int32 of the *decoded* rates (0 for
        padding rows); after a ``'resample'`` correction the row is at
        ``expected_sample_rate`` while this reports the source's rate.
        """
        if self._memory is not None:
            source = self._iter_memory()
        elif self._lib is not None:
            source = self._iter_native()
        else:
            source = self._iter_py()
        for data, lengths, srs, path_idx in source:
            self._apply_rate_policy(data, lengths, srs, path_idx)
            yield data, lengths, srs

    def iter_borrowed(self, hold: int = 1) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Zero-copy iteration: yields views into the loader's ring slots.

        Each yielded ``data`` borrows native memory, valid while its slot is
        held: the oldest slot is recycled once the generator resumes with
        ``hold`` newer batches outstanding (``hold=1`` recycles each slot on
        the next resume; ``hold=2`` keeps the previous batch alive through
        one more iteration). ``hold`` must stay below ``prefetch_batches``
        or the decode workers starve. Copy, or finish with, each batch
        inside the hold window; ``lengths`` and ``sample_rates`` are owned
        copies. Without the native library this is :meth:`iter_with_rates`.
        """
        if self._lib is None:
            yield from self.iter_with_rates()
            return
        if hold < 1:
            raise InvalidInputError(f"hold must be >= 1, got {hold}")
        if hold >= 2 and hold >= max(1, self._prefetch):
            # hold=1 releases each slot before the next acquire, so even a
            # 1-slot ring cannot deadlock; only multi-slot holds can.
            raise InvalidInputError(
                f"hold={hold} must be < prefetch_batches={self._prefetch}: "
                "holding every ring slot would deadlock the decode workers"
            )
        lib = self._lib
        if self._u8:
            acquire, sample_ctype = lib.sg_loader_acquire_u8, ctypes.c_uint8
        elif self._i16:
            acquire, sample_ctype = lib.sg_loader_acquire_i16, ctypes.c_int16
        else:
            acquire, sample_ctype = lib.sg_loader_acquire, ctypes.c_float
        h = self._new_native_handle()
        held: list = []
        try:
            while True:
                token = ctypes.c_int64(-1)
                p_data = ctypes.POINTER(sample_ctype)()
                p_len = ctypes.POINTER(ctypes.c_int64)()
                p_sr = ctypes.POINTER(ctypes.c_int32)()
                p_idx = ctypes.POINTER(ctypes.c_int64)()
                n = acquire(h, ctypes.byref(token), ctypes.byref(p_data), ctypes.byref(p_len),
                            ctypes.byref(p_sr), ctypes.byref(p_idx))
                if n < 0:
                    raise IOError(lib.sg_last_error().decode("utf-8", "replace"))
                if n == 0:
                    return
                data = np.ctypeslib.as_array(p_data, shape=(self.batch_size, self.target_len))
                lengths = np.ctypeslib.as_array(p_len, shape=(self.batch_size,)).copy()
                srs = np.ctypeslib.as_array(p_sr, shape=(self.batch_size,)).copy()
                path_idx = np.ctypeslib.as_array(p_idx, shape=(self.batch_size,)).copy()
                self._apply_rate_policy(data, lengths, srs, path_idx)
                held.append(int(token.value))
                yield data, lengths, srs
                while len(held) > hold - 1:
                    lib.sg_loader_release(h, held.pop(0))
        finally:
            for t in held:
                lib.sg_loader_release(h, t)
            lib.sg_loader_free(h)

    def _apply_rate_policy(self, data, lengths, srs, path_idx) -> None:
        expected = self.expected_sample_rate
        if expected is None or self.on_rate_mismatch == "ignore":
            return
        mismatched = np.nonzero((srs > 0) & (srs != expected))[0]
        if mismatched.size == 0:
            return
        if self.on_rate_mismatch == "error":
            offenders = ", ".join(
                f"{self._source_name(int(path_idx[i]))} ({int(srs[i])} Hz)"
                for i in mismatched[:4]
            )
            raise InvalidInputError(
                f"decoded sample rate does not match the expected {expected} "
                f"Hz: {offenders}; pass on_rate_mismatch='resample' to "
                "convert, or 'ignore' to accept mismatched features"
            )
        for i in mismatched:
            # The row was cut at target_len *source* samples: re-decode and
            # resample only what can reach the kept window, so a high-rate
            # clip keeps its duration.
            sig, sr = self._source_signal(int(path_idx[i]))
            need = int(np.ceil(self.target_len * float(sr) / float(expected))) + 256
            converted = resample(sig[:need], float(sr), float(expected))
            m = min(converted.shape[0], self.target_len)
            data[i, :] = 0
            if self._u8:
                data[i, :m] = ulaw_encode(converted[:m])
            else:
                data[i, :m] = _quantize_i16(converted[:m]) if self._i16 else converted[:m]
            lengths[i] = m

    # ---- sources -----------------------------------------------------------
    def _source_name(self, idx: int) -> str:
        if self._memory is not None:
            return f"arrays[{idx}]"
        return self.paths[idx]

    def _source_signal(self, idx: int):
        """(float32 signal, decoded rate) for rate-policy resampling."""
        if self._memory is not None:
            sig = self._memory[idx]
            if sig.dtype == np.int16:
                sig = sig.astype(np.float32) * np.float32(1.0 / 32768.0)
            return np.asarray(sig, dtype=np.float32), int(self._rates[idx])
        return read_wav(self.paths[idx], mono=True)

    @property
    def _np_dtype(self):
        return np.uint8 if self._u8 else np.int16 if self._i16 else np.float32

    def _empty_batch(self):
        return (np.zeros((self.batch_size, self.target_len), dtype=self._np_dtype),
                np.zeros((self.batch_size,), dtype=np.int64),
                np.zeros((self.batch_size,), dtype=np.int32),
                np.full((self.batch_size,), -1, dtype=np.int64))

    def _iter_memory(self):
        """Batches from decoded arrays, the contract of :meth:`_iter_py`.

        int16 rows pass through verbatim in int16 mode (and dequantize
        exactly in float mode); float rows are quantized once in int16 mode.
        """
        for start in range(0, len(self._memory), self.batch_size):
            data, lengths, srs, path_idx = self._empty_batch()
            for i, sig in enumerate(self._memory[start:start + self.batch_size]):
                m = min(sig.shape[0], self.target_len)
                row = sig[:m]
                if self._u8:
                    data[i, :m] = ulaw_encode(row if row.dtype == np.int16
                                              else row.astype(np.float32))
                elif self._i16:
                    data[i, :m] = (row if row.dtype == np.int16
                                   else _quantize_i16(row.astype(np.float32)))
                elif row.dtype == np.int16:
                    data[i, :m] = row.astype(np.float32) * np.float32(1.0 / 32768.0)
                else:
                    data[i, :m] = row
                lengths[i] = m
                srs[i] = self._rates[start + i]
                path_idx[i] = start + i
            yield data, lengths, srs, path_idx

    # ---- backends ----------------------------------------------------------
    def _new_native_handle(self):
        """Create the native loader handle (the caller frees it)."""
        lib = self._lib
        c_paths = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        h = lib.sg_loader_new2(c_paths, len(self.paths), self.batch_size, self.target_len,
                               self._n_threads, self._prefetch,
                               2 if self._u8 else (1 if self._i16 else 0))
        if not h:
            raise IOError(lib.sg_last_error().decode("utf-8", "replace"))
        return h

    def _iter_native(self):
        """Yields owned (data, lengths, srs, path_idx) native batches."""
        lib = self._lib
        nxt, sample_ctype = (
            (lib.sg_loader_next_u8, ctypes.c_uint8) if self._u8
            else (lib.sg_loader_next_i16, ctypes.c_int16) if self._i16
            else (lib.sg_loader_next, ctypes.c_float)
        )
        h = self._new_native_handle()
        try:
            while True:
                data, lengths, srs, path_idx = self._empty_batch()
                n = nxt(h, data.ctypes.data_as(ctypes.POINTER(sample_ctype)),
                        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                        path_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                if n < 0:
                    raise IOError(lib.sg_last_error().decode("utf-8", "replace"))
                if n == 0:
                    return
                yield data, lengths, srs, path_idx
        finally:
            lib.sg_loader_free(h)

    def _iter_py(self):
        for start in range(0, len(self.paths), self.batch_size):
            data, lengths, srs, path_idx = self._empty_batch()
            for i, p in enumerate(self.paths[start:start + self.batch_size]):
                sig, sr = read_wav(p, mono=True)
                n = min(sig.shape[0], self.target_len)
                if self._u8:
                    data[i, :n] = ulaw_encode(sig[:n])
                else:
                    data[i, :n] = _quantize_i16(sig[:n]) if self._i16 else sig[:n]
                lengths[i] = n
                srs[i] = sr
                path_idx[i] = start + i
            yield data, lengths, srs, path_idx
