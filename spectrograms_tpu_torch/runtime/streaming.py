"""Stateful streaming: the native ring-buffer framer and a block feature step.

Counterpart of ``spectrograms_tpu.runtime.streaming``. A constant-memory C++
ring buffer (``native/sgtpu.cpp``) turns sample chunks of any size into
hop-advanced frames on the host, and the plan maps whole frame *blocks* to
features on its device: per chunk, one host copy and one step.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..dtypes import numpy_dtype
from ..errors import InvalidInputError
from .native import NativeUnavailable, load_library

__all__ = ["StreamingFramer", "StreamingSpectrogram"]


class StreamingFramer:
    """Push sample chunks, pop complete (n, n_fft) frame blocks.

    Backed by the C++ ring buffer when the native library loads, else by a
    numpy buffer. The ``n_fft - hop`` overlap stays buffered between calls;
    ``flush()`` zero-pads the final partial frame.
    """

    def __init__(self, n_fft: int, hop_size: int, capacity: Optional[int] = None):
        if n_fft <= 0 or hop_size <= 0 or hop_size > n_fft:
            raise InvalidInputError("require 0 < hop_size <= n_fft")
        self.n_fft = int(n_fft)
        self.hop_size = int(hop_size)
        cap = int(capacity) if capacity else max(64 * hop_size + n_fft, 4 * n_fft)
        # The native ring's own floor: a frame plus its successor's hop.
        cap = max(cap, 2 * self.n_fft)
        self._lib = None
        self._h = None
        try:
            self._lib = load_library()
            self._h = self._lib.sg_framer_new(self.n_fft, self.hop_size, cap)
            if not self._h:
                raise NativeUnavailable("sg_framer_new failed")
        except NativeUnavailable:
            self._lib = None
            self._buf = np.zeros(0, dtype=np.float32)
        self._capacity = cap

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.sg_framer_free(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        return self._lib is not None

    def available(self) -> int:
        """Complete frames currently poppable."""
        if self._lib is not None:
            return int(self._lib.sg_framer_available(self._h))
        if self._buf.shape[0] < self.n_fft:
            return 0
        return (self._buf.shape[0] - self.n_fft) // self.hop_size + 1

    def push(self, samples) -> int:
        """Buffer a chunk; returns the samples accepted (all, unless full)."""
        x = np.ascontiguousarray(np.asarray(samples, dtype=np.float32).ravel())
        if self._lib is not None:
            return int(self._lib.sg_framer_push(
                self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.shape[0]))
        accept = min(x.shape[0], self._capacity - self._buf.shape[0])
        self._buf = np.concatenate([self._buf, x[:accept]])
        return accept

    def pop(self, max_frames: Optional[int] = None) -> np.ndarray:
        """Pop up to max_frames complete frames → (k, n_fft) float32."""
        n = self.available()
        if max_frames is not None:
            n = min(n, int(max_frames))
        if n <= 0:
            return np.zeros((0, self.n_fft), dtype=np.float32)
        out = np.empty((n, self.n_fft), dtype=np.float32)
        if self._lib is not None:
            got = int(self._lib.sg_framer_pop(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n))
            return out[:got]
        for i in range(n):
            out[i] = self._buf[i * self.hop_size:i * self.hop_size + self.n_fft]
        self._buf = self._buf[n * self.hop_size:]
        return out

    def flush(self) -> np.ndarray:
        """Drain the tail as one zero-padded frame → (0 or 1, n_fft)."""
        out = np.zeros((1, self.n_fft), dtype=np.float32)
        if self._lib is not None:
            got = int(self._lib.sg_framer_flush(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))))
            return out[:got]
        if self._buf.shape[0] == 0:
            return out[:0]
        have = min(self._buf.shape[0], self.n_fft)
        out[0, :have] = self._buf[:have]
        self._buf = np.zeros(0, dtype=np.float32)
        return out


class StreamingSpectrogram:
    """End-to-end streaming feature extractor.

    Couples a :class:`StreamingFramer` with a ``SpectrogramPlan``'s frames →
    features step. ``process(chunk)`` returns the features of every frame
    that chunk completed, shaped (n_bins, k), as host numpy; frame blocks
    are padded to ``block_frames`` rows so the step sees one shape.

    A ``centre=True`` plan primes the framer with ``n_fft//2`` zeros and
    :meth:`finish` pushes the matching right padding, so the concatenated
    output equals ``plan.compute(signal)`` frame for frame. ``centred=False``
    streams raw frames: frame i covers samples [i*hop, i*hop + n_fft).
    """

    def __init__(self, plan, block_frames: int = 64, capacity: Optional[int] = None,
                 centred: Optional[bool] = None):
        self.plan = plan
        self.block_frames = int(block_frames)
        self.centred = bool(plan._centre) if centred is None else bool(centred)
        self.framer = StreamingFramer(plan._n_fft, plan._hop, capacity=capacity)
        if self.centred:
            self.framer.push(np.zeros(plan._n_fft // 2, dtype=np.float32))

    def _empty(self) -> np.ndarray:
        return np.zeros((self.plan.n_output_bins, 0), dtype=numpy_dtype(self.plan._dtype))

    def process(self, chunk) -> np.ndarray:
        """Push a chunk, compute the features of every completed frame."""
        accepted = self.framer.push(chunk)
        x = np.asarray(chunk).ravel()
        rest = x[accepted:] if accepted < x.shape[0] else None
        outs = []
        while True:
            frames = self.framer.pop(self.block_frames)
            if frames.shape[0] == 0:
                break
            outs.append(self._run_block(frames))
            if rest is not None:
                accepted = self.framer.push(rest)
                rest = rest[accepted:] if accepted < rest.shape[0] else None
        return np.concatenate(outs, axis=1) if outs else self._empty()

    def finish(self) -> np.ndarray:
        """Drain the stream's tail.

        Centred: push the ``n_fft//2`` right padding and emit every frame
        left, so the whole output equals the offline ``plan.compute``.
        Uncentred: flush one last zero-padded partial frame.
        """
        if self.centred:
            return self.process(np.zeros(self.plan._n_fft // 2, dtype=np.float32))
        frames = self.framer.flush()
        if frames.shape[0] == 0:
            return self._empty()
        return self._run_block(frames)

    def _run_block(self, frames: np.ndarray) -> np.ndarray:
        k = frames.shape[0]
        if k < self.block_frames:
            frames = np.pad(frames, ((0, self.block_frames - k), (0, 0)))
        block = torch.as_tensor(frames, dtype=self.plan._dtype, device=self.plan.device)
        feats = self.plan._forward_frames(block)  # (block, n_bins)
        return feats[:k].T.cpu().numpy()
