"""The general traffic generator: inputs from ``--seed`` and a traffic file.

Every seed gets the same sizes; only the values change. Batches are made on
the device in a few large calls with a seeded ``torch.Generator`` there; the
WAV corpus is written with one numpy generator.

``tones`` is a frozen copy of ``chip_smoke.py::signal`` (noise plus three
tones a row, broadband and peaked bins both), moved onto the device;
``noise`` is unit white noise, as config 4 draws it.
"""

from __future__ import annotations

import math
import wave
from pathlib import Path

import numpy as np
import torch


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64, device=device)


def tones(gen, batch: int, n: int, sr: float, device) -> torch.Tensor:
    """(batch, n) float32: 0.05·N(0, 1) plus three tones of 80 Hz–0.45·sr."""
    t = torch.arange(n, dtype=torch.float64, device=device) / sr
    x = 0.05 * torch.randn((batch, n), generator=gen, dtype=torch.float64, device=device)
    for _ in range(3):
        f = _uniform(gen, (batch, 1), 80.0, 0.45 * sr, device)
        a = _uniform(gen, (batch, 1), 0.1, 0.5, device)
        x += a * torch.sin(2.0 * math.pi * f * t)
    return x.to(torch.float32)


def noise(gen, batch: int, n: int, sr: float, device) -> torch.Tensor:
    """(batch, n) float32 unit white noise."""
    return torch.randn((batch, n), generator=gen, dtype=torch.float32, device=device)


SIGNALS = {"tones": tones, "noise": noise}


def clip_samples(traffic: dict) -> int:
    return int(round(traffic["clip_s"] * traffic["sr"]))


def make_pool(traffic: dict, seed: int, device) -> list:
    """``traffic["pool"]`` distinct (clips, n) batches drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    make = SIGNALS[traffic["signal"]]
    n = clip_samples(traffic)
    return [make(gen, int(traffic["clips"]), n, float(traffic["sr"]), device)
            for _ in range(int(traffic["pool"]))]


def corpus_pcm(traffic: dict, seed: int) -> np.ndarray:
    """(files, n) int16: white noise at ``rms`` of full scale, from ``seed``."""
    n = clip_samples(traffic)
    rng = np.random.default_rng(int(seed))
    x = rng.standard_normal((int(traffic["files"]), n)) * (traffic["rms"] * 32768.0)
    return np.clip(np.rint(x), -32768, 32767).astype("<i2")


def write_corpus(traffic: dict, seed: int, directory: Path):
    """``traffic["files"]`` mono PCM16 WAVs of ``clip_s`` each under
    ``directory``: (their paths, the (files, n) int16 samples written)."""
    pcm = corpus_pcm(traffic, seed)
    paths = []
    for i, row in enumerate(pcm):
        path = directory / f"clip_{i:05d}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(int(traffic["sr"]))
            w.writeframes(row.tobytes())
        paths.append(str(path))
    return paths, pcm
