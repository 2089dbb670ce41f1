"""The loops that drive the system: a closed loop over a pool of batches with
at most ``inflight`` batches outstanding, and passes of a ``FeaturePipeline``
over a WAV corpus.

Each loop runs either for ``seconds`` (the measured window) or for a fixed
number of steps (the traced window). Spans named ``entry``, ``sync``,
``pool_pick`` and ``pipeline_next`` mark the harness's own calls; they are
``torch.profiler.record_function`` only in a traced window and cost nothing
otherwise.
"""

from __future__ import annotations

import contextlib
import random
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch


def _null_span(name):
    return contextlib.nullcontext()


def spans(traced: bool):
    return torch.profiler.record_function if traced else _null_span


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sampler:
    """A seeded reservoir of ``k`` items among all offered: a sample of the
    window's answers drawn from the seed, kept for the check."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(int(seed))
        self.items = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclass
class Window:
    """What one loop did: steps, audio, wall time, per-call host times."""

    steps: int = 0
    audio_s: float = 0.0
    wall_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    enqueue_s: list = field(default_factory=list)
    ends_s: list = field(default_factory=list)  # each step's end, from the window's start

    def rates_per_second(self) -> list:
        """Steps in each whole second of the window: how steady the run was."""
        counts = [0] * int(self.wall_s)
        for t in self.ends_s:
            if int(t) < len(counts):
                counts[int(t)] += 1
        return counts


def closed_loop(system, pool, device, *, inflight: int, audio_per_step: float,
                seconds: float = None, steps: int = None, sampler: Sampler = None,
                traced: bool = False) -> Window:
    """Call ``system`` on ``pool`` batches in turn, at most ``inflight``
    outstanding; with ``inflight == 1`` each call is followed by a
    synchronize and its latency recorded."""
    span = spans(traced)
    win = Window()
    pending = deque()
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    deadline = None if seconds is None else t0 + seconds
    while True:
        if deadline is not None:
            if time.perf_counter() >= deadline:
                break
        elif win.steps >= steps:
            break
        with span("pool_pick"):
            i = win.steps % len(pool)
            x = pool[i]
            while cuda and len(pending) >= inflight:
                pending.popleft().synchronize()
        ts = time.perf_counter()
        with span("entry"):
            out = system(x)
        te = time.perf_counter()
        win.enqueue_s.append(te - ts)
        if inflight == 1:
            with span("sync"):
                synchronize(device)
            win.latencies_s.append(time.perf_counter() - ts)
        elif cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
        if sampler is not None:
            sampler.offer((i, out))
        win.steps += 1
        win.ends_s.append(time.perf_counter() - t0)
    with span("sync"):
        synchronize(device)
    win.wall_s = time.perf_counter() - t0
    win.audio_s = win.steps * audio_per_step
    return win


def wav_loop(system, pipe, paths, device, *, seed: int, sample_rate: float,
             seconds: float = None, passes: int = None, sampler: Sampler = None,
             traced: bool = False) -> Window:
    """Passes of ``pipe.run`` over ``paths``, each in an order drawn from
    ``seed``, until the window ends; ``system.post`` finishes each batch."""
    span = spans(traced)
    win = Window()
    rng = np.random.default_rng(int(seed))
    bs = pipe.batch_size
    t0 = time.perf_counter()
    deadline = None if seconds is None else t0 + seconds
    done, n_pass = False, 0
    while not done:
        order = rng.permutation(len(paths))
        gen = pipe.run([paths[j] for j in order])
        try:
            b = 0
            while True:
                with span("pipeline_next"):
                    batch = next(gen, None)
                if batch is None:
                    break
                ts = time.perf_counter()
                with span("entry"):
                    out = system.post(batch.features)
                win.enqueue_s.append(time.perf_counter() - ts)
                if sampler is not None:
                    sampler.offer((order[b * bs:(b + 1) * bs], out, batch.lengths,
                                   batch.frame_mask))
                win.steps += 1
                win.ends_s.append(time.perf_counter() - t0)
                win.audio_s += float(np.sum(batch.lengths)) / sample_rate
                b += 1
                if deadline is not None and time.perf_counter() >= deadline:
                    done = True
                    break
        finally:
            gen.close()
        n_pass += 1
        if passes is not None and n_pass >= passes:
            done = True
    with span("sync"):
        synchronize(device)
    win.wall_s = time.perf_counter() - t0
    return win
