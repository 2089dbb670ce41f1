"""Feature serving: decode → batch → card → features.

Counterpart of ``spectrograms_tpu.serving``:

- the C++ prefetching loader decodes and pads on worker threads
  (``runtime/loader.py``) while the card computes the previous batch;
- each fixed-shape batch ships to the card as float32, int16 PCM or μ-law
  bytes and is dequantized there in front of the plan's batched forward,
  whose features come from the fused kernels on CUDA;
- padding frames are masked from the true lengths (host numpy masks).

Copies to the card run on a stream of their own and the compute stream
waits on an event, so the work is ordered by stream waits, not host syncs.
``pipeline_uploads=True`` stages each batch in pinned memory and enqueues
its copy before the previous batch is dispatched.

``FeaturePipeline(mesh=…)`` splits each batch into row blocks over the
mesh's data axis, one a coordinate, and runs each block on its entry's
device with the plan's copy there (``parallel.data.plan_replica``); the
features come back in row order on the plan's device. ``autotune=True``
picks the plan's ``method=`` by measuring it on a zero batch of the serving
shape (the block's shape under a mesh) before the first batch.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .dtypes import resolve_device
from .errors import InvalidInputError
from .featureset import FeatureSet
from .ops.framing import frame_count
from .ops.fused_factored import build_kernels
from .parallel.data import plan_replica
from .runtime.loader import AudioBatchLoader
from .runtime.native import native_available
from .runtime.ulaw import ulaw_decode_torch
from .spans import span

__all__ = ["FeatureBatch", "FeatureSetBatch", "FeaturePipeline"]


@dataclass
class FeatureBatch:
    """One served batch: features and per-item validity.

    ``frame_mask`` stays host numpy (it comes from the host-side lengths);
    ``masked()`` moves it to the features' device.
    """

    features: torch.Tensor     # (B, n_bins, n_frames)
    lengths: np.ndarray        # (B,) true sample counts (0 = padding row)
    frame_mask: np.ndarray     # (B, n_frames) True where the frame is real

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]

    def masked(self) -> torch.Tensor:
        """Features with padding frames zeroed."""
        f = self.features
        mask = torch.as_tensor(self.frame_mask, dtype=f.dtype, device=f.device)
        return f * mask[:, None, :]


@dataclass
class FeatureSetBatch:
    """One served batch of a :class:`~spectrograms_tpu_torch.FeatureSet`.

    ``features`` holds one tensor per member, in member order;
    ``frame_masks`` one host numpy mask per member (None for members whose
    frame geometry is unknown, e.g. bare callables).
    """

    features: Tuple[torch.Tensor, ...]
    lengths: np.ndarray
    frame_masks: Tuple[Optional[np.ndarray], ...]

    @property
    def batch_size(self) -> int:
        return self.features[0].shape[0]

    def masked(self) -> Tuple[torch.Tensor, ...]:
        """Per-member features with padding frames zeroed (members without
        a known frame geometry come back unmasked)."""
        out = []
        for f, m in zip(self.features, self.frame_masks):
            if m is None:
                out.append(f)
            else:
                out.append(f * torch.as_tensor(m, dtype=f.dtype, device=f.device)[:, None, :])
        return tuple(out)


def _plan_rate(m) -> Optional[float]:
    """Sample rate of a plan: ``params`` (``SpectrogramPlan``), the plan's
    own full rate (``ChromaPlan``) or its mel plan's (``MfccPlan``)."""
    for obj in (getattr(m, "params", None), m, getattr(getattr(m, "_mel_plan", None), "params", None)):
        r = getattr(obj, "sample_rate_hz", None) or getattr(obj, "_sample_rate_hz", None)
        if r is not None:
            return float(r)
    return None


def _plan_stft(m):
    """Full-rate STFT geometry of a plan: ``params.stft``
    (``SpectrogramPlan``) or ``_stft`` (``MfccPlan``, ``ChromaPlan``)."""
    st = getattr(getattr(m, "params", None), "stft", None)
    return st if st is not None else getattr(m, "_stft", None)


def _kernel_sources(plan) -> set:
    """The kernel sources (``csrc/<name>.cu``) that a plan, or each plan of
    a FeatureSet, launches: a multirate ``SpectrogramPlan`` launches its
    inner plan's kernel."""
    out = set()
    for m in plan._members if isinstance(plan, FeatureSet) else [plan]:
        mr = getattr(m, "_multirate_inner", None)
        run = getattr(m if mr is None else mr[1], "_kernel_run", None)
        if run is not None:
            out.add(run.source)
    return out


def _waited(items):
    """A loader's ``iter_borrowed`` generator, each wait for its next batch
    in a ``tg.pipeline.loader_wait`` span; closing this closes ``items``."""
    try:
        while True:
            with span("tg.pipeline.loader_wait"):
                item = next(items, None)
            if item is None:
                return
            yield item
    finally:
        items.close()


class FeaturePipeline:
    """Stream WAV files (or decoded arrays) through a plan on its device.

    ``plan`` may also be a :class:`~spectrograms_tpu_torch.FeatureSet`: the
    corpus is then decoded, quantized and shipped once, every member runs
    per batch (sharing one decimation cascade), and batches arrive as
    :class:`FeatureSetBatch`.

    >>> pipe = FeaturePipeline(plan, batch_size=32, target_seconds=10.0)  # doctest: +SKIP
    >>> for batch in pipe.run(paths):                                     # doctest: +SKIP
    ...     train_step(batch.masked())

    On the host, two decoded clips of 1 s and 0.5 s in one batch:

    >>> import numpy as np
    >>> import spectrograms_tpu_torch as tg
    >>> plan = tg.MelDbPlan(tg.SpectrogramParams(tg.StftParams(512, 128), 16000.0),
    ...                     tg.MelParams(40, 0.0, 8000.0), tg.LogParams(-80.0), device="cpu")
    >>> clips = [np.zeros(16000, np.float32), np.zeros(8000, np.float32)]
    >>> pipe = FeaturePipeline(plan, batch_size=2, target_seconds=1.0)
    >>> [(tuple(b.masked().shape), b.lengths.tolist()) for b in pipe.run_arrays(clips, 16000.0)]
    [((2, 40, 126), [16000, 8000])]

    ``transport``: ``"float32"``; ``"int16"`` ships raw PCM (half the
    bytes) and dequantizes on the card with the exact ``x·(1/32768)``,
    bit-equal to float32 for PCM16 sources; ``"ulaw"`` ships one byte a
    sample (G.711, ≈ 38 dB SQNR), expanded on the card by integer ops.
    ``mesh``/``data_axis``: data parallelism over the mesh's ``data_axis``
    (``batch_size`` divides over it; every entry belongs to this process).
    ``autotune=True`` replaces the plan by ``autotune_plan``'s winner for
    this serving shape (``autotune_result``); a ``FeatureSet`` is tuned
    member by member instead.
    """

    def __init__(
        self,
        plan,
        batch_size: int,
        target_seconds: float,
        sample_rate_hz: Optional[float] = None,
        mesh=None,
        data_axis: str = "data",
        n_threads: int = 4,
        prefetch_batches: int = 4,
        on_rate_mismatch: str = "error",
        autotune: bool = False,
        transport: str = "float32",
        pipeline_uploads: bool = False,
    ):
        self._is_set = isinstance(plan, FeatureSet)
        if autotune and self._is_set:
            raise InvalidInputError(
                "autotune= is per-plan (it measures method= lowerings); "
                "tune FeatureSet members individually before composing"
            )
        self.plan = plan
        self.on_rate_mismatch = on_rate_mismatch
        self.pipeline_uploads = bool(pipeline_uploads)
        if self.pipeline_uploads and prefetch_batches < 3:
            raise InvalidInputError(
                "pipeline_uploads=True holds two loader ring slots and "
                f"needs prefetch_batches >= 3 (got {prefetch_batches}) so the "
                "decode workers keep a free slot"
            )
        if transport not in ("float32", "int16", "ulaw"):
            raise InvalidInputError(
                f"transport must be 'float32', 'int16' or 'ulaw', got {transport!r}"
            )
        self.transport = transport
        self._i16 = transport == "int16"
        self._u8 = transport == "ulaw"
        if sample_rate_hz is not None:
            sr = float(sample_rate_hz)
        elif self._is_set:
            rates = {r for r in (_plan_rate(m) for m in plan._members) if r is not None}
            if len(rates) > 1:
                raise InvalidInputError(
                    f"FeatureSet members disagree on sample rate ({sorted(rates)}); "
                    "pass sample_rate_hz= explicitly"
                )
            if not rates:
                raise InvalidInputError(
                    "FeatureSet of bare callables has no sample rate; pass sample_rate_hz="
                )
            sr = rates.pop()
        else:
            sr = _plan_rate(plan)
            if sr is None:
                raise InvalidInputError(
                    f"{type(plan).__name__} has no discoverable sample rate; pass sample_rate_hz="
                )
        self.sample_rate_hz = sr
        self.target_len = int(round(target_seconds * sr))
        if self.target_len <= 0:
            raise InvalidInputError("target_seconds must be positive")
        self.batch_size = int(batch_size)

        # The measured-fastest lowering for this serving shape (a decision
        # in the wisdom, load_wisdom(), skips the measurement). Under a mesh
        # each entry runs the forward on its block, so the candidates are
        # measured at the block's shape.
        self.autotune_result = None
        if autotune:
            from .autotune import autotune_plan

            tune_batch = self.batch_size
            if mesh is not None:
                tune_batch = max(1, self.batch_size // mesh.shape[data_axis])
            sample = torch.zeros((tune_batch, self.target_len), dtype=plan._dtype,
                                 device=plan.device)
            self.autotune_result = autotune_plan(plan, sample)
            plan = self.plan = self.autotune_result.plan

        self._mesh_blocks = None
        if mesh is not None:
            n_blocks = mesh.shape[data_axis]
            if self.batch_size % n_blocks != 0:
                raise InvalidInputError(
                    f"batch_size {batch_size} must divide evenly over the "
                    f"'{data_axis}' mesh axis ({n_blocks})"
                )
            if not mesh.is_local():
                raise InvalidInputError(
                    "FeaturePipeline(mesh=...) serves from one process: every mesh "
                    "entry must belong to this process (run a pipeline in each "
                    "process over its own files)"
                )
            # (rows, device, the plan's copy there): one block a coordinate
            # of the data axis; the copies are cached on the plan
            per = self.batch_size // n_blocks
            self._mesh_blocks = [
                (slice(k * per, (k + 1) * per), dev, plan_replica(plan, dev))
                for k, (dev, _) in enumerate(mesh.axis_devices(data_axis))
            ]
        self._n_threads = n_threads
        self._prefetch = prefetch_batches
        self._dtype = plan._dtype
        self.device = plan.device if plan.device is not None else resolve_device(None)
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

        # Frame geometry, fixed by target_len; a FeatureSet has one a member
        # (callables without a declared geometry get no mask).
        if self._is_set:
            self._member_geoms = []
            for m in plan._members:
                st = _plan_stft(m)
                self._member_geoms.append(None if st is None else (st.n_fft, st.hop_size, st.centre))
        else:
            stft = _plan_stft(plan)
            if stft is None:
                raise InvalidInputError(
                    f"{type(plan).__name__} has no discoverable STFT geometry for frame masking"
                )
            self._n_frames = frame_count(self.target_len, stft.n_fft, stft.hop_size, stft.centre)
            self._hop = stft.hop_size
            self._n_fft = stft.n_fft
            self._centre = stft.centre

    # ---- the step -----------------------------------------------------------
    def _dequant(self, xb: torch.Tensor) -> torch.Tensor:
        """Shipped rows → the plan's dtype, on the card."""
        if self._i16:
            return xb.to(self._dtype) * (1.0 / 32768.0)
        if self._u8:
            return ulaw_decode_torch(xb, self._dtype)
        return xb.to(self._dtype)

    def _run_plan(self, plan, xb: torch.Tensor):
        """Dequantize and run ``plan`` (or every member of the set)."""
        forward = plan._step_impl if self._is_set else plan._forward
        with torch.no_grad():
            x = self._dequant(xb)
            with span(plan._span):
                return forward(x)

    def _step(self, xb: torch.Tensor):
        """The step over one shipped batch: the plan, or under a mesh each
        row block on its entry's device, gathered in row order."""
        if self._mesh_blocks is None:
            return self._run_plan(self.plan, xb)
        outs = [self._run_plan(p, xb[rows].to(dev)) for rows, dev, p in self._mesh_blocks]
        if self._is_set:
            return tuple(torch.cat([o[i].to(self.device) for o in outs])
                         for i in range(len(outs[0])))
        return torch.cat([o.to(self.device) for o in outs])

    # ---- masks and batches ----------------------------------------------------
    @staticmethod
    def _mask_from(lengths, n_fft, hop, centre, n_frames) -> np.ndarray:
        """(B,) sample counts → (B, n_frames) bool of frames with real data."""
        n = np.asarray(lengths, dtype=np.int64)
        pad = n_fft // 2 if centre else 0
        padded = n + 2 * pad
        # frame_count, vectorized
        nf = np.where(padded < n_fft, 1, (padded - n_fft) // hop + 1)
        nf = np.where(n <= 0, 0, np.minimum(nf, n_frames))
        return np.arange(n_frames)[None, :] < nf[:, None]

    def _frame_mask(self, lengths: np.ndarray) -> np.ndarray:
        return self._mask_from(lengths, self._n_fft, self._hop, self._centre, self._n_frames)

    def _make_batch(self, feats, lengths: np.ndarray):
        """Wrap one step's output in the right batch type."""
        with span("tg.pipeline.batch"):
            if not self._is_set:
                return FeatureBatch(features=feats, lengths=lengths,
                                    frame_mask=self._frame_mask(lengths))
            masks = []
            for geom, f in zip(self._member_geoms, feats):
                if geom is None or f.ndim < 2:
                    masks.append(None)
                else:
                    # the member's actual output frames set the mask's width
                    masks.append(self._mask_from(lengths, *geom, f.shape[-1]))
            return FeatureSetBatch(features=tuple(feats), lengths=lengths, frame_masks=tuple(masks))

    # ---- entry points ---------------------------------------------------------
    @property
    def _loader_dtype(self) -> str:
        return "ulaw" if self._u8 else "int16" if self._i16 else "float32"

    def run(self, paths: Sequence, *, preload: bool = False,
            max_preload_bytes: int = 4 << 30) -> Iterator[FeatureBatch]:
        """Iterate feature batches over the given WAV files.

        ``preload=True`` ships every batch of the job to the card before the
        first step runs, then runs the steps over the staged tensors: the
        whole job's input must fit (``max_preload_bytes``). A loader error
        (a corrupt file, a rate-policy violation) stops the staging where
        the serial loop would have stopped; the good batches are served
        first and the error is raised after them.
        """
        loader = AudioBatchLoader(
            paths,
            batch_size=self.batch_size,
            target_len=self.target_len,
            n_threads=self._n_threads,
            prefetch_batches=self._prefetch,
            expected_sample_rate=int(round(self.sample_rate_hz)),
            on_rate_mismatch=self.on_rate_mismatch,
            dtype=self._loader_dtype,
        )
        if preload:
            self._check_preload_budget(len(paths), max_preload_bytes)
            return self._run_loader_preloaded(loader)
        return self._run_loader(loader)

    def run_arrays(self, arrays: Sequence, sample_rates=None, *, preload: bool = False,
                   max_preload_bytes: int = 4 << 30) -> Iterator[FeatureBatch]:
        """Iterate feature batches over decoded signals (memory source).

        Decode any codec with any library and pass the arrays: batching,
        padding, rate policy, transport and compute are those of
        :meth:`run` (``AudioBatchLoader.from_arrays``). ``sample_rates`` is a
        scalar or per-array sequence; omit it to bypass the rate check.
        """
        if sample_rates is None and self.on_rate_mismatch == "error":
            warnings.warn(
                "run_arrays called without sample_rates on a pipeline whose "
                f"rate policy is 'error' (expected {self.sample_rate_hz:g} "
                "Hz) — the rate check is bypassed. Pass sample_rates=, or "
                "construct the pipeline with on_rate_mismatch='ignore' to "
                "acknowledge unchecked rates.",
                stacklevel=2,
            )
        loader = AudioBatchLoader.from_arrays(
            arrays,
            batch_size=self.batch_size,
            target_len=self.target_len,
            sample_rates=sample_rates,
            expected_sample_rate=None if sample_rates is None else int(round(self.sample_rate_hz)),
            on_rate_mismatch=self.on_rate_mismatch,
            dtype=self._loader_dtype,
        )
        if preload:
            self._check_preload_budget(len(arrays), max_preload_bytes)
            return self._run_loader_preloaded(loader)
        return self._run_loader(loader)

    def _check_preload_budget(self, n_items: int, max_preload_bytes: int):
        """Refuse preload jobs whose staged input exceeds the budget."""
        itemsize = 1 if self._u8 else 2 if self._i16 else 4
        est = -(-n_items // self.batch_size) * self.batch_size * self.target_len * itemsize
        if est > max_preload_bytes:
            fmt = lambda b: f"{b / 2**30:.2f} GiB" if b >= 2**30 else f"{b / 2**20:.2f} MiB"
            raise InvalidInputError(
                f"preload=True would stage ~{fmt(est)} of input on the "
                f"device (> max_preload_bytes={fmt(max_preload_bytes)}). "
                "Split the job, use a smaller transport (int16/ulaw), or "
                "raise max_preload_bytes if the device has the memory."
            )

    # ---- transfers ------------------------------------------------------------
    def _upload(self, data: np.ndarray, pinned: bool):
        """Ship one borrowed batch: ``(tensor on the device, copy event)``.

        On the CPU the rows are copied out of the ring slot (a tensor would
        alias it). On CUDA the copy runs on the pipeline's copy stream: from
        the pageable slot it returns once the copy is done; ``pinned``
        copies the slot into pinned memory and returns with the copy to the
        card in flight. Either way the slot has been read when this returns.
        """
        with span("tg.pipeline.upload"):
            host = torch.from_numpy(data)
            if self._copy_stream is None:
                return host.clone(), None
            with torch.cuda.stream(self._copy_stream):
                if pinned:
                    staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                    staged.copy_(host)
                    xb = staged.to(self.device, non_blocking=True)
                else:
                    xb = host.to(self.device)
                done = torch.cuda.Event()
                done.record(self._copy_stream)
            return xb, done

    def _emit(self, xb: torch.Tensor, done, lengths: np.ndarray):
        """Order the step after the batch's copy, run it, wrap the batch."""
        with span("tg.pipeline.step"):
            if done is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(done)
                xb.record_stream(stream)  # allocated on the copy stream
            feats = self._step(xb)
        return self._make_batch(feats, lengths)

    def _run_loader(self, loader) -> Iterator[FeatureBatch]:
        # Serial (default): each batch is copied, then its step enqueued;
        # the loader threads decode meanwhile. Pipelined: batch k's copy is
        # enqueued before batch k-1's step (two ring slots held).
        if not self.pipeline_uploads or self._copy_stream is None:
            for data, lengths, _ in _waited(loader.iter_borrowed()):
                yield self._emit(*self._upload(data, pinned=False), lengths)
            return
        pending = None  # (copied-but-not-dispatched xb, its copy event, lengths)
        try:
            for data, lengths, _ in _waited(loader.iter_borrowed(hold=2)):
                prev, pending = pending, (*self._upload(data, pinned=True), lengths)
                if prev is not None:
                    yield self._emit(*prev)
            if pending is not None:
                last, pending = pending, None
                yield self._emit(*last)
        finally:
            if pending is not None:
                # The consumer left with a copy in flight: let it end before
                # its staging buffer and ring slot are given back.
                pending[1].synchronize()

    def warm_preload(self) -> bool:
        """Pay the one-time builds before a job's data arrives: the native
        library (``g++``) and the kernels that the plan launches (``nvcc``),
        none of them run. Returns True."""
        native_available()
        if self.device.type == "cuda":
            build_kernels(_kernel_sources(self.plan))
        return True

    def _run_loader_preloaded(self, loader) -> Iterator[FeatureBatch]:
        # Phase 1: decode and ship the whole job, no step run. Phase 2: the
        # one-time builds (compile_s), then the steps over the staged tensors.
        t0 = time.perf_counter()
        staged, deferred_error = [], None
        pinned = self.pipeline_uploads and self._copy_stream is not None
        try:
            for data, lengths, _ in _waited(loader.iter_borrowed()):
                staged.append((*self._upload(data, pinned), np.array(lengths)))
        except Exception as e:  # served after the good prefix, as the serial loop would
            deferred_error = e
        t_stage = time.perf_counter()
        if not staged:
            self.last_preload_stats = {"stage_s": round(t_stage - t0, 4), "compile_s": 0.0,
                                       "n_batches": 0}
            if deferred_error is not None:
                raise deferred_error
            return
        self.warm_preload()
        t_compile = time.perf_counter()
        self.last_preload_stats = {
            "stage_s": round(t_stage - t0, 4),
            "compile_s": round(t_compile - t_stage, 4),
            "n_batches": len(staged),
        }
        for xb, done, lengths in staged:
            yield self._emit(xb, done, lengths)
        if deferred_error is not None:
            raise deferred_error

    def throughput_report(self, paths: Sequence, *, preload: bool = False) -> dict:
        """Run once over ``paths``; audio-seconds per second end to end
        (decode, pad, transfer and compute, overlapped), the device
        synchronized after the last batch."""
        total_audio = 0.0
        t0 = time.perf_counter()
        last = None
        for batch in self.run(paths, preload=preload):
            total_audio += float(batch.lengths.sum()) / self.sample_rate_hz
            last = batch
        if last is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        rep = {
            "audio_seconds": round(total_audio, 3),
            "wall_seconds": round(dt, 4),
            "audio_s_per_s": round(total_audio / dt, 1) if dt > 0 else 0.0,
        }
        if preload:
            # The one-time builds run inside a preload job: report the rate
            # without them too.
            stats = getattr(self, "last_preload_stats", None)
            if stats is not None:
                rep["preload_phases"] = stats
                steady = dt - stats["compile_s"]
                if steady > 0:
                    rep["audio_s_per_s_excl_compile"] = round(total_audio / steady, 1)
        return rep
