"""Roofline cost model and profiling helpers for an NVIDIA card.

Counterpart of ``spectrograms_tpu.profiling``. Every plan reports the
operations and memory bytes of one call, and a measured time converts to a
share of the roofline: the least time the card could take, the larger of
the operations over the peak rate of their type and the bytes over the
memory rate. Two gradings, as in the JAX package: ``plan_cost`` counts the
work of the route the plan takes, ``task_cost`` the work of the task
whatever computes it.

The peaks are NVIDIA's data-sheet figures (dense, no sparsity). On these
cards float32 work outside the tensor cores runs at about a fifteenth of
the bf16 tensor-core rate, so ``CostEstimate`` keeps that work apart
(``f32_flops``) where a kernel does it beside tensor-core products.
``trace`` records a ``torch.profiler`` trace of CPU and CUDA activity.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .dtypes import resolve_device
from .errors import FftBackendError, InvalidInputError
from .ops import factored_layout as fl
from .ops import tier_layout as tl
from .ops.fused_factored import mapping_bands
from .pipeline import AmpScale, FreqScale

__all__ = [
    "ChipSpec",
    "CHIPS",
    "detect_chip",
    "CostEstimate",
    "plan_cost",
    "task_cost",
    "roofline",
    "trace",
]


@dataclass(frozen=True)
class ChipSpec:
    """Peak rates of one NVIDIA card, from its data sheet."""

    name: str
    bf16_tflops: float       # tensor cores, bf16 inputs / f32 accumulate, dense
    f32_tflops: float        # float32 outside the tensor cores
    hbm_gbps: float          # device memory, GB/s
    power_limit_w: Optional[float] = None  # the card's power.limit, where read


CHIPS: Dict[str, ChipSpec] = {
    "h100-sxm": ChipSpec("h100-sxm", bf16_tflops=989.0, f32_tflops=67.0, hbm_gbps=3350.0),
    "h100-pcie": ChipSpec("h100-pcie", bf16_tflops=756.0, f32_tflops=51.0, hbm_gbps=2000.0),
}

# torch.cuda.get_device_name markers of each CHIPS entry
_CARD_NAMES = {"h100-sxm": ("H100 80GB HBM3", "H100 SXM"), "h100-pcie": ("H100 PCIe",)}


def _power_limit_w(index: int) -> Optional[float]:
    """The card's ``power.limit`` in W as ``nvidia-smi`` reads it, or None
    where the tool does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout
        return float(out.strip().splitlines()[index])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def detect_chip() -> ChipSpec:
    """The ``CHIPS`` entry of the current card, with its power limit.

    Raises when no card is visible, and on a card the table does not know:
    a roofline against another card's peaks would be wrong. ``roofline``
    and ``light_speed_s`` take ``chip=`` anywhere.
    """
    dev = resolve_device()
    name = torch.cuda.get_device_name(dev)
    for key, markers in _CARD_NAMES.items():
        if any(m in name for m in markers):
            return dataclasses.replace(CHIPS[key], power_limit_w=_power_limit_w(dev.index))
    raise InvalidInputError(
        f"no peak rates for the card {name!r}; known: {sorted(CHIPS)} (pass chip=)"
    )


@dataclass
class CostEstimate:
    """Operations and device-memory bytes of one call.

    ``flops`` is the total; ``f32_flops`` is the part of it that runs as
    float32 outside the tensor cores beside tensor-core products (0 where
    every operation runs at the rate ``light_speed_s``'s ``dtype`` names).
    """

    flops: float
    bytes_hbm: float
    transcendentals: float = 0.0
    f32_flops: float = 0.0

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_hbm, 1.0)

    def light_speed_s(self, chip: Optional[ChipSpec] = None, dtype="bfloat16") -> float:
        """Roofline lower-bound runtime on the given card: ``f32_flops`` at
        the f32 rate plus the other operations at ``dtype``'s rate, or the
        bytes at the memory rate, whichever takes longer."""
        chip = chip or detect_chip()
        s = str(dtype).lower()
        if "bf16x3" in s:
            peak = chip.bf16_tflops / 3.0   # 3-pass hi/lo tier
        elif "bf16x2" in s:
            peak = chip.bf16_tflops / 2.0   # 2-pass middle tier
        elif "bf16" in s or "bfloat16" in s:
            peak = chip.bf16_tflops
        else:
            peak = chip.f32_tflops
        t_compute = ((self.flops - self.f32_flops) / (peak * 1e12)
                     + self.f32_flops / (chip.f32_tflops * 1e12))
        t_memory = self.bytes_hbm / (chip.hbm_gbps * 1e9)
        return max(t_compute, t_memory)

    def __add__(self, other: "CostEstimate") -> "CostEstimate":
        return CostEstimate(
            self.flops + other.flops,
            self.bytes_hbm + other.bytes_hbm,
            self.transcendentals + other.transcendentals,
            self.f32_flops + other.f32_flops,
        )


def _f32_kernel_cost(run, n_fft: int, x_numel: int, y_numel: int, frames: int) -> CostEstimate:
    """``csrc/fused_features.cu``: each input read once (signal, window,
    twiddles, mapping, DCT, the rows' bands), the output written once; per
    frame the window, a real FFT (2.5 N log2 N), |X|^2 (and sqrt), the
    mapping over each row's nonzero band, the amplitude scale and a dense
    DCT, all f32."""
    fb, dct = run.mapping, run.dct
    bands = mapping_bands(fb)
    band_total = int((bands[:, 1] - bands[:, 0]).sum())
    n_out, n_bins = fb.shape
    n_coef = 0 if dct is None else dct.shape[1]
    pre = run.pre_amp != "none"
    bytes_moved = 4 * (x_numel + y_numel + 2 * n_fft + fb.size
                       + (0 if dct is None else dct.size) + 2 * n_out)
    flops = frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + (4 if pre else 3) * n_bins
                      + 2 * band_total + n_out + 2 * n_out * n_coef)
    return CostEstimate(flops, bytes_moved)


def _tier_kernel_cost(run, n_fft: int, x_numel: int, y_numel: int, frames: int) -> CostEstimate:
    """``csrc/fused_tier_features.cu``: the signal, output and constants it
    reads, once; tensor-core MACs of the tier's passes (the outer DFT over
    the 8-column n-tiles a mapping row reads, the folded mapping's nonzeros,
    the DCT dense) in ``flops``, and the f32 work outside them (window,
    inner DFT as real FFTs over the chunk axis, twiddles, Gauss sums, |X|^2
    of the entries computed, the amplitude scale) in ``f32_flops`` too."""
    fb, dct, gauss = run.mapping, run.dct, run.gauss
    x2 = run.precision == "bf16x2"
    pre = run.pre_amp != "none"
    r = n_fft // 128
    cc = r // 2 - 1
    n_out = fb.shape[0]
    n_coef = 0 if dct is None else dct.shape[1]
    map_nnz = int(np.count_nonzero(fl.fold_mapping(fb, n_fft)))
    ntiles = tl.class_ntiles(fb, n_fft)
    real_nt = len(ntiles[0]) + len(ntiles[r // 2])
    cplx_nt = sum(len(ntiles[c]) for c in range(1, r // 2))
    cplx_cols = len(set().union(*map(set, ntiles[1:r // 2]))) if cc else 0
    outer, tail = (2, 3) if x2 else (1, 1)
    words = 2 if x2 else 1
    per_nt = 3 * 128 * 8 if gauss else 256 * 16     # complex MACs a frame an n-tile
    const_bytes = (12 * n_fft + 2 * words * (128 * 16 * real_nt + per_nt * cplx_cols
                                             + map_nnz + n_out * n_coef))
    macs = (outer * (128 * 16 * real_nt + per_nt * cplx_nt)
            + tail * (map_nnz + n_out * n_coef))
    computed = 8 * (real_nt + cplx_nt)
    simt = (n_fft + 128 * 2.5 * r * math.log2(r) + 6 * 128 * cc
            + (3 * 128 * cc if gauss else 0) + (4 if pre else 3) * computed + n_out)
    return CostEstimate(frames * (2 * macs + simt), 4 * (x_numel + y_numel) + const_bytes,
                        f32_flops=frames * simt)


def plan_cost(plan, n_samples: int, batch: int = 1) -> CostEstimate:
    """Analytic cost of ``plan.compute_batch`` on ``batch`` signals of
    ``n_samples``.

    The ``fft``, ``matmul``, ``factored`` and CQT routes count as the JAX
    package counts them (frames materialize once, the elementwise tail
    fuses into its producer). A ``pallas*`` plan counts the CUDA kernel its
    route launches (``_f32_kernel_cost``/``_tier_kernel_cost``): its
    constants once a call, not once a signal. A multirate plan counts at
    the full rate, as in the JAX package.
    """
    n_bins_out, n_frames = plan.output_shape(n_samples)
    n_fft = plan._n_fft
    itemsize = plan._dtype.itemsize
    n_spec_bins = n_fft // 2 + 1

    if plan.method.startswith("pallas"):
        run = plan._kernel_run
        cost = (_f32_kernel_cost if run.source == "fused_features" else _tier_kernel_cost)(
            run, n_fft, batch * n_samples, batch * n_bins_out * n_frames, batch * n_frames)
        if plan.amp_scale != AmpScale.POWER:
            cost.transcendentals = batch * n_frames * n_bins_out   # sqrt or log10
        return cost

    flops = 0.0
    bytes_hbm = 0.0
    trans = 0.0

    frames_elems = n_frames * n_fft
    # framing: read signal, write frame matrix
    bytes_hbm += (n_samples + frames_elems) * itemsize

    if plan.freq_scale == FreqScale.CQT:
        k_bins = plan._cqt_n_out
        flops += 2 * 2 * frames_elems * k_bins            # fused [re|im] matmul
        flops += 3 * n_frames * k_bins                    # |·|²
        bytes_hbm += frames_elems * itemsize              # frames read once
        bytes_hbm += 2 * n_fft * k_bins * itemsize        # kernels
        bytes_hbm += n_frames * k_bins * itemsize         # output
    elif plan.method == "factored":
        # Two-stage Cooley-Tukey (ops/fft_factored.py): stage-1 real matmuls
        # contract 128, + twiddle + radix-2 tail + |·|².
        r = n_fft // 128
        flops += 4 * 128 * frames_elems                   # 2 × (·,128)@(128,128)
        flops += 6 * frames_elems                         # complex twiddle
        flops += 5 * np.log2(r) * frames_elems            # radix-2 butterflies
        flops += 3 * n_frames * n_spec_bins               # re²+im²
        bytes_hbm += 4 * frames_elems * itemsize          # frames ×2 + re/im
        bytes_hbm += n_frames * n_spec_bins * itemsize
    elif plan.method == "matmul":
        flops += 2 * 2 * frames_elems * n_spec_bins       # cos+sin matmuls
        flops += 3 * n_frames * n_spec_bins               # re²+im²
        bytes_hbm += 2 * frames_elems * itemsize
        bytes_hbm += 2 * n_fft * n_spec_bins * itemsize
        bytes_hbm += n_frames * n_spec_bins * itemsize
    else:  # FFT
        flops += 5.0 * frames_elems * np.log2(n_fft)
        bytes_hbm += 2 * frames_elems * itemsize + n_frames * n_spec_bins * itemsize

    if plan._mapping_t is not None:
        n_in = plan._mapping_t.shape[0]
        flops += 2 * n_frames * n_in * n_bins_out
        bytes_hbm += (n_frames * n_in + n_in * n_bins_out + n_frames * n_bins_out) * itemsize

    out_elems = n_frames * n_bins_out
    if plan.amp_scale == AmpScale.MAGNITUDE:
        flops += out_elems
        trans += out_elems            # sqrt
    elif plan.amp_scale == AmpScale.DECIBELS:
        flops += 2 * out_elems
        trans += out_elems            # log10
    bytes_hbm += out_elems * itemsize  # final output write

    return CostEstimate(flops * batch, bytes_hbm * batch, trans * batch)


def task_cost(plan, n_samples: int, batch: int = 1) -> CostEstimate:
    """Algorithm-independent lower bound for the *task* the plan performs.

    Charges the spectral transform at true FFT cost (5·N·log₂N per frame,
    the standard radix-2 count) plus the filterbank product (dense) and the
    elementwise tail, with memory traffic of just signal in and features
    out: the JAX package's count, the same for every route of a plan.
    """
    n_bins_out, n_frames = plan.output_shape(n_samples)
    n_fft = plan._n_fft
    itemsize = plan._dtype.itemsize
    n_spec_bins = n_fft // 2 + 1

    flops = 5.0 * n_frames * n_fft * np.log2(n_fft)       # rFFT task cost
    flops += 3 * n_frames * n_spec_bins                   # |·|²
    if plan.freq_scale == FreqScale.CQT:
        k_bins = plan._cqt_n_out
        flops = 2 * 2 * n_frames * n_fft * k_bins         # CQT is a matmul task
    elif plan._mapping_t is not None:
        n_in = plan._mapping_t.shape[0]
        flops += 2 * n_frames * n_in * n_bins_out
    out_elems = n_frames * n_bins_out
    if plan.amp_scale != AmpScale.POWER:
        flops += 2 * out_elems
    bytes_hbm = (n_samples + out_elems) * itemsize
    return CostEstimate(flops * batch, bytes_hbm * batch)


def _compute_dtype(plan) -> str:
    """The type a plan's products run in: bf16 on the tier kernel's tensor
    cores (its passes are counted in the operations), else the plan's."""
    if plan.method.startswith("pallas") and plan._kernel_run.source == "fused_tier_features":
        return "bfloat16"
    return str(plan._dtype).removeprefix("torch.")


def roofline(
    plan,
    n_samples: int,
    measured_s: float,
    batch: int = 1,
    chip: Optional[ChipSpec] = None,
    dtype=None,
) -> Dict[str, float]:
    """Measured runtime → roofline report dict.

    Reports two gradings: ``pct_of_roofline`` against the cost of the
    *chosen route* (how well its kernels run) and ``pct_of_task_roofline``
    against the FFT-FLOPs *task* lower bound (how close the whole design is
    to speed-of-light for the problem). ``dtype`` names the rate of the
    operations; None takes the plan's (bf16 on the tier kernel).
    """
    chip = chip or detect_chip()
    dtype = _compute_dtype(plan) if dtype is None else dtype
    cost = plan_cost(plan, n_samples, batch)
    task = task_cost(plan, n_samples, batch)
    light = cost.light_speed_s(chip, dtype)
    task_light = task.light_speed_s(chip, dtype)
    return {
        "flops": cost.flops,
        "task_flops": task.flops,
        "bytes_hbm": cost.bytes_hbm,
        "arithmetic_intensity": cost.arithmetic_intensity,
        "light_speed_s": light,
        "task_light_speed_s": task_light,
        "measured_s": measured_s,
        "pct_of_roofline": 100.0 * light / measured_s if measured_s > 0 else 0.0,
        "pct_of_task_roofline": 100.0 * task_light / measured_s if measured_s > 0 else 0.0,
        "achieved_tflops": cost.flops / measured_s / 1e12 if measured_s > 0 else 0.0,
        "achieved_gbps": cost.bytes_hbm / measured_s / 1e9 if measured_s > 0 else 0.0,
    }


class trace:
    """``with profiling.trace(logdir):`` → a ``torch.profiler`` trace of CPU
    and CUDA activity, written into ``logdir`` as a Chrome trace on exit
    (``.path``; ``.profile`` is the profiler, for ``key_averages()``).

    Records CUDA activity unless ``device="cpu"``; raises, as plans do,
    when that device is CUDA and no card is visible. On exit a CUDA trace
    is checked: a kernel launch in the window whose kernel the trace does
    not hold raises :class:`FftBackendError` (the file is written and
    ``.path`` set), so that a breakdown never leaves out work silently.
    With torch 2.11 and CUPTI 12.8 on an H100, Kineto dropped kernel
    records as outside the trace's window in every trace taken 75 s after
    the process's last one, and in the trace right after it; it kept them
    at gaps of 20 s or less. The first trace of a fresh process lost them
    once in twelve.
    """

    def __init__(self, logdir: str, device=None):
        self.logdir = logdir
        self.device = resolve_device(device)
        self.path: Optional[str] = None
        self.profile = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=activities)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.profile.__exit__(*exc)
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(self.logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        self.profile.export_chrome_trace(self.path)
        if self.device.type == "cuda" and exc[0] is None:
            with open(self.path) as f:
                launches, lost = lost_kernels(json.load(f)["traceEvents"])
            if lost:
                raise FftBackendError(
                    f"torch.profiler recorded {len(launches)} kernel launches in this window "
                    f"but not the kernels of {len(lost)} of them ({', '.join(sorted(set(lost)))}"
                    f"): the trace at {self.path} is incomplete")
        return False


def lost_kernels(events) -> tuple:
    """(launches, lost) of a Chrome trace's events: the names of its kernel
    launches (CUDA runtime or driver API), and of those whose correlation id no
    kernel record carries. A launch made while a stream captures a CUDA graph
    runs no kernel and is left out: one between a ``*StreamBeginCapture*``
    call and its ``*StreamEndCapture*`` on the same host thread (Kineto's API
    records name the thread, not the stream)."""
    api = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")),
                 key=lambda e: e.get("ts", 0.0))
    capturing: dict = {}
    launches = []
    for e in api:
        name, tid = e.get("name", ""), e.get("tid")
        if "StreamBeginCapture" in name:
            capturing[tid] = capturing.get(tid, 0) + 1
        elif "StreamEndCapture" in name:
            capturing[tid] = max(0, capturing.get(tid, 0) - 1)
        elif ("LaunchKernel" in name or "LaunchCooperativeKernel" in name) \
                and not capturing.get(tid):
            launches.append(e)
    ran = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    return ([e["name"] for e in launches],
            [e["name"] for e in launches if e.get("args", {}).get("correlation") not in ran])
