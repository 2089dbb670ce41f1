#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build, check and time its kernels.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Two kernels: ``csrc/fused_features.cu`` (f32, the ``precision=HIGH`` path)
and ``csrc/fused_tier_features.cu`` (bf16 tensor cores, the
``precision=DEFAULT`` and ``method="pallas:x2"`` tiers). Phases, each
printing lines (any failure exits non-zero, nothing is caught); the f32
kernel's lines carry the values that the first recorded runs of its
first (radix-2) and current (radix-8) designs printed ("recorded: ...")
beside this run's:

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. build of both sources, one ``nvcc`` each, started together (seconds,
   ptxas registers/spills);
3. each kernel against its plain PyTorch version on the card, same inputs
   from a numpy seed: the f32 kernel at eight geometries, the tier kernel at
   ten (dense ERB rows, hop 160 with ``centre=False`` on an odd length,
   chroma at x2 and a hop whose span is not staged among them), on each output's own scale, and also against
   the f32 exact result at the tier's error limit;
4. the flagship path: ``MfccPlan.compute_batch`` on a (32, 160000) f32
   batch with ``method="auto"``, launch counter and shape checked, compared
   with the same plan under ``method="matmul"``; then the mel-dB sibling;
   then the same plan at ``precision=DEFAULT`` (tier kernel only) and at
   ``method="pallas:x2"``, the tier ordering on mel power, and
   ``ChromaPlan.compute_batch`` on (64, 220500) at 44.1 kHz at ``HIGH`` (f32
   kernel) and ``DEFAULT`` (tier kernel) against ``method="matmul"``;
5. the gradient through each kernel route against autograd through the
   plain path;
6. times (CUDA events, median and p90 of 100 after warm-up, L2 flushed
   and the device held in a ~1 ms spin before each run, so that the host's
   enqueue stays out of the reading): at the flagship shape each kernel,
   its plain version, a PyTorch-call yardstick, the whole
   ``compute_batch``, the ``method="matmul"`` route; host times of one
   call; the chroma batch through each kernel (the tier kernel at 1 pass
   and x2), each plain version (the tier's at 1 pass and x2) and the
   yardsticks (the f32 ``torch.stft`` chain, bf16 chains at 1 pass and x2);
   and each kernel's bound (the tier kernel's over the outer n-tiles that a
   mapping row reads, with the dense count of earlier runs beside it);
7. the serving path (``serving_phase``): 256 PCM16 WAVs of 10 s at 16 kHz
   served by ``FeaturePipeline`` through the native loader with each
   transport (float32, int16, μ-law, int16 with preload, int16 with
   pipelined uploads), each batch held against ``compute_batch`` of the
   rows ``read_wav`` gives and the f32 kernel launched once a batch; the
   flagship MFCC at ``precision=DEFAULT`` through the int16 transport;
   a multirate ``FeatureSet`` (config 9's MFCC, config 4's chroma) at
   44.1 kHz against its members alone and their full-rate plans; both
   kernels against their plain versions at the decimated inner geometries
   512/128 and 1024/256; ``StreamingSpectrogram`` against ``compute``;
   audio-s/s end to end, of the loader alone and of one step's device time;
8. the spectrogram-family surface (``surface_phase``): the packed 1-pass
   tier form (``pallas:dif`` at ``DEFAULT``) timed at the flagship beside
   its plain version and its bound; config 2 (``SpectrogramPlanner().mel_db_plan`` and
   ``MelDbPlan`` on the (32, 160000) batch, mel-128 dB) at ``HIGH`` (the f32
   kernel once) and ``DEFAULT`` (the tier kernel once) against
   ``method="matmul"``; the ``compute_mel_db_spectrogram`` one-shot twice
   (a plan-cache hit, one launch a call); config 1 (``LinearPowerPlan`` at
   float64) against a numpy f64 STFT; ``StftPlan`` on the batch against
   ``rfft`` of f64 frames, ``istft`` back and ``compute_frame``; Griffin-Lim
   (32 iterations, both routes) against the port's CPU run of the same seed;
9. config 4 of ``benchmarks/suite.py`` (``config4_phase``): 64 × 5 s of
   noise at 44.1 kHz through ``FeatureSet([CqtPowerPlan (CQT-84 from C1,
   the octave stack the policy elects), multirate chroma, MDCT round
   trip])``; the chroma member launches the f32 kernel once a step and
   equals the standalone plan, the kernel its plain version on the
   decimated batch; the set's CQT member against the standalone plan at
   ``tests/test_featureset.py``'s bounds, the f32 CQT (octave stack and
   dense ``truncate=True``) against the f64 plans, the MDCT round trip and
   its dense and folded forms, the gammatone bank (``scan`` and
   ``parallel``) against the port's CPU run; times of the step, the
   members alone and on their own (``separate``), the dense CQT step, the
   cascade and the gammatone lowerings, the step's peak memory, and a
   ``torch.profiler`` breakdown of one step;
10. the 1-D/2-D FFT and image family and the f64-grade tiers
   (``fft_image_phase``): config 5 of ``benchmarks/suite.py`` (a 64-frame
   mel-dB block at 512/128 and a 512² Gaussian blur then edge detection)
   against numpy in f64, its step and parts timed; the cuFFT and dense-product
   routes of the image filters at 256², 512² and 1024², timed (the numbers
   behind ``ops/spectral2d.py``'s ``use_matmul_path``); ``fft_convolve``,
   ``fft_deconvolve``, ``OverlapSaveConvolver.process_signal`` on 10 s
   (against ``np.convolve`` and a loop of ``process_block``),
   ``minimum_phase`` and ``fft2d``/``ifft2d`` on 1024² at f32 and f64;
   config 8 (the ``f32x2`` linear-power plan at 256/128, the
   ``stft_x2``/``istft_x2`` round trip, ``fft2d_x2`` on 128²) against numpy
   in f64, the f64 route timed beside the op-for-op double-double route; an
   ``f32x2`` mel-128 plan on 10 s; ``method="factored"`` on the flagship batch
   against ``matmul``, timed beside ``auto`` (the f32 kernel) and ``fft``;
11. autotune, serving options, parallelism, binaural, sources and serde
   (``tuning_parallel_phase``): ``autotune_plan`` with
   ``kernel_variants=True`` on the flagship MFCC batch at ``HIGH`` and
   ``DEFAULT`` and on the chroma batch at ``HIGH`` (each candidate's slope
   reading beside its CUDA-event time, the winner against ``matmul`` and
   beside what ``auto`` resolves to), a second call answered by the
   wisdom with no launch, ``save_wisdom``/``load_wisdom``; config 7 (phase
   7's 256 WAVs) served with ``autotune=True``, over a one-entry mesh (bit-equal to
   ``mesh=None``) and a 4-entry mesh on the one card; ``shard_batch`` and
   ``data_parallel_pipeline`` on the flagship batch over one and four
   entries, and a 30-row batch with its mask; ``sequence_parallel_spectrogram``
   on 10 min of noise over one and four entries against ``compute``; the
   four binaural ``_batch`` functions on 32 × 10 s stereo at f32 and f64
   against the port's CPU f64 run, the one-shots and their histograms;
   the sources on 10 s against their CPU f64 runs (the gammatone bank
   timed once); NPZ ``save``/``load`` of CUDA results. Each f32-kernel
   launch on these paths is counted;
12. the ``kernels`` JSON line, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero, printing no result, when CUDA is unavailable. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12     # bf16 tensor cores, dense, H100 SXM data sheet
SR = 16000.0
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's 1980 MHz SM clock
SEED = 20261016
# The tier kernel's error limits, relative to max|reference|: the JAX
# package's tier contract for mel power (tests/test_pallas.py,
# TestBf16x2Tier: the 1-pass serving tier documented at 2e-3..5e-3, the
# 2-pass tier below 2e-3). dB outputs are held to it in the power domain
# they come from (10^(dB/10)). MFCC outputs are the DCT of dB values, where
# bands far below the frame's peak carry the tier's error relative to the
# whole frame: they are held to 4e-2 at bf16 and 2e-2 at bf16x2, about
# twice what the tiers' plain versions show against exact f32 on this
# script's flagship batch (1.9e-2 and 0.9e-2 on the H100).
TIER_LIMITS = {"bf16": 5e-3, "bf16x2": 2e-3}
MFCC_TIER_LIMITS = {"bf16": 4e-2, "bf16x2": 2e-2}
# The tier kernel against its plain version, each output on its own scale.
# Both round the same operands to bf16 at the same points; they part only
# where an f32 sum taken in another order (the outer DFT's mma against the
# plain version's GEMM) flips a bf16 rounding of the power. dB per element
# in dB; power and magnitude per element, |d| <= rtol*|ref| +
# atol*max|ref|; MFCC per coefficient, relative to that coefficient's
# max|ref| over the batch (so a wrong band shows in the small coefficients,
# not only against C0). The limits were set from the first tier kernel's
# readings on an H100 80GB HBM3 at 700 W, whose inner DFT also summed in
# its own order: 0.303 and 0.064 dB (h, i: one flip moves a band that sits
# far below its frame's peak by a share of the peak's rounding), an rtol of
# 1.3e-4 and 4.5e-4 (j, k), 3.5e-3 and 1.8e-3 per coefficient (f, g). The
# kernel that runs the plain version's inner DFT reads 0.028, 0.022, 0.013
# and 0.026 dB (h, i, o, p), rtol 0 (j, k, q) and 7.0e-4 and 3.6e-6 per
# coefficient (f, g). One mapping row 10 % off fails the power check, and
# one mel band 2 dB off the MFCC check.
TWIN_DB = 0.5
TWIN_RTOL, TWIN_ATOL = 2e-3, 1e-5
TWIN_MFCC = 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def signal(rng, batch: int, n: int, sr: float) -> np.ndarray:
    """Noise plus a few tones per row: broadband and peaked bins both."""
    t = np.arange(n, dtype=np.float64) / sr
    x = 0.05 * rng.standard_normal((batch, n))
    for _ in range(3):
        f = rng.uniform(80.0, 0.45 * sr, size=(batch, 1))
        x += rng.uniform(0.1, 0.5, size=(batch, 1)) * np.sin(2 * np.pi * f * t)
    return x.astype(np.float32)


def time_ms(fn, reps: int = 100, warmup: int = 5):
    """(median, p90) device time of ``fn`` in ms over ``reps`` runs (ten
    lie beyond the p90). The 50 MB L2 is flushed before each run, since a
    caller hands the kernel a new batch each time; a device spin after the
    flush keeps the host's enqueue time out of the reading."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        # ~1 ms of device spin: the host enqueues fn() before the start
        # event fires, so its enqueue time stays out of the reading
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(np.percentile(times, 90))


def host_us(fn, reps: int = 100) -> float:
    """Median host time of one call of ``fn`` in µs, from the call to its
    return with the device idle before it: what a caller pays to enqueue
    the work. Below the device time, a loop of calls keeps the card busy."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def tier_err(out, ref, kind: str, precision: str):
    """(max|out - ref|, limit, ok) at the tier's limit; dB compared as power."""
    if kind == "mfcc":
        limit = MFCC_TIER_LIMITS[precision] * float(ref.abs().max())
    else:
        if kind == "db":
            out, ref = 10.0 ** (out / 10.0), 10.0 ** (ref / 10.0)
        limit = TIER_LIMITS[precision] * float(ref.abs().max())
    err = float((out - ref).abs().max())
    return err, limit, err <= limit


def twin_err(out, ref, kind: str):
    """(reading, limit, ok, what) of the tier kernel against its plain
    version, on the output's own scale (``TWIN_*``)."""
    d = (out - ref).abs()
    if kind == "db":
        reading = float(d.max())
        # where the worst element sits below its frame's loudest row
        at = np.unravel_index(int(d.argmax()), tuple(d.shape))
        below = float(ref[at[0], :, at[2]].max() - ref[at])
        return (reading, TWIN_DB, reading <= TWIN_DB,
                f"max|err| dB (at {below:.1f} dB below its frame's peak)")
    if kind == "mfcc":
        per_coef = d.amax(dim=(0, 2)) / ref.abs().amax(dim=(0, 2))
        reading = float(per_coef.max())
        return reading, TWIN_MFCC, reading <= TWIN_MFCC, "max|err|/max|ref| per coefficient"
    # the least rtol that passes at atol TWIN_ATOL*max|ref|
    excess = (d - TWIN_ATOL * float(ref.abs().max())).clamp_min(0.0)
    reading = float((excess / ref.abs()).nan_to_num(nan=0.0, posinf=math.inf).max())
    return (reading, TWIN_RTOL, reading <= TWIN_RTOL,
            f"rtol needed at atol {TWIN_ATOL:g}*max|ref|")


def f32_bound(x_numel, y_numel, frames, n_fft, mapping, dct, pre):
    """(bound ms, bytes ms, ops ms) of the f32 kernel: each input read once,
    the output written once; per frame the window, a real FFT (2.5 N log2 N),
    |X|^2 (and sqrt), the mapping over each row's nonzero band, the
    amplitude scale and a dense DCT."""
    from spectrograms_tpu_torch.ops import fused_factored as ff

    bands = ff.mapping_bands(mapping)
    band_total = int((bands[:, 1] - bands[:, 0]).sum())
    n_out, n_bins = mapping.shape
    n_coef = 0 if dct is None else dct.shape[1]
    bytes_moved = 4 * (x_numel + y_numel + 2 * n_fft + mapping.size
                       + (0 if dct is None else dct.size) + 2 * n_out)
    flops = frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + (4 if pre else 3) * n_bins
                      + 2 * band_total + n_out + 2 * n_out * n_coef)
    b_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    o_ms = flops / H100_F32_FLOPS * 1e3
    return max(b_ms, o_ms), b_ms, o_ms


def serving_phase(tg, ff, dev, card, tier_bound) -> dict:
    """Phase 7: the serving path at the sizes users run (see the module
    docstring). Each check prints its reading before a failure ends the run.
    Returns the end-to-end audio-s/s of each transport."""
    from spectrograms_tpu_torch.mfcc import _dct_lifter_matrix
    from spectrograms_tpu_torch.ops.filterbanks import chroma_filterbank, mel_filterbank
    from spectrograms_tpu_torch.runtime import (AudioBatchLoader, StreamingSpectrogram,
                                                read_wav, write_wav)

    n_files, n, bs = 256, 160000, 32
    srng = np.random.default_rng(SEED + 5)
    counters = (ff.fused_factored_features, ff.fused_tier_features)

    def zero():
        for c in counters:
            c.launches = 0

    def check(label, ok, reading):
        print(f"[7 {label}] {reading} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"serving phase: {label}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = []
        for i in range(n_files):
            path = Path(tmp) / f"clip_{i:04d}.wav"
            write_wav(path, (0.1 * srng.standard_normal(n)).astype(np.float32), int(SR), bits=16)
            paths.append(str(path))
        rows = np.stack([read_wav(path, mono=True)[0] for path in paths])
        rows_dev = torch.from_numpy(rows).to(dev)
        probe = AudioBatchLoader(paths, bs, n, expected_sample_rate=int(SR))
        check("setup", probe._lib is not None and rows.shape == (n_files, n),
              f"{n_files} PCM16 WAVs of 10 s at 16 kHz written and read back in "
              f"{time.perf_counter() - t0:.2f} s; the loader's native path in use: "
              f"{probe._lib is not None}")

        # ---- 7a. config 7: mel-dB serving from files ----------------------
        mel_p = tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY)
        plan = tg.SpectrogramPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), SR),
                                  tg.FreqScale.MEL, tg.AmpScale.DECIBELS, scale_params=mel_p,
                                  log_params=tg.LogParams(-80.0), dtype="float32")
        with torch.no_grad():
            refs = [plan.compute_batch(rows_dev[b:b + bs]) for b in range(0, n_files, bs)]
        audio_s = n_files * n / SR
        configs = [("float32", dict(transport="float32"), False),
                   ("int16", dict(transport="int16"), False),
                   ("ulaw", dict(transport="ulaw"), False),
                   ("int16+preload", dict(transport="int16"), True),
                   ("int16+pipeline_uploads", dict(transport="int16", pipeline_uploads=True),
                    False)]
        served, pipes, rates = {}, {}, {}
        for label, kw, preload in configs:
            pipe = tg.FeaturePipeline(plan, batch_size=bs, target_seconds=10.0, **kw)
            pipes[label] = pipe
            pipe.warm_preload()
            zero()
            batches = list(pipe.run(paths, preload=preload))  # the warm pass, checked
            torch.cuda.synchronize()
            launches = [c.launches for c in counters]
            feats = [b.features for b in batches]
            served[label] = feats
            mask_ok = all(np.array_equal(b.frame_mask, pipe._mask_from(
                b.lengths, 1024, 256, True, pipe._n_frames)) and bool((b.lengths == n).all())
                for b in batches)
            if label == "ulaw":
                live = [r > -60.0 for r in refs]
                err = max(float((f - r).abs()[m].max()) for f, r, m in zip(feats, refs, live))
                ok, what = err < 3.0, f"max|err| on bins above -60 dB {err:.3e} dB (limit 3.0)"
            else:
                err = max(float((f - r).abs().max()) for f, r in zip(feats, refs))
                ok, what = err == 0.0, f"max|err| {err:.3e} (limit 0: exact)"
            reps = []
            for _ in range(3):
                reps.append(pipe.throughput_report(paths, preload=preload))
            timed_launches = [c.launches for c in counters]
            rates[label] = float(np.median([r["audio_s_per_s"] for r in reps]))
            extra = ""
            if preload:
                extra = f", preload phases {reps[-1]['preload_phases']}"
            check(f"serve {label}", ok and mask_ok and len(batches) == 8 and launches == [8, 0]
                  and timed_launches == [32, 0],
                  f"{card} | {len(batches)} batches of {tuple(feats[0].shape)} vs compute_batch "
                  f"of read_wav rows: {what}; masks as _mask_from: {mask_ok}; launches f32/tier "
                  f"{launches[0]}/{launches[1]} (want 8/0), after 3 more passes "
                  f"{timed_launches[0]}/{timed_launches[1]} (want 32/0) | throughput_report "
                  f"median of 3 {rates[label]:.1f} audio-s/s (passes: "
                  f"{', '.join(str(r['audio_s_per_s']) for r in reps)}){extra}")
        i16_exact = all(torch.equal(a, b) for a, b in zip(served["float32"], served["int16"]))
        check("int16 vs float32", i16_exact, f"int16 transport bit-equal to float32: {i16_exact}")
        del served

        loader_rates = {}
        for dtype in ("float32", "int16", "ulaw"):
            walls = []
            for _ in range(4):  # one warm pass, then three timed
                t = time.perf_counter()
                for data, lengths, _ in AudioBatchLoader(
                        paths, bs, n, expected_sample_rate=int(SR), dtype=dtype).iter_borrowed():
                    pass
                walls.append(time.perf_counter() - t)
            loader_rates[dtype] = audio_s / float(np.median(walls[1:]))
        steps = {}
        for label in ("float32", "int16", "ulaw"):
            pipe = pipes[label]
            loader = AudioBatchLoader(paths[:bs], bs, n, dtype=pipe._loader_dtype)
            (data, _, _), = list(loader.iter_with_rates())
            xb = torch.from_numpy(data).to(dev)
            steps[label] = time_ms(lambda: pipe._step(xb))
        print(f"[7 serve rates] {card} | end to end (median of 3): "
              + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
              + " audio-s/s | the loader alone (iter_borrowed, no copy, no compute; median of "
              "3 after one warm pass): "
              + ", ".join(f"{k} {v:.1f}" for k, v in loader_rates.items())
              + " audio-s/s | one step on the card (dequant + kernel, (32, 160000), median/p90 "
              "of 100): " + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f} ms" for k, v in steps.items())
              + f" = {bs * n / SR / (steps['int16'][0] / 1e3):.0f} audio-s/s at int16")
        del refs

        # ---- 7b. the flagship MFCC at DEFAULT through the int16 transport --
        mkw = dict(mel_params=mel_p, mfcc_params=tg.MfccParams(40, include_c0=True, lifter=22),
                   log_params=tg.LogParams(-80.0), dtype="float32")
        tier_plan = tg.MfccPlan(tg.StftParams(1024, 256), SR, precision=tg.Precision.DEFAULT,
                                **mkw)
        exact_plan = tg.MfccPlan(tg.StftParams(1024, 256), SR, method="matmul",
                                 precision=tg.Precision.HIGHEST, **mkw)
        pipe = tg.FeaturePipeline(tier_plan, batch_size=bs, target_seconds=10.0,
                                  transport="int16")
        pipe.warm_preload()
        zero()
        batches = list(pipe.run(paths))
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        worst, limit_ok = 0.0, True
        with torch.no_grad():
            for i, b in enumerate(batches):
                err, lim, ok = tier_err(b.features, exact_plan.compute_batch(
                    rows_dev[i * bs:(i + 1) * bs]), "mfcc", "bf16")
                worst, limit_ok = max(worst, err / lim), limit_ok and ok
        rate = float(np.median([pipe.throughput_report(paths)["audio_s_per_s"]
                                for _ in range(3)]))
        check("flagship DEFAULT int16", limit_ok and launches == [0, 8] and len(batches) == 8,
              f"{card} | MfccPlan(precision=DEFAULT) served int16, {len(batches)} batches of "
              f"{tuple(batches[0].features.shape)}; vs HIGHEST matmul worst max|err| "
              f"{worst:.3f} of the tier limit ({MFCC_TIER_LIMITS['bf16']:g}*max|ref|); launches "
              f"f32/tier {launches[0]}/{launches[1]} (want 0/8) | {rate:.1f} audio-s/s "
              f"(median of 3)")
        del batches, rows_dev

        # ---- 7e. streaming over 10 s of the config-7 plan ------------------
        strm = StreamingSpectrogram(plan, block_frames=64)
        parts = [strm.process(rows[0, s:s + 1600]) for s in range(0, n, 1600)] + [strm.finish()]
        streamed = torch.from_numpy(np.concatenate(parts, axis=1)).to(dev)
        with torch.no_grad():
            offline = plan.compute(torch.from_numpy(rows[0]).to(dev)).data
        excess = float(((streamed - offline).abs() - 1e-4 - 1e-4 * offline.abs()).max())
        check("streaming", tuple(streamed.shape) == tuple(offline.shape) and excess <= 0.0,
              f"StreamingSpectrogram(64-frame blocks, 1600-sample chunks) {tuple(streamed.shape)}"
              f" vs plan.compute: max|err| {float((streamed - offline).abs().max()):.3e} dB "
              f"(rtol 1e-4, atol 1e-4)")

    # ---- 7c. a multirate FeatureSet at 44.1 kHz --------------------------------
    # tests/test_multirate.py's signal, whose bounds hold it (17 harmonics of
    # 220 Hz), at a phase of its own a row
    sr44, n44 = 44100.0, 441000
    t44 = np.arange(n44) / sr44
    phase = srng.uniform(0.0, 2 * np.pi, size=(bs, 1))
    arrays = sum(np.sin(2 * np.pi * 220.0 * k * t44 + k + phase) / k
                 for k in range(1, 18)).astype(np.float32)
    mel80 = tg.MelParams(80, 0.0, 4000.0, tg.MelNorm.SLANEY)
    mf = tg.MfccPlan(tg.StftParams(2048, 512), sr44, mel_params=mel80.with_multirate(),
                     mfcc_params=tg.MfccParams(13), dtype="float32")
    ch = tg.ChromaPlan(tg.StftParams(4096, 1024), sr44,
                       tg.ChromaParams.music_standard().with_multirate(), dtype="float32")
    mf_full = tg.MfccPlan(tg.StftParams(2048, 512), sr44, mel_params=mel80,
                          mfcc_params=tg.MfccParams(13), dtype="float32")
    ch_full = tg.ChromaPlan(tg.StftParams(4096, 1024), sr44, dtype="float32")
    fs = tg.FeatureSet([mf, ch])
    pipe = tg.FeaturePipeline(fs, batch_size=bs, target_seconds=10.0)
    pipe.warm_preload()
    zero()
    set_batches = list(pipe.run_arrays(list(arrays), sample_rates=int(sr44)))
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    xb = torch.from_numpy(arrays).to(dev)
    with torch.no_grad():
        got_mf, got_ch = set_batches[0].features
        alone_mf, alone_ch = mf.compute_batch(xb), ch.compute_batch(xb)
        full_mf, full_ch = mf_full.compute_batch(xb), ch_full.compute_batch(xb)
    bit_mf, bit_ch = torch.equal(got_mf, alone_mf), torch.equal(got_ch, alone_ch)
    e_mf = float((got_mf - full_mf).abs().max()) / float(full_mf.abs().max())
    e_ch = float((got_ch - full_ch).abs().max()) / float(full_ch.abs().max())
    depths = (mf._mel_plan._multirate_inner[0], ch._decimation)
    with torch.no_grad():
        t_set = time_ms(lambda: fs._step_impl(xb))
        t_mf, t_mf_full = time_ms(lambda: mf.compute_batch(xb)), time_ms(lambda: mf_full.compute_batch(xb))
        t_ch, t_ch_full = time_ms(lambda: ch.compute_batch(xb)), time_ms(lambda: ch_full.compute_batch(xb))
        t_dec = time_ms(lambda: mf._mel_plan._mr_pre(xb))  # the MFCC member's front end alone
    check("multirate FeatureSet", len(set_batches) == 1 and launches == [2, 0] and bit_mf
          and bit_ch and e_mf <= 1e-3 and e_ch <= 2e-4 and depths == (2, 2),
          f"{card} | MFCC-13 mel-80 0-4 kHz 2048/512 + chroma 4096/1024, {bs} x 10 s at 44.1 "
          f"kHz through run_arrays: depths {depths}, launches f32/tier {launches[0]}/"
          f"{launches[1]} (want 2/0); members bit-equal to standalone: MFCC {bit_mf}, chroma "
          f"{bit_ch}; vs full rate max|err|/max MFCC {e_mf:.3e} (limit 1e-3), chroma {e_ch:.3e} "
          f"(limit 2e-4) | median/p90 of 100: the set's step {t_set[0]:.4f}/{t_set[1]:.4f} ms; "
          f"MFCC multirate {t_mf[0]:.4f} vs full rate {t_mf_full[0]:.4f} ms (of which the "
          f"decimator, pad and 2^d gain {t_dec[0]:.4f} ms); chroma multirate {t_ch[0]:.4f} vs "
          f"full rate {t_ch_full[0]:.4f} ms")

    # ---- 7d. both kernels at the decimated inner geometries -----------------
    # The main path's shapes, on phase 3's broadband signal (noise and tones)
    # decimated by the plans' own front ends: the harmonic clips above leave
    # mel bands at the dB floor, where the tier's rounding is not bounded by
    # the frame's scale.
    xn = torch.from_numpy(signal(np.random.default_rng(SEED + 6), bs, n44, sr44)).to(dev)
    hann = lambda m: tg.make_window(tg.WindowType.hanning, m)
    mp = mf.mfcc_params
    basis = _dct_lifter_matrix(80, mp.n_mfcc, mp.lifter)
    basis = basis if mp.include_c0 or mp.n_mfcc == 1 else basis[:, 1:]
    geoms = [
        # name, decimated signal, n_fft, hop, sr, window, mapping, amp, pre, dct, kind, tol
        ("MFCC-13 mel-80 512/128 at 11025 Hz", mf._mel_plan._mr_pre(xn), 512, 128,
         sr44 / 4, hann(2048)[::4], mel_filterbank(sr44 / 4, 512, mel80), "decibels", "none",
         basis, "mfcc"),
        ("chroma 1024/256 at 11025 Hz", ch._pre(xn), 1024, 256, sr44 / 4, hann(4096)[::4],
         chroma_filterbank(sr44 / 4, 1024, ch.params), "power", "magnitude", None, "power"),
    ]
    for name, y, n_fft, hop, sr_d, win, mapping, amp, pre, dct, kind in geoms:
        f32 = dict(dtype=torch.float32, device=dev)
        win_t, map_t = torch.tensor(win, **f32), torch.tensor(mapping, **f32)
        dct_t = None if dct is None else torch.tensor(dct, **f32)
        kw = dict(amp=amp, floor_db=-80.0, centre=False, pre_amp=pre, device=str(dev),
                  dct_key=None if dct is None else ff.KernelConst(dct))
        run32 = ff.fused_factored_features(n_fft, hop, tuple(win.tolist()),
                                           ff.KernelConst(mapping), **kw)
        run16 = ff.fused_factored_features(n_fft, hop, tuple(win.tolist()),
                                           ff.KernelConst(mapping), precision="bf16", **kw)
        consts = ff.tier_constants(n_fft, win, mapping, dct, "bf16", True, dev)
        with torch.no_grad():
            plain = lambda: ff.fused_features_reference(y, win_t, map_t, amp, -80.0, pre, dct_t,
                                                        False, n_fft, hop)
            plain16 = lambda: ff.fused_tier_features_reference(y, consts, amp, -80.0, pre,
                                                               False, hop)
            out32, ref32, out16, ref16 = run32(y), plain(), run16(y), plain16()

            def chain():
                s = torch.stft(y, n_fft, hop, window=win_t, center=False, return_complex=True)
                p = s.abs() if pre == "magnitude" else s.abs() ** 2
                f = map_t @ p
                if amp == "decibels":
                    f = 10.0 * torch.log10(torch.clamp_min(f, 1e-8))
                return f if dct_t is None else torch.matmul(dct_t.T, f)

            times = {k: time_ms(fn) for k, fn in (("f32 kernel", lambda: run32(y)),
                                                  ("f32 plain", plain), ("chain", chain),
                                                  ("tier kernel", lambda: run16(y)),
                                                  ("tier plain", plain16))}
        if kind == "mfcc":
            err32 = float((out32 - ref32).abs().max())
            lim32 = 1e-4 * float(ref32.abs().max())
            ok32, what32 = err32 <= lim32, f"max|err| {err32:.3e} (limit {lim32:.3e}, 1e-4*max|ref|)"
        else:
            excess = (out32 - ref32).abs() - 1e-4 * ref32.abs() - 1e-7 * float(ref32.abs().max())
            ok32 = float(excess.max()) <= 0.0
            what32 = (f"max|err| {float((out32 - ref32).abs().max()):.3e} (rtol 1e-4 + atol "
                      "1e-7*max|ref|)")
        reading, limit, ok16, what = twin_err(out16, ref16, kind)
        xerr, xlim, xok = tier_err(out16, ref32, kind, "bf16")
        frames = y.shape[0] * out32.shape[-1]
        io = (4 * y.numel(), 4 * out32.numel())
        b32 = f32_bound(y.numel(), out32.numel(), frames, n_fft, mapping, dct, pre == "magnitude")
        b16 = tier_bound("bf16", True, n_fft, mapping, 0 if dct is None else dct.shape[1],
                         frames, *io, pre == "magnitude")
        check(f"decimated {name}", ok32 and ok16 and xok,
              f"{card} | input {tuple(y.shape)} -> {tuple(out32.shape)}, decimated Hann, "
              f"centre=False | f32 kernel vs plain {what32}; tier kernel (bf16) vs plain {what} "
              f"{reading:.3e} (limit {limit:g}), vs f32 exact {xerr:.3e} (limit {xlim:.3e}) | "
              "median/p90 of 100: " + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f} ms"
                                                 for k, v in times.items())
              + f" | bound f32 {b32[0] * 1e3:.2f} us ({'bytes' if b32[1] >= b32[2] else 'operations'}),"
              f" tier {b16[0] * 1e3:.2f} us ({'bytes' if b16[1] >= b16[2] else 'operations'})")
    return rates


# Phase 8's limits. The mel-dB kernel route against method="matmul" is held
# at phase 4's limit for the mel-dB sibling (2e-2 dB), the DEFAULT tier at
# TIER_LIMITS. The f64 LinearPowerPlan against a numpy f64 STFT at 1e-10 of
# the peak (tests/test_stft.py's 1e-10). The f32 STFT against rfft of frames
# built in f64 at 1e-4 of the peak, its iSTFT at 1e-4 of the signal's peak
# (tests/test_torch_port_stft.py's f32 bar). Griffin-Lim on the card against
# the port's CPU run of the same seed: at f64 (the fft route) 1e-9 of the
# peak; at f32 (the matmul route) both sum in f32 in their own order and the
# momentum-0.99 iteration amplifies that (tests/test_torch_port_reconstruct.py
# holds the port against the JAX package at 2e-2 of the peak after 32
# iterations), so 1e-2 of the peak, and the spectral convergence within 1e-4.
SURF_DB = 2e-2
SURF_F64 = 1e-10
SURF_STFT = 1e-4
GL_F64, GL_F32, GL_SC = 1e-9, 1e-2, 1e-4


def surface_phase(tg, ff, dev, card, xb, tier_bound) -> None:
    """Phase 8: the spectrogram-family surface (see the module docstring).
    Each check prints its reading before a failure ends the run."""
    counters = (ff.fused_factored_features, ff.fused_tier_features)

    def check(label, ok, reading):
        print(f"[8 {label}] {reading} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"surface phase: {label}")

    def counted(fn):
        """fn() with both kernels' counts set to 0 just before it and read
        just after: (result, (f32 launches, tier launches))."""
        for c in counters:
            c.launches = 0
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, tuple(c.launches for c in counters)

    t_phase = time.perf_counter()
    params = tg.SpectrogramParams(tg.StftParams(1024, 256), SR)
    mel = tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY)
    db = tg.LogParams(-80.0)
    audio_s = xb.shape[0] * xb.shape[1] / SR

    # ---- 8a. config 2: MelDbPlan on the (32, 160000) batch -------------------
    planned = tg.SpectrogramPlanner().mel_db_plan(params, mel, db, dtype="float32")
    typed = tg.MelDbPlan(params, mel, db, dtype="float32")
    with torch.no_grad():
        ref = tg.MelDbPlan(params, mel, db, dtype="float32", method="matmul").compute_batch(xb)
    y_planned, l_planned = counted(lambda: planned.compute_batch(xb))
    y, l_high = counted(lambda: typed.compute_batch(xb))
    err = float((y - ref).abs().max())
    # Beside each kernel: its plain version, a PyTorch chain computing the
    # same function (timed only) and its bound, as in phase 6.
    from spectrograms_tpu_torch.ops.dft import rdft_matrices
    from spectrograms_tpu_torch.ops.filterbanks import mel_filterbank
    mel64 = mel_filterbank(SR, 1024, mel)
    hann64 = tg.make_window(tg.WindowType.hanning, 1024)
    mel_t = torch.tensor(mel64, dtype=torch.float32, device=dev)
    win_t = torch.tensor(hann64, dtype=torch.float32, device=dev)
    tconsts = ff.tier_constants(1024, hann64, mel64, None, "bf16", True, dev)
    cs16 = torch.cat(rdft_matrices(1024, hann64, torch.float32, dev), dim=1).to(torch.bfloat16)
    mel16 = mel_t.T.contiguous().to(torch.bfloat16)
    eps = 10.0 ** (-80.0 / 10.0)

    def chain():
        st = torch.stft(xb, 1024, 256, window=win_t, center=True, pad_mode="constant",
                        return_complex=True)
        return 10.0 * torch.log10(torch.clamp_min(mel_t @ (st.abs() ** 2), eps))

    def chain_bf16():
        fr = F.pad(xb, (512, 512)).unfold(-1, 1024, 256).to(torch.bfloat16)
        re, im = (fr @ cs16).float().chunk(2, dim=-1)
        mel_p = ((re * re + im * im).to(torch.bfloat16) @ mel16).float()
        return (10.0 * torch.log10(torch.clamp_min(mel_p, eps))).transpose(-1, -2)

    frames = xb.shape[0] * y.shape[-1]
    f32_b = f32_bound(xb.numel(), y.numel(), frames, 1024, mel64, None, False)
    tier_b = tier_bound("bf16", True, 1024, mel64, 0, frames, 4 * xb.numel(), 4 * y.numel(), False)
    with torch.no_grad():
        high_ms, high_p90 = time_ms(lambda: typed.compute_batch(xb))
        high_k = time_ms(lambda: typed._kernel_run(xb))[0]
        high_plain = time_ms(lambda: ff.fused_features_reference(
            xb, win_t, mel_t, "decibels", -80.0, "none", None, True, 1024, 256))[0]
        high_chain = time_ms(chain)[0]
    check("config 2 HIGH",
          type(planned) is tg.MelDbPlan and planned.method == typed.method == "pallas"
          and l_planned == l_high == (1, 0) and torch.equal(y, y_planned)
          and tuple(y.shape) == (32, 128, 626) and bool(torch.isfinite(y).all()) and err <= SURF_DB,
          f"{card} | SpectrogramPlanner().mel_db_plan and MelDbPlan (1024/256, mel-128 Slaney "
          f"0-8 kHz, -80 dB) compute_batch (32, 160000) -> {tuple(y.shape)}, method "
          f"{typed.method!r}, launches f32 {l_high[0]} tier {l_high[1]} (planner's plan "
          f"{l_planned[0]}/{l_planned[1]}, equal: {torch.equal(y, y_planned)}); vs "
          f"method='matmul' max|err| {err:.3e} dB (limit {SURF_DB:g}); median/p90 of 100 "
          f"{high_ms:.4f}/{high_p90:.4f} ms, {audio_s / (high_ms / 1e3):.0f} audio-s/s; the "
          f"kernel {high_k:.4f} ms, plain {high_plain:.4f} ms, torch.stft chain "
          f"{high_chain:.4f} ms, bound {f32_b[0] * 1e3:.2f} us "
          f"({'bytes' if f32_b[1] >= f32_b[2] else 'operations'})")
    del ref
    dplan = tg.MelDbPlan(params, mel, db, dtype="float32", precision=tg.Precision.DEFAULT)
    with torch.no_grad():
        exact = tg.MelDbPlan(params, mel, db, dtype="float32", method="matmul",
                             precision=tg.Precision.HIGHEST).compute_batch(xb)
    yd, l_dflt = counted(lambda: dplan.compute_batch(xb))
    terr, tlim, tok = tier_err(yd, exact, "db", "bf16")
    with torch.no_grad():
        dflt_ms, dflt_p90 = time_ms(lambda: dplan.compute_batch(xb))
        dflt_k = time_ms(lambda: dplan._kernel_run(xb))[0]
        dflt_plain = time_ms(lambda: ff.fused_tier_features_reference(
            xb, tconsts, "decibels", -80.0, "none", True, 256))[0]
        dflt_chain = time_ms(chain_bf16)[0]
    check("config 2 DEFAULT", l_dflt == (0, 1) and tok and tuple(yd.shape) == (32, 128, 626),
          f"{card} | MelDbPlan(precision=DEFAULT) compute_batch, launches f32 {l_dflt[0]} tier "
          f"{l_dflt[1]}; vs HIGHEST matmul max|err| {terr:.3e} in power (limit {tlim:.3e}); "
          f"median/p90 of 100 {dflt_ms:.4f}/{dflt_p90:.4f} ms, "
          f"{audio_s / (dflt_ms / 1e3):.0f} audio-s/s; the kernel {dflt_k:.4f} ms, plain "
          f"{dflt_plain:.4f} ms, bf16 chain {dflt_chain:.4f} ms, bound {tier_b[0] * 1e3:.2f} us "
          f"({'bytes' if tier_b[1] >= tier_b[2] else 'operations'})")
    del yd, exact

    # ---- 8b. the one-shot and its plan cache -----------------------------------
    tg.clear_fft_plan_cache()
    row = xb[0]
    calls = [counted(lambda: tg.compute_mel_db_spectrogram(row, params, mel, db)) for _ in range(2)]
    info = tg.fft_plan_cache_info()["functions.cached_plan"]
    oerr = float((calls[1][0].data - y[0]).abs().max())
    check("one-shot", (info["misses"], info["hits"]) == (1, 1)
          and [c[1] for c in calls] == [(1, 0), (1, 0)]
          and torch.equal(calls[0][0].data, calls[1][0].data) and oerr <= SURF_DB,
          f"compute_mel_db_spectrogram on one 10 s row, twice: plan cache misses "
          f"{info['misses']} hits {info['hits']}; launches f32/tier a call "
          f"{[c[1] for c in calls]}; vs row 0 of the batch max|err| {oerr:.3e} dB "
          f"(limit {SURF_DB:g})")
    del y, calls

    # ---- 8c. config 1: f64 LinearPowerPlan against numpy ------------------------
    n1 = 16000
    x1 = np.sin(2 * np.pi * 440.0 * np.arange(n1) / n1)
    lp = tg.LinearPowerPlan(tg.SpectrogramParams(tg.StftParams(256, 128), float(n1)),
                            dtype="float64")
    got = lp.compute(x1).to_numpy()
    w = tg.make_window(tg.WindowType.hanning, 256)
    xp = np.pad(x1, (128, 128))
    frames = np.stack([xp[i * 128 : i * 128 + 256] for i in range((len(xp) - 256) // 128 + 1)])
    want = (np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2).T
    e64 = float(np.abs(got - want).max())
    x1_dev = torch.from_numpy(x1).to(dev)
    lp_ms = time_ms(lambda: lp.compute_raw(x1_dev))[0]
    check("config 1", lp.method == "fft" and got.dtype == np.float64 and got.shape == want.shape
          and e64 <= SURF_F64 * want.max() and int(np.argmax(got.mean(axis=1))) == 7,
          f"{card} | LinearPowerPlan(256/128, float64) on 1 s of a 440 Hz sine -> "
          f"{got.shape}, method {lp.method!r}; vs numpy f64 STFT max|err| {e64:.3e} "
          f"(limit {SURF_F64:g} x max {want.max():.1f}); peak bin "
          f"{int(np.argmax(got.mean(axis=1)))}; median {lp_ms:.4f} ms a signal")

    # ---- 8d. STFT round trip -------------------------------------------------------
    sp = tg.StftPlan(params, dtype="float32")
    with torch.no_grad():
        res = sp.compute(xb)
        fr = F.pad(xb.double(), (512, 512)).unfold(-1, 1024, 256)
        w64 = torch.tensor(tg.make_window(tg.WindowType.hanning, 1024), dtype=torch.float64,
                           device=dev)
        sref = torch.fft.rfft(fr * w64, dim=-1).transpose(-1, -2)
        serr = float((res.data.to(torch.complex128) - sref).abs().max() / sref.abs().max())
        del fr, sref
        back = tg.istft(res.data[0], 1024, 256)
        ierr = float((back - xb[0]).abs().max() / xb[0].abs().max())
        col = sp.compute_frame(xb[0], 300)
        ferr = float((col - res.data[0, :, 300]).abs().max() / res.data[0, :, 300].abs().max())
        stft_ms = time_ms(lambda: sp.compute(xb))[0]
        win32 = w64.float()
        lib_ms = time_ms(lambda: torch.stft(xb, 1024, 256, window=win32, center=True,
                                            pad_mode="constant", return_complex=True))[0]
    check("stft round trip", res.shape == (32, 513, 626) and res.data.dtype == torch.complex64
          and serr <= SURF_STFT and back.shape == xb[0].shape and ierr <= SURF_STFT
          and ferr <= SURF_STFT,
          f"{card} | StftPlan(1024/256, float32).compute (32, 160000) -> {res.shape} "
          f"{res.data.dtype}; vs rfft of f64 frames max|err|/max {serr:.3e}; istft of channel 0 "
          f"max|err|/max {ierr:.3e}; compute_frame(300) vs its column {ferr:.3e} (limits "
          f"{SURF_STFT:g}); median {stft_ms:.4f} ms ({audio_s / (stft_ms / 1e3):.0f} audio-s/s), "
          f"torch.stft {lib_ms:.4f} ms")
    del res, back

    # ---- 8e. Griffin-Lim on the card against the port's CPU run -----------------------
    xs = np.sin(2 * np.pi * 440.0 * np.arange(16000) / 16000.0)
    for dt, tol in ((np.float32, GL_F32), (np.float64, GL_F64)):
        mag = tg.stft(xs.astype(dt), 1024, 256).abs()

        def conv(yy):
            m = tg.stft(yy, 1024, 256, device=dev).abs()[:, : mag.shape[1]]
            return float(torch.linalg.norm(m - mag) / torch.linalg.norm(mag))

        with torch.no_grad():
            y0 = tg.griffin_lim(mag, 1024, 256, n_iter=0, length=16000)
            y32 = tg.griffin_lim(mag, 1024, 256, n_iter=32, length=16000)
            ycpu = tg.griffin_lim(mag.cpu(), 1024, 256, n_iter=32, length=16000, device="cpu")
            gerr = float((y32.cpu() - ycpu).abs().max() / ycpu.abs().max())
            sc0, sc32, sc_cpu = conv(y0), conv(y32), conv(ycpu.to(dev))
            gl_ms = time_ms(lambda: tg.griffin_lim(mag, 1024, 256, n_iter=32, length=16000),
                            reps=20, warmup=2)[0]
        route = "matmul" if dt == np.float32 else "fft"
        check(f"griffin-lim {np.dtype(dt).name}",
              y32.device.type == "cuda" and sc32 < sc0 and gerr <= tol
              and (dt == np.float64 or abs(sc32 - sc_cpu) <= GL_SC),
              f"{card} | 32 iterations at 1024/256, 1 s of a 440 Hz sine, {route} route: "
              f"spectral convergence {sc0:.4f} at iteration 0 -> {sc32:.6f} (CPU run "
              f"{sc_cpu:.6f}); vs the CPU run of the same seed max|err|/max {gerr:.3e} "
              f"(limit {tol:g}); {gl_ms / 32:.4f} ms an iteration (median of 20 calls)")
    print(f"[8 phase] {time.perf_counter() - t_phase:.1f} s")


# Phase 9's limits. The set's CQT member against the standalone plan at
# tests/test_featureset.py:80-113's bounds, on that test's signal (8 s: the
# middle third of the frames is then clear of the deep octaves' edges):
# rtol 5e-5 + atol 5e-5*max in the middle third, 5e-3*max everywhere. The
# f32 CQT plans against the f64 plans on the card at 1e-5 of the peak: the
# port's f32 plans read 4.8e-7 (the octave stack) and 8.1e-7 (dense
# truncate=True) of the peak against its f64 plans on two config-4 rows on
# the CPU. The MDCT round trip at tests/test_mdct.py's 1e-3 in the
# interior; its dense and folded forms at 1e-5 of the peak of each other
# (both f32, one product each, summed in other orders). The gammatone bank
# on the card against the port's CPU scan at f64 to 1e-9 relative (the
# JAX scalar-reference test, tests/test_cqt_erb.py:93-124).
C4_MID, C4_ALL = 5e-5, 5e-3
C4_F64 = 1e-5
C4_MDCT, C4_FOLD = 1e-3, 1e-5
C4_GAMMA = 1e-9


def config4_phase(tg, ff, dev, card, batch: int = 64) -> None:
    """Phase 9: ``benchmarks/suite.py`` config 4 at full size, 64 clips of 5 s
    (see the module docstring); a smaller ``batch`` rehearses it. Each check
    prints its reading before a failure ends the run."""
    from spectrograms_tpu_torch.mdct import (_consts_for, _imdct_folded_impl, _imdct_impl,
                                             _mdct_folded_impl, _mdct_impl)
    from spectrograms_tpu_torch.ops.decimate import DecimationCascade
    from spectrograms_tpu_torch.ops.filterbanks import chroma_filterbank

    counters = (ff.fused_factored_features, ff.fused_tier_features)

    def check(label, ok, reading):
        print(f"[9 {label}] {reading} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"config 4 phase: {label}")

    def counted(fn):
        for c in counters:
            c.launches = 0
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, tuple(c.launches for c in counters)

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    t_phase = time.perf_counter()
    sr, n = 44100.0, 220500
    nf = 216  # frames of 5 s at 4096/1024, centre
    xb = torch.from_numpy(np.random.default_rng(2).standard_normal((batch, n)).astype(np.float32)
                          ).to(dev)
    params = tg.SpectrogramParams(tg.StftParams(4096, 1024), sr)
    cqt_p = tg.CqtParams(12, 7, 32.703)
    cq = tg.CqtPowerPlan(params, cqt_p, dtype="float32")
    cq_dense = tg.CqtPowerPlan(params, cqt_p.with_truncate(True), dtype="float32")
    ch = tg.ChromaPlan(params.stft, sr, tg.ChromaParams.music_standard().with_multirate(),
                       dtype="float32")
    mp = tg.MdctParams.sine_window(512)

    def mdct_rt(b, folded=False):
        """Config 4's MDCT member: the round trip over the batch axis."""
        consts = _consts_for(mp, folded, b.dtype, b.device)
        if folded:
            d4, wa, wb, wc, wd, w = consts
            c = _mdct_folded_impl(b, d4, wa, wb, wc, wd, 512, 256)
            return _imdct_folded_impl(c.transpose(-1, -2), d4, w, 512, 256)[..., : b.shape[-1]]
        fwd, inv = consts
        c = _mdct_impl(b, fwd, 512, 256)
        return _imdct_impl(c.transpose(-1, -2), inv, 512, 256)[..., : b.shape[-1]]

    fs = tg.FeatureSet([cq, ch, mdct_rt])
    groups = [(d, flen, jp) for d, _, _, flen, jp in cq._cqt_multirate]
    check("setup", cq.scale_params.multirate and cq.scale_params.multirate_depth == "max"
          and ch.method == "pallas" and len(fs._flavors) == 1
          and cq.output_shape(n) == (84, nf),
          f"CqtPowerPlan(CqtParams(12, 7, 32.703)) at 4096/1024, 44.1 kHz: the policy elected "
          f"multirate={cq.scale_params.multirate}, depth {cq.scale_params.multirate_depth!r}, "
          f"groups (d, flen, jp) {groups}; chroma method {ch.method!r} at depth "
          f"{ch._decimation}; the set's cascades {len(fs._flavors)} (want 1)")

    # ---- 9a. the step, the kernel on its path -------------------------------
    fs._step_impl(xb)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    (got_cq, got_ch, got_rt), launches = counted(lambda: fs._step_impl(xb))
    peak = torch.cuda.max_memory_allocated(dev) - base_mem
    with torch.no_grad():
        alone_ch = ch.compute_batch(xb)
    bit_ch = torch.equal(got_ch, alone_ch)
    check("step", launches == (1, 0) and bit_ch and tuple(got_cq.shape) == (batch, 84, nf)
          and tuple(got_ch.shape) == (batch, 12, nf) and bool(torch.isfinite(got_cq).all())
          and bool(torch.isfinite(got_rt).all()),
          f"{card} | FeatureSet([cqt, chroma, mdct_rt])._step_impl on ({batch}, {n}) -> CQT "
          f"{tuple(got_cq.shape)}, chroma {tuple(got_ch.shape)}, MDCT round trip "
          f"{tuple(got_rt.shape)}; launches f32/tier a step {launches[0]}/{launches[1]} (want "
          f"1/0); chroma member bit-equal to ChromaPlan.compute_batch: {bit_ch}; the step's "
          f"peak CUDA memory above its input {peak / 2**20:.1f} MiB")
    print(f"[9 launches] config 4's chroma member launches fused_features.cu {launches[0]} time "
          f"a step (fused_tier_features.cu {launches[1]})")

    y = ch._pre(xb)
    win_t, fb_t = ch._mag_plan._window, ch._fb_t.T.contiguous()
    fb64 = chroma_filterbank(sr / 4, 1024, ch.params)
    with torch.no_grad():
        out = ch._kernel_run(y)
        ref = ff.fused_features_reference(y, win_t, fb_t, "power", -80.0, "magnitude", None,
                                          False, 1024, 256)

        def chain():
            st = torch.stft(y, 1024, 256, window=win_t, center=False, return_complex=True)
            return fb_t @ st.abs()

        k_ms, k_p90 = time_ms(lambda: ch._kernel_run(y))
        p_ms = time_ms(lambda: ff.fused_features_reference(
            y, win_t, fb_t, "power", -80.0, "magnitude", None, False, 1024, 256))[0]
        c_ms = time_ms(chain)[0]
    excess = (out - ref).abs() - 1e-4 * ref.abs() - 1e-7 * float(ref.abs().max())
    kb = f32_bound(y.numel(), out.numel(), y.shape[0] * out.shape[-1], 1024, fb64, None, True)
    check("kernel", float(excess.max()) <= 0.0,
          f"{card} | fused_features.cu on the decimated batch {tuple(y.shape)} (chroma 1024/256 "
          f"at 11025 Hz, centre=False) -> {tuple(out.shape)} vs its plain version max|err| "
          f"{float((out - ref).abs().max()):.3e} (rtol 1e-4 + atol 1e-7*max|ref|) | median/p90 "
          f"of 100: kernel {k_ms:.4f}/{k_p90:.4f} ms, plain {p_ms:.4f} ms, torch.stft chain "
          f"{c_ms:.4f} ms, bound {kb[0] * 1e3:.2f} us "
          f"({'bytes' if kb[1] >= kb[2] else 'operations'})")
    del y, out, ref

    # ---- 9b. CQT ---------------------------------------------------------------------
    x8 = torch.from_numpy(np.random.default_rng(7).standard_normal((1, int(sr) * 8))
                          .astype(np.float32)).to(dev)
    with torch.no_grad():
        g8 = tg.FeatureSet([cq, ch]).compute_batch(x8)[0]
        w8 = cq.compute_batch(x8)
        w5 = cq.compute_batch(xb)
    nf8 = g8.shape[-1]
    mid = (Ellipsis, slice(nf8 // 3, 2 * nf8 // 3))
    peak8 = float(w8.abs().max())
    mid_excess = float(((g8[mid] - w8[mid]).abs() - C4_MID * w8[mid].abs() - C4_MID * peak8).max())
    all_err = float((g8 - w8).abs().max()) / peak8
    mid5 = (Ellipsis, slice(nf // 3, 2 * nf // 3))
    check("cqt set vs standalone", mid_excess <= 0.0 and all_err <= C4_ALL,
          f"{card} | the set's CQT member vs CqtPowerPlan.compute_batch on 8 s (the JAX test's "
          f"signal): middle third rtol {C4_MID:g} + atol {C4_MID:g}*max excess {mid_excess:.3e} "
          f"(<= 0), everywhere max|err|/max {all_err:.3e} (limit {C4_ALL:g}) | on the config-4 "
          f"batch (5 s, edge frames nearer the deep octaves): middle third "
          f"{rel(got_cq[mid5], w5[mid5]):.3e}, everywhere {rel(got_cq, w5):.3e} of the peak")
    del g8, w8, x8, w5
    rows = xb[:2]
    for label, plan, p64 in (("octave stack", cq, cqt_p), ("dense truncate=True", cq_dense,
                                                            cqt_p.with_truncate(True))):
        with torch.no_grad():
            a = plan.compute_batch(rows)
            b = tg.CqtPowerPlan(params, p64, dtype="float64").compute_batch(rows.double())
        err = rel(a.double(), b)
        check(f"cqt f32 vs f64 {label}", err <= C4_F64,
              f"{card} | CqtPowerPlan f32 vs f64 on two config-4 rows, {label}: max|err|/max "
              f"{err:.3e} (limit {C4_F64:g})")

    # ---- 9c. MDCT ---------------------------------------------------------------------
    with torch.no_grad():
        rt_fold = mdct_rt(xb, folded=True)
        c_dense = _mdct_impl(xb, _consts_for(mp, False, xb.dtype, dev)[0], 512, 256)
        d4, wa, wb, wc, wd, _ = _consts_for(mp, True, xb.dtype, dev)
        c_fold = _mdct_folded_impl(xb, d4, wa, wb, wc, wd, 512, 256)
    m = got_rt.shape[-1]
    rt_err = float((got_rt[:, 512:m - 512] - xb[:, 512:m - 512]).abs().max())
    fold_c, fold_rt = rel(c_fold, c_dense), rel(rt_fold, got_rt)
    check("mdct", rt_err <= C4_MDCT and fold_c <= C4_FOLD and fold_rt <= C4_FOLD,
          f"{card} | MdctParams.sine_window(512) round trip of ({batch}, {n}) -> "
          f"{tuple(got_rt.shape)}: interior max|err| {rt_err:.3e} (limit {C4_MDCT:g}); folded vs "
          f"dense coefficients {fold_c:.3e}, round trip {fold_rt:.3e} of the peak (limit "
          f"{C4_FOLD:g})")
    del rt_fold, c_dense, c_fold

    # ---- 9d. the gammatone bank ---------------------------------------------------------
    xg = np.random.default_rng(SEED + 9).standard_normal(16000)
    erb = tg.ErbParams(32, 50.0, 8000.0)
    want, _ = tg.gammatone_iir_spectrogram(xg, 16000.0, 1024, 256, erb, dtype="float64",
                                           method="scan", device="cpu")
    xg_dev = torch.from_numpy(xg).to(dev)
    g_times, g_errs = {}, {}
    for method in ("scan", "parallel"):
        with torch.no_grad():
            got, _ = tg.gammatone_iir_spectrogram(xg_dev, 16000.0, 1024, 256, erb,
                                                  dtype="float64", method=method)
            g_times[method] = time_ms(lambda: tg.gammatone_iir_spectrogram(
                xg_dev, 16000.0, 1024, 256, erb, dtype="float64", method=method),
                reps=5, warmup=1)
        g_errs[method] = float(((got.cpu() - want).abs() / want.abs()).max())
    check("gammatone", all(e <= C4_GAMMA for e in g_errs.values()),
          f"{card} | gammatone_iir_spectrogram 1 s at 16 kHz, 32 bands, frame 1024, hop 256 "
          f"-> {tuple(want.shape)} at f64, vs the port's CPU scan max relative error: "
          + ", ".join(f"{k} {v:.3e}" for k, v in g_errs.items())
          + f" (limit {C4_GAMMA:g}) | median/p90 of 5: "
          + ", ".join(f"{k} {v[0]:.3f}/{v[1]:.3f} ms" for k, v in g_times.items()))

    # ---- 9e. times ----------------------------------------------------------------------
    def separate():
        return cq.compute_batch(xb), ch.compute_batch(xb), mdct_rt(xb)

    def dense_step():
        return cq_dense.compute_batch(xb), ch.compute_batch(xb), mdct_rt(xb)

    depths = sorted({d for spec in fs._specs if spec is not None for d in spec[3]})

    def cascade():
        cas = DecimationCascade(xb, pad=fs._flavors[(True, tg.Precision.HIGH)],
                                precision=tg.Precision.HIGH, composite=True)
        return [cas.level(d) for d in depths]

    with torch.no_grad():
        times = {label: time_ms(fn, reps=30) for label, fn in (
            ("step", lambda: fs._step_impl(xb)), ("separate", separate),
            ("truncate_true", dense_step), ("cqt", lambda: cq.compute_batch(xb)),
            ("cqt truncate_true", lambda: cq_dense.compute_batch(xb)),
            ("chroma", lambda: ch.compute_batch(xb)), ("mdct round trip", lambda: mdct_rt(xb)),
            ("mdct round trip folded", lambda: mdct_rt(xb, folded=True)),
            ("cascade", cascade))}
    dense_ops = 2.0 * batch * nf * 4096 * 2 * 84
    dense_bytes = 4.0 * (batch * n + 4096 * 2 * 84 + batch * nf * 84)
    d_ops, d_bytes = dense_ops / H100_F32_FLOPS * 1e3, dense_bytes / H100_BYTES_PER_S * 1e3
    # the MDCT round trip's two dense products, (frames, 512) @ (512, 256) and back
    mdct_ops = 2 * 2.0 * batch * ((n - 512) // 256 + 1) * 512 * 256
    m_ops, m_bytes = mdct_ops / H100_F32_FLOPS * 1e3, 4.0 * 2 * batch * n / H100_BYTES_PER_S * 1e3
    audio_s = batch * n / sr
    print(f"[9 times] {card} | median/p90 of 30 (L2 flushed, device spin): "
          + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f} ms" for k, v in times.items())
          + f" | the step {audio_s / (times['step'][0] / 1e3):.0f} audio-s/s ({audio_s:.0f} "
          f"audio-s a step), truncate_true {audio_s / (times['truncate_true'][0] / 1e3):.0f} "
          f"audio-s/s | the dense CQT product's bound {max(d_ops, d_bytes):.4f} ms "
          f"({'operations' if d_ops >= d_bytes else 'bytes'}; {dense_ops / 1e9:.2f} GFLOP at "
          f"67 TFLOP/s, {dense_bytes / 1e6:.1f} MB at 3.35 TB/s); the MDCT round trip's bound "
          f"{max(m_ops, m_bytes):.4f} ms ({'operations' if m_ops >= m_bytes else 'bytes'}; "
          f"{mdct_ops / 1e9:.2f} GFLOP); cascade levels {depths} | "
          f"host time of one step's enqueue (median of 30, device idle before): "
          f"{host_us(lambda: fs._step_impl(xb), reps=30) / 1e3:.4f} ms")

    # ---- 9f. where one step's device time goes ----------------------------------------
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fs._step_impl(xb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fs._step_impl(xb)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    # the kernels' own rows (an operator's row repeats its kernels' time)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print("[9 profile] torch.profiler recorded no device time: not measured")
    else:
        total = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
        print(f"[9 profile] {card} | one step under torch.profiler: wall {wall:.3f} ms, device "
              f"time {total:.3f} ms in {sum(e.count for e in events)} kernels (idle share of "
              f"the wall {max(0.0, 1 - total / wall):.2f}) | top by device time: "
              + "; ".join(f"{e.key[:70]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                          for e in top))
    print(f"[9 phase] {time.perf_counter() - t_phase:.1f} s")


# Phase 10's limits. Image results in f32 against numpy f64 of the same
# function at tests/test_spectral2d.py's 2e-4 (absolute, on unit-variance
# images), in f64 at 1e-10 (tests/test_fft2d.py); the mel-dB block at 1e-3 dB
# (tests/test_torch_port_plans.py's bar for f32 plans). 1-D convolution and
# the overlap-save convolver in f32 at 1e-5 of the output's peak, the
# deconvolution and minimum phase in f64 at 1e-10 (tests/test_convolution.py).
# The 2-D FFT of a 1024² image: f64 within 1e-13 of the peak against numpy,
# f32 within 1e-5 (the same transform rounded in f32); the round trips at
# 1e-12 (f64) and 1e-5 (f32) absolute. The f64-grade tier at
# tests/test_f32x2.py's bounds: the plan 1e-9 relative to numpy f64 (config
# 8: of the peak; the mel-128 plan: per element), stft_x2 → istft_x2 1e-12
# of the RMS, fft2d_x2 1e-12 of the peak, |lo| <= 1e-6 max|hi|; the
# factored plan against method="matmul" at tests/test_fft_factored.py's
# 2e-3 dB.
P10_IMG, P10_IMG64, P10_DB = 2e-4, 1e-10, 1e-3
P10_CONV, P10_EXACT64 = 1e-5, 1e-10
P10_FFT2_64, P10_FFT2_32, P10_RT64, P10_RT32 = 1e-13, 1e-5, 1e-12, 1e-5
P10_PLAN, P10_X2, P10_LO, P10_FACTORED = 1e-9, 1e-12, 1e-6, 2e-3


def fft_image_phase(tg, ff, dev, card, batch: int = 32) -> None:
    """Phase 10: the 1-D/2-D FFT and image family and the f64-grade method
    tiers (config 5 and config 8 of ``benchmarks/suite.py``, at their own
    sizes; see the module docstring); a smaller ``batch`` of the flagship
    rehearses it. Each check prints its reading before a failure ends the
    run."""
    from spectrograms_tpu_torch.ops import dd as D
    from spectrograms_tpu_torch.ops import spectral2d as s2
    from spectrograms_tpu_torch.ops.filterbanks import mel_filterbank
    from spectrograms_tpu_torch.ops.framing import frame_signal

    counters = (ff.fused_factored_features, ff.fused_tier_features)

    def check(label, ok, reading):
        print(f"[10 {label}] {reading} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"fft and image phase: {label}")

    def counted(fn):
        """fn() with both kernels' counts set to 0 just before it and read
        just after: (result, (f32 launches, tier launches))."""
        for c in counters:
            c.launches = 0
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, tuple(c.launches for c in counters)

    def err(a, b):
        return float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())

    def hann(n):
        return tg.make_window(tg.WindowType.hanning, n)

    t_phase = time.perf_counter()
    on = dict(device=dev)

    # ---- 10a. config 5: a mel-dB block and a 512² blur + edge detection ------
    c5 = tg.MelDbPlan(tg.SpectrogramParams(tg.StftParams(512, 128, centre=False), SR),
                      tg.MelParams(64, 0.0, 8000.0, tg.MelNorm.SLANEY), tg.LogParams(-80.0),
                      dtype="float32", **on)
    frames_np = np.random.default_rng(3).standard_normal((64, 512)).astype(np.float32)
    img_np = np.random.default_rng(4).standard_normal((512, 512)).astype(np.float32)
    ker_np = np.asarray(tg.gaussian_kernel_2d(9, 2.0), dtype=np.float32)
    frames = torch.from_numpy(frames_np).to(dev)
    img = torch.from_numpy(img_np).to(dev)
    ker_t = torch.from_numpy(ker_np).to(dev)  # on the device, as suite.py device_puts it

    def feats():
        return c5._forward_frames(frames)

    def blur(x, kernel=ker_t):
        return tg.convolve_fft(x, kernel, **on)

    def step():
        f = feats()
        edges = tg.detect_edges_fft(blur(img + f.sum() * 1e-30), **on)
        return f, edges

    (f5, e5), l5 = counted(step)
    spec = np.fft.rfft(frames_np.astype(np.float64) * hann(512), axis=-1)
    mel64 = (np.abs(spec) ** 2) @ mel_filterbank(SR, 512, tg.MelParams(64, 0.0, 8000.0,
                                                                      tg.MelNorm.SLANEY)).T
    db_ref = 10.0 * np.log10(np.maximum(mel64, 1e-8))
    from spectrograms_tpu_torch.image_ops import _lowpass_mask, _pad_kernel_for_fft
    padded = _pad_kernel_for_fft(ker_np.astype(np.float64), (512, 512))
    blur64 = np.fft.irfft2(np.fft.rfft2(img_np.astype(np.float64)) * np.fft.rfft2(padded),
                           s=(512, 512))
    hp_half = 1.0 - _lowpass_mask((512, 257), 0.1)
    edges64 = np.fft.irfft2(np.fft.rfft2(blur64) * hp_half, s=(512, 512))
    e_db = err(f5.cpu().double(), db_ref)
    e_edges = err(e5.cpu().double(), edges64)
    with torch.no_grad():
        e_blur = err(blur(img).cpu().double(), blur64)
        img64 = img.double()
        e64 = err(tg.detect_edges_fft(tg.convolve_fft(img64, ker_np.astype(np.float64), **on),
                                      **on).cpu(), edges64)
    check("config 5 step", e_db <= P10_DB and max(e_blur, e_edges) <= P10_IMG
          and e64 <= P10_IMG64 and l5 == (0, 0) and tuple(f5.shape) == (64, 64),
          f"{card} | MelDbPlan 512/128 centre=False mel-64 frames step on (64, 512) + 512² blur "
          f"(9x9 Gaussian sigma 2) + detect_edges_fft: vs numpy f64 mel dB {e_db:.3e} dB (limit "
          f"{P10_DB:g}), blur {e_blur:.3e}, edges {e_edges:.3e} (limit {P10_IMG:g}); the f64 image "
          f"{e64:.3e} (limit {P10_IMG64:g}); launches f32 {l5[0]} tier {l5[1]}")
    with torch.no_grad():
        t_step = time_ms(step)
        t_feats = time_ms(feats)
        t_blur = time_ms(lambda: blur(img))
        # a kernel given as a host array is copied to the device, and the copy
        # waits for the device's queue: the host's enqueue then shows
        t_blur_host = time_ms(lambda: blur(img, ker_np))
        t_edges = time_ms(lambda: tg.detect_edges_fft(img, **on))
    block_audio = 64 * 128 / SR
    print(f"[10 config 5 times] {card} | median/p90 of 100: step {t_step[0]:.4f}/{t_step[1]:.4f} "
          f"ms ({block_audio / t_step[0] * 1e3:.1f} block audio-s/s), of which the mel-dB block "
          f"{t_feats[0]:.4f}, convolve_fft {t_blur[0]:.4f} (the kernel a host array: "
          f"{t_blur_host[0]:.4f}), detect_edges_fft {t_edges[0]:.4f} ms")

    # ---- 10b. the two 2-D routes at 256², 512² and 1024² (use_matmul_path) ---
    wins = {}
    for side in (256, 512, 1024):
        x = torch.from_numpy(np.random.default_rng(side).standard_normal(
            (side, side)).astype(np.float32)).to(dev)
        half = 1.0 - _lowpass_mask((side, side // 2 + 1), 0.1)
        half_t = torch.tensor(half, dtype=torch.float32, device=dev)
        full = s2.full_mask_from_half(half, side)
        kspec = s2.full_spectrum_from_kernel(_pad_kernel_for_fft(ker_np.astype(np.float64),
                                                                 (side, side)))
        k_half = torch.fft.rfft2(torch.tensor(_pad_kernel_for_fft(ker_np, (side, side)),
                                              device=dev))

        def fft_filter():
            return torch.fft.irfft2(torch.fft.rfft2(x) * half_t, s=(side, side))

        def fft_conv():
            return torch.fft.irfft2(torch.fft.rfft2(x) * k_half, s=(side, side))

        with torch.no_grad():
            e_f = err(s2.spectral_filter_matmul(x, full), fft_filter())
            e_c = err(s2.spectral_conv_matmul(x, kspec), fft_conv())
            t = {name: time_ms(fn)[0] for name, fn in (
                ("fft filter", fft_filter), ("matmul filter", lambda: s2.spectral_filter_matmul(
                    x, full)), ("fft conv", fft_conv),
                ("matmul conv", lambda: s2.spectral_conv_matmul(x, kspec)))}
        wins[side] = (t["matmul filter"] < t["fft filter"], t["matmul conv"] < t["fft conv"])
        check(f"routes {side}", max(e_f, e_c) <= P10_IMG,
              f"{card} | {side}²: high-pass(0.1) cuFFT {t['fft filter']:.4f} ms vs dense "
              f"products {t['matmul filter']:.4f} ms; Gaussian conv cuFFT {t['fft conv']:.4f} "
              f"vs products {t['matmul conv']:.4f} ms; routes agree to {max(e_f, e_c):.3e} "
              f"(limit {P10_IMG:g}); products win: filter {wins[side][0]}, conv {wins[side][1]}")
    crossover = max([side for side, w in wins.items() if all(w)], default=0)
    print(f"[10 rule] {card} | largest side where the products beat cuFFT on both: "
          f"{crossover}; ops/spectral2d.py MATMUL_MAX_DIM = {s2.MATMUL_MAX_DIM} "
          f"({'agrees' if crossover == s2.MATMUL_MAX_DIM else 'DIFFERS from this run'})")

    # ---- 10c. the 1-D family ------------------------------------------------
    rng = np.random.default_rng(10)
    sig = signal(rng, 1, 16000, SR)[0]
    ir = (rng.standard_normal(513) * np.exp(-np.arange(513) / 100.0)).astype(np.float32)
    direct = np.convolve(sig.astype(np.float64), ir.astype(np.float64))
    sig_t, ir_t = torch.from_numpy(sig).to(dev), torch.from_numpy(ir).to(dev)
    direct_t = torch.from_numpy(direct).to(dev)
    sig64_t = sig_t.double()
    with torch.no_grad():
        y = tg.fft_convolve(sig_t, ir_t, **on)
        e_conv = err(y.cpu().double(), direct) / np.abs(direct).max()
        rec = tg.fft_deconvolve(direct_t, sig64_t, regularization=0.0, **on)
        e_dec = err(rec.cpu(), ir.astype(np.float64))
        t_conv = time_ms(lambda: tg.fft_convolve(sig_t, ir_t, **on))[0]
        t_dec = time_ms(lambda: tg.fft_deconvolve(direct_t, sig64_t, **on))[0]
    check("fft_convolve", e_conv <= P10_CONV and e_dec <= P10_EXACT64,
          f"{card} | 1 s at 16 kHz * 513-tap IR: f32 vs np.convolve {e_conv:.3e} of the peak "
          f"(limit {P10_CONV:g}), {t_conv:.4f} ms; f64 deconvolution recovers the IR to "
          f"{e_dec:.3e} (limit {P10_EXACT64:g}), {t_dec:.4f} ms")
    long_np = np.zeros(157 * 1024, dtype=np.float32)  # 10 s, zero-padded to whole blocks
    long_np[:160000] = signal(rng, 1, 160000, SR)[0]
    conv = tg.OverlapSaveConvolver(ir, 1024, dtype="float32", **on)
    long_t = torch.from_numpy(long_np).to(dev)
    blocks = long_t.reshape(-1, 1024)

    def block_loop():
        conv.reset()
        return torch.cat([conv.process_block(b) for b in blocks])

    with torch.no_grad():
        ols = conv.process_signal(long_t)
        loop = block_loop()
        ols_ref = np.convolve(long_np.astype(np.float64), ir.astype(np.float64))[: long_np.size]
        e_ols = err(ols.cpu().double(), ols_ref) / np.abs(ols_ref).max()
        e_loop = err(ols, loop) / float(loop.abs().max())
        t_ols = time_ms(lambda: conv.process_signal(long_t), reps=30)[0]
        t_loop = time_ms(block_loop, reps=5, warmup=1)[0]
    check("overlap-save", max(e_ols, e_loop) <= P10_CONV,
          f"{card} | process_signal on 10 s at 16 kHz (157 blocks of 1024, fft_size "
          f"{conv.fft_size}): vs np.convolve {e_ols:.3e}, vs a loop of process_block "
          f"{e_loop:.3e} of the peak (limit {P10_CONV:g}); {t_ols:.4f} ms against the loop's "
          f"{t_loop:.4f} ms")
    # minimum phase against numpy's cepstral computation in f64
    mp_ir = ir.astype(np.float64)[:64]
    n = 1 << (64 * 8 - 1).bit_length()
    h = np.fft.fft(mp_ir, n)
    mag2 = np.abs(h) ** 2
    cep = np.fft.ifft(0.5 * np.log(mag2 + mag2.max() * 1e-20))
    w = np.zeros(n)
    w[0], w[1:n // 2], w[n // 2] = 1.0, 2.0, 1.0
    mp_ref = np.real(np.fft.ifft(np.exp(np.fft.fft(cep * w))))[:64]
    mp_t = torch.from_numpy(mp_ir).to(dev)
    with torch.no_grad():
        e_mp = err(tg.minimum_phase(mp_t, **on).cpu(), mp_ref)
        t_mp = time_ms(lambda: tg.minimum_phase(mp_t, **on))[0]
    check("minimum_phase", e_mp <= P10_EXACT64,
          f"{card} | 64 taps, f64, vs numpy {e_mp:.3e} (limit {P10_EXACT64:g}), {t_mp:.4f} ms")
    big = np.random.default_rng(11).standard_normal((1024, 1024))
    ref2 = np.fft.rfft2(big)
    for dt, lim, lim_rt in (("float64", P10_FFT2_64, P10_RT64), ("float32", P10_FFT2_32,
                                                                  P10_RT32)):
        xin = torch.tensor(big, dtype=getattr(torch, dt), device=dev)
        with torch.no_grad():
            spec2 = tg.fft2d(xin, **on)
            e2 = err(spec2.cpu().to(torch.complex128), ref2) / np.abs(ref2).max()
            e_rt = err(tg.ifft2d(spec2, 1024, **on).cpu().double(), xin.cpu().double())
            t2 = time_ms(lambda: tg.fft2d(xin, **on))[0]
            t_rt = time_ms(lambda: tg.ifft2d(spec2, 1024, **on))[0]
        check(f"fft2d {dt}", e2 <= lim and e_rt <= lim_rt,
              f"{card} | 1024²: fft2d vs numpy {e2:.3e} of the peak (limit {lim:g}), ifft2d "
              f"round trip {e_rt:.3e} (limit {lim_rt:g}); {t2:.4f} ms and {t_rt:.4f} ms")

    # ---- 10d. config 8: the f64-grade tier ------------------------------------
    x8 = np.sin(2 * np.pi * 440 * np.arange(16000) / 16000).astype(np.float32)
    p8 = tg.SpectrogramPlan(tg.SpectrogramParams(tg.StftParams(256, 128), SR),
                            tg.FreqScale.LINEAR, tg.AmpScale.POWER, dtype="float32",
                            method="f32x2", **on)
    fr8 = np.pad(x8.astype(np.float64), 128)
    fr8 = np.lib.stride_tricks.sliding_window_view(fr8, 256)[::128][:126]
    ref8 = (np.abs(np.fft.rfft(fr8 * hann(256), axis=-1)) ** 2).T
    x8_t = torch.from_numpy(x8).to(dev)
    (hi8, lo8), l8 = counted(lambda: p8.compute_raw_x2(x8_t))
    e8 = float(np.abs(D.dd_to_f64((hi8, lo8)) - ref8).max() / ref8.max())
    e8_hi = float(np.abs(p8.compute(x8_t).data.cpu().double().numpy() - ref8).max() / ref8.max())
    fr8_t = frame_signal(x8_t, 256, 128, True)
    with torch.no_grad():
        e8_dd = float(np.abs(D.dd_to_f64(tuple(a.T for a in p8._bins_x2_dd(fr8_t))) - ref8).max()
                      / ref8.max())
        t8 = time_ms(lambda: p8.compute_raw_x2(x8_t))[0]
        t8_dd = time_ms(lambda: p8._bins_x2_dd(fr8_t), reps=10, warmup=2)[0]
    lo_ok = float(lo8.abs().max()) <= P10_LO * float(hi8.abs().max())
    check("config 8 plan", e8 <= P10_PLAN and e8_dd <= P10_PLAN and lo_ok and l8 == (0, 0),
          f"{card} | LINEAR POWER f32x2 256/128 on 1 s of 440 Hz: vs numpy f64 {e8:.3e} of the "
          f"peak (limit {P10_PLAN:g}; hi alone {e8_hi:.3e}); the dd route {e8_dd:.3e}; |lo|/max|hi| "
          f"{float(lo8.abs().max()) / float(hi8.abs().max()):.3e}; f64 route {t8:.4f} ms, dd "
          f"route {t8_dd:.4f} ms ({t8_dd / t8:.1f}x); launches f32 {l8[0]} tier {l8[1]}")
    rms = float(np.sqrt(np.mean(np.square(x8, dtype=np.float64))))
    with torch.no_grad():
        rt = D.dd_to_f64(tg.istft_x2(tg.stft_x2(x8_t, 512, 128, **on), 512, 128, **on))
        t_stft = time_ms(lambda: tg.stft_x2(x8_t, 512, 128, **on))[0]
        spec_x2 = tg.stft_x2(x8_t, 512, 128, **on)
        t_istft = time_ms(lambda: tg.istft_x2(spec_x2, 512, 128, **on))[0]
    e_rt8 = float(np.abs(rt - x8).max() / rms)
    check("config 8 round trip", e_rt8 <= P10_X2,
          f"{card} | stft_x2 -> istft_x2 at 512/128: {e_rt8:.3e} of the RMS (limit {P10_X2:g}); "
          f"stft_x2 {t_stft:.4f} ms, istft_x2 {t_istft:.4f} ms")
    img8_np = np.random.default_rng(8).standard_normal((128, 128)).astype(np.float32)
    img8 = torch.from_numpy(img8_np).to(dev)
    ref_img8 = np.fft.rfft2(img8_np.astype(np.float64))

    def fft2d_x2_dd():
        # JAX's dd route (x2.py): dd rows r2c, then dd columns c2c
        re, im = D.dd_rfft((img8, torch.zeros_like(img8)), 128)
        t_ = lambda p: (p[0].T, p[1].T)
        re_t, im_t = D.dd_fft((t_(re), t_(im)), 128)
        return t_(re_t), t_(im_t)

    with torch.no_grad():
        (reh, rel_), (imh, iml) = tg.fft2d_x2(img8, **on)
        g8 = D.dd_to_f64((reh, rel_)) + 1j * D.dd_to_f64((imh, iml))
        (dre, dim_) = fft2d_x2_dd()
        g8_dd = D.dd_to_f64(dre) + 1j * D.dd_to_f64(dim_)
        t_f2 = time_ms(lambda: tg.fft2d_x2(img8, **on))[0]
        t_f2_dd = time_ms(fft2d_x2_dd, reps=10, warmup=2)[0]
    e_f2 = float(np.abs(g8 - ref_img8).max() / np.abs(ref_img8).max())
    e_f2_dd = float(np.abs(g8_dd - ref_img8).max() / np.abs(ref_img8).max())
    check("config 8 fft2d_x2", e_f2 <= P10_X2 and e_f2_dd <= P10_X2,
          f"{card} | 128² from default_rng(8): vs numpy f64 {e_f2:.3e} of the peak, the dd route "
          f"{e_f2_dd:.3e} (limit {P10_X2:g}); f64 route {t_f2:.4f} ms, dd route {t_f2_dd:.4f} "
          f"ms ({t_f2_dd / t_f2:.1f}x)")

    # ---- 10e. the new methods at real sizes ------------------------------------
    clip = signal(np.random.default_rng(12), 1, 160000, SR)[0]
    clip_t = torch.from_numpy(clip).to(dev)
    mel128 = tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY)
    px2 = tg.SpectrogramPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), SR),
                             tg.FreqScale.MEL, tg.AmpScale.POWER, scale_params=mel128,
                             dtype="float32", method="f32x2", **on)
    (hi, lo), lx2 = counted(lambda: px2.compute_raw_x2(clip_t))
    fr = np.lib.stride_tricks.sliding_window_view(np.pad(clip.astype(np.float64), 512),
                                                  1024)[::256][:626]
    ref_mel = ((np.abs(np.fft.rfft(fr * hann(1024), axis=-1)) ** 2)
               @ mel_filterbank(SR, 1024, mel128).T).T
    got_mel = D.dd_to_f64((hi, lo))
    e_mel = float((np.abs(got_mel - ref_mel) / (np.abs(ref_mel) + 1e-300)).max())
    frc = frame_signal(clip_t, 1024, 256, True)
    with torch.no_grad():
        dd_mel = D.dd_to_f64(tuple(a.T for a in px2._bins_x2_dd(frc)))
        e_mel_dd = float((np.abs(dd_mel - ref_mel) / (np.abs(ref_mel) + 1e-300)).max())
        t_x2 = time_ms(lambda: px2.compute_raw_x2(clip_t))[0]
        t_x2_dd = time_ms(lambda: px2._bins_x2_dd(frc), reps=5, warmup=1)[0]
    check("f32x2 mel-128", e_mel <= P10_PLAN and e_mel_dd <= P10_PLAN and lx2 == (0, 0)
          and got_mel.shape == (128, 626),
          f"{card} | MEL POWER f32x2 1024/256 mel-128 on 10 s: vs numpy f64 {e_mel:.3e} per "
          f"element, the dd route {e_mel_dd:.3e} (limit {P10_PLAN:g}); f64 route {t_x2:.4f} ms, "
          f"dd route {t_x2_dd:.4f} ms ({t_x2_dd / t_x2:.1f}x)")
    xb = torch.from_numpy(signal(np.random.default_rng(13), batch, 160000, SR)).to(dev)
    params = tg.SpectrogramParams(tg.StftParams(1024, 256), SR)
    db = tg.LogParams(-80.0)
    plans = {m: tg.MelDbPlan(params, mel128, db, dtype="float32", method=m, **on)
             for m in ("factored", "matmul", "auto", "fft")}
    out_fac, l_fac = counted(lambda: plans["factored"].compute_batch(xb))
    _, l_auto = counted(lambda: plans["auto"].compute_batch(xb))
    with torch.no_grad():
        e_fac = err(out_fac, plans["matmul"].compute_batch(xb))
        t = {m: time_ms(lambda p=p: p.compute_batch(xb)) for m, p in plans.items()}
    check("factored flagship", e_fac <= P10_FACTORED and l_fac == (0, 0) and l_auto == (1, 0),
          f"{card} | MelDbPlan ({batch}, 160000) 1024/256 mel-128 dB, method='factored' vs "
          f"'matmul' "
          f"{e_fac:.3e} dB (limit {P10_FACTORED:g}); launches factored {l_fac}, auto {l_auto}; "
          f"median/p90 of 100: factored {t['factored'][0]:.4f}/{t['factored'][1]:.4f} ms, auto "
          f"(the f32 kernel) {t['auto'][0]:.4f}, fft {t['fft'][0]:.4f}, matmul "
          f"{t['matmul'][0]:.4f} ms")
    print(f"[10 phase] {time.perf_counter() - t_phase:.1f} s")


# Phase 11's limits. The autotune winners against method="matmul": f32
# routes at phase 3's mfcc_tol (1e-4 of max|ref|) for MFCC and phase 4's
# 1e-4 of max|ref| for chroma; a DEFAULT-tier winner against HIGHEST matmul
# at MFCC_TIER_LIMITS. Served batches equal compute_batch of the same rows
# (exact, as phase 7), the one-entry mesh bit-equal to mesh=None, the
# 4-entry mesh on one card within phase 3's db_tol (1e-3 dB). Data
# parallelism against compute_batch at mfcc_tol; sequence parallelism
# against plan.compute at db_tol. Binaural batches on the card: f64 at
# 1e-9 against the port's CPU f64 run (phases modulo 2π: the wrap rule of
# tests/test_torch_port_binaural.py); f32 against the same f64 run at 10x
# that test's f32 bars (1e-2 dB ILD, 1e-3 ILR, 1e-2 rad for IPD and ITD's
# phase), on cells where both channels exceed 1e-3 of the item's peak
# magnitude, since one f32 FFT over 10 s batches is held here against f64;
# f64 histograms: the same valid count per frame and at most 1e-3 of the
# values in another bin. Sources on the card (f32) against the same source
# on the CPU in f64: the mel-dB plan at 1e-2 dB, the others at 1e-3 of
# max|ref|. Serde: exact after loading.
P11_DB, P11_MFCC_REL, P11_CHROMA_REL = 1e-3, 1e-4, 1e-4
P11_BIN64, P11_ILD32, P11_ILR32, P11_PHASE32 = 1e-9, 1e-2, 1e-3, 1e-2
P11_HIST_MOVED, P11_SRC_DB, P11_SRC_REL = 1e-3, 1e-2, 1e-3


def tuning_parallel_phase(tg, ff, dev, card, phase7_rates, batch: int = 32,
                          seconds: float = 10.0, n_files: int = 256,
                          seq_samples: int = 9_600_000) -> None:
    """Phase 11: autotune and wisdom, config 7 served with autotune=True and
    over a mesh, data and sequence parallelism, binaural, sources and serde
    (see the module docstring)."""
    # the package binds ``autotune`` to the function: the module by its name
    at = sys.modules["spectrograms_tpu_torch.autotune"]
    from spectrograms_tpu_torch import binaural as tb
    from spectrograms_tpu_torch import serde
    from spectrograms_tpu_torch.parallel import (create_device_mesh, data_parallel_pipeline,
                                                 sequence_parallel_spectrogram, shard_batch)
    from spectrograms_tpu_torch.runtime import read_wav, write_wav

    counters = (ff.fused_factored_features, ff.fused_tier_features)
    n = int(SR * seconds)

    def check(label, ok, reading):
        print(f"[11 {label}] {reading} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"tuning and parallel phase: {label}")

    def counted(fn):
        for c in counters:
            c.launches = 0
        with torch.no_grad():
            out = fn()
        torch.cuda.synchronize()
        return out, tuple(c.launches for c in counters)

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    mel_p = tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY)
    mkw = dict(mel_params=mel_p, mfcc_params=tg.MfccParams(40, include_c0=True, lifter=22),
               log_params=tg.LogParams(-80.0), dtype="float32")
    stft = tg.StftParams(1024, 256)
    xb = torch.from_numpy(signal(rng, batch, n, SR)).to(dev)

    # ---- 11a. autotune on the flagship and chroma batches ------------------
    sr44 = 44100.0
    xc = torch.from_numpy(rng.standard_normal((2 * batch, int(sr44 * seconds / 2)))
                          .astype(np.float32)).to(dev)
    highest = dict(method="matmul", precision=tg.Precision.HIGHEST)
    cases = [
        ("flagship MFCC HIGH", tg.MfccPlan(stft, SR, **mkw), xb,
         tg.MfccPlan(stft, SR, **mkw, method="matmul"), "mfcc"),
        ("flagship MFCC DEFAULT", tg.MfccPlan(stft, SR, **mkw, precision=tg.Precision.DEFAULT),
         xb, tg.MfccPlan(stft, SR, **mkw, **highest), "mfcc"),
        ("chroma HIGH", tg.ChromaPlan(tg.StftParams(4096, 1024), sr44, dtype="float32"), xc,
         tg.ChromaPlan(tg.StftParams(4096, 1024), sr44, dtype="float32", method="matmul"),
         "chroma"),
    ]
    tg.clear_wisdom()
    for label, plan, x, ref_plan, kind in cases:
        t0 = time.perf_counter()
        res, tune_launches = counted(lambda: tg.autotune_plan(plan, x, kernel_variants=True))
        tune_s = time.perf_counter() - t0
        with torch.no_grad():
            ref = ref_plan.compute_batch(x)
            out = res.plan.compute_batch(x)
            events = {m: time_ms(lambda p=at._rebuild_with_method(plan, m): p.compute_batch(x),
                                 reps=30) for m in res.timings_ms}
        tier_winner = (res.winner.startswith("pallas")
                       and at._spectrogram_plan(plan).precision == tg.Precision.DEFAULT)
        if tier_winner:
            err, lim, ok = tier_err(out, ref, "mfcc", "bf16")
            what = f"vs HIGHEST matmul max|err| {err:.3e} (tier limit {lim:.3e})"
        else:
            err = float((out - ref).abs().max())
            lim = (P11_MFCC_REL if kind == "mfcc" else P11_CHROMA_REL) * float(ref.abs().max())
            ok = err <= lim
            what = f"vs matmul max|err| {err:.3e} (limit {lim:.3e})"
        expect = ["fft", "matmul", "pallas", "pallas:dif"] + (
            [] if at._spectrogram_plan(plan).precision == tg.Precision.DEFAULT
            else ["pallas:stack", "pallas:dif+stack", "pallas:gauss"])
        lines = "; ".join(
            f"{m} slope {res.timings_ms[m]:.4f} ms, event {events[m][0]:.4f}/{events[m][1]:.4f} "
            f"ms (gap {res.timings_ms[m] - events[m][0]:+.4f})" for m in res.timings_ms)
        check(f"autotune {label}", ok and list(res.timings_ms) == expect
              and tune_launches[0] + tune_launches[1] > 0 and bool(torch.isfinite(out).all()),
              f"{card} | {tuple(x.shape)} kernel_variants=True, tuned in {tune_s:.2f} s, "
              f"launches during tuning f32/tier {tune_launches[0]}/{tune_launches[1]} | {lines} "
              f"| winner {res.winner!r}, auto resolves to {plan.method!r} "
              f"({'agrees' if res.winner == plan.method else 'DIFFERS'}); winner {what}")
        hit, hit_launches = counted(lambda: tg.autotune_plan(plan, x, kernel_variants=True))
        check(f"wisdom hit {label}", hit.from_cache and hit.timings_ms == {}
              and hit.winner == res.winner and hit_launches == (0, 0),
              f"second autotune_plan: from_cache {hit.from_cache}, timings_ms "
              f"{hit.timings_ms}, winner {hit.winner!r}, launches {hit_launches} (want (0, 0))")
        del out, ref
    with tempfile.TemporaryDirectory() as tmp:
        saved = tg.wisdom()
        tg.save_wisdom(Path(tmp) / "wisdom.json")
        tg.clear_wisdom()
        loaded = tg.load_wisdom(Path(tmp) / "wisdom.json")
        again, again_launches = counted(lambda: tg.autotune_plan(cases[0][1], xb,
                                                                 kernel_variants=True))
    check("wisdom round trip", loaded == saved and len(saved) == 3 and again.from_cache
          and again_launches == (0, 0),
          f"save_wisdom/load_wisdom of {len(saved)} entries equal: {loaded == saved}; "
          f"autotune_plan after loading from_cache {again.from_cache}, launches {again_launches}")
    del xc

    # ---- 11b. config 7 served with autotune=True and over a mesh -----------
    plan7 = tg.SpectrogramPlan(tg.SpectrogramParams(stft, SR), tg.FreqScale.MEL,
                               tg.AmpScale.DECIBELS, scale_params=mel_p,
                               log_params=tg.LogParams(-80.0), dtype="float32")
    srng = np.random.default_rng(SEED + 5)  # phase 7's clips
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(n_files):
            path = Path(tmp) / f"clip_{i:04d}.wav"
            write_wav(path, (0.1 * srng.standard_normal(n)).astype(np.float32), int(SR),
                      bits=16)
            paths.append(str(path))
        rows_dev = torch.from_numpy(np.stack([read_wav(p, mono=True)[0] for p in paths])).to(dev)
        tg.clear_wisdom()
        pipes = {
            "mesh=None": tg.FeaturePipeline(plan7, batch_size=batch, target_seconds=seconds),
            "autotune=True": tg.FeaturePipeline(plan7, batch_size=batch, target_seconds=seconds,
                                                autotune=True),
            "mesh (1,)": tg.FeaturePipeline(plan7, batch_size=batch, target_seconds=seconds,
                                            mesh=create_device_mesh((1,), ("data",))),
            "mesh (4,) on one card": tg.FeaturePipeline(
                plan7, batch_size=batch, target_seconds=seconds,
                mesh=create_device_mesh((4,), ("data",), devices=[dev] * 4)),
        }
        served = {}
        n_batches = -(-n_files // batch)
        for label, pipe in pipes.items():
            pipe.warm_preload()
            batches, launches = counted(lambda: list(pipe.run(paths)))
            feats = [b.features for b in batches]
            served[label] = feats
            with torch.no_grad():
                refs = [pipe.plan.compute_batch(rows_dev[i * batch:(i + 1) * batch])
                        for i in range(len(batches))]
            err = max(float((f - r).abs().max()) for f, r in zip(feats, refs))
            rate = float(np.median([pipe.throughput_report(paths)["audio_s_per_s"]
                                    for _ in range(3)]))
            blocks = 4 if "(4,)" in label else 1
            kernel_route = pipe.plan.method.startswith("pallas")
            want = (n_batches * blocks, 0) if kernel_route else (0, 0)
            extra = ""
            if pipe.autotune_result is not None:
                r = pipe.autotune_result
                extra = (f"; autotune winner {r.winner!r} (auto: {plan7.method!r}), candidates "
                         + ", ".join(f"{m} {v:.4f} ms" for m, v in r.timings_ms.items()))
            limit = P11_DB if blocks > 1 else 0.0
            check(f"config 7 {label}", len(batches) == n_batches and err <= limit
                  and launches == want,
                  f"{card} | {len(batches)} batches of {tuple(feats[0].shape)} vs compute_batch "
                  f"of the read_wav rows max|err| {err:.3e} (limit {limit:g}); launches f32/tier "
                  f"{launches[0]}/{launches[1]} (want {want[0]}/{want[1]}) | {rate:.1f} audio-s/s "
                  f"(median of 3; phase 7 float32 {phase7_rates.get('float32', float('nan')):.1f})"
                  + extra)
        bit1 = all(torch.equal(a, b) for a, b in zip(served["mesh (1,)"], served["mesh=None"]))
        bit4 = all(torch.equal(a, b) for a, b in zip(served["mesh (4,) on one card"],
                                                     served["mesh=None"]))
        check("config 7 mesh vs mesh=None", bit1,
              f"one-entry mesh bit-equal to mesh=None: {bit1}; the 4-entry mesh on one card "
              f"bit-equal: {bit4}")
        del served, rows_dev
    tg.clear_wisdom()

    # ---- 11c. data parallelism on the flagship batch ------------------------
    plan = tg.MfccPlan(stft, SR, **mkw)
    with torch.no_grad():
        ref = plan.compute_batch(xb)
    lim = P11_MFCC_REL * float(ref.abs().max())
    for label, mesh in (("(1,)", create_device_mesh((1,), ("data",))),
                        ("(4,) on one card", create_device_mesh((4,), ("data",),
                                                                devices=[dev] * 4))):
        step = data_parallel_pipeline(plan.compute_batch, mesh)
        sharded = shard_batch(xb, mesh)
        out, launches = counted(lambda: step(sharded).gather())
        with torch.no_grad():
            t_dp = time_ms(lambda: step(sharded))
        err = float((out - ref).abs().max())
        blocks = mesh.shape["data"]
        check(f"data parallel {label}", err <= lim and launches == (blocks, 0)
              and tuple(out.shape) == tuple(ref.shape),
              f"{card} | shard_batch + data_parallel_pipeline(MfccPlan.compute_batch) on "
              f"{tuple(xb.shape)}: vs compute_batch max|err| {err:.3e} (limit {lim:.3e}), "
              f"bit-equal {torch.equal(out, ref)}; f32 launches {launches[0]} (want {blocks}, one "
              f"a block), tier {launches[1]} | median/p90 of 100 {t_dp[0]:.4f}/{t_dp[1]:.4f} ms")
    mesh4 = create_device_mesh((4,), ("data",), devices=[dev] * 4)
    n_rows = batch - 2  # 30 rows at the full size: two short of the mesh's multiple
    padded, mask = shard_batch(xb[:n_rows], mesh4, return_mask=True)
    out, launches = counted(lambda: data_parallel_pipeline(plan.compute_batch, mesh4)(
        padded).gather())
    err = float((out[mask.to(dev)] - ref[:n_rows]).abs().max())
    check("data parallel uneven", err <= lim and launches == (4, 0) and out.shape[0] == batch
          and int(mask.sum()) == n_rows,
          f"{n_rows} rows over 4 entries: padded to {out.shape[0]}, mask {int(mask.sum())} true; "
          f"masked rows vs compute_batch max|err| {err:.3e} (limit {lim:.3e}); f32 launches "
          f"{launches[0]} (want 4)")
    del out, ref, padded

    # ---- 11d. sequence parallelism on 10 min of noise -----------------------
    long_x = torch.from_numpy((0.1 * rng.standard_normal(seq_samples)).astype(np.float32)).to(dev)
    with torch.no_grad():
        ref = plan7.compute(long_x).data
        t_ref = time_ms(lambda: plan7.compute(long_x), reps=20)
    for label, mesh in (("(1,)", create_device_mesh((1,), ("time",))),
                        ("(4,) on one card", create_device_mesh((4,), ("time",),
                                                                devices=[dev] * 4))):
        seq = sequence_parallel_spectrogram(plan7, mesh, axis="time")
        h0 = sequence_parallel_spectrogram.halo_copies
        out, launches = counted(lambda: seq(long_x))
        halos = sequence_parallel_spectrogram.halo_copies - h0
        with torch.no_grad():
            t_seq = time_ms(lambda: seq(long_x), reps=20)
        err = float((out - ref).abs().max())
        blocks = mesh.shape["time"]
        check(f"sequence parallel {label}", err <= P11_DB and launches == (blocks, 0)
              and halos == blocks - 1 and tuple(out.shape) == tuple(ref.shape),
              f"{card} | {seq_samples} samples (mel-128 dB 1024/256) -> {tuple(out.shape)}: vs "
              f"plan.compute max|err| {err:.3e} dB (limit {P11_DB:g}); f32 launches "
              f"{launches[0]} (want {blocks}), halo copies {halos} | median/p90 of 20: "
              f"{t_seq[0]:.4f}/{t_seq[1]:.4f} ms against compute {t_ref[0]:.4f}/{t_ref[1]:.4f} ms")
    del long_x, ref, out

    # ---- 11e. binaural on 32 x 10 s stereo ----------------------------------
    bparams = tg.SpectrogramParams(tg.StftParams(512, 256), SR)
    src = rng.standard_normal((batch, n + 16))
    stereo = np.stack([src[:, 16:] + 0.3 * rng.standard_normal((batch, n)),
                       0.7 * src[:, 9:n + 9] + 0.3 * rng.standard_normal((batch, n))], axis=1)
    kinds = (("itd", tg.ITDSpectrogramParams(bparams)), ("ipd", tg.IPDSpectrogramParams(bparams)),
             ("ild", tg.ILDSpectrogramParams(bparams)), ("ilr", tg.ILRSpectrogramParams(bparams)))
    cpu = torch.device("cpu")
    spec64 = tb._stereo_spec_math(torch.from_numpy(stereo), tb._window(kinds[0][1], torch.float64,
                                                                       cpu), 512, 256, True, 0, 257)
    mags = spec64.abs()
    peak = mags.amax(dim=(1, 2, 3), keepdim=True)[:, :, 0]
    live_all = ((mags[:, 0] > 1e-3 * peak) & (mags[:, 1] > 1e-3 * peak)).numpy()
    for kind, p in kinds:
        b0, b1, bw = tb._bin_range(p)
        fn = getattr(tg, f"compute_{kind}_spectrogram_batch")
        want = fn(stereo, p, dtype="float64", device="cpu").numpy()
        live = live_all[:, b0:b1]
        for dt in ("float64", "float32"):
            got = fn(stereo, p, dtype=dt).double().cpu().numpy()
            if kind in ("ild", "ilr"):
                d = np.abs(np.nan_to_num(got - want, nan=0.0))
                nan_ok = bool((np.isnan(got) == np.isnan(want))[live].all())
            else:
                a, b = got, want
                if kind == "itd":
                    scale = 2 * np.pi * bw * np.arange(b0, b1)[:, None]
                    a, b = a * scale, b * scale
                d = np.abs(np.remainder(a - b + np.pi, 2 * np.pi) - np.pi)
                nan_ok = True
            if dt == "float64":
                reading, limit = float(d.max()), P11_BIN64
            else:
                reading = float(d[live].max())
                limit = {"ild": P11_ILD32, "ilr": P11_ILR32}.get(kind, P11_PHASE32)
            with torch.no_grad():
                xs = torch.from_numpy(stereo.astype(dt)).to(dev)
                t = time_ms(lambda: fn(xs, p, dtype=dt), reps=20)
            check(f"binaural {kind} {dt}", reading <= limit and nan_ok,
                  f"{card} | compute_{kind}_spectrogram_batch {stereo.shape} on the card vs "
                  f"the CPU f64 run: {reading:.3e} (limit {limit:g}"
                  f"{', phases modulo 2pi' if kind in ('itd', 'ipd') else ''}"
                  f"{', live cells' if dt == 'float32' else ''}) | median/p90 of 20 "
                  f"{t[0]:.4f}/{t[1]:.4f} ms")
    # one-shots and histograms (f64, one pair)
    for kind, p in kinds:
        one = getattr(tg, f"compute_{kind}_spectrogram")
        got = one(stereo[0], p, dtype="float64")
        want = one(stereo[0], p, dtype="float64", device="cpu")
        # ILD and ILR histograms cube their counts by default: compare counts
        hist = (lambda r: r.histogram(exponent=1)) if kind in ("ild", "ilr") else (
            lambda r: r.histogram())
        hg, hw = hist(got), hist(want)
        moved = 0.5 * float(np.abs(hg - hw).sum())
        counts, counts_w = hg.sum(axis=0), hw.sum(axis=0)
        total = float(counts_w.sum())
        check(f"binaural {kind} one-shot", got.data.is_cuda and bool((counts == counts_w).all())
              and moved <= P11_HIST_MOVED * total and got.shape == want.shape,
              f"compute_{kind}_spectrogram(10 s, f64) on the card {got.shape}, histogram "
              f"{hg.shape}: valid counts per frame equal to the CPU run's, {moved:.0f} of "
              f"{total:.0f} values in another bin (limit {P11_HIST_MOVED:g})")

    # ---- 11f. the six sources on 10 s --------------------------------------
    x1 = xb[0]
    x1_cpu = x1.double().cpu()
    mel_src = tg.MelDbPlan(tg.SpectrogramParams(stft, SR), mel_p, tg.LogParams(-80.0),
                           dtype="float32")
    mel_src64 = tg.MelDbPlan(tg.SpectrogramParams(stft, SR), mel_p, tg.LogParams(-80.0),
                             dtype="float64", device="cpu")
    erb = tg.ErbParams(32, 50.0, 8000.0)
    srcs = [
        ("PlanSource", tg.PlanSource(mel_src), tg.PlanSource(mel_src64), (1, 0)),
        ("GammatoneSource", tg.GammatoneSource(SR, 1024, 256, erb),
         tg.GammatoneSource(SR, 1024, 256, erb, dtype="float64", device="cpu"), (0, 0)),
        ("CqtSource", tg.CqtSource(SR, tg.CqtParams(12, 7, 32.703), 256),
         tg.CqtSource(SR, tg.CqtParams(12, 7, 32.703), 256, dtype="float64", device="cpu"),
         (0, 0)),
        ("ChromaSource", tg.ChromaSource(stft, SR),
         tg.ChromaSource(stft, SR, dtype="float64", device="cpu"), (1, 0)),
        ("MfccSource", tg.MfccSource(stft, SR, 128, tg.MfccParams(40)),
         tg.MfccSource(stft, SR, 128, tg.MfccParams(40), dtype="float64", device="cpu"), (1, 0)),
    ]
    for label, s, s_cpu, want_launches in srcs:
        t0 = time.perf_counter()
        out, launches = counted(lambda: s.compute_matrix(x1))
        wall = time.perf_counter() - t0
        ref = s_cpu.compute_matrix(x1_cpu)
        err = float((out.double().cpu() - ref).abs().max())
        lim = P11_SRC_DB if label == "PlanSource" else P11_SRC_REL * float(ref.abs().max())
        ok = (err <= lim and launches == want_launches and out.shape[0] == s.n_bands
              and out.is_cuda and isinstance(s, tg.SpectrogramSource))
        timing = ""
        if label != "GammatoneSource":
            with torch.no_grad():
                t = time_ms(lambda: s.compute_matrix(x1), reps=20)
            timing = f"median/p90 of 20 {t[0]:.4f}/{t[1]:.4f} ms"
        else:
            timing = f"one call {wall * 1e3:.1f} ms (host clock, synchronized; auto = scan)"
        check(f"source {label}", ok,
              f"{card} | compute_matrix(10 s) {tuple(out.shape)} vs the CPU f64 source "
              f"max|err| {err:.3e} (limit {lim:.3e}); launches f32/tier {launches[0]}/"
              f"{launches[1]} (want {want_launches[0]}/{want_launches[1]}) | {timing}")
    # the sixth: the protocol itself, on a plan source of the flagship MFCC's mel plan
    check("source protocol", isinstance(tg.PlanSource(plan._mel_plan), tg.SpectrogramSource)
          and not isinstance(object(), tg.SpectrogramSource),
          "SpectrogramSource is runtime-checkable: a PlanSource is one, an object is not")

    # ---- 11g. serde on the card ----------------------------------------------
    items = [("Spectrogram", mel_src.compute(x1)), ("Mfcc", plan.compute(x1)),
             ("ItdSpectrogram", tg.compute_itd_spectrogram(stereo[0], kinds[0][1]))]
    with tempfile.TemporaryDirectory() as tmp:
        for label, obj in items:
            path = Path(tmp) / f"{label}.npz"
            serde.save(obj, path)
            back = serde.load(path)
            same = (type(back) is type(obj) and back.data.is_cuda
                    and torch.equal(back.data, obj.data) and back.params == obj.params)
            check(f"serde {label}", same,
                  f"NPZ save/load of a CUDA {label} {tuple(obj.data.shape)}: type, device, data "
                  f"and params equal after loading: {same}")
    print(f"[11 phase] {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs one GPU")
    import spectrograms_tpu_torch as tg
    from spectrograms_tpu_torch.mfcc import _dct_lifter_matrix
    from spectrograms_tpu_torch.ops import _build
    from spectrograms_tpu_torch.ops import factored_layout as fl
    from spectrograms_tpu_torch.ops import fused_factored as ff
    from spectrograms_tpu_torch.ops import tier_layout as tl
    from spectrograms_tpu_torch.ops.dft import rdft_matrices
    from spectrograms_tpu_torch.ops.filterbanks import (chroma_filterbank, erb_filterbank,
                                                        mel_filterbank)
    from spectrograms_tpu_torch.ops.framing import frame_count

    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index]
    print(f"[1 card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(dev)}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are enabled; the plain references need true f32")

    # ---- 2. build -------------------------------------------------------
    # the host library (g++) builds beside the two nvcc builds
    from spectrograms_tpu_torch.runtime import native
    native_build = {}

    def build_native():
        t = time.perf_counter()
        native_build["path"] = native.build_library()
        native_build["seconds"] = time.perf_counter() - t

    native_thread = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    native_thread.start()
    _build.build_all(["fused_features", "fused_tier_features"])
    _build.load_library("fused_features", ff._SIGNATURES)
    _build.load_library("fused_tier_features", ff._TIER_SIGNATURES)
    for name in ("fused_features", "fused_tier_features"):
        seconds, log = _build.build_log.get(name, (0.0, "(already built)"))
        ptxas = " ".join(
            line.split(":", 1)[-1].strip() for line in log.splitlines()
            if "registers" in line or "spill" in line
        )
        print(f"[2 build] {name}.cu sm_90a in {seconds:.2f} s "
              f"(both, in parallel, loaded in {time.perf_counter() - t0:.2f} s) | {ptxas}")
    native_thread.join()
    if "path" not in native_build or not native.native_available():
        fail("the native host library native/sgtpu.cpp did not build")
    print(f"[2 build] native/sgtpu.cpp (g++) in {native_build['seconds']:.2f} s -> "
          f"{native_build['path'].name}")

    # ---- 3. kernel against its plain version, on the card ---------------
    rng = np.random.default_rng(SEED)
    hann = lambda n: tg.make_window(tg.WindowType.hanning, n)
    mel128 = mel_filterbank(SR, 1024, tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY))
    dct40 = _dct_lifter_matrix(128, 40, 22)

    def db_tol(out, ref):
        # Both sides f32; they differ in summation order only (the kernel's
        # radix-8 passes vs cuFFT, loops vs GEMM): ~1e-6 relative in power,
        # ~5e-6 dB. 1e-3 dB leaves margin and still fails any wrong bin.
        err = float((out - ref).abs().max())
        return err, err <= 1e-3, "atol 1e-3 dB"

    def mfcc_tol(out, ref):
        # The DCT sums 128 dB values of magnitude ~1e2 into coefficients up
        # to ~1e4: an absolute error relative to the largest coefficient.
        err, limit = float((out - ref).abs().max()), 1e-4 * float(ref.abs().max())
        return err, err <= limit, f"atol {limit:.3e} (1e-4*max|ref|)"

    def power_tol(out, ref):
        # rtol 1e-4. Near-empty bins carry the FFT's rounding of the whole
        # frame's energy, not of their own, so they get an atol of
        # 1e-7·max|ref| (the f32 rounding floor of the largest bin).
        excess = (out - ref).abs() - 1e-4 * ref.abs() - 1e-7 * float(ref.abs().max())
        err = float((out - ref).abs().max())
        return err, float(excess.max()) <= 0.0, "rtol 1e-4 + atol 1e-7*max|ref|"

    mel40 = mel_filterbank(SR, 512, tg.MelParams(40, 0.0, 8000.0, tg.MelNorm.SLANEY))
    cases = [
        # name, n_fft, hop, sr, mapping (n_out, n_bins) | "identity", amp,
        # pre_amp, dct, centre, (batch, n), tolerance, recorded max|err|
        ("a flagship MFCC 1024/256 mel-128 dB DCT-40", 1024, 256, SR, mel128,
         "decibels", "none", dct40, True, (32, 160000), mfcc_tol,
         "radix-2 kernel: 7.080e-03; radix-8 kernel: 6.104e-03"),
        ("b mel-128 dB 1024/256", 1024, 256, SR, mel128,
         "decibels", "none", None, True, (32, 160000), db_tol,
         "radix-2 kernel: 3.185e-04; radix-8 kernel: 3.128e-04"),
        ("c mel-40 dB 512/160 (frames-input geometry)", 512, 160, SR, mel40,
         "decibels", "none", None, True, (32, 160000), db_tol,
         "radix-2 kernel: 1.011e-04; radix-8 kernel: 8.392e-05"),
        ("d linear identity power 1024/256", 1024, 256, SR, "identity",
         "power", "none", None, True, (8, 160000), power_tol,
         "radix-2 kernel: 7.812e-03; radix-8 kernel: 8.789e-03"),
        ("e chroma 4096/1024 pre_amp=magnitude power", 4096, 1024, 22050.0,
         chroma_filterbank(22050.0, 4096, tg.ChromaParams()),
         "power", "magnitude", None, True, (8, 220500), power_tol,
         "radix-2 kernel: 1.144e-05; radix-8 kernel: 3.338e-06"),
        # the staged span's edges: hop 160 and an odd row length put every
        # frame and row at its own 16-byte shift; centre=False starts at 0
        ("l mel-128 dB 1024/160, odd length 160001", 1024, 160, SR, mel128,
         "decibels", "none", None, True, (8, 160001), db_tol, "radix-8 kernel: 2.041e-04"),
        ("m flagship MFCC centre=False, length 159999", 1024, 256, SR, mel128,
         "decibels", "none", dct40, False, (8, 159999), mfcc_tol, "radix-8 kernel: 6.958e-03"),
        # ERB rows are dense: the kernel sums them in longer pieces
        ("n ERB-128 power 1024/256 (dense rows)", 1024, 256, SR,
         erb_filterbank(SR, 1024, tg.ErbParams(128, 50.0, 8000.0))[0],
         "power", "none", None, True, (8, 160000), power_tol, "radix-8 kernel: 2.734e-02"),
    ]
    flagship_err = None
    edge_rng = np.random.default_rng(SEED + 3)
    for (name, n_fft, hop, sr, mapping, amp, pre_amp, dct, centre, (b, n), tol,
         recorded) in cases:
        win = hann(n_fft)
        run = ff.fused_factored_features(
            n_fft, hop, tuple(win.tolist()),
            mapping if isinstance(mapping, str) else ff.KernelConst(mapping),
            amp=amp, floor_db=-80.0, centre=centre,
            dct_key=None if dct is None else ff.KernelConst(dct),
            pre_amp=pre_amp, device=str(dev),
        )
        fb = np.eye(n_fft // 2 + 1) if isinstance(mapping, str) else mapping
        f32 = dict(dtype=torch.float32, device=dev)
        # cases l, m and n draw from their own seed, so that the later phases'
        # inputs stay those of the runs recorded before them
        x = torch.from_numpy(signal(edge_rng if name[0] in "lmn" else rng, b, n, sr)).to(dev)
        out = run(x)
        ref = ff.fused_features_reference(
            x, torch.tensor(win, **f32), torch.tensor(fb, **f32), amp, -80.0,
            pre_amp, None if dct is None else torch.tensor(dct, **f32),
            centre, n_fft, hop,
        )
        torch.cuda.synchronize()
        nf = frame_count(n, n_fft, hop, centre)
        expect = (b, fb.shape[0] if dct is None else dct.shape[1], nf)
        if tuple(out.shape) != expect or not bool(torch.isfinite(out).all()):
            fail(f"[3 {name}] shape {tuple(out.shape)} (want {expect}) or non-finite")
        err, ok, limit = tol(out, ref)
        print(f"[3 kernel vs plain] {name}: max|err| {err:.3e} ({limit}) "
              f"{'ok' if ok else 'FAIL'} (recorded: {recorded})")
        if not ok:
            fail(f"kernel disagrees with its plain version at {name}")
        if flagship_err is None:
            flagship_err = err
        del x, out, ref

    # The tier kernel, on inputs of its own seed (the f32 kernel's phases
    # keep their inputs). Each case against its plain version on the
    # output's own scale (TWIN_*), and against the f32 exact result at the
    # tier's limit; every case prints before a failure ends the phase.
    rng2 = np.random.default_rng(SEED + 2)
    tier_cases = [
        # name, n_fft, hop, sr, mapping, amp, pre_amp, dct, precision,
        # gauss, (batch, n), kind
        ("f flagship MFCC bf16 Gauss", 1024, 256, SR, mel128, "decibels", "none", dct40,
         "bf16", True, (32, 160000), "mfcc"),
        ("g flagship MFCC bf16x2", 1024, 256, SR, mel128, "decibels", "none", dct40,
         "bf16x2", False, (32, 160000), "mfcc"),
        ("h mel-128 dB 1024/256 bf16 packed", 1024, 256, SR, mel128, "decibels", "none",
         None, "bf16", False, (32, 160000), "db"),
        ("i mel-40 dB 512/160 bf16 Gauss", 512, 160, SR, mel40, "decibels", "none", None,
         "bf16", True, (32, 160000), "db"),
        ("j linear identity power 1024/256 bf16x2", 1024, 256, SR, "identity", "power",
         "none", None, "bf16x2", False, (8, 160000), "power"),
        ("k chroma 4096/1024 pre_amp=magnitude 44.1 kHz bf16 Gauss", 4096, 1024, 44100.0,
         chroma_filterbank(44100.0, 4096, tg.ChromaParams()), "power", "magnitude", None,
         "bf16", True, (8, 220500), "power"),
        # dense ERB rows read every power entry: nothing is skipped. In dB:
        # a low ERB row takes most of its power from one bin, and one bf16
        # rounding of that bin's power that the two f32 sums (the kernel's
        # mma, the plain version's GEMM) send to neighbouring values moves
        # the row by 3.0e-3 of its power (0.013 dB), over TWIN_RTOL
        ("o ERB-128 dB 1024/256 bf16 Gauss (dense rows)", 1024, 256, SR,
         erb_filterbank(SR, 1024, tg.ErbParams(128, 50.0, 8000.0))[0], "decibels", "none",
         None, "bf16", True, (8, 160000), "db"),
        # the staged span's edges: hop 160 on an odd length, frames from 0
        ("p mel-128 dB 1024/160 centre=False, odd length 160001, bf16 Gauss", 1024, 160, SR,
         mel128, "decibels", "none", None, "bf16", True, (8, 160001), "db"),
        ("q chroma 4096/1024 pre_amp=magnitude 44.1 kHz bf16x2 Gauss", 4096, 1024, 44100.0,
         chroma_filterbank(44100.0, 4096, tg.ChromaParams()), "power", "magnitude", None,
         "bf16x2", True, (8, 220500), "power"),
        # hop 4096 at n_fft 4096: the span does not fit beside the rest of the
        # block, so the kernel reads its samples through L1
        ("r chroma 4096/4096 pre_amp=magnitude 44.1 kHz bf16 Gauss (span not staged)", 4096,
         4096, 44100.0, chroma_filterbank(44100.0, 4096, tg.ChromaParams()), "power",
         "magnitude", None, "bf16", True, (4, 220500), "power"),
    ]
    # cases o to r draw from their own seed, so that the later phases'
    # inputs stay those of the runs recorded before them
    tier_edge_rng = np.random.default_rng(SEED + 4)
    tier_flagship_err, tier_bad = None, []
    for (name, n_fft, hop, sr, mapping, amp, pre_amp, dct, prec, gauss, (b, n),
         kind) in tier_cases:
        centre = not name.startswith("p ")
        win = hann(n_fft)
        fb = np.eye(n_fft // 2 + 1) if isinstance(mapping, str) else mapping
        run = ff.fused_factored_features(
            n_fft, hop, tuple(win.tolist()),
            mapping if isinstance(mapping, str) else ff.KernelConst(mapping),
            amp=amp, floor_db=-80.0, centre=centre,
            dct_key=None if dct is None else ff.KernelConst(dct),
            pre_amp=pre_amp, device=str(dev), precision=prec, gauss=gauss,
        )
        f32 = dict(dtype=torch.float32, device=dev)
        x = torch.from_numpy(signal(tier_edge_rng if name[0] in "opqr" else rng2, b, n, sr)).to(dev)
        before = ff.fused_tier_features.launches
        out = run(x)
        consts = ff.tier_constants(n_fft, win, fb, dct, prec, gauss, dev)
        ref = ff.fused_tier_features_reference(x, consts, amp, -80.0, pre_amp, centre, hop)
        exact = ff.fused_features_reference(
            x, torch.tensor(win, **f32), torch.tensor(fb, **f32), amp, -80.0,
            pre_amp, None if dct is None else torch.tensor(dct, **f32), centre, n_fft, hop,
        )
        torch.cuda.synchronize()
        nf = frame_count(n, n_fft, hop, centre)
        expect = (b, fb.shape[0] if dct is None else dct.shape[1], nf)
        if tuple(out.shape) != expect or not bool(torch.isfinite(out).all()):
            fail(f"[3 {name}] shape {tuple(out.shape)} (want {expect}) or non-finite")
        if ff.fused_tier_features.launches != before + 1:
            fail(f"[3 {name}] the tier kernel was not launched")
        reading, limit, ok, what = twin_err(out, ref, kind)
        abs_err = float((out - ref).abs().max())
        xerr, xlimit, xok = tier_err(out, exact, kind, prec)
        perr = tier_err(ref, exact, kind, prec)[0]
        dom = " in power" if kind == "db" else ""
        print(f"[3 tier kernel] {name}: vs plain {what} {reading:.3e} (limit {limit:g}), "
              f"max|err| {abs_err:.3e}; vs f32 exact max|err|{dom} {xerr:.3e} (plain vs "
              f"exact {perr:.3e}; limit {xlimit:.3e}, "
              f"{MFCC_TIER_LIMITS[prec] if kind == 'mfcc' else TIER_LIMITS[prec]:g}"
              f"*max|ref|) {'ok' if ok and xok else 'FAIL'}")
        if not (ok and xok):
            tier_bad.append(name)
        if tier_flagship_err is None:
            tier_flagship_err = abs_err
        del x, out, ref, exact
    if tier_bad:
        fail(f"tier kernel outside its limits at {', '.join(tier_bad)}")

    # ---- 4. the flagship path, through the entry points ------------------
    mel_p = tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY)
    kw = dict(mel_params=mel_p, mfcc_params=tg.MfccParams(40, include_c0=True, lifter=22),
              log_params=tg.LogParams(-80.0), dtype="float32")
    plan = tg.MfccPlan(tg.StftParams(1024, 256), SR, **kw)          # auto, cuda
    if plan.method != "pallas":
        fail(f"auto picked {plan.method!r} for the flagship plan, not the kernel")
    xb = torch.from_numpy(signal(rng, 32, 160000, SR)).to(dev)
    ff.fused_factored_features.launches = 0
    ff.fused_tier_features.launches = 0
    with torch.no_grad():
        y = plan.compute_batch(xb)
    torch.cuda.synchronize()
    launches = ff.fused_factored_features.launches
    if launches < 1 or ff.fused_tier_features.launches != 0:
        fail("the flagship compute_batch did not launch the f32 kernel alone")
    if tuple(y.shape) != (32, 40, 626) or not bool(torch.isfinite(y).all()):
        fail(f"flagship output shape {tuple(y.shape)} or non-finite values")
    matmul_plan = tg.MfccPlan(tg.StftParams(1024, 256), SR, **kw, method="matmul")
    ref = matmul_plan.compute_batch(xb)
    err = float((y - ref).abs().max())
    limit = 5e-3 * float(ref.abs().max())  # the JAX package's kernel tolerance
    print(f"[4 flagship] MfccPlan.compute_batch (32, 160000) -> {tuple(y.shape)}, "
          f"{launches} launch(es); vs method='matmul' max|err| {err:.3e} "
          f"(limit {limit:.3e}) {'ok' if err <= limit else 'FAIL'} (recorded: 4.883e-03)")
    if err > limit:
        fail("flagship kernel route disagrees with the matmul route")

    sib = tg.SpectrogramPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), SR),
                             tg.FreqScale.MEL, tg.AmpScale.DECIBELS, scale_params=mel_p,
                             log_params=tg.LogParams(-80.0), dtype="float32")
    ff.fused_factored_features.launches = 0
    with torch.no_grad():
        ys = sib.compute_batch(xb)
    torch.cuda.synchronize()
    sib_launches = ff.fused_factored_features.launches
    sref = tg.SpectrogramPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), SR),
                              tg.FreqScale.MEL, tg.AmpScale.DECIBELS, scale_params=mel_p,
                              log_params=tg.LogParams(-80.0), dtype="float32",
                              method="matmul").compute_batch(xb)
    serr = float((ys - sref).abs().max())
    print(f"[4 sibling] mel-dB SpectrogramPlan.compute_batch -> {tuple(ys.shape)}, "
          f"{sib_launches} launch(es); vs matmul max|err| {serr:.3e} dB (limit 2e-2) "
          f"(recorded: 4.807e-04)")
    if sib.method != "pallas" or sib_launches < 1 or serr > 2e-2:
        fail("mel-dB sibling did not take the kernel or disagrees with matmul")
    del ys, sref, ref

    # The serving tiers through the same entry points, on the same batch.
    highest = dict(method="matmul", precision=tg.Precision.HIGHEST)
    exact_mfcc = tg.MfccPlan(tg.StftParams(1024, 256), SR, **kw, **highest).compute_batch(xb)
    tier_plans = {}
    for label, prec, desc, kwargs in (
            ("bf16", "bf16", "precision=DEFAULT", dict(precision=tg.Precision.DEFAULT)),
            ("bf16x2", "bf16x2", "method='pallas:x2'", dict(method="pallas:x2"))):
        tplan = tg.MfccPlan(tg.StftParams(1024, 256), SR, **kw, **kwargs)
        ff.fused_factored_features.launches = 0
        ff.fused_tier_features.launches = 0
        with torch.no_grad():
            yt = tplan.compute_batch(xb)
        torch.cuda.synchronize()
        t_launches = ff.fused_tier_features.launches
        f_launches = ff.fused_factored_features.launches
        if label == "bf16":
            tier_launches = t_launches
            default_plan = tplan
        else:
            x2_plan = tplan
        terr, tlim, tok = tier_err(yt, exact_mfcc, "mfcc", prec)
        print(f"[4 flagship {label}] MfccPlan({desc}) "
              f"method {tplan.method!r} compute_batch -> {tuple(yt.shape)}, tier kernel "
              f"{t_launches} launch(es), f32 kernel {f_launches}; vs HIGHEST matmul max|err| "
              f"{terr:.3e} (limit {tlim:.3e}) {'ok' if tok else 'FAIL'}")
        if t_launches < 1 or f_launches != 0 or tuple(yt.shape) != (32, 40, 626) or not tok:
            fail(f"the {label} flagship did not run the tier kernel alone, or disagrees")
    del yt, exact_mfcc

    # The tier ordering on the flagship's mel power (TestBf16x2Tier's).
    def mel_power(**kwargs):
        return tg.SpectrogramPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), SR),
                                  tg.FreqScale.MEL, tg.AmpScale.POWER, scale_params=mel_p,
                                  dtype="float32", **kwargs)

    with torch.no_grad():
        pref = mel_power(**highest).compute_batch(xb)
        scale = float(pref.abs().max())
        e1, e2, e3 = (
            float((mel_power(**k).compute_batch(xb) - pref).abs().max()) / scale
            for k in (dict(precision=tg.Precision.DEFAULT), dict(method="pallas:x2"),
                      dict(precision=tg.Precision.HIGH)))
    order_ok = e3 < e2 < e1 and e2 < e1 / 2 and e2 < TIER_LIMITS["bf16x2"] and e1 < TIER_LIMITS["bf16"]
    print(f"[4 tier ordering] mel-128 power (32, 160000) vs HIGHEST matmul, max|err|/max: "
          f"bf16 {e1:.3e}, bf16x2 {e2:.3e}, HIGH (f32 kernel) {e3:.3e}; need e3 < e2 < e1, "
          f"e2 < e1/2, e2 < 2e-3, e1 < 5e-3: {'ok' if order_ok else 'FAIL'}")
    if not order_ok:
        fail("the tiers do not order")
    del pref

    # ChromaPlan, the kernel's other caller, on the suite's chroma batch:
    # 64 clips of 5 s of white noise at 44.1 kHz (benchmarks/suite.py,
    # config 4). Each frame is L2-normalized over its 12 classes, so its
    # error is relative to its own chroma energy; noise keeps that a steady
    # share of the frame's energy, where a loud tone above the bank's
    # 4186 Hz would not.
    sr44 = 44100.0
    xc = torch.from_numpy(rng2.standard_normal((64, 220500)).astype(np.float32)).to(dev)
    chroma_ref = tg.ChromaPlan(tg.StftParams(4096, 1024), sr44, dtype="float32",
                               method="matmul").compute_batch(xc)
    chroma_plans = {}
    for label, prec, counter, limit in (
            ("HIGH", None, ff.fused_factored_features, 1e-4),
            ("DEFAULT", tg.Precision.DEFAULT, ff.fused_tier_features, TIER_LIMITS["bf16"])):
        cplan = tg.ChromaPlan(tg.StftParams(4096, 1024), sr44, dtype="float32", precision=prec)
        chroma_plans[label] = cplan
        ff.fused_factored_features.launches = 0
        ff.fused_tier_features.launches = 0
        with torch.no_grad():
            yc = cplan.compute_batch(xc)
        torch.cuda.synchronize()
        cerr = float((yc - chroma_ref).abs().max())
        clim = limit * float(chroma_ref.abs().max())
        c_ok = (counter.launches >= 1 and tuple(yc.shape) == (64, 12, 216)
                and ff.fused_factored_features.launches + ff.fused_tier_features.launches
                == counter.launches and cerr <= clim)
        print(f"[4 chroma {label}] ChromaPlan(4096/1024, 44.1 kHz).compute_batch (64, 220500) "
              f"-> {tuple(yc.shape)}, {counter.__name__} {counter.launches} launch(es); vs "
              f"method='matmul' max|err| {cerr:.3e} (limit {clim:.3e}) {'ok' if c_ok else 'FAIL'}")
        if not c_ok:
            fail(f"the {label} chroma batch did not take its kernel, or disagrees")
    del yc, chroma_ref

    # ---- 5. gradient ----------------------------------------------------
    xs = torch.from_numpy(signal(rng, 2, 16000, SR)).to(dev).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((2, 40, 63)).astype(np.float32)).to(dev)
    (plan.compute_batch(xs) * w).sum().backward()
    xt = xs.detach().clone().requires_grad_(True)
    (plan._plain_forward(xt) * w).sum().backward()
    gerr = float((xs.grad - xt.grad).abs().max())
    glim = 1e-5 * float(xt.grad.abs().max())
    print(f"[5 gradient] kernel route vs autograd through the plain path: "
          f"max|err| {gerr:.3e} (limit {glim:.3e}) {'ok' if gerr <= glim else 'FAIL'} "
          f"(recorded: 0.000e+00)")
    if gerr > glim:
        fail("gradient through the kernel route differs from the plain path's")
    xs2 = xs.detach().clone().requires_grad_(True)
    (default_plan.compute_batch(xs2) * w).sum().backward()
    gerr2 = float((xs2.grad - xt.grad).abs().max())
    print(f"[5 gradient bf16] precision=DEFAULT route vs autograd through the f32 plain "
          f"path: max|err| {gerr2:.3e} (limit {glim:.3e}) {'ok' if gerr2 <= glim else 'FAIL'}")
    if gerr2 > glim:
        fail("gradient through the tier kernel route differs from the plain path's")

    # ---- 6. times at the flagship shape ---------------------------------
    mel_t = torch.tensor(mel128, dtype=torch.float32, device=dev)
    dct_t = torch.tensor(dct40, dtype=torch.float32, device=dev)
    win_t = torch.tensor(hann(1024), dtype=torch.float32, device=dev)
    eps = 10.0 ** (-80.0 / 10.0)

    def plain():
        return ff.fused_features_reference(xb, win_t, mel_t, "decibels", -80.0, "none",
                                           dct_t, True, 1024, 256)

    def library():
        # One chain of PyTorch calls computing the same function: the
        # yardstick only, never called by the port.
        s = torch.stft(xb, 1024, 256, window=win_t, center=True, pad_mode="constant",
                       return_complex=True)
        p = s.abs() ** 2
        return torch.matmul(dct_t.T, 10.0 * torch.log10(torch.clamp_min(mel_t @ p, eps)))

    with torch.no_grad():
        lib_err = float((library() - y).abs().max())
        kernel_ms, kernel_p90 = time_ms(lambda: plan._kernel_run(xb))
        plain_ms, plain_p90 = time_ms(plain)
        library_ms, library_p90 = time_ms(library)
        batch_ms, batch_p90 = time_ms(lambda: plan.compute_batch(xb))
        matmul_ms, matmul_p90 = time_ms(lambda: matmul_plan.compute_batch(xb))
        batch_host = host_us(lambda: plan.compute_batch(xb))
        kernel_host = host_us(lambda: plan._kernel_run(xb))
    audio_s = 32 * 160000 / SR
    # Bound: each input read once, the output written once; operations per
    # frame counting the DFT as a real FFT (2.5 N log2 N), the mel product
    # over each row's nonzero band (what this mapping needs), the DCT dense.
    bands = ff.mapping_bands(mel128)
    band_total = int((bands[:, 1] - bands[:, 0]).sum())
    batch, n_frames = xb.shape[0], y.shape[-1]
    (n_out, n_bins), n_coef = mel128.shape, dct40.shape[1]
    n_fft = 2 * (n_bins - 1)
    # signal + output + window, twiddles, mapping, DCT and bands (all 4-byte)
    bytes_moved = 4 * (xb.numel() + y.numel() + 2 * n_fft + mel128.size + dct40.size
                       + 2 * n_out)
    flops = batch * n_frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_bins
                                + 2 * band_total + n_out + 2 * n_out * n_coef)
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[6 times] {card} | median/p90 of 100: kernel {kernel_ms:.4f}/{kernel_p90:.4f} ms, "
          f"plain {plain_ms:.4f}/{plain_p90:.4f} ms, library {library_ms:.4f}/{library_p90:.4f} ms "
          f"(vs kernel max|diff| {lib_err:.3e}), compute_batch {batch_ms:.4f}/{batch_p90:.4f} ms, "
          f"method='matmul' compute_batch {matmul_ms:.4f}/{matmul_p90:.4f} ms "
          f"| host per call (median): compute_batch {batch_host:.1f} us, kernel wrapper "
          f"{kernel_host:.1f} us | {audio_s / (kernel_ms / 1e3):.0f} audio-s/s "
          f"kernel, {audio_s / (batch_ms / 1e3):.0f} audio-s/s compute_batch | bound "
          f"{bound_ms * 1e3:.2f} us ({bytes_moved / 1e6:.2f} MB -> {bytes_ms * 1e3:.2f} us, "
          f"{flops / 1e9:.3f} GFLOP -> {ops_ms * 1e3:.2f} us; mel band bins {band_total})")

    # The tier kernel at the flagship shape, at 1 pass (the DEFAULT plan's
    # runner) and at x2; its plain version and a PyTorch-call chain at each.
    bf16 = torch.bfloat16
    consts1 = ff.tier_constants(1024, hann(1024), mel128, dct40, "bf16", True, dev)
    consts2 = ff.tier_constants(1024, hann(1024), mel128, dct40, "bf16x2", False, dev)

    def split16(t):
        hi = t.to(bf16)
        return hi, (t - hi.float()).to(bf16)

    cs2 = split16(torch.cat(rdft_matrices(1024, hann(1024), torch.float32, dev), dim=1))
    mel2, dct2 = split16(mel_t.T.contiguous()), split16(dct_t)

    def passes(a, b, n):
        # dot3's first n products (a_h b_h, a_h b_l, a_l b_h) as bf16 GEMMs
        a_hi = a.to(bf16)
        out = (a_hi @ b[0]).float()
        if n > 1:
            out = out + (a_hi @ b[1]).float()
        if n > 2:
            out = out + ((a - a_hi.float()).to(bf16) @ b[0]).float()
        return out

    def tier_chain(outer, tail):
        # frames @ bf16 [C|S] -> power -> bf16 mel -> dB -> bf16 DCT, each
        # product in the tier's passes: the yardstick only, never called by
        # the port. PyTorch's bf16 GEMM rounds its output to bf16, so at x2
        # the chain does the tier's work without reaching its accuracy.
        fr = F.pad(xb, (512, 512)).unfold(-1, 1024, 256)
        re, im = passes(fr, cs2, outer).chunk(2, dim=-1)
        mel = passes(re * re + im * im, mel2, tail)
        db = 10.0 * torch.log10(torch.clamp_min(mel, eps))
        return passes(db, dct2, tail).transpose(-1, -2)

    tier1, tier2 = default_plan._kernel_run, x2_plan._kernel_run
    with torch.no_grad():
        tier_lib_err = float((tier_chain(1, 1) - tier1(xb)).abs().max())
        t1_ms, t1_p90 = time_ms(lambda: tier1(xb))
        t2_ms, t2_p90 = time_ms(lambda: tier2(xb))
        tplain_ms, tplain_p90 = time_ms(lambda: ff.fused_tier_features_reference(
            xb, consts1, "decibels", -80.0, "none", True, 256))
        tplain2_ms, tplain2_p90 = time_ms(lambda: ff.fused_tier_features_reference(
            xb, consts2, "decibels", -80.0, "none", True, 256))
        tlib_ms, tlib_p90 = time_ms(lambda: tier_chain(1, 1))
        tlib2_ms, tlib2_p90 = time_ms(lambda: tier_chain(2, 3))
        tbatch_ms, tbatch_p90 = time_ms(lambda: default_plan.compute_batch(xb))
        tbatch_host = host_us(lambda: default_plan.compute_batch(xb))

    def tier_bound(precision, gauss, n_fft, mapping, n_coef, frames, in_bytes, out_bytes, pre,
                   dense=False):
        """(bound ms, bytes ms, ops ms): bytes of signal, output and the
        constants the kernel reads, once; tensor-core MACs of the tier at
        the bf16 rate plus the f32 work outside them at the f32 rate. The
        outer DFT counts the 8-column n-tiles that a mapping row reads (the
        kernel computes no other; ``dense``: every n-tile, as the first
        design's bound counted), the filterbank its nonzeros in the folded layout, the DCT
        dense."""
        r = n_fft // 128
        cc, kp = r // 2 - 1, (r // 2 + 1) * 128
        n_out = mapping.shape[0]
        map_nnz = int(np.count_nonzero(fl.fold_mapping(mapping, n_fft)))
        ntiles = [range(16)] * (r // 2 + 1) if dense else tl.class_ntiles(mapping, n_fft)
        real_nt = len(ntiles[0]) + len(ntiles[r // 2])
        cplx_nt = sum(len(ntiles[c]) for c in range(1, r // 2))
        cplx_cols = len(set().union(*map(set, ntiles[1:r // 2]))) if cc else 0
        outer, tail = (2, 3) if precision == "bf16x2" else (1, 1)
        words = 2 if precision == "bf16x2" else 1
        per_nt = 3 * 128 * 8 if gauss else 256 * 16     # complex MACs a frame an n-tile
        const_bytes = (12 * n_fft + 2 * words * (128 * 16 * real_nt + per_nt * cplx_cols
                                                 + map_nnz + n_out * n_coef))
        macs = (outer * (128 * 16 * real_nt + per_nt * cplx_nt)
                + tail * (map_nnz + n_out * n_coef))
        # window; the inner DFT counted as real FFTs over the chunk axis;
        # twiddles; Gauss sums; |X|^2 (and sqrt) of the entries computed;
        # the amplitude scale
        computed = 8 * (real_nt + cplx_nt)
        simt = (n_fft + 128 * 2.5 * r * math.log2(r) + 6 * 128 * cc
                + (3 * 128 * cc if gauss else 0) + (4 if pre else 3) * computed + n_out)
        b_ms = (in_bytes + out_bytes + const_bytes) / H100_BYTES_PER_S * 1e3
        o_ms = frames * (2 * macs / H100_BF16_FLOPS + simt / H100_F32_FLOPS) * 1e3
        return max(b_ms, o_ms), b_ms, o_ms

    flag_args = (1024, mel128, 40, batch * n_frames, 4 * xb.numel(), 4 * y.numel(), False)
    tb1, tb1_bytes, tb1_ops = tier_bound("bf16", True, *flag_args)
    tb2, tb2_bytes, tb2_ops = tier_bound("bf16x2", False, *flag_args)
    tb1_dense = tier_bound("bf16", True, *flag_args, dense=True)[0]
    tb2_dense = tier_bound("bf16x2", False, *flag_args, dense=True)[0]
    print(f"[6 times bf16] {card} | median/p90 of 100: tier kernel 1-pass {t1_ms:.4f}/{t1_p90:.4f} ms, "
          f"x2 {t2_ms:.4f}/{t2_p90:.4f} ms, plain 1-pass {tplain_ms:.4f}/{tplain_p90:.4f} ms, "
          f"x2 {tplain2_ms:.4f}/{tplain2_p90:.4f} ms, bf16 library chain 1-pass "
          f"{tlib_ms:.4f}/{tlib_p90:.4f} ms (vs kernel max|diff| {tier_lib_err:.3e}), x2 "
          f"{tlib2_ms:.4f}/{tlib2_p90:.4f} ms, precision=DEFAULT compute_batch "
          f"{tbatch_ms:.4f}/{tbatch_p90:.4f} ms | host per compute_batch {tbatch_host:.1f} us "
          f"| {audio_s / (t1_ms / 1e3):.0f} audio-s/s 1-pass kernel | bound 1-pass "
          f"{tb1 * 1e3:.2f} us (bytes {tb1_bytes * 1e3:.2f} us, operations {tb1_ops * 1e3:.2f} "
          f"us), x2 {tb2 * 1e3:.2f} us ({'bytes' if tb2_bytes >= tb2_ops else 'operations'}); "
          f"the outer DFT counted dense: {tb1_dense * 1e3:.2f} and "
          f"{tb2_dense * 1e3:.2f} us")

    # The chroma batch through each kernel, with a yardstick each.
    hplan, dplan = chroma_plans["HIGH"], chroma_plans["DEFAULT"]
    fb44 = chroma_filterbank(sr44, 4096, tg.ChromaParams())
    fb44_t = torch.tensor(fb44, dtype=torch.float32, device=dev)
    win4 = torch.tensor(hann(4096), dtype=torch.float32, device=dev)
    cs4 = torch.cat(rdft_matrices(4096, hann(4096), torch.float32, dev), dim=1).to(bf16)
    fb44_16 = fb44_t.T.contiguous().to(bf16)

    # the tier kernel at x2 on the chroma shape, beside the f32 kernel
    chroma_x2 = ff.fused_factored_features(
        4096, 1024, tuple(hann(4096).tolist()), ff.KernelConst(fb44), amp="power",
        pre_amp="magnitude", device=str(dev), precision="bf16x2")

    def chroma_library():
        s = torch.stft(xc, 4096, 1024, window=win4, center=True, pad_mode="constant",
                       return_complex=True)
        return fb44_t @ s.abs()

    def chroma_library_bf16():
        fr = F.pad(xc, (2048, 2048)).unfold(-1, 4096, 1024).to(bf16)
        re, im = (fr @ cs4).float().chunk(2, dim=-1)
        return (torch.sqrt(re * re + im * im).to(bf16) @ fb44_16).float().transpose(-1, -2)

    cs4_2 = split16(torch.cat(rdft_matrices(4096, hann(4096), torch.float32, dev), dim=1))
    fb44_2 = split16(fb44_t.T.contiguous())

    def chroma_library_bf16x2():
        # the x2 tier's passes: 2 on the DFT, 3 on the filterbank
        fr = F.pad(xc, (2048, 2048)).unfold(-1, 4096, 1024)
        re, im = passes(fr, cs4_2, 2).chunk(2, dim=-1)
        return passes(torch.sqrt(re * re + im * im), fb44_2, 3).transpose(-1, -2)

    c_consts1 = ff.tier_constants(4096, hann(4096), fb44, None, "bf16", True, dev)
    c_consts2 = ff.tier_constants(4096, hann(4096), fb44, None, "bf16x2", False, dev)
    with torch.no_grad():
        c32_ms, c32_p90 = time_ms(lambda: hplan._kernel_run(xc))
        c16_ms, c16_p90 = time_ms(lambda: dplan._kernel_run(xc))
        c2_ms, c2_p90 = time_ms(lambda: chroma_x2(xc))
        cplain_ms, cplain_p90 = time_ms(lambda: ff.fused_features_reference(
            xc, win4, fb44_t, "power", -80.0, "magnitude", None, True, 4096, 1024))
        ctplain_ms, ctplain_p90 = time_ms(lambda: ff.fused_tier_features_reference(
            xc, c_consts1, "power", -80.0, "magnitude", True, 1024))
        ctplain2_ms, ctplain2_p90 = time_ms(lambda: ff.fused_tier_features_reference(
            xc, c_consts2, "power", -80.0, "magnitude", True, 1024))
        clib_ms, clib_p90 = time_ms(chroma_library)
        clib16_ms, clib16_p90 = time_ms(chroma_library_bf16)
        clib162_ms, clib162_p90 = time_ms(chroma_library_bf16x2)
    c_frames = xc.shape[0] * 216
    c_io = (4 * xc.numel(), 4 * xc.shape[0] * 12 * 216)
    by = lambda b: "bytes" if b[1] >= b[2] else "operations"  # what sets a bound
    cb16_t = tier_bound("bf16", True, 4096, fb44, 0, c_frames, *c_io, True)
    cb16x2_t = tier_bound("bf16x2", False, 4096, fb44, 0, c_frames, *c_io, True)
    cb16, cb16x2 = cb16_t[0], cb16x2_t[0]
    cb16_dense = tier_bound("bf16", True, 4096, fb44, 0, c_frames, *c_io, True, dense=True)[0]
    c_bands = ff.mapping_bands(fb44)
    c_band_total = int((c_bands[:, 1] - c_bands[:, 0]).sum())
    c_bytes = (sum(c_io) + 4 * (3 * 4096 + fb44.size + 2 * 12)) / H100_BYTES_PER_S * 1e3
    c_ops = c_frames * (4096 + 2.5 * 4096 * 12 + 4 * 2049 + 2 * c_band_total) / H100_F32_FLOPS * 1e3
    cb32 = max(c_bytes, c_ops)
    print(f"[6 times chroma] {card} | (64, 220500) 4096/1024 44.1 kHz, median/p90 of 100: "
          f"f32 kernel {c32_ms:.4f}/{c32_p90:.4f} ms (bound {cb32 * 1e3:.2f} us, "
          f"{by((cb32, c_bytes, c_ops))}; plain "
          f"{cplain_ms:.4f}/{cplain_p90:.4f} ms), tier kernel 1-pass {c16_ms:.4f}/{c16_p90:.4f} "
          f"ms (bound {cb16 * 1e3:.2f} us, {by(cb16_t)}; outer DFT counted dense "
          f"{cb16_dense * 1e3:.2f} us; plain "
          f"{ctplain_ms:.4f}/{ctplain_p90:.4f} ms), x2 {c2_ms:.4f}/{c2_p90:.4f} ms (bound "
          f"{cb16x2 * 1e3:.2f} us, {by(cb16x2_t)}; plain {ctplain2_ms:.4f}/{ctplain2_p90:.4f} "
          f"ms), library chain "
          f"f32 {clib_ms:.4f}/{clib_p90:.4f} ms, bf16 {clib16_ms:.4f}/{clib16_p90:.4f} ms, bf16 "
          f"at x2 {clib162_ms:.4f}/{clib162_p90:.4f} ms | tier 1-pass vs the f32 chain: "
          f"{'faster' if c16_ms < clib_ms else 'SLOWER'}")

    phase7_rates = serving_phase(tg, ff, dev, card, tier_bound)

    # ---- 8. the spectrogram-family surface ------------------------------
    # First the packed product of the 1-pass tier (K1e: method="pallas:dif"
    # at DEFAULT) at the flagship, with its bound and its chain (the bf16
    # chain of the 1-pass tier computes the same function).
    packed_plan = tg.MfccPlan(tg.StftParams(1024, 256), SR, **kw, method="pallas:dif",
                              precision=tg.Precision.DEFAULT)
    ff.fused_factored_features.launches = 0
    ff.fused_tier_features.launches = 0
    with torch.no_grad():
        yp = packed_plan.compute_batch(xb)
    torch.cuda.synchronize()
    p_launches = (ff.fused_factored_features.launches, ff.fused_tier_features.launches)
    with torch.no_grad():
        exact_mfcc = tg.MfccPlan(tg.StftParams(1024, 256), SR, **kw, **highest).compute_batch(xb)
        perr, plim, pok = tier_err(yp, exact_mfcc, "mfcc", "bf16")
        packed_ms, packed_p90 = time_ms(lambda: packed_plan._kernel_run(xb))
        packed_consts = ff.tier_constants(1024, hann(1024), mel128, dct40, "bf16", False, dev)
        packed_plain = time_ms(lambda: ff.fused_tier_features_reference(
            xb, packed_consts, "decibels", -80.0, "none", True, 256))[0]
    pb, pb_bytes, pb_ops = tier_bound("bf16", False, *flag_args)
    print(f"[8 K1e packed] {card} | MfccPlan(method='pallas:dif', precision=DEFAULT) "
          f"kernel kwargs {packed_plan._kernel_plan._kernel_kwargs}, launches f32 {p_launches[0]} "
          f"tier {p_launches[1]}; vs HIGHEST matmul max|err| {perr:.3e} (limit {plim:.3e}); "
          f"median/p90 of 100 {packed_ms:.4f}/{packed_p90:.4f} ms, bound {pb * 1e3:.2f} us "
          f"({'bytes' if pb_bytes >= pb_ops else 'operations'}), plain {packed_plain:.4f} ms, "
          f"bf16 chain {tlib_ms:.4f} ms "
          f"{'ok' if pok and p_launches == (0, 1) else 'FAIL'}")
    if not pok or p_launches != (0, 1):
        fail("the packed 1-pass form did not run the tier kernel alone, or disagrees")
    del yp, exact_mfcc
    surface_phase(tg, ff, dev, card, xb, tier_bound)
    del xb
    config4_phase(tg, ff, dev, card)
    fft_image_phase(tg, ff, dev, card)
    tuning_parallel_phase(tg, ff, dev, card, phase7_rates)

    print(json.dumps({"kernels": [{
        "name": "fused_features",
        "route": "cuda",
        "source": "spectrograms_tpu_torch/csrc/fused_features.cu",
        "replaces": "spectrograms_tpu/ops/pallas_factored.py:230",
        "launches": launches,
        "max_abs_err": flagship_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }, {
        "name": "fused_tier_features",
        "route": "cuda",
        "source": "spectrograms_tpu_torch/csrc/fused_tier_features.cu",
        "replaces": "spectrograms_tpu/ops/pallas_factored.py:230",
        "launches": tier_launches,
        "max_abs_err": tier_flagship_err,
        "ms": t1_ms,
        "plain_ms": tplain_ms,
        "bound_ms": tb1,
        "bound_by": "bytes" if tb1_bytes >= tb1_ops else "operations",
        "library_ms": tlib_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
