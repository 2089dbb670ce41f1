#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build, check and time its kernel.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one line (any failure exits non-zero, nothing is
caught):

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. build of ``spectrograms_tpu_torch/csrc/fused_features.cu`` (seconds,
   ptxas registers/spills);
3. the fused kernel against its plain PyTorch version on the card, same
   inputs from a numpy seed, at five geometries;
4. the flagship path: ``MfccPlan.compute_batch`` on a (32, 160000) f32
   batch with ``method="auto"``, launch counter and shape checked, compared
   with the same plan under ``method="matmul"``; then the mel-dB sibling;
5. the gradient through the kernel route against autograd through the
   plain path;
6. times at the flagship shape (CUDA events, median and p90 of 100 after
   warm-up, L2 flushed before each run): kernel, plain version, a PyTorch-call
   yardstick, the whole ``compute_batch`` and the ``method="matmul"``
   route; the host time of one ``compute_batch`` and of one kernel-wrapper
   call; and the kernel's bound;
7. the ``kernels`` JSON line, the card line, and the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero, printing no result, when CUDA is unavailable. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, H100 SXM data sheet
SR = 16000.0
SEED = 20261016


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
    caller hands the kernel a new batch each time."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs one GPU")
    import spectrograms_tpu_torch as tg
    from spectrograms_tpu_torch.mfcc import _dct_lifter_matrix
    from spectrograms_tpu_torch.ops import _build
    from spectrograms_tpu_torch.ops import fused_factored as ff
    from spectrograms_tpu_torch.ops.filterbanks import chroma_filterbank, mel_filterbank
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
    t0 = time.perf_counter()
    _build.load_library("fused_features", ff._SIGNATURES)
    seconds, log = _build.build_log.get("fused_features", (0.0, "(already built)"))
    ptxas = " ".join(
        line.split(":", 1)[-1].strip() for line in log.splitlines()
        if "registers" in line or "spill" in line
    )
    print(f"[2 build] fused_features.cu sm_90a in {seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s) | {ptxas}")

    # ---- 3. kernel against its plain version, on the card ---------------
    rng = np.random.default_rng(SEED)
    hann = lambda n: tg.make_window(tg.WindowType.hanning, n)
    mel128 = mel_filterbank(SR, 1024, tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY))
    dct40 = _dct_lifter_matrix(128, 40, 22)

    def db_tol(out, ref):
        # Both sides f32; they differ in summation order only (radix-2 in
        # shared memory vs cuFFT, loops vs GEMM): ~1e-6 relative in power,
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

    cases = [
        # name, n_fft, hop, sr, mapping (n_out, n_bins) | "identity", amp,
        # pre_amp, dct, (batch, n), tolerance
        ("a flagship MFCC 1024/256 mel-128 dB DCT-40", 1024, 256, SR, mel128,
         "decibels", "none", dct40, (32, 160000), mfcc_tol),
        ("b mel-128 dB 1024/256", 1024, 256, SR, mel128,
         "decibels", "none", None, (32, 160000), db_tol),
        ("c mel-40 dB 512/160 (frames-input geometry)", 512, 160, SR,
         mel_filterbank(SR, 512, tg.MelParams(40, 0.0, 8000.0, tg.MelNorm.SLANEY)),
         "decibels", "none", None, (32, 160000), db_tol),
        ("d linear identity power 1024/256", 1024, 256, SR, "identity",
         "power", "none", None, (8, 160000), power_tol),
        ("e chroma 4096/1024 pre_amp=magnitude power", 4096, 1024, 22050.0,
         chroma_filterbank(22050.0, 4096, tg.ChromaParams()),
         "power", "magnitude", None, (8, 220500), power_tol),
    ]
    flagship_err = None
    for name, n_fft, hop, sr, mapping, amp, pre_amp, dct, (b, n), tol in cases:
        win = hann(n_fft)
        run = ff.fused_factored_features(
            n_fft, hop, tuple(win.tolist()),
            mapping if isinstance(mapping, str) else ff.KernelConst(mapping),
            amp=amp, floor_db=-80.0, centre=True,
            dct_key=None if dct is None else ff.KernelConst(dct),
            pre_amp=pre_amp, device=str(dev),
        )
        fb = np.eye(n_fft // 2 + 1) if isinstance(mapping, str) else mapping
        f32 = dict(dtype=torch.float32, device=dev)
        x = torch.from_numpy(signal(rng, b, n, sr)).to(dev)
        out = run(x)
        ref = ff.fused_features_reference(
            x, torch.tensor(win, **f32), torch.tensor(fb, **f32), amp, -80.0,
            pre_amp, None if dct is None else torch.tensor(dct, **f32),
            True, n_fft, hop,
        )
        torch.cuda.synchronize()
        nf = frame_count(n, n_fft, hop, True)
        expect = (b, fb.shape[0] if dct is None else dct.shape[1], nf)
        if tuple(out.shape) != expect or not bool(torch.isfinite(out).all()):
            fail(f"[3 {name}] shape {tuple(out.shape)} (want {expect}) or non-finite")
        err, ok, limit = tol(out, ref)
        print(f"[3 kernel vs plain] {name}: max|err| {err:.3e} ({limit}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"kernel disagrees with its plain version at {name}")
        if flagship_err is None:
            flagship_err = err
        del x, out, ref

    # ---- 4. the flagship path, through the entry points ------------------
    mel_p = tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY)
    kw = dict(mel_params=mel_p, mfcc_params=tg.MfccParams(40, include_c0=True, lifter=22),
              log_params=tg.LogParams(-80.0), dtype="float32")
    plan = tg.MfccPlan(tg.StftParams(1024, 256), SR, **kw)          # auto, cuda
    if plan.method != "pallas":
        fail(f"auto picked {plan.method!r} for the flagship plan, not the kernel")
    xb = torch.from_numpy(signal(rng, 32, 160000, SR)).to(dev)
    ff.fused_factored_features.launches = 0
    with torch.no_grad():
        y = plan.compute_batch(xb)
    torch.cuda.synchronize()
    launches = ff.fused_factored_features.launches
    if launches < 1:
        fail("the flagship compute_batch did not launch the fused kernel")
    if tuple(y.shape) != (32, 40, 626) or not bool(torch.isfinite(y).all()):
        fail(f"flagship output shape {tuple(y.shape)} or non-finite values")
    matmul_plan = tg.MfccPlan(tg.StftParams(1024, 256), SR, **kw, method="matmul")
    ref = matmul_plan.compute_batch(xb)
    err = float((y - ref).abs().max())
    limit = 5e-3 * float(ref.abs().max())  # the JAX package's kernel tolerance
    print(f"[4 flagship] MfccPlan.compute_batch (32, 160000) -> {tuple(y.shape)}, "
          f"{launches} launch(es); vs method='matmul' max|err| {err:.3e} "
          f"(limit {limit:.3e}) {'ok' if err <= limit else 'FAIL'}")
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
          f"{sib_launches} launch(es); vs matmul max|err| {serr:.3e} dB (limit 2e-2)")
    if sib.method != "pallas" or sib_launches < 1 or serr > 2e-2:
        fail("mel-dB sibling did not take the kernel or disagrees with matmul")
    del ys, sref, ref

    # ---- 5. gradient ----------------------------------------------------
    xs = torch.from_numpy(signal(rng, 2, 16000, SR)).to(dev).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((2, 40, 63)).astype(np.float32)).to(dev)
    (plan.compute_batch(xs) * w).sum().backward()
    xt = xs.detach().clone().requires_grad_(True)
    (plan._plain_forward(xt) * w).sum().backward()
    gerr = float((xs.grad - xt.grad).abs().max())
    glim = 1e-5 * float(xt.grad.abs().max())
    print(f"[5 gradient] kernel route vs autograd through the plain path: "
          f"max|err| {gerr:.3e} (limit {glim:.3e}) {'ok' if gerr <= glim else 'FAIL'}")
    if gerr > glim:
        fail("gradient through the kernel route differs from the plain path's")

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
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
