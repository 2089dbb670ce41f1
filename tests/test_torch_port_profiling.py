"""The port's roofline model (``spectrograms_tpu_torch.profiling``) against
the JAX package's (``spectrograms_tpu.profiling``) on the same plans.

``task_cost`` equals JAX's at every route; ``plan_cost`` equals JAX's on the
``fft``, ``matmul`` and ``factored`` routes and on CQT plans, and on the
``pallas`` routes counts the CUDA kernel the route launches: the counts are
written out below, on small plans, as the bounds ``chip_smoke.py`` reports
for each kernel. Every comparison is to 1e-12 relative. The cases of
``tests/test_profiling.py`` follow against the H100's peaks.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu import profiling as jprof
from spectrograms_tpu_torch import profiling
from spectrograms_tpu_torch.ops.factored_layout import fold_mapping, needed_complex_k1
from spectrograms_tpu_torch.ops.filterbanks import mel_filterbank
from spectrograms_tpu_torch.ops.tier_layout import class_ntiles

H100 = profiling.CHIPS["h100-sxm"]
N = 160000
ROUTES = ["fft", "matmul", "factored", "pallas", "pallas:x2", "pallas:dif", "pallas:prune",
          "pallas:stack", "pallas:gauss"]


def _params(pkg, n_fft=1024, hop=256):
    return pkg.SpectrogramParams(pkg.StftParams(n_fft, hop), 16000.0)


def _plan(pkg, kind, method, precision=None, n_fft=1024, hop=256):
    """The same plan in either package; ``precision`` only on the port's."""
    params = _params(pkg, n_fft, hop)
    kw = dict(dtype="float32", method=method)
    if pkg is tg:
        kw.update(device="cpu", precision=precision)
    if kind == "mel_db":
        mel = pkg.MelParams(128, 0.0, 8000.0, pkg.MelNorm.SLANEY)
        return pkg.MelDbPlan(params, mel, pkg.LogParams(-80.0), **kw)
    if kind == "linear_power":
        return pkg.LinearPowerPlan(params, **kw)
    if kind == "loghz_magnitude":
        return pkg.LogHzMagnitudePlan(params, pkg.LogHzParams(64, 50.0, 8000.0), **kw)
    if kind == "erb_db":
        return pkg.ErbDbPlan(params, pkg.ErbParams(40, 50.0, 8000.0), pkg.LogParams(-80.0), **kw)
    raise AssertionError(kind)


def _cqt(pkg):
    kw = dict(device="cpu") if pkg is tg else {}
    return pkg.CqtPowerPlan(_params(pkg), pkg.CqtParams(12, 7, 32.703), dtype="float32", **kw)


def _close(a, b):
    assert math.isclose(float(a), float(b), rel_tol=1e-12, abs_tol=0.0), (a, b)


@pytest.mark.parametrize("kind", ["mel_db", "linear_power", "loghz_magnitude", "erb_db"])
@pytest.mark.parametrize("route", ROUTES)
def test_task_cost_equals_jax_at_every_route(kind, route):
    mine = profiling.task_cost(_plan(tg, kind, route), N, batch=32)
    theirs = jprof.task_cost(_plan(sg, kind, route), N, batch=32)
    _close(mine.flops, theirs.flops)
    _close(mine.bytes_hbm, theirs.bytes_hbm)
    if route.startswith("pallas") and route != "pallas:stack":  # the tiers read the same task
        dflt = profiling.task_cost(_plan(tg, kind, route, tg.Precision.DEFAULT), N, batch=32)
        assert (dflt.flops, dflt.bytes_hbm) == (mine.flops, mine.bytes_hbm)


def test_task_cost_equals_jax_on_a_cqt_plan():
    for batch in (1, 4):
        mine, theirs = profiling.task_cost(_cqt(tg), N, batch), jprof.task_cost(_cqt(sg), N, batch)
        _close(mine.flops, theirs.flops)
        _close(mine.bytes_hbm, theirs.bytes_hbm)


@pytest.mark.parametrize("kind", ["mel_db", "linear_power", "loghz_magnitude", "erb_db"])
@pytest.mark.parametrize("route", ["fft", "matmul", "factored"])
def test_plan_cost_equals_jax_off_the_kernels(kind, route):
    for batch in (1, 32):
        mine = profiling.plan_cost(_plan(tg, kind, route), N, batch)
        theirs = jprof.plan_cost(_plan(sg, kind, route), N, batch)
        for field in ("flops", "bytes_hbm", "transcendentals"):
            _close(getattr(mine, field), getattr(theirs, field))
        assert mine.f32_flops == 0.0


def test_plan_cost_equals_jax_on_a_cqt_plan():
    mine, theirs = profiling.plan_cost(_cqt(tg), N, 3), jprof.plan_cost(_cqt(sg), N, 3)
    for field in ("flops", "bytes_hbm", "transcendentals"):
        _close(getattr(mine, field), getattr(theirs, field))


def test_mfcc_plan_has_no_plan_cost_in_either_package():
    # JAX's MfccPlan has no output_shape: a reference behaviour, kept
    for pkg, prof, kw in ((sg, jprof, {}), (tg, profiling, dict(device="cpu"))):
        plan = pkg.MfccPlan(pkg.StftParams(1024, 256), 16000.0, dtype="float32", **kw)
        with pytest.raises(AttributeError):
            prof.plan_cost(plan, N)


# ---- the kernels' counts, written out -------------------------------------

def f32_counts(b, n, frames_row, n_fft, fb):
    """(flops, bytes) of csrc/fused_features.cu: signal, output, window,
    twiddles, mapping and bands once; a frame's window, real FFT, |X|^2, the
    mapping over each row's band, the amplitude scale (no DCT here)."""
    nz = fb != 0.0
    band = sum(int(np.flatnonzero(r)[-1] - np.flatnonzero(r)[0] + 1) for r in nz if r.any())
    n_out, n_bins = fb.shape
    frames = b * frames_row
    bytes_ = 4 * (b * n + b * n_out * frames_row + 2 * n_fft + fb.size + 2 * n_out)
    flops = frames * (n_fft + 2.5 * n_fft * math.log2(n_fft) + 3 * n_bins + 2 * band + n_out)
    return flops, bytes_


def tier_counts(b, n, frames_row, n_fft, fb, precision, gauss):
    """(tensor-core flops, f32 flops, bytes) of csrc/fused_tier_features.cu:
    the outer DFT over the n-tiles a folded mapping row reads, the folded
    mapping's nonzeros; the window, inner DFT, twiddles, Gauss sums, |X|^2
    and amplitude scale in f32 (no DCT here)."""
    r = n_fft // 128
    n_out = fb.shape[0]
    nt = class_ntiles(fb, n_fft)
    nnz = int(np.count_nonzero(fold_mapping(fb, n_fft)))
    real_nt = len(nt[0]) + len(nt[r // 2])
    cplx = nt[1:r // 2]
    cplx_nt, cplx_cols = sum(map(len, cplx)), len(set().union(*map(set, cplx))) if cplx else 0
    x2 = precision == "bf16x2"
    per_nt = 3 * 128 * 8 if gauss else 256 * 16
    macs = ((2 if x2 else 1) * (2048 * real_nt + per_nt * cplx_nt) + (3 if x2 else 1) * nnz)
    simt = (n_fft + 320 * r * math.log2(r) + 768 * (r // 2 - 1)
            + (384 * (r // 2 - 1) if gauss else 0) + 24 * (real_nt + cplx_nt) + n_out)
    consts = 12 * n_fft + 2 * (2 if x2 else 1) * (2048 * real_nt + per_nt * cplx_cols + nnz)
    frames = b * frames_row
    return frames * 2 * macs, frames * simt, 4 * (b * n + b * n_out * frames_row) + consts


KERNEL_ROUTES = [  # (method, precision) -> kernel, tier, Gauss form (prune: see below)
    ("pallas", tg.Precision.HIGH, "fused_features", None, None),
    ("pallas:stack", tg.Precision.HIGH, "fused_features", None, None),
    ("pallas:dif", tg.Precision.HIGH, "fused_features", None, None),
    ("pallas", tg.Precision.DEFAULT, "fused_tier_features", "bf16", True),
    ("pallas:gauss", tg.Precision.DEFAULT, "fused_tier_features", "bf16", True),
    ("pallas:dif", tg.Precision.DEFAULT, "fused_tier_features", "bf16", False),
    ("pallas:prune", tg.Precision.DEFAULT, "fused_tier_features", "bf16", False),
    ("pallas:x2", tg.Precision.DEFAULT, "fused_tier_features", "bf16x2", False),
    ("pallas:x2", tg.Precision.HIGH, "fused_tier_features", "bf16x2", False),
]


@pytest.mark.parametrize("n_fft,hop,n_mels,f_max", [(512, 128, 40, 8000.0), (256, 64, 24, 8000.0),
                                                   (1024, 256, 128, 8000.0),
                                                   (1024, 256, 32, 1500.0)])
@pytest.mark.parametrize("method,precision,kernel,tier,gauss", KERNEL_ROUTES)
def test_plan_cost_counts_the_kernel_the_route_launches(n_fft, hop, n_mels, f_max, method,
                                                        precision, kernel, tier, gauss):
    b, n = 3, 4000
    mel = tg.MelParams(n_mels, 0.0, f_max, tg.MelNorm.SLANEY)
    plan = tg.MelDbPlan(_params(tg, n_fft, hop), mel, tg.LogParams(-80.0), dtype="float32",
                        method=method, precision=precision, device="cpu")
    fb = mel_filterbank(16000.0, n_fft, mel)
    if method == "pallas:prune":
        # the pruned form is packed where it truncates (a complex class
        # reads at most 64 columns), else the 1-pass tier's Gauss form
        gauss = needed_complex_k1(fb, n_fft // 128) is None
    assert plan._kernel_run.source == kernel
    if kernel == "fused_tier_features" and n_fft > 256:  # at 256 no class is complex
        assert (plan._kernel_run.precision, plan._kernel_run.gauss) == (tier, gauss)
    frames_row = plan.output_shape(n)[1]
    cost = profiling.plan_cost(plan, n, batch=b)
    if kernel == "fused_features":
        flops, bytes_ = f32_counts(b, n, frames_row, n_fft, fb)
        _close(cost.flops, flops)
        assert cost.f32_flops == 0.0
        light = max(flops / 67e12, bytes_ / 3.35e12)
        _close(cost.light_speed_s(H100, "float32"), light)
        assert profiling.roofline(plan, n, 1.0, b, chip=H100)["light_speed_s"] == \
            cost.light_speed_s(H100, "float32")
    else:
        tc, simt, bytes_ = tier_counts(b, n, frames_row, n_fft, fb, tier, gauss)
        _close(cost.flops, tc + simt)
        _close(cost.f32_flops, simt)
        light = max(tc / 989e12 + simt / 67e12, bytes_ / 3.35e12)
        _close(cost.light_speed_s(H100, "bfloat16"), light)
        assert profiling.roofline(plan, n, 1.0, b, chip=H100)["light_speed_s"] == \
            cost.light_speed_s(H100, "bfloat16")
    _close(cost.bytes_hbm, bytes_)
    assert cost.transcendentals == b * frames_row * n_mels


def test_kernel_counts_on_an_identity_mapping():
    plan = tg.LinearPowerPlan(_params(tg, 512, 128), dtype="float32", method="pallas",
                              precision=tg.Precision.DEFAULT, device="cpu")
    fb = np.eye(257)
    tc, simt, bytes_ = tier_counts(2, 3000, plan.output_shape(3000)[1], 512, fb, "bf16", True)
    cost = profiling.plan_cost(plan, 3000, batch=2)
    _close(cost.flops, tc + simt)
    _close(cost.bytes_hbm, bytes_)
    assert cost.transcendentals == 0
    high = tg.LinearPowerPlan(_params(tg, 512, 128), dtype="float32", method="pallas",
                              device="cpu")
    flops, bytes_ = f32_counts(2, 3000, plan.output_shape(3000)[1], 512, fb)
    _close(profiling.plan_cost(high, 3000, batch=2).flops, flops)


def test_config2_bounds_as_perf_records():
    # PERF.md's bounds of config 2 (32 x 10 s to mel-128 dB): 9.26 us (f32
    # kernel, bytes) and 11.5 us (tier kernel at 1 pass, operations)
    high = _plan(tg, "mel_db", "pallas", tg.Precision.HIGH)
    dflt = _plan(tg, "mel_db", "pallas", tg.Precision.DEFAULT)
    h = profiling.roofline(high, N, 75e-6, batch=32, chip=H100)
    d = profiling.roofline(dflt, N, 111e-6, batch=32, chip=H100)
    assert round(h["light_speed_s"] * 1e6, 2) == 9.26
    assert round(d["light_speed_s"] * 1e6, 1) == 11.5
    # the task is graded at f32 on the f32 kernel: 3.69 GFLOP at 67 TFLOP/s
    assert 54e-6 < h["task_light_speed_s"] < 56e-6
    assert h["pct_of_task_roofline"] > 5 * h["pct_of_roofline"]


# ---- the cases of tests/test_profiling.py, on the H100 --------------------

PARAMS = tg.SpectrogramParams(tg.StftParams(1024, 256), 16000.0)
MEL = tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY)


def _mel_db(method):
    return tg.MelDbPlan(PARAMS, MEL, tg.LogParams(-80.0), dtype="float32", method=method,
                        device="cpu")


def test_plan_cost_counts_matmul_flops():
    plan = _mel_db("matmul")
    cost = profiling.plan_cost(plan, N)
    _, n_frames = plan.output_shape(N)
    dft_flops = 2 * 2 * n_frames * 1024 * 513
    assert dft_flops < cost.flops < dft_flops * 1.2
    assert cost.bytes_hbm > n_frames * 1024 * 4
    assert cost.arithmetic_intensity > 50


def test_factored_method_cuts_dft_flops():
    c_fact = profiling.plan_cost(_mel_db("factored"), N).flops
    c_dense = profiling.plan_cost(_mel_db("matmul"), N).flops
    c_fft = profiling.plan_cost(_mel_db("fft"), N).flops
    assert c_fft < c_fact < c_dense / 3


def test_task_roofline_is_algorithm_independent():
    dense, fact = _mel_db("matmul"), _mel_db("factored")
    assert profiling.task_cost(dense, N).flops == profiling.task_cost(fact, N).flops
    rep = profiling.roofline(dense, N, measured_s=1e-3, batch=1, chip=H100)
    assert rep["pct_of_task_roofline"] < rep["pct_of_roofline"]
    assert rep["task_flops"] < rep["flops"]
    jrep = jprof.roofline(_plan(sg, "mel_db", "matmul"), N, 1e-3, chip=jprof.CHIPS["v5e"])
    assert rep.keys() == jrep.keys()


def test_light_speed_and_roofline():
    plan = tg.MelDbPlan(PARAMS, MEL, tg.LogParams(-80.0), dtype="float32", device="cpu")
    cost = profiling.plan_cost(plan, N, batch=32)
    light = cost.light_speed_s(H100, "bfloat16")
    assert 0 < light < 0.1
    rep = profiling.roofline(plan, N, measured_s=light * 4, batch=32, chip=H100,
                             dtype="bfloat16")
    assert abs(rep["pct_of_roofline"] - 25.0) < 1e-6
    assert rep["achieved_tflops"] > 0


def test_fft_method_cheaper_flops():
    mm = tg.LinearPowerPlan(PARAMS, dtype="float32", method="matmul", device="cpu")
    ff = tg.LinearPowerPlan(PARAMS, dtype="float32", method="fft", device="cpu")
    assert profiling.plan_cost(ff, N).flops < profiling.plan_cost(mm, N).flops


def _card(monkeypatch, name, limit="700.00\n"):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)

    def smi(cmd, **kw):
        if limit is None:
            raise FileNotFoundError(cmd[0])
        assert cmd[0] == "nvidia-smi" and "--query-gpu=power.limit" in cmd
        return type("Done", (), {"stdout": limit})()

    monkeypatch.setattr(profiling.subprocess, "run", smi)


def test_detect_chip_returns_spec(monkeypatch):
    _card(monkeypatch, "NVIDIA H100 80GB HBM3")
    spec = profiling.detect_chip()
    assert spec.bf16_tflops > 0 and spec.hbm_gbps > 0
    assert (spec.name, spec.bf16_tflops, spec.f32_tflops, spec.hbm_gbps) == \
        ("h100-sxm", 989.0, 67.0, 3350.0)
    assert spec.power_limit_w == 700.0 and H100.power_limit_w is None
    _card(monkeypatch, "NVIDIA H100 PCIe", limit="350.00\n")
    assert profiling.detect_chip() == profiling.ChipSpec("h100-pcie", 756.0, 51.0, 2000.0, 350.0)
    _card(monkeypatch, "NVIDIA H100 80GB HBM3", limit=None)  # no nvidia-smi
    assert profiling.detect_chip().power_limit_w is None


def test_detect_chip_raises_without_a_known_card(monkeypatch):
    _card(monkeypatch, "NVIDIA A100-SXM4-40GB")
    with pytest.raises(tg.InvalidInputError, match="A100-SXM4-40GB"):
        profiling.detect_chip()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
        profiling.detect_chip()
    cost = profiling.CostEstimate(1e9, 1e6)
    with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
        cost.light_speed_s()
    assert cost.light_speed_s(H100, "float32") == 1e9 / 67e12


def test_chips_hold_only_nvidia_cards():
    assert set(profiling.CHIPS) == {"h100-sxm", "h100-pcie"}
    assert not set(profiling.CHIPS) & set(jprof.CHIPS)


def test_cost_estimate_charges_f32_work_at_the_f32_rate():
    c = profiling.CostEstimate(flops=2e9, bytes_hbm=1e3, f32_flops=0.5e9)
    assert c.light_speed_s(H100, "bf16") == pytest.approx(1.5e9 / 989e12 + 0.5e9 / 67e12,
                                                          rel=1e-15)
    assert c.light_speed_s(H100, "float32") == pytest.approx(2e9 / 67e12, rel=1e-15)
    assert c.light_speed_s(H100, "bf16x2") == pytest.approx(1.5e9 / 494.5e12 + 0.5e9 / 67e12,
                                                            rel=1e-15)
    assert c.light_speed_s(H100, "bf16x3") == pytest.approx(1.5e9 / (989e12 / 3) + 0.5e9 / 67e12,
                                                            rel=1e-15)
    s = c + profiling.CostEstimate(1.0, 2.0, 3.0, 0.5)
    assert (s.flops, s.bytes_hbm, s.transcendentals, s.f32_flops) == (2e9 + 1, 1002.0, 3.0,
                                                                      0.5e9 + 0.5)
    memory_bound = profiling.CostEstimate(1.0, 3.35e9)
    assert memory_bound.light_speed_s(H100) == pytest.approx(1e-3, rel=1e-15)


def test_trace_writes_a_chrome_trace(tmp_path):
    plan = _mel_db("matmul")
    x = np.random.default_rng(0).standard_normal(4000).astype(np.float32)
    with profiling.trace(str(tmp_path / "t"), device="cpu") as tr:
        plan.compute(x)
    assert tr.path is not None and os.path.dirname(tr.path) == str(tmp_path / "t")
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert tr.profile.key_averages()


def test_trace_records_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
        profiling.trace("unused")
