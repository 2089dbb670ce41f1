"""The port's autotune (``autotune.py``) against the JAX package's, on the CPU.

The counterpart of each test in ``tests/test_autotune.py``, with its
inputs. What the CPU can show: the winner among ``fft``/``matmul`` and its
features against the JAX plan (1e-3 dB, the JAX test's atol), the rebuild
(typed subclasses, multirate mel/MFCC/chroma kept at their full rate, the
device kept), the wisdom key and its round trip through JSON, stale wisdom
tuned anew, and the candidate gating: no ``pallas`` on a CPU plan, the
whole list (kernel forms included) on a plan whose device reads CUDA. The
eager slope never writes the caller's sample. k2 ≤ 9 and reps 1 keep the
file fast.
"""

import sys

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch.autotune import (_candidate_methods, _plan_key,
                                             _rebuild_with_method)
from tests.conftest import noise

CPU = dict(device="cpu")
at = sys.modules["spectrograms_tpu_torch.autotune"]


@pytest.fixture(autouse=True)
def _fresh_wisdom():
    tg.clear_wisdom()
    sg.clear_wisdom()
    yield
    tg.clear_wisdom()
    sg.clear_wisdom()


def mfcc_plan(m, **kw):
    kw.setdefault("dtype", "float32")
    if m is tg:
        kw.setdefault("device", "cpu")
    return m.MfccPlan(m.StftParams(512, 128), 16000.0, **kw)


def test_autotune_picks_fast_candidate():
    def fast(x):
        return torch.sum(x * 2.0, dim=0, keepdim=True)

    def slow(x):
        y = x
        for _ in range(200):
            y = torch.tanh(y) + x
        return torch.sum(y, dim=0, keepdim=True)

    x = np.ones(4096, np.float32)
    r = tg.autotune({"fast": fast, "slow": slow}, x, k2=9)
    assert r.winner == "fast" and r.key == "<callables>" and not r.from_cache
    assert set(r.timings_ms) == {"fast", "slow"}
    assert r.timings_ms["fast"] < r.timings_ms["slow"]
    np.testing.assert_array_equal(x, 1.0)  # the chain writes a clone, never the sample


def test_autotune_plan_mfcc_and_wisdom_cache():
    xb = np.stack([noise(), noise()]).astype(np.float32)
    plan = mfcc_plan(tg)
    r = tg.autotune_plan(plan, xb, methods=["fft", "matmul"], k2=5, reps=1)
    assert r.winner in ("fft", "matmul") and r.plan.method == r.winner
    assert not r.from_cache and set(r.timings_ms) == {"fft", "matmul"}
    assert r.plan.device == torch.device("cpu")
    # the winner computes the JAX plan's features
    want = np.asarray(mfcc_plan(sg).compute_batch(xb))
    np.testing.assert_allclose(r.plan.compute_batch(xb).numpy(), want, atol=1e-3)
    np.testing.assert_allclose(plan.compute_batch(xb).numpy(), want, atol=1e-3)
    # second call: a wisdom hit, nothing measured
    r2 = tg.autotune_plan(plan, xb, methods=["fft", "matmul"], k2=5, reps=1)
    assert r2.from_cache and r2.winner == r.winner and r2.timings_ms == {}
    assert tg.wisdom() == {r.key: r.winner}
    assert tg.fft_plan_cache_info()["autotune.wisdom"]["currsize"] == 1


def test_autotune_plan_spectrogram_and_chroma_rebuild():
    x = noise().astype(np.float32)
    plans = {}
    for m in (sg, tg):
        kw = CPU if m is tg else {}
        params = m.SpectrogramParams(m.StftParams(512, 128), 16000.0)
        plans[m] = (m.SpectrogramPlan(params, m.FreqScale.MEL, m.AmpScale.POWER,
                                      scale_params=m.MelParams(32, 0.0, 8000.0),
                                      dtype="float32", **kw),
                    m.ChromaPlan(m.StftParams(512, 128), 16000.0, dtype="float32", **kw))
    r = tg.autotune_plan(plans[tg][0], x, methods=["fft", "matmul"], k2=5, reps=1)
    assert r.plan.method == r.winner
    want = np.asarray(plans[sg][0].compute_raw(x))
    np.testing.assert_allclose(r.plan.compute_raw(x).numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    rc = tg.autotune_plan(plans[tg][1], x, methods=["fft", "matmul"], k2=5, reps=1)
    assert rc.winner in ("fft", "matmul") and type(rc.plan) is tg.ChromaPlan
    np.testing.assert_allclose(rc.plan.compute(x).data.numpy(),
                               np.asarray(plans[sg][1].compute(x).data), rtol=0, atol=1e-5)


def test_wisdom_save_load_roundtrip(tmp_path):
    plan = mfcc_plan(tg)
    xb = np.stack([noise()]).astype(np.float32)
    r = tg.autotune_plan(plan, xb, methods=["fft"], k2=3, reps=1)
    p = tmp_path / "wisdom.json"
    tg.save_wisdom(p)
    tg.clear_wisdom()
    assert tg.wisdom() == {}
    assert tg.load_wisdom(p) == {r.key: "fft"}
    r2 = tg.autotune_plan(plan, xb, methods=["fft"], k2=3, reps=1)
    assert r2.from_cache and r2.plan.method == "fft"
    # merge=False replaces; a file that is not an object is refused, as in JAX
    (tmp_path / "other.json").write_text('{"k": "matmul"}')
    assert tg.load_wisdom(tmp_path / "other.json", merge=False) == {"k": "matmul"}
    (tmp_path / "bad.json").write_text("[1, 2]")
    for m in (tg, sg):
        with pytest.raises(m.InvalidInputError, match="JSON object"):
            m.load_wisdom(tmp_path / "bad.json")


def test_autotune_plan_typed_subclasses():
    x = noise().astype(np.float32)
    plans = {}
    for m in (sg, tg):
        kw = CPU if m is tg else {}
        params = m.SpectrogramParams(m.StftParams(512, 128), 16000.0)
        plans[m] = (m.MelDbPlan(params, m.MelParams(32, 0.0, 8000.0), m.LogParams(-80.0),
                                dtype="float32", **kw),
                    m.LinearPowerPlan(params, dtype="float32", **kw))
    r = tg.autotune_plan(plans[tg][0], x, methods=["fft", "matmul"], k2=5, reps=1)
    assert type(r.plan) is tg.MelDbPlan and r.plan.method == r.winner
    np.testing.assert_allclose(r.plan.compute_raw(x).numpy(),
                               np.asarray(plans[sg][0].compute_raw(x)), atol=1e-3)
    r2 = tg.autotune_plan(plans[tg][0], x, methods=["fft", "matmul"], k2=5, reps=1)
    assert r2.from_cache and type(r2.plan) is tg.MelDbPlan
    rl = tg.autotune_plan(plans[tg][1], x, methods=["fft", "matmul"], k2=5, reps=1)
    assert type(rl.plan) is tg.LinearPowerPlan


def test_wisdom_key_separates_feature_configs():
    def mk(n_mels, n_mfcc=13, **kw):
        return tg.MfccPlan(tg.StftParams(512, 128), 16000.0,
                           mel_params=tg.MelParams(n_mels, 0.0, 8000.0),
                           mfcc_params=tg.MfccParams(n_mfcc), dtype="float32",
                           **{"device": "cpu", **kw})

    shape = (2, 16000)
    assert _plan_key(mk(32), shape) != _plan_key(mk(128), shape)
    assert _plan_key(mk(64, 13), shape) != _plan_key(mk(64, 20), shape)
    assert _plan_key(mk(64), shape) == _plan_key(mk(64), shape)
    assert _plan_key(mk(64), shape) != _plan_key(mk(64), (4, 16000))
    assert _plan_key(mk(64), shape) != _plan_key(mk(64, precision=tg.Precision.DEFAULT), shape)
    # custom windows of one length are told apart by their coefficients
    w1 = tg.WindowType.custom(np.hanning(512))
    w2 = tg.WindowType.custom(np.hamming(512))
    mkw = lambda w: tg.LinearPowerPlan(
        tg.SpectrogramParams(tg.StftParams(512, 128, window=w), 16000.0), **CPU)
    assert _plan_key(mkw(w1), shape) != _plan_key(mkw(w2), shape)
    assert '"cpu"' in _plan_key(mk(64), shape)  # keyed on the device type


def test_candidate_methods_gate_pallas_off_cuda():
    plan = tg.MfccPlan(tg.StftParams(1024, 256), 16000.0, dtype="float32", **CPU)
    assert set(_candidate_methods(plan)) == {"fft", "matmul"}
    assert set(_candidate_methods(plan, kernel_variants=True)) == {"fft", "matmul"}
    jplan = sg.MfccPlan(sg.StftParams(1024, 256), 16000.0, dtype="float32")
    from spectrograms_tpu.autotune import _candidate_methods as jax_candidates

    assert list(_candidate_methods(plan)) == list(jax_candidates(jplan))
    f64 = tg.MelDbPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), 16000.0),
                       tg.MelParams(32, 0.0, 8000.0), dtype="float64", **CPU)
    assert list(_candidate_methods(f64)) == ["fft"]


def test_autotune_validation():
    with pytest.raises(tg.InvalidInputError, match="at least one candidate"):
        tg.autotune({}, np.ones(8, np.float32))
    plan = mfcc_plan(tg)
    with pytest.raises(tg.InvalidInputError, match="1-D signal or"):
        tg.autotune_plan(plan, np.ones((2, 2, 2), np.float32))
    with pytest.raises(tg.InvalidInputError, match="supports SpectrogramPlan"):
        tg.autotune_plan(object(), np.ones(8, np.float32))
    with pytest.raises(tg.InvalidInputError, match="no candidate method"):
        tg.autotune_plan(plan, np.ones((1, 4096), np.float32), methods=["pallas:bogus"])


def test_parse_pallas_method_matches_jax():
    from spectrograms_tpu.ops.pallas_factored import parse_pallas_method as jparse
    from spectrograms_tpu_torch.ops.fused_factored import parse_pallas_method

    for m in ("pallas", "pallas:dif", "pallas:stack", "pallas:dif+stack", "pallas:gauss"):
        assert parse_pallas_method(m) == jparse(m)
    for bad in ("pallas:bogus", "matmul"):
        with pytest.raises(tg.InvalidInputError):
            parse_pallas_method(bad)


def test_variant_method_plans_match_base():
    """The variant forms on the CPU (the kernels' plain versions) against
    the JAX plan at the JAX test's 2e-2 dB."""
    x = np.random.default_rng(3).standard_normal(16000).astype(np.float32)
    jp = sg.SpectrogramParams(sg.StftParams(1024, 256), 16000.0)
    want = np.asarray(sg.MelDbPlan(jp, sg.MelParams(64, 0.0, 8000.0, sg.MelNorm.SLANEY),
                                   sg.LogParams(-80.0), dtype="float32",
                                   method="matmul").compute_raw(x))
    params = tg.SpectrogramParams(tg.StftParams(1024, 256), 16000.0)
    mel = tg.MelParams(64, 0.0, 8000.0, tg.MelNorm.SLANEY)
    for m in ("pallas", "pallas:stack", "pallas:dif", "pallas:dif+stack"):
        out = tg.MelDbPlan(params, mel, tg.LogParams(-80.0), dtype="float32", method=m,
                           **CPU).compute_raw(x).numpy()
        np.testing.assert_allclose(out, want, atol=2e-2, err_msg=m)
    with pytest.raises(tg.InvalidInputError):
        tg.MelDbPlan(params, mel, tg.LogParams(-80.0), dtype="float32",
                     method="pallas:gauss+dif", **CPU)


@pytest.mark.parametrize("precision", ["HIGH", "DEFAULT"])
def test_candidate_methods_kernel_variants(monkeypatch, precision):
    params = tg.SpectrogramParams(tg.StftParams(1024, 256), 16000.0)
    mel = tg.MelParams(64, 0.0, 8000.0, tg.MelNorm.SLANEY)
    plan = tg.MelDbPlan(params, mel, tg.LogParams(-80.0), dtype="float32",
                        precision=getattr(tg.Precision, precision), **CPU)
    monkeypatch.setattr(plan, "device", torch.device("cuda", 0))  # as the card reads it
    base = _candidate_methods(plan)
    ext = _candidate_methods(plan, kernel_variants=True)
    assert base == ["fft", "matmul", "pallas"]
    if precision == "HIGH":
        assert ext == base + ["pallas:dif", "pallas:stack", "pallas:dif+stack", "pallas:gauss"]
    else:  # stack is a form of the x3 tier; the bf16 tier is Gauss already
        assert ext == base + ["pallas:dif"]
    import jax

    from spectrograms_tpu.autotune import _candidate_methods as jax_candidates

    jplan = sg.MelDbPlan(sg.SpectrogramParams(sg.StftParams(1024, 256), 16000.0),
                         sg.MelParams(64, 0.0, 8000.0, sg.MelNorm.SLANEY), sg.LogParams(-80.0),
                         dtype="float32", precision=getattr(jax.lax.Precision, precision))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert list(jax_candidates(jplan, kernel_variants=True)) == ext
    for m in ext:  # every candidate rebuilds (no wisdom poison), on the CPU here
        assert _rebuild_with_method(plan, m, device="cpu").method == m


def test_rebuild_preserves_multirate_chroma():
    sr = 44100.0
    plan = tg.ChromaPlan(tg.StftParams(4096, 1024), sr,
                         tg.ChromaParams.music_standard().with_multirate(),
                         dtype="float32", **CPU)
    assert plan._decimation == 2
    rebuilt = _rebuild_with_method(plan, "auto")
    assert rebuilt._decimation == plan._decimation and rebuilt._sample_rate_hz == sr
    assert rebuilt.device == plan.device
    t = np.arange(int(sr * 0.4)) / sr
    x = sum(np.sin(2 * np.pi * 220.0 * k * t) / k for k in range(1, 10)).astype(np.float32)
    a = plan.compute(x).data.numpy()
    b = rebuilt.compute(x).data.numpy()
    assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
    from spectrograms_tpu.autotune import _rebuild_with_method as jax_rebuild

    jrebuilt = jax_rebuild(sg.ChromaPlan(sg.StftParams(4096, 1024), sr,
                                         sg.ChromaParams.music_standard().with_multirate(),
                                         dtype="float32"), "auto")
    want = np.asarray(jrebuilt.compute(x).data)
    np.testing.assert_allclose(b, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_rebuild_preserves_multirate_mel_and_mfcc():
    sr = 44100.0
    x = np.random.default_rng(3).standard_normal(int(sr * 0.4)).astype(np.float32)
    plan = tg.MelDbPlan(tg.SpectrogramParams(tg.StftParams(2048, 512), sr),
                        tg.MelParams(64, 0.0, 4000.0, tg.MelNorm.SLANEY, multirate=True),
                        tg.LogParams(-80.0), dtype="float32", **CPU)
    assert plan._multirate_inner is not None
    rebuilt = _rebuild_with_method(plan, "fft")
    assert rebuilt._multirate_inner is not None
    assert rebuilt._multirate_inner[0] == plan._multirate_inner[0]
    assert rebuilt.params.sample_rate_hz == sr and type(rebuilt) is tg.MelDbPlan
    a = plan.compute(x).data.numpy()
    b = rebuilt.compute(x).data.numpy()
    energetic = a > a.max() - 50.0
    assert np.abs(a - b)[energetic].max() <= 5e-3

    mel = tg.MelParams(64, 0.0, 4000.0, tg.MelNorm.SLANEY, multirate=True)
    mfcc = tg.MfccPlan(tg.StftParams(2048, 512), sr, mel_params=mel,
                       mfcc_params=tg.MfccParams(13), dtype="float32", **CPU)
    assert mfcc._mel_plan._multirate_inner is not None
    mre = _rebuild_with_method(mfcc, "fft")
    assert mre._mel_plan._multirate_inner is not None
    assert mre._mel_plan.params.sample_rate_hz == sr
    am = mfcc.compute(x).data.numpy()
    bm = mre.compute(x).data.numpy()
    assert np.abs(am - bm).max() <= 1e-3 * np.abs(am).max()
    # the rebuilt multirate MFCC against JAX's, rebuilt the same way
    from spectrograms_tpu.autotune import _rebuild_with_method as jax_rebuild

    jm = jax_rebuild(sg.MfccPlan(sg.StftParams(2048, 512), sr, mel_params=sg.MelParams(
        64, 0.0, 4000.0, sg.MelNorm.SLANEY, multirate=True), mfcc_params=sg.MfccParams(13),
        dtype="float32"), "fft")
    want = np.asarray(jm.compute(x).data)
    assert np.abs(bm - want).max() <= 1e-3 * np.abs(want).max()


def test_stale_wisdom_entry_retunes_instead_of_crashing():
    plan = tg.MelDbPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), 16000.0),
                        tg.MelParams(64, 0.0, 8000.0, tg.MelNorm.SLANEY), tg.LogParams(-80.0),
                        dtype="float32", precision=tg.Precision.DEFAULT, **CPU)
    x = np.zeros((2, 16000), dtype=np.float32)
    key = _plan_key(plan, x.shape)
    at._WISDOM[key] = "pallas:stack"  # stale: the DEFAULT tier does not take it
    res = tg.autotune_plan(plan, x, k2=5, reps=1)
    assert not res.from_cache and res.winner != "pallas:stack"
    assert at._WISDOM[key] == res.winner


def test_cache_info_reports_wisdom_as_jax_does():
    xb = np.stack([noise()]).astype(np.float32)
    tg.autotune_plan(mfcc_plan(tg), xb, methods=["fft"], k2=3, reps=1)
    sg.autotune_plan(mfcc_plan(sg), xb, methods=["fft"], k2=3, reps=1)
    assert tg.fft_plan_cache_info()["autotune.wisdom"] == \
        sg.fft_plan_cache_info()["autotune.wisdom"] == \
        {"hits": -1, "misses": -1, "currsize": 1, "maxsize": -1}


def test_slope_time_chains_a_data_dependency():
    """Each chained call reads a clone whose first element comes from the
    running sum of the previous outputs; the caller's sample is untouched."""
    seen = []

    def fn(x):
        seen.append(float(x[0]))
        return torch.full((3,), 1e20)

    x = torch.full((8,), 7.0)
    at._slope_time(fn, x, 1, 3, 1)
    assert torch.equal(x, torch.full((8,), 7.0))
    # every chain starts from the sample, and later calls read 1e-30·sum
    assert seen[0] == 0.0 and all(v in (0.0, pytest.approx(3e-10), pytest.approx(6e-10))
                                  for v in seen)
    assert any(v > 0.0 for v in seen)
