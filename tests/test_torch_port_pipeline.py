"""The PyTorch port's plans against the JAX package's, on the CPU.

Same inputs (numpy, seeded) through both packages at 1 s of 16 kHz:

- f64: the port's ``matmul`` and ``fft`` plans equal the JAX plans to
  rtol 1e-9 for LINEAR/MEL/LOG_HZ/ERB × POWER/MAGNITUDE/DECIBELS;
- f32: the port's paths equal JAX ``method="matmul"`` to 1e-3 dB (mel-dB)
  and 1e-4·max|ref| (MFCC). The JAX CPU backend ignores ``precision``, so
  both sides are plain f32;
- constants carried from a JAX plan (``plan_constants_from_numpy``) give
  the JAX output; gradients match ``jax.grad``;
- the plan surface: shapes, method resolution, and the parts not yet
  ported, which raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu import pipeline as jpl
from spectrograms_tpu.mfcc import MfccPlan as JaxMfccPlan
from spectrograms_tpu_torch import pipeline as tpl
from spectrograms_tpu_torch.mfcc import MfccPlan as PortMfccPlan
from tests.conftest import noise

SR = 16000.0


def _scale(m, scale):
    """(FreqScale, scale params) for one package ``m``."""
    if scale == "linear":
        return m.FreqScale.LINEAR, None
    if scale == "mel":
        return m.FreqScale.MEL, m.MelParams(128, 0.0, 8000.0, m.MelNorm.SLANEY)
    if scale == "loghz":
        return m.FreqScale.LOG_HZ, m.LogHzParams(48, 50.0, 8000.0)
    return m.FreqScale.ERB, m.ErbParams(32, 50.0, 8000.0)


def plan(m, scale, amp, n_fft=1024, hop=256, **kw):
    fs, sp = _scale(m, scale)
    amp_scale = {"power": m.AmpScale.POWER, "magnitude": m.AmpScale.MAGNITUDE,
                 "db": m.AmpScale.DECIBELS}[amp]
    if m is tg:
        kw.setdefault("device", "cpu")
    return m.SpectrogramPlan(
        m.SpectrogramParams(m.StftParams(n_fft, hop), SR), fs, amp_scale,
        scale_params=sp, log_params=m.LogParams(-80.0) if amp == "db" else None, **kw,
    )


def mfcc_plan(m, method, include_c0=True, n_mfcc=40, dtype="float32"):
    cls = PortMfccPlan if m is tg else JaxMfccPlan
    kw = dict(device="cpu") if m is tg else {}
    return cls(
        m.StftParams(1024, 256), SR,
        mel_params=m.MelParams(128, 0.0, 8000.0, m.MelNorm.SLANEY),
        mfcc_params=m.MfccParams(n_mfcc, include_c0=include_c0),
        log_params=m.LogParams(-80.0), dtype=dtype, method=method, **kw,
    )


def rel_max(ref):
    return float(np.abs(ref).max())


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("amp", ["power", "magnitude", "db"])
@pytest.mark.parametrize("scale", ["linear", "mel", "loghz", "erb"])
def test_f64_plans_match_jax(scale, amp, method):
    x = noise(16000, seed=1)
    ref = np.asarray(plan(sg, scale, amp, dtype="float64", method=method).compute_raw(x))
    out = plan(tg, scale, amp, dtype="float64", method=method).compute_raw(x).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-12 * rel_max(ref))


@pytest.mark.parametrize("n_fft,hop,n_mels", [(1024, 256, 128), (512, 160, 40)])
@pytest.mark.parametrize("method", ["matmul", "fft", "pallas"])
def test_f32_mel_db_matches_jax_matmul(method, n_fft, hop, n_mels):
    x = noise(16000, seed=2, dtype=np.float32)
    mk = lambda m, **kw: m.SpectrogramPlan(
        m.SpectrogramParams(m.StftParams(n_fft, hop), SR), m.FreqScale.MEL,
        m.AmpScale.DECIBELS, scale_params=m.MelParams(n_mels, 0.0, 8000.0, m.MelNorm.SLANEY),
        log_params=m.LogParams(-80.0), dtype="float32", **kw,
    )
    ref = np.asarray(mk(sg, method="matmul").compute_raw(x))
    out = mk(tg, method=method, device="cpu").compute_raw(x).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("method", ["matmul", "fft", "pallas"])
def test_f32_mfcc_matches_jax_matmul(method):
    # Noise keeps every mel band well above the -80 dB floor: a pure tone
    # leaves bands at the floor, where both f32 lowerings carry rounding
    # noise that dB + DCT amplify (test_pallas.py's C0-drop test).
    x = np.stack([noise(16000, seed=3, dtype=np.float32), noise(16000, seed=30, dtype=np.float32)])
    ref = np.asarray(mfcc_plan(sg, "matmul").compute_batch(x))
    out = mfcc_plan(tg, method).compute_batch(x).numpy()
    assert out.shape == ref.shape == (2, 40, 63)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * rel_max(ref))


@pytest.mark.parametrize("include_c0,n_mfcc", [(True, 13), (False, 13), (False, 1)])
def test_mfcc_c0_handling_matches_jax(include_c0, n_mfcc):
    x = noise(16000, seed=4, dtype=np.float32)
    ref = np.asarray(mfcc_plan(sg, "matmul", include_c0, n_mfcc).compute(x).data)
    out = mfcc_plan(tg, "matmul", include_c0, n_mfcc).compute(x)
    assert out.shape == ref.shape and out.n_coefficients == ref.shape[0]
    np.testing.assert_allclose(out.to_numpy(), ref, rtol=0, atol=1e-4 * rel_max(ref))


def test_mfcc_from_log_mel_matches_jax():
    lm = np.random.default_rng(5).uniform(-80.0, 20.0, (40, 30))
    p = (13, False, 22)
    ref = np.asarray(sg.mfcc_from_log_mel(lm, sg.MfccParams(*p)).data)
    out = tg.mfcc_from_log_mel(torch.from_numpy(lm), tg.MfccParams(*p))
    np.testing.assert_allclose(out.to_numpy(), ref, rtol=1e-12, atol=1e-9)
    assert out.dtype == "float64" and out.n_frames == 30
    with pytest.raises(tg.InvalidInputError):
        tg.mfcc_from_log_mel(lm[:10], tg.MfccParams(13))


@pytest.mark.parametrize("width,order", [(9, 1), (3, 2), (5, 1)])
def test_mfcc_one_shots_and_delta_match_jax(width, order):
    x = noise(16000, seed=15)
    stft, mp = (512, 256), (13, True, 22)
    ref = sg.compute_mfcc(x, sg.StftParams(*stft), SR, 40, sg.MfccParams(*mp), dtype="float64")
    out = tg.compute_mfcc(x, tg.StftParams(*stft), SR, 40, tg.MfccParams(*mp), dtype="float64",
                          device="cpu")
    np.testing.assert_allclose(out.to_numpy(), np.asarray(ref.data), rtol=1e-9,
                               atol=1e-9 * rel_max(ref.data))
    np.testing.assert_array_equal(
        tg.mfcc(x, tg.StftParams(*stft), SR, 40, tg.MfccParams(*mp), dtype="float64",
                device="cpu").to_numpy(), out.to_numpy())
    d_ref = np.asarray(sg.delta(ref, width, order))
    np.testing.assert_allclose(tg.delta(out, width, order).numpy(), d_ref, rtol=1e-9,
                               atol=1e-9 * rel_max(d_ref))
    # numpy and batched inputs: the last axis is time
    feats = np.random.default_rng(16).standard_normal((2, 13, 30))
    np.testing.assert_allclose(tg.delta(feats, width, order).numpy(),
                               np.asarray(sg.delta(feats, width, order)), rtol=1e-12, atol=1e-12)
    for bad in (dict(width=4), dict(width=1), dict(order=0)):
        with pytest.raises(tg.InvalidInputError):
            tg.delta(feats, **bad)


def test_plan_surface_matches_jax():
    x = noise(16000, seed=6, dtype=np.float32)
    j = plan(sg, "mel", "db", dtype="float32", method="matmul")
    t = plan(tg, "mel", "db", dtype="float32", method="matmul")
    assert t.output_shape(16000) == j.output_shape(16000) == (128, 63)
    assert t.dtype == j.dtype == "float32"
    js, ts = j.compute(x), t.compute(x)
    assert ts.shape == js.shape and len(ts) == len(js) == 63
    np.testing.assert_array_equal(ts.times, js.times)
    np.testing.assert_array_equal(ts.frequencies, js.frequencies)
    assert ts.frequency_range() == js.frequency_range()
    assert ts.duration() == js.duration()
    np.testing.assert_allclose(ts.db_range(), js.db_range(), atol=1e-3)
    assert np.asarray(ts).shape == (128, 63)
    batch = t.compute_batch(np.stack([x, 0.5 * x]))
    assert batch.shape == (2, 128, 63)
    np.testing.assert_allclose(batch[0].numpy(), ts.to_numpy(), rtol=1e-5, atol=1e-5)
    for bad in (np.zeros((2, 5), np.float32), np.zeros(0, np.float32)):
        with pytest.raises(tg.InvalidInputError):
            t.compute(bad)
    with pytest.raises(tg.InvalidInputError):
        t.compute_batch(x)


@pytest.mark.parametrize("build", [
    "cqt", "multirate", "factored", "f32x2", "loghz_multirate", "mfcc_multirate",
    "chroma_multirate", "compute_frame", "stft_plan",
])
def test_parts_not_yet_ported_raise(build):
    """Each part of the JAX surface that the port lacks raises "not yet
    ported". The parts ported since (CQT plans, the multirate plans,
    ``compute_frame``, ``StftPlan`` and the ``factored`` and ``f32x2``
    methods) build and compute instead: finite values of the expected
    shape, here; their parity tests are ``tests/test_torch_port_cqt.py``,
    ``test_torch_port_multirate.py``, ``test_torch_port_streaming.py``,
    ``test_torch_port_stft.py``, ``test_torch_port_factored.py`` and
    ``test_torch_port_f32x2.py``."""
    params = tg.SpectrogramParams(tg.StftParams(1024, 256), SR)
    x = noise(16000, seed=17, dtype=np.float32)
    ported = {
        "cqt": lambda: tg.SpectrogramPlan(
            params, tg.FreqScale.CQT, tg.AmpScale.POWER,
            scale_params=tg.CqtParams(12, 4, 55.0), device="cpu",
        ).compute_raw(x),
        "multirate": lambda: tg.SpectrogramPlan(
            params, tg.FreqScale.MEL, tg.AmpScale.POWER,
            scale_params=tg.MelParams(40, 0.0, 2000.0, multirate=True), device="cpu",
        ).compute_raw(x),
        "loghz_multirate": lambda: tg.SpectrogramPlan(
            params, tg.FreqScale.LOG_HZ, tg.AmpScale.POWER,
            scale_params=tg.LogHzParams(48, 50.0, 4000.0, multirate=True), device="cpu",
        ).compute_raw(x),
        "mfcc_multirate": lambda: tg.MfccPlan(
            tg.StftParams(1024, 256), SR, device="cpu",
            mel_params=tg.MelParams(40, 0.0, 2000.0, multirate=True)).compute(x).data,
        "chroma_multirate": lambda: tg.ChromaPlan(
            tg.StftParams(4096, 1024), 44100.0, device="cpu",
            chroma_params=tg.ChromaParams().with_multirate()).compute(x).data,
        "compute_frame": lambda: plan(tg, "mel", "db").compute_frame(x, 0)[:, None],
        "stft_plan": lambda: tg.StftPlan(params, device="cpu").compute(x).norm(),
        "factored": lambda: plan(tg, "mel", "db", method="factored").compute_raw(x),
        "f32x2": lambda: plan(tg, "mel", "db", method="f32x2",
                              dtype="float32").compute_raw_x2(x)[1],
    }
    if build in ported:
        out = ported[build]()
        frames = {"chroma_multirate": 16, "compute_frame": 1}.get(build, 63)
        assert out.ndim == 2 and out.shape[1] == frames
        assert bool(torch.isfinite(out).all())
        return
    with pytest.raises(tg.InvalidInputError, match="not yet ported"):
        plan(tg, "mel", "db", method=build)


def test_method_errors_match_jax():
    for m in (sg, tg):
        with pytest.raises(m.InvalidInputError, match="unknown method"):
            plan(m, "mel", "db", method="bogus")
        with pytest.raises(m.InvalidInputError, match="unknown pallas option"):
            plan(m, "mel", "db", method="pallas:bogus")
        with pytest.raises(m.InvalidInputError):
            plan(m, "mel", "db", dtype="float64", method="pallas")
        with pytest.raises(m.InvalidInputError):
            plan(m, "mel", "db", n_fft=1000, hop=250, dtype="float32", method="pallas")
    with pytest.raises(sg.InvalidInputError, match="HIGHEST"):
        plan(sg, "mel", "db", dtype="float32", method="pallas",
             precision=jax.lax.Precision.HIGHEST)
    with pytest.raises(tg.InvalidInputError, match="HIGHEST"):
        plan(tg, "mel", "db", dtype="float32", method="pallas", precision=tg.Precision.HIGHEST)


@pytest.mark.parametrize("scale", ["linear", "mel", "loghz", "erb"])
def test_auto_resolves_like_jax(scale, monkeypatch):
    """The JAX rule with "on a TPU" read as "on a CUDA device"."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    fs_j, _ = _scale(sg, scale)
    fs_t, _ = _scale(tg, scale)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cases = [  # (n_fft, hop, f64?, HIGHEST?)
        (1024, 256, False, False), (1024, 256, False, True), (1024, 256, True, False),
        (512, 160, False, False), (1000, 250, False, False), (8192, 2048, False, False),
    ]
    for n_fft, hop, f64, highest in cases:
        want = jpl._resolve_method(
            "auto", n_fft, hop, np.float64 if f64 else np.float32, fs_j,
            jax.lax.Precision.HIGHEST if highest else jax.lax.Precision.HIGH,
        )
        prec = tg.Precision.HIGHEST if highest else tg.Precision.HIGH
        dt = torch.float64 if f64 else torch.float32
        assert tpl._resolve_method("auto", n_fft, hop, dt, fs_t, prec, cuda) == want
        assert tpl._resolve_method("auto", n_fft, hop, dt, fs_t, prec, cpu) == (
            "matmul" if want == "pallas" else want)
    # A CPU plan never picks the kernel on its own.
    assert plan(tg, scale, "db", dtype="float32").method != "pallas"


def test_plan_constants_from_numpy_gives_the_jax_output():
    x = noise(16000, seed=8, dtype=np.float32)
    j = plan(sg, "mel", "db", dtype="float32", method="matmul")
    t = plan(tg, "mel", "db", dtype="float32", method="matmul")
    # The port's own builders give the JAX plan's constants...
    np.testing.assert_array_equal(t._window.numpy(), np.asarray(j._window))
    np.testing.assert_array_equal(t._mapping_t.numpy(), np.asarray(j._mapping_t))
    # ...and constants carried over from the JAX plan give its output.
    t2 = tg.plan_constants_from_numpy(t, np.asarray(j._window), np.asarray(j._mapping_t).T)
    ref = np.asarray(j.compute_raw(x))
    np.testing.assert_allclose(t2.compute_raw(x).numpy(), ref, rtol=0, atol=1e-3)
    # The installed constants are the ones used: a doubled filterbank is +3 dB.
    tg.plan_constants_from_numpy(t, np.asarray(j._window), 2.0 * np.asarray(j._mapping_t).T)
    np.testing.assert_allclose(t.compute_raw(x).numpy(), ref + 10 * np.log10(2.0),
                               rtol=0, atol=2e-3)


@pytest.mark.parametrize("method", ["matmul", "pallas"])
def test_mfcc_constants_from_numpy_give_the_jax_output(method):
    x = noise(16000, seed=9, dtype=np.float32)
    j = mfcc_plan(sg, "matmul", include_c0=False)
    t = tg.plan_constants_from_numpy(
        mfcc_plan(tg, method, include_c0=False),
        np.asarray(j._mel_plan._window), np.asarray(j._mel_plan._mapping_t).T,
        np.asarray(j._basis),
    )
    ref = np.asarray(j.compute(x).data)
    np.testing.assert_allclose(t.compute(x).to_numpy(), ref, rtol=0, atol=1e-4 * rel_max(ref))
    with pytest.raises(tg.DimensionMismatchError):
        tg.plan_constants_from_numpy(t, np.ones(512), np.asarray(j._mel_plan._mapping_t).T,
                                     np.asarray(j._basis))
    with pytest.raises(tg.InvalidInputError):
        tg.plan_constants_from_numpy(t, np.asarray(j._mel_plan._window),
                                     np.asarray(j._mel_plan._mapping_t).T)


def test_plan_constants_from_numpy_f64_linear():
    x = noise(16000, seed=10)
    j = plan(sg, "linear", "magnitude", dtype="float64", method="fft")
    t = tg.plan_constants_from_numpy(
        plan(tg, "linear", "magnitude", dtype="float64", method="fft"), np.asarray(j._window))
    ref = np.asarray(j.compute_raw(x))
    np.testing.assert_allclose(t.compute_raw(x).numpy(), ref, rtol=1e-9, atol=1e-12 * rel_max(ref))


@pytest.mark.parametrize("method", ["matmul", "pallas"])
def test_mfcc_gradient_matches_jax_grad(method):
    rng = np.random.default_rng(11)
    # Noise only: at the dB floor d(dB)/dp = 10/(p·ln 10) makes the gradient
    # of near-floor bands as ill-conditioned as their values.
    x = np.stack([noise(16000, seed=12, dtype=np.float32), noise(16000, seed=14, dtype=np.float32)])
    w = rng.standard_normal((2, 13, 63)).astype(np.float32)
    jp = mfcc_plan(sg, "matmul", n_mfcc=13)
    g_ref = np.asarray(jax.grad(lambda v: jnp.sum(jp.compute_batch(v) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (mfcc_plan(tg, method, n_mfcc=13).compute_batch(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, rtol=0, atol=1e-4 * rel_max(g_ref))


def test_spectrogram_gradient_through_the_kernel_route_is_the_plain_one():
    x = torch.from_numpy(noise(16000, seed=13, dtype=np.float32))
    p = plan(tg, "erb", "db", dtype="float32", method="pallas")
    a = x.clone().requires_grad_(True)
    p.compute_raw(a).sum().backward()
    b = x.clone().requires_grad_(True)
    p._forward_impl(b).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
