"""The port's band-limited multirate path against the JAX package's, on the CPU.

- ``ops/decimate.py``: the taps equal JAX's exactly; ``decimate_pow2_framed``,
  the ``decimate2``/``pow2``/``strided`` family and ``DecimationCascade``
  ``level``/``level_slice`` equal JAX's to 1e-12 in f64 and to 1e-6·max in
  f32 (``tests/test_featureset.py:56``); the engaged depth is JAX's;
- multirate mel (power, magnitude, dB), log-Hz, chroma and MFCC plans equal
  the JAX plans (f32: 1e-3 dB for dB, 1e-5·max for power, magnitude,
  chroma and MFCC, as ``tests/test_torch_port_pipeline.py`` holds the
  full-rate plans), through the plain route and the kernel's plain version;
- each is held against its own full-rate plan at ``tests/test_multirate.py``'s
  and ``tests/test_chroma.py``'s relative-to-peak bounds;
- constants carried from a JAX multirate plan give its output;
- gradients through the multirate path are finite and equal to the plain
  route's.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.chroma import ChromaPlan as JaxChromaPlan
from spectrograms_tpu.mfcc import MfccPlan as JaxMfccPlan
from spectrograms_tpu.ops import decimate as jd
from spectrograms_tpu_torch.ops import decimate as td

SR = 44100.0
F64 = dict(rtol=0, atol=1e-12)


def music(n_sec=0.5, f0=220.0):
    """``tests/test_multirate.py``'s signal: 17 harmonics of f0."""
    t = np.arange(int(44100 * n_sec)) / 44100.0
    return sum(np.sin(2 * np.pi * f0 * k * t + k) / k for k in range(1, 18)).astype(np.float32)


def batch():
    x = music()
    return np.stack([x, x[::-1].copy()])


def rel_max(ref):
    return float(np.abs(ref).max())


# ---- ops/decimate.py --------------------------------------------------------

def test_taps_equal_jax():
    for args in ((), (31, 6.0), (63, 9.0)):
        np.testing.assert_array_equal(td.halfband_taps(*args), jd.halfband_taps(*args))
    for d in (1, 2, 3):
        np.testing.assert_array_equal(td.composite_taps(d), jd.composite_taps(d))
    with pytest.raises(ValueError):
        td.halfband_taps(8)


@pytest.mark.parametrize("sr,n_fft,hop,f_max", [
    (44100.0, 2048, 512, 4000.0), (44100.0, 4096, 1024, 4186.0), (16000.0, 1024, 256, 2000.0),
    (16000.0, 1024, 256, 8000.0), (44100.0, 4096, 1023, 4186.0), (44100.0, 128, 64, 500.0),
])
def test_decimation_depth_equals_jax(sr, n_fft, hop, f_max):
    assert (td.band_limited_decimation_depth(sr, n_fft, hop, f_max)
            == jd.band_limited_decimation_depth(sr, n_fft, hop, f_max))


@pytest.mark.parametrize("d,hop", [(1, None), (2, None), (3, None), (2, 128), (1, 512)])
def test_decimate_pow2_framed_matches_jax(d, hop):
    x = np.random.default_rng(d).standard_normal((3, 20001))
    want = np.asarray(jd.decimate_pow2_framed(jnp.asarray(x), d, hop=hop))
    np.testing.assert_allclose(td.decimate_pow2_framed(torch.from_numpy(x), d, hop=hop).numpy(),
                               want, **F64)
    x32 = x.astype(np.float32)
    want32 = np.asarray(jd.decimate_pow2_framed(jnp.asarray(x32), d, jax.lax.Precision.HIGH, hop))
    got32 = td.decimate_pow2_framed(torch.from_numpy(x32), d, tg.Precision.HIGH, hop).numpy()
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, want32, rtol=0, atol=1e-6 * rel_max(want32))


def test_decimate_pow2_framed_rejects_bad_hop():
    for m in (td, jd):
        with pytest.raises(ValueError, match="multiple"):
            m.decimate_pow2_framed(np.zeros(100) if m is jd else torch.zeros(100), 2, hop=6)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_decimate_family_matches_jax(d):
    x = np.random.default_rng(10 + d).standard_normal(4001)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(td.decimate2(xt).numpy(), np.asarray(jd.decimate2(jnp.asarray(x))),
                               **F64)
    np.testing.assert_allclose(td.decimate_pow2(xt, d).numpy(),
                               np.asarray(jd.decimate_pow2(jnp.asarray(x), d)), **F64)
    xb = np.random.default_rng(20 + d).standard_normal((2, 3, 4001))
    np.testing.assert_allclose(td.decimate_pow2_strided(torch.from_numpy(xb), d).numpy(),
                               np.asarray(jd.decimate_pow2_strided(jnp.asarray(xb), d)), **F64)


@pytest.mark.parametrize("composite", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cascade_levels_and_slices_match_jax(composite, dtype):
    x = np.random.default_rng(7).standard_normal((2, 30001)).astype(dtype)
    jc = jd.DecimationCascade(jnp.asarray(x), pad=2048, precision=jax.lax.Precision.HIGH,
                              composite=composite)
    tc = td.DecimationCascade(torch.from_numpy(x), pad=2048, composite=composite)
    assert tc.precision == tg.Precision.HIGH
    for d, keep in ((1, 1024), (2, 2048), (2, 0), (3, 1024), (4, 2048)):
        for got, want in ((tc.level(d), jc.level(d)), (tc.level_slice(d, keep),
                                                        jc.level_slice(d, keep))):
            want = np.asarray(want)
            assert got.shape == want.shape
            tol = F64 if dtype == np.float64 else dict(rtol=0, atol=1e-6 * rel_max(want))
            np.testing.assert_allclose(got.numpy(), want, **tol)
    for d, keep, length in ((2, 1024, 100), (1, 0, 99999)):
        got = tc.level_slice(d, keep, length)
        assert got.shape[-1] == length
        np.testing.assert_allclose(got.numpy(), np.asarray(jc.level_slice(d, keep, length)),
                                   **(F64 if dtype == np.float64 else dict(rtol=0, atol=1e-5)))


def test_cascade_single_stage_slices_are_bit_exact():
    """A slice of a deeper-padded level equals decimating the shallower pad."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 30000)).astype(np.float32))
    for pad, keep in ((2048, 1024), (4096, 2048), (2048, 0), (1024, 1024)):
        cas = td.DecimationCascade(x, pad=pad)
        for d in (1, 2):
            direct = td.decimate_pow2_framed(torch.nn.functional.pad(x, (keep, keep)), d)
            assert torch.equal(cas.level_slice(d, keep, direct.shape[-1]), direct)


def test_cascade_keep_pad_validation():
    cas = td.DecimationCascade(torch.zeros(2, 1000), pad=256)
    with pytest.raises(ValueError):
        cas.level_slice(2, 512)  # keep_pad > pad
    with pytest.raises(ValueError):
        cas.level_slice(4, 8)  # not a multiple of 2^4


# ---- multirate plans ---------------------------------------------------------

MEL = (80, 0.0, 4000.0)


def mel_plan(m, amp, multirate=True, method="matmul", n_fft=2048, hop=512, sr=SR, mel=MEL,
             **kw):
    mp = m.MelParams(*mel, m.MelNorm.SLANEY).with_multirate(multirate)
    amp_scale = {"power": m.AmpScale.POWER, "magnitude": m.AmpScale.MAGNITUDE,
                 "db": m.AmpScale.DECIBELS}[amp]
    if m is tg:
        kw.setdefault("device", "cpu")
    return m.SpectrogramPlan(m.SpectrogramParams(m.StftParams(n_fft, hop), sr), m.FreqScale.MEL,
                             amp_scale, scale_params=mp,
                             log_params=m.LogParams(-80.0) if amp == "db" else None,
                             dtype="float32", method=method, **kw)


def mfcc_plan(m, multirate=True, method="matmul"):
    cls = tg.MfccPlan if m is tg else JaxMfccPlan
    kw = dict(device="cpu") if m is tg else {}
    return cls(m.StftParams(2048, 512), SR,
               mel_params=m.MelParams(*MEL, m.MelNorm.SLANEY).with_multirate(multirate),
               mfcc_params=m.MfccParams(13), dtype="float32", method=method, **kw)


def chroma_plan(m, multirate=True, method="matmul", params=None, stft=(4096, 1024)):
    cls = tg.ChromaPlan if m is tg else JaxChromaPlan
    kw = dict(device="cpu") if m is tg else {}
    p = params if params is not None else m.ChromaParams.music_standard()
    return cls(m.StftParams(*stft), SR, p.with_multirate(multirate), dtype="float32",
               method=method, **kw)


@pytest.mark.parametrize("n_fft,hop,sr,mel,method", [
    (2048, 512, SR, MEL, "auto"), (2048, 512, SR, MEL, "pallas"),
    (1024, 256, 16000.0, (64, 0.0, 2000.0), "auto"), (512, 128, 16000.0, (40, 0.0, 1500.0), "auto"),
    (512, 128, 16000.0, (40, 0.0, 1500.0), "pallas"), (1024, 256, 16000.0, (64, 0.0, 8000.0), "auto"),
])
def test_engaged_depth_equals_jax(n_fft, hop, sr, mel, method):
    j = mel_plan(sg, "db", n_fft=n_fft, hop=hop, sr=sr, mel=mel, method=method)
    t = mel_plan(tg, "db", n_fft=n_fft, hop=hop, sr=sr, mel=mel, method=method)
    want = None if j._multirate_inner is None else j._multirate_inner[0]
    got = None if t._multirate_inner is None else t._multirate_inner[0]
    assert got == want
    if got is not None:
        inner = t._multirate_inner[1]
        assert inner.params.stft.centre is False and inner._n_fft == n_fft >> got
        assert inner.method == ("pallas" if method == "pallas" else "matmul")


@pytest.mark.parametrize("method", ["matmul", "pallas"])
@pytest.mark.parametrize("amp", ["power", "magnitude", "db"])
def test_multirate_mel_matches_jax(amp, method):
    xb = batch()
    want = np.asarray(mel_plan(sg, amp).compute_batch(xb))
    got = mel_plan(tg, amp, method=method).compute_batch(xb).numpy()
    assert got.shape == want.shape == (2, 80, 44)
    tol = 1e-3 if amp == "db" else 1e-5 * rel_max(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("method", ["matmul", "pallas"])
def test_multirate_loghz_matches_jax(method):
    x = music(0.5)

    def plan(m, multirate, meth):
        kw = dict(device="cpu") if m is tg else {}
        return m.SpectrogramPlan(m.SpectrogramParams(m.StftParams(2048, 512), SR),
                                 m.FreqScale.LOG_HZ, m.AmpScale.POWER,
                                 scale_params=m.LogHzParams(84, 27.5, 4186.0).with_multirate(multirate),
                                 dtype="float32", method=meth, **kw)

    want = np.asarray(plan(sg, True, "matmul").compute(x).data)
    got = plan(tg, True, method).compute(x).to_numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * rel_max(want))
    full = plan(tg, False, "matmul").compute(x).to_numpy()
    assert np.abs(got - full).max() <= 2e-4 * rel_max(full)  # test_multirate.py:147


@pytest.mark.parametrize("method", ["matmul", "pallas"])
def test_multirate_mfcc_matches_jax(method):
    xb = batch()
    want = np.asarray(mfcc_plan(sg).compute_batch(xb))
    got = mfcc_plan(tg, method=method).compute_batch(xb).numpy()
    assert got.shape == want.shape == (2, 13, 44)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * rel_max(want))


@pytest.mark.parametrize("method", ["matmul", "pallas"])
def test_multirate_chroma_matches_jax(method):
    xb = batch()
    j, t = chroma_plan(sg), chroma_plan(tg, method=method)
    assert t._decimation == j._decimation == 2
    want = np.asarray(j.compute_batch(xb))
    got = t.compute_batch(xb).numpy()
    assert got.shape == want.shape == (2, 12, 22)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * rel_max(want))


@pytest.mark.parametrize("amp", ["power", "magnitude", "db"])
def test_multirate_mel_matches_its_full_rate_plan(amp):
    for sig in (music(1.0), music(1.0)[:-5],
                np.random.default_rng(0).standard_normal(44100).astype(np.float32)):
        a = mel_plan(tg, amp, multirate=False).compute(sig).to_numpy()
        b = mel_plan(tg, amp, method="pallas").compute(sig).to_numpy()
        assert a.shape == b.shape
        if amp == "db":  # test_multirate.py:65-67
            energetic = a > a.max() - 50.0
            assert np.abs(a - b)[energetic].max() <= 5e-3
            assert np.abs(a - b).max() <= 2.0
        else:
            assert np.abs(a - b).max() <= 2e-4 * rel_max(a)


def test_multirate_mfcc_matches_its_full_rate_plan():
    x = music(1.0)
    a = mfcc_plan(tg, multirate=False).compute(x).to_numpy()
    b = mfcc_plan(tg, method="pallas").compute(x).to_numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-3 * rel_max(a)  # test_multirate.py:163


@pytest.mark.parametrize("centre", [True, False])
def test_multirate_chroma_matches_its_full_rate_plan(centre):
    x = music(1.0)[:-7]
    stft = (4096, 1024)
    full = tg.ChromaPlan(tg.StftParams(*stft, centre=centre), SR, device="cpu", dtype="float32")
    multi = tg.ChromaPlan(tg.StftParams(*stft, centre=centre), SR,
                          tg.ChromaParams.music_standard().with_multirate(), device="cpu",
                          dtype="float32", method="pallas")
    a, b = full.compute(x).to_numpy(), multi.compute(x).to_numpy()
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 2e-4 * rel_max(a)  # test_chroma.py:151
    # broadband noise, unnormalized: the 2^d rescale (test_chroma.py:133)
    xn = np.random.default_rng(5).standard_normal(44100).astype(np.float32)
    pn = tg.ChromaParams(norm=tg.ChromaNorm.NONE)
    a = tg.ChromaPlan(tg.StftParams(*stft), SR, pn, device="cpu").compute(xn).to_numpy()
    b = tg.ChromaPlan(tg.StftParams(*stft), SR, pn.with_multirate(), device="cpu").compute(xn)
    assert np.abs(a - b.to_numpy()).max() <= 5e-4 * rel_max(a)


def test_multirate_noop_at_full_band():
    x = np.random.default_rng(1).standard_normal(16000).astype(np.float32)
    kw = dict(n_fft=1024, hop=256, sr=16000.0, mel=(128, 0.0, 8000.0))
    full, multi = mel_plan(tg, "db", False, **kw), mel_plan(tg, "db", True, **kw)
    assert multi._multirate_inner is None and multi._fs_cascade_spec() is None
    assert torch.equal(full.compute(x).data, multi.compute(x).data)
    ch = tg.ChromaPlan(tg.StftParams(1024, 256), 16000.0,
                       tg.ChromaParams.music_standard().with_multirate(), device="cpu")
    assert ch._decimation == 0 and ch._fs_cascade_spec() is None


def test_multirate_batch_matches_single_and_forward_impl():
    x = music(0.5)
    xb = np.stack([x, x[::-1].copy()])
    for plan in (mel_plan(tg, "db", method="pallas"), mfcc_plan(tg, method="pallas"),
                 chroma_plan(tg, method="pallas")):
        cb = plan.compute_batch(xb).numpy()
        c0 = plan.compute(x).data.numpy()
        np.testing.assert_allclose(cb[0], c0, rtol=0, atol=1e-5 * rel_max(c0))
    p = mel_plan(tg, "db", method="pallas")
    np.testing.assert_allclose(p._forward_impl(torch.from_numpy(xb)).numpy(),
                               p.compute_batch(xb).numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("which", ["mel", "mfcc", "chroma"])
def test_plan_constants_from_numpy_carries_a_jax_multirate_plan(which):
    x = batch()
    if which == "mel":
        j, t = mel_plan(sg, "db"), mel_plan(tg, "db", method="pallas")
        inner = j._multirate_inner[1]
        tg.plan_constants_from_numpy(t, np.asarray(inner._window), np.asarray(inner._mapping_t).T)
        tol = 1e-3
    elif which == "mfcc":
        j, t = mfcc_plan(sg), mfcc_plan(tg, method="pallas")
        inner = j._mel_plan._multirate_inner[1]
        tg.plan_constants_from_numpy(t, np.asarray(inner._window),
                                     np.asarray(inner._mapping_t).T, np.asarray(j._basis))
        tol = None
    else:
        j, t = chroma_plan(sg), chroma_plan(tg, method="pallas")
        tg.plan_constants_from_numpy(t, np.asarray(j._mag_plan._window), np.asarray(j._fb_t).T)
        tol = None
    want = np.asarray(j.compute_batch(x))
    got = t.compute_batch(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol if tol is not None else 1e-5 * rel_max(want))
    if which == "mel":
        # the installed constants are the ones used: a doubled bank is +3 dB
        tg.plan_constants_from_numpy(t, np.asarray(inner._window),
                                     2.0 * np.asarray(inner._mapping_t).T)
        np.testing.assert_allclose(t.compute_batch(x).numpy(), want + 10 * np.log10(2.0),
                                   rtol=0, atol=2e-3)
        with pytest.raises(tg.DimensionMismatchError):  # full-rate shapes do not fit
            tg.plan_constants_from_numpy(t, np.asarray(j._window), np.asarray(j._mapping_t).T)


@pytest.mark.parametrize("which", ["mel", "mfcc", "chroma"])
def test_multirate_gradients_are_finite_and_the_plain_routes(which):
    plan = {"mel": lambda: mel_plan(tg, "db", method="pallas"),
            "mfcc": lambda: mfcc_plan(tg, method="pallas"),
            "chroma": lambda: chroma_plan(tg, method="pallas")}[which]()
    x = torch.from_numpy(music(0.25))
    a = x.clone().requires_grad_(True)
    plan._forward(a).sum().backward()
    assert bool(torch.isfinite(a.grad).all()) and float(a.grad.abs().max()) > 0
    b = x.clone().requires_grad_(True)
    twin = plan._forward_impl if which == "mel" else plan._plain_forward
    twin(b).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_multirate_jax_gradient_agrees():
    x = music(0.25)
    jp = mel_plan(sg, "power")
    g_ref = np.asarray(jax.grad(lambda s: jnp.sum(jp._forward(s)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    mel_plan(tg, "power", method="pallas")._forward(xt).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, rtol=0, atol=1e-4 * rel_max(g_ref))


def test_compute_frame_on_a_multirate_plan_warns_once():
    plan = mel_plan(tg, "db")
    x = music(0.25)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan.compute_frame(x, 1)
        plan.compute_frame(x, 2)
    assert len([w for w in caught if "multirate" in str(w.message)]) == 1
    full = mel_plan(tg, "db", multirate=False).compute(x).data.numpy()
    np.testing.assert_allclose(plan.compute_frame(x, 3).numpy(), full[:, 3], rtol=0, atol=1e-3)
