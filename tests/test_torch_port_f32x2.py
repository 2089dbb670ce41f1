"""The port's f64-grade tier (``method="f32x2"``, ``x2.py``) and its
double-double arithmetic (``ops/dd.py``) against the JAX package's, on the
CPU.

Same numpy inputs (seeded) through both packages. The bars are
``tests/test_f32x2.py``'s: 1e-13 relative to f64 for the dd primitives,
1e-12 for ``dd_rfft``, ``dd_matvec``, ``stft_x2``, ``fft2d_x2`` and the round
trips, 1e-9 relative to the CPU f64 plan for the plan tier, 1e-4 dB for
decibels, ``hi`` equal to ``compute_raw`` to 1e-6 and ``|lo| ≤
1e-6·max|hi|``; each is also held against JAX's output at the same bar.

- ``two_sum``, ``_split``, ``two_prod`` and ``dd_add`` give JAX's bits
  (jitted, on the CPU). ``dd_mul`` and what is built on it do not: XLA's
  CPU backend contracts ``x.hi·y.lo + x.lo·y.hi`` into an FMA, PyTorch rounds
  the product, so only the bounds are asked of them.
- The port computes the tier in float64 and splits it; its op-for-op dd
  route (``SpectrogramPlan._bins_x2_dd``) is held to JAX's ``_bins_x2``.
- Config 8 of ``benchmarks/suite.py`` at its own shapes: the plan at
  256/128 on a 1 s 440 Hz sine, the 512/128 round trip and a 128² 2-D FFT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.ops import dd as JD
from spectrograms_tpu.pipeline import SpectrogramPlan as JaxPlan
from spectrograms_tpu_torch.ops import dd as TD
from spectrograms_tpu_torch.ops.framing import frame_signal

SR = 16000.0
CPU = dict(device="cpu")


def _sig(n=16000, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def rel_err(got, ref):
    return float((np.abs(got - ref) / (np.abs(ref) + 1e-300)).max())


def spread(rng, n, lo_scale=1e-8):
    """f32 values over many binades, and a dd pair of them."""
    hi = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    lo = (hi.astype(np.float64) * rng.standard_normal(n) * lo_scale).astype(np.float32)
    return hi, lo


# ---- the error-free transformations ---------------------------------------------------


@pytest.mark.parametrize("name", ["two_sum", "_split", "two_prod", "dd_add"])
def test_error_free_transforms_equal_jax_bit_for_bit(name):
    rng = np.random.default_rng(0)
    a, al = spread(rng, 100_000)
    b, bl = spread(rng, 100_000)
    fn_j, fn_t = getattr(JD, name), getattr(TD, name)
    if name == "_split":
        j, t = jax.jit(fn_j)(a), fn_t(torch.from_numpy(a))
    elif name == "dd_add":
        j = jax.jit(fn_j)((a, al), (b, bl))
        t = fn_t((torch.from_numpy(a), torch.from_numpy(al)), (torch.from_numpy(b),
                                                               torch.from_numpy(bl)))
    else:
        j, t = jax.jit(fn_j)(a, b), fn_t(torch.from_numpy(a), torch.from_numpy(b))
    for x, y in zip(j, t):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_two_prod_and_split_are_exact():
    rng = np.random.default_rng(1)
    a, _ = spread(rng, 10_000)
    b, _ = spread(rng, 10_000)
    p, e = TD.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(),
                                  a.astype(np.float64) * b.astype(np.float64))
    hi, lo = TD._split(torch.from_numpy(a))
    np.testing.assert_array_equal(hi.double().numpy() + lo.double().numpy(), a.astype(np.float64))


def test_dd_split_and_recombine_equal_jax():
    x = np.random.default_rng(2).standard_normal(1000) * 1e3
    for a, b in zip(TD.dd_from_f64(x, **CPU), JD.dd_from_f64(x)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pair = TD.dd_from_f64(x, **CPU)
    np.testing.assert_array_equal(TD.dd_to_f64(pair), JD.dd_to_f64(JD.dd_from_f64(x)))
    np.testing.assert_allclose(TD.dd_to_f64(pair), x, rtol=2e-15)
    hi, lo = TD.dd(np.ones(3), **CPU)
    assert hi.dtype == torch.float32 and not lo.any()


@pytest.mark.parametrize("name", ["dd_mul", "dd_sqrt", "dd_sub"])
def test_dd_arithmetic_within_bounds_of_f64_and_jax(name):
    rng = np.random.default_rng(0)
    a64 = rng.standard_normal(4096) * 1e3
    b64 = rng.standard_normal(4096)
    if name == "dd_sqrt":
        ref, args, jargs = np.sqrt(np.abs(a64)), (TD.dd_from_f64(np.abs(a64), **CPU),), (
            JD.dd_from_f64(np.abs(a64)),)
    else:
        ref = a64 * b64 if name == "dd_mul" else a64 - b64
        args = (TD.dd_from_f64(a64, **CPU), TD.dd_from_f64(b64, **CPU))
        jargs = (JD.dd_from_f64(a64), JD.dd_from_f64(b64))
    got = TD.dd_to_f64(getattr(TD, name)(*args))
    np.testing.assert_allclose(got, ref, rtol=1e-13)
    np.testing.assert_allclose(got, JD.dd_to_f64(jax.jit(getattr(JD, name))(*jargs)), rtol=1e-13)


# ---- dd transforms ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_dd_rfft_matches_f64_and_jax(n):
    x64 = np.random.default_rng(2).standard_normal((3, n))
    X = np.fft.rfft(x64, axis=-1)
    (reh, rel_), (imh, iml) = TD.dd_rfft(TD.dd_from_f64(x64, **CPU), n)
    re, im = TD.dd_to_f64((reh, rel_)), TD.dd_to_f64((imh, iml))
    assert (np.abs(re - X.real) + np.abs(im - X.imag)).max() / np.abs(X).max() < 1e-12
    (jreh, jrel), (jimh, jiml) = jax.jit(lambda h, l: JD.dd_rfft((h, l), n))(*JD.dd_from_f64(x64))
    jre, jim = JD.dd_to_f64((jreh, jrel)), JD.dd_to_f64((jimh, jiml))
    assert (np.abs(re - jre) + np.abs(im - jim)).max() / np.abs(X).max() < 1e-12


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_dd_fft_and_inverses(n):
    rng = np.random.default_rng(n)
    z64 = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    z = (TD.dd_from_f64(z64.real, **CPU), TD.dd_from_f64(z64.imag, **CPU))
    re, im = TD.dd_fft(z, n)
    Z = np.fft.fft(z64, axis=-1)
    scale = np.abs(Z).max()
    assert np.abs(TD.dd_to_f64(re) + 1j * TD.dd_to_f64(im) - Z).max() / scale < 1e-13
    bre, bim = TD.dd_ifft((re, im), n)
    assert np.abs(TD.dd_to_f64(bre) + 1j * TD.dd_to_f64(bim) - z64).max() < 1e-13
    if n >= 2:
        x64 = rng.standard_normal((3, n))
        back = TD.dd_irfft(TD.dd_rfft(TD.dd_from_f64(x64, **CPU), n), n)
        assert np.abs(TD.dd_to_f64(back) - x64).max() < 1e-13
        jback = JD.dd_irfft(JD.dd_rfft(JD.dd_from_f64(x64), n), n)
        assert np.abs(TD.dd_to_f64(back) - JD.dd_to_f64(jback)).max() < 1e-13
    with pytest.raises(ValueError):
        TD.dd_fft(z, 3)


@pytest.mark.parametrize("shape", [(128, 513), (5, 7), (1, 1)])
def test_dd_matvec_and_tree_sum_match_f64_and_jax(shape):
    rng = np.random.default_rng(3)
    m64 = np.abs(rng.standard_normal(shape))
    v64 = np.abs(rng.standard_normal((7, shape[1])))
    got = TD.dd_to_f64(TD.dd_matvec(TD.dd_from_f64(m64, **CPU), TD.dd_from_f64(v64, **CPU)))
    ref = v64 @ m64.T
    assert got.shape == ref.shape and rel_err(got, ref) < 1e-12
    jgot = JD.dd_to_f64(jax.jit(JD.dd_matvec)(JD.dd_from_f64(m64), JD.dd_from_f64(v64)))
    assert rel_err(got, jgot) < 1e-12
    s = TD.dd_to_f64(TD.dd_tree_sum(TD.dd_from_f64(v64, **CPU)))
    assert rel_err(s, v64.sum(axis=-1)) < 1e-13


def test_dd_matvec_blocks_leave_each_output_unchanged(monkeypatch):
    """A block of one row at a time gives the same bits as one block."""
    rng = np.random.default_rng(4)
    m = TD.dd_from_f64(np.abs(rng.standard_normal((9, 33))), **CPU)
    v = TD.dd_from_f64(np.abs(rng.standard_normal((4, 33))), **CPU)
    whole = TD.dd_matvec(m, v)
    monkeypatch.setattr(TD, "_MATVEC_BLOCK", 1)
    for a, b in zip(whole, TD.dd_matvec(m, v)):
        assert torch.equal(a, b)


# ---- the plan tier -----------------------------------------------------------------------


CASES = [
    ("LINEAR", None, "POWER"),
    ("LINEAR", None, "MAGNITUDE"),
    ("MEL", (128, 0.0, 8000.0, "SLANEY"), "POWER"),
    ("MEL", (64, 100.0, 6000.0, "L2"), "MAGNITUDE"),
    ("ERB", (48, 50.0, 8000.0), "POWER"),
]


def make_plan(m, scale, sp, amp, dtype="float32", method="f32x2", n_fft=1024, hop=256, **kw):
    scale_params = None
    if scale == "MEL":
        scale_params = m.MelParams(*sp[:3], getattr(m.MelNorm, sp[3]))
    elif scale == "ERB":
        scale_params = m.ErbParams(*sp)
    cls = JaxPlan if m is sg else m.SpectrogramPlan
    if m is tg:
        kw.setdefault("device", "cpu")
    return cls(m.SpectrogramParams(m.StftParams(n_fft, hop), SR), getattr(m.FreqScale, scale),
               getattr(m.AmpScale, amp), scale_params=scale_params,
               log_params=m.LogParams(-80.0) if amp == "DECIBELS" else None, dtype=dtype,
               method=method, **kw)


@pytest.mark.parametrize("scale,sp,amp", CASES)
def test_f32x2_matches_cpu_f64_and_jax_to_1e9(scale, sp, amp):
    x = _sig()
    ref = np.asarray(make_plan(sg, scale, sp, amp, "float64", "fft").compute_raw(
        x.astype(np.float64)))
    plan = make_plan(tg, scale, sp, amp)
    got = TD.dd_to_f64(plan.compute_raw_x2(x))
    assert got.shape == ref.shape
    assert rel_err(got, ref) < 1e-9, f"{scale}/{amp}"
    jgot = JD.dd_to_f64(make_plan(sg, scale, sp, amp).compute_raw_x2(x))
    assert rel_err(got, jgot) < 1e-9


@pytest.mark.parametrize("scale,sp,amp", CASES)
def test_dd_route_matches_jax_dd_tier(scale, sp, amp):
    """The op-for-op plain version against JAX's ``_bins_x2`` on the same
    frames, and against f64."""
    x = _sig(4096, seed=2)
    plan = make_plan(tg, scale, sp, amp)
    frames = frame_signal(torch.from_numpy(x), 1024, 256, True)
    got = TD.dd_to_f64(plan._bins_x2_dd(frames))
    jplan = make_plan(sg, scale, sp, amp)
    jgot = JD.dd_to_f64(jax.jit(jplan._bins_x2)(jnp.asarray(frames.numpy())))
    assert rel_err(got, jgot) < 1e-9
    hi, lo = plan._bins_x2(frames)
    assert rel_err(got, TD.dd_to_f64((hi, lo))) < 1e-9


def test_f32x2_hi_equals_compute_raw():
    x = _sig()
    mel = ("MEL", (64, 0.0, 8000.0, "SLANEY"), "POWER")
    p2 = make_plan(tg, *mel, n_fft=512, hop=128)
    hi, lo = p2.compute_raw_x2(x)
    out = p2.compute_raw(x)
    np.testing.assert_allclose(out.numpy(), hi.numpy(), rtol=1e-6)
    assert float(lo.abs().max()) <= float(hi.abs().max()) * 1e-6
    jout = np.asarray(make_plan(sg, *mel, n_fft=512, hop=128).compute_raw(x))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-6, atol=1e-6 * np.abs(jout).max())


def test_f32x2_decibels_tier():
    """dB in f64 on the port (lo = the f64 remainder), within 1e-4 dB of the
    f64 plan and of JAX's dd tier (an f32 log with a first-order
    correction, lo = 0); the port's dd route keeps JAX's contract."""
    x = _sig()
    args = ("MEL", (64, 0.0, 8000.0, "SLANEY"), "DECIBELS")
    ref = np.asarray(make_plan(sg, *args, "float64", "fft").compute_raw(x.astype(np.float64)))
    plan = make_plan(tg, *args)
    hi, lo = plan.compute_raw_x2(x)
    got = TD.dd_to_f64((hi, lo))
    assert np.abs(got - ref).max() < 1e-4
    assert np.abs(got - ref).max() < 1e-10  # the port's dB is f64 all the way
    jhi, jlo = make_plan(sg, *args).compute_raw_x2(x)
    assert not np.asarray(jlo).any()
    assert np.abs(hi.numpy() - np.asarray(jhi)).max() < 1e-4
    dd_hi, dd_lo = plan._bins_x2_dd(frame_signal(torch.from_numpy(x), 1024, 256, True))
    assert not dd_lo.any() and np.abs(dd_hi.T.numpy() - ref).max() < 1e-4


def test_f32x2_validation_matches_jax():
    for m in (sg, tg):
        with pytest.raises(m.InvalidInputError, match="f32x2"):
            make_plan(m, "LINEAR", None, "POWER", dtype="float64")
        with pytest.raises(m.InvalidInputError, match="power-of-two"):
            make_plan(m, "LINEAR", None, "POWER", n_fft=400, hop=160)
        with pytest.raises(m.InvalidInputError, match="does not cover CQT"):
            cls = JaxPlan if m is sg else m.SpectrogramPlan
            cls(m.SpectrogramParams(m.StftParams(1024, 256), SR), m.FreqScale.CQT,
                m.AmpScale.POWER, scale_params=m.CqtParams(12, 3, 110.0), dtype="float32",
                method="f32x2", **({} if m is sg else CPU))
        with pytest.raises(m.InvalidInputError, match="compute_raw_x2 requires"):
            make_plan(m, "LINEAR", None, "POWER", method="fft").compute_raw_x2(_sig())
        with pytest.raises(m.InvalidInputError, match="unknown method"):
            make_plan(m, "LINEAR", None, "POWER", method="f32x3")
    assert make_plan(tg, "MEL", (64, 0.0, 8000.0, "SLANEY"), "POWER", method="auto").method \
        not in ("f32x2", "factored")


def test_f32x2_batch_frame_and_spectrogram_api():
    x = _sig()
    args = ("MEL", (32, 0.0, 8000.0, "SLANEY"), "POWER")
    p2 = make_plan(tg, *args, n_fft=512, hop=256)
    spec = p2.compute(x)
    assert tuple(spec.data.shape) == p2.output_shape(len(x))
    out = p2.compute_batch(np.stack([x, 0.5 * x]))
    np.testing.assert_allclose(out[0].numpy(), p2.compute_raw(x).numpy(), rtol=1e-6, atol=1e-8)
    jp = make_plan(sg, *args, n_fft=512, hop=256)
    np.testing.assert_allclose(p2.compute_frame(x, 7).numpy(), np.asarray(jp.compute_frame(x, 7)),
                               rtol=1e-6, atol=1e-6 * float(spec.data.max()))


def test_f32x2_stays_full_rate_under_multirate():
    x = _sig()
    plan = tg.SpectrogramPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), SR),
                              tg.FreqScale.MEL, tg.AmpScale.POWER,
                              scale_params=tg.MelParams(64, 0.0, 2000.0, tg.MelNorm.SLANEY,
                                                        multirate=True),
                              dtype="float32", method="f32x2", **CPU)
    assert plan._multirate_inner is None
    jplan = JaxPlan(sg.SpectrogramParams(sg.StftParams(1024, 256), SR), sg.FreqScale.MEL,
                    sg.AmpScale.POWER,
                    scale_params=sg.MelParams(64, 0.0, 2000.0, sg.MelNorm.SLANEY, multirate=True),
                    dtype="float32", method="f32x2")
    assert jplan._multirate_inner is None
    assert rel_err(TD.dd_to_f64(plan.compute_raw_x2(x)), JD.dd_to_f64(jplan.compute_raw_x2(x))) \
        < 1e-9


# ---- x2.py ---------------------------------------------------------------------------------


def test_stft_x2_matches_f64_and_jax():
    x = np.random.default_rng(0).standard_normal(8192).astype(np.float32)
    (reh, rel_), (imh, iml) = tg.stft_x2(x, 1024, 256, **CPU)
    ref = np.asarray(sg.stft(x.astype(np.float64), 1024, 256, dtype="float64"))
    got_re, got_im = TD.dd_to_f64((reh, rel_)), TD.dd_to_f64((imh, iml))
    scale = np.abs(ref).max()
    assert np.abs(got_re - ref.real).max() / scale < 1e-12
    assert np.abs(got_im - ref.imag).max() / scale < 1e-12
    (jreh, jrel), (jimh, jiml) = sg.stft_x2(x, 1024, 256)
    assert np.abs(got_re - JD.dd_to_f64((jreh, jrel))).max() / scale < 1e-12
    assert np.abs(got_im - JD.dd_to_f64((jimh, jiml))).max() / scale < 1e-12
    assert tuple(reh.shape) == np.asarray(jreh).shape


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (256, 64), (1024, 256)])
def test_istft_x2_roundtrip_f64_grade(n_fft, hop):
    x = np.random.default_rng(1).standard_normal(8192).astype(np.float32)
    hi, lo = tg.istft_x2(tg.stft_x2(x, n_fft, hop, **CPU), n_fft, hop, **CPU)
    rec = TD.dd_to_f64((hi, lo))
    rms = float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    assert rec.shape == x.shape and np.abs(rec - x).max() / rms < 1e-12
    jrec = JD.dd_to_f64(sg.istft_x2(sg.stft_x2(x, n_fft, hop), n_fft, hop))
    assert np.abs(rec - jrec).max() / rms < 1e-12
    # the pair is taken as given: JAX's own pairs give the same signal
    back = TD.dd_to_f64(tg.istft_x2(sg.stft_x2(x, n_fft, hop), n_fft, hop, **CPU))
    assert np.abs(back - jrec).max() / rms < 1e-12


@pytest.mark.parametrize("shape", [(128, 256), (64, 128), (2, 2)])
def test_fft2d_x2_and_inverse(shape):
    img = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    (reh, rel_), (imh, iml) = tg.fft2d_x2(img, **CPU)
    ref = np.fft.rfft2(img.astype(np.float64))
    scale = np.abs(ref).max()
    got = TD.dd_to_f64((reh, rel_)) + 1j * TD.dd_to_f64((imh, iml))
    assert np.abs(got - ref).max() / scale < 1e-12
    (jreh, jrel), (jimh, jiml) = sg.fft2d_x2(img)
    jgot = JD.dd_to_f64((jreh, jrel)) + 1j * JD.dd_to_f64((jimh, jiml))
    assert np.abs(got - jgot).max() / scale < 1e-12
    hi, lo = tg.ifft2d_x2(tg.fft2d_x2(img, **CPU), shape[1], **CPU)
    assert np.abs(TD.dd_to_f64((hi, lo)) - img).max() < 1e-12


def test_x2_validation_matches_jax():
    x = np.zeros(1000, dtype=np.float32)
    for m, kw in ((sg, {}), (tg, CPU)):
        with pytest.raises(m.InvalidInputError, match="power-of-two"):
            m.stft_x2(x, 1000, 250, **kw)
        with pytest.raises(m.InvalidInputError, match="hop_size"):
            m.stft_x2(x, 512, 0, **kw)
        with pytest.raises(m.InvalidInputError, match="non-empty 1-D"):
            m.stft_x2(np.zeros((2, 8), np.float32), 4, 2, **kw)
        with pytest.raises(m.InvalidInputError, match="dividing"):
            m.istft_x2(m.stft_x2(np.zeros(4096, np.float32), 512, 128, **kw), 512, 96, **kw)
        with pytest.raises(m.DimensionMismatchError):
            m.istft_x2(m.stft_x2(np.zeros(4096, np.float32), 512, 128, **kw), 256, 128, **kw)
        with pytest.raises(m.InvalidInputError, match="row count"):
            m.fft2d_x2(np.zeros((100, 128), np.float32), **kw)
        with pytest.raises(m.InvalidInputError, match="2-D"):
            m.fft2d_x2(np.zeros(128, np.float32), **kw)
        with pytest.raises(m.DimensionMismatchError):
            m.ifft2d_x2(m.fft2d_x2(np.zeros((64, 128), np.float32), **kw), 256, **kw)


# ---- benchmarks/suite.py config 8 ------------------------------------------------------------


def test_config8_readings_match_jax():
    x = np.sin(2 * np.pi * 440 * np.arange(16000) / 16000).astype(np.float32)
    ref = np.asarray(sg.LinearPowerPlan(sg.SpectrogramParams(sg.StftParams(256, 128), SR),
                                        dtype="float64").compute(x.astype(np.float64)).data)
    plan = make_plan(tg, "LINEAR", None, "POWER", n_fft=256, hop=128)
    jplan = make_plan(sg, "LINEAR", None, "POWER", n_fft=256, hop=128)
    err_x2 = np.abs(TD.dd_to_f64(plan.compute_raw_x2(x)) - ref).max() / ref.max()
    assert err_x2 < 1e-9
    # suite.py's own reading is the hi half (compute), f32-rounded: ~1e-8
    err_hi = np.abs(plan.compute(x).data.numpy() - ref).max() / ref.max()
    jerr_hi = np.abs(np.asarray(jplan.compute(x).data) - ref).max() / ref.max()
    assert err_hi < 1e-7 and jerr_hi < 1e-7

    rms = float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    rec = TD.dd_to_f64(tg.istft_x2(tg.stft_x2(x, 512, 128, **CPU), 512, 128, **CPU))
    assert np.abs(rec - x.astype(np.float64)).max() / rms < 1e-12

    img = np.random.default_rng(8).standard_normal((128, 128)).astype(np.float32)
    (reh, rel_), (imh, iml) = tg.fft2d_x2(img, **CPU)
    ref2 = np.fft.rfft2(img.astype(np.float64))
    g = TD.dd_to_f64((reh, rel_)) + 1j * TD.dd_to_f64((imh, iml))
    assert np.abs(g - ref2).max() / np.abs(ref2).max() < 1e-12
