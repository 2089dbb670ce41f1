"""The port's binaural analysis against the JAX package's, on the CPU.

Counterparts of every test in ``tests/test_binaural.py``, with its inputs,
and parity with the JAX functions on the same seeded inputs, for the four
one-shots and the four ``_batch`` functions at float64 and float32.

Tolerances. float64: values at 1e-9 (ILD in dB, ILR, and IPD/ITD as below).
float32: ILD at 1e-3 dB, ILR at 1e-4, phases at 1e-3 rad; the two FFTs
round differently, and bins far below the frame's energy carry that
rounding in their phase, so float32 phases are compared only where both
channels' magnitudes exceed 1e-3 of the row's peak. The wrap rule: IPD and
ITD are phase differences wrapped at ±π, where float rounding in either
package can put a value on the other side of the cut, so they are compared
modulo 2π (ITD as the phase 2π·f·ITD it comes from). Histograms are
compared on float64 inputs, where the two agree; the ITD at bin 0 (a start
frequency under half a bin) divides by zero in both packages and is held
equal, NaN and infinity included.
"""

import math

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.binaural import _histogram_core as jax_histogram_core

SR = 16000.0
CPU = dict(device="cpu")


def params(m):
    return m.SpectrogramParams(m.StftParams(512, 256), SR)


PARAMS = params(tg)


def stereo(n=4096, delay=0, gain=1.0, freq=300.0):
    """Left = sine; right = delayed/scaled copy (``tests/test_binaural.py``)."""
    t = np.arange(n + abs(delay)) / SR
    base = np.sin(2 * np.pi * freq * t)
    left = base[:n]
    right = gain * base[delay:n + delay] if delay >= 0 else gain * base[:n]
    return left, right


def noisy_stereo(seed=0, n=8000, batch=None):
    """Correlated noise channels: a common source, delayed and scaled, plus
    independent noise."""
    rng = np.random.default_rng(seed)
    shape = (n + 16,) if batch is None else (batch, n + 16)
    src = rng.standard_normal(shape)
    left = src[..., 16:] + 0.3 * rng.standard_normal(src[..., 16:].shape)
    right = 0.7 * src[..., 9:n + 9] + 0.3 * rng.standard_normal(src[..., 16:].shape)
    return np.stack([left, right], axis=-2)


def wrapped_diff(a, b):
    return np.remainder(a - b + np.pi, 2 * np.pi) - np.pi


def kind_params(m, kind, **kw):
    cls = {"itd": m.ITDSpectrogramParams, "ipd": m.IPDSpectrogramParams,
           "ild": m.ILDSpectrogramParams, "ilr": m.ILRSpectrogramParams}[kind]
    return cls(params(m), **kw)


def assert_kind_close(kind, got, want, dtype, bins=None, bw=None, mags=None):
    """``got``/``want`` (..., bins, frames) under the module's rules."""
    f64 = dtype == "float64"
    if kind in ("ild", "ilr"):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        tol = 1e-9 if f64 else (1e-3 if kind == "ild" else 1e-4)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, equal_nan=True)
        return
    if kind == "itd":  # back to the wrapped phase it was divided from
        scale = 2 * np.pi * bw * bins[:, None]
        got, want = got * scale, want * scale
    d = np.abs(wrapped_diff(got, want))
    if not f64:
        d = d[mags]
    assert d.max() <= (1e-9 if f64 else 1e-3), d.max()


def live_bins(stereo_x, p, start_bin, stop_bin):
    """Where both channels' |X| exceed 1e-3 of the row's peak (f64 STFT)."""
    spec = np.asarray(sg.StftPlan(p, dtype="float64").compute(stereo_x.reshape(-1, stereo_x.shape[-1])[0]).data)
    spec_r = np.asarray(sg.StftPlan(p, dtype="float64").compute(stereo_x.reshape(-1, stereo_x.shape[-1])[1]).data)
    ml, mr = np.abs(spec[start_bin:stop_bin]), np.abs(spec_r[start_bin:stop_bin])
    peak = max(ml.max(), mr.max())
    return (ml > 1e-3 * peak) & (mr > 1e-3 * peak)


# ---- tests/test_binaural.py, one for one ----------------------------------------------

def test_magphase():
    spec = np.array([[3 + 4j, 0 + 0j]])
    mag, phase = tg.magphase(spec, 1)
    assert np.allclose(mag.numpy(), [[5.0, 0.0]])
    assert np.allclose(phase.numpy(), [[0.6 + 0.8j, 1.0 + 0.0j]])
    mag2, _ = tg.magphase(spec, 2)
    assert np.allclose(mag2.numpy(), [[25.0, 0.0]])
    rng = np.random.default_rng(4)
    c = rng.standard_normal((5, 7)) + 1j * rng.standard_normal((5, 7))
    c[0, 0] = 0
    for power in (1, 2, 3):
        for got, want in zip(tg.magphase(c, power), sg.magphase(c, power)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)
    for m in (tg, sg):
        with pytest.raises(m.InvalidInputError, match="power must be >= 1"):
            m.magphase(c, 0)


def test_params_validation():
    for m in (tg, sg):
        p = params(m)
        with pytest.raises(m.InvalidInputError, match="positive"):
            m.ITDSpectrogramParams(p, -1.0, 620.0)
        with pytest.raises(m.InvalidInputError, match="less than end"):
            m.ITDSpectrogramParams(p, 620.0, 50.0)
        with pytest.raises(m.InvalidInputError, match="Nyquist"):
            m.ILDSpectrogramParams(p, 1700.0, 9000.0)
        with pytest.raises(m.InvalidInputError, match="magphase_power"):
            m.ITDSpectrogramParams(p, magphase_power=0)
    p = tg.ITDSpectrogramParams(PARAMS)
    assert (p.start_freq, p.end_freq, p.magphase_power) == (50.0, 620.0, 1)
    assert tg.ILDSpectrogramParams(PARAMS).start_freq == 1700.0


def test_itd_identical_channels_zero():
    l, r = stereo()
    itd = tg.compute_itd_spectrogram([l, l], tg.ITDSpectrogramParams(PARAMS), dtype="float64",
                                     **CPU)
    assert np.allclose(itd.to_numpy(), 0.0, atol=1e-12)
    assert itd.unit_label == "ITD (seconds)"
    bw = SR / 512
    assert itd.frequencies[0] == pytest.approx(round(50.0 / bw) * bw)


def test_itd_detects_delay():
    delay = 8
    l, r = stereo(delay=delay, freq=250.0)
    itd = tg.compute_itd_spectrogram([l, r], tg.ITDSpectrogramParams(PARAMS, 100.0, 400.0),
                                     dtype="float64", **CPU)
    data = itd.to_numpy()
    bw = SR / 512
    tone_bin = int(round(250.0 / bw)) - int(round(100.0 / bw))
    assert np.allclose(data[tone_bin, 3:-3], -delay / SR, atol=5e-6)


def test_ipd_wrapped_range():
    l, r = stereo(delay=16, freq=500.0)
    p = tg.IPDSpectrogramParams(PARAMS, 50.0, 620.0, wrapped=True)
    ipd = tg.compute_ipd_spectrogram([l, r], p, dtype="float64", **CPU)
    d = ipd.to_numpy()
    assert np.all(d >= -np.pi - 1e-9) and np.all(d <= np.pi + 1e-9)
    assert ipd.unit_label == "IPD (radians)"


def test_ild_gain():
    l, r = stereo(gain=0.5, freq=2500.0)
    ild = tg.compute_ild_spectrogram([l, r], tg.ILDSpectrogramParams(PARAMS), dtype="float64",
                                     **CPU)
    d = ild.to_numpy()
    assert np.nanmedian(d[np.isfinite(d)]) == pytest.approx(6.0206, abs=0.1)


def test_ilr_range_and_sign():
    l, r = stereo(gain=0.5, freq=2500.0)
    ilr = tg.compute_ilr_spectrogram([l, r], tg.ILRSpectrogramParams(PARAMS), dtype="float64",
                                     **CPU)
    d = ilr.to_numpy()
    finite = d[np.isfinite(d)]
    assert np.all(finite >= -1.0 - 1e-9) and np.all(finite <= 1.0 + 1e-9)
    assert np.nanmedian(finite) == pytest.approx(0.5, abs=0.05)


def test_histograms():
    l, r = stereo(delay=4)
    out = {}
    for m in (tg, sg):
        kw = dict(dtype="float64", **(CPU if m is tg else {}))
        p = params(m)
        out[m] = (m.compute_itd_spectrogram([l, r], m.ITDSpectrogramParams(p), **kw),
                  m.compute_ild_spectrogram([l, r], m.ILDSpectrogramParams(p), **kw),
                  m.compute_ipd_spectrogram([l, r], m.IPDSpectrogramParams(p), **kw),
                  m.compute_ilr_spectrogram([l, r], m.ILRSpectrogramParams(p), **kw))
    itd, ild, ipd, ilr = out[tg]
    h = itd.histogram(normalize=True)
    assert h.shape == (400, itd.n_frames)
    sums = h.sum(axis=0)
    assert np.all((np.abs(sums - 1.0) < 1e-9) | (sums == 0.0))
    assert ild.histogram(num_bins=100).shape == (100, ild.n_frames)
    assert ipd.histogram().shape[0] == 400
    assert ilr.histogram(exponent=1).shape[0] == 400
    # each histogram equal to JAX's, on the same float64 inputs
    for res, jres, kw in zip(out[tg], out[sg], ({"normalize": True}, {"num_bins": 100}, {},
                                                 {"exponent": 1})):
        np.testing.assert_array_equal(res.histogram(**kw), jres.histogram(**kw))
        np.testing.assert_array_equal(res.histogram(), jres.histogram())


def test_diff_functions():
    l, r = stereo(delay=4)
    p = tg.ITDSpectrogramParams(PARAMS)
    col_means, deg, med = tg.compute_itd_spectrogram_diff([l, l], [l, r], p, dtype="float64",
                                                          **CPU)
    assert col_means.shape == (len(col_means),) and isinstance(col_means, np.ndarray)
    assert np.isfinite(deg) and np.isfinite(med)
    jcm, jdeg, jmed = sg.compute_itd_spectrogram_diff([l, l], [l, r],
                                                      sg.ITDSpectrogramParams(params(sg)),
                                                      dtype="float64")
    np.testing.assert_allclose(col_means, jcm, rtol=0, atol=1e-15)
    assert deg == pytest.approx(jdeg, rel=1e-9) and med == pytest.approx(jmed, abs=1e-15)
    cm0, deg0, _ = tg.compute_itd_spectrogram_diff([l, r], [l, r], p, dtype="float64", **CPU)
    assert np.allclose(cm0, 0.0, atol=1e-12) and deg0 == pytest.approx(0.0, abs=1e-9)
    ilr_p = tg.ILRSpectrogramParams(PARAMS)
    _, mean_diff = tg.compute_ilr_spectrogram_diff([l, r], [l, r], ilr_p, dtype="float64", **CPU)
    assert mean_diff == pytest.approx(0.0, abs=1e-12)
    l2, r2 = stereo(gain=0.5, freq=2500.0)
    cm, md = tg.compute_ilr_spectrogram_diff([l, r], [l2, r2], ilr_p, dtype="float64", **CPU)
    jcm, jmd = sg.compute_ilr_spectrogram_diff([l, r], [l2, r2],
                                               sg.ILRSpectrogramParams(params(sg)),
                                               dtype="float64")
    np.testing.assert_allclose(cm, jcm, rtol=0, atol=1e-9)
    assert md == pytest.approx(jmd, abs=1e-9)


def test_channel_validation():
    l, _ = stereo()
    for m in (tg, sg):
        kw = CPU if m is tg else {}
        p = m.ITDSpectrogramParams(params(m))
        with pytest.raises(m.InvalidInputError, match="left, right"):
            m.compute_itd_spectrogram([l], p, **kw)
        with pytest.raises(m.InvalidInputError, match="same length"):
            m.compute_itd_spectrogram([l, l[:100]], p, **kw)
        with pytest.raises(m.InvalidInputError, match="non-empty"):
            m.compute_itd_spectrogram([l[:0], l[:0]], p, **kw)


def test_result_axes():
    l, r = stereo()
    itd = tg.compute_itd_spectrogram([l, r], tg.ITDSpectrogramParams(PARAMS), dtype="float64",
                                     **CPU)
    jitd = sg.compute_itd_spectrogram([l, r], sg.ITDSpectrogramParams(params(sg)),
                                      dtype="float64")
    assert itd.n_bins == len(itd.frequencies) and itd.n_frames == len(itd.times)
    assert itd.duration() > 0
    lo, hi = itd.frequency_range()
    assert lo < hi <= 620.0 + SR / 512
    np.testing.assert_array_equal(itd.frequencies, jitd.frequencies)
    np.testing.assert_array_equal(itd.times, jitd.times)
    assert itd.shape == jitd.shape and itd.dtype == jitd.dtype == "float64"
    assert itd.duration() == jitd.duration()
    assert itd.frequency_range() == jitd.frequency_range()
    np.testing.assert_array_equal(np.asarray(itd), itd.to_numpy())
    assert torch.equal(torch.from_dlpack(itd), itd.data)
    assert itd.__dlpack_device__() == (1, 0)


def test_batch_matches_single():
    batch = []
    for i in range(3):
        l, r = stereo(delay=i + 1, gain=1.0 + 0.2 * i, freq=250.0 + 50 * i)
        batch.append(np.stack([l, r]))
    xb = np.stack(batch)
    for kind, batch_fn, single_fn, p in [
        ("itd", tg.compute_itd_spectrogram_batch, tg.compute_itd_spectrogram,
         tg.ITDSpectrogramParams(PARAMS)),
        ("ipd", tg.compute_ipd_spectrogram_batch, tg.compute_ipd_spectrogram,
         tg.IPDSpectrogramParams(PARAMS, wrapped=True)),
        ("ild", tg.compute_ild_spectrogram_batch, tg.compute_ild_spectrogram,
         tg.ILDSpectrogramParams(PARAMS)),
        ("ilr", tg.compute_ilr_spectrogram_batch, tg.compute_ilr_spectrogram,
         tg.ILRSpectrogramParams(PARAMS)),
    ]:
        out = batch_fn(xb, p, dtype="float64", **CPU)
        assert isinstance(out, torch.Tensor) and out.shape[0] == 3 and out.device.type == "cpu"
        for i in range(3):
            ref = single_fn([xb[i, 0], xb[i, 1]], p, dtype="float64", **CPU).to_numpy()
            np.testing.assert_allclose(out[i].numpy(), ref, rtol=1e-10, atol=1e-12,
                                       err_msg=kind)


def test_batch_input_validation():
    for m in (tg, sg):
        kw = CPU if m is tg else {}
        with pytest.raises(m.InvalidInputError, match="stereo batch"):
            m.compute_itd_spectrogram_batch(np.zeros((3, 4, 100)),
                                            m.ITDSpectrogramParams(params(m)), **kw)
        with pytest.raises(m.InvalidInputError, match="stereo batch"):
            m.compute_ild_spectrogram_batch(np.zeros((2, 100)),
                                            m.ILDSpectrogramParams(params(m)), **kw)
        with pytest.raises(m.InvalidInputError, match="non-empty"):
            m.compute_ild_spectrogram_batch(np.zeros((2, 2, 0)),
                                            m.ILDSpectrogramParams(params(m)), **kw)


@pytest.mark.parametrize("exponent,normalize", [(1, False), (3, False), (3, True)])
def test_vectorized_histogram_matches_loop(exponent, normalize):
    """The port's copy of ``_histogram_core`` equals JAX's (which
    ``tests/test_binaural.py`` holds against its per-frame loop)."""
    from spectrograms_tpu_torch.binaural import _histogram_core

    rng = np.random.default_rng(11)
    data = rng.uniform(-30, 30, size=(40, 1000))
    data[rng.uniform(size=data.shape) < 0.05] = np.nan
    got = _histogram_core(data, 50, (-24.0, 24.0), exponent, normalize)
    want = jax_histogram_core(data, 50, (-24.0, 24.0), exponent, normalize)
    np.testing.assert_array_equal(got, want)


def test_batch_with_unhashable_custom_window_builds_uncached():
    w = tg.WindowType("custom", coefficients=[0.5] * 512)
    p = tg.ITDSpectrogramParams(tg.SpectrogramParams(tg.StftParams(512, 256, window=w), SR))
    xb = np.random.default_rng(0).standard_normal((2, 2, 2048)).astype(np.float32)
    out = tg.compute_itd_spectrogram_batch(xb, p, **CPU)
    assert out.shape[0] == 2 and out.dtype == torch.float32
    jw = sg.WindowType("custom", coefficients=[0.5] * 512)
    jp = sg.ITDSpectrogramParams(sg.SpectrogramParams(sg.StftParams(512, 256, window=jw), SR))
    want = np.asarray(sg.compute_itd_spectrogram_batch(xb, jp))
    assert out.shape == want.shape


# ---- parity with the JAX functions ---------------------------------------------------

KINDS = [("itd", {}), ("ipd", {"wrapped": True}), ("ipd", {"wrapped": False}), ("ild", {}),
         ("ilr", {})]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind,kw", KINDS, ids=[f"{k}{v}" for k, v in KINDS])
def test_one_shots_match_jax(kind, kw, dtype):
    x = noisy_stereo(seed=1).astype(dtype)
    tp, jp = kind_params(tg, kind, **kw), kind_params(sg, kind, **kw)
    got = getattr(tg, f"compute_{kind}_spectrogram")(x, tp, dtype=dtype, **CPU)
    want = getattr(sg, f"compute_{kind}_spectrogram")(x, jp, dtype=dtype)
    from spectrograms_tpu_torch.binaural import _bin_range

    b0, b1, bw = _bin_range(tp)
    assert type(got).__name__ == type(want).__name__ and got.dtype == want.dtype == dtype
    assert got.unit_label == want.unit_label
    assert_kind_close(kind, got.to_numpy(), np.asarray(want.data), dtype,
                      np.arange(b0, b1), bw, live_bins(x.astype(np.float64), params(sg), b0, b1))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind,kw", KINDS, ids=[f"{k}{v}" for k, v in KINDS])
def test_batches_match_jax(kind, kw, dtype):
    xb = noisy_stereo(seed=2, n=6000, batch=3).astype(dtype)
    tp, jp = kind_params(tg, kind, **kw), kind_params(sg, kind, **kw)
    got = getattr(tg, f"compute_{kind}_spectrogram_batch")(xb, tp, dtype=dtype, **CPU)
    want = np.asarray(getattr(sg, f"compute_{kind}_spectrogram_batch")(xb, jp, dtype=dtype))
    assert got.shape == want.shape and str(got.dtype) == f"torch.{dtype}"
    from spectrograms_tpu_torch.binaural import _bin_range

    b0, b1, bw = _bin_range(tp)
    for i in range(xb.shape[0]):
        assert_kind_close(kind, got[i].numpy(), want[i], dtype, np.arange(b0, b1), bw,
                          live_bins(xb[i].astype(np.float64), params(sg), b0, b1))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_itd_at_bin_zero_matches_jax(dtype):
    """A start frequency under half a bin rounds to bin 0, where ITD
    divides by zero: NaN or −∞ in both packages, and equal rows above."""
    x = noisy_stereo(seed=3).astype(dtype)
    tp = tg.ITDSpectrogramParams(PARAMS, 10.0, 300.0)
    jp = sg.ITDSpectrogramParams(params(sg), 10.0, 300.0)
    got = tg.compute_itd_spectrogram(x, tp, dtype=dtype, **CPU).to_numpy()
    want = np.asarray(sg.compute_itd_spectrogram(x, jp, dtype=dtype).data)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[0], want[0])
    assert not np.isfinite(got[0]).any()
    tg_batch = tg.compute_itd_spectrogram_batch(x[None], tp, dtype=dtype, **CPU)[0].numpy()
    np.testing.assert_array_equal(tg_batch[0], want[0])


def test_batch_window_cache_is_bounded_and_keyed_on_device():
    from spectrograms_tpu_torch import binaural as tb

    tb._BATCH_WINDOWS.clear()
    xb = np.zeros((1, 2, 1024))
    for i in range(40):
        p = tg.ILDSpectrogramParams(tg.SpectrogramParams(tg.StftParams(512, 256), SR),
                                    1000.0 + i, 4600.0)
        tg.compute_ild_spectrogram_batch(xb, p, **CPU)
    assert len(tb._BATCH_WINDOWS) == tb._BATCH_WINDOWS_MAX == 32
    assert all(k[3] == torch.device("cpu") for k in tb._BATCH_WINDOWS)
    assert math.isclose(float(next(iter(tb._BATCH_WINDOWS.values()))[256]), 1.0, rel_tol=1e-2)
