"""The port's ERB gammatone bank against the JAX package's, on the CPU.

- ``ErbFilterbank``, ``gammatone_center_frequencies`` and the IIR bank
  (``make_iir_bank``) equal to JAX's: both are numpy;
- ``gammatone_iir_spectrogram`` by ``scan`` and by ``parallel`` against
  JAX's ``scan`` at f64, at 1e-9 relative (the JAX scalar-reference test,
  ``tests/test_cqt_erb.py:93-124``), and against that scalar reference;
  ``parallel`` against ``scan`` at JAX's 1e-10; the dB floor; the
  validation errors; the ERB cases of ``tests/test_cqt_erb.py`` on the port.
"""

import importlib

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from tests.conftest import sine

je = importlib.import_module("spectrograms_tpu.erb")
te = importlib.import_module("spectrograms_tpu_torch.erb")

SR = 16000.0
CPU = dict(device="cpu")

BANKS = [
    lambda m: m.ErbParams(32, 50.0, 8000.0),
    lambda m: m.ErbParams(16, 50.0, 8000.0, spacing=m.ErbSpacing.APPLE_TR35),
    lambda m: m.ErbParams(4, 100.0, 4000.0),
    lambda m: m.ErbParams(64, 20.0, 7600.0),
]


@pytest.mark.parametrize("bank", range(len(BANKS)))
def test_bank_constants_equal_jax(bank):
    jp, tp = BANKS[bank](sg), BANKS[bank](tg)
    cfs = tg.gammatone_center_frequencies(tp)
    np.testing.assert_array_equal(cfs, sg.gammatone_center_frequencies(jp))
    for sr in (8000.0, 16000.0, 44100.0):
        for a, b in zip(te.make_iir_bank(cfs, sr), je.make_iir_bank(cfs, sr)):
            np.testing.assert_array_equal(a, b)
    tf, jf = tg.ErbFilterbank(tp, SR, 1024), sg.ErbFilterbank(jp, SR, 1024)
    assert tf.num_filters == jf.num_filters
    np.testing.assert_array_equal(tf.response_matrix, jf.response_matrix)
    np.testing.assert_array_equal(tf.center_frequencies, jf.center_frequencies)
    ps = np.abs(np.random.default_rng(bank).standard_normal((513, 9)))
    got = tf.apply_to_power_spectrum(torch.from_numpy(ps))
    assert got.dtype == torch.float64 and got.shape == (tf.num_filters, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(jf.apply_to_power_spectrum(ps)),
                               rtol=1e-12, atol=1e-12)


def test_erb_filterbank_validation():
    for m in (sg, tg):
        with pytest.raises(m.InvalidInputError, match="sample_rate"):
            m.ErbFilterbank(m.ErbParams(8, 100.0, 4000.0), 0.0, 512)


CASES = [
    # (n samples, sr, frame, hop, bank)
    (600, SR, 256, 128, 2),
    (8000, 8000.0, 512, 256, None),
    (4000, SR, 1024, 512, 0),
    (5000, SR, 300, 170, 1),
]


@pytest.mark.parametrize("method", ["scan", "parallel", "auto"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_gammatone_matches_jax_scan(case, method):
    n, sr, frame, hop, bank = CASES[case]
    x = 0.3 * np.random.default_rng(case).standard_normal(n)
    mk = (lambda m: m.ErbParams(16, 80.0, 3500.0)) if bank is None else BANKS[bank]
    want, jcfs = sg.gammatone_iir_spectrogram(x, sr, frame, hop, mk(sg), dtype="float64",
                                              method="scan")
    got, cfs = tg.gammatone_iir_spectrogram(x, sr, frame, hop, mk(tg), dtype="float64",
                                            method=method, **CPU)
    assert got.dtype == torch.float64 and tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_array_equal(cfs, jcfs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=0)


def test_gammatone_f32_output_and_db():
    x = sine(440.0, duration=0.25)
    p = lambda m: m.ErbParams(8, 100.0, 4000.0).with_db_floor(-60.0)
    want, _ = sg.gammatone_iir_spectrogram(x, SR, 512, 256, p(sg), dtype="float32")
    got, _ = tg.gammatone_iir_spectrogram(x, SR, 512, 256, p(tg), dtype="float32", **CPU)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_gammatone_iir_peak_band():
    g, cfs = tg.gammatone_iir_spectrogram(sine(440.0, duration=0.5), SR, 1024, 256,
                                          tg.ErbParams(32, 50.0, 8000.0), **CPU)
    assert g.shape[0] == 32
    peak_cf = cfs[int(np.argmax(g.numpy().mean(axis=1)))]
    assert peak_cf == pytest.approx(cfs[np.argmin(np.abs(cfs - 440.0))])


@pytest.mark.parametrize("method", ["scan", "parallel"])
def test_gammatone_iir_matches_scalar_reference(method):
    """Both lowerings against a direct per-sample biquad cascade (1e-9)."""
    x = np.random.default_rng(0).standard_normal(600)
    g, cfs = tg.gammatone_iir_spectrogram(x, SR, 256, 128, tg.ErbParams(4, 100.0, 4000.0),
                                          dtype="float64", method=method, **CPU)
    g = g.numpy()
    a, b = te.make_iir_bank(cfs, SR)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(256) / 255)

    def biquad(a0, a1, b1, b2, sig):
        z0 = z1 = 0.0
        out = np.empty_like(sig)
        for i, xv in enumerate(sig):
            y = a0 * xv + z0
            z0 = a1 * xv + z1 - b1 * y
            z1 = -b2 * y
            out[i] = y
        return out

    for band in range(4):
        for frame in range(g.shape[1]):
            sig = x[frame * 128 : frame * 128 + 256] * w
            for s in range(4):
                sig = biquad(a[band, s, 0], a[band, s, 1], b[band, 0], b[band, 1], sig)
            assert np.isclose(g[band, frame], np.sqrt(np.mean(sig**2)), rtol=1e-9), (band, frame)


def test_gammatone_parallel_matches_scan():
    x = 0.3 * np.random.default_rng(0).standard_normal(8000)
    p = tg.ErbParams(16, 80.0, 3500.0)
    a, _ = tg.gammatone_iir_spectrogram(x, 8000.0, 512, 256, p, dtype="float64", method="scan",
                                        **CPU)
    b, _ = tg.gammatone_iir_spectrogram(x, 8000.0, 512, 256, p, dtype="float64",
                                        method="parallel", **CPU)
    assert a.shape == b.shape
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("method", ["scan", "parallel"])
def test_gammatone_db_floor(method):
    g, _ = tg.gammatone_iir_spectrogram(np.zeros(4000), SR, 1024, 512,
                                        tg.ErbParams(8, 100.0, 4000.0).with_db_floor(-60.0),
                                        method=method, **CPU)
    assert np.allclose(g.numpy(), -60.0, atol=1e-9)


def test_gammatone_validation_matches_jax():
    for m, kw in ((sg, {}), (tg, CPU)):
        p = m.ErbParams(8, 100.0, 4000.0)
        with pytest.raises(m.InvalidInputError, match="shorter than frame_size"):
            m.gammatone_iir_spectrogram(np.ones(100), SR, 1024, 256, p, **kw)
        with pytest.raises(m.InvalidInputError, match="auto/scan/parallel"):
            m.gammatone_iir_spectrogram(np.ones(2000), SR, 1024, 256, p, method="bogus", **kw)
        with pytest.raises(m.InvalidInputError, match="sample_rate"):
            m.gammatone_iir_spectrogram(np.ones(2000), 0.0, 1024, 256, p, **kw)


def test_erb_freq_domain_response():
    resp = tg.ErbFilterbank(tg.ErbParams(16, 100.0, 7000.0), SR, 1024)
    assert resp.response_matrix.shape == (16, 513)
    df = SR / 1024
    for i, cf in enumerate(resp.center_frequencies):
        assert abs(int(np.argmax(resp.response_matrix[i])) * df - cf) <= df
        assert resp.response_matrix[i].max() <= 1.0 + 1e-9


def test_erb_apple_tr35_spacing():
    lin = tg.gammatone_center_frequencies(tg.ErbParams(16, 50.0, 8000.0))
    app = tg.gammatone_center_frequencies(
        tg.ErbParams(16, 50.0, 8000.0, spacing=tg.ErbSpacing.APPLE_TR35))
    assert np.all(np.diff(lin) > 0) and np.all(np.diff(app) > 0)
    assert not np.allclose(lin, app)


def test_audio_namespace_matches_jax():
    """The ``audio`` namespace module exports JAX's names that the port has."""
    ja = importlib.import_module("spectrograms_tpu.audio")
    ta = importlib.import_module("spectrograms_tpu_torch.audio")
    public = lambda mod: {n for n in vars(mod) if not n.startswith("_")}
    assert public(ja) - public(ta) <= {"annotations"}
    for name in ("cqt", "CqtResult", "ErbFilterbank", "gammatone_iir_spectrogram",
                 "CqtPowerPlan", "ChromaPlan", "MfccPlan", "griffin_lim"):
        assert getattr(ta, name) is getattr(tg, name)
