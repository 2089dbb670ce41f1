"""``tests/test_scipy_equivalence.py`` held on the port, on the CPU.

Each test holds the port against SciPy (or NumPy) at the JAX test's
tolerance, and against the JAX function on the same input at the same
tolerance: windows, convolution, overlap-save, minimum phase, the STFT
against ``ShortTimeFFT``, the 2-D FFT and the shifts, a SciPy window as a
custom window through a plan.
"""

import numpy as np
import pytest
import scipy.signal

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from tests.conftest import noise

CPU = dict(device="cpu")


def close(out, scipy_ref, jax_ref, **tol):
    np.testing.assert_allclose(out, scipy_ref, **tol)
    np.testing.assert_allclose(out, jax_ref, **tol)


# ---- windows ---------------------------------------------------------------

@pytest.mark.parametrize("ours,scipy_name", [("HANNING", "hann"), ("HAMMING", "hamming"),
                                             ("BLACKMAN", "blackman")])
def test_windows_match_scipy_symmetric(ours, scipy_name):
    """``test_scipy_equivalence.py::test_windows_match_scipy_symmetric``:
    symmetric (N-1) windows at atol 1e-12."""
    n = 512
    w = np.asarray(tg.make_window(getattr(tg.WindowType, ours), n, np.float64))
    close(w, scipy.signal.get_window(scipy_name, n, fftbins=False),
          np.asarray(sg.make_window(getattr(sg.WindowType, ours), n, np.float64)), atol=1e-12)


def test_kaiser_matches_scipy():
    """``test_scipy_equivalence.py::test_kaiser_matches_scipy`` (rtol 1e-9,
    atol 1e-12)."""
    n, beta = 512, 8.0
    w = np.asarray(tg.make_window(tg.WindowType.kaiser(beta), n, np.float64))
    close(w, scipy.signal.get_window(("kaiser", beta), n, fftbins=False),
          np.asarray(sg.make_window(sg.WindowType.kaiser(beta), n, np.float64)),
          rtol=1e-9, atol=1e-12)


# ---- convolution ----------------------------------------------------------

def test_fft_convolve_matches_scipy():
    """``test_scipy_equivalence.py::test_fft_convolve_matches_scipy``
    (rtol 1e-9, atol 1e-9)."""
    a, b = noise(1000, seed=1), noise(257, seed=2)
    close(tg.fft_convolve(a, b, **CPU).numpy(), scipy.signal.fftconvolve(a, b, mode="full"),
          np.asarray(sg.fft_convolve(a, b)), rtol=1e-9, atol=1e-9)


def test_overlap_save_matches_scipy():
    """``test_scipy_equivalence.py::test_overlap_save_matches_scipy``: 19
    blocks of 256 through ``process_block`` at f64 (rtol 1e-6, atol 1e-8)."""
    sig, ir = noise(5000, seed=3), noise(128, seed=4)

    def run(m, **kw):
        conv = m.OverlapSaveConvolver(ir, block=256, dtype="float64", **kw)
        return np.concatenate([np.asarray(conv.process_block(sig[i:i + 256]))
                               for i in range(0, 4864, 256)])

    ours = run(tg, **CPU)
    close(ours, scipy.signal.fftconvolve(sig, ir, mode="full")[:len(ours)], run(sg),
          rtol=1e-6, atol=1e-8)


# ---- minimum phase ---------------------------------------------------------

def test_minimum_phase_invariants():
    """``test_scipy_equivalence.py::test_minimum_phase_invariants``: same
    length, magnitude response kept (atol 2e-3), energy moved to the front;
    JAX's filter at the same atol."""
    h = scipy.signal.firwin(61, 0.3)
    ours = tg.minimum_phase(h, **CPU).numpy()
    assert ours.shape == h.shape
    np.testing.assert_allclose(np.abs(np.fft.rfft(ours, 512)), np.abs(np.fft.rfft(h, 512)),
                               atol=2e-3)
    np.testing.assert_allclose(ours, np.asarray(sg.minimum_phase(h)), atol=2e-3)
    energy = np.cumsum(ours ** 2) / np.sum(ours ** 2)
    energy_in = np.cumsum(h ** 2) / np.sum(h ** 2)
    assert energy[10] > 0.8
    assert energy_in[10] < 0.1


# ---- STFT ------------------------------------------------------------------

def test_stft_matches_scipy_shorttimefft():
    """``test_scipy_equivalence.py::test_stft_matches_scipy_shorttimefft``:
    magnitudes at the JAX test's offset (rtol 1e-9, atol 1e-10)."""
    from scipy.signal import ShortTimeFFT

    x = noise(4000, seed=5)
    n_fft, hop = 256, 64
    win = scipy.signal.get_window("hann", n_fft, fftbins=False)
    ours = tg.stft(x, n_fft, hop, tg.WindowType.HANNING, centre=True, **CPU).numpy()
    jax_ref = np.asarray(sg.stft(x, n_fft, hop, sg.WindowType.HANNING, centre=True))
    ref = ShortTimeFFT(win, hop, fs=1.0, fft_mode="onesided", scale_to=None).stft(x)
    n = ours.shape[1]
    close(np.abs(ours[:, 4:n - 8]), np.abs(ref[:, 5:n - 7]), np.abs(jax_ref[:, 4:n - 8]),
          rtol=1e-9, atol=1e-10)


# ---- 2-D FFT ---------------------------------------------------------------

def test_fft2d_matches_numpy():
    """``test_scipy_equivalence.py::test_fft2d_matches_numpy`` (rtol 1e-9,
    atol 1e-9)."""
    img = noise(64 * 32, seed=6).reshape(64, 32)
    close(tg.fft2d(img, **CPU).numpy(), np.fft.rfft2(img), np.asarray(sg.fft2d(img)),
          rtol=1e-9, atol=1e-9)


def test_fftshift_matches_numpy():
    """``test_scipy_equivalence.py::test_fftshift_matches_numpy``: equal."""
    a, v = np.arange(63.0).reshape(9, 7), np.arange(10.0)
    pairs = [(tg.fftshift(a, **CPU).numpy(), np.fft.fftshift(a), sg.fftshift(a)),
             (tg.fftshift_1d(v, **CPU).numpy(), np.fft.fftshift(v), sg.fftshift_1d(v)),
             (tg.fftfreq(10, d=0.01), np.fft.fftfreq(10, d=0.01), sg.fftfreq(10, d=0.01)),
             (tg.rfftfreq(10, d=0.01), np.fft.rfftfreq(10, d=0.01), sg.rfftfreq(10, d=0.01))]
    for ours, ref, jax_ref in pairs:
        np.testing.assert_array_equal(np.asarray(ours), ref)
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(jax_ref))


def test_scipy_window_as_custom(rng):
    """``test_scipy_equivalence.py::test_scipy_window_as_custom``: a SciPy
    Tukey window plugs in as ``WindowType.custom`` and drives a plan (JAX's
    spectrogram at rtol 1e-9), its energy normalization sums to 1 (rtol
    1e-12), and a window of the wrong size raises."""
    n_fft = 256
    tukey = scipy.signal.get_window(("tukey", 0.25), n_fft, fftbins=False)
    w = tg.WindowType.custom(tukey)
    np.testing.assert_allclose(np.asarray(tg.make_window(w, n_fft, np.float64)), tukey)

    x = rng.standard_normal(4000)
    spec = tg.LinearPowerPlan(tg.SpectrogramParams(tg.StftParams(n_fft, 64, window=w), 16000.0),
                              dtype="float64", **CPU).compute(x)
    assert spec.shape[0] == n_fft // 2 + 1
    ref = np.asarray(sg.LinearPowerPlan(
        sg.SpectrogramParams(sg.StftParams(n_fft, 64, window=sg.WindowType.custom(tukey)),
                             16000.0), dtype="float64").compute(x).data)
    np.testing.assert_allclose(spec.to_numpy(), ref, rtol=1e-9, atol=1e-12 * np.abs(ref).max())

    coeffs = np.asarray(tg.make_window(tg.WindowType.custom(tukey, normalize="energy"), n_fft,
                                       np.float64))
    np.testing.assert_allclose(np.sum(coeffs ** 2), 1.0, rtol=1e-12)
    with pytest.raises(tg.InvalidInputError):
        tg.SpectrogramParams(tg.StftParams(512, 64, window=tg.WindowType.custom(tukey)), 16000.0)
