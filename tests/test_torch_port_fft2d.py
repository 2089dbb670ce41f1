"""The port's 2-D FFT family and the ``fft``/``image`` namespace modules
against the JAX package's, on the CPU.

Same numpy inputs (seeded) through both packages, at float32 and float64.
The bar is ``tests/test_fft2d.py``'s 1e-10 absolute at float64 (against
numpy and JAX); at float32, 1e-5 of the output's peak against JAX (both
round the same transforms in f32). The shifts and ``fftfreq``/``rfftfreq``
are exact. The ``fft`` namespace module is callable, so the package's
``fft`` is the one-shot either way round: checked in fresh interpreters,
the package imported first and the submodule imported first.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg

CPU = dict(device="cpu")
REPO = Path(__file__).resolve().parents[1]


def check(out, ref, dtype):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert out.shape == ref.shape
    if dtype == "float64":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(32, 48), (17, 16), (8, 65), (1, 1)])
def test_fft2d_matches_numpy_and_jax(dtype, shape):
    img = np.random.default_rng(sum(shape)).standard_normal(shape).astype(dtype)
    out = tg.fft2d(img, **CPU)
    assert out.dtype == (torch.complex128 if dtype == "float64" else torch.complex64)
    check(out, sg.fft2d(img), dtype)
    check(tg.compute_fft2d(img, **CPU), np.fft.rfft2(img.astype(np.float64)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(16, 16), (32, 17), (8, 64)])
def test_ifft2d_roundtrip_and_jax(dtype, shape):
    img = np.random.default_rng(1).standard_normal(shape).astype(dtype)
    spec = tg.fft2d(img, **CPU)
    rec = tg.ifft2d(spec, shape[1], **CPU)
    check(rec, img, dtype)
    check(rec, sg.ifft2d(sg.fft2d(img), shape[1]), dtype)
    assert tg.ifft2d(spec, shape[1], dtype="float32", **CPU).dtype == torch.float32


def test_ifft2d_errors_match_jax():
    for m, kw in ((sg, {}), (tg, CPU)):
        with pytest.raises(m.DimensionMismatchError):
            m.ifft2d(np.zeros((16, 10), dtype=np.complex128), 32, **kw)
        with pytest.raises(m.InvalidInputError, match="2-D spectrum"):
            m.ifft2d(np.zeros(10, dtype=np.complex128), 18, **kw)
        with pytest.raises(m.InvalidInputError, match="dimensions must be > 0"):
            m.ifft2d(np.zeros((4, 3), dtype=np.complex128), 0, **kw)
        with pytest.raises(m.InvalidInputError, match="2-D array"):
            m.fft2d(np.zeros(8), **kw)
        with pytest.raises(m.InvalidInputError, match="dimensions must be > 0"):
            m.fft2d(np.zeros((0, 4)), **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_power_and_magnitude_spectra(dtype):
    img = np.random.default_rng(2).standard_normal((24, 30)).astype(dtype)
    check(tg.power_spectrum_2d(img, **CPU), sg.power_spectrum_2d(img), dtype)
    check(tg.magnitude_spectrum_2d(img, **CPU), sg.magnitude_spectrum_2d(img), dtype)
    ones = np.ones((32, 32))
    p = tg.power_spectrum_2d(ones, **CPU).numpy()
    assert p[0, 0] > 1000.0 and np.allclose(p[1:, 1:], 0.0, atol=1e-6)  # DC holds it all
    np.testing.assert_allclose(tg.magnitude_spectrum_2d(ones, **CPU).numpy(), np.sqrt(p),
                               atol=1e-8)


@pytest.mark.parametrize("shape", [(4, 4), (5, 7), (1, 6)])
def test_shifts_match_jax(shape):
    a = np.arange(np.prod(shape)).reshape(shape)
    for name in ("fftshift", "ifftshift"):
        np.testing.assert_array_equal(getattr(tg, name)(a, **CPU).numpy(),
                                      np.asarray(getattr(sg, name)(a)))
    np.testing.assert_array_equal(tg.ifftshift(tg.fftshift(a, **CPU), **CPU).numpy(), a)
    v = np.arange(7)
    np.testing.assert_array_equal(tg.fftshift_1d(v, **CPU).numpy(), np.fft.fftshift(v))
    np.testing.assert_array_equal(tg.ifftshift_1d(tg.fftshift_1d(v, **CPU), **CPU).numpy(), v)


def test_shift_dtype_casts_like_jax():
    """A dtype casts real input to it and complex input to its complex type."""
    z = (np.arange(6) + 1j * np.arange(6)).astype(np.complex128)
    out = tg.fftshift_1d(z, dtype="float32", **CPU)
    assert out.dtype == torch.complex64
    np.testing.assert_array_equal(out.numpy(), np.asarray(sg.fftshift_1d(z, dtype="float32")))
    assert tg.fftshift(np.arange(4.0).reshape(2, 2), dtype="float64", **CPU).dtype == torch.float64


@pytest.mark.parametrize("n,d", [(8, 1.0), (100, 1 / 16000.0), (7, 0.5), (1, 2.0)])
def test_fftfreq_rfftfreq_equal_jax(n, d):
    for name in ("fftfreq", "rfftfreq"):
        for dtype in ("float32", "float64"):
            out = getattr(tg, name)(n, d, dtype=dtype)
            ref = getattr(sg, name)(n, d, dtype=dtype)
            assert isinstance(out, np.ndarray) and out.dtype == ref.dtype
            np.testing.assert_array_equal(out, ref)
    assert tg.fftfreq(n, d).dtype == np.float64
    for m in (sg, tg):
        with pytest.raises(m.InvalidInputError):
            m.fftfreq(0)
        with pytest.raises(m.InvalidInputError):
            m.rfftfreq(-1)


@pytest.mark.parametrize("dtype", [None, "float32", "float64"])
def test_planner_matches_jax(dtype):
    planner = tg.Fft2dPlanner(dtype=dtype, **CPU)
    jplanner = sg.Fft2dPlanner(dtype=dtype)
    assert planner.dtype == jplanner.dtype
    img = np.random.default_rng(5).standard_normal((16, 18))
    tol = "float64" if dtype == "float64" else "float32"
    check(planner.fft2d(img), jplanner.fft2d(img), tol)
    check(planner.ifft2d(planner.fft2d(img), 18), jplanner.ifft2d(jplanner.fft2d(img), 18), tol)
    check(planner.power_spectrum_2d(img), jplanner.power_spectrum_2d(img), tol)
    check(planner.magnitude_spectrum_2d(img), jplanner.magnitude_spectrum_2d(img), tol)
    if dtype == "float64":
        np.testing.assert_allclose(planner.ifft2d(planner.fft2d(img), 18).numpy(), img,
                                   atol=1e-10)
    with pytest.raises(tg.InvalidInputError):
        tg.Fft2dPlanner(dtype="int8", **CPU)


# ---- the namespace modules ------------------------------------------------------------


def _public(mod):
    return {k for k in vars(mod) if not k.startswith("_")} - {"annotations"}


def test_namespace_modules_export_jax_names():
    import spectrograms_tpu.fft as jfft
    import spectrograms_tpu.image as jimage
    import spectrograms_tpu_torch.fft as tfft
    import spectrograms_tpu_torch.image as timage

    assert _public(tfft) == _public(jfft)
    assert _public(timage) == _public(jimage)
    assert tg.image_ops.convolve_fft is tg.convolve_fft is timage.convolve_fft
    x = np.random.default_rng(0).standard_normal(10)
    # Importing the submodule rebound tg.fft to the module; it still calls.
    np.testing.assert_allclose(tg.fft(x, 16, device="cpu").numpy(), np.fft.rfft(x, 16),
                               atol=1e-12)
    np.testing.assert_allclose(tfft.fft2d(np.eye(4), device="cpu").numpy(),
                               np.fft.rfft2(np.eye(4)), atol=1e-12)


@pytest.mark.parametrize("order", [
    "import spectrograms_tpu_torch as tg\nf = tg.fft\n"
    "import spectrograms_tpu_torch.fft\nassert tg.fft is not f\n",
    "import spectrograms_tpu_torch.fft\nimport spectrograms_tpu_torch as tg\n",
])
def test_fft_is_callable_in_both_import_orders(order):
    code = order + (
        "import numpy as np, types\n"
        "x = np.arange(6.0)\n"
        "assert isinstance(tg.fft, types.ModuleType)\n"
        "y = tg.fft(x, 8, device='cpu')\n"
        "assert np.allclose(y.numpy(), np.fft.rfft(x, 8))\n"
        "assert np.allclose(tg.fft.fft(x, 8, device='cpu').numpy(), y.numpy())\n"
        "import sys\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'spectrograms_tpu')]\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
