"""The port's FFT image filters and both 2-D spectral routes against the JAX
package's, on the CPU.

Same numpy inputs (seeded) through both packages:

- ``gaussian_kernel_2d`` and the host masks, equal to JAX's bit for bit
  (both numpy);
- ``convolve_fft``, the low/high/band-pass filters, ``detect_edges_fft`` and
  ``sharpen_fft`` at float32 (1e-5 of the peak against JAX: the same rfft2
  route, rounded in f32) and float64 (``tests/test_fft2d.py``'s 1e-10);
- the dense-product route of ``ops/spectral2d.py`` against JAX's own
  (called directly at ``HIGHEST``, as ``tests/test_spectral2d.py`` does:
  ``use_matmul_path`` is False on JAX's CPU backend and on the port's CPU)
  and against the FFT route at that test's 2e-4;
- ``benchmarks/suite.py`` config 5's step at its own shapes: a 64-frame
  mel-dB block (512/128, ``centre=False``, mel-64 Slaney) and a 512² blur
  with a 9×9 Gaussian, then edge detection, against JAX (1e-3 dB, the bar of
  ``tests/test_torch_port_plans.py``, and 2e-4) and numpy in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu import image_ops as jio
from spectrograms_tpu.ops import spectral2d as js
from spectrograms_tpu_torch import image_ops as tio
from spectrograms_tpu_torch.ops import spectral2d as ts
from spectrograms_tpu_torch.ops.filterbanks import mel_filterbank

CPU = dict(device="cpu")
HIGHEST = jax.lax.Precision.HIGHEST


def check(out, ref, dtype, rel=1e-5):
    ref = np.asarray(ref)
    out = out.numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if dtype == "float64":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def image(shape, seed, dtype="float32"):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ---- host builders ------------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 3, 5, 9, 15])
@pytest.mark.parametrize("sigma", [0.5, 1.0, 3.0])
def test_gaussian_kernel_equals_jax(size, sigma):
    k = tg.gaussian_kernel_2d(size, sigma)
    np.testing.assert_array_equal(k, sg.gaussian_kernel_2d(size, sigma))
    assert k.dtype == np.float64 and abs(k.sum() - 1.0) < 1e-12
    np.testing.assert_array_equal(tg.gaussian_kernel_2d(size, sigma, dtype="float32"),
                                  sg.gaussian_kernel_2d(size, sigma, dtype="float32"))


def test_gaussian_kernel_validation():
    for m in (sg, tg):
        for size in (0, 2, 4, 10):
            with pytest.raises(m.InvalidInputError, match="odd"):
                m.gaussian_kernel_2d(size, 1.0)
        with pytest.raises(m.InvalidInputError, match="sigma"):
            m.gaussian_kernel_2d(5, 0.0)


@pytest.mark.parametrize("shape", [(32, 17), (64, 33), (9, 5)])
def test_masks_and_padding_equal_jax(shape):
    for frac in (0.0, 0.1, 0.35, 1.0):
        np.testing.assert_array_equal(tio._lowpass_mask(shape, frac),
                                      jio._lowpass_mask(shape, frac))
    ker = tg.gaussian_kernel_2d(5, 1.0)
    np.testing.assert_array_equal(tio._pad_kernel_for_fft(ker, (shape[0], 2 * shape[1])),
                                  jio._pad_kernel_for_fft(ker, (shape[0], 2 * shape[1])))


@pytest.mark.parametrize("kshape,target", [((9, 9), (512, 512)), ((3, 7), (16, 9)),
                                            ((1, 1), (4, 4)), ((4, 6), (4, 6))])
def test_device_padding_places_the_kernel_as_jax(kshape, target):
    ker = np.random.default_rng(0).standard_normal(kshape)
    got = tio._pad_kernel_on(torch.from_numpy(ker), target)
    np.testing.assert_array_equal(got.numpy(), jio._pad_kernel_for_fft(ker, target))


def test_device_masks_are_cached_once():
    img = image((32, 32), 0)
    tg.highpass_filter(img, 0.3, **CPU)
    before = tio._device_mask.cache_info().hits
    tg.highpass_filter(img, 0.3, **CPU)
    assert tio._device_mask.cache_info().hits == before + 1
    info = tg.fft_plan_cache_info()
    assert {"image_kernels.lowpass_mask", "image_kernels.device_mask"} <= set(info)


# ---- the filters --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape,ksize", [((64, 64), 9), ((33, 48), 5), ((16, 16), 1)])
def test_convolve_fft_matches_jax(dtype, shape, ksize):
    img = image(shape, ksize, dtype)
    ker = tg.gaussian_kernel_2d(ksize, 2.0)
    check(tg.convolve_fft(img, ker, **CPU), sg.convolve_fft(img, ker), dtype)
    ident = np.zeros((3, 3))
    ident[1, 1] = 1.0
    check(tg.convolve_fft(img, ident, **CPU), img, dtype)
    rect = np.random.default_rng(1).standard_normal((3, 7))  # off-centre, asymmetric
    check(tg.convolve_fft(img, rect, **CPU), sg.convolve_fft(img, rect), dtype)
    # a kernel tensor (on the image's device), of either float type, gives the same
    for k in (torch.from_numpy(rect), torch.from_numpy(rect).float(), rect.tolist()):
        check(tg.convolve_fft(img, k, **CPU), sg.convolve_fft(img, np.asarray(k, np.float64)
                                                               if isinstance(k, list) else
                                                               k.double().numpy()), dtype)


def test_convolve_fft_validation_texts():
    img = np.ones((8, 8))
    for m, kw in ((sg, {}), (tg, CPU)):
        with pytest.raises(m.InvalidInputError, match="must not exceed"):
            m.convolve_fft(img, np.ones((9, 9)), **kw)
        with pytest.raises(m.InvalidInputError, match="kernel must be 2-D"):
            m.convolve_fft(img, np.ones(3), **kw)
        with pytest.raises(m.InvalidInputError, match="kernel dimensions must be > 0"):
            m.convolve_fft(img, np.ones((0, 3)), **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(32, 32), (48, 31), (64, 128)])
def test_mask_filters_match_jax(dtype, shape):
    img = image(shape, 7, dtype)
    for frac in (0.1, 0.3, 0.5):
        check(tg.lowpass_filter(img, frac, **CPU), sg.lowpass_filter(img, frac), dtype)
        check(tg.highpass_filter(img, frac, **CPU), sg.highpass_filter(img, frac), dtype)
    check(tg.bandpass_filter(img, 0.1, 0.5, **CPU), sg.bandpass_filter(img, 0.1, 0.5), dtype)
    check(tg.detect_edges_fft(img, **CPU), sg.detect_edges_fft(img), dtype)
    check(tg.sharpen_fft(img, 0.8, **CPU), sg.sharpen_fft(img, 0.8), dtype)
    lo, hi = tg.lowpass_filter(img, 0.3, **CPU), tg.highpass_filter(img, 0.3, **CPU)
    np.testing.assert_allclose((lo + hi).numpy(), img, atol=1e-8 if dtype == "float64" else 1e-5)


def test_filter_validation_texts():
    img = np.ones((16, 16))
    for m, kw in ((sg, {}), (tg, CPU)):
        with pytest.raises(m.InvalidInputError, match="cutoff_fraction must be between"):
            m.lowpass_filter(img, 1.5, **kw)
        with pytest.raises(m.InvalidInputError, match="high_cutoff must be greater"):
            m.bandpass_filter(img, 0.6, 0.2, **kw)
        with pytest.raises(m.InvalidInputError, match="low_cutoff must be between"):
            m.bandpass_filter(img, -0.1, 0.2, **kw)
        with pytest.raises(m.InvalidInputError, match="amount must be >= 0"):
            m.sharpen_fft(img, -1.0, **kw)


def test_reference_behaviours():
    """``tests/test_fft2d.py``'s behaviour checks, on the port."""
    flat = np.full((32, 32), 5.0)
    np.testing.assert_allclose(tg.lowpass_filter(flat, 0.5, **CPU).numpy(), 5.0, atol=1e-6)
    np.testing.assert_allclose(tg.highpass_filter(flat, 0.5, **CPU).numpy(), 0.0, atol=1e-6)
    step = np.zeros((32, 32))
    step[:, 16:] = 1.0
    assert abs(float(tg.detect_edges_fft(step, **CPU).mean())) < 1e-8
    i = np.arange(32, dtype=np.float64)
    ramp = i[:, None] + i[None, :]
    np.testing.assert_allclose(tg.sharpen_fft(ramp, 0.0, **CPU).numpy(), ramp, atol=1e-8)
    img = image((32, 32), 11, "float64") + 5.0
    out = tg.convolve_fft(img, tg.gaussian_kernel_2d(7, 1.5), **CPU).numpy()
    assert abs(out.sum() - img.sum()) / abs(img.sum()) < 1e-6


# ---- the dense-product route ---------------------------------------------------------


def test_spectral_builders_equal_jax():
    for n in (8, 64, 100):
        for a, b in zip(ts._dft_consts_np(n), js._dft_consts_np(n)):
            np.testing.assert_array_equal(a, b)
    half = np.random.default_rng(0).random((16, 9))
    np.testing.assert_array_equal(ts.full_mask_from_half(half, 16), js.full_mask_from_half(half, 16))
    padded = jio._pad_kernel_for_fft(sg.gaussian_kernel_2d(5, 1.0), (16, 16))
    for a, b in zip(ts.full_spectrum_from_kernel(padded), js.full_spectrum_from_kernel(padded)):
        np.testing.assert_array_equal(a, b)
    for m in (ts, js):
        with pytest.raises(ValueError):
            m.full_mask_from_half(np.ones((8, 4)), 7)


@pytest.mark.parametrize("shape", [(64, 64), (32, 48)])
def test_fft2_matmul_matches_jax(shape):
    img = image(shape, 3)
    re, im = ts.fft2_matmul(torch.from_numpy(img))
    jre, jim = js.fft2_matmul(jnp.asarray(img), HIGHEST)
    check(re, jre, "float32")
    check(im, jim, "float32")
    full = np.fft.fft2(img.astype(np.float64))
    check(re, full.real.astype(np.float32), "float32")
    back = ts.ifft2_matmul_real(re, im)
    check(back, js.ifft2_matmul_real(jre, jim, HIGHEST), "float32")
    check(back, img, "float32")


@pytest.mark.parametrize("shape", [(512, 512), (128, 256), (64, 64)])
def test_mask_filter_matmul_matches_both_routes(shape):
    img = image(shape, 12)
    for frac in (0.1, 0.35):
        hp = 1.0 - tio._lowpass_mask((shape[0], shape[1] // 2 + 1), frac)
        got = ts.spectral_filter_matmul(torch.from_numpy(img), ts.full_mask_from_half(hp, shape[1]))
        np.testing.assert_allclose(got.numpy(), tg.highpass_filter(img, frac, **CPU).numpy(),
                                   atol=2e-4)
        jgot = js.spectral_filter_matmul(jnp.asarray(img), js.full_mask_from_half(hp, shape[1]),
                                         HIGHEST)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=2e-4)


def test_bandpass_and_conv_matmul_match_fft_route():
    img = image((128, 128), 13)
    m = tio._lowpass_mask((128, 65), 0.6) - tio._lowpass_mask((128, 65), 0.2)
    got = ts.spectral_filter_matmul(torch.from_numpy(img), ts.full_mask_from_half(m, 128))
    np.testing.assert_allclose(got.numpy(), tg.bandpass_filter(img, 0.2, 0.6, **CPU).numpy(),
                               atol=2e-4)
    img = image((256, 256), 14)
    ker = tg.gaussian_kernel_2d(9, 2.0)
    padded = tio._pad_kernel_for_fft(ker, img.shape)
    got = ts.spectral_conv_matmul(torch.from_numpy(img), ts.full_spectrum_from_kernel(padded))
    np.testing.assert_allclose(got.numpy(), tg.convolve_fft(img, ker, **CPU).numpy(), atol=2e-4)
    jgot = js.spectral_conv_matmul(jnp.asarray(img), js.full_spectrum_from_kernel(padded), HIGHEST)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=2e-4)


def test_matmul_route_rule():
    """The JAX gates (f32, even sides in 8..MATMUL_MAX_DIM) on a CUDA device,
    and False on the CPU whatever the shape, as JAX's rule is off its TPU."""
    for dtype in (np.float32, torch.float32, "float32"):
        assert not ts.use_matmul_path((512, 512), dtype, "cpu")
        assert not ts.use_matmul_path((64, 64), dtype, torch.device("cpu"))
    for shape, dtype in (((512, 512), np.float64), ((511, 512), np.float32),
                         ((2048, 2048), np.float32), ((4, 4), np.float32),
                         ((64, 64), np.int32)):
        assert not ts.use_matmul_path(shape, dtype, "cuda")
        assert not js.use_matmul_path(shape, dtype)
    for side in (8, 64, 256, 512, 1024):
        want = side <= ts.MATMUL_MAX_DIM
        assert ts.use_matmul_path((side, side), np.float32, "cuda") == want
        assert ts.use_matmul_path((side, side), "float32") == want  # the default is CUDA


# ---- benchmarks/suite.py config 5 ----------------------------------------------------


def config5(m, **kw):
    params = m.SpectrogramParams(m.StftParams(512, 128, centre=False), 16000.0)
    mel = m.MelParams(64, 0.0, 8000.0, m.MelNorm.SLANEY)
    return m.MelDbPlan(params, mel, m.LogParams(-80.0), dtype="float32", **kw)


def test_config5_step_matches_jax_and_f64():
    frames = np.random.default_rng(3).standard_normal((64, 512)).astype(np.float32)
    img = np.random.default_rng(4).standard_normal((512, 512)).astype(np.float32)
    kernel = np.asarray(tg.gaussian_kernel_2d(9, 2.0), dtype=np.float32)
    feats = config5(tg, **CPU)._forward_frames(torch.from_numpy(frames))
    jfeats = np.asarray(config5(sg)._frames_to_bins(jnp.asarray(frames)))
    assert tuple(feats.shape) == (64, 64)
    np.testing.assert_allclose(feats.numpy(), jfeats, rtol=0, atol=1e-3)
    w = tg.make_window(tg.WindowType.hanning, 512)
    spec = np.fft.rfft(frames.astype(np.float64) * w, axis=-1)
    mapped = (np.abs(spec) ** 2) @ mel_filterbank(16000.0, 512, tg.MelParams(
        64, 0.0, 8000.0, tg.MelNorm.SLANEY)).T
    np.testing.assert_allclose(feats.numpy(), 10 * np.log10(np.maximum(mapped, 1e-8)), atol=1e-3)

    blurred = tg.convolve_fft(img, kernel, **CPU)
    edges = tg.detect_edges_fft(blurred, **CPU)
    jblur = sg.convolve_fft(img, kernel)
    np.testing.assert_allclose(blurred.numpy(), np.asarray(jblur), atol=2e-4)
    np.testing.assert_allclose(edges.numpy(), np.asarray(sg.detect_edges_fft(jblur)), atol=2e-4)
    # numpy f64 of the same function
    padded = tio._pad_kernel_for_fft(kernel.astype(np.float64), img.shape)
    blur64 = np.fft.irfft2(np.fft.rfft2(img.astype(np.float64)) * np.fft.rfft2(padded), s=img.shape)
    hp = 1.0 - tio._lowpass_mask((512, 257), 0.1)
    edges64 = np.fft.irfft2(np.fft.rfft2(blur64) * hp, s=img.shape)
    np.testing.assert_allclose(blurred.numpy(), blur64, atol=2e-4)
    np.testing.assert_allclose(edges.numpy(), edges64, atol=2e-4)
    e64 = tg.detect_edges_fft(tg.convolve_fft(img.astype(np.float64), kernel.astype(np.float64),
                                              **CPU), **CPU)
    np.testing.assert_allclose(e64.numpy(), edges64, rtol=0, atol=1e-10)
