"""The port's 1-D convolution, deconvolution, overlap-save and minimum phase
against the JAX package's, on the CPU.

Same numpy inputs (seeded) through both packages. The bars are
``tests/test_convolution.py``'s: 1e-10 absolute at float64 (against numpy
and against JAX), and for float32 1e-5 of the output's peak against JAX
(both round the same transforms in f32; cuFFT or pocketFFT sum in their own
orders). The overlap-save convolver's state (its impulse-response spectrum
and carried history) is carried from a JAX convolver into the port's
(``convert.convolver_state_from_numpy``) so that both continue from the
same state. Minimum phase at float32 takes the log of |H|² down to
``max|H|²·1e-20``, so on a filter with a deep stop band both packages sit
~1e-3 of the peak from the f64 result: there it is held to the JAX test's
magnitude and energy-centroid checks, and to JAX at float64.
"""

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch.convert import convolver_state_from_numpy

CPU = dict(device="cpu")


def close_f32(out, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def lowpass_fir(taps=64, fc=0.15):
    """The JAX test's Hann-windowed sinc low-pass."""
    mid = (taps - 1) / 2
    k = np.arange(taps)
    sinc = np.where(np.abs(k - mid) < 1e-9, 2 * fc,
                    np.sin(2 * np.pi * fc * (k - mid)) / (np.pi * np.where(k == mid, 1, k - mid)))
    return sinc * (0.5 - 0.5 * np.cos(2 * np.pi * k / (taps - 1)))


# ---- fft_convolve / fft_deconvolve ------------------------------------------------


@pytest.mark.parametrize("la,lb", [(100, 17), (1, 1), (64, 64), (1000, 513)])
def test_fft_convolve_matches_numpy_and_jax(la, lb):
    rng = np.random.default_rng(la * 7 + lb)
    a, b = rng.standard_normal(la), rng.standard_normal(lb)
    out = tg.fft_convolve(a, b, dtype="float64", **CPU)
    assert out.dtype == torch.float64 and tuple(out.shape) == (la + lb - 1,)
    np.testing.assert_allclose(out.numpy(), np.convolve(a, b), rtol=0, atol=1e-10)
    np.testing.assert_allclose(out.numpy(), np.asarray(sg.fft_convolve(a, b, dtype="float64")),
                               rtol=0, atol=1e-10)
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    out32 = tg.fft_convolve(a32, b32, **CPU)  # the dtype follows the input
    assert out32.dtype == torch.float32
    close_f32(out32, sg.fft_convolve(a32, b32))


def test_fft_convolve_impulse_shift_and_example():
    y = tg.fft_convolve([1.0, 2.0, 3.0, 4.0], [0.0, 0.0, 1.0], dtype="float64", **CPU)
    np.testing.assert_allclose(y.numpy(), [0, 0, 1, 2, 3, 4], atol=1e-12)
    assert np.round(tg.fft_convolve([1.0, 2.0, 3.0], [1.0, 1.0], **CPU).numpy(), 6).tolist() == [
        1.0, 3.0, 5.0, 3.0]


def test_fft_deconvolve_recovers_ir():
    rng = np.random.default_rng(1)
    sig = rng.standard_normal(2000)
    ir = np.array([1.0, -0.5, 0.25, 0.1])
    full = np.convolve(sig, ir)
    rec = tg.fft_deconvolve(full, sig, regularization=0.0, dtype="float64", **CPU)
    assert tuple(rec.shape) == (4,)
    np.testing.assert_allclose(rec.numpy(), ir, atol=1e-9)


@pytest.mark.parametrize("n_len,d_len,reg", [(2003, 2000, 1e-6), (500, 40, 1e-3), (30, 50, 1e-6),
                                             (64, 64, 0.0)])
def test_fft_deconvolve_matches_jax(n_len, d_len, reg):
    rng = np.random.default_rng(n_len + d_len)
    num, den = rng.standard_normal(n_len), rng.standard_normal(d_len)
    out = tg.fft_deconvolve(num, den, regularization=reg, dtype="float64", **CPU)
    ref = np.asarray(sg.fft_deconvolve(num, den, regularization=reg, dtype="float64"))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-10 * max(1.0, np.abs(ref).max()))
    close_f32(tg.fft_deconvolve(num.astype(np.float32), den.astype(np.float32),
                                regularization=reg, **CPU),
              sg.fft_deconvolve(num.astype(np.float32), den.astype(np.float32),
                                regularization=reg), rel=1e-4)


def test_fft_deconvolve_zero_denominator_is_zero():
    """|D|² + ε = 0 everywhere (a zero denominator, no regularization): the
    quotient is 0, as in JAX, not NaN."""
    out = tg.fft_deconvolve(np.ones(8), np.zeros(4), regularization=0.0, dtype="float64", **CPU)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        sg.fft_deconvolve(np.ones(8), np.zeros(4), regularization=0.0, dtype="float64")))
    assert not out.isnan().any()


@pytest.mark.parametrize("fn", ["fft_convolve", "fft_deconvolve"])
def test_convolve_validation(fn):
    for bad in ([], np.ones((2, 3))):
        for m, kw in ((sg, {}), (tg, CPU)):
            with pytest.raises(m.InvalidInputError, match="non-empty 1-D"):
                getattr(m, fn)(bad, np.ones(3), **kw)


# ---- OverlapSaveConvolver -------------------------------------------------------------


@pytest.mark.parametrize("taps,block", [(37, 256), (1, 64), (513, 1024), (100, 32)])
def test_overlap_save_matches_direct_and_jax(taps, block):
    rng = np.random.default_rng(taps + block)
    ir = rng.standard_normal(taps)
    sig = rng.standard_normal(4 * block)
    conv = tg.OverlapSaveConvolver(ir, block, dtype="float64", **CPU)
    jconv = sg.OverlapSaveConvolver(ir, block, dtype="float64")
    assert conv.block_size == jconv.block_size == block
    assert conv.fft_size == jconv.fft_size
    out = torch.cat([conv.process_block(sig[i * block:(i + 1) * block]) for i in range(4)])
    direct = np.convolve(sig, ir)[: 4 * block]
    np.testing.assert_allclose(out.numpy(), direct, atol=1e-10)
    conv.reset()
    np.testing.assert_allclose(conv.process_signal(sig).numpy(), direct, atol=1e-10)
    np.testing.assert_allclose(conv.process_signal(sig).numpy(),
                               np.asarray(jconv.process_signal(sig)), atol=1e-10)


def test_process_signal_equals_a_loop_of_steps():
    """The batched transform over all blocks computes what a scan of the
    pure step computes from silence, at float32 too."""
    rng = np.random.default_rng(5)
    ir = rng.standard_normal(129).astype(np.float32)
    sig = rng.standard_normal(16 * 128).astype(np.float32)
    conv = tg.OverlapSaveConvolver(ir, 128, **CPU)
    history, outs = conv.initial_state, []
    for blk in torch.from_numpy(sig).reshape(-1, 128):
        history, y = conv.step(history, blk)
        outs.append(y)
    np.testing.assert_allclose(conv.process_signal(sig).numpy(), torch.cat(outs).numpy(),
                               rtol=0, atol=1e-6 * float(np.abs(torch.cat(outs).numpy()).max()))
    close_f32(conv.process_signal(sig), sg.OverlapSaveConvolver(ir, 128).process_signal(sig))


def test_overlap_save_state_carried_from_jax():
    """A JAX convolver that has filtered three blocks hands its spectrum and
    history to a fresh port convolver; both then filter the same blocks."""
    rng = np.random.default_rng(6)
    ir, sig = rng.standard_normal(50), rng.standard_normal(6 * 64)
    jconv = sg.OverlapSaveConvolver(ir, 64, dtype="float64")
    for i in range(3):
        jconv.process_block(sig[i * 64:(i + 1) * 64])
    conv = convolver_state_from_numpy(tg.OverlapSaveConvolver(np.ones(50), 64, dtype="float64",
                                                              **CPU),
                                      np.asarray(jconv._h_spec), np.asarray(jconv._history))
    for i in range(3, 6):
        blk = sig[i * 64:(i + 1) * 64]
        np.testing.assert_allclose(conv.process_block(blk).numpy(),
                                   np.asarray(jconv.process_block(blk)), atol=1e-10)
    np.testing.assert_allclose(conv._history.numpy(), np.asarray(jconv._history), atol=0)
    with pytest.raises(tg.DimensionMismatchError):
        convolver_state_from_numpy(conv, np.zeros(3, complex), np.zeros(conv.fft_size - 64))
    with pytest.raises(tg.InvalidInputError):
        convolver_state_from_numpy(object(), np.zeros(3), np.zeros(3))


def test_step_is_pure_and_initial_state_is_silence():
    conv = tg.OverlapSaveConvolver(np.arange(1.0, 6.0), 16, dtype="float64", **CPU)
    state = conv.initial_state
    assert tuple(state.shape) == (conv.fft_size - 16,) and not state.any()
    h1, y1 = conv.step(state, torch.ones(16, dtype=torch.float64))
    h2, y2 = conv.step(state, torch.ones(16, dtype=torch.float64))
    assert torch.equal(h1, h2) and torch.equal(y1, y2) and not state.any()
    assert not conv._history.any()  # the step leaves the carried history alone
    h3, y3 = conv.step(np.zeros(conv.fft_size - 16), np.ones(16))  # host arrays in
    assert torch.equal(h3, h1) and torch.equal(y3, y1)


def test_overlap_save_validation():
    for m, kw in ((sg, {}), (tg, CPU)):
        with pytest.raises(m.InvalidInputError, match="must not be empty"):
            m.OverlapSaveConvolver([], 256, **kw)
        with pytest.raises(m.InvalidInputError, match="block size"):
            m.OverlapSaveConvolver([1.0], 0, **kw)
        conv = m.OverlapSaveConvolver([1.0], 256, **kw)
        with pytest.raises(m.InvalidInputError, match="process_block expects"):
            conv.process_block(np.ones(100))
        with pytest.raises(m.InvalidInputError, match="multiple of block size"):
            conv.process_signal(np.ones(300))


# ---- minimum phase ------------------------------------------------------------------


@pytest.mark.parametrize("taps,out_len,oversample", [(64, 64, 8), (50, 20, 4), (7, 300, 2),
                                                     (33, 33, 1)])
def test_minimum_phase_with_matches_jax_f64(taps, out_len, oversample):
    rng = np.random.default_rng(taps)
    ir = rng.standard_normal(taps) * np.exp(-np.arange(taps) / 10.0)
    out = tg.minimum_phase_with(ir, out_len, oversample, dtype="float64", **CPU)
    ref = np.asarray(sg.minimum_phase_with(ir, out_len, oversample, dtype="float64"))
    assert out.dtype == torch.float64 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-10 * np.abs(ref).max())


def test_minimum_phase_f32_well_conditioned_matches_jax():
    """No deep stop band: both f32 results sit ~1e-7 of the peak from f64."""
    ir = np.random.default_rng(3).standard_normal(50) * np.exp(-np.arange(50) / 10.0)
    out = tg.minimum_phase(ir.astype(np.float32), **CPU)
    assert out.dtype == torch.float32
    ref64 = np.asarray(sg.minimum_phase(ir, dtype="float64"))
    close_f32(out, ref64, rel=1e-5)
    close_f32(out, sg.minimum_phase(ir.astype(np.float32)), rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_minimum_phase_preserves_magnitude(dtype):
    """``tests/test_convolution.py``'s checks, on the port."""
    lin = lowpass_fir()
    mp = tg.minimum_phase(lin, dtype=dtype, **CPU).numpy().astype(np.float64)
    assert mp.shape == lin.shape
    mag_l = np.abs(np.fft.rfft(lin, 512))
    mag_m = np.abs(np.fft.rfft(mp, 512))
    assert np.all(np.abs(mag_l - mag_m) < 1e-2 + 1e-2 * mag_l)
    centroid = lambda h: np.sum(np.arange(len(h)) * h**2) / np.sum(h**2)
    assert centroid(mp) < centroid(lin) * 0.5
    if dtype == "float64":
        np.testing.assert_allclose(mp, np.asarray(sg.minimum_phase(lin, dtype="float64")),
                                   rtol=0, atol=1e-10)


def test_minimum_phase_of_silence_takes_the_floor():
    """An all-zero response: the eps of 1e-300 keeps the log finite (f64),
    as in JAX."""
    out = tg.minimum_phase(np.zeros(8), dtype="float64", **CPU)
    np.testing.assert_allclose(out.numpy(), np.asarray(sg.minimum_phase(np.zeros(8),
                                                                        dtype="float64")))
    assert torch.isfinite(out).all()


def test_minimum_phase_validation():
    for m, kw in ((sg, {}), (tg, CPU)):
        with pytest.raises(m.InvalidInputError, match="must not be empty"):
            m.minimum_phase(np.array([]), **kw)
        with pytest.raises(m.InvalidInputError, match="out_len"):
            m.minimum_phase_with(np.ones(4), 0, **kw)
