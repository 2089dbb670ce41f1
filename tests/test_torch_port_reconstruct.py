"""The port's Griffin-Lim and mel inversion against the JAX package's, on the CPU.

The JAX package draws its initial phase from ``jax.random.PRNGKey(0)``; the
port draws its own from torch's seed 0 unless given ``init_angles``. Here the JAX
phase is carried across as ``init_angles``, so both iterate from the same
start:

- the fft route (float64): the waveform equals JAX's to 1e-9·max after 32
  iterations;
- the matmul route (float32, n_fft ≤ 4096) and the fft route at float32
  (n_fft > 4096): both packages sum in f32 in their own order, and the
  momentum-0.99 iteration amplifies that: the waveform equals JAX's to
  1e-4·max after 8 iterations (the readings: 7.5e-6 to 2.0e-5) and to
  2e-2·max after 32 (9.5e-3 on a sine, 3.0e-3 on noise), while the spectral
  convergence (‖|STFT(y)| − M‖ / ‖M‖) agrees to 1e-5 (readings ~1e-7);
- batches, validation, the default phase, ``mel_filterbank_pinv`` (exact),
  ``mel_to_linear`` (rtol 1e-9 f64, 1e-5·max f32), ``invert_mel_db``, and
  ``tests/test_reconstruct.py``'s quality checks.
"""

import jax
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.reconstruct import griffin_lim as jgl
from tests.conftest import noise, sine

SR = 16000.0
N_FFT, HOP = 512, 128
CPU = dict(device="cpu")


def jax_angles(mag):
    """The JAX package's initial phase, laid out like ``mag`` (n_bins, n_frames)."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.T.shape, dtype=mag.dtype,
                                         minval=-np.pi, maxval=np.pi)).T


def spectral_convergence(y, mag, n_fft, hop):
    got = np.abs(tg.stft(np.asarray(y, np.float64), n_fft, hop, **CPU).numpy())[:, : mag.shape[1]]
    return float(np.linalg.norm(got - mag) / np.linalg.norm(mag))


def mag_of(x, n_fft=N_FFT, hop=HOP):
    return np.abs(np.asarray(sg.stft(x, n_fft, hop)))


@pytest.mark.parametrize("signal", ["sine", "noise"])
@pytest.mark.parametrize("centre,length", [(True, None), (True, 7000), (False, None)])
def test_fft_route_f64_matches_jax(signal, centre, length):
    x = sine(440.0, duration=0.5) if signal == "sine" else noise(8000, seed=4)
    mag = np.abs(np.asarray(sg.stft(x, N_FFT, HOP, centre=centre)))
    want = np.asarray(jgl(mag, N_FFT, HOP, centre=centre, n_iter=32, length=length))
    got = tg.griffin_lim(mag, N_FFT, HOP, centre=centre, n_iter=32, length=length,
                         init_angles=jax_angles(mag), **CPU)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("signal", ["sine", "noise"])
@pytest.mark.parametrize("n_fft,hop", [(512, 128), (400, 160), (8192, 2048)])
def test_f32_routes_match_jax(signal, n_fft, hop):
    """(512, 128) and (400, 160) take the matmul route, (8192, 2048) the
    fft route at f32; JAX chooses the same."""
    n = 8000 if n_fft < 8192 else 32000
    x = (sine(440.0, duration=n / SR) if signal == "sine" else noise(n, seed=5)).astype(np.float32)
    mag = mag_of(x, n_fft, hop)
    ang = jax_angles(mag)
    for n_iter, tol in ((8, 1e-4), (32, 2e-2)):
        want = np.asarray(jgl(mag, n_fft, hop, n_iter=n_iter))
        got = tg.griffin_lim(mag, n_fft, hop, n_iter=n_iter, init_angles=ang, **CPU)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    assert abs(spectral_convergence(got, mag, n_fft, hop)
               - spectral_convergence(want, mag, n_fft, hop)) < 1e-5


def test_momentum_zero_and_irregular_hop_match_jax():
    x = noise(6000, seed=8)
    mag = mag_of(x, 256, 100)
    want = np.asarray(jgl(mag, 256, 100, n_iter=16, momentum=0.0))
    got = tg.griffin_lim(mag, 256, 100, n_iter=16, momentum=0.0, init_angles=jax_angles(mag),
                         **CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_batch_runs_each_item_from_the_same_phase():
    """A (B, n_bins, n_frames) batch equals the items run alone, as JAX's
    vmap over one key does."""
    mags = np.stack([mag_of(sine(f, duration=0.25, dtype=np.float32)) for f in (330.0, 660.0)])
    batched = tg.griffin_lim(mags, N_FFT, HOP, n_iter=8, length=4000, **CPU)
    assert batched.shape == (2, 4000)
    for i in range(2):
        alone = tg.griffin_lim(mags[i], N_FFT, HOP, n_iter=8, length=4000, **CPU)
        np.testing.assert_allclose(batched[i].numpy(), alone.numpy(), rtol=0,
                                   atol=1e-5 * float(alone.abs().max()))
    want = np.asarray(sg.griffin_lim(mags.astype(np.float64), N_FFT, HOP, n_iter=8, length=4000))
    got = tg.griffin_lim(mags.astype(np.float64), N_FFT, HOP, n_iter=8, length=4000,
                         init_angles=jax_angles(mags[0].astype(np.float64)), **CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_default_phase_is_seed_zero():
    """Without ``init_angles`` the phase is torch's seed-0 draw on the host,
    the same on every device and call."""
    mag = mag_of(noise(4000, seed=3).astype(np.float32))
    a = tg.griffin_lim(mag, N_FFT, HOP, n_iter=4, **CPU)
    assert torch.equal(a, tg.griffin_lim(mag, N_FFT, HOP, n_iter=4, **CPU))
    gen = torch.Generator().manual_seed(0)
    ang = (torch.rand(mag.shape[1], mag.shape[0], generator=gen, dtype=torch.float64)
           * (2 * np.pi) - np.pi).T
    assert torch.equal(a, tg.griffin_lim(mag, N_FFT, HOP, n_iter=4, init_angles=ang, **CPU))


def test_validation_matches_jax():
    for gl, kw in ((sg.griffin_lim, {}), (tg.griffin_lim, CPU)):
        with pytest.raises((sg.InvalidInputError, tg.InvalidInputError), match="bins, expected 257"):
            gl(np.zeros((100, 10)), N_FFT, HOP, **kw)
        with pytest.raises((sg.InvalidInputError, tg.InvalidInputError), match="momentum"):
            gl(np.zeros((257, 10)), N_FFT, HOP, momentum=1.5, **kw)
        with pytest.raises((sg.InvalidInputError, tg.InvalidInputError), match="hop_size"):
            gl(np.zeros((257, 10)), N_FFT, 1024, **kw)
        with pytest.raises((sg.InvalidInputError, tg.InvalidInputError), match="2-D or 3-D"):
            gl(np.zeros(257), N_FFT, HOP, **kw)
    with pytest.raises(tg.InvalidInputError, match="init_angles"):
        tg.griffin_lim(np.ones((257, 10)), N_FFT, HOP, init_angles=np.zeros((10, 257)), **CPU)


# ---- tests/test_reconstruct.py's quality checks, on the port ------------------------

def test_griffin_lim_recovers_sine():
    x = sine(440.0, dtype=np.float32)
    mag = np.abs(tg.stft(x, N_FFT, HOP, **CPU).numpy())
    rec = tg.griffin_lim(mag, N_FFT, HOP, n_iter=150, length=len(x), **CPU).numpy()
    assert rec.shape == x.shape
    interior, ref = rec[2000:-2000], x[2000:-2000]
    f_peak = np.argmax(np.abs(np.fft.rfft(interior))) * SR / len(interior)
    assert abs(f_peak - 440.0) < 5.0
    assert abs(interior.std() - ref.std()) / ref.std() < 0.1
    corr = np.correlate(interior, ref[: len(ref) // 2], mode="valid")
    peak_corr = np.max(np.abs(corr)) / (
        np.linalg.norm(ref[: len(ref) // 2]) * interior.std() * np.sqrt(len(ref) // 2))
    assert peak_corr > 0.85, peak_corr


def test_griffin_lim_both_routes_converge():
    x = sine(440.0, duration=0.5, dtype=np.float32)
    for dt in (np.float32, np.float64):
        mag = np.abs(tg.stft(x.astype(dt), N_FFT, HOP, **CPU).numpy())
        rec = tg.griffin_lim(mag, N_FFT, HOP, n_iter=100, length=len(x), **CPU)
        assert rec.dtype == (torch.float32 if dt == np.float32 else torch.float64)
        assert spectral_convergence(rec, mag, N_FFT, HOP) < 0.06


def test_mel_filterbank_pinv_matches_jax():
    for mel in (tg.MelParams(80, 0.0, 8000.0, tg.MelNorm.SLANEY), tg.MelParams(40, 100.0, 4000.0)):
        jmel = sg.MelParams(mel.n_mels, mel.f_min, mel.f_max, sg.MelNorm(mel.norm.value))
        np.testing.assert_array_equal(tg.mel_filterbank_pinv(mel, SR, N_FFT),
                                      np.asarray(sg.mel_filterbank_pinv(jmel, SR, N_FFT)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mel_to_linear_matches_jax(dtype):
    params = sg.SpectrogramParams(sg.StftParams(N_FFT, HOP), SR)
    jmel = sg.MelParams(80, 0.0, 8000.0, sg.MelNorm.SLANEY)
    melspec = np.asarray(sg.MelPowerPlan(params, jmel, dtype=dtype).compute_raw(
        noise(8000, seed=6).astype(dtype)))
    want = np.asarray(sg.mel_to_linear(melspec, jmel, SR, N_FFT))
    got = tg.mel_to_linear(melspec, tg.MelParams(80, 0.0, 8000.0, tg.MelNorm.SLANEY), SR, N_FFT,
                           **CPU)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    tol = dict(rtol=1e-9, atol=1e-12) if dtype == "float64" else dict(rtol=0, atol=1e-5 * want.max())
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_invert_mel_db_end_to_end():
    mel = tg.MelParams(80, 0.0, 8000.0, tg.MelNorm.SLANEY)
    params = tg.SpectrogramParams(tg.StftParams(N_FFT, HOP), SR)
    x = sine(440.0, duration=0.5, dtype=np.float32)
    mel_db = tg.MelDbPlan(params, mel, tg.LogParams(-80.0), dtype="float32", **CPU).compute(x)
    rec = tg.invert_mel_db(mel_db, mel, SR, N_FFT, HOP, n_iter=32, length=len(x), **CPU)
    assert rec.shape == x.shape and rec.dtype == torch.float32
    # it is Griffin-Lim of the pseudo-inverse's magnitude
    lin = tg.mel_to_linear(torch.pow(10.0, mel_db.data / 10.0), mel, SR, N_FFT, **CPU)
    again = tg.griffin_lim(torch.sqrt(lin), N_FFT, HOP, n_iter=32, length=len(x), **CPU)
    assert torch.equal(rec, again)
    spec = np.abs(np.fft.rfft(rec.numpy() * np.hanning(len(rec))))
    assert abs(np.argmax(spec) * SR / len(rec) - 440.0) < 25.0


def test_reconstruction_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mel = tg.MelParams(80, 0.0, 8000.0)
    for call in (lambda: tg.griffin_lim(np.ones((257, 4)), N_FFT, HOP),
                 lambda: tg.mel_to_linear(np.ones((80, 4)), mel, SR, N_FFT),
                 lambda: tg.invert_mel_db(np.zeros((80, 4)), mel, SR, N_FFT, HOP)):
        with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
            call()
