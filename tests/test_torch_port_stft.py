"""The port's STFT layer against the JAX package's, on the CPU.

Same numpy inputs (seeded) through both packages:

- ``ops/ola.py``: ``overlap_add`` (hop | n_fft and irregular hops) and
  ``ola_matmul`` equal JAX's to 1e-12 in f64;
- ``ops/stft.py``: ``fft``, ``rfft``, ``irfft``, ``power_spectrum``,
  ``magnitude_spectrum``, ``stft`` and ``istft`` equal JAX's at rtol 1e-9 in
  f64 and to 1e-4·max in f32, mono and multichannel, with the JAX dtypes
  (complex64 / complex128); ``istft`` round trips to 1e-10 in f64
  (``tests/test_stft.py``); the error types and texts are JAX's;
- ``ops/dft.py``: the inverse real-DFT matrices equal JAX's;
- ``StftPlan``/``StftResult``: values, axes, ``compute_frame``, DLPack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.ops import dft as jdft
from spectrograms_tpu.ops import ola as jola
from spectrograms_tpu_torch.ops import dft as tdft
from spectrograms_tpu_torch.ops import ola as tola
from spectrograms_tpu_torch.ops import stft as tstft
from tests.conftest import noise, sine

F64 = dict(rtol=1e-9, atol=1e-12)
CPU = dict(device="cpu")


def f32_close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()))


# ---- ops/ola.py -------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop", [(256, 64), (256, 128), (400, 160), (128, 128), (100, 37)])
def test_overlap_add_matches_jax(n_fft, hop):
    frames = np.random.default_rng(n_fft + hop).standard_normal((9, n_fft))
    want = np.asarray(jola.overlap_add(jnp.asarray(frames), hop))
    got = tola.overlap_add(torch.from_numpy(frames), hop).numpy()
    assert got.shape == want.shape == ((9 - 1) * hop + n_fft,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_overlap_add_leading_dims():
    frames = np.random.default_rng(3).standard_normal((2, 3, 7, 64))
    for hop in (16, 24):
        got = tola.overlap_add(torch.from_numpy(frames), hop).numpy()
        for i in range(2):
            for j in range(3):
                want = np.asarray(jola.overlap_add(jnp.asarray(frames[i, j]), hop))
                np.testing.assert_allclose(got[i, j], want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (256, 128), (128, 128)])
def test_ola_matmul_matches_jax(n_fft, hop):
    rng = np.random.default_rng(n_fft // hop)
    coeffs = rng.standard_normal((11, 40))
    mat = rng.standard_normal((40, n_fft))
    want = np.asarray(jola.ola_matmul(jnp.asarray(coeffs), jnp.asarray(mat), hop))
    got = tola.ola_matmul(torch.from_numpy(coeffs), torch.from_numpy(mat), hop).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, tola.overlap_add(torch.from_numpy(coeffs @ mat), hop).numpy(),
                               rtol=0, atol=1e-12)


def test_ola_matmul_accumulates_in_f32():
    rng = np.random.default_rng(5)
    coeffs = torch.from_numpy(rng.standard_normal((6, 32))).to(torch.bfloat16)
    mat = torch.from_numpy(rng.standard_normal((32, 64))).to(torch.bfloat16)
    out = tola.ola_matmul(coeffs, mat, 16)
    assert out.dtype == torch.bfloat16
    ref = tola.overlap_add(coeffs.double() @ mat.double(), 16)
    # one bf16 rounding of an f32 sum, not one a partial product
    np.testing.assert_allclose(out.double().numpy(), ref.numpy(), rtol=1e-2, atol=1e-2)
    with pytest.raises(tg.InvalidInputError, match="hop"):
        tola.ola_matmul(coeffs, mat, 24)


# ---- ops/dft.py ---------------------------------------------------------------

@pytest.mark.parametrize("n_fft", [256, 400, 1024])
def test_irdft_matrices_match_jax(n_fft):
    for j, t in zip(jdft.irdft_matrices(n_fft, np.float64), tdft.irdft_matrices(n_fft, torch.float64)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    spec = np.fft.rfft(np.random.default_rng(n_fft).standard_normal(n_fft))
    ci, si = tdft.irdft_matrices(n_fft, torch.float64)
    back = torch.from_numpy(spec.real) @ ci + torch.from_numpy(spec.imag) @ si
    np.testing.assert_allclose(back.numpy(), np.fft.irfft(spec, n_fft), atol=1e-12)


# ---- ops/stft.py: one-shot FFTs ----------------------------------------------

@pytest.mark.parametrize("shape", [(3,), (300,), (512,), (2, 300)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fft_rfft_irfft_match_jax(shape, dtype):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(dtype)
    want = np.asarray(sg.fft(x, 512))
    got = tg.fft(x, 512, **CPU)
    assert got.dtype == (torch.complex64 if dtype == "float32" else torch.complex128)
    assert got.shape == want.shape
    close = f32_close if dtype == "float32" else (
        lambda o, r: np.testing.assert_allclose(o, r, **F64))
    close(got.numpy(), want)
    close(tg.rfft(x, 512, **CPU).numpy(), np.asarray(sg.rfft(x, 512)))
    close(tg.irfft(got, 512, **CPU).numpy(), np.asarray(sg.irfft(want, 512)))


@pytest.mark.parametrize("window", [None, "hann", tg.WindowType.BLACKMAN])
@pytest.mark.parametrize("shape", [(400,), (2, 300)])
def test_power_and_magnitude_spectrum_match_jax(window, shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape)
    jwin = sg.WindowType.BLACKMAN if window is tg.WindowType.BLACKMAN else window
    for name in ("power_spectrum", "magnitude_spectrum"):
        want = np.asarray(getattr(sg, name)(x, 512, jwin, dtype="float64"))
        got = getattr(tg, name)(x, 512, window, dtype="float64", **CPU).numpy()
        np.testing.assert_allclose(got, want, **F64)
        got32 = getattr(tg, name)(x.astype(np.float32), 512, window, **CPU)
        assert got32.dtype == torch.float32
        f32_close(got32.numpy(), np.asarray(getattr(sg, name)(x.astype(np.float32), 512, jwin)))


def test_power_spectrum_peak_and_unwindowed():
    x = sine(1000.0, sr=8000, duration=0.064)  # 512 samples
    p = tg.power_spectrum(x, 512, tg.WindowType.HANNING, **CPU).numpy()
    m = tg.magnitude_spectrum(x, 512, tg.WindowType.HANNING, **CPU).numpy()
    assert p.shape == (257,) and int(np.argmax(p)) == 64
    np.testing.assert_allclose(m, np.sqrt(p), atol=1e-10)
    np.testing.assert_allclose(tg.power_spectrum(x, 512, **CPU).numpy(),
                               np.abs(np.fft.rfft(x)) ** 2, atol=1e-8)


def test_one_shot_errors_match_jax():
    for m, kw in ((sg, {}), (tg, CPU)):
        with pytest.raises(m.InvalidInputError, match=r"Input length \(16\) exceeds FFT size \(8\)"):
            m.fft(np.ones(16), 8, **kw)
        with pytest.raises(m.InvalidInputError, match="exceeds FFT size"):
            m.power_spectrum(np.ones(16), 8, **kw)
        with pytest.raises(m.DimensionMismatchError):
            m.irfft(np.zeros(100, dtype=np.complex128), 512, **kw)
        with pytest.raises(m.InvalidInputError, match="expected a 1-D signal"):
            m.fft(np.zeros((2, 2, 4)), 8, **kw)
        with pytest.raises(m.InvalidInputError, match="signal must be non-empty"):
            m.fft(np.zeros(0), 8, **kw)
        with pytest.raises(m.InvalidInputError):
            m.fft(np.ones(4, dtype=np.int32), 8, **kw)


# ---- ops/stft.py: stft / istft -------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,centre", [
    (256, 128, True), (512, 256, True), (512, 128, True), (400, 160, True),
    (256, 128, False), (256, 100, True), (128, 128, False),
])
def test_stft_matches_jax(n_fft, hop, centre):
    x = noise(4000, seed=n_fft + hop)
    want = np.asarray(sg.stft(x, n_fft, hop, centre=centre))
    got = tg.stft(x, n_fft, hop, centre=centre, **CPU)
    assert got.dtype == torch.complex128 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F64)
    x32 = x.astype(np.float32)
    got32 = tg.stft(x32, n_fft, hop, centre=centre, **CPU)
    assert got32.dtype == torch.complex64
    f32_close(got32.numpy(), np.asarray(sg.stft(x32, n_fft, hop, centre=centre)))


@pytest.mark.parametrize("window", ["hamming", "blackman", "kaiser=8.0", "gaussian=60.0"])
def test_stft_windows_match_jax(window):
    x = noise(3000, seed=9)
    want = np.asarray(sg.stft(x, 256, 64, window=sg.parse_window(window)))
    got = tg.stft(x, 256, 64, window=tg.parse_window(window), **CPU).numpy()
    np.testing.assert_allclose(got, want, **F64)


def test_stft_multichannel_matches_jax_and_per_channel():
    x = np.random.default_rng(21).standard_normal((3, 4000))
    got = tg.stft(x, 512, 128, dtype="float64", **CPU).numpy()
    assert got.shape[0] == 3
    np.testing.assert_allclose(got, np.asarray(sg.stft(x, 512, 128, dtype="float64")), **F64)
    for c in range(3):
        np.testing.assert_allclose(got[c], tg.stft(x[c], 512, 128, **CPU).numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_stft_errors_match_jax():
    for m, kw in ((sg, {}), (tg, CPU)):
        with pytest.raises(m.InvalidInputError, match="hop_size must be <= n_fft"):
            m.stft(np.ones(100), 64, 128, **kw)
        with pytest.raises(m.InvalidInputError, match="multichannel input"):
            m.stft(np.zeros((2, 2, 100)), 64, 32, **kw)
        with pytest.raises(m.DimensionMismatchError):
            m.istft(np.zeros((100, 5), dtype=np.complex128), 512, 256, **kw)
        with pytest.raises(m.InvalidInputError, match="stft_matrix must be 2-D"):
            m.istft(np.zeros((2, 257, 5), dtype=np.complex128), 512, 256, **kw)
        with pytest.raises(m.InvalidInputError, match="hop_size must be <= n_fft"):
            m.istft(np.zeros((257, 5), dtype=np.complex128), 512, 1024, **kw)


@pytest.mark.parametrize("n_fft,hop,window,centre", [
    (512, 128, "hanning", True), (256, 64, "hamming", False), (400, 160, "hanning", True),
    (256, 256, "hanning", True),
])
def test_istft_matches_jax(n_fft, hop, window, centre):
    x = noise(4096, seed=n_fft)
    spec = np.asarray(sg.stft(x, n_fft, hop, window=sg.parse_window(window), centre=centre))
    want = np.asarray(sg.istft(spec, n_fft, hop, window=sg.parse_window(window), centre=centre))
    got = tg.istft(spec, n_fft, hop, window=tg.parse_window(window), centre=centre, **CPU)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    # f32: where the window-energy normalizer is at least 1e-3 of its peak.
    # Below that (the frame edges at hop = n_fft, where the Hann energy falls
    # to ~1e-8) the division amplifies f32 rounding in both packages alike;
    # the f64 check above holds every sample.
    s32 = spec.astype(np.complex64)
    got32 = tg.istft(s32, n_fft, hop, window=tg.parse_window(window), centre=centre, **CPU)
    assert got32.dtype == torch.float32
    want32 = np.asarray(sg.istft(s32, n_fft, hop, window=sg.parse_window(window), centre=centre))
    w64 = tg.make_window(tg.parse_window(window), n_fft)
    norm = tstft._ola_norm_np(tuple(w64.tolist()), n_fft, hop, spec.shape[1],
                              (spec.shape[1] - 1) * hop + n_fft)
    pad = n_fft // 2 if centre else 0
    well = norm[pad : pad + len(want)] >= 1e-3 * norm.max()
    assert well.mean() > 0.8  # 0.88 at hop = n_fft, 1.0 elsewhere
    f32_close(got32.numpy()[well], want32[well])


def test_istft_roundtrip_hann():
    x = sine(440.0, duration=0.5)
    y = tg.istft(tg.stft(x, 512, 128, **CPU), 512, 128, **CPU).numpy()
    n = min(len(y), len(x))
    np.testing.assert_allclose(y[:n], x[:n], atol=1e-10)


def test_istft_roundtrip_hamming_no_centre():
    x = noise(4096)
    s = tg.stft(x, 256, 64, window=tg.WindowType.HAMMING, centre=False, **CPU)
    y = tg.istft(s, 256, 64, window=tg.WindowType.HAMMING, centre=False, **CPU).numpy()
    np.testing.assert_allclose(y[256:-256], x[256 : len(y) - 256], atol=1e-8)


def test_istft_dtype_argument():
    s = tg.stft(noise(2000), 256, 64, **CPU)
    assert tg.istft(s, 256, 64, dtype="float32", **CPU).dtype == torch.float32


def test_irfft_roundtrip():
    x = noise(512)
    np.testing.assert_allclose(tg.irfft(tg.fft(x, 512, **CPU), 512, **CPU).numpy(), x, atol=1e-10)


def test_default_device_is_cuda(monkeypatch):
    """No ``device`` means CUDA: without a card the call raises, it does not
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tg.stft(noise(1000), 256, 64), lambda: tg.fft(noise(100), 128),
                 lambda: tg.istft(np.zeros((129, 4), np.complex64), 256, 64),
                 lambda: tg.StftPlan(tg.SpectrogramParams(tg.StftParams(256, 64), 16000.0))):
        with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
            call()


# ---- StftPlan / StftResult ---------------------------------------------------------

def _stft_plans(n_fft=512, hop=256, dtype="float64", centre=True):
    jp = sg.StftPlan(sg.SpectrogramParams(sg.StftParams(n_fft, hop, centre=centre), 16000.0),
                     dtype=dtype)
    tp = tg.StftPlan(tg.SpectrogramParams(tg.StftParams(n_fft, hop, centre=centre), 16000.0),
                     dtype=dtype, **CPU)
    return jp, tp


@pytest.mark.parametrize("centre", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_stft_plan_matches_jax(dtype, centre):
    jp, tp = _stft_plans(dtype=dtype, centre=centre)
    x = sine(440.0, duration=0.25)
    jr, tr = jp.compute(x), tp.compute(x)
    assert tp.dtype == jp.dtype == dtype and tr.dtype == jr.dtype == dtype
    assert (tr.n_bins, tr.n_frames, tr.n_channels, tr.shape) == (jr.n_bins, jr.n_frames,
                                                                  jr.n_channels, jr.shape)
    assert tr.n_frames == tp.frame_count(len(x)) == jp.frame_count(len(x))
    np.testing.assert_array_equal(tr.frequencies, jr.frequencies)
    assert (tr.sample_rate, tr.params) == (jr.sample_rate, tp.params.stft)
    assert tr.frequency_resolution == jr.frequency_resolution == 16000 / 512
    assert tr.time_resolution == jr.time_resolution == 256 / 16000
    close = f32_close if dtype == "float32" else (
        lambda o, r: np.testing.assert_allclose(o, r, **F64))
    close(tr.to_numpy(), np.asarray(jr.data))
    close(tr.norm().numpy(), np.asarray(jr.norm()))
    np.testing.assert_array_equal(np.asarray(tr), tr.to_numpy())
    for idx in (0, 3, tr.n_frames - 1):
        f = tp.compute_frame(x, idx)
        close(f.numpy(), np.asarray(jp.compute_frame(x, idx)))
        np.testing.assert_allclose(f.numpy(), tr.to_numpy()[:, idx], atol=1e-10)
    for m_plan in (jp, tp):
        with pytest.raises((sg.InvalidInputError, tg.InvalidInputError), match="out of range"):
            m_plan.compute_frame(x, 10_000)


def test_stft_plan_multichannel_and_dlpack():
    params = tg.SpectrogramParams(tg.StftParams(512, 128), 16000.0)
    plan = tg.SpectrogramPlanner(device="cpu").stft_plan(params, dtype="float32")
    x = np.random.default_rng(4).standard_normal((3, 4000)).astype(np.float32)
    res = plan.compute(x)
    assert (res.n_channels, res.n_bins, res.n_frames) == (3, 257, res.data.shape[-1])
    mono = plan.compute(x[0])
    assert mono.n_channels == 1 and mono.n_bins == 257
    np.testing.assert_allclose(res.to_numpy()[0], mono.to_numpy(), atol=1e-6)
    back = torch.from_dlpack(res)
    assert torch.equal(back, res.data) and res.__dlpack_device__()[0] == 1
    jr = sg.compute_stft(x, sg.SpectrogramParams(sg.StftParams(512, 128), 16000.0), dtype="float32")
    f32_close(tg.compute_stft(x, params, dtype="float32", **CPU).to_numpy(), np.asarray(jr.data))


def test_planner_spectra_match_jax():
    x = noise(400, seed=12)
    jp, tp = sg.SpectrogramPlanner(dtype="float64"), tg.SpectrogramPlanner(dtype="float64",
                                                                         device="cpu")
    for name in ("compute_power_spectrum", "compute_magnitude_spectrum"):
        np.testing.assert_allclose(getattr(tp, name)(x, 512, "hann").numpy(),
                                   np.asarray(getattr(jp, name)(x, 512, "hann")), **F64)
    params = tg.SpectrogramParams(tg.StftParams(256, 64), 16000.0)
    jparams = sg.SpectrogramParams(sg.StftParams(256, 64), 16000.0)
    np.testing.assert_allclose(tp.compute_stft(x, params).to_numpy(),
                               np.asarray(jp.compute_stft(x, jparams).data), **F64)
