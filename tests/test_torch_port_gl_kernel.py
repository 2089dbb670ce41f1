"""``csrc/griffin_lim.cu``: one launch per fast Griffin-Lim iteration.

On the CPU:

- the kernel's factorization, ``reconstruct.py::griffin_lim_kernel_twin``
  (per-frame rfft, the momentum step and projection, irfft, the window and
  the normalised overlap-add, with the kernel's runs and halo frames),
  against the matmul route (``griffin_lim`` on the CPU) and the JAX
  package's ``griffin_lim`` from the same initial phase, at the shapes and
  tolerances of ``tests/test_torch_port_reconstruct.py::
  test_f32_routes_match_jax``; the runs leave its values unchanged;
- the kernel route's plumbing through ``griffin_lim`` (momentum 0,
  ``centre=False``, ``length``, ``init_angles``, 2-D and 3-D input, a
  frame count that is not a whole number of runs), with the launch replaced
  by the twin's step, against the matmul route;
- the constants, computed in float64 and rounded to float32 once;
- which calls take the kernel (a stubbed library, ``Source.launch`` faked):
  a float32 CUDA magnitude at a power-of-two ``n_fft`` in the kernel's range
  and ``hop | n_fft``, one launch an iteration and one to start; a CPU
  tensor, float64, ``hop ∤ n_fft``, sizes and overlaps outside the range and
  inputs that require grad take the routes they took before, uncounted by
  the kernel.

The tests marked ``card`` launch the kernel and hold it against the twin
and against the matmul route on the same CUDA tensor, at the TTS cell's
shape and at ``n_fft`` 256, 2048 and 4096, with the medians of the
benchmark's ``sc_self_err`` and ``wave_err`` against a float64 Griffin-Lim
from the same phase; they skip without CUDA. JAX is imported only inside
the tests that compare with it, so on a machine without JAX ``python3 -m
pytest --noconftest tests/test_torch_port_gl_kernel.py -m card`` runs them.
"""

import contextlib

import numpy as np
import pytest
import torch

import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch import reconstruct as rc
from spectrograms_tpu_torch.ops import _build

CPU = torch.device("cpu")
SR = 16000.0


def sine(n, freq=440.0):
    return np.sin(2 * np.pi * freq * np.arange(n) / SR)


def noise(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def magnitude(x, n_fft, hop, centre=True):
    """(n_bins, n_frames) float32 |STFT| on the CPU."""
    return tg.stft(np.asarray(x, np.float32), n_fft, hop, centre=centre, device="cpu").abs()


def kernel_inputs(mag, n_fft, hop, init_angles=None, window=tg.WindowType.HANNING):
    """What ``griffin_lim`` hands the kernel for ``mag``."""
    mag_t = torch.as_tensor(mag).transpose(-1, -2)
    angles = rc._initial_angles(init_angles, mag_t.shape, torch.float32, mag_t.device)
    w64 = np.asarray(tg.make_window(window, n_fft), np.float64)
    return rc._kernel_inputs(mag_t, angles, w64, n_fft, hop)


def twin(mag, n_fft, hop, n_iter, momentum=0.99, init_angles=None, run=rc.KERNEL_RUN):
    """The twin's waveform, sliced as ``griffin_lim`` slices (centred, full length)."""
    mag_k, angles_k, tables, lead = kernel_inputs(mag, n_fft, hop, init_angles)
    y = rc.griffin_lim_kernel_twin(mag_k, angles_k, tables, n_fft, hop, n_iter, momentum, run)
    n_frames = mag_k.shape[1]
    return y.reshape(*lead, -1)[..., n_fft // 2 : n_fft // 2 + (n_frames - 1) * hop]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def spectral_convergence(y, mag, n_fft, hop):
    got = np.abs(tg.stft(np.asarray(y, np.float64), n_fft, hop, device="cpu").numpy())
    got = got[:, : mag.shape[1]]
    return float(np.linalg.norm(got - mag) / np.linalg.norm(mag))


# ---- the factorization on the CPU ------------------------------------------------------

@pytest.mark.parametrize("signal", ["sine", "noise"])
def test_twin_matches_the_matmul_route_and_jax(signal):
    """From JAX's initial phase, as test_f32_routes_match_jax holds the
    matmul route at its shape in the kernel's domain, 512/128: 1e-4 of the
    peak after 8 iterations, 2e-2 after 32, the spectral convergence within
    1e-5."""
    n_fft, hop = 512, 128
    import jax

    from spectrograms_tpu.reconstruct import griffin_lim as jgl

    x = (sine(8000) if signal == "sine" else noise(8000, seed=5)).astype(np.float32)
    mag = magnitude(x, n_fft, hop).numpy()
    ang = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.T.shape, dtype=mag.dtype,
                                        minval=-np.pi, maxval=np.pi)).T
    for n_iter, tol in ((8, 1e-4), (32, 2e-2)):
        want = np.asarray(jgl(mag, n_fft, hop, n_iter=n_iter))
        chain = tg.griffin_lim(mag, n_fft, hop, n_iter=n_iter, init_angles=ang, device="cpu")
        got = twin(mag, n_fft, hop, n_iter, init_angles=ang)
        assert got.dtype == torch.float32
        assert rel(got, want) <= tol and rel(got, chain) <= tol
    assert abs(spectral_convergence(got, mag, n_fft, hop)
               - spectral_convergence(want, mag, n_fft, hop)) < 1e-5


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (64, 4), (128, 128)], ids=["k4", "k16", "k1"])
def test_the_runs_leave_the_values_unchanged(n_fft, hop):
    """Runs of 1, 3 and 37 segments and one run over the row: the halo
    frames are recomputed to the same values."""
    mag = magnitude(noise(24 * hop + 11, seed=9), n_fft, hop)
    ys = [twin(mag, n_fft, hop, 3, run=run) for run in (1, 3, 37, 10**6)]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


def test_tables_are_the_float64_constants_rounded_once():
    n_fft, hop, n_frames = 256, 64, 9
    w = np.asarray(tg.make_window(tg.WindowType.HANNING, n_fft), np.float64)
    t64 = rc._kernel_tables_np(n_fft, hop, tuple(w.tolist()), n_frames)
    m = n_fft // 2
    norm = np.zeros((n_frames - 1) * hop + n_fft)
    for f in range(n_frames):
        norm[f * hop : f * hop + n_fft] += w * w
    inv = t64[7 * n_fft // 2 + 4 :]
    assert inv.size == norm.size
    np.testing.assert_allclose(inv[norm > 1e-10], 1.0 / norm[norm > 1e-10], rtol=1e-12)
    assert (inv[norm <= 1e-10] == 1.0).all() and (norm <= 1e-10).any()
    np.testing.assert_array_equal(t64[:n_fft], w)
    np.testing.assert_allclose(t64[n_fft : 2 * n_fft], w / n_fft, rtol=1e-15)
    tw = t64[2 * n_fft : 3 * n_fft].reshape(m, 2)
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], np.exp(-2j * np.pi * np.arange(m) / m),
                               atol=1e-15)
    rs = t64[3 * n_fft : 3 * n_fft + m + 2].reshape(m // 2 + 1, 2)
    np.testing.assert_allclose(rs[:, 0] + 1j * rs[:, 1],
                               np.exp(-2j * np.pi * np.arange(m // 2 + 1) / n_fft), atol=1e-15)
    dev = rc._device_tables(n_fft, hop, tuple(w.tolist()), n_frames, CPU)
    assert dev is rc._device_tables(n_fft, hop, tuple(w.tolist()), n_frames, CPU)
    assert torch.equal(dev, torch.from_numpy(t64.astype(np.float32)))


# ---- the kernel route's plumbing: the twin's step in place of the launch ---------------

@pytest.fixture
def twin_route(monkeypatch):
    """CPU tensors report ``is_cuda`` and each launch runs the twin's step."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(rc, "_kernel_step", rc._twin_step)
    monkeypatch.setattr(rc, "gl_kernel_calls", 0)
    monkeypatch.setattr(rc, "gl_matmul_calls", 0)


ROUTE_CASES = {
    "momentum_0": dict(momentum=0.0),
    "centre_off": dict(centre=False),
    "length": dict(length=5000),
    "long_length": dict(length=10**6),
    "init_angles": dict(init_angles="given"),
    "batch_3d": dict(batch=3),
    "batch_3d_shared_angles": dict(batch=2, init_angles="given"),
    "hamming_frames_not_a_run": dict(window=tg.WindowType.HAMMING, n=37 * 128 + 50),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_the_kernel_route_matches_the_matmul_route(case, twin_route):
    kw = dict(ROUTE_CASES[case])
    n_fft, hop, n_iter = 512, 128, 4
    n, batch, window = kw.pop("n", 6000), kw.pop("batch", None), kw.pop("window", None)
    g = np.random.default_rng(len(case))
    rows = [sine(n, f) + 0.1 * g.standard_normal(n) for f in (330.0, 660.0, 990.0)[:batch or 1]]
    mag = np.stack([magnitude(r, n_fft, hop, kw.get("centre", True)).numpy() for r in rows])
    mag = mag if batch else mag[0]
    if kw.get("init_angles") == "given":
        kw["init_angles"] = g.uniform(-np.pi, np.pi, mag.shape[-2:])
    if window is not None:
        kw["window"] = window
    with contextlib.ExitStack() as stack:   # the matmul route first, as a CPU call takes it
        stack.enter_context(pytest.MonkeyPatch.context()).setattr(
            torch.Tensor, "is_cuda", property(lambda self: False))
        want = tg.griffin_lim(mag, n_fft, hop, n_iter=n_iter, device="cpu", **kw)
    assert rc.gl_matmul_calls == 1
    got = tg.griffin_lim(mag, n_fft, hop, n_iter=n_iter, device="cpu", **kw)
    assert (rc.gl_kernel_calls, rc.gl_matmul_calls) == (1, 1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel(got, want) <= 1e-4


# ---- which calls take the kernel: a stubbed library ------------------------------------

class FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        if fn == "griffin_lim_launch":
            return lambda *args: self.calls.append(args) or 0
        if fn == "griffin_lim_error_string":
            return lambda rc_: b"an error"
        raise AttributeError(fn)


@pytest.fixture
def stub(monkeypatch):
    """CPU tensors report ``is_cuda``, the kernel's library is a recorder,
    the CUDA calls of ``Source.launch`` are faked, the counters start at 0."""
    lib = FakeLibrary()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build.SOURCES["griffin_lim"], "lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 100, raising=False)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for name in ("launches", "gl_iterations", "gl_kernel_calls", "gl_matmul_calls",
                 "gl_fft_calls"):
        monkeypatch.setattr(rc, name, 0)
    return lib


def counters():
    return rc.launches, rc.gl_kernel_calls, rc.gl_matmul_calls, rc.gl_fft_calls


@pytest.mark.parametrize("n_iter", [-1, 0, 1, 4])
@pytest.mark.parametrize("batch", [None, 3])
def test_a_qualifying_call_launches_once_an_iteration_and_once_to_start(stub, n_iter, batch):
    """A negative count runs no iteration, as the chain's loop does."""
    n_fft, hop = 256, 64
    mag = torch.rand((batch, 129, 20) if batch else (129, 20))
    y = tg.griffin_lim(mag, n_fft, hop, n_iter=n_iter, momentum=0.5, length=1000, device="cpu")
    assert tuple(y.shape) == ((batch, 1000) if batch else (1000,))
    assert counters() == (1 + max(0, n_iter), 1, 0, 0) and rc.gl_iterations == n_iter
    calls = stub.calls
    assert [c[13] for c in calls] == [0] + [1] * max(0, n_iter - 1) + [2] * (n_iter > 0)
    rows = batch or 1
    for c in calls:
        assert c[2] == 0                                    # one phase for every row
        assert c[8:13] == (rows, 20, n_fft, hop, 0.5) and c[14] == 100
    start = calls[0]
    assert start[3] == 0 and start[5] == 0                  # no old spectrum, no old signal
    # the spectrum and the signal ping-pong; the last iteration stores no spectrum
    for i, c in enumerate(calls[1:]):
        assert c[3] == (calls[i][4]) and c[5] == calls[i][6]
        assert c[4] == (0 if i == n_iter - 1 else c[4]) and c[4] != c[3]
        assert c[6] != c[5]
    if n_iter:
        assert y.data_ptr() >= calls[-1][6]


def test_given_angles_per_row_are_read_per_row(stub):
    mag = torch.rand((2, 129, 20))
    ang = np.random.default_rng(0).uniform(-np.pi, np.pi, (2, 129, 20))
    tg.griffin_lim(mag, 256, 64, n_iter=1, init_angles=ang, device="cpu")
    assert stub.calls[0][2] == 20 * (128 + 4)


CHAIN_CASES = {
    # case: (dtype, n_fft, hop, the route it takes)
    "float64": (torch.float64, 256, 64, "fft"),
    "hop_not_dividing": (torch.float32, 256, 96, "matmul"),
    "n_fft_not_a_power_of_two": (torch.float32, 400, 100, "matmul"),
    "n_fft_below_the_range": (torch.float32, 32, 8, "matmul"),
    "n_fft_above_the_range": (torch.float32, 8192, 2048, "fft"),
    "overlap_above_16": (torch.float32, 1024, 32, "matmul"),
    "requires_grad": (torch.float32, 256, 64, "matmul"),
    "angles_require_grad": (torch.float32, 256, 64, "matmul"),
}


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_every_other_cuda_call_takes_the_route_it_took(stub, monkeypatch, case):
    dtype, n_fft, hop, route = CHAIN_CASES[case]
    monkeypatch.setattr("spectrograms_tpu_torch.reconstruct.check_true_f32", lambda: None)
    mag = torch.rand((n_fft // 2 + 1, 6), dtype=dtype)
    kw = {}
    if case == "requires_grad":
        mag.requires_grad_(True)
    if case == "angles_require_grad":
        kw["init_angles"] = torch.zeros((n_fft // 2 + 1, 6), dtype=torch.float64,
                                        requires_grad=True)
    y = tg.griffin_lim(mag, n_fft, hop, n_iter=2, device="cpu", **kw)
    assert stub.calls == [] and rc.launches == 0 and rc.gl_kernel_calls == 0
    assert (rc.gl_matmul_calls, rc.gl_fft_calls) == ((1, 0) if route == "matmul" else (0, 1))
    assert rc.gl_iterations == 2 and torch.isfinite(y).all()
    if case == "requires_grad":
        assert y.requires_grad


def test_cpu_tensors_take_the_matmul_route_uncounted_by_the_kernel(monkeypatch):
    monkeypatch.setattr(_build.SOURCES["griffin_lim"], "lib", None)
    monkeypatch.setattr(_build, "load_library", lambda *a: pytest.fail("the kernel was loaded"))
    for name in ("launches", "gl_kernel_calls", "gl_matmul_calls"):
        monkeypatch.setattr(rc, name, 0)
    mag = magnitude(noise(4000, seed=2), 512, 128)
    tg.griffin_lim(mag, 512, 128, n_iter=2, device="cpu")
    assert (rc.launches, rc.gl_kernel_calls, rc.gl_matmul_calls) == (0, 0, 1)


def test_an_empty_batch_launches_nothing(stub):
    y = tg.griffin_lim(torch.zeros((0, 129, 10)), 256, 64, n_iter=3, device="cpu")
    assert tuple(y.shape) == (0, 9 * 64) and stub.calls == []
    assert (rc.launches, rc.gl_kernel_calls) == (0, 1)


# ---- on the card -----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_kernels(["griffin_lim"])
    return torch.device("cuda", 0)


def tones(rows, n, sr, seed):
    """Noise plus three tones a row, as the benchmark's traffic."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.05 * g.standard_normal((rows, n))
    for _ in range(3):
        x += g.uniform(0.1, 0.5, (rows, 1)) * np.sin(2 * np.pi * g.uniform(80, 0.45 * sr, (rows, 1)) * t)
    return torch.from_numpy(x.astype(np.float32))


def chain(mag, n_fft, hop, n_iter, **kw):
    """The route the call took before the kernel: the same call on an input
    that requires grad, without a graph."""
    with torch.no_grad():
        return tg.griffin_lim(mag.detach().clone().requires_grad_(True), n_fft, hop,
                              n_iter=n_iter, **kw)


def medians(y, ref, mag64, n_fft, hop):
    """(sc_self_err, wave_err) as the TTS cell's check takes them: medians over
    the rows of |SC(y) − SC(ref)|/SC(ref) and of max|y − ref|/max|ref|."""
    def sc(z):
        s = tg.stft(z.to(torch.float64), n_fft, hop).abs()[..., : mag64.shape[-1]]
        return torch.linalg.vector_norm(s - mag64, dim=(-2, -1)) / torch.linalg.vector_norm(
            mag64, dim=(-2, -1))
    sc_ref = sc(ref)
    sc_err = ((sc(y) - sc_ref).abs() / sc_ref).median()
    wave = ((y.to(torch.float64) - ref).abs().amax(-1) / ref.abs().amax(-1)).median()
    return float(sc_err), float(wave)


@pytest.mark.card
@pytest.mark.parametrize("n_fft,hop,rows,n,sr", [
    (1024, 256, 32, 220500, 22050.0),     # the TTS cell's batch
    (256, 64, 8, 48000, 16000.0),
    (2048, 512, 8, 96000, 44100.0),
    (4096, 1024, 4, 192000, 44100.0),
], ids=["tts_cell", "n256", "n2048", "n4096"])
def test_the_kernel_matches_its_twin_the_chain_and_float64(card, n_fft, hop, rows, n, sr):
    x = tones(rows, n, sr, seed=n_fft).to(card)
    mag = tg.stft(x, n_fft, hop).abs()
    rc.launches = rc.gl_kernel_calls = 0
    with torch.no_grad():
        y1 = tg.griffin_lim(mag, n_fft, hop, n_iter=1, length=n)
        y32 = tg.griffin_lim(mag, n_fft, hop, n_iter=32, length=n)
    torch.cuda.synchronize()
    assert (rc.launches, rc.gl_kernel_calls) == (2 + 33, 2)
    # one iteration: against the twin and the chain on the same tensor
    mag_k, angles_k, tables, _ = kernel_inputs(mag, n_fft, hop)
    pad = slice(n_fft // 2, n_fft // 2 + n)
    t1 = rc.griffin_lim_kernel_twin(mag_k, angles_k, tables, n_fft, hop, 1, 0.99)[:, pad]
    c1 = chain(mag, n_fft, hop, 1, length=n)
    for ref in (t1, c1):
        assert float(((y1 - ref).abs().amax(-1) / ref.abs().amax(-1)).max()) <= 1e-4
    # 32 iterations: the cell's medians against float64 from the same phase
    ref64 = chain(mag.to(torch.float64), n_fft, hop, 32, length=n)
    mag64 = mag.to(torch.float64)
    sc_err, wave = medians(y32, ref64, mag64, n_fft, hop)
    c_sc, c_wave = medians(chain(mag, n_fft, hop, 32, length=n), ref64, mag64, n_fft, hop)
    print(f"n_fft {n_fft}: kernel sc {sc_err:.3e} wave {wave:.3e}; chain sc {c_sc:.3e} "
          f"wave {c_wave:.3e}")
    assert sc_err <= 1e-5 and wave <= 0.03


@pytest.mark.card
@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_the_kernel_matches_its_twin_over_the_domain(card, n_fft, k):
    hop = n_fft // k
    x = tones(3, 40 * hop + 17, 16000.0, seed=k).to(card)
    mag = tg.stft(x, n_fft, hop).abs()
    mag_k, angles_k, tables, _ = kernel_inputs(mag, n_fft, hop)
    for n_iter in (0, 3):
        y = rc._kernel_run(mag_k, angles_k, tables, n_fft, hop, n_iter, 0.99, rc._kernel_step)
        torch.cuda.synchronize()
        t = rc.griffin_lim_kernel_twin(mag_k, angles_k, tables, n_fft, hop, n_iter, 0.99)
        assert float(((y - t).abs().amax(-1) / t.abs().amax(-1)).max()) <= 1e-4


@pytest.mark.card
def test_the_public_entries_on_the_card(card):
    """2-D input, ``centre=False``, ``length``, momentum 0 and
    ``invert_mel_db`` take the kernel and agree with the chain."""
    x = tones(1, 16000, SR, seed=3)[0].to(card)
    mag = tg.stft(x, 512, 128, centre=False).abs()
    rc.launches = rc.gl_kernel_calls = 0
    y = tg.griffin_lim(mag, 512, 128, centre=False, n_iter=2, momentum=0.0, length=9000)
    torch.cuda.synchronize()
    assert (rc.launches, rc.gl_kernel_calls) == (3, 1) and tuple(y.shape) == (9000,)
    ref = chain(mag, 512, 128, 2, centre=False, momentum=0.0, length=9000)
    assert rel(y.cpu(), ref.cpu()) <= 1e-4
    mel = tg.MelParams(80, 0.0, 8000.0, tg.MelNorm.SLANEY)
    plan = tg.MelDbPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), SR), mel,
                        tg.LogParams(-80.0), dtype="float32")
    db = plan.compute_batch(tones(2, 16000, SR, seed=4).to(card))
    audio = tg.invert_mel_db(db, mel, SR, 1024, 256, n_iter=4, length=16000)
    torch.cuda.synchronize()
    assert rc.gl_kernel_calls == 2 and tuple(audio.shape) == (2, 16000)
