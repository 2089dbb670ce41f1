"""The port's package surface against the JAX package's, on the CPU.

The repairs of faults in modules ported earlier:

- the result classes: ``Spectrogram``'s ``T``, ``astype``, ``__getitem__``,
  ``__iter__`` (``list(spec)`` has ``n_bins`` rows while ``len`` counts
  frames), ``block_until_ready`` and DLPack export, and DLPack on ``Mfcc``
  and ``Chromagram``, with the JAX package's argument checks and texts;
  ``SpectrogramPlan.compute_into``;
- the package names: the mel/ERB scale functions and ``mel_filterbank``
  equal JAX's; ``set_default_dtype``/``get_default_dtype``,
  ``complex_dtype`` and ``ensure_x64``; ``runtime`` and ``__version__`` in
  ``__all__``; every name of the spectrogram-family surface;
- config 9's multirate MFCC plan at ``precision=DEFAULT`` (the 1-pass bf16
  tier, here its plain version) against the JAX plan (its interpret-mode
  kernel): the same output to ``tests/test_torch_port_tiers.py``'s 5e-3·max,
  and no further from exact f32 than JAX is.
"""

import jax
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.mfcc import MfccPlan as JaxMfccPlan
from spectrograms_tpu_torch import dtypes as tdt
from tests.conftest import noise

SR = 16000.0
CPU = dict(device="cpu")


def pair(m):
    """A mel-dB spectrogram of one package on 0.5 s of noise."""
    kw = CPU if m is tg else {}
    params = m.SpectrogramParams(m.StftParams(512, 128), SR)
    return m.compute_mel_db_spectrogram(noise(8000, seed=1), params,
                                        m.MelParams(40, 0.0, 8000.0), dtype="float64", **kw)


# ---- Spectrogram -------------------------------------------------------------

def test_spectrogram_indexing_and_iteration_match_jax():
    j, t = pair(sg), pair(tg)
    rows = list(t)
    assert len(rows) == t.n_bins == len(list(j)) == 40
    assert len(t) == t.n_frames == len(j) == 63  # frames: the reference's asymmetry
    np.testing.assert_allclose(rows[5].numpy(), np.asarray(list(j)[5]), rtol=1e-9)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=1e-9)
    np.testing.assert_allclose(t[:, 7].numpy(), np.asarray(j[:, 7]), rtol=1e-9)
    np.testing.assert_allclose(t[2, 9].item(), float(j[2, 9]), rtol=1e-9)
    assert tuple(t.T.shape) == tuple(j.T.shape) == (63, 40)
    np.testing.assert_allclose(t.T.numpy(), np.asarray(j.T), rtol=1e-9)


@pytest.mark.parametrize("dtype,want", [
    ("float32", torch.float32), (np.float32, torch.float32), (torch.float32, torch.float32),
    ("bfloat16", torch.bfloat16), (np.float16, torch.float16), ("float16", torch.float16),
])
def test_spectrogram_astype_is_a_tensor(dtype, want):
    t = pair(tg)
    out = t.astype(dtype)
    assert isinstance(out, torch.Tensor) and not isinstance(out, tg.Spectrogram)
    assert out.dtype == want and out.shape == t.data.shape
    ref = np.asarray(pair(sg).astype(np.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-2 if want in
                               (torch.bfloat16, torch.float16) else 1e-6)


def test_block_until_ready_returns_itself():
    t = pair(tg)
    assert t.block_until_ready() is t


def test_dlpack_round_trips():
    t = pair(tg)
    for back in (torch.from_dlpack(t), torch.utils.dlpack.from_dlpack(t.__dlpack__())):
        assert torch.equal(back, t.data)
    assert np.array_equal(np.from_dlpack(t), t.to_numpy())
    assert t.__dlpack_device__() == (1, 0) == tuple(pair(sg).__dlpack_device__())
    copied = torch.from_dlpack(t.__dlpack__(copy=True))
    copied.zero_()
    assert not torch.equal(copied, t.data)
    # a result that carries autograd exports its values
    x = torch.from_numpy(noise(4000, seed=2, dtype=np.float32)).requires_grad_(True)
    plan = tg.MelPowerPlan(tg.SpectrogramParams(tg.StftParams(512, 128), SR),
                           tg.MelParams(40, 0.0, 8000.0), **CPU)
    spec = plan.compute(x)
    assert spec.data.requires_grad
    assert torch.equal(torch.from_dlpack(spec), spec.data.detach())


def test_dlpack_argument_checks_match_jax():
    """``dlpack_export``'s checks raise the JAX package's ``BufferError`` texts."""
    for spec in (pair(sg), pair(tg)):
        with pytest.raises(BufferError, match="^stream must be None for CPU tensors$"):
            spec.__dlpack__(stream=1)
        with pytest.raises(BufferError, match=r"^Unsupported DLPack version: 0\.8$"):
            spec.__dlpack__(max_version=(0, 8))
        with pytest.raises(BufferError, match=r"^Only CPU device \(1, 0\) is supported, got \(2, 0\)$"):
            spec.__dlpack__(dl_device=(2, 0))
        spec.__dlpack__(max_version=(1, 0), dl_device=(1, 0))


def test_mfcc_and_chromagram_export_dlpack():
    x = noise(16000, seed=4, dtype=np.float32)
    mf = tg.compute_mfcc(x, tg.StftParams(512, 128), SR, 40, tg.MfccParams(13), **CPU)
    ch = tg.compute_chromagram(x, tg.StftParams(2048, 512), SR, **CPU)
    jmf = sg.compute_mfcc(x, sg.StftParams(512, 128), SR, 40, sg.MfccParams(13))
    for res, ref in ((mf, jmf), (ch, None)):
        back = torch.from_dlpack(res)
        assert torch.equal(back, res.data)
        assert res.__dlpack_device__() == (1, 0)
        assert np.array_equal(np.from_dlpack(res), res.to_numpy())
        with pytest.raises(BufferError, match="stream must be None"):
            res.__dlpack__(stream=1)
        if ref is not None:
            np.testing.assert_allclose(back.numpy(), np.asarray(ref.data),
                                       rtol=0, atol=1e-4 * float(np.abs(ref.data).max()))


# ---- compute_into ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_compute_into_fills_and_rejects(dtype):
    """``tests/test_streaming.py``'s compute_into check, on both packages.
    Noise keeps every band above the dB floor, where the two f32 routes
    agree to 1e-3 dB."""
    x = noise(16000, seed=5, dtype=np.dtype(dtype))
    outs = []
    for m, kw in ((sg, {}), (tg, CPU)):
        plan = m.MelDbPlan(m.SpectrogramParams(m.StftParams(512, 128), SR),
                           m.MelParams(40, 0.0, 8000.0), m.LogParams(-80.0), dtype=dtype, **kw)
        out = np.empty(plan.output_shape(len(x)), dtype=dtype)
        assert plan.compute_into(x, out) is out
        np.testing.assert_array_equal(out, np.asarray(plan.compute_raw(x)))
        with pytest.raises(m.DimensionMismatchError):
            plan.compute_into(x, np.empty((3, 3), dtype=dtype))
        outs.append(out)
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-3 if dtype == "float32" else 1e-9)


# ---- dtype defaults ----------------------------------------------------------------------

def test_set_default_dtype_changes_parse_dtype():
    assert tg.get_default_dtype() == torch.float32 == tg.parse_dtype(None)
    try:
        tg.set_default_dtype("float64")
        assert tg.parse_dtype(None) == torch.float64 == tg.get_default_dtype()
        plan = tg.LinearPowerPlan(tg.SpectrogramParams(tg.StftParams(256, 64), SR), **CPU)
        assert plan.dtype == "float64"
        assert tg.StftPlan(tg.SpectrogramParams(tg.StftParams(256, 64), SR), **CPU).dtype == "float64"
        assert tg.stft([0.0, 1.0, 0.5] * 100, 256, 64, **CPU).dtype == torch.complex128
        with pytest.raises(tg.InvalidInputError):
            tg.set_default_dtype("int8")
        assert tg.get_default_dtype() == torch.float64
    finally:
        tg.set_default_dtype("float32")
    assert tg.parse_dtype(None) == torch.float32 == tdt.DEFAULT_DTYPE


def test_complex_dtype_and_ensure_x64_match_jax():
    for name, want in (("float32", torch.complex64), ("float64", torch.complex128),
                       ("bfloat16", torch.complex64), (torch.float64, torch.complex128)):
        assert tg.complex_dtype(name) == want
        jname = name if isinstance(name, str) else "float64"
        assert str(sg.complex_dtype(sg.parse_dtype(jname))) == str(want).removeprefix("torch.")
    assert tg.ensure_x64(torch.float64) is None and tg.ensure_x64(torch.float32) is None


# ---- package names -----------------------------------------------------------------------

def test_scale_functions_are_exported_and_match_jax():
    hz = np.array([0.0, 100.0, 440.0, 1000.0, 4000.0, 8000.0])
    for name in ("hz_to_mel", "mel_to_hz", "hz_to_erb", "erb_to_hz"):
        assert name in tg.__all__
        np.testing.assert_allclose(np.asarray(getattr(tg, name)(hz)),
                                   np.asarray(getattr(sg, name)(hz)), rtol=1e-12)
    np.testing.assert_allclose(tg.mel_to_hz(tg.hz_to_mel(hz)), hz, rtol=1e-9, atol=1e-9)
    assert "mel_filterbank" in tg.__all__
    for mel in (tg.MelParams(40, 0.0, 8000.0), tg.MelParams(128, 20.0, 7600.0, tg.MelNorm.SLANEY)):
        jmel = sg.MelParams(mel.n_mels, mel.f_min, mel.f_max, sg.MelNorm(mel.norm.value))
        np.testing.assert_array_equal(tg.mel_filterbank(SR, 1024, mel),
                                      np.asarray(sg.mel_filterbank(SR, 1024, jmel)))


def test_runtime_and_version_in_all():
    assert "runtime" in tg.__all__ and "__version__" in tg.__all__
    assert tg.runtime.read_wav is not None and tg.__version__ == sg.__version__


SLICE_NAMES = [
    "set_default_dtype", "get_default_dtype", "complex_dtype", "ensure_x64",
    "SpectrogramPlanner", "StftPlan", "StftResult",
    *[f"{s}{a}Plan" for s in ("Linear", "Mel", "Erb", "LogHz", "Cqt")
      for a in ("Power", "Magnitude", "Db")],
    "fft", "rfft", "irfft", "power_spectrum", "magnitude_spectrum", "stft", "istft",
    "hz_to_mel", "mel_to_hz", "hz_to_erb", "erb_to_hz", "mel_filterbank",
    *[f"compute_{s}_{a}_spectrogram" for s in ("linear", "mel", "erb", "loghz", "cqt")
      for a in ("power", "magnitude", "db")],
    "compute_stft", "compute_fft", "compute_rfft", "compute_irfft", "compute_istft",
    "compute_power_spectrum", "compute_magnitude_spectrum", "FftPlanner",
    "fft_plan_cache_info", "clear_fft_plan_cache", "cache_stats",
    "griffin_lim", "mel_to_linear", "invert_mel_db", "mel_filterbank_pinv",
    "runtime", "__version__",
]


@pytest.mark.parametrize("name", SLICE_NAMES)
def test_slice_name_is_jax_name(name):
    """Each name of the spectrogram-family surface is in both ``__all__``s."""
    assert name in sg.__all__ and name in tg.__all__ and hasattr(tg, name)


def test_port_all_is_a_subset_of_jax_all():
    extra = set(tg.__all__) - set(sg.__all__)
    assert extra == {"Precision", "plan_constants_from_numpy"}, extra


# The JAX names the port has yet to port: none. Every name of the JAX
# package's ``__all__`` is the port's (``parallel`` and ``serde`` are
# modules in both).
STILL_TO_PORT = set()


def test_port_misses_exactly_the_names_still_to_port():
    missing = set(sg.__all__) - set(tg.__all__)
    assert STILL_TO_PORT == set()
    assert missing == STILL_TO_PORT, (missing - STILL_TO_PORT, STILL_TO_PORT - missing)
    for name in set(tg.__all__):
        assert hasattr(tg, name), name
    import types

    for name in ("parallel", "serde"):
        assert isinstance(getattr(tg, name), types.ModuleType)
        assert isinstance(getattr(sg, name), types.ModuleType)
        assert set(getattr(tg, name).__all__) == set(getattr(sg, name).__all__)


# ---- the DEFAULT tier on config 9's multirate MFCC ---------------------------------------

def test_default_multirate_mfcc_matches_jax():
    """Config 9 (``benchmarks/suite.py``: 44.1 kHz, 2048/512, mel-80 Slaney
    0–4 kHz multirate, MFCC-13) at ``precision=DEFAULT``: the inner plan at
    512/128 runs the 1-pass tier (the port's plain version; JAX's kernel in
    interpret mode). Both read the same distance from exact f32 (HIGHEST
    matmul, multirate): 0.106/0.124/0.005 of each row's peak on the
    harmonic rows and the noise row (the port and JAX equal to 1e-7 of it),
    against 0.036/0.042/0.005 for the port's full-rate DEFAULT plan: the
    tier itself is farther from exact at the decimated geometry, not the
    port."""
    sr = 44100.0
    t = np.arange(int(sr * 0.5)) / sr
    music = sum(np.sin(2 * np.pi * 220.0 * k * t + k) / k for k in range(1, 18)).astype(np.float32)
    xb = np.stack([music, music[::-1].copy(),
                   np.random.default_rng(9).standard_normal(len(music)).astype(np.float32)])

    def plan(m, method, precision):
        cls, kw = (tg.MfccPlan, CPU) if m is tg else (JaxMfccPlan, {})
        prec = getattr(tg.Precision if m is tg else jax.lax.Precision, precision)
        return cls(m.StftParams(2048, 512), sr,
                   mel_params=m.MelParams(80, 0.0, 4000.0, m.MelNorm.SLANEY).with_multirate(),
                   mfcc_params=m.MfccParams(13), dtype="float32", method=method, precision=prec,
                   **kw)

    tplan = plan(tg, "pallas", "DEFAULT")
    assert tplan._kernel_plan._n_fft == 512 and tplan._kernel_plan._kernel_kwargs == {
        "precision": "bf16"}
    port = tplan.compute_batch(xb).numpy()
    ref = np.asarray(plan(sg, "pallas", "DEFAULT").compute_batch(xb))
    exact = plan(tg, "matmul", "HIGHEST").compute_batch(xb).numpy()
    assert port.shape == ref.shape == (3, 13, 44)
    np.testing.assert_allclose(port, ref, rtol=0, atol=5e-3 * np.abs(ref).max())
    def full_rate(method, precision):
        return tg.MfccPlan(tg.StftParams(2048, 512), sr,
                           mel_params=tg.MelParams(80, 0.0, 4000.0, tg.MelNorm.SLANEY),
                           mfcc_params=tg.MfccParams(13), dtype="float32", method=method,
                           precision=precision, **CPU).compute_batch(xb).numpy()

    full = full_rate("pallas", tg.Precision.DEFAULT)
    full_exact = full_rate("matmul", tg.Precision.HIGHEST)
    for r in range(3):
        peak = np.abs(exact[r]).max()
        e_port = np.abs(port[r] - exact[r]).max() / peak
        e_jax = np.abs(ref[r] - exact[r]).max() / peak
        assert e_port <= e_jax * (1 + 1e-3) + 1e-6, (r, e_port, e_jax)
        e_full = np.abs(full[r] - full_exact[r]).max() / np.abs(full_exact[r]).max()
        assert e_full <= e_port, (r, e_full, e_port)
