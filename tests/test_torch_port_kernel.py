"""The port's fused-kernel module against the JAX package's Pallas kernel.

The CUDA kernel itself runs only on a GPU (``chip_smoke.py`` holds it
against its plain version there). Here, on the CPU, the plain version
``fused_features_reference`` — which the runner takes for CPU tensors — is
held against the JAX kernel run as ``tests/test_pallas.py`` runs it
(``method="pallas"``, interpret mode), at that file's tolerances. The
wrapper's host-side arithmetic (bands, tiles, the build) is checked too.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.mfcc import MfccPlan as JaxMfccPlan
from spectrograms_tpu.ops import pallas_factored as jpf
from spectrograms_tpu_torch.mfcc import MfccPlan as PortMfccPlan
from spectrograms_tpu_torch.ops import _build
from spectrograms_tpu_torch.ops import f32_layout as fl32
from spectrograms_tpu_torch.ops import fused_factored as tff
from spectrograms_tpu_torch.ops.gradients import kernel_forward_twin_grad
from tests.conftest import noise, sine

SR = 16000.0


def spec_plan(m, scale, amp, n_fft=1024, hop=256, method="pallas"):
    fs, sp = {
        "linear": (m.FreqScale.LINEAR, None),
        "mel": (m.FreqScale.MEL, m.MelParams(128, 0.0, 8000.0, m.MelNorm.SLANEY)),
        "mel40": (m.FreqScale.MEL, m.MelParams(40, 0.0, 8000.0, m.MelNorm.SLANEY)),
        "loghz": (m.FreqScale.LOG_HZ, m.LogHzParams(48, 50.0, 8000.0)),
        "erb": (m.FreqScale.ERB, m.ErbParams(32, 50.0, 8000.0)),
    }[scale]
    kw = dict(device="cpu") if m is tg else {}
    return m.SpectrogramPlan(
        m.SpectrogramParams(m.StftParams(n_fft, hop), SR), fs,
        m.AmpScale.DECIBELS if amp == "db" else m.AmpScale.POWER,
        scale_params=sp, log_params=m.LogParams(-80.0) if amp == "db" else None,
        dtype="float32", method=method, **kw,
    )


def mfcc_plan(m, n_mfcc=40, include_c0=True):
    cls, kw = (PortMfccPlan, dict(device="cpu")) if m is tg else (JaxMfccPlan, {})
    return cls(
        m.StftParams(1024, 256), SR,
        mel_params=m.MelParams(128, 0.0, 8000.0, m.MelNorm.SLANEY),
        mfcc_params=m.MfccParams(n_mfcc, include_c0=include_c0),
        log_params=m.LogParams(-80.0), dtype="float32", method="pallas", **kw,
    )


@pytest.mark.parametrize("n_fft", [128, 256, 384, 512, 1000, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("hop", [100, 160, 256, 1024])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_supports_predicate_is_the_jax_one(n_fft, hop, dtype):
    assert tff.supports_factored_fusion(n_fft, hop, dtype) == jpf.supports_factored_fusion(
        n_fft, hop, np.dtype(dtype))


def test_parse_pallas_method():
    """The port's parse returns the JAX dicts, and raises where JAX raises."""
    for method in ("pallas", "pallas:dif", "pallas:stack", "pallas:gauss", "pallas:prune",
                   "pallas:x2", "pallas:x2+dif", "pallas:x2+gauss", "pallas:dif+stack",
                   "pallas:x2+stack", "pallas:dif+x2+prune"):
        assert tff.parse_pallas_method(method) == jpf.parse_pallas_method(method), method
    assert tff.parse_pallas_method("pallas:x2+dif") == {"precision": "bf16x2", "dif": True}
    for bad in ("pallas:nope", "pallas:x2+nope", "pallas:", "matmul"):
        with pytest.raises(sg.InvalidInputError):
            jpf.parse_pallas_method(bad)
        with pytest.raises(tg.InvalidInputError):
            tff.parse_pallas_method(bad)


# (scale, amp, n_fft, hop); the tolerances are those of test_pallas.py:
# 2e-2 dB for dB outputs, rtol/atol 2e-3·max for power outputs.
SPECTROGRAM_CASES = [
    ("mel", "db", 1024, 256),       # the flagship's mel-dB sibling
    ("mel", "power", 1024, 256),
    ("mel40", "db", 512, 160),      # frames-input geometry (hop ∤ n_fft)
    ("linear", "db", 1024, 256),    # identity mapping
    ("linear", "power", 1024, 256),
    ("loghz", "power", 1024, 256),
    ("erb", "power", 1024, 256),
]


@pytest.mark.parametrize("scale,amp,n_fft,hop", SPECTROGRAM_CASES)
def test_reference_matches_the_jax_kernel(scale, amp, n_fft, hop):
    x = noise(16000, seed=21, dtype=np.float32)
    ref = np.asarray(spec_plan(sg, scale, amp, n_fft, hop).compute_raw(x))
    port = spec_plan(tg, scale, amp, n_fft, hop)
    before = tff.fused_factored_features.launches
    out = port.compute_raw(x).numpy()
    assert tff.fused_factored_features.launches == before  # CPU: no launch
    assert out.shape == ref.shape
    if amp == "db":
        np.testing.assert_allclose(out, ref, atol=2e-2)
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3 * np.max(np.abs(ref)))


def test_flagship_mfcc_reference_matches_the_jax_kernel():
    x = noise(16000, seed=22, dtype=np.float32)
    xb = np.stack([x, 0.5 * x])
    ref = np.asarray(mfcc_plan(sg).compute_batch(xb))
    out = mfcc_plan(tg).compute_batch(xb).numpy()
    assert out.shape == ref.shape == (2, 40, 63)
    np.testing.assert_allclose(out, ref, atol=5e-3 * np.abs(ref).max())


def test_mfcc_c0_drop_matches_the_jax_kernel():
    x = sine(440.0, dtype=np.float32)
    ref = np.asarray(mfcc_plan(sg, 13, include_c0=False).compute(x).data)
    out = mfcc_plan(tg, 13, include_c0=False).compute(x).to_numpy()
    assert out.shape == ref.shape == (12, 63)
    # test_pallas.py::test_fused_mfcc_drops_c0's tolerance: a pure sine
    # leaves bands at the dB floor, where f32 rounding is amplified.
    np.testing.assert_allclose(out, ref, atol=8e-3 * np.abs(ref).max())


def test_pre_amp_magnitude_factory_matches_the_jax_kernel():
    """The chroma mode: sqrt before the filterbank, power amp, 4096/1024."""
    from spectrograms_tpu.ops.filterbanks import chroma_filterbank

    sr, n_fft, hop = 22050.0, 4096, 1024
    fb = chroma_filterbank(sr, n_fft, sg.ChromaParams())
    win = tuple(sg.make_window("hann", n_fft).tolist())
    x = noise(22050, seed=23, dtype=np.float32)
    jrun = jpf.fused_factored_features(
        n_fft, hop, win, jpf.KernelConst(fb), amp="power", centre=True,
        pre_amp="magnitude", interpret=True)
    ref = np.asarray(jrun(jnp.asarray(x)))
    trun = tff.fused_factored_features(
        n_fft, hop, win, tff.KernelConst(fb), amp="power", centre=True,
        pre_amp="magnitude", device="cpu")
    out = trun(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (12, 22)
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3 * np.abs(ref).max())


def test_runner_checks_its_input():
    run = tff.fused_factored_features(512, 128, None, "identity", device="cpu")
    assert run(torch.zeros(2, 1000)).shape == (2, 257, 8)
    with pytest.raises(tg.InvalidInputError, match="float32"):
        run(torch.zeros(1000, dtype=torch.float64))
    with pytest.raises(tg.InvalidInputError, match="on meta"):
        run(torch.zeros(1000, device="meta"))
    with pytest.raises(tg.InvalidInputError):
        tff.fused_factored_features(1000, 250, None, "identity", device="cpu")
    with pytest.raises(tg.InvalidInputError):
        tff.fused_factored_features(512, 128, None, tff.KernelConst(np.ones((4, 100))),
                                    device="cpu")
    with pytest.raises(tg.InvalidInputError):
        tff.fused_factored_features(512, 128, None, "identity", amp="bogus", device="cpu")
    with pytest.raises(tg.InvalidInputError, match="runs on CUDA"):
        tff.fused_factored_features(512, 128, None, "identity", device="meta")


@pytest.mark.parametrize("fb_name", ["mel", "identity", "loghz", "erb", "empty rows"])
def test_mapping_bands_cover_every_nonzero(fb_name):
    from spectrograms_tpu_torch.ops import filterbanks as tfb

    fb = {
        "mel": lambda: tfb.mel_filterbank(SR, 1024, tg.MelParams(128, 0.0, 8000.0, "slaney")),
        "identity": lambda: np.eye(513),
        "loghz": lambda: tfb.loghz_matrix(SR, 1024, tg.LogHzParams(48, 50.0, 8000.0))[0],
        "erb": lambda: tfb.erb_filterbank(SR, 1024, tg.ErbParams(32, 50.0, 8000.0))[0],
        "empty rows": lambda: np.vstack([np.zeros((2, 513)), np.eye(513)[100:103]]),
    }[fb_name]()
    bands = tff.mapping_bands(fb)
    assert bands.shape == (fb.shape[0], 2) and bands.dtype == np.int32
    for m, (lo, hi) in enumerate(bands):
        assert not fb[m, :lo].any() and not fb[m, hi:].any()
        assert lo == hi == 0 or (fb[m, lo] != 0 and fb[m, hi - 1] != 0)
    p = np.random.default_rng(24).exponential(size=(5, fb.shape[1]))
    banded = np.stack(
        [[p[f, lo:hi] @ fb[m, lo:hi] for m, (lo, hi) in enumerate(bands)] for f in range(5)])
    np.testing.assert_allclose(banded, p @ fb.T, rtol=1e-13, atol=0)
    if fb_name == "identity":
        np.testing.assert_array_equal(bands[:, 1] - bands[:, 0], 1)


def test_tiles_fit_in_shared_memory():
    for n_fft in (256, 512, 1024, 2048, 4096):
        n_bins = n_fft // 2 + 1
        for n_out, dct in ((128, True), (n_bins, False), (12, False)):
            for hop in (160, n_fft):
                n_items = n_bins if n_out == n_bins else 4 * n_out
                tile = fl32.tile_frames(n_fft, hop, n_items, n_out, dct)
                assert 1 <= tile and tile * n_fft // 16 <= fl32.MAX_THREADS
                buf_off, smem = fl32.smem_layout(tile, n_fft, hop, n_items, n_out, dct)
                assert smem <= tff._MAX_SMEM and buf_off % 4 == 0
    # the flagship: 4 frames, 256 threads, 24.5 KB (six blocks an SM at 40 registers)
    assert fl32.tile_frames(1024, 256, 189, 128, True) == 4
    assert fl32.smem_layout(4, 1024, 256, 189, 128, True)[1] == 25616
    assert fl32.tile_frames(4096, 1024, 588, 12, False) == 2      # chroma: 512 threads
    with pytest.raises(tg.InvalidInputError):
        fl32.tile_frames(4096, 1024, 2049, 60000, True)


def test_launch_signature_matches_the_c_entry():
    argtypes, restype = tff._SIGNATURES["fused_features_launch"]
    assert restype is ctypes.c_int
    src = (_build._CSRC / "fused_features.cu").read_text()
    entry = src[src.index('extern "C" int fused_features_launch('):]
    params = [q.strip() for q in entry[entry.index("(") + 1: entry.index(")")].split(",")]
    assert len(params) == len(argtypes)
    c_type = {ctypes.c_void_p: "*", ctypes.c_int: "int ", ctypes.c_longlong: "long long ",
              ctypes.c_float: "float "}
    for param, argtype in zip(params, argtypes):
        if argtype is ctypes.c_void_p:
            assert "*" in param, param
        else:
            assert param.startswith(c_type[argtype]) and "*" not in param, (param, argtype)
    assert "pallas_factored.py::_kernel" in src
    assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_tier_launch_signature_matches_the_c_entry():
    argtypes, restype = tff._TIER_SIGNATURES["fused_tier_features_launch"]
    assert restype is ctypes.c_int
    src = (_build._CSRC / "fused_tier_features.cu").read_text()
    entry = src[src.index('extern "C" int fused_tier_features_launch('):]
    params = [q.strip() for q in entry[entry.index("(") + 1: entry.index(")")].split(",")]
    assert len(params) == len(argtypes)
    c_type = {ctypes.c_void_p: "*", ctypes.c_int: "int ", ctypes.c_longlong: "long long ",
              ctypes.c_float: "float "}
    for param, argtype in zip(params, argtypes):
        if argtype is ctypes.c_void_p:
            assert "*" in param, param
        else:
            assert param.startswith(c_type[argtype]) and "*" not in param, (param, argtype)
    assert "pallas_factored.py::_kernel" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src


def test_missing_nvcc_raises_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(tg.FftBackendError, match="nvcc not found"):
        _build.find_nvcc()
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(tg.FftBackendError, match="nvcc not found"):
        _build.load_library("fused_features", tff._SIGNATURES)


def test_kernel_forward_twin_grad_differentiates_the_twin():
    f = kernel_forward_twin_grad(lambda x: 3.0 * x, lambda x: 2.0 * x * x)
    x = torch.tensor([1.0, -2.0], requires_grad=True)
    y = f(x)
    torch.testing.assert_close(y.detach(), torch.tensor([3.0, -6.0]))
    y.sum().backward()
    torch.testing.assert_close(x.grad, torch.tensor([4.0, -8.0]))   # d(2x²)/dx


def test_port_kernel_gradient_matches_jax_kernel_gradient():
    """Both packages' kernel routes differentiate their plain twins."""
    x = noise(16000, seed=25, dtype=np.float32)
    w = np.random.default_rng(26).standard_normal((128, 63)).astype(np.float32)
    jp = spec_plan(sg, "mel", "db")
    g_ref = np.asarray(jax.grad(lambda v: jnp.sum(jp.compute_raw(v) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (spec_plan(tg, "mel", "db").compute_raw(xt) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, atol=1e-4 * np.abs(g_ref).max())
