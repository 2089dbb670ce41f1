"""The PyTorch port's host-level modules against the JAX package.

Windows, filterbanks, the DCT-lifter basis, framing, the DFT matrices,
params validation and dtypes: the same inputs through both packages, f64
arrays equal to 1e-12. Also: the port imports neither JAX nor the JAX
package, and its entry points refuse to run without CUDA unless asked for
the CPU.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.mfcc import _dct_lifter_matrix as jax_dct_lifter
from spectrograms_tpu.mfcc import dct_ii_matrix as jax_dct_ii
from spectrograms_tpu.ops import dft as jdft
from spectrograms_tpu.ops import filterbanks as jfb
from spectrograms_tpu.ops import framing as jfr
from spectrograms_tpu_torch import dtypes as tdt
from spectrograms_tpu_torch.mfcc import _dct_lifter_matrix as port_dct_lifter
from spectrograms_tpu_torch.mfcc import dct_ii_matrix as port_dct_ii
from spectrograms_tpu_torch.ops import dft as tdft
from spectrograms_tpu_torch.ops import filterbanks as tfb
from spectrograms_tpu_torch.ops import framing as tfr
from tests.conftest import noise

REPO = Path(__file__).resolve().parents[1]
EXACT = dict(rtol=0.0, atol=1e-12)


@pytest.mark.parametrize("spec", ["rect", "hann", "hamming", "blackman",
                                  "kaiser=8.0", "gaussian=100.0"])
@pytest.mark.parametrize("n", [1, 512, 1024])
def test_windows_match(spec, n):
    np.testing.assert_allclose(tg.make_window(spec, n), sg.make_window(spec, n), **EXACT)


@pytest.mark.parametrize("normalize", [None, "sum", "peak", "energy"])
def test_custom_window_normalization_matches(normalize):
    coeffs = np.random.default_rng(3).uniform(0.1, 1.0, 64)
    t = tg.make_window(tg.WindowType.custom(coeffs, normalize), 64)
    j = sg.make_window(sg.WindowType.custom(coeffs, normalize), 64)
    np.testing.assert_allclose(t, j, **EXACT)


@pytest.mark.parametrize("sr,n_fft,n_mels,f_min,f_max,norm", [
    (16000.0, 1024, 128, 0.0, 8000.0, "slaney"),
    (16000.0, 512, 40, 0.0, 8000.0, "slaney"),
    (22050.0, 2048, 96, 50.0, 11025.0, "none"),
    (44100.0, 4096, 64, 20.0, 16000.0, "l1"),
    (16000.0, 256, 24, 100.0, 7000.0, "l2"),
])
def test_mel_filterbank_matches(sr, n_fft, n_mels, f_min, f_max, norm):
    t = tfb.mel_filterbank(sr, n_fft, tg.MelParams(n_mels, f_min, f_max, norm))
    j = jfb.mel_filterbank(sr, n_fft, sg.MelParams(n_mels, f_min, f_max, norm))
    np.testing.assert_allclose(t, j, **EXACT)
    np.testing.assert_allclose(
        tfb.mel_band_centres_hz(n_mels, sr, sr / 2), jfb.mel_band_centres_hz(n_mels, sr, sr / 2),
        **EXACT,
    )


@pytest.mark.parametrize("n_bins,f_min,f_max", [(48, 50.0, 8000.0), (128, 20.0, 8000.0),
                                                (1, 100.0, 200.0)])
def test_loghz_matrix_matches(n_bins, f_min, f_max):
    tm, tf = tfb.loghz_matrix(16000.0, 1024, tg.LogHzParams(n_bins, f_min, f_max))
    jm, jf = jfb.loghz_matrix(16000.0, 1024, sg.LogHzParams(n_bins, f_min, f_max))
    np.testing.assert_allclose(tm, jm, **EXACT)
    np.testing.assert_allclose(tf, jf, **EXACT)


@pytest.mark.parametrize("spacing", ["LINEAR", "APPLE_TR35"])
def test_erb_filterbank_matches(spacing):
    tm, tc = tfb.erb_filterbank(
        16000.0, 1024, tg.ErbParams(32, 50.0, 8000.0, getattr(tg.ErbSpacing, spacing)))
    jm, jc = jfb.erb_filterbank(
        16000.0, 1024, sg.ErbParams(32, 50.0, 8000.0, getattr(sg.ErbSpacing, spacing)))
    np.testing.assert_allclose(tm, jm, **EXACT)
    np.testing.assert_allclose(tc, jc, **EXACT)


def test_chroma_filterbank_matches():
    np.testing.assert_allclose(
        tfb.chroma_filterbank(22050.0, 4096, tg.ChromaParams()),
        jfb.chroma_filterbank(22050.0, 4096, sg.ChromaParams()),
        **EXACT,
    )


@pytest.mark.parametrize("n_mels,n_mfcc,lifter", [(128, 40, 22), (40, 13, 0), (26, 26, 22)])
def test_dct_lifter_matrix_matches(n_mels, n_mfcc, lifter):
    np.testing.assert_allclose(
        port_dct_lifter(n_mels, n_mfcc, lifter), jax_dct_lifter(n_mels, n_mfcc, lifter), **EXACT
    )
    np.testing.assert_allclose(
        port_dct_ii(n_mels, n_mfcc), jax_dct_ii(n_mels, n_mfcc), **EXACT)


def test_frame_count_flagship():
    assert tfr.frame_count(16000, 1024, 256, True) == 63
    assert tfr.frame_count(16000, 1024, 256, False) == 59
    assert tfr.frame_count(160000, 1024, 256, True) == 626
    with pytest.raises(tg.InvalidInputError):
        tfr.frame_count(0, 1024, 256, True)


# (n, n_fft, hop, centre): hop | n_fft, irregular hops, disjoint frames, and
# signals shorter than n_fft (the "1 frame" rule and the extra right pad).
FRAMINGS = [
    (16000, 1024, 256, True),
    (16000, 1024, 256, False),
    (16000, 512, 160, True),
    (16000, 512, 160, False),
    (5000, 256, 256, True),
    (700, 1024, 256, True),
    (700, 1024, 256, False),
    (1023, 1024, 1000, False),
]


@pytest.mark.parametrize("n,n_fft,hop,centre", FRAMINGS)
def test_framing_matches(n, n_fft, hop, centre):
    assert tfr.pad_amounts(n, n_fft, hop, centre) == jfr.pad_amounts(n, n_fft, hop, centre)
    assert tfr.frame_start_sample(5, n_fft, hop, centre) == jfr.frame_start_sample(
        5, n_fft, hop, centre)
    x = noise(n, seed=n)
    t = tfr.frame_signal(torch.from_numpy(x), n_fft, hop, centre).numpy()
    j = np.asarray(jfr.frame_signal(jnp.asarray(x), n_fft, hop, centre))
    np.testing.assert_array_equal(t, j)
    xb = np.stack([x, 2.0 * x])
    tb = tfr.frame_signal(torch.from_numpy(xb), n_fft, hop, centre).numpy()
    np.testing.assert_array_equal(tb[1], 2.0 * j)


@pytest.mark.parametrize("n,n_fft,hop,centre", FRAMINGS)
def test_framed_matmul_matches(n, n_fft, hop, centre):
    rng = np.random.default_rng(n_fft + hop)
    x = noise(n, seed=7)
    mat = rng.standard_normal((n_fft, 6))
    t = tfr.framed_matmul(torch.from_numpy(x), torch.from_numpy(mat), n_fft, hop, centre)
    j = jfr.framed_matmul(jnp.asarray(x), jnp.asarray(mat), n_fft, hop, centre)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("n_fft", [256, 1024])
def test_rdft_matrices_match(n_fft):
    w = sg.make_window("hann", n_fft)
    tc, ts = tdft.rdft_matrices(n_fft, w, torch.float64)
    jc, js = jdft.rdft_matrices(n_fft, w, np.float64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **EXACT)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **EXACT)


BAD_PARAMS = {
    "n_fft zero": lambda m: m.StftParams(0, 256),
    "hop above n_fft": lambda m: m.StftParams(1024, 2048),
    "unknown window": lambda m: m.StftParams(1024, 256, window="nope"),
    "custom window size": lambda m: m.StftParams(8, 4, window=m.WindowType.custom([1.0] * 4)),
    "negative rate": lambda m: m.SpectrogramParams(m.StftParams(1024, 256), -1.0),
    "no mels": lambda m: m.MelParams(0, 0.0, 8000.0),
    "mel f_max below f_min": lambda m: m.MelParams(40, 100.0, 50.0),
    "unknown mel norm": lambda m: m.MelParams(40, 0.0, 8000.0, "bogus"),
    "log-hz f_min zero": lambda m: m.LogHzParams(10, 0.0, 100.0),
    "one erb filter": lambda m: m.ErbParams(1, 50.0, 8000.0),
    "no mfcc": lambda m: m.MfccParams(0),
    "negative lifter": lambda m: m.MfccParams(13, lifter=-1),
    "infinite floor": lambda m: m.LogParams(float("inf")),
    "empty custom window": lambda m: m.WindowType.custom([]),
    "window string": lambda m: m.parse_window("kaiser"),
    "mel above nyquist": lambda m: m.ops.filterbanks.mel_filterbank(
        16000.0, 1024, m.MelParams(40, 0.0, 9000.0)),
}


@pytest.mark.parametrize("case", sorted(BAD_PARAMS))
def test_bad_params_raise_the_same_error(case):
    import spectrograms_tpu.ops.filterbanks  # noqa: F401  (m.ops.filterbanks)
    import spectrograms_tpu_torch.ops.filterbanks  # noqa: F401

    with pytest.raises(sg.SpectrogramError) as ej:
        BAD_PARAMS[case](sg)
    with pytest.raises(tg.SpectrogramError) as et:
        BAD_PARAMS[case](tg)
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


def test_parse_dtype():
    assert tdt.parse_dtype(None) is torch.float32
    assert tdt.parse_dtype("f64") is torch.float64
    assert tdt.parse_dtype(np.float32) is torch.float32
    assert tdt.parse_dtype(torch.float64) is torch.float64
    assert tdt.parse_dtype("bf16") is torch.bfloat16
    for bad in ("int32", np.int32, torch.int64, "float16x"):
        with pytest.raises(tg.InvalidInputError):
            tdt.parse_dtype(bad)
    tdt.ensure_plan_dtype(torch.float64)
    with pytest.raises(tg.InvalidInputError):
        tdt.ensure_plan_dtype(torch.bfloat16)
    assert tdt.real_dtype_name(torch.complex64) == "float32"
    assert tdt.numpy_dtype(torch.float64) == np.float64


def test_precision_enum_keeps_the_jax_names():
    assert [p.name for p in tg.Precision] == ["DEFAULT", "HIGH", "HIGHEST"]


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tg.SpectrogramParams(tg.StftParams(1024, 256), 16000.0)
    with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
        tg.SpectrogramPlan(params, tg.FreqScale.LINEAR, tg.AmpScale.POWER)
    with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
        tg.MfccPlan(tg.StftParams(1024, 256), 16000.0)
    with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
        tg.SpectrogramPlan(params, tg.FreqScale.LINEAR, tg.AmpScale.POWER, device="cuda")
    plan = tg.SpectrogramPlan(params, tg.FreqScale.LINEAR, tg.AmpScale.POWER, device="cpu")
    assert plan.device == torch.device("cpu")


def test_tf32_is_refused():
    tdt.check_true_f32()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(tg.InvalidInputError, match="TF32"):
            tdt.check_true_f32()
    finally:
        torch.set_float32_matmul_precision("highest")
    tdt.check_true_f32()


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "spectrograms_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert "import_module" not in text and "__import__" not in text, path
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes", "spectrograms_tpu"), (path, mod)


def test_port_import_loads_no_jax():
    code = (
        "import sys, chip_smoke, spectrograms_tpu_torch, spectrograms_tpu_torch.convert, "
        "spectrograms_tpu_torch.ops._build, spectrograms_tpu_torch.profiling, "
        "spectrograms_tpu_torch.torch, spectrograms_tpu_torch.jax, "
        "spectrograms_tpu_torch.runtime.build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'spectrograms_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


# The port's counterpart of each JAX module of another name: the Pallas
# kernel's module became the CUDA kernels' wrappers.
RENAMED_MODULES = {"ops.pallas_factored": "ops.fused_factored"}


def test_port_has_every_submodule_of_the_jax_package():
    def walk(pkg):
        prefix = pkg.__name__ + "."
        return {m.name[len(prefix):] for m in pkgutil.walk_packages(pkg.__path__, prefix)}

    theirs = {RENAMED_MODULES.get(m, m) for m in walk(sg)}
    missing = theirs - walk(tg)
    assert not missing, sorted(missing)
