"""The port's typed plans, planner, one-shots and plan cache against the JAX package's.

Same numpy inputs (seeded) through both packages, on the CPU:

- the 15 typed plans (``plans.py``) and the planner's 15 named builders:
  the JAX output at rtol 1e-9 in f64 and 1e-3 dB / 1e-4·max in f32 (the
  bar of ``tests/test_torch_port_pipeline.py``), the three CQT classes
  included (``tests/test_torch_port_cqt.py`` holds their other forms);
- the 15 ``compute_*_spectrogram`` one-shots at the same tolerances, and at
  ``precision=DEFAULT`` on the kernel route against the JAX plan's tier;
- ``tests/test_dtype_matrix.py``'s matrix (output dtypes, f32 ≈ f64,
  aliases, invalid dtypes) and ``tests/test_plans.py``'s surface checks;
- the plan cache: hits, misses and clears, the device and the precision in
  its key; ``cache.py``'s counters.
"""

import jax
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch import functions as tfn
from tests.conftest import noise, sine

SR = 16000.0
CPU = dict(device="cpu")


def cfg(m):
    """(params, mel, erb, loghz, cqt, db) of one package (``tests/test_plans.py``'s)."""
    return (m.SpectrogramParams(m.StftParams(512, 128), SR),
            m.MelParams(64, 0.0, 8000.0, m.MelNorm.SLANEY), m.ErbParams(32, 50.0, 8000.0),
            m.LogHzParams(48, 32.7, 8000.0), m.CqtParams(12, 5, 55.0), m.LogParams(-80.0))


SCALES = {"Linear": None, "Mel": 1, "Erb": 2, "LogHz": 3, "Cqt": 4}
AMPS = ("Power", "Magnitude", "Db")
ALL_15 = [(s, a) for s in SCALES for a in AMPS]
ONE_SHOT_SCALE = {"Linear": "linear", "Mel": "mel", "Erb": "erb", "LogHz": "loghz", "Cqt": "cqt"}
ONE_SHOT_AMP = {"Power": "power", "Magnitude": "magnitude", "Db": "db"}


def typed_args(m, scale, amp):
    c = cfg(m)
    args = (c[0],) if SCALES[scale] is None else (c[0], c[SCALES[scale]])
    return args, ({"db": c[5]} if amp == "Db" else {})


def assert_matches(out, ref, dtype, amp):
    if dtype == "float64":
        np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-12 * float(np.abs(ref).max()))
    elif amp == "Db":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()))


# ---- the 15 typed plans --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scale,amp", ALL_15, ids=[s + a for s, a in ALL_15])
def test_typed_plan_matches_jax(scale, amp, dtype):
    name = f"{scale}{amp}Plan"
    cls = getattr(tg, name)
    args, kw = typed_args(tg, scale, amp)
    x = noise(16000, seed=len(name), dtype=np.dtype(dtype))
    jargs, jkw = typed_args(sg, scale, amp)
    ref = np.asarray(getattr(sg, name)(*jargs, dtype=dtype, **jkw).compute_raw(x))
    plan = cls(*args, dtype=dtype, **kw, **CPU)
    assert isinstance(plan, tg.SpectrogramPlan) and type(plan).__name__ == name
    assert plan.dtype == dtype
    spec = plan.compute(x)
    assert spec.shape == plan.output_shape(len(x)) == ref.shape
    assert (spec.freq_scale, spec.amp_scale) == (plan.freq_scale, plan.amp_scale)
    assert_matches(spec.to_numpy(), ref, dtype, amp)


@pytest.mark.parametrize("scale,amp", ALL_15, ids=[s + a for s, a in ALL_15])
def test_planner_builder_returns_typed(scale, amp):
    """Each of the 15 named builders returns its typed class with the
    planner's defaults, and computes what the class computes."""
    name = f"{ONE_SHOT_SCALE[scale]}_{ONE_SHOT_AMP[amp]}_plan"
    planner = tg.SpectrogramPlanner(dtype="float64", method="fft", device="cpu")
    args, kw = typed_args(tg, scale, amp)
    builder = getattr(planner, name)
    assert builder.__name__ == name
    plan = builder(*args, **kw)
    assert type(plan) is getattr(tg, f"{scale}{amp}Plan")
    assert (plan.dtype, plan.method, plan.device) == ("float64", "fft", torch.device("cpu"))
    x = noise(8000, seed=3)
    direct = getattr(tg, f"{scale}{amp}Plan")(*args, dtype="float64", method="fft", **kw, **CPU)
    np.testing.assert_array_equal(plan.compute_raw(x).numpy(), direct.compute_raw(x).numpy())
    assert builder(*args, **kw, dtype="float32", method="matmul").method == "matmul"
    assert type(getattr(sg.SpectrogramPlanner(), name)(*typed_args(sg, scale, amp)[0],
                                                      **typed_args(sg, scale, amp)[1])
                ).__name__ == type(plan).__name__


def test_generic_builders_match_jax():
    jc, tc = cfg(sg), cfg(tg)
    x = noise(8000, seed=11)
    jp, tp = sg.SpectrogramPlanner(dtype="float64"), tg.SpectrogramPlanner(dtype="float64", **CPU)
    for name, i, amp in (("linear_plan", None, "POWER"), ("mel_plan", 1, "DECIBELS"),
                         ("erb_plan", 2, "MAGNITUDE"), ("log_hz_plan", 3, "POWER"),
                         ("cqt_plan", 4, "DECIBELS")):
        jargs = (jc[0],) if i is None else (jc[0], jc[i])
        targs = (tc[0],) if i is None else (tc[0], tc[i])
        jdb, tdb = (jc[5], tc[5]) if amp == "DECIBELS" else (None, None)
        ref = getattr(jp, name)(*jargs, amp=getattr(sg.AmpScale, amp), db=jdb).compute_raw(x)
        out = getattr(tp, name)(*targs, amp=getattr(tg.AmpScale, amp), db=tdb).compute_raw(x)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)


def test_typed_plan_matches_generic():
    params, mel, _, _, _, db = cfg(tg)
    x = sine(440.0, dtype=np.float32)
    typed = tg.MelDbPlan(params, mel, db, dtype="float32", **CPU).compute_raw(x)
    generic = tg.SpectrogramPlan(params, tg.FreqScale.MEL, tg.AmpScale.DECIBELS,
                                 scale_params=mel, log_params=db, dtype="float32",
                                 **CPU).compute_raw(x)
    assert torch.equal(typed, generic)


def test_power_plan_rejects_db():
    params, mel, _, _, _, db = cfg(tg)
    for m, kw in ((sg, {}), (tg, CPU)):
        c = cfg(m)
        with pytest.raises(m.InvalidInputError, match="does not take dB params"):
            m.MelPowerPlan(c[0], c[1], db=c[5], dtype="float32", **kw)
        with pytest.raises(m.InvalidInputError, match="does not take dB params"):
            m.LinearMagnitudePlan(c[0], db=c[5], dtype="float32", **kw)


def test_typed_plans_keep_the_kernel_route():
    """``method="pallas"`` and ``precision`` pass through a typed plan: its
    DEFAULT tier equals the JAX plan's (interpret-mode kernel) at
    ``test_torch_port_tiers.py``'s dB limit; the port's HIGH f32 kernel
    (here its plain version) equals JAX's matmul route to 1e-3 dB."""
    x = noise(16000, seed=3, dtype=np.float32)

    def mk(m, **kw):
        extra = CPU if m is tg else {}
        return m.MelDbPlan(m.SpectrogramParams(m.StftParams(1024, 256), SR),
                           m.MelParams(128, 0.0, 8000.0, m.MelNorm.SLANEY), m.LogParams(-80.0),
                           dtype="float32", **kw, **extra)

    dflt = mk(tg, method="pallas", precision=tg.Precision.DEFAULT)
    assert dflt.method == "pallas" and dflt._kernel_kwargs == {"precision": "bf16"}
    ref = np.asarray(mk(sg, method="pallas", precision=jax.lax.Precision.DEFAULT).compute_raw(x))
    np.testing.assert_allclose(dflt.compute_raw(x).numpy(), ref, rtol=0, atol=2e-2)
    high = mk(tg, method="pallas")
    assert high._kernel_kwargs == {"precision": "bf16x3"}
    np.testing.assert_allclose(high.compute_raw(x).numpy(),
                               np.asarray(mk(sg, method="matmul").compute_raw(x)), rtol=0, atol=1e-3)


# ---- the 15 one-shots -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scale,amp", ALL_15, ids=[s + a for s, a in ALL_15])
def test_one_shot_matches_jax(scale, amp, dtype):
    name = f"compute_{ONE_SHOT_SCALE[scale]}_{ONE_SHOT_AMP[amp]}_spectrogram"
    args, kw = typed_args(tg, scale, amp)
    x = noise(8000, seed=len(name), dtype=np.dtype(dtype))
    fn = getattr(tg, name)
    assert fn.__name__ == name and name in tg.__all__
    jargs, jkw = typed_args(sg, scale, amp)
    ref = getattr(sg, name)(x, *jargs, dtype=dtype, **jkw)
    spec = fn(x, *args, dtype=dtype, **kw, **CPU)
    assert isinstance(spec, tg.Spectrogram)
    np.testing.assert_allclose(spec.frequencies, ref.frequencies, rtol=1e-12)
    np.testing.assert_allclose(spec.times, ref.times, rtol=1e-12)
    assert_matches(spec.to_numpy(), np.asarray(ref.data), dtype, amp)
    if amp == "Db":  # db=None means LogParams() (-80 dB), as in JAX
        np.testing.assert_array_equal(fn(x, *args, dtype=dtype, **CPU).to_numpy(), spec.to_numpy())


# ---- tests/test_dtype_matrix.py's matrix -----------------------------------------

MATRIX = [(f"compute_{s}_{a}_spectrogram", s) for s in ("linear", "mel", "erb")
          for a in ("power", "magnitude", "db")]


def matrix_args(scale):
    c = cfg(tg)
    return {"linear": (c[0],), "mel": (c[0], c[1]), "erb": (c[0], c[2])}[scale]


@pytest.mark.parametrize("name,scale", MATRIX, ids=[n for n, _ in MATRIX])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_one_shot_dtype(name, scale, dtype):
    spec = getattr(tg, name)(sine(440.0), *matrix_args(scale), dtype=dtype, **CPU)
    assert str(spec.data.dtype) == f"torch.{dtype}" and spec.to_numpy().dtype == np.dtype(dtype)


@pytest.mark.parametrize("name,scale", MATRIX, ids=[n for n, _ in MATRIX])
def test_f32_close_to_f64(name, scale):
    x = noise(8000, seed=7)
    fn = getattr(tg, name)
    a = fn(x, *matrix_args(scale), dtype="float32", **CPU).to_numpy().astype(np.float64)
    b = fn(x, *matrix_args(scale), dtype="float64", **CPU).to_numpy()
    if name.endswith("db_spectrogram"):
        np.testing.assert_allclose(a, b, atol=1e-1)
    else:
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4 * np.max(b))


@pytest.mark.parametrize("alias", ["f32", "f64", "float32", "float64"])
def test_dtype_aliases(alias):
    spec = tg.compute_linear_power_spectrogram(sine(440.0), cfg(tg)[0], dtype=alias, **CPU)
    assert spec.data.dtype == (torch.float32 if "32" in alias else torch.float64)


def test_invalid_dtype_raises():
    with pytest.raises(tg.InvalidInputError):
        tg.compute_linear_power_spectrogram(sine(440.0), cfg(tg)[0], dtype="int8", **CPU)
    with pytest.raises(tg.InvalidInputError):
        tg.parse_dtype("bogus")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plans_respect_dtype(dtype):
    params, mel, _, _, _, db = cfg(tg)
    plan = tg.MelDbPlan(params, mel, db, dtype=dtype, **CPU)
    x = sine(440.0).astype(dtype)
    assert plan.dtype == dtype
    assert plan.compute_raw(x).dtype == getattr(torch, dtype)
    assert plan.compute_frame(x, 3).dtype == getattr(torch, dtype)


def test_surface_names():
    assert tg.FFTBackendError is tg.FftBackendError
    assert "__version__" in tg.__all__ and tg.__version__ == sg.__version__


# ---- FftPlanner ---------------------------------------------------------------------

def test_fft_planner_matches_jax():
    jp, tp = sg.FftPlanner(dtype="float32"), tg.FftPlanner(dtype="float32", **CPU)
    x = np.sin(2 * np.pi * 440 * np.arange(400) / 16000).astype(np.float32)
    spec = tp.fft(x, 512)
    assert spec.shape == (257,) and spec.dtype == torch.complex64
    peak = float(np.abs(np.asarray(jp.fft(x, 512))).max())
    np.testing.assert_allclose(spec.numpy(), np.asarray(jp.fft(x, 512)), atol=1e-4 * peak)
    np.testing.assert_allclose(tp.rfft(x, 512).numpy(), spec.abs().numpy(), rtol=1e-6)
    np.testing.assert_allclose(tp.irfft(spec, 512).numpy()[:400], x, atol=1e-5)
    for name in ("power_spectrum", "magnitude_spectrum"):
        ref = np.asarray(getattr(jp, name)(x, 512, window="hann"))
        np.testing.assert_allclose(getattr(tp, name)(x, 512, window="hann").numpy(), ref,
                                   rtol=0, atol=1e-4 * float(ref.max()))
    with pytest.raises(tg.InvalidInputError):
        tp.fft(np.zeros(600, np.float32), 512)


# ---- the plan cache -----------------------------------------------------------------

def _plan_counters():
    return tg.fft_plan_cache_info()["functions.cached_plan"]


def test_one_shot_plan_cache_hits_misses_and_clears():
    tg.clear_fft_plan_cache()
    params, mel = cfg(tg)[:2]
    x = noise(4000, seed=1, dtype=np.float32)
    first = tg.compute_mel_db_spectrogram(x, params, mel, **CPU)
    assert _plan_counters()["misses"] == 1 and _plan_counters()["hits"] == 0
    again = tg.compute_mel_db_spectrogram(x, params, mel, **CPU)
    assert _plan_counters()["hits"] == 1 and _plan_counters()["currsize"] == 1
    assert torch.equal(first.data, again.data)
    # None and the plan's own default precision (HIGH at f32) share one plan
    tg.compute_mel_db_spectrogram(x, params, mel, precision=tg.Precision.HIGH, **CPU)
    assert _plan_counters()["hits"] == 2
    tg.compute_mel_db_spectrogram(x, params, mel, dtype="float64", **CPU)
    assert _plan_counters()["misses"] == 2
    assert tfn.fft_plan_cache_info() == {"hits": 2, "misses": 2, "size": 2, "max_size": 100}
    tg.clear_fft_plan_cache()
    assert _plan_counters()["currsize"] == 0 and _plan_counters()["hits"] == 0


def test_plan_cache_key_holds_device_and_precision():
    """A plan built for one device or precision tier is never served to a
    call that asks for another: each is its own entry, and the DEFAULT
    call computes the DEFAULT tier."""
    tg.clear_fft_plan_cache()
    params, mel, _, _, _, db = cfg(tg)
    p_cpu = tfn.get_plan(params, tg.FreqScale.MEL, tg.AmpScale.DECIBELS, mel, db, "float32",
                         "pallas", device="cpu")
    assert tfn.get_plan(params, tg.FreqScale.MEL, tg.AmpScale.DECIBELS, mel, db, "float32",
                        "pallas", device=torch.device("cpu")) is p_cpu
    p_cpu0 = tfn.get_plan(params, tg.FreqScale.MEL, tg.AmpScale.DECIBELS, mel, db, "float32",
                          "pallas", device=torch.device("cpu", 0))
    assert p_cpu0 is not p_cpu and p_cpu0.device == torch.device("cpu", 0)
    p_dflt = tfn.get_plan(params, tg.FreqScale.MEL, tg.AmpScale.DECIBELS, mel, db, "float32",
                          "pallas", precision=tg.Precision.DEFAULT, device="cpu")
    assert p_dflt is not p_cpu and p_dflt.precision == tg.Precision.DEFAULT
    assert (p_cpu._kernel_kwargs, p_dflt._kernel_kwargs) == (
        {"precision": "bf16x3"}, {"precision": "bf16"})
    assert _plan_counters()["misses"] == 3 and _plan_counters()["hits"] == 1
    x = noise(8000, seed=2, dtype=np.float32)
    out = tg.compute_mel_db_spectrogram(x, params, mel, method="pallas",
                                        precision=tg.Precision.DEFAULT, **CPU)
    assert torch.equal(out.data, p_dflt.compute_raw(x))
    assert not torch.equal(out.data, p_cpu.compute_raw(x))
    tg.clear_fft_plan_cache()


def test_cache_stats_report_host_caches():
    tg.mel_filterbank(16000, 512, tg.MelParams(32, 0.0, 8000.0))
    tg.compute_linear_power_spectrogram(sine(440.0), cfg(tg)[0], **CPU)
    st = tg.cache_stats()
    assert st == tg.fft_plan_cache_info()
    for prefix in ("functions.", "filterbanks.", "dft_matrices.", "ola_norm.", "mfcc_dct.",
                   "decimate."):
        assert any(k.startswith(prefix) for k in st), prefix
    for entry in st.values():
        assert set(entry) == {"hits", "misses", "currsize", "maxsize"}
    # only the builders each module defines: the MFCC module's kernel
    # factory import is not reported as a DCT cache
    assert not any("fused" in k for k in st)
    assert "device.cuda_memory_allocated" not in st  # no card here


def test_clear_fft_plan_cache_resets_counters(monkeypatch):
    tg.mel_filterbank(16000, 1024, tg.MelParams(64, 0.0, 8000.0))
    assert any(v["currsize"] > 0 for v in tg.cache_stats().values())
    tg.clear_fft_plan_cache()
    host = {k: v for k, v in tg.cache_stats().items() if not k.startswith("device.")}
    assert all(v["currsize"] == 0 for v in host.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda: 4096)
    assert tg.cache_stats()["device.cuda_memory_allocated"]["currsize"] == 4096
