"""``tests/test_equivalence_sweep.py`` held on the port, on the CPU.

The same seeded random configurations (n_fft, hop, window, centre, scale,
amplitude, bands, f_min/f_max) through every lowering of the port
(``matmul``, ``factored``, ``pallas`` — the f32 kernel's plain version on
the CPU) against the port's exact ``fft`` path, at the JAX test's
tolerances, and the port's ``fft`` path against JAX's. The bf16 tiers
(``precision=DEFAULT`` and ``pallas:x2``, their plain versions here)
against the JAX plans of the same tier, which run the JAX kernel in
interpret mode: where a tier's own rounding reads above ``chip_smoke.py``'s
``TIER_LIMITS`` against ``fft``, the JAX tier reads the same.
"""

import jax
import numpy as np
import pytest

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch.ops.fft_factored import supports_factored
from spectrograms_tpu_torch.ops.fused_factored import supports_factored_fusion

SR_CHOICES = (8000.0, 16000.0, 22050.0, 44100.0)
N_FFT_CHOICES = (256, 400, 512, 1000, 1024, 2048)
WINDOWS = ("hann", "hamming", "blackman", "kaiser=6.5", "gaussian=0.4", "rect")


def _random_config(rng):
    """``test_equivalence_sweep.py::_random_config``, draw for draw."""
    sr = float(rng.choice(SR_CHOICES))
    n_fft = int(rng.choice(N_FFT_CHOICES))
    hop = int(rng.integers(max(32, n_fft // 8), n_fft + 1))
    window = str(rng.choice(WINDOWS))
    centre = bool(rng.integers(0, 2))
    scale = str(rng.choice(["linear", "mel", "loghz", "erb"]))
    amp = str(rng.choice(["power", "magnitude", "db"]))
    n_bands = int(rng.integers(8, 96))
    f_min = float(rng.uniform(0.0 if scale == "mel" else 30.0, 300.0))
    f_max = float(rng.uniform(sr / 4, sr / 2))
    return sr, n_fft, hop, window, centre, scale, amp, n_bands, f_min, f_max


def _build(m, cfg, method, **kw):
    """``test_equivalence_sweep.py::_build`` in package ``m``."""
    sr, n_fft, hop, window, centre, scale, amp, n_bands, f_min, f_max = cfg
    params = m.SpectrogramParams(m.StftParams(n_fft, hop, window, centre), sr)
    db = m.LogParams(-80.0) if amp == "db" else None
    kw = dict(dtype="float32", method=method, **kw, **({"device": "cpu"} if m is tg else {}))
    if scale == "linear":
        cls = {"power": m.LinearPowerPlan, "magnitude": m.LinearMagnitudePlan,
               "db": m.LinearDbPlan}[amp]
        return cls(params, db=db, **kw) if amp == "db" else cls(params, **kw)
    if scale == "mel":
        sp = m.MelParams(n_bands, f_min, f_max, m.MelNorm.SLANEY)
        cls = {"power": m.MelPowerPlan, "magnitude": m.MelMagnitudePlan, "db": m.MelDbPlan}[amp]
    elif scale == "loghz":
        sp = m.LogHzParams(n_bands, max(f_min, 20.0), f_max)
        cls = {"power": m.LogHzPowerPlan, "magnitude": m.LogHzMagnitudePlan,
               "db": m.LogHzDbPlan}[amp]
    else:
        sp = m.ErbParams(max(n_bands, 2), max(f_min, 20.0), f_max)
        cls = {"power": m.ErbPowerPlan, "magnitude": m.ErbMagnitudePlan, "db": m.ErbDbPlan}[amp]
    return cls(params, sp, db=db, **kw) if amp == "db" else cls(params, sp, **kw)


def _draw(seed):
    rng = np.random.default_rng(1000 + seed)
    cfg = _random_config(rng)
    return cfg, rng.standard_normal(int(cfg[0] * 0.6)).astype(np.float32)


def _err(out, ref, amp):
    """The JAX test's reading: dB in dB, else relative to max|ref|."""
    if amp == "db":
        return float(np.abs(out - ref).max()), 3e-2
    return float(np.abs(out - ref).max()) / (float(np.abs(ref).max()) + 1e-12), 5e-3


@pytest.mark.parametrize("seed", range(12))
def test_methods_agree_on_random_config(seed):
    """``test_equivalence_sweep.py::test_methods_agree_on_random_config``:
    every lowering of the port against its ``fft`` path at 3e-2 dB /
    5e-3·max|ref| (the JAX test's), and the port's ``fft`` path against
    JAX's at the same limits."""
    cfg, x = _draw(seed)
    sr, n_fft, hop, window, centre, scale, amp, n_bands, f_min, f_max = cfg
    ref = _build(tg, cfg, "fft").compute_raw(x).numpy()
    err, tol = _err(ref, np.asarray(_build(sg, cfg, "fft").compute_raw(x)), amp)
    assert err < tol, (cfg, "fft vs JAX", err)

    methods = ["matmul"]
    if supports_factored(n_fft):
        methods.append("factored")
    if scale != "linear" and supports_factored_fusion(n_fft, hop, np.float32):
        methods.append("pallas")
    for method in methods:
        out = _build(tg, cfg, method).compute_raw(x).numpy()
        assert out.shape == ref.shape, (cfg, method)
        err, tol = _err(out, ref, amp)
        assert err < tol, (cfg, method, err)


TIER_SEEDS = [s for s in range(12)
              if _draw(s)[0][5] != "linear" and supports_factored_fusion(_draw(s)[0][1],
                                                                         _draw(s)[0][2],
                                                                         np.float32)]


@pytest.mark.parametrize("route", ["DEFAULT", "x2"])
@pytest.mark.parametrize("seed", TIER_SEEDS)
def test_tiers_match_jax_on_random_config(seed, route):
    """The sweep's kernel configurations at the bf16 tiers: the port's plan
    (the tier kernel's plain version on the CPU) against the JAX plan of the
    same tier (the JAX kernel in interpret mode), at
    ``tests/test_torch_port_tiers.py``'s plan tolerances (2e-2 dB, 2e-3
    relative); and each package's distance from ``fft``, in the power domain
    for dB and magnitude, the same within a tenth."""
    cfg, x = _draw(seed)
    amp = cfg[6]
    kw = ((dict(precision=tg.Precision.DEFAULT), dict(precision=jax.lax.Precision.DEFAULT))
          if route == "DEFAULT" else ({}, {}))
    method = "pallas" if route == "DEFAULT" else "pallas:x2"
    out = _build(tg, cfg, method, **kw[0]).compute_raw(x).numpy()
    ref = np.asarray(_build(sg, cfg, method, **kw[1]).compute_raw(x))
    if amp == "db":
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3 * np.abs(ref).max())
    exact = _build(tg, cfg, "fft").compute_raw(x).numpy()
    power = {"db": lambda v: 10.0 ** (v / 10.0), "magnitude": np.square,
             "power": lambda v: v}[amp]
    dist = lambda v: float(np.abs(power(v) - power(exact)).max() / np.abs(power(exact)).max())
    assert abs(dist(out) - dist(ref)) <= 0.1 * dist(ref) + 1e-7, (cfg, dist(out), dist(ref))
