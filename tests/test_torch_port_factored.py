"""The port's factored rFFT (``method="factored"``) against the JAX
package's, on the CPU.

Same numpy inputs (seeded) through both packages:

- ``supports_factored`` and the host constants (``_constants_np``) equal to
  JAX's, bit for bit (both numpy);
- ``FactoredRfft`` against numpy's rfft (``tests/test_fft_factored.py``'s
  1e-10 of the peak at f64, 1e-5 at f32) and against JAX's, from the JAX
  object's constants carried over (``convert.factored_constants_from_numpy``);
- the ``factored`` plans against the ``fft`` method (2e-3 dB at f32, 1e-10
  at f64, the JAX test's bars) and against the JAX ``factored`` plans (the
  bar of ``tests/test_torch_port_plans.py``: 1e-4 of the peak, 1e-3 dB;
  1e-9 relative at f64), batch against single, gradients through autograd;
- ``MfccPlan`` and ``ChromaPlan`` with ``method="factored"``, and a CQT plan,
  which builds and ignores the method, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.mfcc import MfccPlan as JaxMfccPlan
from spectrograms_tpu.ops import fft_factored as jff
from spectrograms_tpu_torch.convert import factored_constants_from_numpy, plan_constants_from_numpy
from spectrograms_tpu_torch.ops import fft_factored as tff

CPU = dict(device="cpu")
SR = 16000.0


def mel_db(m, method, n_fft=1024, hop=256, dtype="float32", **kw):
    params = m.SpectrogramParams(m.StftParams(n_fft, hop), SR)
    mel = m.MelParams(64, 0.0, 8000.0, m.MelNorm.SLANEY)
    return m.MelDbPlan(params, mel, m.LogParams(-80.0), dtype=dtype, method=method, **kw)


def test_supports_factored_equals_jax():
    for n in list(range(0, 9000, 64)) + [128, 384, 400, 8192]:
        assert tff.supports_factored(n) == jff.supports_factored(n), n
    assert tff.supports_factored(256) and tff.supports_factored(4096)
    assert not tff.supports_factored(128) and not tff.supports_factored(8192)


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_constants_equal_jax(n_fft, dtype):
    mine = tff._constants_np(n_fft, np.dtype(dtype).str)
    theirs = jff._constants_np(n_fft, np.dtype(dtype).str)
    for a, b in zip(mine[:4], theirs[:4]):
        np.testing.assert_array_equal(a, b)
    assert len(mine[4]) == len(theirs[4]) == int(np.log2(n_fft // 128))
    for (ar, ai), (br, bi) in zip(mine[4], theirs[4]):
        np.testing.assert_array_equal(ar, br)
        np.testing.assert_array_equal(ai, bi)


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_factored_matches_numpy_rfft_f64(n_fft):
    frames = np.random.default_rng(0).standard_normal((5, n_fft))
    w = tg.make_window("hann", n_fft, np.float64)
    re, im = tff.FactoredRfft(n_fft, w, dtype=np.float64)(torch.from_numpy(frames))
    ref = np.fft.rfft(frames * w, axis=-1)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(re.numpy(), ref.real, atol=1e-10 * scale)
    np.testing.assert_allclose(im.numpy(), ref.imag, atol=1e-10 * scale)


def test_factored_f32_accuracy():
    frames = np.random.default_rng(1).standard_normal((8, 1024)).astype(np.float32)
    re, im = tff.FactoredRfft(1024, None, dtype=np.float32)(torch.from_numpy(frames))
    ref = np.fft.rfft(frames.astype(np.float64), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(re.numpy() - ref.real).max() < 1e-5 * scale
    assert np.abs(im.numpy() - ref.imag).max() < 1e-5 * scale


@pytest.mark.parametrize("n_fft,windowed", [(256, True), (1024, False), (4096, True)])
def test_factored_from_jax_constants_matches_jax(n_fft, windowed):
    w = tg.make_window("hann", n_fft, np.float64) if windowed else None
    j = jff.FactoredRfft(n_fft, w, np.float32)
    t = factored_constants_from_numpy(
        tff.FactoredRfft(n_fft, None if w is None else np.ones(n_fft), np.float32),
        np.asarray(j._c), np.asarray(j._s), np.asarray(j._tw_re), np.asarray(j._tw_im),
        [(np.asarray(re), np.asarray(im)) for re, im in j._bfs],
        None if j._window is None else np.asarray(j._window))
    frames = np.random.default_rng(2).standard_normal((3, 4, n_fft)).astype(np.float32)
    jre, jim = j(jnp.asarray(frames))
    re, im = t(torch.from_numpy(frames))
    scale = float(np.abs(np.asarray(jre)).max())
    np.testing.assert_allclose(re.numpy(), np.asarray(jre), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(im.numpy(), np.asarray(jim), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(t.power(torch.from_numpy(frames)).numpy(),
                               np.asarray(j.power(jnp.asarray(frames))), rtol=0,
                               atol=1e-5 * scale ** 2)
    with pytest.raises(tg.DimensionMismatchError):
        factored_constants_from_numpy(t, np.zeros((4, 4)), j._s, j._tw_re, j._tw_im, [], None)
    with pytest.raises(ValueError):
        tff.FactoredRfft(384)


def test_factored_plan_matches_fft_method_and_jax():
    x = np.random.default_rng(2).standard_normal(16000).astype(np.float32)
    fac = mel_db(tg, "factored", **CPU)
    assert fac.method == "factored"
    a = fac.compute_raw(x).numpy()
    np.testing.assert_allclose(a, mel_db(tg, "fft", **CPU).compute_raw(x).numpy(), atol=2e-3)
    np.testing.assert_allclose(a, np.asarray(mel_db(sg, "factored").compute_raw(x)), atol=1e-3)


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (2048, 512)])
def test_factored_f64_plan_matches_fft_tightly_and_jax(n_fft, hop):
    params = lambda m: m.SpectrogramParams(m.StftParams(n_fft, hop), SR)
    x = np.random.default_rng(3).standard_normal(8000)
    fac = tg.LinearPowerPlan(params(tg), dtype="float64", method="factored", **CPU)
    a = fac.compute_raw(x).numpy()
    b = tg.LinearPowerPlan(params(tg), dtype="float64", method="fft", **CPU).compute_raw(x).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * b.max())
    j = np.asarray(sg.LinearPowerPlan(params(sg), dtype="float64", method="factored").compute_raw(x))
    np.testing.assert_allclose(a, j, rtol=1e-9, atol=1e-12 * j.max())


@pytest.mark.parametrize("scale,amp", [("MEL", "POWER"), ("ERB", "MAGNITUDE"),
                                       ("LOG_HZ", "POWER"), ("LINEAR", "DECIBELS")])
def test_factored_plans_match_jax(scale, amp):
    sps = {"MEL": lambda m: m.MelParams(40, 0.0, 8000.0), "ERB": lambda m: m.ErbParams(32, 50.0,
                                                                                       8000.0),
           "LOG_HZ": lambda m: m.LogHzParams(48, 50.0, 8000.0), "LINEAR": lambda m: None}
    x = np.random.default_rng(4).standard_normal(12000).astype(np.float32)

    def build(m, **kw):
        return m.SpectrogramPlan(m.SpectrogramParams(m.StftParams(512, 160), SR),
                                 getattr(m.FreqScale, scale), getattr(m.AmpScale, amp),
                                 scale_params=sps[scale](m),
                                 log_params=m.LogParams(-80.0) if amp == "DECIBELS" else None,
                                 dtype="float32", method="factored", **kw)
    out = build(tg, **CPU).compute_raw(x).numpy()
    ref = np.asarray(build(sg).compute_raw(x))
    if amp == "DECIBELS":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_factored_rejects_unsupported_n_fft_and_auto_never_picks_it():
    for m, kw in ((sg, {}), (tg, CPU)):
        params = m.SpectrogramParams(m.StftParams(400, 100), SR)
        with pytest.raises(m.InvalidInputError, match="128 \\* 2\\^k"):
            m.LinearPowerPlan(params, dtype="float32", method="factored", **kw)
        assert m.LinearPowerPlan(params, dtype="float32", **kw).method == "matmul"
        assert mel_db(m, "auto", **kw).method != "factored"


def test_factored_batch_equals_single():
    plan = tg.LinearPowerPlan(tg.SpectrogramParams(tg.StftParams(256, 64), 8000.0),
                              dtype="float32", method="factored", **CPU)
    xb = np.random.default_rng(4).standard_normal((3, 4000)).astype(np.float32)
    out = plan.compute_batch(xb).numpy()
    for i in range(3):
        np.testing.assert_allclose(out[i], plan.compute_raw(xb[i]).numpy(), rtol=2e-4, atol=1e-5)


def test_factored_grad_flows_and_matches_the_fft_route():
    params = tg.SpectrogramParams(tg.StftParams(256, 128), 8000.0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(2000).astype(np.float32))
    grads = []
    for method in ("factored", "fft"):
        plan = tg.LinearPowerPlan(params, dtype="float32", method=method, **CPU)
        xr = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(plan._forward(xr).sum(), xr)
        grads.append(g)
    assert bool(torch.isfinite(grads[0]).all()) and float(grads[0].abs().max()) > 0
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=0,
                               atol=1e-4 * float(grads[1].abs().max()))
    jplan = sg.LinearPowerPlan(sg.SpectrogramParams(sg.StftParams(256, 128), 8000.0),
                               dtype="float32", method="factored")
    jg = jax.grad(lambda v: jnp.sum(jplan._forward(v)))(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4 * float(np.abs(np.asarray(jg)).max()))


def test_factored_plan_takes_jax_constants():
    """A JAX factored plan's window and mapping, carried over, rebuild the
    port plan's factored constants."""
    j = mel_db(sg, "factored")
    t = plan_constants_from_numpy(mel_db(tg, "factored", **CPU), np.asarray(j._window),
                                  np.asarray(j._mapping_t).T)
    x = np.random.default_rng(6).standard_normal(8000).astype(np.float32)
    np.testing.assert_allclose(t.compute_raw(x).numpy(), np.asarray(j.compute_raw(x)), atol=1e-3)


def test_mfcc_and_chroma_pass_factored_through():
    x = np.random.default_rng(7).standard_normal(16000).astype(np.float32)
    mel = lambda m: m.MelParams(64, 0.0, 8000.0, m.MelNorm.SLANEY)
    m_t = tg.MfccPlan(tg.StftParams(1024, 256), SR, mfcc_params=tg.MfccParams(13),
                      mel_params=mel(tg), method="factored", **CPU)
    m_j = JaxMfccPlan(sg.StftParams(1024, 256), SR, mfcc_params=sg.MfccParams(13),
                      mel_params=mel(sg), method="factored")
    assert m_t.method == "factored"
    out, ref = m_t.compute(x).data.numpy(), np.asarray(m_j.compute(x).data)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    x44 = np.random.default_rng(8).standard_normal(44100).astype(np.float32)
    c_t = tg.ChromaPlan(tg.StftParams(4096, 1024), 44100.0, method="factored", **CPU)
    c_j = sg.ChromaPlan(sg.StftParams(4096, 1024), 44100.0, method="factored")
    assert c_t.method == "factored" and not c_t._pallas_factored
    np.testing.assert_allclose(c_t.compute(x44).data.numpy(), np.asarray(c_j.compute(x44).data),
                               rtol=0, atol=1e-5)


def test_cqt_plan_builds_and_ignores_factored():
    x = np.random.default_rng(9).standard_normal(16000).astype(np.float32)
    args = lambda m: (m.SpectrogramParams(m.StftParams(1024, 256), SR), m.CqtParams(12, 5, 55.0))
    t = tg.CqtPowerPlan(*args(tg), dtype="float32", method="factored", **CPU)
    j = sg.CqtPowerPlan(*args(sg), dtype="float32", method="factored")
    assert t.method == j.method == "factored" and not hasattr(t, "_factored")
    ref = np.asarray(j.compute_raw(x))
    np.testing.assert_allclose(t.compute_raw(x).numpy(), ref, rtol=0, atol=1e-4 * ref.max())
    dense = tg.CqtPowerPlan(*args(tg), dtype="float32", method="matmul", **CPU).compute_raw(x)
    assert torch.equal(t.compute_raw(x), dense)
