"""The port's chroma against the JAX package's, on the CPU.

``ChromaPlan`` is the fused kernel's second caller (``pre_amp="magnitude"``).
Same inputs (numpy, seeded) through both packages: the plans at
``method="matmul"`` and ``"pallas"`` at ``tests/test_pallas.py``'s chroma
tolerance (atol 1e-4), and at the serving tiers; every normalization at
``tests/test_chroma.py``'s; the one-shots, ``chromagram_from_spectrogram``,
constants carried across, and the part not yet ported (multirate).
"""

import jax
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.chroma import ChromaPlan as JaxChromaPlan
from spectrograms_tpu.chroma import apply_chroma_normalization as jax_normalize
from spectrograms_tpu_torch.chroma import apply_chroma_normalization
from spectrograms_tpu_torch.ops import fused_factored as tff
from tests.conftest import noise, sine

SR22 = 22050.0


def chroma_plan(m, method, precision=None, n_fft=4096, hop=1024, sr=SR22, params=None, **kw):
    if m is tg:
        kw.setdefault("device", "cpu")
        cls = tg.ChromaPlan
        prec = None if precision is None else getattr(tg.Precision, precision)
    else:
        cls = JaxChromaPlan
        prec = None if precision is None else getattr(jax.lax.Precision, precision)
    params = m.ChromaParams.music_standard() if params is None else params
    return cls(m.StftParams(n_fft, hop), sr, params, dtype="float32", method=method,
               precision=prec, **kw)


@pytest.mark.parametrize("method,precision", [
    ("matmul", None), ("pallas", None), ("pallas", "DEFAULT"), ("pallas:x2", None),
])
def test_chroma_plan_matches_jax(method, precision):
    """test_pallas.py::test_chroma_pallas_matches_matmul's inputs and atol,
    with the JAX plan at the same method and tier."""
    x = noise(22050, seed=11, dtype=np.float32)
    j = chroma_plan(sg, method, precision)
    t = chroma_plan(tg, method, precision)
    assert t._pallas_factored == j._pallas_factored == method.startswith("pallas")
    ref = np.asarray(j.compute(x).data)
    out = t.compute(x)
    assert out.shape == ref.shape == (12, 22) and out.n_bins == 12 and out.dtype == "float32"
    np.testing.assert_allclose(out.to_numpy(), ref, rtol=0, atol=1e-4)
    xb = np.stack([x, 0.5 * x])
    np.testing.assert_allclose(t.compute_batch(xb).numpy(), np.asarray(j.compute_batch(xb)),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("norm", ["NONE", "L1", "L2", "MAX"])
def test_every_norm_matches_jax(norm):
    """test_chroma.py's configuration (2048/512 at 16 kHz, f64) and its 1e-6."""
    x = sine(440.0) + 0.1 * noise(16000, seed=12)
    jp = sg.ChromaParams.music_standard().with_norm(getattr(sg.ChromaNorm, norm))
    tp = tg.ChromaParams.music_standard().with_norm(getattr(tg.ChromaNorm, norm))
    ref = np.asarray(sg.compute_chromagram(x, sg.StftParams(2048, 512), 16000.0, jp,
                                           dtype="float64").data)
    out = tg.compute_chromagram(x, tg.StftParams(2048, 512), 16000.0, tp, dtype="float64",
                                device="cpu")
    np.testing.assert_allclose(out.to_numpy(), ref, rtol=0, atol=1e-6)
    assert int(out.to_numpy().mean(axis=1).argmax()) == 9          # A
    c = np.random.default_rng(13).exponential(size=(7, 12))
    c[3] = 0.0                                                     # a silent frame
    np.testing.assert_allclose(
        apply_chroma_normalization(torch.from_numpy(c), tp.norm).numpy(),
        np.asarray(jax_normalize(c, jp.norm)), rtol=1e-12, atol=0)


def test_compute_batch_is_compute_per_row():
    xb = np.stack([noise(22050, seed=14, dtype=np.float32), sine(261.63, sr=22050, dtype=np.float32),
                   np.zeros(22050, np.float32)])
    for method, precision in (("matmul", None), ("pallas", "DEFAULT")):
        plan = chroma_plan(tg, method, precision)
        batch = plan.compute_batch(xb).numpy()
        assert batch.shape == (3, 12, 22) and np.isfinite(batch).all()
        for row in range(3):
            np.testing.assert_allclose(batch[row], plan.compute(xb[row]).to_numpy(),
                                       rtol=1e-5, atol=1e-6)
        with pytest.raises(tg.InvalidInputError):
            plan.compute_batch(xb[0])
        with pytest.raises(tg.InvalidInputError):
            plan.compute(xb)


def test_one_shots_match_jax():
    x = sine(440.0, sr=22050) + 0.05 * noise(22050, seed=15)
    stft = (2048, 512)
    ref = np.asarray(sg.chromagram(x, sg.StftParams(*stft), SR22, dtype="float64").data)
    out = tg.chromagram(x, tg.StftParams(*stft), SR22, dtype="float64", device="cpu")
    np.testing.assert_allclose(out.to_numpy(), ref, rtol=0, atol=1e-9)
    out2 = tg.compute_chromagram(x, tg.StftParams(*stft), SR22, dtype="float64", device="cpu")
    np.testing.assert_array_equal(out2.to_numpy(), out.to_numpy())
    assert tg.Chromagram.labels[9] == sg.Chromagram.labels[9] == "A"
    assert np.asarray(out).shape == ref.shape


def test_chromagram_from_spectrogram_matches_jax():
    mag = np.random.default_rng(16).exponential(size=(1025, 9))
    ref = np.asarray(sg.chromagram_from_spectrogram(mag, 16000.0, 2048).data)
    out = tg.chromagram_from_spectrogram(torch.from_numpy(mag), 16000.0, 2048)
    np.testing.assert_allclose(out.to_numpy(), ref, rtol=1e-12, atol=1e-15)
    for m in (sg, tg):
        with pytest.raises(m.DimensionMismatchError):
            m.chromagram_from_spectrogram(np.zeros((100, 5)), 16000.0, 2048)
        with pytest.raises(m.InvalidInputError):
            m.chromagram_from_spectrogram(np.zeros(1025), 16000.0, 2048)


def test_multirate_is_not_yet_ported():
    """Multirate chroma was the part of ``ChromaPlan`` still missing; it is
    ported now and builds at JAX's depth with JAX's output (the full
    parity: ``tests/test_torch_port_multirate.py``)."""
    x = np.random.default_rng(18).standard_normal(44100).astype(np.float32)
    kw = dict(params=sg.ChromaParams.music_standard().with_multirate(), sr=44100.0)
    j = chroma_plan(sg, "auto", **kw)
    t = chroma_plan(tg, "auto", **{**kw, "params": tg.ChromaParams.music_standard().with_multirate()})
    assert t._decimation == j._decimation == 2
    ref = np.asarray(j.compute(x).data)
    np.testing.assert_allclose(t.compute(x).to_numpy(), ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("method", ["matmul", "pallas"])
def test_constants_carried_across_give_the_jax_output(method):
    x = noise(22050, seed=17, dtype=np.float32)
    j = chroma_plan(sg, "matmul")
    t = tg.plan_constants_from_numpy(chroma_plan(tg, method), np.asarray(j._mag_plan._window),
                                     np.asarray(j._fb_t).T)
    ref = np.asarray(j.compute(x).data)
    np.testing.assert_allclose(t.compute(x).to_numpy(), ref, rtol=0, atol=1e-4)
    # The installed constants are the ones used: a bank of one pitch class.
    fb = np.zeros_like(np.asarray(j._fb_t).T)
    fb[9] = np.asarray(j._fb_t).T[9]
    one = tg.plan_constants_from_numpy(t, np.asarray(j._mag_plan._window), fb).compute(x)
    assert np.allclose(one.to_numpy()[9], 1.0) and not one.to_numpy()[:9].any()
    with pytest.raises(tg.DimensionMismatchError):
        tg.plan_constants_from_numpy(t, np.ones(2048), np.asarray(j._fb_t).T)
    with pytest.raises(tg.InvalidInputError):
        tg.plan_constants_from_numpy(t, np.asarray(j._mag_plan._window),
                                     np.asarray(j._fb_t).T, dct_basis=np.ones((12, 4)))


def test_gradient_through_the_kernel_route_is_the_plain_one():
    x = torch.from_numpy(noise(22050, seed=18, dtype=np.float32))
    w = torch.from_numpy(np.random.default_rng(19).standard_normal((12, 22)).astype(np.float32))
    for precision in (None, "DEFAULT"):
        plan = chroma_plan(tg, "pallas", precision)
        before = (tff.fused_factored_features.launches, tff.fused_tier_features.launches)
        a = x.clone().requires_grad_(True)
        (plan.compute(a).data * w).sum().backward()
        b = x.clone().requires_grad_(True)
        (plan._plain_forward(b) * w).sum().backward()
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
        assert (tff.fused_factored_features.launches, tff.fused_tier_features.launches) == before
