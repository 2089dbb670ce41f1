"""The port's ``FeatureSet`` against the JAX package's, on the CPU.

- the same members (multirate chroma, mel and MFCC, plain plans, callables)
  give what JAX's ``FeatureSet`` gives, at the f32 tolerances of
  ``tests/test_torch_port_multirate.py`` (1e-3 dB; 1e-5·max otherwise);
- each shared-cascade member is bit-equal to its own standalone
  ``compute_batch`` at depth ≤ 2, in any member order
  (``tests/test_featureset.py:67-78``, ``:207-233``, ``:262``);
- the cascade flavours, ``compute`` on one signal, gradients and the
  validation errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.chroma import ChromaPlan as JaxChromaPlan
from spectrograms_tpu.mfcc import MfccPlan as JaxMfccPlan

SR = 44100.0


@pytest.fixture(scope="module")
def xb():
    return np.random.default_rng(7).standard_normal((2, 44100)).astype(np.float32)


def rel_max(ref):
    return float(np.abs(ref).max())


def chroma(m, method="auto", params=None, sr=SR, stft=(4096, 1024)):
    cls = tg.ChromaPlan if m is tg else JaxChromaPlan
    kw = dict(device="cpu") if m is tg else {}
    p = params if params is not None else m.ChromaParams.music_standard().with_multirate()
    return cls(m.StftParams(*stft), sr, p, dtype="float32", method=method, **kw)


def mfcc(m, method="auto", sr=SR, stft=(2048, 512), mel=(80, 0.0, 4000.0)):
    cls = tg.MfccPlan if m is tg else JaxMfccPlan
    kw = dict(device="cpu") if m is tg else {}
    return cls(m.StftParams(*stft), sr,
               mel_params=m.MelParams(*mel, m.MelNorm.SLANEY).with_multirate(),
               mfcc_params=m.MfccParams(13), dtype="float32", method=method, **kw)


def mel(m, amp="power", method="auto", sr=SR, stft=(2048, 512), mel_args=(64, 0.0, 2000.0),
        multirate=True):
    kw = dict(device="cpu") if m is tg else {}
    return m.SpectrogramPlan(
        m.SpectrogramParams(m.StftParams(*stft), sr), m.FreqScale.MEL,
        m.AmpScale.DECIBELS if amp == "db" else m.AmpScale.POWER,
        scale_params=m.MelParams(*mel_args).with_multirate(multirate),
        log_params=m.LogParams(-80.0) if amp == "db" else None,
        dtype="float32", method=method, **kw)


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_featureset_matches_jax(xb, method):
    members = lambda m, meth: [chroma(m, meth), mfcc(m, meth), mel(m, "db", meth)]
    want = sg.FeatureSet(members(sg, "auto")).compute_batch(xb)
    got = tg.FeatureSet(members(tg, method)).compute_batch(xb)
    assert len(got) == len(want) == 3
    for g, w, tol in zip(got, want, (None, None, 1e-3)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=tol if tol is not None else 1e-5 * rel_max(w))


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_members_are_bit_equal_to_standalone(xb, method):
    plans = [chroma(tg, method), mfcc(tg, method), mel(tg, "db", method, mel_args=(64, 0.0, 4000.0))]
    assert [p._fs_cascade_spec()[3] for p in plans] == [(2,), (2,), (2,)]
    fs = tg.FeatureSet(plans)
    assert fs._flavors == {(True, tg.Precision.HIGH): 2048}
    for got, p in zip(fs.compute_batch(xb), plans):
        assert torch.equal(got, p.compute_batch(xb))


def test_mixed_depth_members_bit_exact_any_order():
    """Chroma at d=1 and mel at d=2 in one flavour: level 2 is the single
    composite stage the standalone mel uses, whichever member comes first."""
    xs = np.random.default_rng(5).standard_normal((2, 16000)).astype(np.float32)
    m = mel(tg, sr=16000.0, stft=(1024, 256), mel_args=(64, 0.0, 1500.0))
    ch = chroma(tg, sr=16000.0, stft=(1024, 256),
                params=tg.ChromaParams(f_min=100.0, f_max=3000.0, multirate=True))
    assert ch._decimation == 1 and m._multirate_inner[0] == 2
    want_m, want_ch = m.compute_batch(xs), ch.compute_batch(xs)
    for members, i_m, i_ch in (([ch, m], 1, 0), ([m, ch], 0, 1)):
        out = tg.FeatureSet(members).compute_batch(xs)
        assert torch.equal(out[i_m], want_m) and torch.equal(out[i_ch], want_ch)


def test_deep_level_member_matches_standalone_within_tolerance():
    """d=3: the shared level 3 is chained (level 2, then one half-band),
    the standalone one a composite stage: equal away from float noise."""
    xs = np.random.default_rng(9).standard_normal((2, 32000)).astype(np.float32)
    p = mel(tg, sr=16000.0, stft=(1024, 256), mel_args=(32, 0.0, 800.0))
    assert p._multirate_inner[0] == 3
    (got,) = tg.FeatureSet([p]).compute_batch(xs)
    want = p.compute_batch(xs).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * rel_max(want))


def test_plain_plans_and_callables_ride_along(xb):
    plain = mel(tg, "db", multirate=False, mel_args=(64, 0.0, 8000.0))
    assert plain._fs_cascade_spec() is None
    fs = tg.FeatureSet([plain, lambda b: b[:, :100] * 2.0, chroma(tg)])
    got_mel, got_fn, got_ch = fs.compute_batch(xb)
    assert torch.equal(got_mel, plain.compute_batch(xb))
    assert torch.equal(got_fn, torch.from_numpy(xb[:, :100]) * 2.0)
    jfs = sg.FeatureSet([mel(sg, "db", multirate=False, mel_args=(64, 0.0, 8000.0)),
                         lambda b: b[:, :100] * 2.0, chroma(sg)])
    for g, w in zip((got_mel, got_fn, got_ch), jfs.compute_batch(xb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-3)
    assert fs.n_members == 3
    fn_only = tg.FeatureSet([lambda b: b.sum(-1)])
    assert fn_only.device is None
    torch.testing.assert_close(fn_only.compute_batch(xb)[0], torch.from_numpy(xb).sum(-1))


def test_compute_single_signal(xb):
    ch = chroma(tg)
    (got,) = tg.FeatureSet([ch]).compute(xb[0])
    assert torch.equal(got, ch.compute_batch(xb[:1])[0])
    np.testing.assert_allclose(got.numpy(), ch.compute(xb[0]).to_numpy(), rtol=1e-4, atol=1e-4)
    (jgot,) = sg.FeatureSet([chroma(sg)]).compute(xb[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0,
                               atol=1e-5 * rel_max(np.asarray(jgot)))


def test_gradients_flow_through_a_shared_cascade(xb):
    fs = tg.FeatureSet([chroma(tg, "pallas"), mfcc(tg, "pallas")])
    x = torch.from_numpy(xb[:, :22050]).requires_grad_(True)
    a, b = fs._step_impl(x)
    (a.sum() + b.sum()).backward()
    assert bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().max()) > 0
    jfs = sg.FeatureSet([chroma(sg), mfcc(sg)])

    def loss(v):
        a, b = jfs._step_impl(v)
        return jnp.sum(a) + jnp.sum(b)

    g_ref = np.asarray(jax.grad(loss)(jnp.asarray(xb[:, :22050])))
    np.testing.assert_allclose(x.grad.numpy(), g_ref, rtol=0, atol=1e-3 * rel_max(g_ref))


def test_validation(xb):
    with pytest.raises(tg.InvalidInputError):
        tg.FeatureSet([])
    with pytest.raises(tg.InvalidInputError, match="neither"):
        tg.FeatureSet([object()])
    p32 = mel(tg, multirate=False, mel_args=(64, 0.0, 8000.0))
    p64 = tg.SpectrogramPlan(tg.SpectrogramParams(tg.StftParams(2048, 512), SR),
                             tg.FreqScale.MEL, tg.AmpScale.POWER,
                             scale_params=tg.MelParams(64, 0.0, 8000.0), dtype="float64",
                             device="cpu")
    with pytest.raises(tg.InvalidInputError, match="one dtype"):
        tg.FeatureSet([p32, p64])
    fs = tg.FeatureSet([p32])
    with pytest.raises(tg.InvalidInputError):
        fs.compute_batch(xb[0])  # 1-D where a batch is expected
    with pytest.raises(tg.InvalidInputError):
        fs.compute(xb)
