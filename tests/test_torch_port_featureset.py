"""The port's ``FeatureSet`` against the JAX package's, on the CPU.

- the same members (multirate chroma, mel and MFCC, plain plans, callables)
  give what JAX's ``FeatureSet`` gives, at the f32 tolerances of
  ``tests/test_torch_port_multirate.py`` (1e-3 dB; 1e-5·max otherwise);
- each shared-cascade member is bit-equal to its own standalone
  ``compute_batch`` at depth ≤ 2, in any member order
  (``tests/test_featureset.py:67-78``, ``:207-233``, ``:262``);
- the cascade flavours, ``compute`` on one signal, gradients and the
  validation errors;
- CQT members: a full-Q multirate CQT and a multirate chroma in one set
  against JAX's set (member by member, the same flavour keys and number of
  cascades) and the CQT member against its standalone plan at
  ``tests/test_featureset.py:80-113``'s two bounds; an MDCT round-trip
  callable; gradients through a CQT + chroma set; ``benchmarks/suite.py``
  config 4's step (CQT-84, multirate chroma, MDCT round trip) at a batch of
  2 × 5 s against JAX's ``fs._step_impl``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.chroma import ChromaPlan as JaxChromaPlan
from spectrograms_tpu.mfcc import MfccPlan as JaxMfccPlan

tmdct = importlib.import_module("spectrograms_tpu_torch.mdct")

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


# ---- CQT members (config 4) ----------------------------------------------------------------

def cqt(m, cqt_params=None, dtype="float32"):
    kw = dict(device="cpu") if m is tg else {}
    p = cqt_params(m) if cqt_params is not None else m.CqtParams(12, 7, 32.703)
    return m.CqtPowerPlan(m.SpectrogramParams(m.StftParams(4096, 1024), SR), p, dtype=dtype,
                          **kw)


def mdct_roundtrip(m, window=512):
    """Config 4's MDCT member: ``jax.vmap`` of ``mdct_one`` in JAX
    (``benchmarks/suite.py:198-203``); the port's private impls take the
    batch axis."""
    mp = m.MdctParams.sine_window(window)
    if m is sg:
        def one(sig):
            return sg.imdct(sg.mdct(sig, mp, dtype="float32"), mp, original_length=sig.shape[0])
        return lambda b: jax.vmap(one)(b)

    def rt(b):
        fwd, inv = tmdct._consts_for(mp, False, b.dtype, b.device)
        c = tmdct._mdct_impl(b, fwd, mp.window_size, mp.hop_size)
        return tmdct._imdct_impl(c.transpose(-1, -2), inv, mp.window_size, mp.hop_size)[
            ..., : b.shape[-1]]
    return rt


@pytest.fixture(scope="module")
def x8():
    return np.random.default_rng(7).standard_normal((1, int(SR) * 8)).astype(np.float32)


@pytest.mark.parametrize("form", ["auto", "min"])
def test_cqt_chroma_set_matches_jax_and_standalone(x8, form):
    """``auto``: config 4's CQT, whose policy elects the octave stack at
    depth "max" (composite stages) and shares one cascade with the chroma;
    ``min``: an explicit full-Q stack at depth "min" (single half-band
    stages, pad 0), a flavour of its own, so two cascades, as in JAX."""
    params = None if form == "auto" else (lambda m: m.CqtParams(12, 7, 32.703).with_multirate())
    tcq, jcq = cqt(tg, params), cqt(sg, params)
    assert tcq.scale_params.multirate and tcq._cqt_mr_composite == (form == "auto")
    tfs, jfs = tg.FeatureSet([tcq, chroma(tg)]), sg.FeatureSet([jcq, chroma(sg)])
    assert len(tfs._flavors) == len(jfs._flavors) == (1 if form == "auto" else 2)
    assert ({(c, p.value) for c, p in tfs._flavors}
            == {(c, p.name.lower()) for c, p in jfs._flavors})
    assert sorted(tfs._flavors.values()) == sorted(jfs._flavors.values())
    got = tfs.compute_batch(x8)
    for g, w in zip(got, jfs.compute_batch(x8)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * rel_max(w))
    # the member against its standalone plan (tests/test_featureset.py:80-113):
    # the middle third to float noise, edge frames within the cascade's class
    g, w = got[0].numpy(), tcq.compute_batch(x8).numpy()
    nf = g.shape[-1]
    mid = (Ellipsis, slice(nf // 3, 2 * nf // 3))
    np.testing.assert_allclose(g[mid], w[mid], rtol=5e-5, atol=5e-5 * np.abs(w).max())
    np.testing.assert_allclose(g, w, rtol=0, atol=5e-3 * np.abs(w).max())
    assert torch.equal(got[1], tfs._members[1].compute_batch(x8))


def test_mdct_callable_member(xb):
    """``tests/test_featureset.py:136-156``: a plain mel plan and an MDCT
    round trip ride along; the round trip equals JAX's vmapped one."""
    params = lambda m: m.SpectrogramParams(m.StftParams(4096, 1024), SR)
    melp = lambda m, **kw: m.MelDbPlan(params(m), m.MelParams(64, 0.0, 8000.0),
                                       m.LogParams(-80.0), dtype="float32", **kw)
    tmel = melp(tg, device="cpu")
    got_mel, got_rt = tg.FeatureSet([tmel, mdct_roundtrip(tg)]).compute_batch(xb)
    assert torch.equal(got_mel, tmel.compute_batch(xb))
    want_mel, want_rt = sg.FeatureSet([melp(sg), mdct_roundtrip(sg)]).compute_batch(xb)
    want_rt = np.asarray(want_rt)
    assert tuple(got_rt.shape) == want_rt.shape and got_rt.shape[0] == xb.shape[0]
    np.testing.assert_allclose(got_rt.numpy(), want_rt, rtol=0, atol=1e-4 * rel_max(want_rt))
    np.testing.assert_allclose(got_mel.numpy(), np.asarray(want_mel), rtol=0, atol=1e-3)
    # the interior is the signal back (tests/test_mdct.py's f32 bar)
    n = got_rt.shape[1]
    assert float((got_rt[:, 512:n - 512] - torch.from_numpy(xb)[:, 512:n - 512]).abs().max()) < 1e-3


def test_gradients_through_a_cqt_chroma_set():
    """``tests/test_featureset.py:174-193``: the gradient through a CQT +
    chroma step is finite; with the chroma on its kernel route (whose
    backward runs the plain version, ``ops.gradients``) it equals plain
    autograd through the same set with the chroma at ``method="matmul"``,
    and JAX's gradient."""
    xs = np.random.default_rng(3).standard_normal((2, int(SR))).astype(np.float32)
    small = lambda m: m.CqtParams(12, 4, 65.4)
    grads = []
    for method in ("pallas", "matmul"):
        fs = tg.FeatureSet([cqt(tg, small), chroma(tg, method)])
        x = torch.from_numpy(xs).requires_grad_(True)
        a, b = fs._step_impl(x)
        (a.sum() + b.sum()).backward()
        assert bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().max()) > 0
        grads.append(x.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=0,
                               atol=1e-4 * float(grads[1].abs().max()))
    jfs = sg.FeatureSet([cqt(sg, small), chroma(sg)])

    def loss(v):
        a, b = jfs._step_impl(v)
        return jnp.sum(a) + jnp.sum(b)

    g_ref = np.asarray(jax.grad(loss)(jnp.asarray(xs)))
    np.testing.assert_allclose(grads[0].numpy(), g_ref, rtol=0, atol=1e-3 * rel_max(g_ref))


def test_config4_step_matches_jax():
    """``benchmarks/suite.py`` config 4 (``:155-243``) at a batch of 2 × 5 s:
    CQT-84 from C1 (the policy elects the octave stack), the multirate
    ``music_standard`` chroma and the MDCT round trip (sine window 512), as
    one ``FeatureSet`` step, against JAX's ``fs._step_impl`` member by
    member; the standalone dense ``truncate=True`` CQT likewise."""
    xs = np.random.default_rng(2).standard_normal((2, int(SR) * 5)).astype(np.float32)
    sets = {}
    for m in (sg, tg):
        c = cqt(m)
        assert c.scale_params.multirate and c.scale_params.multirate_depth == "max"
        sets[m] = m.FeatureSet([c, chroma(m), mdct_roundtrip(m)])
    got = sets[tg].compute_batch(xs)
    want = sets[sg]._step_impl(jnp.asarray(xs))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * rel_max(w))
    dense = lambda m, **kw: m.CqtPowerPlan(
        m.SpectrogramParams(m.StftParams(4096, 1024), SR),
        m.CqtParams(12, 7, 32.703).with_truncate(True), dtype="float32", **kw)
    w = np.asarray(jax.vmap(dense(sg)._forward_impl)(jnp.asarray(xs)))
    np.testing.assert_allclose(dense(tg, device="cpu")._forward_impl(torch.from_numpy(xs)).numpy(),
                               w, rtol=0, atol=1e-5 * rel_max(w))
