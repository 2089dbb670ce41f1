"""The port's constant-Q transform against the JAX package's, on the CPU.

Same numpy inputs (seeded) through both packages:

- ``ops/cqt.py``'s numpy builders (kernel matrices, lengths, frequencies,
  ``truncation_q_loss``, the policy, ``plan_cqt_bands``, ``max_decimation``,
  ``multirate_cqt_groups`` at both depths, each group's ``k_ri``, ``e0``,
  ``flen`` and ``jp``) equal to JAX's, bit for bit: both are numpy;
- ``tail_framed_matmul`` and the multirate groups' ``ri`` blocks against
  JAX's, one group at a time;
- ``cqt`` (the complex data, dense and multirate) and the three
  ``Cqt*Plan``s at f32 and f64, dense, banded and multirate, from each
  package's own builders and from the JAX plan's constants carried over:
  the JAX output at rtol 1e-9 in f64 and 1e-4·max / 1e-3 dB in f32 (the bar
  of ``tests/test_torch_port_plans.py``);
- ``compute_frame``'s once-only warning and its single-rate fallback, batch
  against single, the error texts;
- the CQT cases of ``tests/test_cqt_erb.py`` re-run on the port, at their
  own tolerances.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.ops import cqt as jcq
from spectrograms_tpu.ops import framing as jfr
from spectrograms_tpu_torch.ops import cqt as tcq
from spectrograms_tpu_torch.ops import framing as tfr
from tests.conftest import noise, sine

SR = 16000.0
SR44 = 44100.0
CPU = dict(device="cpu")


def quiet(fn, *args, **kw):
    """fn(*args, **kw) with the truncation warnings silenced (they are under
    test elsewhere)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


def assert_matches(out, ref, dtype, amp="Power"):
    if dtype == "float64":
        np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-12 * float(np.abs(ref).max()))
    elif amp == "Db":
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()))


# ---- the numpy builders ------------------------------------------------------------

PRESETS = {
    "c1-84": lambda m: m.CqtParams(12, 7, 32.703),
    "q1": lambda m: m.CqtParams(12, 5, 32.7, q_factor=1.0),
    "percussive": lambda m: m.CqtParams.percussive(),
    "onset": lambda m: m.CqtParams.onset_detection(),
    "chord": lambda m: m.CqtParams.chord_detection(),
    "dense-unnormalised": lambda m: m.CqtParams(24, 4, 110.0, sparsity_threshold=0.0,
                                                normalize=False),
}
GEOMS = [(44100.0, 4096, 1024, True), (16000.0, 1024, 256, True), (22050.0, 2048, 512, False),
         (16000.0, 256, 64, True), (48000.0, 4096, 2048, True), (44100.0, 2048, 511, True)]


@pytest.mark.parametrize("geom", GEOMS, ids=[f"{int(g[0])}-{g[1]}-{g[2]}" for g in GEOMS])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_builders_equal_jax(preset, geom):
    sr, n_fft, hop, centre = geom
    jp, tp = PRESETS[preset](sg), PRESETS[preset](tg)
    for a, b in zip(quiet(jcq.cqt_kernel_matrices, jp, sr, n_fft),
                    quiet(tcq.cqt_kernel_matrices, tp, sr, n_fft)):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tcq.cqt_bin_frequencies(tp, sr), jcq.cqt_bin_frequencies(jp, sr))
    lengths = tcq.cqt_kernel_lengths(tp, sr, n_fft)
    np.testing.assert_array_equal(lengths, jcq.cqt_kernel_lengths(jp, sr, n_fft))
    assert tcq.truncation_q_loss(tp, sr, n_fft) == jcq.truncation_q_loss(jp, sr, n_fft)
    for p_t, p_j in ((tp, jp), (tp.with_truncate(False), jp.with_truncate(False)),
                     (tp.with_truncate(True), jp.with_truncate(True))):
        r_t, r_j = (tcq.resolve_cqt_policy(p_t, sr, n_fft, hop, centre),
                    jcq.resolve_cqt_policy(p_j, sr, n_fft, hop, centre))
        assert (r_t.multirate, r_t.multirate_depth, r_t.truncate) == (
            r_j.multirate, r_j.multirate_depth, r_j.truncate)
    assert tcq.plan_cqt_bands(lengths, n_fft, hop) == jcq.plan_cqt_bands(lengths, n_fft, hop)
    assert tcq.max_decimation(n_fft, hop, centre) == jcq.max_decimation(n_fft, hop, centre)
    for depth in ("min", "max"):
        g_t, f_t = quiet(tcq.multirate_cqt_groups, tp, sr, n_fft, hop, centre, depth=depth)
        g_j, f_j = quiet(jcq.multirate_cqt_groups, jp, sr, n_fft, hop, centre, depth=depth)
        np.testing.assert_array_equal(f_t, f_j)
        assert len(g_t) == len(g_j)
        for (d, k, e0, flen, jpk), (dj, kj, e0j, flenj, jpj) in zip(g_t, g_j):
            assert (d, e0, flen, jpk) == (dj, e0j, flenj, jpj)
            np.testing.assert_array_equal(k, kj)


def test_policy_constants_and_banding_switch():
    assert tcq.TRUNCATION_Q_LOSS_THRESHOLD == jcq.TRUNCATION_Q_LOSS_THRESHOLD
    assert tcq.CQT_BANDING is False and jcq.CQT_BANDING is False
    with pytest.raises(tg.InvalidInputError, match="depth must be"):
        tcq.multirate_cqt_groups(tg.CqtParams(12, 7, 32.703), SR44, 4096, 1024, True, depth="x")


def test_truncation_warnings_match_jax():
    """Both packages warn the same texts: the dense clamp, and the residual
    truncation of the octave stack at a hop that cannot decimate deep
    enough."""
    def texts(mod, m, fn, *args, **kw):
        mod._cqt_kernels_cached.cache_clear()
        mod.multirate_cqt_groups.cache_clear()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn(*args, **kw)
        return [str(w.message) for w in caught]

    for mod, m in ((jcq, sg), (tcq, tg)):
        dense = texts(mod, m, mod.cqt_kernel_matrices, m.CqtParams(12, 5, 32.703), SR44, 2048)
        assert len(dense) == 1 and "truncated" in dense[0]
    assert (texts(jcq, sg, jcq.cqt_kernel_matrices, sg.CqtParams(12, 5, 32.703), SR44, 2048)
            == texts(tcq, tg, tcq.cqt_kernel_matrices, tg.CqtParams(12, 5, 32.703), SR44, 2048))
    args = (SR44, 2048, 8, True)
    want = texts(jcq, sg, jcq.multirate_cqt_groups, sg.CqtParams(12, 5, 32.703), *args)
    got = texts(tcq, tg, tcq.multirate_cqt_groups, tg.CqtParams(12, 5, 32.703), *args)
    assert got == want and len(got) == 1 and "remain truncated" in got[0]


# ---- framing primitives --------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,s", [(1024, 256, 256), (1024, 256, 512), (1024, 512, 128),
                                         (1024, 1024, 256), (512, 160, 128), (1024, 256, 1024)])
@pytest.mark.parametrize("centre", [True, False])
def test_tail_framed_matmul_matches_jax(n_fft, hop, s, centre):
    """``tests/test_cqt_erb.py``'s shapes, batched, against JAX's (1e-12)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5000))
    mat = rng.standard_normal((s, 7))
    want = np.asarray(jax.vmap(lambda r: jfr.tail_framed_matmul(r, mat, n_fft, hop, s, centre))(x))
    got = tfr.tail_framed_matmul(torch.from_numpy(x), torch.from_numpy(mat), n_fft, hop, s, centre)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    with pytest.raises(tg.InvalidInputError, match="support"):
        tfr.tail_framed_matmul(torch.from_numpy(x), torch.from_numpy(mat), n_fft, hop, 0)


@pytest.mark.parametrize("xdt,mdt", [("float32", "float64"), ("float64", "float32"),
                                     ("float32", "float32")])
@pytest.mark.parametrize("hop", [256, 300])
def test_framed_matmul_promotes_like_jax(xdt, mdt, hop):
    """The result dtype is ``jnp.promote_types(x, mat)`` on both the hopped
    decomposition (hop 256) and the frame-matrix fallback (hop 300)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal(3000).astype(xdt)
    mat = rng.standard_normal((1024, 5)).astype(mdt)
    want = np.asarray(jfr.framed_matmul(x, mat, 1024, hop, True))
    got = tfr.framed_matmul(torch.from_numpy(x), torch.from_numpy(mat), 1024, hop, True)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


# ---- the multirate groups' ri blocks, one group at a time ------------------------------

@pytest.mark.parametrize("depth", ["min", "max"])
@pytest.mark.parametrize("centre", [True, False])
def test_multirate_ri_blocks_match_jax_per_group(depth, centre):
    """Each group's [re | −im] block on its own, so that a frame shifted by a
    hop in one octave cannot hide in the concatenated result."""
    from spectrograms_tpu.cqt import multirate_ri_blocks as jblocks
    from spectrograms_tpu_torch.cqt import multirate_ri_blocks as tblocks
    from spectrograms_tpu_torch.ops.framing import frame_count

    n_fft, hop = 4096, 1024
    groups, _ = tcq.multirate_cqt_groups(tg.CqtParams(12, 7, 32.703), SR44, n_fft, hop, centre,
                                         depth=depth)
    # packed super-frames at both depths; a signal cut from the front
    # (flen < e0) at depth="max" only
    assert any(jp > 1 for *_, jp in groups)
    assert any(flen < e0 for _, _, e0, flen, _ in groups) == (depth == "max")
    x = np.random.default_rng(4).standard_normal((2, int(SR44 * 1.5)))
    nf = frame_count(x.shape[-1], n_fft, hop, centre)
    prec = jax.lax.Precision.HIGHEST
    want = jblocks(jax.numpy.asarray(x), [(d, jax.numpy.asarray(k), e0, flen, jp)
                                         for d, k, e0, flen, jp in groups],
                   hop, nf, prec, composite=depth == "max")
    got = tblocks(torch.from_numpy(x), [(d, torch.from_numpy(np.array(k)), e0, flen, jp)
                                        for d, k, e0, flen, jp in groups],
                  hop, nf, composite=depth == "max")
    assert len(got) == len(want) == len(groups)
    for g, w, (d, *_) in zip(got, want, groups):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, d
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-12 * np.abs(w).max())


# ---- cqt(): the complex data ----------------------------------------------------------

CQT_CASES = {
    "dense": (lambda m: m.CqtParams(12, 5, 55.0), 512),
    "truncated": (lambda m: m.CqtParams(12, 6, 16.35).with_truncate(True), 4096),
    "auto-multirate": (lambda m: m.CqtParams(12, 6, 16.35), 4096),
    "multirate-min": (lambda m: m.CqtParams(12, 6, 16.35).with_multirate(), 4096),
    "multirate-max": (lambda m: m.CqtParams(12, 6, 16.35).with_multirate(depth="max"), 4096),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(CQT_CASES))
def test_cqt_complex_data_matches_jax(case, dtype):
    """The complex coefficients, phase included: a sign slip in the [re | −im]
    assembly would leave the power unchanged and fail here."""
    params, hop = CQT_CASES[case]
    t = np.arange(32768) / SR
    x = (np.sin(2 * np.pi * 16.35 * t) + 0.3 * np.sin(2 * np.pi * 440.0 * t)
         + 0.1 * np.random.default_rng(7).standard_normal(t.size)).astype(dtype)
    want = quiet(sg.cqt, x, SR, params(sg), hop, dtype=dtype)
    got = quiet(tg.cqt, x, SR, params(tg), hop, dtype=dtype, **CPU)
    assert isinstance(got, tg.CqtResult)
    assert got.data.dtype == (torch.complex128 if dtype == "float64" else torch.complex64)
    assert (got.n_bins, got.n_frames, got.dtype, got.hop_size) == (
        want.n_bins, want.n_frames, want.dtype, want.hop_size)
    np.testing.assert_array_equal(got.frequencies, want.frequencies)
    w = np.asarray(want.data)
    tol = 1e-9 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(got.to_numpy(), w, rtol=0, atol=tol * np.abs(w).max())
    np.testing.assert_allclose(got.to_power().numpy(), np.asarray(want.to_power()), rtol=0,
                               atol=tol * np.abs(w).max() ** 2)
    np.testing.assert_allclose(got.to_magnitude().numpy(), np.asarray(want.to_magnitude()),
                               rtol=0, atol=tol * np.abs(w).max())


def test_cqt_validation_matches_jax():
    for m, kw in ((sg, {}), (tg, CPU)):
        with pytest.raises(m.InvalidInputError, match="non-empty"):
            m.cqt(np.zeros(0), SR, m.CqtParams(12, 5, 55.0), 256, **kw)
        with pytest.raises(m.InvalidInputError, match="hop_size"):
            m.cqt(np.zeros(1000), SR, m.CqtParams(12, 5, 55.0), 0, **kw)
    with pytest.raises(tg.InvalidInputError, match="Precision"):
        tg.cqt(np.zeros(1000), SR, tg.CqtParams(12, 5, 55.0), 256, precision="high", **CPU)
    res = tg.cqt(np.zeros(1000, np.float32), SR, tg.CqtParams(12, 5, 55.0), 256,
                 precision=tg.Precision.HIGHEST, **CPU)
    assert res.dtype == "float32" and res.n_frames == 1  # a frame of the whole signal


# ---- the three CQT plans -----------------------------------------------------------------

PLAN_CASES = {
    # (CqtParams of a package, n_fft, hop): 44.1 kHz
    "auto-multirate": (lambda m: m.CqtParams(12, 7, 32.703), 4096, 1024),
    "multirate-min": (lambda m: m.CqtParams(12, 7, 32.703).with_multirate(), 4096, 1024),
    "truncate": (lambda m: m.CqtParams(12, 7, 32.703).with_truncate(True), 4096, 1024),
    "dense": (lambda m: m.CqtParams(12, 4, 220.0), 2048, 512),
}
AMPS = ("Power", "Magnitude", "Db")


def plan_pair(case, amp, dtype, **tkw):
    params, n_fft, hop = PLAN_CASES[case]
    out = []
    for m, kw in ((sg, {}), (tg, CPU)):
        extra = {"db": m.LogParams(-80.0)} if amp == "Db" else {}
        out.append(quiet(getattr(m, f"Cqt{amp}Plan"),
                         m.SpectrogramParams(m.StftParams(n_fft, hop), SR44), params(m),
                         dtype=dtype, **extra, **kw, **(tkw if m is tg else {})))
    return out


@pytest.fixture(scope="module")
def x44():
    return np.random.default_rng(12).standard_normal((2, int(SR44 * 1.2)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("amp", AMPS)
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_cqt_plan_matches_jax(case, amp, dtype, x44):
    jplan, tplan = plan_pair(case, amp, dtype)
    assert type(tplan).__name__ == f"Cqt{amp}Plan" and tplan.dtype == dtype
    assert tplan.scale_params.multirate == jplan.scale_params.multirate
    assert tplan.scale_params.multirate_depth == jplan.scale_params.multirate_depth
    assert (tplan._cqt_multirate is None) == (jplan._cqt_multirate is None)
    np.testing.assert_array_equal(tplan.frequencies, jplan.frequencies)
    xb = x44.astype(dtype)
    ref = np.asarray(jplan.compute_batch(xb))
    out = tplan.compute_batch(xb).numpy()
    assert out.shape == ref.shape == (2,) + tplan.output_shape(xb.shape[1])
    assert_matches(out, ref, dtype, amp)
    spec = tplan.compute(xb[0])
    assert spec.freq_scale == tg.FreqScale.CQT
    assert_matches(spec.to_numpy(), np.asarray(jplan.compute(xb[0]).data), dtype, amp)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_cqt_plan_from_jax_constants(case, dtype, x44):
    """The port's plan from the JAX plan's kernels, groups and bands: both
    packages compute the same function from the same constants."""
    jplan, tplan = plan_pair(case, "Power", dtype)
    groups = None if jplan._cqt_multirate is None else [
        (d, np.asarray(k), e0, flen, jp) for d, k, e0, flen, jp in jplan._cqt_multirate]
    tg.plan_constants_from_numpy(tplan, cqt_ri=np.asarray(jplan._cqt_ri), cqt_groups=groups)
    xb = x44.astype(dtype)
    assert_matches(tplan.compute_batch(xb).numpy(), np.asarray(jplan.compute_batch(xb)), dtype)
    with pytest.raises(tg.InvalidInputError, match="cqt_ri"):
        tg.plan_constants_from_numpy(tplan)
    with pytest.raises(tg.InvalidInputError, match="only cqt_ri"):
        tg.plan_constants_from_numpy(tplan, np.ones(4096), cqt_ri=np.asarray(jplan._cqt_ri))
    with pytest.raises(tg.DimensionMismatchError):
        tg.plan_constants_from_numpy(tplan, cqt_ri=np.ones((7, 7)), cqt_groups=groups)
    mel = tg.MelPowerPlan(tg.SpectrogramParams(tg.StftParams(512, 128), SR),
                          tg.MelParams(32, 0.0, 8000.0), **CPU)
    with pytest.raises(tg.InvalidInputError, match="only a CQT plan"):
        tg.plan_constants_from_numpy(mel, np.ones(512), np.ones((32, 257)), cqt_ri=np.ones(3))


@pytest.fixture
def banding():
    """``set_cqt_banding(True)`` in both packages, restored after."""
    was = (jcq.CQT_BANDING, tcq.CQT_BANDING)
    jcq.set_cqt_banding(True)
    tcq.set_cqt_banding(True)
    yield
    jcq.set_cqt_banding(was[0])
    tcq.set_cqt_banding(was[1])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("amp", AMPS)
def test_banded_plan_matches_jax(banding, amp, dtype, x44):
    jplan, tplan = plan_pair("truncate", amp, dtype)
    assert tplan._cqt_bands is not None and len(tplan._cqt_bands) == len(jplan._cqt_bands) > 1
    for (s0, s1, s, k), (j0, j1, js, jk) in zip(tplan._cqt_bands, jplan._cqt_bands):
        assert (s0, s1, s) == (j0, j1, js)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    xb = x44.astype(dtype)
    assert_matches(tplan.compute_batch(xb).numpy(), np.asarray(jplan.compute_batch(xb)), dtype, amp)
    # the same plan from the JAX plan's constants, bands included
    tg.plan_constants_from_numpy(
        tplan, cqt_ri=np.asarray(jplan._cqt_ri),
        cqt_bands=[(a, b, s, np.asarray(k)) for a, b, s, k in jplan._cqt_bands])
    assert_matches(tplan.compute_batch(xb).numpy(), np.asarray(jplan.compute_batch(xb)), dtype, amp)
    with pytest.raises(tg.InvalidInputError, match="banded"):
        tg.plan_constants_from_numpy(tplan, cqt_ri=np.asarray(jplan._cqt_ri))
    # compute_frame contracts each band against its frame tail too
    np.testing.assert_allclose(tplan.compute_frame(xb[0], 5).numpy(),
                               np.asarray(jplan.compute_frame(xb[0], 5)), rtol=0,
                               atol=(1e-9 if dtype == "float64" else 1e-3 if amp == "Db" else 1e-4)
                               * (1 if amp == "Db" else float(np.abs(
                                   np.asarray(jplan.compute_frame(xb[0], 5))).max())))


# ---- compute_frame, batch, errors -----------------------------------------------------------

def test_compute_frame_warns_once_and_matches_jax():
    """A multirate plan's ``compute_frame`` falls back to the truncated
    single-rate kernels and warns once (``tests/test_cqt_erb.py``), and its
    values are JAX's fallback values."""
    t = np.arange(16000) / SR
    x = np.sin(2 * np.pi * 65.4 * t) + 0.5 * np.sin(2 * np.pi * 261.6 * t)
    params = lambda m: m.SpectrogramParams(m.StftParams(256, 64), SR)
    p_mr = lambda m: m.CqtParams(12, 5, 32.7, q_factor=1.0, multirate=True)
    jplan = sg.CqtPowerPlan(params(sg), p_mr(sg), dtype="float64")
    tplan = tg.CqtPowerPlan(params(tg), p_mr(tg), dtype="float64", **CPU)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        frames = [tplan.compute_frame(x, i) for i in (0, 1, 100)]
    msgs = [str(w.message) for w in caught if "multirate" in str(w.message)]
    assert len(msgs) == 1 and "single-rate" in msgs[0]
    for i, f in zip((0, 1, 100), frames):
        want = np.asarray(quiet(jplan.compute_frame, x, i))
        np.testing.assert_allclose(f.numpy(), want, rtol=1e-9, atol=1e-12 * np.abs(want).max())
    with pytest.raises(tg.InvalidInputError, match="out of range"):
        tplan.compute_frame(x, tplan.output_shape(len(x))[1])


def test_batch_matches_single():
    xb = np.random.default_rng(2).standard_normal((3, 22050)).astype(np.float32)
    plan = tg.CqtDbPlan(tg.SpectrogramParams(tg.StftParams(4096, 1024), SR44),
                        tg.CqtParams(12, 7, 32.703), tg.LogParams(-80.0), dtype="float32", **CPU)
    assert plan.scale_params.multirate
    batch = plan.compute_batch(xb)
    for i in range(3):
        np.testing.assert_allclose(batch[i].numpy(), plan.compute_raw(xb[i]).numpy(),
                                   rtol=0, atol=1e-4)


def test_plan_errors_match_jax():
    """The JAX texts: Nyquist, the scale params' type, and the methods that
    refuse CQT (``pallas`` and ``f32x2``); ``auto`` never picks a kernel."""
    for m, kw in ((sg, {}), (tg, CPU)):
        p = m.SpectrogramParams(m.StftParams(1024, 256), SR)
        with pytest.raises(m.InvalidInputError, match="below Nyquist"):
            m.CqtPowerPlan(p, m.CqtParams(12, 9, 55.0), **kw)
        with pytest.raises(m.InvalidInputError, match="requires CqtParams"):
            m.SpectrogramPlan(p, m.FreqScale.CQT, m.AmpScale.POWER,
                              scale_params=m.MelParams(40, 0.0, 8000.0), **kw)
        for method in ("pallas", "pallas:dif", "f32x2"):
            with pytest.raises(m.InvalidInputError, match="does not cover CQT"):
                m.CqtPowerPlan(p, m.CqtParams(12, 5, 55.0), dtype="float32", method=method, **kw)
    plan = tg.CqtPowerPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), SR),
                           tg.CqtParams(12, 5, 55.0), dtype="float32", **CPU)
    assert plan.method == "matmul" and not plan.method.startswith("pallas")


def test_one_shots_and_planner_build_cqt():
    """``compute_cqt_*`` one-shots and ``SpectrogramPlanner.cqt_plan`` build
    the same plans and match JAX (``tests/test_torch_port_plans.py`` holds
    all 15 one-shots)."""
    x = noise(44100, seed=5, dtype=np.float32)
    args = lambda m: (m.SpectrogramParams(m.StftParams(4096, 1024), SR44),
                      m.CqtParams(12, 7, 32.703))
    want = sg.compute_cqt_db_spectrogram(x, *args(sg), dtype="float32")
    got = tg.compute_cqt_db_spectrogram(x, *args(tg), dtype="float32", **CPU)
    np.testing.assert_allclose(got.to_numpy(), np.asarray(want.data), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.frequencies, want.frequencies)
    planned = tg.SpectrogramPlanner(dtype="float32", **CPU).cqt_plan(*args(tg))
    assert planned.scale_params.multirate and planned.freq_scale == tg.FreqScale.CQT
    ref = np.asarray(sg.SpectrogramPlanner(dtype="float32").cqt_plan(*args(sg)).compute_raw(x))
    np.testing.assert_allclose(planned.compute_raw(x).numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


SLICE_NAMES = ["CqtResult", "cqt", "ErbFilterbank", "gammatone_center_frequencies",
               "gammatone_iir_spectrogram", "MdctParams", "mdct", "imdct", "compute_mdct",
               "compute_imdct"]


@pytest.mark.parametrize("name", SLICE_NAMES)
def test_slice_name_is_jax_name(name):
    """Each name this slice adds is in both ``__all__``s."""
    assert name in sg.__all__ and name in tg.__all__ and hasattr(tg, name)


# ---- tests/test_cqt_erb.py's CQT cases, on the port -------------------------------------

def test_cqt_standalone_peak():
    res = tg.cqt(sine(440.0), SR, tg.CqtParams(12, 7, 32.7), 512, dtype="float64", **CPU)
    assert res.n_bins == 84
    mag = res.to_magnitude().numpy()
    peak_freq = res.frequencies[int(np.argmax(mag.mean(axis=1)))]
    assert abs(peak_freq - 440.0) / 440.0 < 0.03
    assert np.allclose(res.to_power().numpy(), mag**2, atol=1e-9)


def test_cqt_integrated_peak_and_no_double_windowing():
    x = sine(440.0)
    params = tg.SpectrogramParams(tg.StftParams(4096, 1024), SR)
    cqt_p = tg.CqtParams(12, 7, 32.7, truncate=True)
    spec = tg.compute_cqt_power_spectrogram(x, params, cqt_p, dtype="float64", **CPU)
    data = spec.to_numpy()
    k_peak = int(np.argmax(data.mean(axis=1)))
    assert abs(spec.frequencies[k_peak] - 440.0) / 440.0 < 0.03
    k_re, k_im, _ = tcq.cqt_kernel_matrices(cqt_p, SR, 4096)
    frame_idx = data.shape[1] // 2
    start = frame_idx * 1024 - 2048
    frame = x[start : start + 4096]
    direct = (k_re @ frame) ** 2 + (k_im @ frame) ** 2
    assert np.allclose(direct, data[:, frame_idx], rtol=1e-6, atol=1e-9)


def test_cqt_kernel_unit_energy():
    k_re, k_im, freqs = tcq.cqt_kernel_matrices(tg.CqtParams(12, 5, 110.0), SR, 2048)
    assert np.allclose((k_re**2 + k_im**2).sum(axis=1), 1.0, atol=1e-9)
    assert freqs[0] == pytest.approx(110.0)


def test_cqt_truncation_warns():
    params = tg.CqtParams(12, 5, 32.703)
    odd = tg.SpectrogramParams(tg.StftParams(2048, 511), SR44)
    tcq._cqt_kernels_cached.cache_clear()
    with pytest.warns(UserWarning, match="truncated"):
        tg.CqtPowerPlan(odd, params, dtype="float32", **CPU)
    tcq._cqt_kernels_cached.cache_clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tg.CqtPowerPlan(odd, params.with_truncate(True), dtype="float32", **CPU)
    tcq._cqt_kernels_cached.cache_clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tg.CqtPowerPlan(tg.SpectrogramParams(tg.StftParams(2048, 512), SR44),
                        tg.CqtParams(12, 2, 1000.0), dtype="float32", **CPU)


def test_cqt_auto_policy_elects_multirate():
    material = tg.CqtParams(12, 5, 32.703)
    assert tcq.truncation_q_loss(material, SR44, 2048) > tcq.TRUNCATION_Q_LOSS_THRESHOLD
    r = tcq.resolve_cqt_policy(material, SR44, 2048, 512, True)
    assert r.multirate and r.multirate_depth == "max"
    plan = tg.CqtPowerPlan(tg.SpectrogramParams(tg.StftParams(2048, 512), SR44), material,
                           dtype="float32", **CPU)
    assert plan.scale_params.multirate
    assert not tcq.resolve_cqt_policy(material.with_truncate(True), SR44, 2048, 512, True).multirate
    assert not tcq.resolve_cqt_policy(material, SR44, 2048, 511, True).multirate
    tiny = tg.CqtParams(12, 6, 16.35)
    assert 0 < tcq.truncation_q_loss(tiny, 16000.0, 16384) < tcq.TRUNCATION_Q_LOSS_THRESHOLD
    assert not tcq.resolve_cqt_policy(tiny, 16000.0, 16384, 4096, False).multirate
    assert tcq.resolve_cqt_policy(tiny.with_truncate(False), 16000.0, 16384, 4096, False).multirate


@pytest.mark.parametrize("n_fft,hop", [(4096, 1024), (4096, 512), (2048, 1024), (4096, 1000)])
def test_cqt_banded_matches_dense(n_fft, hop):
    x = np.random.default_rng(5).standard_normal(int(SR44))
    plan = quiet(tg.SpectrogramPlan, tg.SpectrogramParams(tg.StftParams(n_fft, hop), SR44),
                 tg.FreqScale.CQT, tg.AmpScale.POWER,
                 scale_params=tg.CqtParams(12, 7, 32.703).with_truncate(True), dtype="float64",
                 **CPU)
    k_re, k_im, _ = tcq.cqt_kernel_matrices(plan.scale_params, SR44, n_fft)
    bands = tcq.plan_cqt_bands(tcq.cqt_kernel_lengths(plan.scale_params, SR44, n_fft), n_fft, hop)
    dense = plan._forward_impl(torch.from_numpy(x)).numpy()
    plan._cqt_bands = [(a, b, s, torch.from_numpy(np.concatenate(
        [k_re[a:b, n_fft - s:].T, k_im[a:b, n_fft - s:].T], axis=1))) for a, b, s in bands]
    banded = plan._forward_impl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(banded, dense, rtol=1e-12, atol=1e-14)


def test_plan_cqt_bands_cost_model():
    lengths = tcq.cqt_kernel_lengths(tg.CqtParams(12, 7, 32.703), SR44, 4096)
    bands = tcq.plan_cqt_bands(lengths, 4096, 1024)
    assert bands[0][0] == 0 and bands[-1][1] == len(lengths)
    for (a, b, s), (a2, b2, s2) in zip(bands, bands[1:]):
        assert b == a2 and s >= s2
    for a, b, s in bands:
        assert s >= int(lengths[a:b].max())
    assert tcq.plan_cqt_bands(lengths, 4096, 1000) == [(0, len(lengths), 4096)]


def test_tail_framed_matmul_matches_slice():
    rng = np.random.default_rng(6)
    x = rng.standard_normal(5000)
    for n_fft, hop, s in [(1024, 256, 256), (1024, 256, 512), (1024, 512, 128),
                          (1024, 1024, 256), (512, 160, 128), (1024, 256, 1024)]:
        mat = rng.standard_normal((s, 7))
        frames = tfr.frame_signal(torch.from_numpy(x), n_fft, hop, True).numpy()
        got = tfr.tail_framed_matmul(torch.from_numpy(x), torch.from_numpy(mat), n_fft, hop, s,
                                     True).numpy()
        np.testing.assert_allclose(got, frames[:, n_fft - s:] @ mat, rtol=1e-12, atol=1e-12)


class TestMultirateCqt:
    P_MR = tg.CqtParams(12, 5, 32.7, q_factor=1.0, multirate=True)
    P_SR = tg.CqtParams(12, 5, 32.7, q_factor=1.0)

    def _tone(self, seconds=2.0):
        t = np.arange(int(seconds * SR)) / SR
        return np.sin(2 * np.pi * 65.4 * t) + 0.5 * np.sin(2 * np.pi * 261.6 * t)

    def test_restores_full_q_vs_untruncated_reference(self):
        x = self._tone()
        params = tg.SpectrogramParams(tg.StftParams(256, 64), SR)
        plan_mr = tg.CqtPowerPlan(params, self.P_MR, dtype="float64", **CPU)
        plan_tr = quiet(tg.CqtPowerPlan, params, self.P_SR.with_truncate(True),
                        dtype="float64", **CPU)
        plan_ref = tg.CqtPowerPlan(tg.SpectrogramParams(tg.StftParams(1024, 64), SR), self.P_SR,
                                   dtype="float64", **CPU)
        mid = slice(80, 400)
        prof = lambda plan: np.sqrt(plan.compute(x).to_numpy()[:, mid].mean(axis=1))
        pa, pb, pc = prof(plan_mr), prof(plan_ref), prof(plan_tr)
        scale = pb.max()
        assert np.abs(pa - pb).max() / scale < 5e-3
        assert np.abs(pc - pb).max() / scale > 5e-2

    def test_no_truncation_warning_and_same_shape(self):
        x = self._tone(1.0)
        params = tg.SpectrogramParams(tg.StftParams(256, 64), SR)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            plan = tg.CqtPowerPlan(params, self.P_MR, dtype="float64", **CPU)
            out = plan.compute(x)
        assert out.shape == plan.output_shape(x.shape[0])
        np.testing.assert_allclose(out.frequencies, self.P_MR.frequencies())

    def test_multirate_noop_when_kernels_fit(self):
        x = self._tone(1.0)
        params = tg.SpectrogramParams(tg.StftParams(1024, 256), SR)
        hi = tg.CqtParams(12, 2, 523.25, q_factor=1.0)
        a = tg.CqtPowerPlan(params, hi.with_multirate(), dtype="float64", **CPU).compute(x)
        b = tg.CqtPowerPlan(params, hi, dtype="float64", **CPU).compute(x)
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=1e-12, atol=1e-14)

    def test_standalone_cqt_multirate_vs_direct_formula(self):
        p_sr = tg.CqtParams(12, 6, 16.35)
        fc = 16.35
        L = int(np.round(p_sr.q_factor * SR / fc))
        assert L > 16384
        rng = np.random.default_rng(7)
        t = np.arange(32768) / SR
        x = np.sin(2 * np.pi * fc * t) + 0.1 * rng.standard_normal(t.size)
        r_mr = tg.cqt(x, SR, p_sr.with_multirate(), hop_size=4096, dtype="float64", **CPU)
        r_tr = quiet(tg.cqt, x, SR, p_sr.with_truncate(True), hop_size=4096, dtype="float64",
                     **CPU)
        w = tg.make_window(p_sr.window, L, np.float64)
        kern = np.exp(2j * np.pi * fc * np.arange(L) / SR) * w
        mags = np.abs(kern)
        kern = np.where(mags < mags.max() * p_sr.sparsity_threshold, 0.0, kern)
        kern = kern / np.sqrt(np.sum(np.abs(kern) ** 2))
        direct = []
        for i in range(r_mr.n_frames):
            end = 16384 + i * 4096
            seg = np.zeros(L)
            lo = max(0, end - L)
            seg[L - (end - lo):] = x[lo:end]
            direct.append(np.sum(seg * np.conj(kern)))
        direct = np.asarray(direct)
        got, trunc = r_mr.to_numpy()[0], r_tr.to_numpy()[0]
        scale = np.abs(direct).max()
        assert np.abs(got - direct).max() / scale < 2e-2
        assert np.abs(trunc - direct).max() / scale > 1e-1

    def test_batch_and_f32(self):
        x = self._tone(1.0).astype(np.float32)
        plan = tg.CqtPowerPlan(tg.SpectrogramParams(tg.StftParams(256, 64), SR), self.P_MR,
                               dtype="float32", **CPU)
        fb = plan.compute_batch(np.stack([x, 0.5 * x])).numpy()
        f0 = plan.compute(x).to_numpy()
        assert fb.shape == (2,) + plan.output_shape(x.shape[0])
        np.testing.assert_allclose(fb[0], f0, rtol=1e-5, atol=1e-6 * np.abs(f0).max())
        np.testing.assert_allclose(fb[1], 0.25 * fb[0], rtol=1e-4, atol=1e-6 * np.abs(f0).max())


class TestMultirateMaxDepth:
    def _music(self, seconds=3.0, seed=11):
        rng = np.random.default_rng(seed)
        t = np.arange(int(seconds * SR44)) / SR44
        return (np.sin(2 * np.pi * 65.4 * t) + 0.7 * np.sin(2 * np.pi * 261.6 * t)
                + 0.5 * np.sin(2 * np.pi * 1046.5 * t) + 0.05 * rng.standard_normal(t.size))

    def test_max_depth_matches_min_depth(self):
        x = self._music()
        params = tg.SpectrogramParams(tg.StftParams(4096, 1024), SR44)
        cqt = tg.CqtParams(12, 7, 32.703)
        a = tg.CqtPowerPlan(params, cqt.with_multirate(), dtype="float64", **CPU).compute(x)
        b = tg.CqtPowerPlan(params, cqt.with_multirate(depth="max"), dtype="float64",
                            **CPU).compute(x)
        a, b = a.to_numpy(), b.to_numpy()
        assert a.shape == b.shape and np.abs(a - b).max() / a.max() < 4e-2
        L0 = cqt.q_factor * SR44 / 32.703
        ss = slice(int(np.ceil((L0 - 2048) / 1024)), a.shape[1] - 2)
        en = a[:, ss] > 0.01 * a.max()
        assert en.any()
        assert (np.abs(a[:, ss] - b[:, ss])[en] / a[:, ss][en]).max() < 4e-2
        assert np.abs(a[:, ss] - b[:, ss])[~en].max() / a.max() < 2e-3

    def test_max_depth_deepens_and_shrinks_frames(self):
        cqt = tg.CqtParams(12, 7, 32.703)
        g_min, f_min = tcq.multirate_cqt_groups(cqt, SR44, 4096, 1024, True)
        g_max, f_max = tcq.multirate_cqt_groups(cqt, SR44, 4096, 1024, True, depth="max")
        np.testing.assert_array_equal(f_min, f_max)
        assert max(d for d, *_ in g_max) > max(d for d, *_ in g_min)
        assert all(flen == 4096 for _, _, _, flen, _ in g_min)
        assert any(flen < 4096 for _, _, _, flen, _ in g_max)
        for d, k_ri, e0, flen, jp in g_max:
            assert k_ri.shape[0] == (flen if jp == 1 else flen + jp * (1024 >> d))
        assert sum(k.shape[1] // (2 * jp) for _, k, _, _, jp in g_max) == len(f_max)

    def test_bad_depth_rejected(self):
        with pytest.raises(tg.InvalidInputError, match="multirate_depth"):
            tg.CqtParams(12, 7, 32.703, multirate_depth="deep")


@pytest.mark.parametrize("sr,n_fft,hop,f_min,bpo,octaves", [
    (44100.0, 4096, 1024, 32.703, 12, 7),
    (44100.0, 2048, 512, 65.41, 12, 6),
    (22050.0, 2048, 512, 32.703, 12, 6),
    (48000.0, 4096, 2048, 55.0, 24, 5),
])
def test_max_depth_equivalence_sweep(sr, n_fft, hop, f_min, bpo, octaves):
    rng = np.random.default_rng(5)
    t = np.arange(int(2.5 * sr)) / sr
    x = (np.sin(2 * np.pi * 2.0 * f_min * t) + 0.6 * np.sin(2 * np.pi * 8.1 * f_min * t)
         + 0.02 * rng.standard_normal(t.size))
    params = tg.SpectrogramParams(tg.StftParams(n_fft, hop), sr)
    cqt = tg.CqtParams(bpo, octaves, f_min)
    a = tg.CqtPowerPlan(params, cqt.with_multirate(), dtype="float64", **CPU).compute(x).to_numpy()
    b = tg.CqtPowerPlan(params, cqt.with_multirate(depth="max"), dtype="float64",
                        **CPU).compute(x).to_numpy()
    assert a.shape == b.shape
    L0 = cqt.q_factor * sr / f_min
    first_full = max(0, int(np.ceil((L0 - n_fft // 2) / hop)))
    ss = slice(first_full, max(first_full + 1, a.shape[1] - 2))
    en = a[:, ss] > 0.01 * a.max()
    assert en.any()
    assert (np.abs(a[:, ss] - b[:, ss])[en] / a[:, ss][en]).max() < 5e-2
    assert np.abs(a[:, ss] - b[:, ss])[~en].max() / a.max() < 5e-3
