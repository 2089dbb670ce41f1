"""The bf16 precision tiers and the ``pallas:<opt>`` forms, against the JAX package.

The tier kernel (``csrc/fused_tier_features.cu``) runs only on a GPU, where
``chip_smoke.py`` holds it against its plain version. Here, on the CPU, the
plain version ``fused_tier_features_reference`` (the tier runner's CPU path)
is held against the JAX package's Pallas kernel in interpret mode, tier by
tier, and the port's plans against the JAX plans at ``precision=DEFAULT``,
``pallas:x2`` and the variant forms, at ``tests/test_pallas.py``'s
tolerances. The host-side layout (fold, fragments, tiles) is checked too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.mfcc import MfccPlan as JaxMfccPlan
from spectrograms_tpu.mfcc import _dct_lifter_matrix
from spectrograms_tpu.ops import pallas_factored as jpf
from spectrograms_tpu.ops.filterbanks import chroma_filterbank, mel_filterbank
from spectrograms_tpu_torch.mfcc import MfccPlan as PortMfccPlan
from spectrograms_tpu_torch.ops import factored_layout as fl
from spectrograms_tpu_torch.ops import fused_factored as tff
from spectrograms_tpu_torch.ops import tier_layout as tl
from tests.conftest import noise

SR = 16000.0
MEL128 = (128, 0.0, 8000.0)


def _precision(m, name):
    return None if name is None else getattr(tg.Precision if m is tg else jax.lax.Precision, name)


def mel_plan(m, amp, method, precision=None):
    kw = dict(device="cpu") if m is tg else {}
    return m.SpectrogramPlan(
        m.SpectrogramParams(m.StftParams(1024, 256), SR), m.FreqScale.MEL,
        m.AmpScale.DECIBELS if amp == "db" else m.AmpScale.POWER,
        scale_params=m.MelParams(*MEL128, m.MelNorm.SLANEY),
        log_params=m.LogParams(-80.0) if amp == "db" else None,
        dtype="float32", method=method, precision=_precision(m, precision), **kw,
    )


def mfcc_plan(m, method, precision=None):
    cls, kw = (PortMfccPlan, dict(device="cpu")) if m is tg else (JaxMfccPlan, {})
    return cls(
        m.StftParams(1024, 256), SR, mel_params=m.MelParams(*MEL128, m.MelNorm.SLANEY),
        mfcc_params=m.MfccParams(40), log_params=m.LogParams(-80.0), dtype="float32",
        method=method, precision=_precision(m, precision), **kw,
    )


# ---- the factory's errors ---------------------------------------------------

# (kwargs, message): the JAX factory's bad combinations (pallas_factored.py
# :567-577). column_prune truncates only where the mapping reads <= 64 k1
# columns of the complex classes: chroma at 44.1 kHz reads 25.
BAD_COMBINATIONS = [
    (dict(dif=True, column_prune=True), "mutually exclusive"),
    (dict(gauss=True, dif=True), "incompatible"),
    (dict(gauss=True, column_prune=True), "incompatible"),
    (dict(x3_stack=True, precision="bf16"), "bf16x3"),
    (dict(x3_stack=True, precision="bf16x2"), "bf16x3"),
    (dict(precision="bf16x4"), "unknown precision"),
]


@pytest.mark.parametrize("kwargs,message", BAD_COMBINATIONS)
def test_factory_errors_match_jax(kwargs, message):
    fb = chroma_filterbank(44100.0, 4096, sg.ChromaParams())
    common = dict(amp="power", pre_amp="magnitude")
    with pytest.raises(sg.InvalidInputError, match=message):
        jpf.fused_factored_features(4096, 1024, None, jpf.KernelConst(fb), interpret=True,
                                    **common, **kwargs)
    with pytest.raises(tg.InvalidInputError, match=message):
        tff.fused_factored_features(4096, 1024, None, tff.KernelConst(fb), device="cpu",
                                    **common, **kwargs)


def test_factory_dispatches_tiers_and_forms():
    """bf16x3 (and every form at it) takes the f32 kernel's runner; bf16 and
    bf16x2 take the tier kernel's, Gauss by default at 1 pass only, and the
    dif/prune forms run the packed product."""
    fb = tff.KernelConst(mel_filterbank(SR, 1024, sg.MelParams(*MEL128, sg.MelNorm.SLANEY)))
    make = lambda **kw: tff.fused_factored_features(1024, 256, None, fb, device="cpu", **kw)
    tier = lambda precision, gauss: tff.fused_tier_features(
        1024, 256, None, fb, "power", -80.0, True, None, "none", "cpu", precision, gauss)
    assert make(precision="bf16") is tier("bf16", True)
    assert make(precision="bf16", gauss=False) is tier("bf16", False)
    assert make(precision="bf16x2") is tier("bf16x2", False)
    assert make(precision="bf16x2", gauss=True) is tier("bf16x2", True)
    assert make(precision="bf16", dif=True) is tier("bf16", False)
    for kw in (dict(), dict(gauss=True), dict(dif=True), dict(x3_stack=True),
               dict(column_prune=True)):
        run = make(precision="bf16x3", **kw)
        assert run is not tier("bf16", True) and run is not tier("bf16x2", False)
        np.testing.assert_array_equal(run(torch.ones(4000)).numpy(), make()(torch.ones(4000)).numpy())


# ---- host-side layout ------------------------------------------------------

FOLD_CASES = {
    "mel-128 1024": (1024, lambda: mel_filterbank(SR, 1024, sg.MelParams(*MEL128, sg.MelNorm.SLANEY))),
    "mel-40 512": (512, lambda: mel_filterbank(SR, 512, sg.MelParams(40, 0.0, 8000.0, sg.MelNorm.SLANEY))),
    "identity 512": (512, lambda: np.eye(257)),
    "chroma 4096": (4096, lambda: chroma_filterbank(22050.0, 4096, sg.ChromaParams())),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_folded_mapping_reads_the_class_layout(case):
    """The (c, k1) layout of a real signal's power times the folded mapping
    equals power @ fb.T: natural bin c + r k1 sits at slot (c, k1), and the
    mirrored slots (c > r/2) fold onto (r - c, 127 - k1)."""
    n_fft, make_fb = FOLD_CASES[case]
    fb = make_fb()
    r, n_bins = n_fft // 128, n_fft // 2 + 1
    power = np.random.default_rng(31).exponential(size=(6, n_bins))
    full = np.concatenate([power, power[:, n_bins - 2:0:-1]], axis=1)   # |X[N-k]| = |X[k]|
    c, k1 = np.meshgrid(np.arange(r // 2 + 1), np.arange(128), indexing="ij")
    layout = full[:, (c + r * k1).ravel()]                              # (6, classes*128)
    np.testing.assert_allclose(layout @ fl.fold_mapping(fb, n_fft), power @ fb.T,
                               rtol=1e-12, atol=1e-12 * np.abs(power @ fb.T).max())


def test_split_and_constants_are_the_jax_ones():
    a = np.random.default_rng(32).standard_normal((64, 96)) * 1e3
    hi, lo = fl.split_bf16(a)
    j_hi, j_lo = jpf._split_bf16(a)
    np.testing.assert_array_equal(hi, np.asarray(j_hi, np.float32))
    np.testing.assert_array_equal(lo, np.asarray(j_lo, np.float32))
    xs = [np.random.default_rng(n).standard_normal((3, 128)).astype(np.float32) for n in range(8)]
    for (re, im), (j_re, j_im) in zip(fl.real_fft_classes(xs), jpf._real_fft_classes(xs)):
        np.testing.assert_array_equal(re, j_re)
        assert (im is None) == (j_im is None)
        if im is not None:
            np.testing.assert_array_equal(im, j_im)
    fb = chroma_filterbank(44100.0, 4096, sg.ChromaParams())
    assert fl.needed_complex_k1(fb, 32) == jpf._needed_complex_k1(fb, 32)
    assert len(fl.needed_complex_k1(fb, 32)) == 25


def test_mma_b_fragments_follow_the_mma_layout():
    """Lane l = 4g + t holds B[16ks + 2t + (0, 1, 8, 9), 8nt + g]: the B
    operand layout of mma.m16n8k16.row.col, lower k in the lower half."""
    b = fl.split_bf16(np.random.default_rng(33).standard_normal((32, 24)))[0]
    frag = fl.mma_b_fragments(b)
    assert frag.shape == (2, 3, 32, 4) and frag.dtype == np.uint16
    as_f32 = lambda bits: (bits.astype(np.uint32) << 16).view(np.float32)
    rebuilt = np.full_like(b, np.nan)
    for ks in range(2):
        for nt in range(3):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                rebuilt[16 * ks + 2 * t + np.array([0, 1, 8, 9]), 8 * nt + g] = as_f32(frag[ks, nt, lane])
    np.testing.assert_array_equal(rebuilt, b)
    with pytest.raises(ValueError):
        fl.mma_b_fragments(np.zeros((24, 8), np.float32))
    with pytest.raises(ValueError):
        fl.bf16_bits(np.full((16, 8), 0.1, np.float32))    # not a bf16 value


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("gauss", [True, False])
@pytest.mark.parametrize("x2", [True, False])
def test_tier_tiles_fit_in_shared_memory(n_fft, gauss, x2):
    """The tier kernel's block (``tier_layout``) at every n_fft, form and
    tier, with the power tile at its largest (every class, every n-tile)
    and a DCT over 0, 128 or 2064 rows: it fits, its class groups cover the
    complex classes in order, and no fewer groups would fit."""
    r = n_fft // 128
    kc = (r // 2 + 1) * 128
    for kd in (0, 128, 2064 if n_fft < 4096 else 0):
        for hop in (n_fft // 4, n_fft):
            lay = tl.tier_layout(n_fft, hop, gauss, x2, kc, kd)
            assert lay.tile_f in tl.TILES and lay.smem <= tl.MAX_SMEM and lay.blocks >= 1
            cover = [c for c0, c1 in lay.groups for c in range(c0, c1)]
            assert cover == list(range(1, r // 2))
            assert lay.ar_off % 16 == lay.ac_off % 16 == lay.p_off % 16 == lay.feat_off % 16 == 0
            if len(lay.groups) > 1:            # one group fewer does not fit
                fewer = -(-(r // 2 - 1) // (len(lay.groups) - 1))
                assert tl._layout(16, n_fft, hop, gauss, x2, kc, kd, fewer,
                                  lay.staged).smem > tl.MAX_SMEM
    # The flagship at 1 pass: 16 frames, every class in one group, the span
    # staged (and reused by P), three blocks an SM; at x2 (packed) three too.
    for g, x in ((True, False), (False, True)):
        lay = tl.tier_layout(1024, 256, g, x, 512, 128)
        assert (lay.tile_f, lay.groups, lay.staged, lay.blocks) == (16, ((1, 4),), True, 3)
    with pytest.raises(tg.InvalidInputError):
        tl.tier_layout(4096, 1024, True, True, 2176, 4096)


# ---- the plain version against the JAX kernel, tier by tier ---------------

GEOMETRIES = {
    # name: (n_fft, hop, sr, mapping, amp, pre_amp, dct, n_samples, kind)
    "flagship MFCC-40": (1024, 256, SR, lambda: mel_filterbank(SR, 1024, sg.MelParams(*MEL128, sg.MelNorm.SLANEY)),
                         "decibels", "none", lambda: _dct_lifter_matrix(128, 40, 22), 16000, "mfcc"),
    "mel-128 dB": (1024, 256, SR, lambda: mel_filterbank(SR, 1024, sg.MelParams(*MEL128, sg.MelNorm.SLANEY)),
                   "decibels", "none", None, 16000, "db"),
    "mel-40 dB 512/160": (512, 160, SR, lambda: mel_filterbank(SR, 512, sg.MelParams(40, 0.0, 8000.0, sg.MelNorm.SLANEY)),
                          "decibels", "none", None, 16000, "db"),
    "identity power 512/128": (512, 128, SR, lambda: "identity", "power", "none", None, 16000, "power"),
    "chroma 4096/1024": (4096, 1024, 22050.0, lambda: chroma_filterbank(22050.0, 4096, sg.ChromaParams()),
                         "power", "magnitude", None, 11025, "chroma"),
}
TIERS = {"bf16 Gauss": ("bf16", None), "bf16 packed": ("bf16", False), "bf16x2": ("bf16x2", None)}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_tier_reference_matches_the_jax_kernel(geometry, tier):
    """Tolerances are test_pallas.py's for each output. Measured maxima
    (port vs JAX, this test's inputs, relative to max|ref| unless dB), for
    bf16 Gauss / bf16 packed / bf16x2: flagship MFCC 8.5e-4 / 1.7e-7 /
    2.2e-6; mel-128 dB 7.2e-3 / 4.1e-5 / 4.0e-5 dB; mel-40 dB 3.3e-3 /
    2.8e-3 / 1.9e-4 dB; identity power 9.2e-4 / 9.2e-4 / 1.6e-4; chroma
    2.0e-5 / 3.0e-7 / 3.0e-7. The remaining differences are bf16 roundings
    flipped by f32 sums taken in another order."""
    n_fft, hop, sr, make_fb, amp, pre_amp, make_dct, n, kind = GEOMETRIES[geometry]
    precision, gauss = TIERS[tier]
    fb, dct = make_fb(), None if make_dct is None else make_dct()
    win = tuple(sg.make_window("hann", n_fft).tolist())
    x = noise(n, seed=3, dtype=np.float32)
    common = dict(amp=amp, centre=True, pre_amp=pre_amp, precision=precision, gauss=gauss)
    jkey = fb if isinstance(fb, str) else jpf.KernelConst(fb)
    ref = np.asarray(jpf.fused_factored_features(
        n_fft, hop, win, jkey, dct_key=None if dct is None else jpf.KernelConst(dct),
        interpret=True, **common)(jnp.asarray(x)))
    tkey = fb if isinstance(fb, str) else tff.KernelConst(fb)
    before = tff.fused_tier_features.launches
    out = tff.fused_factored_features(
        n_fft, hop, win, tkey, dct_key=None if dct is None else tff.KernelConst(dct),
        device="cpu", **common)(torch.from_numpy(x)).numpy()
    assert tff.fused_tier_features.launches == before     # CPU: the plain version
    assert out.shape == ref.shape
    peak = np.abs(ref).max()
    if kind == "mfcc":
        np.testing.assert_allclose(out, ref, rtol=0, atol=5e-3 * peak)
    elif kind == "db":
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)
    elif kind == "power":
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3 * peak)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * peak)


# ---- the plans: the DEFAULT parity repair, x2 and the forms ---------------

# (output, method, precision). At DEFAULT the JAX plans run the 1-pass bf16
# tier and pallas:x2 the 2-pass tier; the forms run at HIGH, the default.
PLAN_CASES = [
    (out, method, precision)
    for out in ("mel power", "mel dB", "MFCC")
    for method, precision in (("pallas", "DEFAULT"), ("pallas:x2", None),
                              ("pallas:gauss", None), ("pallas:dif", None),
                              ("pallas:prune", None), ("pallas:stack", None))
]


@pytest.mark.parametrize("output,method,precision", PLAN_CASES)
def test_plans_match_jax_plans(output, method, precision):
    """The repair of the DEFAULT parity fault: a port plan computes what the
    same JAX plan computes, at test_pallas.py's tolerance for that output."""
    x = noise(16000, seed=3, dtype=np.float32)
    if output == "MFCC":
        xb = np.stack([x, noise(16000, seed=30, dtype=np.float32)])
        jplan = mfcc_plan(sg, method, precision)
        tplan = mfcc_plan(tg, method, precision)
        ref = np.asarray(jplan.compute_batch(xb))
        out = tplan.compute_batch(xb).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=5e-3 * np.abs(ref).max())
        return
    amp = "db" if output == "mel dB" else "power"
    jplan = mel_plan(sg, amp, method, precision)
    tplan = mel_plan(tg, amp, method, precision)
    assert jplan.method.startswith("pallas") and tplan.method.startswith("pallas")
    ref = np.asarray(jplan.compute_raw(x))
    out = tplan.compute_raw(x).numpy()
    if amp == "db":
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3 * np.max(ref))


def test_auto_takes_the_tier_kernel_at_default_on_cuda(monkeypatch):
    """``auto`` at DEFAULT resolves as in the JAX package on a TPU: the
    kernel, whose tier the precision then picks."""
    from spectrograms_tpu import pipeline as jpl
    from spectrograms_tpu_torch import pipeline as tpl

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = jpl._resolve_method("auto", 1024, 256, np.float32, sg.FreqScale.MEL,
                               jax.lax.Precision.DEFAULT)
    got = tpl._resolve_method("auto", 1024, 256, torch.float32, tg.FreqScale.MEL,
                              tg.Precision.DEFAULT, torch.device("cuda"))
    assert got == want == "pallas"
    assert tpl.kernel_kwargs(got, tg.Precision.DEFAULT) == {"precision": "bf16"}
    assert tpl.kernel_kwargs(got, tg.Precision.HIGH) == {"precision": "bf16x3"}
    assert tpl.kernel_kwargs("pallas:x2+dif", tg.Precision.DEFAULT) == {
        "precision": "bf16x2", "dif": True}
    assert tpl.kernel_kwargs("matmul", tg.Precision.DEFAULT) == {}


class TestTierContract:
    """The counterpart of test_pallas.py::TestBf16x2Tier on the port."""

    def test_x2_between_tiers(self):
        x = noise(16000, seed=3, dtype=np.float32)
        ref = mel_plan(tg, "power", "matmul", "HIGHEST").compute_raw(x).numpy()

        def err(method, precision=None):
            out = mel_plan(tg, "power", method, precision).compute_raw(x).numpy()
            return np.abs(out - ref).max() / ref.max()

        e1, e2, e3 = err("pallas", "DEFAULT"), err("pallas:x2"), err("pallas", "HIGH")
        assert e3 < e2 < e1, (e1, e2, e3)
        assert e2 < 2e-3
        assert e2 < e1 / 2

    def test_x2_overrides_plan_precision(self):
        x = noise(8000, seed=5, dtype=np.float32)
        a = mel_plan(tg, "power", "pallas:x2", "DEFAULT").compute_raw(x).numpy()
        b = mel_plan(tg, "power", "pallas:x2", "HIGH").compute_raw(x).numpy()
        np.testing.assert_array_equal(a, b)

    def test_stack_requires_x3(self):
        with pytest.raises(tg.InvalidInputError, match="bf16x3"):
            mel_plan(tg, "power", "pallas:x2+stack")
        with pytest.raises(tg.InvalidInputError, match="bf16x3"):
            mel_plan(tg, "power", "pallas:stack", "DEFAULT")


def test_default_gradient_is_the_f32_plain_paths():
    """At DEFAULT the forward is the tier kernel (here its plain version);
    the backward differentiates the f32 plain path, as JAX's
    pallas_forward_xla_grad does."""
    rng = np.random.default_rng(34)
    x = np.stack([noise(16000, seed=35, dtype=np.float32), noise(16000, seed=36, dtype=np.float32)])
    w = torch.from_numpy(rng.standard_normal((2, 40, 63)).astype(np.float32))
    plan = mfcc_plan(tg, "pallas", "DEFAULT")
    a = torch.from_numpy(x).requires_grad_(True)
    (plan.compute_batch(a) * w).sum().backward()
    b = torch.from_numpy(x).requires_grad_(True)
    (plan._plain_forward(b) * w).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
    jp = mfcc_plan(sg, "matmul")
    g_ref = np.asarray(jax.grad(lambda v: jnp.sum(jp.compute_batch(v) * w.numpy()))(jnp.asarray(x)))
    np.testing.assert_allclose(a.grad.numpy(), g_ref, rtol=0, atol=1e-4 * np.abs(g_ref).max())


def test_tier_constants_carried_across_rebuild_the_kernel():
    """plan_constants_from_numpy rebuilds a DEFAULT plan's tier constants: a
    doubled filterbank is +3 dB through the tier path too."""
    x = noise(16000, seed=37, dtype=np.float32)
    j = mel_plan(sg, "db", "pallas", "DEFAULT")
    t = mel_plan(tg, "db", "pallas", "DEFAULT")
    ref = np.asarray(j.compute_raw(x))
    win, fb = np.asarray(j._window), np.asarray(j._mapping_t).T
    np.testing.assert_allclose(tg.plan_constants_from_numpy(t, win, fb).compute_raw(x).numpy(),
                               ref, rtol=0, atol=2e-2)
    doubled = tg.plan_constants_from_numpy(t, win, 2.0 * fb).compute_raw(x).numpy()
    np.testing.assert_allclose(doubled, ref + 10 * np.log10(2.0), rtol=0, atol=2e-2)
