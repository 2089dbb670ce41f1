"""``tests/test_differentiability.py`` held on the port, on the CPU.

Gradients through the port's feature pipelines with ``torch.autograd``
(and ``torch.func`` where the JAX test composes ``vmap``), against
``jax.grad`` of the same JAX function on the same numpy input. The JAX
tests check that gradients exist and are finite; the port's are also held
to JAX's values: at float64, where both packages' sums agree to rounding,
to rtol 1e-6 of the largest gradient; the kernel route against ``matmul``
at the JAX test's rtol/atol 1e-3. ``test_grad_through_fused_mfcc_plan``
is held by ``tests/test_torch_port_pipeline.py::test_mfcc_gradient_matches_jax_grad``
(the kernel route's MFCC gradient against ``jax.grad``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from tests.conftest import sine

SR = 16000.0
CPU = dict(device="cpu")


def params(m):
    return m.SpectrogramParams(m.StftParams(512, 128), SR)


def mel(m, n=64):
    return m.MelParams(n, 0.0, 8000.0, m.MelNorm.SLANEY)


def grad_of(fn, x: np.ndarray) -> np.ndarray:
    """d fn / d x by torch.autograd, ``fn`` taking and returning tensors."""
    t = torch.from_numpy(x).requires_grad_(True)
    fn(t).backward()
    return t.grad.numpy()


def assert_grads_match(g, g_ref, rtol=1e-6):
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=rtol * float(np.abs(g_ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grad_through_mel_db(dtype):
    """``test_differentiability.py::test_grad_through_mel_db``: the gradient
    of mean(mel-dB²) has the signal's shape, is finite and nonzero; at
    float64 it equals ``jax.grad`` of the JAX plan's ``_forward_impl``."""
    x = sine(440.0, dtype=np.dtype(dtype))
    plan = tg.MelDbPlan(params(tg), mel(tg), tg.LogParams(-80.0), dtype=dtype, **CPU)
    g = grad_of(lambda s: (plan._forward_impl(s) ** 2).mean(), x)
    assert g.shape == x.shape and np.all(np.isfinite(g)) and np.abs(g).max() > 0
    if dtype == "float64":
        jplan = sg.MelDbPlan(params(sg), mel(sg), sg.LogParams(-80.0), dtype=dtype)
        g_ref = np.asarray(jax.grad(lambda s: jnp.mean(jplan._forward_impl(s) ** 2))(
            jnp.asarray(x)))
        assert_grads_match(g, g_ref)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grad_through_mfcc(dtype):
    """``test_differentiability.py::test_grad_through_mfcc``: the gradient
    of sum|MFCC-13| is finite; at float64 it equals JAX's."""
    x = sine(300.0, dtype=np.dtype(dtype))
    plan = tg.MfccPlan(params(tg).stft, SR, mel_params=mel(tg), mfcc_params=tg.MfccParams(13),
                       dtype=dtype, **CPU)
    g = grad_of(lambda s: plan._forward(s).abs().sum(), x)
    assert np.all(np.isfinite(g))
    if dtype == "float64":
        from spectrograms_tpu.mfcc import MfccPlan

        jplan = MfccPlan(params(sg).stft, SR, mel_params=mel(sg), mfcc_params=sg.MfccParams(13),
                         dtype=dtype)
        g_ref = np.asarray(jax.grad(lambda s: jnp.sum(jnp.abs(jplan._forward.__wrapped__(s))))(
            jnp.asarray(x)))
        assert_grads_match(g, g_ref)


def test_grad_through_istft_roundtrip():
    """``test_differentiability.py::test_grad_through_istft_roundtrip``: the
    gradient of mean(istft(S)²) with respect to a complex STFT has its
    shape and is finite; it is JAX's gradient conjugated (torch reports
    ∂L/∂Re + i·∂L/∂Im, JAX ∂L/∂Re − i·∂L/∂Im)."""
    x = sine(440.0, dtype=np.float64)
    spec = np.array(sg.stft(x, 512, 128))
    s = torch.from_numpy(spec).requires_grad_(True)
    (tg.istft(s, 512, 128, **CPU) ** 2).mean().backward()
    g = s.grad.numpy()
    assert g.shape == spec.shape and np.all(np.isfinite(np.abs(g)))
    g_ref = np.asarray(jax.grad(lambda v: jnp.mean(sg.istft(v, 512, 128) ** 2))(
        jnp.asarray(spec)))
    assert_grads_match(g, np.conj(g_ref))


def test_trainable_mel_filterbank():
    """``test_differentiability.py::test_trainable_mel_filterbank``: a mel
    filterbank learned by 120 normalized projected-gradient steps halves the
    loss; the first gradient equals JAX's at rtol 1e-3 of its largest entry
    (f32 framed products summed in other orders)."""
    from spectrograms_tpu.ops.dft import rdft_matrices as jax_rdft
    from spectrograms_tpu.ops.framing import frame_signal as jax_frames
    from spectrograms_tpu_torch.ops.dft import rdft_matrices
    from spectrograms_tpu_torch.ops.framing import frame_signal

    x32 = sine(1000.0, dtype=np.float32)
    w64 = tg.make_window(tg.WindowType.HANNING, 512, np.float64)
    fb0 = tg.mel_filterbank(SR, 512, mel(tg)).astype(np.float32)
    C, S = rdft_matrices(512, w64, torch.float32, "cpu")
    x = torch.from_numpy(x32)

    def features(fb):
        fr = frame_signal(x, 512, 128, True)
        return torch.log1p(((fr @ C) ** 2 + (fr @ S) ** 2) @ fb.T)

    target = features(torch.from_numpy(fb0)).detach() * 0.5

    def loss(fb):
        return ((features(fb) - target) ** 2).mean()

    jC, jS = jax_rdft(512, w64, np.float32)
    jx = jnp.asarray(x32)

    def jloss(fb):
        fr = jax_frames(jx, 512, 128, True)
        f = jnp.log1p((jnp.matmul(fr, jC) ** 2 + jnp.matmul(fr, jS) ** 2) @ fb.T)
        return jnp.mean((f - target.numpy()) ** 2)

    fb = torch.from_numpy(fb0).requires_grad_(True)
    l0 = float(loss(fb).detach())
    g0 = torch.autograd.grad(loss(fb), fb)[0].numpy()
    assert_grads_match(g0, np.asarray(jax.grad(jloss)(jnp.asarray(fb0))), rtol=1e-3)
    for _ in range(120):
        g = torch.autograd.grad(loss(fb), fb)[0]
        with torch.no_grad():
            fb = (fb - 2e-3 * g / (g.abs().max() + 1e-12)).clamp_min(0.0)
        fb.requires_grad_(True)
    assert float(loss(fb).detach()) < 0.5 * l0


def test_vmap_jit_compose():
    """``test_differentiability.py::test_vmap_jit_compose``: ``torch.func.vmap``
    of the plan's pure function over a batch of two equals JAX's
    ``jit(vmap(...))`` (3e-2 dB, ``tests/test_equivalence_sweep.py``'s f32
    bar: the tones leave bands near the floor, where two f32 sums in other
    orders part by ~1e-2 dB), and the gradient of its sum
    through ``torch.func.grad`` has the batch's shape."""
    xb = np.stack([sine(f, dtype=np.float32) for f in (220.0, 440.0)])
    plan = tg.MelDbPlan(params(tg), mel(tg), tg.LogParams(-80.0), dtype="float32", **CPU)
    out = torch.func.vmap(plan._forward_impl)(torch.from_numpy(xb))
    assert out.shape[0] == 2
    jplan = sg.MelDbPlan(params(sg), mel(sg), sg.LogParams(-80.0), dtype="float32")
    ref = np.asarray(jax.jit(jax.vmap(jplan._forward_impl))(jnp.asarray(xb)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=3e-2)
    g = torch.func.grad(lambda b: torch.func.vmap(plan._forward_impl)(b).sum())(
        torch.from_numpy(xb))
    assert g.shape == xb.shape


def test_grad_through_pallas_plan_matches_matmul():
    """``test_differentiability.py::test_grad_through_pallas_plan_matches_matmul``:
    the kernel route differentiates (kernel forward, plain backward), and
    its gradient of sum(mel-dB²) equals the ``matmul`` route's at the JAX
    test's rtol/atol 1e-3, and JAX's kernel route's gradient."""
    x = np.random.default_rng(0).standard_normal(4000).astype(np.float32)

    def plan(m, method):
        kw = CPU if m is tg else {}
        return m.MelDbPlan(params(m), mel(m, 40), m.LogParams(-80.0), dtype="float32",
                           method=method, **kw)

    g_pal = grad_of(lambda s: (plan(tg, "pallas")._forward(s) ** 2).sum(), x)
    g_ref = grad_of(lambda s: (plan(tg, "matmul")._forward(s) ** 2).sum(), x)
    assert np.all(np.isfinite(g_pal))
    np.testing.assert_allclose(g_pal, g_ref, rtol=1e-3, atol=1e-3 * np.abs(g_ref).max())
    jpal = plan(sg, "pallas")
    g_jax = np.asarray(jax.grad(lambda s: jnp.sum(jpal._forward(s) ** 2))(jnp.asarray(x)))
    np.testing.assert_allclose(g_pal, g_jax, rtol=1e-3, atol=1e-3 * np.abs(g_jax).max())
