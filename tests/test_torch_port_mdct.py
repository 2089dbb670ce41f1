"""The port's MDCT against the JAX package's, on the CPU.

- ``tests/test_mdct.py``'s cases re-run on the port, at their tolerances
  (1e-10 against the direct formula and the independent DCT-IV/FFT check,
  1e-9 reconstruction at f64, 1e-3 at f32);
- ``mdct``/``imdct`` (dense and folded, f32 and f64, ``compute_*``
  aliases) against ``sg.mdct``/``sg.imdct`` on the same seeded input: 1e-10
  of the peak at f64, 1e-4 of the peak at f32 (``tests/test_torch_port_plans.py``'s
  f32 bar); the bases equal to JAX's, and the JAX bases handed to the
  port's private impls;
- the batched private impls against a loop of the public functions (how
  ``benchmarks/suite.py`` config 4's member runs a batch).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from tests.conftest import sine

# the modules: both packages rebind the name ``mdct`` to the function
jm = importlib.import_module("spectrograms_tpu.mdct")
tm = importlib.import_module("spectrograms_tpu_torch.mdct")

CPU = dict(device="cpu")


def pair(two_n, hop=None, window=None):
    """The same MdctParams in both packages (the sine window by default)."""
    out = []
    for m in (sg, tg):
        base = m.MdctParams.sine_window(two_n)
        w = base.window if window is None else m.WindowType.custom(list(window))
        out.append(m.MdctParams(two_n, hop if hop is not None else two_n // 2, w))
    return out


# ---- tests/test_mdct.py on the port --------------------------------------------------

def test_params_validation():
    with pytest.raises(tg.InvalidInputError):
        tg.MdctParams(15, 8)
    with pytest.raises(tg.InvalidInputError):
        tg.MdctParams(2, 1)
    with pytest.raises(tg.InvalidInputError, match="hop_size"):
        tg.MdctParams(16, 0)
    p = tg.MdctParams.sine_window(1024)
    assert p.hop_size == 512 and p.n_coefficients == 512
    w = np.asarray(p.window.coefficients)
    assert np.allclose(w[:512] ** 2 + w[512:] ** 2, 1.0, atol=1e-12)
    assert tg.MdctParams(16, 8, "hamming").window == tg.parse_window("hamming")
    for bad in (15, 2):
        with pytest.raises(tg.InvalidInputError):
            tg.MdctParams.sine_window(bad)


def test_shapes():
    n_samples, window_size = 8192, 1024
    for hop in [256, 512, 1024]:
        params = tg.MdctParams(window_size, hop, tg.WindowType.HANNING)
        coefs = tg.mdct(np.random.default_rng(0).standard_normal(n_samples), params,
                        dtype="float64", **CPU)
        assert coefs.shape == (512, (n_samples - window_size) // hop + 1)


def test_short_signal_raises():
    params = tg.MdctParams.sine_window(1024)
    with pytest.raises(tg.InvalidInputError, match="must be >= window_size"):
        tg.mdct(np.random.default_rng(0).standard_normal(512), params, **CPU)
    with pytest.raises(tg.InvalidInputError, match="1-D"):
        tg.mdct(np.zeros((2, 2048)), params, **CPU)


def test_single_frame_matches_direct_formula():
    N = 8
    params = tg.MdctParams(2 * N, N, tg.WindowType.RECTANGULAR)
    x = np.random.default_rng(7).standard_normal(2 * N)
    coefs = tg.mdct(x, params, dtype="float64", **CPU).numpy()[:, 0]
    ref = np.array([sum(x[n] * np.cos(np.pi * (2 * n + 1 + N) * (2 * k + 1) / (4 * N))
                        for n in range(2 * N)) for k in range(N)])
    assert np.allclose(coefs, ref, atol=1e-10)


@pytest.mark.parametrize("window_size,n", [(1024, 8192), (512, 4096), (16, 256)])
@pytest.mark.parametrize("method", ["auto", "folded"])
def test_perfect_reconstruction(window_size, n, method):
    params = tg.MdctParams.sine_window(window_size)
    x = np.random.default_rng(42).standard_normal(n)
    coefs = tg.mdct(x, params, dtype="float64", method=method, **CPU)
    x_rec = tg.imdct(coefs, params, original_length=n, method=method, **CPU).numpy()
    assert len(x_rec) == n
    m = window_size
    np.testing.assert_allclose(x_rec[m:-m], x[m:-m], atol=1e-9)


def test_imdct_validation():
    params = tg.MdctParams.sine_window(512)
    for m, kw, p in ((sg, {}, sg.MdctParams.sine_window(512)), (tg, CPU, params)):
        with pytest.raises(m.InvalidInputError, match="n_coefficients"):
            m.imdct(np.zeros((100, 4)), p, **kw)
        with pytest.raises(m.InvalidInputError, match="2-D"):
            m.imdct(np.zeros(256), p, **kw)
    empty = tg.imdct(np.zeros((256, 0)), params, **CPU)
    assert empty.shape == (0,) and empty.dtype == torch.float64


def test_f32_path():
    params = tg.MdctParams.sine_window(512)
    x = sine(440.0, duration=0.25).astype(np.float32)
    coefs = tg.mdct(x, params, **CPU)
    assert coefs.dtype == torch.float32
    x_rec = tg.imdct(coefs, params, original_length=len(x), **CPU).numpy()
    n = min(len(x_rec), len(x))
    assert np.abs(x_rec[512 : n - 512] - x[512 : n - 512]).max() < 1e-3


def _dct_iv_fft(u):
    n_pts = len(u)
    n = np.arange(n_pts)
    z = u * np.exp(-1j * np.pi * n / (2 * n_pts))
    w = np.fft.fft(np.concatenate([z, np.zeros(n_pts)]))
    k = np.arange(n_pts)
    return np.real(np.exp(-1j * np.pi * (k + 0.5) / (2 * n_pts)) * w[:n_pts])


def _mdct_frame_independent(xw):
    n = len(xw) // 2
    a, b = xw[: n // 2], xw[n // 2 : n]
    c, d = xw[n : 3 * n // 2], xw[3 * n // 2 :]
    return _dct_iv_fft(np.concatenate([-(c[::-1]) - d, a - b[::-1]]))


def _vorbis_window(two_n):
    n = np.arange(two_n, dtype=np.float64)
    return np.sin(0.5 * np.pi * np.sin(np.pi * (n + 0.5) / two_n) ** 2)


@pytest.mark.parametrize("two_n", [64, 256, 1024])
@pytest.mark.parametrize("method", ["auto", "folded"])
def test_forward_mdct_vs_independent_vorbis(two_n, method):
    w = _vorbis_window(two_n)
    params = tg.MdctParams(two_n, two_n // 2, tg.WindowType.custom(w.tolist()))
    x = np.random.default_rng(7).standard_normal(two_n * 12)
    ours = tg.mdct(x, params, dtype="float64", method=method, **CPU).numpy()
    for i in range(ours.shape[1]):
        frame = x[i * params.hop_size : i * params.hop_size + two_n] * w
        np.testing.assert_allclose(ours[:, i], _mdct_frame_independent(frame), atol=1e-10)


def test_vorbis_window_perfect_reconstruction():
    two_n = 256
    w = _vorbis_window(two_n)
    params = tg.MdctParams(two_n, two_n // 2, tg.WindowType.custom(w.tolist()))
    x = np.random.default_rng(3).standard_normal(4096)
    coefs = tg.mdct(x, params, dtype="float64", **CPU)
    x_rec = tg.imdct(coefs, params, original_length=len(x), **CPU).numpy()
    np.testing.assert_allclose(x_rec[two_n:-two_n], x[two_n : len(x_rec) - two_n], atol=1e-9)


@pytest.mark.parametrize("two_n,hop", [(512, 256), (512, 128), (16, 8), (64, 48), (512, 100)])
def test_folded_matches_dense(two_n, hop):
    params = pair(two_n, hop)[1]
    x = np.random.default_rng(11).standard_normal(4000 if two_n > 64 else 300)
    c_dense = tg.mdct(x, params, dtype="float64", method="matmul", **CPU)
    c_fold = tg.mdct(x, params, dtype="float64", method="folded", **CPU)
    np.testing.assert_allclose(c_fold.numpy(), c_dense.numpy(), atol=1e-10)
    y_dense = tg.imdct(c_dense, params, dtype="float64", method="matmul", **CPU)
    y_fold = tg.imdct(c_dense, params, dtype="float64", method="folded", **CPU)
    np.testing.assert_allclose(y_fold.numpy(), y_dense.numpy(), atol=1e-10)


def test_folded_method_validation():
    x = np.random.default_rng(0).standard_normal(64)
    for m, kw in ((sg, {}), (tg, CPU)):
        params = m.MdctParams(6, 3)
        with pytest.raises(m.InvalidInputError, match="window_size % 4"):
            m.mdct(x, params, dtype="float64", method="folded", **kw)
        with pytest.raises(m.InvalidInputError, match="unknown mdct method"):
            m.mdct(x, params, dtype="float64", method="fft", **kw)
        assert m.mdct(x, params, dtype="float64", **kw).shape[0] == 3
    with pytest.raises(tg.InvalidInputError, match="Precision"):
        tg.mdct(x, tg.MdctParams(8, 4), precision="highest", **CPU)


@pytest.mark.parametrize("nf,n_fft,hop", [(7, 512, 256), (1, 512, 256), (9, 512, 128), (5, 16, 4)])
def test_ola_matmul_matches_overlap_add(nf, n_fft, hop):
    from spectrograms_tpu_torch.ops.ola import ola_matmul, overlap_add

    rng = np.random.default_rng(13)
    c = torch.from_numpy(rng.standard_normal((nf, 5)))
    m = torch.from_numpy(rng.standard_normal((5, n_fft)))
    np.testing.assert_allclose(ola_matmul(c, m, hop).numpy(), overlap_add(c @ m, hop).numpy(),
                               rtol=1e-12, atol=1e-12)


# ---- the port against sg.mdct / sg.imdct ------------------------------------------------

CASES = [(512, 256), (512, 128), (64, 48), (512, 100), (16, 8)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("method", ["auto", "matmul", "folded"])
@pytest.mark.parametrize("two_n,hop", CASES)
def test_mdct_imdct_match_jax(two_n, hop, method, dtype):
    jp, tp = pair(two_n, hop)
    x = np.random.default_rng(two_n + hop).standard_normal(3000).astype(dtype)
    tol = 1e-10 if dtype == "float64" else 1e-4
    want = np.asarray(sg.mdct(x, jp, dtype=dtype, method=method))
    got = tg.mdct(x, tp, dtype=dtype, method=method, **CPU)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name == dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    back_want = np.asarray(sg.imdct(want, jp, original_length=len(x), method=method))
    back = tg.compute_imdct(want, tp, original_length=len(x), method=method, **CPU)
    assert back.shape == back_want.shape and back.dtype == got.dtype
    np.testing.assert_allclose(back.numpy(), back_want, rtol=0, atol=tol * np.abs(back_want).max())
    assert tg.compute_mdct is tg.mdct and tg.compute_imdct is tg.imdct


@pytest.mark.parametrize("two_n", [16, 64, 512])
def test_bases_equal_jax_and_carry_over(two_n):
    """The dense bases and the folded constants equal JAX's, and the JAX
    bases handed to the port's private impls give JAX's result."""
    jp, tp = pair(two_n, two_n // 2, window=_vorbis_window(two_n))
    for a, b in zip(tm._mdct_basis(two_n, tm._window_key(tp)), jm._basis_for(jp, np.float64)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tm._folded_consts(two_n, tm._window_key(tp)),
                    jm._folded_for(jp, np.float64)):
        np.testing.assert_array_equal(a, b)
    fwd, inv = (torch.from_numpy(np.array(a)) for a in jm._basis_for(jp, np.float64))
    x = np.random.default_rng(1).standard_normal(40 * two_n)
    want = np.asarray(sg.mdct(x, jp, dtype="float64"))
    got = tm._mdct_impl(torch.from_numpy(x), fwd, two_n, two_n // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    back = tm._imdct_impl(got.T, inv, two_n, two_n // 2)
    np.testing.assert_allclose(back.numpy(), np.asarray(sg.imdct(want, jp)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["dense", "folded"])
@pytest.mark.parametrize("two_n,hop", [(512, 256), (64, 48), (512, 100)])
def test_batched_impls_match_a_loop(two_n, hop, method):
    """The private impls take leading batch dimensions: a (3, n) batch equals
    the public 1-D functions row by row, and ``jax.vmap`` of JAX's."""
    jp, tp = pair(two_n, hop)
    xb = np.random.default_rng(9).standard_normal((3, 2500)).astype(np.float32)
    x = torch.from_numpy(xb)
    if method == "folded":
        d4, wa, wb, wc, wd, w = tm._consts_for(tp, True, torch.float32, torch.device("cpu"))
        c = tm._mdct_folded_impl(x, d4, wa, wb, wc, wd, two_n, hop)
        back = tm._imdct_folded_impl(c.transpose(-1, -2), d4, w, two_n, hop)
    else:
        fwd, inv = tm._consts_for(tp, False, torch.float32, torch.device("cpu"))
        c = tm._mdct_impl(x, fwd, two_n, hop)
        back = tm._imdct_impl(c.transpose(-1, -2), inv, two_n, hop)
    meth = "folded" if method == "folded" else "auto"
    for r in range(3):
        one = tg.mdct(xb[r], tp, method=meth, **CPU)
        np.testing.assert_allclose(c[r].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6 * float(one.abs().max()))
        np.testing.assert_allclose(back[r].numpy(), tg.imdct(one, tp, method=meth, **CPU).numpy(),
                                   rtol=0, atol=1e-5)

    def rt(sig):
        return sg.imdct(sg.mdct(sig, jp, dtype="float32", method=meth), jp,
                        original_length=sig.shape[0], method=meth)

    want = np.asarray(jax.vmap(rt)(jnp.asarray(xb)))
    np.testing.assert_allclose(back[:, : xb.shape[1]].numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
