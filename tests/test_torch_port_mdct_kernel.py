"""``csrc/mdct.cu``: the batched MDCT and IMDCT at hop = N as one launch each.

On the CPU:

- the kernel's factorization, ``mdct.py::mdct_kernel_twin`` and
  ``imdct_kernel_twin`` (the TDAC fold, a DCT-IV by an N/2-point FFT, the
  inverse's unfold and overlap-add), against
  the dense chain (``_mdct_impl``/``_imdct_impl`` on the CPU) and the JAX
  package's ``mdct``/``imdct``: 1e-12 of the peak at float64, 1e-5 at
  float32, over the kernel's N = 8 .. 1024, batched and 1-D, at lengths that
  are not a whole number of hops; at N = 2048 and 4096 against the direct
  formula with its cosine's argument reduced exactly (the dense float64
  basis itself is off by 1.4e-12 of the peak at N = 4096, from
  ``np.cos`` of arguments near 2e4);
- which calls take the kernel (a stubbed library, the CUDA calls faked): a
  basis that ``_device_consts`` built, at hop = N, in float32; JAX's basis,
  a copied basis, the other direction's basis, another hop, another N,
  float64 and CPU tensors take the chain; ``mdct.launches`` and
  ``mdct.chain_calls`` count each call once;
- the gradient of a call that takes the kernel is the dense chain's.

The tests marked ``card`` launch the kernel and hold it against the dense
chain on the same CUDA tensor (over the kernel's whole N, so every block
geometry that ``csrc/mdct.cu`` derives runs once); they skip without CUDA. JAX is imported only
inside the tests that compare with it, so on a machine without JAX
``python3 -m pytest --noconftest tests/test_torch_port_mdct_kernel.py -m
card`` runs them.
"""

import contextlib
import gc
import sys

import numpy as np
import pytest
import torch

import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch.ops import _build

tm = sys.modules["spectrograms_tpu_torch.mdct"]

CPU = torch.device("cpu")
DTYPES = [torch.float64, torch.float32]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
DOMAIN = [2**k for k in range(3, 13)]       # the kernel's N
DENSE_N = [n for n in DOMAIN if n <= 1024]


def signal(n, rows=2, dtype=torch.float64, seed=0):
    """``rows`` of noise, 19 hops and more long: several of the runs of 8
    frames that the kernel's teams take, and not a whole number of hops."""
    length = 19 * n + n // 2 + 3
    g = np.random.default_rng(seed + n)
    return torch.from_numpy(g.standard_normal((rows, length))).to(dtype)


def tables(two_n, dtype):
    p = tg.MdctParams.sine_window(two_n)
    return torch.tensor(tm._kernel_tables(two_n, tm._window_key(p)), dtype=dtype)


def assert_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


# ---- the factorization on the CPU ------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("n", DENSE_N)
def test_twin_matches_the_dense_chain_and_jax(n, dtype):
    import spectrograms_tpu as sg

    two_n = 2 * n
    p = tg.MdctParams.sine_window(two_n)
    fwd, inv = tm._consts_for(p, False, dtype, CPU)
    tab = tables(two_n, dtype)
    x = signal(n, dtype=dtype)
    c = tm.mdct_kernel_twin(x, tab, two_n)
    chain = tm._mdct_impl(x, fwd, two_n, n)
    assert c.dtype == dtype and tuple(c.shape) == tuple(chain.shape[:-2]) + (chain.shape[-1], n)
    assert_close(c, chain.transpose(-1, -2), TOL[dtype])
    y = tm.imdct_kernel_twin(c, tab, two_n)
    assert_close(y, tm._imdct_impl(c, inv, two_n, n), TOL[dtype])
    # 1-D, against the JAX package
    jp = sg.MdctParams.sine_window(two_n)
    name = str(dtype).removeprefix("torch.")
    want = np.asarray(sg.mdct(x[0].numpy(), jp, dtype=name))
    c1 = tm.mdct_kernel_twin(x[0], tab, two_n)
    assert_close(c1.T, want, TOL[dtype])
    assert_close(tm.imdct_kernel_twin(c1, tab, two_n), np.asarray(sg.imdct(want, jp)), TOL[dtype])


def exact_mdct(x, w, two_n):
    """float64 C = frames·w @ cos(π(2m+1+N)(2k+1)/(4N)) with the integer
    (2m+1+N)(2k+1) reduced mod 8N, a block of 256 columns at a time."""
    n = two_n // 2
    nf = (x.shape[-1] - two_n) // n + 1
    frames = np.stack([x[..., f * n:f * n + two_n] for f in range(nf)], axis=-2) * w
    m = np.arange(two_n, dtype=np.int64)[:, None]
    out = np.empty(frames.shape[:-1] + (n,))
    for k0 in range(0, n, 256):
        k = np.arange(k0, min(n, k0 + 256), dtype=np.int64)[None, :]
        arg = ((2 * m + 1 + n) * (2 * k + 1)) % (8 * n)
        out[..., k0:k0 + 256] = frames @ np.cos(np.pi * arg / (4.0 * n))
    return out


def exact_imdct(c, w, two_n):
    """float64 overlap-add of (2/N)·Σ_k C[k]·cos(...)·w, blocks as above."""
    n = two_n // 2
    nf = c.shape[-2]
    k = np.arange(n, dtype=np.int64)[:, None]
    frames = np.zeros(c.shape[:-1] + (two_n,))
    for m0 in range(0, two_n, 256):
        m = np.arange(m0, min(two_n, m0 + 256), dtype=np.int64)[None, :]
        arg = ((2 * m + 1 + n) * (2 * k + 1)) % (8 * n)
        frames[..., m0:m0 + 256] = (2.0 / n) * (c @ np.cos(np.pi * arg / (4.0 * n)))
    frames *= w
    out = np.zeros(c.shape[:-2] + ((nf + 1) * n,))
    for f in range(nf):
        out[..., f * n:f * n + two_n] += frames[..., f, :]
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("n", [n for n in DOMAIN if n > 1024])
def test_twin_matches_the_exact_formula_at_large_n(n, dtype):
    two_n = 2 * n
    tab = tables(two_n, dtype)
    w = np.asarray(tm._window_key(tg.MdctParams.sine_window(two_n)))
    x = signal(n, rows=1, dtype=torch.float64)[..., : 6 * n + 5]
    c = tm.mdct_kernel_twin(x.to(dtype), tab, two_n)
    want = exact_mdct(x.numpy(), w, two_n)
    assert_close(c, want, TOL[dtype])
    assert_close(tm.imdct_kernel_twin(c, tab, two_n), exact_imdct(c.double().numpy(), w, two_n),
                 TOL[dtype])


@pytest.mark.parametrize("length", [5, 16, 17, 31, 32, 33])
def test_twin_at_lengths_of_one_frame_or_less(length):
    """A signal shorter than a frame is one zero-padded frame, as the
    chain's; lengths around 2N, 1-D and batched."""
    two_n, n = 32, 16
    fwd, inv = tm._consts_for(tg.MdctParams.sine_window(two_n), False, torch.float64, CPU)
    x = torch.from_numpy(np.random.default_rng(length).standard_normal((3, 2, length)))
    c = tm.mdct_kernel_twin(x, tables(two_n, torch.float64), two_n)
    assert_close(c, tm._mdct_impl(x, fwd, two_n, n).transpose(-1, -2), 1e-12)
    assert_close(tm.imdct_kernel_twin(c, tables(two_n, torch.float64), two_n),
                 tm._imdct_impl(c, inv, two_n, n), 1e-12)


def test_tables_are_the_float64_constants_rounded_once():
    two_n, n = 512, 256
    key = tm._window_key(tg.MdctParams.sine_window(two_n))
    t64 = tm._kernel_tables(two_n, key)
    assert t64.dtype == np.float64 and t64.shape == (6 * n,) and not t64.flags.writeable
    np.testing.assert_array_equal(t64[:two_n], np.asarray(key))
    z = t64[two_n:].reshape(4, n // 2, 2)
    z = z[..., 0] + 1j * z[..., 1]
    i = np.arange(n // 2)
    np.testing.assert_allclose(z[0], np.exp(-1j * np.pi * i / n), rtol=0, atol=1e-16)
    np.testing.assert_allclose(z[2], (2.0 / n) * z[1], rtol=0, atol=0)
    np.testing.assert_allclose(z[3], np.exp(-2j * np.pi * i / (n // 2)), rtol=0, atol=1e-16)
    # the device tables of a float32 dense pair: those values rounded to float32
    fwd, inv = tm._consts_for(tg.MdctParams.sine_window(two_n), False, torch.float32, CPU)
    dev = tm._kernel_tables_for(torch.zeros(1), fwd, two_n, n, False)
    assert dev is tm._kernel_tables_for(torch.zeros(1), inv, two_n, n, True)
    assert torch.equal(dev, torch.from_numpy(t64.astype(np.float32)))


# ---- which calls take the kernel: a stubbed library ------------------------------------

class FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        if fn == "mdct_launch":
            return lambda *args: self.calls.append(args) or 0
        if fn == "mdct_error_string":
            return lambda rc: b"an error"
        raise AttributeError(fn)


@pytest.fixture
def stub(monkeypatch):
    """CPU tensors report ``is_cuda``, the kernel's library is a recorder,
    the CUDA calls of ``Source.launch`` are faked, the counters start at 0."""
    lib = FakeLibrary()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build.SOURCES["mdct"], "lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 100, raising=False)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tm, "launches", 0)
    monkeypatch.setattr(tm, "chain_calls", 0)
    return lib


def consts(two_n, dtype=torch.float32, hop=None):
    p = tg.MdctParams(two_n, hop or two_n // 2, tg.MdctParams.sine_window(two_n).window)
    return tm._consts_for(p, False, dtype, CPU)


@pytest.mark.parametrize("shape", [(2, 3, 1000), (1000,)], ids=["batched", "1-D"])
def test_a_registered_basis_at_hop_n_takes_the_kernel(stub, shape):
    two_n, n = 64, 32
    fwd, inv = consts(two_n)
    x = torch.zeros(shape)
    c = tm._mdct_impl(x, fwd, two_n, n)
    nf = (shape[-1] - two_n) // n + 1
    assert tuple(c.shape) == shape[:-1] + (n, nf) and c.transpose(-1, -2).is_contiguous()
    y = tm._imdct_impl(c.transpose(-1, -2), inv, two_n, n)
    assert tuple(y.shape) == shape[:-1] + (n * (nf + 1),)
    assert (tm.launches, tm.chain_calls) == (2, 0)
    rows = int(np.prod(shape[:-1]))
    tab = tm._kernel_tables_for(x, fwd, two_n, n, False)
    (f_args, i_args) = stub.calls
    assert f_args[2:] == (tab.data_ptr(), rows, shape[-1], nf, n, 0, 100)
    assert i_args[2:] == (tab.data_ptr(), rows, 0, nf, n, 1, 100)
    assert f_args[0] == x.data_ptr() and f_args[1] == c.data_ptr() and i_args[1] == y.data_ptr()


def chain_grad(impl, t, basis, two_n, n, g):
    """The gradient of ``impl`` at ``t`` against ``g``, by the dense chain
    (``basis`` copied, so not registered)."""
    t = t.detach().requires_grad_(True)
    return torch.autograd.grad(impl(t, basis.clone(), two_n, n), t, g)[0]


@pytest.mark.parametrize("shape", [(2, 3, 300), (300,)], ids=["batched", "1-D"])
def test_the_gradient_through_the_kernel_is_the_chains(stub, shape):
    """A call that takes the kernel, on an input that requires grad, runs
    the kernel forward and the dense chain's gradient backward."""
    two_n, n = 64, 32
    fwd, inv = consts(two_n)
    g = np.random.default_rng(6)
    x = torch.from_numpy(g.standard_normal(shape).astype(np.float32)).requires_grad_(True)
    c = tm._mdct_impl(x, fwd, two_n, n)
    assert c.grad_fn is not None and (tm.launches, tm.chain_calls) == (1, 0)
    gc_ = torch.from_numpy(g.standard_normal(tuple(c.shape)).astype(np.float32))
    (gx,) = torch.autograd.grad(c, x, gc_)
    assert tm.launches == 1
    assert torch.equal(gx, chain_grad(tm._mdct_impl, x, fwd, two_n, n, gc_))
    ct = torch.from_numpy(g.standard_normal((*shape[:-1], 8, n)).astype(np.float32))
    ct.requires_grad_(True)
    y = tm._imdct_impl(ct, inv, two_n, n)
    assert y.grad_fn is not None and tm.launches == 2
    gy = torch.from_numpy(g.standard_normal(tuple(y.shape)).astype(np.float32))
    (gct,) = torch.autograd.grad(y, ct, gy)
    assert torch.equal(gct, chain_grad(tm._imdct_impl, ct, inv, two_n, n, gy))
    with torch.no_grad():
        assert tm._mdct_impl(x, fwd, two_n, n).grad_fn is None
    assert tm.launches == 3


def jax_bases(two_n):
    import spectrograms_tpu as sg

    jm = sys.modules["spectrograms_tpu.mdct"]
    b = jm._basis_for(sg.MdctParams.sine_window(two_n), np.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in b)


@pytest.mark.parametrize("case", ["jax", "copied", "other_n", "hop", "f64",
                                  "n_not_a_power_of_two", "n_below_the_domain"])
def test_every_other_cuda_call_takes_the_chain(stub, case):
    two_n, n, hop, dtype = 64, 32, 32, torch.float32
    fwd, inv = consts(two_n)
    if case == "jax":
        fwd, inv = jax_bases(two_n)
    elif case == "copied":
        fwd, inv = fwd.clone(), inv.clone()
    elif case == "other_n":
        fwd, inv = consts(128)      # registered, for another window_size
    elif case == "hop":
        hop = 16
        fwd, inv = consts(two_n, hop=hop)
    elif case == "f64":
        dtype = torch.float64
        fwd, inv = consts(two_n, dtype)
    elif case == "n_not_a_power_of_two":
        two_n, n, hop = 48, 24, 24
        fwd, inv = consts(two_n)
    else:
        two_n, n, hop = 8, 4, 4
        fwd, inv = consts(two_n)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 700))).to(dtype)
    c = tm._mdct_impl(x, fwd, two_n, hop)
    y = tm._imdct_impl(c.transpose(-1, -2), inv, two_n, hop)
    assert (tm.launches, tm.chain_calls) == (0, 2) and stub.calls == []
    assert torch.isfinite(y).all()


def test_a_basis_serves_its_own_direction_and_size_only():
    fwd, inv = consts(64)
    x = torch.zeros(1)
    assert tm._kernel_tables_for(x, fwd, 64, 32, False) is not None
    assert tm._kernel_tables_for(x, inv, 64, 32, True) is not None
    assert tm._kernel_tables_for(x, inv, 64, 32, False) is None
    assert tm._kernel_tables_for(x, fwd, 64, 32, True) is None
    assert tm._kernel_tables_for(x, fwd, 128, 64, False) is None
    assert tm._kernel_tables_for(x.double(), fwd, 64, 32, False) is None


def test_cpu_tensors_take_the_chain_uncounted(monkeypatch):
    monkeypatch.setattr(_build.SOURCES["mdct"], "lib", None)
    monkeypatch.setattr(_build, "load_library", lambda *a: pytest.fail("the kernel was loaded"))
    monkeypatch.setattr(tm, "launches", 0)
    monkeypatch.setattr(tm, "chain_calls", 0)
    fwd, inv = consts(512)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 5000)).astype(np.float32))
    y = tm._imdct_impl(tm._mdct_impl(x, fwd, 512, 256).transpose(-1, -2), inv, 512, 256)
    out = tg.imdct(tg.mdct(x[0], tg.MdctParams.sine_window(512), device="cpu"),
                   tg.MdctParams.sine_window(512), device="cpu")
    assert torch.equal(y[0], out)
    assert (tm.launches, tm.chain_calls) == (0, 0)


def test_the_inverse_checks_its_coefficients(stub):
    fwd, inv = consts(64)
    with pytest.raises(tg.InvalidInputError, match=r"\(\.\.\., n_frames, 32\)"):
        tm._imdct_impl(torch.zeros((3, 31)), inv, 64, 32)
    assert stub.calls == [] and tm.launches == 0


def test_an_empty_batch_launches_nothing(stub):
    fwd, inv = consts(64)
    c = tm._mdct_impl(torch.zeros((0, 500)), fwd, 64, 32)
    y = tm._imdct_impl(c.transpose(-1, -2), inv, 64, 32)
    assert tuple(c.shape) == (0, 32, 14) and tuple(y.shape) == (0, 32 * 15)
    assert stub.calls == [] and (tm.launches, tm.chain_calls) == (0, 0)


def test_a_basis_that_is_freed_leaves_the_registry():
    key = tm._window_key(tg.MdctParams.sine_window(64))
    before = len(tm._kernel_bases)
    fwd, inv = tm._device_consts.__wrapped__(64, key, False, torch.float32, CPU)
    assert len(tm._kernel_bases) == before + 2
    assert tm._kernel_tables_for(torch.zeros(1), fwd, 64, 32, False) is not None
    del fwd, inv
    gc.collect()
    assert len(tm._kernel_bases) == before
    # float64 pairs and the folded constants are not registered
    tm._device_consts.__wrapped__(64, key, False, torch.float64, CPU)
    tm._device_consts.__wrapped__(64, key, True, torch.float32, CPU)
    assert len(tm._kernel_bases) == before


# ---- on the card -----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_kernels(["mdct"])
    return torch.device("cuda", 0)


def kernel_and_chain(x, two_n, n):
    """(coefficients, round trip) by the kernel, then by the chain (the
    same bases copied, so not registered), each launch synchronised."""
    p = tg.MdctParams.sine_window(two_n)
    fwd, inv = tm._consts_for(p, False, torch.float32, x.device)
    out = []
    for f, i in ((fwd, inv), (fwd.clone(), inv.clone())):
        c = tm._mdct_impl(x, f, two_n, n)
        torch.cuda.synchronize()
        y = tm._imdct_impl(c.transpose(-1, -2), i, two_n, n)
        torch.cuda.synchronize()
        out.append((c, y))
    return out


@pytest.mark.card
@pytest.mark.parametrize("length", [220500, 220501 + 97])
def test_the_kernel_matches_the_chain_at_config_4s_batch(card, length):
    g = torch.Generator(device=card).manual_seed(length)
    x = torch.randn((64, length), device=card, generator=g)
    tm.launches = tm.chain_calls = 0
    (c, y), (c_ref, y_ref) = kernel_and_chain(x, 512, 256)
    assert (tm.launches, tm.chain_calls) == (2, 2)
    assert c.shape == c_ref.shape and c.stride() == c_ref.stride() and y.shape == y_ref.shape
    assert_close(c.cpu(), c_ref.cpu(), 1e-5)
    assert_close(y.cpu(), y_ref.cpu(), 1e-5)
    inner = slice(512, y.shape[-1] - 512)
    assert float((y[:, inner] - x[:, inner]).abs().max()) <= 1e-5


@pytest.mark.card
@pytest.mark.parametrize("n", DOMAIN)
def test_the_kernel_matches_its_twin_over_the_domain(card, n):
    two_n = 2 * n
    x = signal(n, rows=3, dtype=torch.float32).to(card)
    tab = tables(two_n, torch.float32).to(card)
    (c, y), (c_ref, y_ref) = kernel_and_chain(x, two_n, n)
    assert_close(c.transpose(-1, -2).cpu(), tm.mdct_kernel_twin(x, tab, two_n).cpu(), 1e-5)
    assert_close(y.cpu(), tm.imdct_kernel_twin(c.transpose(-1, -2), tab, two_n).cpu(), 1e-5)
    assert_close(c.cpu(), c_ref.cpu(), 1e-5)
    assert_close(y.cpu(), y_ref.cpu(), 1e-5)


@pytest.mark.card
@pytest.mark.parametrize("length", [5, 16, 17, 31, 32, 33, 87])
def test_the_kernel_on_short_rows_off_the_16_byte_grid(card, length):
    """Rows of (3, 2, length) at N = 16: rows that do not start on a 16-byte
    vector, and hop-blocks that lie partly or wholly past the row."""
    two_n, n = 32, 16
    x = torch.from_numpy(np.random.default_rng(length).standard_normal((3, 2, length)))
    x = x.to(card, torch.float32)
    tab = tables(two_n, torch.float32).to(card)
    tm.launches = tm.chain_calls = 0
    (c, y), (c_ref, y_ref) = kernel_and_chain(x, two_n, n)
    assert (tm.launches, tm.chain_calls) == (2, 2)
    assert_close(c.transpose(-1, -2).cpu(), tm.mdct_kernel_twin(x, tab, two_n).cpu(), 1e-5)
    assert_close(c.cpu(), c_ref.cpu(), 1e-5)
    assert_close(y.cpu(), y_ref.cpu(), 1e-5)


@pytest.mark.card
def test_the_gradient_on_the_card_is_the_chains(card):
    two_n, n = 512, 256
    fwd, inv = tm._consts_for(tg.MdctParams.sine_window(two_n), False, torch.float32, card)
    x = torch.randn((4, 44100), device=card, requires_grad=True)
    tm.launches = tm.chain_calls = 0
    c = tm._mdct_impl(x, fwd, two_n, n)
    y = tm._imdct_impl(c.transpose(-1, -2), inv, two_n, n)
    torch.cuda.synchronize()
    assert (tm.launches, tm.chain_calls) == (2, 0)
    g = torch.randn(y.shape, device=card)
    (gx,) = torch.autograd.grad(y, x, g)
    torch.cuda.synchronize()
    xd = x.detach().requires_grad_(True)
    y_ref = tm._imdct_impl(tm._mdct_impl(xd, fwd.clone(), two_n, n).transpose(-1, -2),
                           inv.clone(), two_n, n)
    (gx_ref,) = torch.autograd.grad(y_ref, xd, g)
    assert_close(gx.cpu(), gx_ref.cpu(), 1e-5)


@pytest.mark.card
def test_the_public_functions_launch_the_kernel(card):
    p = tg.MdctParams.sine_window(512)
    x = np.random.default_rng(5).standard_normal(44100 + 77).astype(np.float32)
    tm.launches = tm.chain_calls = 0
    c = tg.mdct(x, p)
    torch.cuda.synchronize()
    back = tg.imdct(c, p, original_length=x.size)
    torch.cuda.synchronize()
    assert (tm.launches, tm.chain_calls) == (2, 0)
    want = tg.mdct(x.astype(np.float64), p, device="cpu")
    assert_close(c.cpu(), want, 1e-5)
    m = back.shape[0]    # (n_frames + 1)·N: the frames end before the signal does
    assert float((back.cpu()[512:m - 512] - torch.from_numpy(x)[512:m - 512]).abs().max()) <= 1e-5


@pytest.mark.card
def test_the_member_call_is_two_launches(card):
    """Config 4's MDCT member, as ``portbench/configs/music_cqt84.py``
    writes it: two launches, no chain."""
    p = tg.MdctParams.sine_window(512)
    x = torch.randn((4, 44100), device=card)
    tm.launches = tm.chain_calls = 0
    fwd, inv = tm._consts_for(p, False, x.dtype, x.device)
    c = tm._mdct_impl(x, fwd, 512, 256)
    torch.cuda.synchronize()
    y = tm._imdct_impl(c.transpose(-1, -2), inv, 512, 256)[..., : x.shape[-1]]
    torch.cuda.synchronize()
    assert (tm.launches, tm.chain_calls) == (2, 0)
    assert float((y[:, 512:-512] - x[:, 512:y.shape[-1] - 512]).abs().max()) <= 1e-5
