"""``tg.delta``: the torch-op chain on the CPU and the one-launch kernel
``csrc/delta.cu`` on CUDA tensors.

On the CPU: numpy and CPU inputs take the chain (``ops/delta.py::
delta_reference``) and launch nothing; a CUDA request is dispatched to the
kernel (a dtype other than float32 and float64 raises, on either path)
without a card; ``launch`` counts only the launches that return (its call
into ``ops/_build.py``'s table is held for all three sources in
``tests/test_torch_port_build.py``, with the signatures); and a twin of the kernel's tiling, halo and
clamp arithmetic, written here in torch ops, equals the chain bit for bit.
The tests marked ``card`` hold the kernel itself against the chain on the
same CUDA tensor; they skip without CUDA. This file imports no JAX, so on a
machine without it ``python3 -m pytest --noconftest
tests/test_torch_port_delta.py -m card`` runs them
(``tests/test_torch_port_pipeline.py`` holds the chain against the JAX
package's ``delta``).
"""

import numpy as np
import pytest
import torch

import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch.errors import FftBackendError, InvalidInputError
from spectrograms_tpu_torch.ops import _build
from spectrograms_tpu_torch.ops import delta as dops

DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]


def feats(shape, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g, dtype=torch.float64) * 10).to(dtype)


@pytest.fixture
def no_kernel(monkeypatch):
    """Any kernel launch fails the test."""
    def launch(*a, **k):
        raise AssertionError("the kernel was launched")
    monkeypatch.setattr(dops, "launch", launch)


@pytest.mark.parametrize("kind", ["numpy", "tensor", "result"])
@pytest.mark.parametrize("order", [1, 2])
def test_cpu_and_numpy_inputs_take_the_chain(no_kernel, kind, order):
    x = feats((3, 40, 50))
    arg = {"numpy": x.numpy(), "tensor": x, "result": tg.Mfcc(x[0], tg.MfccParams(40))}[kind]
    dops.launches = 0
    out = tg.delta(arg, 9, order)
    ref = dops.delta_reference(x[0] if kind == "result" else x, 9, order)
    assert dops.launches == 0
    assert torch.equal(out, ref)


@pytest.fixture
def as_if_cuda(monkeypatch):
    """CPU tensors report ``is_cuda``: the dispatch of a CUDA request,
    without a card."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.bool, torch.complex64,
                                   torch.float16, torch.bfloat16])
def test_a_cuda_request_other_than_f32_f64_raises(monkeypatch, as_if_cuda, dtype):
    monkeypatch.setattr(_build, "load_library", lambda *a: pytest.fail("the kernel was loaded"))
    dops.launches = 0
    with pytest.raises(InvalidInputError, match="float32 or float64"):
        tg.delta(torch.ones((2, 8), dtype=dtype))
    assert dops.launches == 0


@pytest.mark.parametrize("arg", [np.ones((2, 8), np.float16), torch.ones((2, 8), dtype=torch.float16),
                                 torch.ones((2, 8), dtype=torch.bfloat16)],
                         ids=["f16-numpy", "f16", "bf16"])
def test_half_precision_features_raise_on_the_cpu(no_kernel, arg):
    # the chain rounds its weights to the features' type: float32 or float64
    with pytest.raises(InvalidInputError, match="NumPy counterpart"):
        tg.delta(arg)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("order", [1, 2, 3])
def test_a_floating_cuda_request_takes_one_launch(monkeypatch, as_if_cuda, dtype, order):
    calls = []

    def launch(x, width, order):
        calls.append((x.dtype, width, order))
        return torch.zeros_like(x)

    def chain(*a):
        raise AssertionError("the chain ran on a CUDA request")

    monkeypatch.setattr(dops, "launch", launch)
    monkeypatch.setattr(dops, "delta_reference", chain)
    tg.delta(feats((2, 3, 20), dtype), 5, order)
    assert calls == [(dtype, 5, order)]


class FakeLibrary:
    """The C entry points, returning ``rc`` and recording each launch."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def delta_launch(self, *args):
        self.calls.append(args)
        return self.rc

    def delta_error_string(self, rc):
        return b"an error"


@pytest.mark.parametrize("rc", [0, 700])
@pytest.mark.parametrize("shape", [(2, 3, 20), (0, 20)], ids=["full", "empty"])
def test_launch_counts_only_launches_that_return(monkeypatch, rc, shape):
    lib = FakeLibrary(rc)
    monkeypatch.setattr(_build.SOURCES["delta"], "lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 0, raising=False)
    x = feats(shape, torch.float32)
    dops.launches = 0
    if rc and x.numel():
        with pytest.raises(FftBackendError, match="an error"):
            dops.launch(x, 9, 2)
    else:
        assert dops.launch(x, 9, 2).shape == shape
    launched = 1 if x.numel() else 0
    assert len(lib.calls) == launched
    assert dops.launches == (launched if rc == 0 else 0)


def test_a_cuda_request_with_grad_goes_through_the_kernel(monkeypatch, as_if_cuda):
    calls = []

    def launch(x, w, o):
        calls.append(o)
        return dops.delta_reference(x.detach(), w, o)

    monkeypatch.setattr(dops, "launch", launch)
    x = feats((2, 30)).requires_grad_()
    y = tg.delta(x, 7, 2)
    assert calls == [2]
    (gx,) = torch.autograd.grad((y * y).sum(), x)
    xr = x.detach().requires_grad_()
    (gr,) = torch.autograd.grad((dops.delta_reference(xr, 7, 2) ** 2).sum(), xr)
    assert torch.equal(gx, gr)


def kernel_twin(x, width, order, tile):
    """``csrc/delta.cu`` written in torch ops: the items of ``layout``, each
    a tile with its halo cut at the row's ends, the stages on buffers of
    ``span`` values (unwritten values NaN), the clamp at the row's ends, and
    the products and sums in the chain's order."""
    S = x.dtype
    T = x.shape[-1]
    rows = x.reshape(-1, T)
    tile, tiles, span, _ = dops.layout(T, width, order, S, tile)
    k = dops.delta_weights(width, S)
    half, halo = width // 2, order * (width // 2)
    out = torch.full(rows.shape, float("nan"), dtype=S)
    for i in range(tiles):
        t0, t1 = i * tile, min(T, i * tile + tile)
        b0, b1 = max(0, t0 - halo), min(T, t1 + halo)
        assert b1 - b0 <= span
        src = torch.full((rows.shape[0], span), float("nan"), dtype=S)
        src[:, : b1 - b0] = rows[:, b0:b1]
        for s in range(1, order + 1):
            m = (order - s) * half
            c0, c1 = max(0, t0 - m), min(T, t1 + m)
            t = torch.arange(c0, c1)
            acc = torch.zeros((rows.shape[0], c1 - c0), dtype=S)
            for j in range(width):
                tau = (t + j - half).clamp(0, T - 1)
                acc = acc + src[:, tau - b0] * k[j]
            if s == order:
                out[:, c0:c1] = acc
            else:
                dst = torch.full_like(src, float("nan"))
                dst[:, c0 - b0: c1 - b0] = acc
                src = dst
    return out.reshape(x.shape)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("width", [3, 5, 9, 15])
def test_kernel_twin_equals_the_chain(dtype, width):
    for order in (1, 2, 3):
        for T, tile in ((1, 1024), (2, 1024), (4, 1024), (5, 2), (37, 8), (626, 1024), (626, 64)):
            x = feats((2, 3, T), dtype, seed=T + order)
            twin = kernel_twin(x, width, order, tile)
            assert torch.equal(twin, dops.delta_reference(x, width, order)), (order, T, tile)


def test_layout_halves_the_tile_until_shared_memory_holds_it():
    assert dops.layout(626, 9, 1, torch.float32) == (1024, 1, 626, (9 + 626) * 4)
    assert dops.layout(5000, 9, 2, torch.float32) == (1024, 5, 1040, (9 + 2 * 1040) * 4)
    # halo 6475 a side in float64: 1024 frames do not fit, 512 do
    assert dops.layout(10**6, 1851, 7, torch.float64) == (
        512, 1954, 512 + 2 * 6475, (1851 + 2 * 13462) * 8)
    assert dops.layout(13000, 1851, 7, torch.float64)[:3] == (1024, 13, 13000)
    with pytest.raises(InvalidInputError, match="shared memory"):
        dops.layout(10**6, 4001, 4, torch.float64)


def test_weights_round_to_the_features_type():
    n = np.arange(-4, 5, dtype=np.float64)
    k64 = n / np.sum(n * n)
    assert dops.delta_weights(9, torch.float64) == tuple(k64)
    assert dops.delta_weights(9, torch.float32) == tuple(float(v) for v in k64.astype(np.float32))
    for dt in (torch.float16, torch.bfloat16):
        with pytest.raises(InvalidInputError):
            dops.delta_weights(9, dt)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


SHAPES = {1: lambda T: (T,), 2: lambda T: (3, T), 3: lambda T: (2, 3, T),
          4: lambda T: (2, 2, 3, T)}


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("width", [3, 5, 9, 15])
def test_kernel_equals_the_chain_on_the_card(card, dtype, width):
    bad = []
    for order in (1, 2, 3):
        for T in (1, 2, 4, 5, 626, 5000):
            for rank, shape in SHAPES.items():
                x = feats(shape(T), dtype, seed=T * 7 + rank).to(card)
                dops.launches = 0
                got = tg.delta(x, width, order)
                if dops.launches != 1 or not torch.equal(
                        got, dops.delta_reference(x, width, order)):
                    bad.append((order, T, rank))
    assert not bad


@pytest.mark.card
def test_one_launch_a_call_on_the_card(card):
    x = feats((32, 40, 626), torch.float32).to(card)
    for order in (1, 2, 3, 4):
        dops.launches = 0
        tg.delta(x, 9, order)
        assert dops.launches == 1
    dops.launches = 0
    assert tg.delta(torch.empty((0, 5), device=card)).shape == (0, 5)
    assert dops.launches == 0
    for dtype in (torch.float16, torch.bfloat16):
        with pytest.raises(InvalidInputError, match="float32 or float64"):
            tg.delta(x.to(dtype))
    assert dops.launches == 0


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_gradient_through_the_kernel_on_the_card(card, dtype):
    x = feats((4, 40, 100), dtype).to(card).requires_grad_()
    g = feats((4, 40, 100), dtype, seed=1).to(card)
    dops.launches = 0
    y = tg.delta(x, 9, 2)
    assert dops.launches == 1
    (gx,) = torch.autograd.grad(y, x, g)
    xr = x.detach().requires_grad_()
    (gr,) = torch.autograd.grad(dops.delta_reference(xr, 9, 2), xr, g)
    assert torch.equal(y.detach(), dops.delta_reference(x.detach(), 9, 2))
    assert torch.equal(gx, gr)
