"""``csrc/gammatone.cu``: the gammatone bank of ``gammatone_iir_spectrogram``
as one launch a call.

On the CPU:

- CPU calls keep the torch-op scan: the kernel is neither loaded nor
  counted;
- which calls take the kernel (a stubbed library, ``Source.launch`` faked):
  ``auto`` and ``scan`` on a CUDA tensor, batched or not, launch once with
  the call's shapes, dtype codes and dB floor; float32 and float64 inputs are
  handed over as they are, any other dtype as float64; float32 and float64
  outputs are written by the kernel, any other dtype is cast after it; an
  input that requires grad takes the scan and ``parallel`` its own
  lowering; an empty batch launches nothing; every route counts
  ``gt_calls`` and ``gt_filtered_samples`` alike.

The tests marked ``card`` launch the kernel and hold it against the torch-op
scan (``erb._gammatone_impl``) on the same card: the float64 RMS at 1e-9
relative, the float32 dB at 1e-4 dB, at the cochleagram cell's shape (a few
10 s clips at 16 kHz, 64 bands, 320/160), at 300/170 with a ragged tail, at
5 and 33 bands and for one clip; a 1-D call, ``db_floor=None`` and a float64
input; a batch equal to its rows' single calls bit for bit; one launch a
call. They skip without CUDA. This file imports no JAX, so on a card
``python3 -m pytest --noconftest tests/test_torch_port_gt_kernel.py -m card``
runs them.
"""

import contextlib

import numpy as np
import pytest
import torch

import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch import erb
from spectrograms_tpu_torch.ops import _build

SR = 16000.0
# the benchmark's cochleagram_gt64: 64 bands uniform on the ERB-rate scale, 50 Hz-8 kHz
CELL = tg.ErbParams(64, 50.0, 8454.200768317056, tg.ErbSpacing.APPLE_TR35, db_floor=-80.0)
COUNTERS = ("launches", "gt_calls", "gt_kernel_calls", "gt_scan_calls", "gt_parallel_calls",
            "gt_filtered_samples")


def tones(rows, n, seed):
    """Noise plus three tones a row, as the benchmark's traffic, float32."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.05 * g.standard_normal((rows, n))
    for _ in range(3):
        x += g.uniform(0.1, 0.5, (rows, 1)) * np.sin(2 * np.pi * g.uniform(80, 0.45 * SR,
                                                                            (rows, 1)) * t)
    return torch.from_numpy(x.astype(np.float32))


def counters():
    return {name: getattr(erb, name) for name in COUNTERS}


def moved(before):
    return {name: getattr(erb, name) - n for name, n in before.items()}


# ---- on the CPU ------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("method", ["auto", "scan"])
def test_cpu_calls_keep_the_torch_op_scan(monkeypatch, method, batched):
    monkeypatch.setattr(_build.SOURCES["gammatone"], "lib", None)
    monkeypatch.setattr(_build, "load_library", lambda *a: pytest.fail("the kernel was loaded"))
    x = tones(2, 4000, seed=1)
    before = counters()
    tg.gammatone_iir_spectrogram(x if batched else x[0], SR, 320, 160,
                                 tg.ErbParams(8, 50.0, 8000.0), method=method,
                                 device="cpu", batched=batched)
    rows = 2 if batched else 1
    assert moved(before) == {"launches": 0, "gt_calls": 1, "gt_kernel_calls": 0,
                             "gt_scan_calls": 1, "gt_parallel_calls": 0,
                             "gt_filtered_samples": rows * 8 * 24 * 320}


class FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, fn):
        if fn == "gammatone_launch":
            return lambda *args: self.calls.append(args) or 0
        if fn == "gammatone_error_string":
            return lambda rc: b"an error"
        raise AttributeError(fn)


@pytest.fixture
def stub(monkeypatch):
    """CPU tensors report ``is_cuda``, the kernel's library is a recorder, the
    CUDA calls of ``Source.launch`` are faked, the counters start at 0."""
    lib = FakeLibrary()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build.SOURCES["gammatone"], "lib", lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 100, raising=False)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for name in COUNTERS:
        monkeypatch.setattr(erb, name, 0)
    return lib


LAUNCH_CASES = {
    # case: (input dtype, output dtype, batched, db_floor, input code, output code)
    "cell": (torch.float32, "float32", True, -80.0, 0, 0),
    "float64_in_out": (torch.float64, "float64", True, -60.0, 1, 1),
    "f32_in_f64_out": (torch.float32, "float64", True, None, 0, 1),
    "f64_in_f32_out": (torch.float64, "float32", False, None, 1, 0),
    "int16_in": (torch.int16, "float32", True, -80.0, 1, 0),
    "float16_in_bfloat16_out": (torch.float16, "bfloat16", False, -80.0, 1, 1),
}


@pytest.mark.parametrize("case", list(LAUNCH_CASES))
def test_a_cuda_call_launches_once_with_its_shapes(stub, case):
    in_dtype, out_dtype, batched, floor, in_code, out_code = LAUNCH_CASES[case]
    x = (tones(3, 5000, seed=2) * 1000).to(in_dtype)
    x = x if batched else x[0]
    params = tg.ErbParams(33, 50.0, 8000.0, db_floor=floor)
    out, cfs = tg.gammatone_iir_spectrogram(x, SR, 300, 170, params, dtype=out_dtype,
                                            device="cpu", batched=batched)
    n_frames, rows = 1 + (5000 - 300) // 170, 3 if batched else 1
    assert out.dtype == getattr(torch, out_dtype)
    assert tuple(out.shape) == ((3,) if batched else ()) + (33, n_frames)
    assert len(stub.calls) == 1
    call = stub.calls[0]
    window, a, b = erb._device_tables(tuple(cfs.tolist()), SR, 300, torch.device("cpu"))
    assert call[1:4] == (window.data_ptr(), a.data_ptr(), b.data_ptr())
    assert call[5:] == (rows, 5000, 300, 170, n_frames, 33, in_code, out_code,
                        int(floor is not None),
                        0.0 if floor is None else 10.0 ** (floor / 10.0), 100)
    assert counters() == {"launches": 1, "gt_calls": 1, "gt_kernel_calls": 1,
                          "gt_scan_calls": 0, "gt_parallel_calls": 0,
                          "gt_filtered_samples": rows * 33 * n_frames * 300}


def test_float_inputs_are_read_where_they_lie(stub):
    x = tones(2, 4000, seed=3)
    tg.gammatone_iir_spectrogram(x, SR, 320, 160, CELL, device="cpu", batched=True)
    assert stub.calls[0][0] == x.data_ptr()


@pytest.mark.parametrize("route", ["requires_grad", "parallel"])
def test_other_cuda_calls_take_their_torch_op_lowering(stub, route):
    x = tones(2, 4000, seed=4).to(torch.float64)
    p = tg.ErbParams(8, 50.0, 8000.0, db_floor=-80.0)
    kw = dict(method="parallel") if route == "parallel" else {}
    if route == "requires_grad":
        x.requires_grad_(True)
    got, _ = tg.gammatone_iir_spectrogram(x, SR, 320, 160, p, dtype="float64", device="cpu",
                                          batched=True, **kw)
    assert stub.calls == []
    assert counters() == {"launches": 0, "gt_calls": 1, "gt_kernel_calls": 0,
                          "gt_scan_calls": int(route != "parallel"),
                          "gt_parallel_calls": int(route == "parallel"),
                          "gt_filtered_samples": 2 * 8 * 24 * 320}
    assert got.requires_grad == (route == "requires_grad")
    with torch.no_grad(), pytest.MonkeyPatch.context() as m:   # the CPU's own route
        m.setattr(torch.Tensor, "is_cuda", property(lambda self: False))
        want, _ = tg.gammatone_iir_spectrogram(x.detach(), SR, 320, 160, p, dtype="float64",
                                               device="cpu", batched=True, **kw)
    assert torch.equal(got.detach(), want)


def test_an_empty_batch_launches_nothing(stub):
    out, _ = tg.gammatone_iir_spectrogram(torch.zeros((0, 4000)), SR, 320, 160, CELL,
                                          device="cpu", batched=True)
    assert tuple(out.shape) == (0, 64, 24) and stub.calls == []
    assert (erb.launches, erb.gt_kernel_calls, erb.gt_filtered_samples) == (0, 1, 0)


# ---- on the card -----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.build_kernels(["gammatone"])
    return torch.device("cuda", 0)


def scan_rms(x, params, frame, hop):
    """The torch-op scan's float64 RMS of the (..., n) signal on its device."""
    cfs = tg.gammatone_center_frequencies(params)
    window, a, b = erb._device_tables(tuple(cfs.tolist()), SR, frame, x.device)
    n_frames = 1 + (x.shape[-1] - frame) // hop
    return erb._gammatone_impl(x.to(torch.float64), window, a, b, frame, hop, n_frames)


def scan_call(x, params, frame, hop, **kw):
    """The whole call on the torch-op route: the same input, requiring grad."""
    with torch.no_grad():
        return tg.gammatone_iir_spectrogram(x.clone().requires_grad_(True), SR, frame, hop,
                                            params, **kw)[0]


def rms_params(params):
    return tg.ErbParams(params.n_filters, params.f_min, params.f_max, params.spacing)


CARD_CASES = {
    # case: (rows, n, frame, hop, bank)
    "cell": (4, 160000, 320, 160, CELL),
    "ragged_300_170": (3, 16000 + 77, 300, 170, CELL),
    "bands_5": (3, 16000, 320, 160, tg.ErbParams(5, 100.0, 4000.0, db_floor=-80.0)),
    "bands_33": (3, 16000, 300, 170, tg.ErbParams(33, 50.0, 8000.0, db_floor=-80.0)),
    "one_clip": (1, 48000, 320, 160, CELL),
    "frame_1100": (2, 16000, 1100, 256, tg.ErbParams(16, 80.0, 7000.0, db_floor=-60.0)),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_the_kernel_matches_the_scan_on_the_card(card, case):
    rows, n, frame, hop, params = CARD_CASES[case]
    x = tones(rows, n, seed=rows * n).to(card)
    before = counters()
    with torch.no_grad():
        rms, _ = tg.gammatone_iir_spectrogram(x, SR, frame, hop, rms_params(params),
                                              dtype="float64", batched=True)
        db, _ = tg.gammatone_iir_spectrogram(x, SR, frame, hop, params, dtype="float32",
                                             batched=True)
    torch.cuda.synchronize()
    assert moved(before)["launches"] == moved(before)["gt_kernel_calls"] == 2
    assert moved(before)["gt_scan_calls"] == 0
    want_rms = scan_rms(x, params, frame, hop)
    assert rms.dtype == torch.float64 and rms.shape == want_rms.shape
    assert float(((rms - want_rms).abs() / want_rms.abs()).max()) <= 1e-9
    want_db = scan_call(x, params, frame, hop, dtype="float32", batched=True)
    assert db.dtype == torch.float32 and db.shape == want_db.shape
    assert float((db - want_db).abs().max()) <= 1e-4


@pytest.mark.card
def test_a_1d_call_a_float64_input_and_no_db_floor_on_the_card(card):
    x = tones(1, 24000, seed=5)[0].to(card)
    p = rms_params(CELL)
    before = counters()
    with torch.no_grad():
        got32, _ = tg.gammatone_iir_spectrogram(x, SR, 320, 160, p, dtype="float64")
        got64, _ = tg.gammatone_iir_spectrogram(x.to(torch.float64), SR, 320, 160, p,
                                                dtype="float64")
    torch.cuda.synchronize()
    assert moved(before)["launches"] == moved(before)["gt_kernel_calls"] == 2
    assert got32.shape == (64, 149)
    assert torch.equal(got32, got64)    # a float32 input is read exactly as float64
    want = scan_rms(x, p, 320, 160)
    assert float(((got32 - want).abs() / want.abs()).max()) <= 1e-9


@pytest.mark.card
def test_a_batch_equals_its_rows_single_calls_on_the_card(card):
    x = tones(3, 16000, seed=6).to(card)
    with torch.no_grad():
        got, _ = tg.gammatone_iir_spectrogram(x, SR, 320, 160, CELL, dtype="float32",
                                              batched=True)
        rows = [tg.gammatone_iir_spectrogram(r, SR, 320, 160, CELL, dtype="float32")[0]
                for r in x]
    assert torch.equal(got, torch.stack(rows))


@pytest.mark.card
def test_each_call_launches_once_and_grad_takes_the_scan_on_the_card(card):
    x = tones(2, 16000, seed=7).to(card)
    before = counters()
    with torch.no_grad():
        for _ in range(3):
            tg.gammatone_iir_spectrogram(x, SR, 320, 160, CELL, batched=True)
    assert moved(before) == {"launches": 3, "gt_calls": 3, "gt_kernel_calls": 3,
                             "gt_scan_calls": 0, "gt_parallel_calls": 0,
                             "gt_filtered_samples": 3 * 2 * 64 * 99 * 320}
    before = counters()
    y = tg.gammatone_iir_spectrogram(x.clone().requires_grad_(True), SR, 320, 160, CELL,
                                     batched=True)[0]
    assert y.requires_grad
    assert moved(before) == {"launches": 0, "gt_calls": 1, "gt_kernel_calls": 0,
                             "gt_scan_calls": 1, "gt_parallel_calls": 0,
                             "gt_filtered_samples": 2 * 64 * 99 * 320}
