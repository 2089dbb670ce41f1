"""``ops/_build.py``'s table of the CUDA sources, ``SOURCES``, and its one
launch call, ``Source.launch``, through which all six kernels launch.

On the CPU, with a fake library in place of a built one:

- each entry's signatures match its source's ``extern "C"`` entries, with
  each kernel's own checks (the build flags, the JAX kernel it ports, the
  tensor-core instruction);
- a launch that returns 0 is counted in its source's ``.launches``, one
  that returns an error raises with the source's error string and is not
  counted;
- a launch of another build of a source (a stage variant) is not counted;
- the device guard is entered only for tensors off the current device, and
  the stream is that device's current raw stream;
- ``launch_counts``/``add_launches`` read and move the six counters.

The tests marked ``card`` launch each source once on a side stream and hold
it against its plain version; they skip without CUDA. This file imports no
JAX, so on a card ``python3 -m pytest --noconftest
tests/test_torch_port_build.py -m card`` runs them.
"""

import contextlib
import ctypes
import re
import sys

import pytest
import torch

import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch.ops import _build
from spectrograms_tpu_torch.ops import delta as dops
from spectrograms_tpu_torch.ops import fused_factored as tff

NAMES = ["fused_features", "fused_tier_features", "delta", "mdct", "griffin_lim", "gammatone"]
tmdct = sys.modules["spectrograms_tpu_torch.mdct"]
trc = sys.modules["spectrograms_tpu_torch.reconstruct"]
terb = sys.modules["spectrograms_tpu_torch.erb"]


def owner(name):
    return {"fused_features": tff.fused_factored_features,
            "fused_tier_features": tff.fused_tier_features, "delta": dops, "mdct": tmdct,
            "griffin_lim": trc, "gammatone": terb}[name]


def test_the_table_lists_the_three_sources_in_counter_order():
    assert list(_build.SOURCES) == NAMES
    assert sorted(p.stem for p in _build._CSRC.glob("*.cu")) == sorted(NAMES)
    # each source's counter, named by the module that owns it
    assert all(_build.SOURCES[name].counter is owner(name) for name in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_launch_signature_matches_the_c_entry(name):
    src = (_build._CSRC / f"{name}.cu").read_text()
    # the entries outside #ifdef: a stage variant's own entries are not in the table
    plain = re.sub(r"#ifdef.*?#endif", "", src, flags=re.S)
    exported = dict(re.findall(r'extern "C" [^(]*?\b(\w+)\(([^)]*)\)', plain))
    sigs = _build.SOURCES[name].signatures
    assert set(exported) == set(sigs) == {f"{name}_launch", f"{name}_error_string"}
    assert sigs[f"{name}_error_string"] == ([ctypes.c_int], ctypes.c_char_p)
    argtypes, restype = sigs[f"{name}_launch"]
    assert restype is ctypes.c_int
    params = [q.strip() for q in exported[f"{name}_launch"].split(",")]
    assert len(params) == len(argtypes)
    c_type = {ctypes.c_int: "int ", ctypes.c_longlong: "long long ", ctypes.c_float: "float ",
              ctypes.c_double: "double "}
    for param, argtype in zip(params, argtypes):
        if argtype is ctypes.c_void_p:
            assert "*" in param, param
        else:
            assert param.startswith(c_type[argtype]) and "*" not in param, (param, argtype)
    assert params[-1] == "void* stream"
    if name == "fused_features":
        assert "pallas_factored.py::_kernel" in src
        assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    elif name == "fused_tier_features":
        assert "pallas_factored.py::_kernel" in src
        assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    elif name == "delta":
        assert "ops/delta.py::_DTYPES" in src
    elif name == "mdct":
        assert "Replaces no Pallas kernel" in src and "mdct.py::_kernel_tables" in src
        assert "wgmma" not in src and "mma.sync" not in src
    elif name == "griffin_lim":
        assert "Replaces no Pallas kernel" in src and "reconstruct.py::_kernel_tables_np" in src
        assert "wgmma" not in src and "mma.sync" not in src
    else:
        assert "Replaces no Pallas kernel" in src and "erb.py::_gammatone_impl" in src
        assert "erb.py::_KERNEL_DTYPES" in src and "jax.lax.scan" in src
        assert "wgmma" not in src and "mma.sync" not in src


class FakeLibrary:
    """A source's C entries, returning ``rc`` and recording each launch's
    arguments."""

    def __init__(self, name, rc=0):
        self.name, self.rc, self.calls = name, rc, []

    def __getattr__(self, fn):
        if fn == self.name + "_launch":
            return lambda *args: self.calls.append(args) or self.rc
        if fn == self.name + "_error_string":
            return lambda rc: b"an error"
        raise AttributeError(fn)


@pytest.fixture
def fake_cuda(monkeypatch):
    """Device 0 is current, each device's current raw stream is 100 + its
    index, and the guards entered are recorded."""
    guards = []

    @contextlib.contextmanager
    def guard(device):
        guards.append(device)
        yield

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 100 + dev,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", guard)
    return guards


def args_of(name):
    """Placeholder arguments, one for each before the stream."""
    return tuple(range(len(_build.SOURCES[name].signatures[f"{name}_launch"][0]) - 1))


@pytest.mark.parametrize("rc", [0, 700])
@pytest.mark.parametrize("name", NAMES)
def test_launch_counts_only_launches_that_return(monkeypatch, fake_cuda, name, rc):
    lib = FakeLibrary(name, rc)
    monkeypatch.setattr(_build.SOURCES[name], "lib", lib)
    monkeypatch.setattr(owner(name), "launches", 0)
    args = args_of(name)
    if rc:
        with pytest.raises(tg.FftBackendError,
                           match=rf"^{name} kernel launch failed: an error \(700\)$"):
            _build.SOURCES[name].launch(torch.device("cuda", 0), *args)
    else:
        assert _build.SOURCES[name].launch(torch.device("cuda", 0), *args) is None
    assert lib.calls == [(*args, 100)]
    assert owner(name).launches == (1 if rc == 0 else 0)
    assert fake_cuda == []


@pytest.mark.parametrize("name", NAMES)
def test_a_launch_of_another_build_is_not_counted(monkeypatch, fake_cuda, name):
    own, variant = FakeLibrary(name), FakeLibrary(name)
    monkeypatch.setattr(_build.SOURCES[name], "lib", own)
    monkeypatch.setattr(owner(name), "launches", 0)
    _build.SOURCES[name].launch(torch.device("cuda", 0), *args_of(name), lib=variant)
    assert own.calls == [] and len(variant.calls) == 1
    assert owner(name).launches == 0
    with pytest.raises(tg.FftBackendError, match="an error"):
        _build.SOURCES[name].launch(torch.device("cuda", 0), *args_of(name),
                                    lib=FakeLibrary(name, 700))


@pytest.mark.parametrize("index", [0, 1], ids=["current", "other"])
@pytest.mark.parametrize("name", NAMES)
def test_a_tensor_off_the_current_device_enters_the_guard(monkeypatch, fake_cuda, name, index):
    lib = FakeLibrary(name)
    monkeypatch.setattr(_build.SOURCES[name], "lib", lib)
    monkeypatch.setattr(owner(name), "launches", 0)
    device = torch.device("cuda", index)
    _build.SOURCES[name].launch(device, *args_of(name))
    assert fake_cuda == ([device] if index else [])
    assert lib.calls == [(*args_of(name), 100 + index)]     # that device's stream
    assert owner(name).launches == 1


def test_launch_counts_read_and_move_the_three_counters(monkeypatch):
    for name, n in zip(NAMES, (5, 6, 7, 8, 9, 10)):
        monkeypatch.setattr(owner(name), "launches", n)
    assert _build.launch_counts() == (5, 6, 7, 8, 9, 10)
    _build.add_launches((1, 0, 2, 3, 4, 5), -1)
    assert (tff.fused_factored_features.launches, tff.fused_tier_features.launches,
            dops.launches, tmdct.launches, trc.launches, terb.launches) == (4, 6, 5, 5, 5, 5)
    _build.add_launches((1, 0, 2, 3, 4, 5))
    assert _build.launch_counts() == (5, 6, 7, 8, 9, 10)


def test_the_library_is_loaded_once_and_typed_by_the_table(monkeypatch):
    loaded = []

    class Entry:
        pass

    class Library:
        def __init__(self, path):
            loaded.append(path)
            self.delta_launch, self.delta_error_string = Entry(), Entry()

    monkeypatch.setattr(_build.SOURCES["delta"], "lib", None)
    monkeypatch.setattr(_build, "build_all", lambda names: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", Library)
    lib = _build.load_library("delta")
    assert _build.load_library("delta") is lib is _build.SOURCES["delta"].lib
    assert loaded == [str(_build._library_path("delta")[1])]
    for fn, (argtypes, restype) in _build.SOURCES["delta"].signatures.items():
        assert getattr(lib, fn).argtypes == argtypes and getattr(lib, fn).restype is restype


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def card_case(name, device):
    """(call, plain version, input) of a small launch of ``name``."""
    from spectrograms_tpu_torch.ops.filterbanks import mel_filterbank

    g = torch.Generator().manual_seed(3)
    if name == "gammatone":     # against the torch-op scan, which an input that requires grad takes
        def bank(x):
            with torch.no_grad():
                return tg.gammatone_iir_spectrogram(x, 16000.0, 320, 160,
                                                    tg.ErbParams(40, 50.0, 8000.0),
                                                    dtype="float64", batched=True)[0]
        return (bank, (lambda x: bank(x.clone().requires_grad_(True))),
                torch.randn((3, 16000), generator=g).to(device))
    if name == "griffin_lim":    # the start launch, against its twin
        mag_t = torch.rand((2, 40, 257), generator=g).to(device)
        angles = trc._initial_angles(None, mag_t.shape, torch.float32, device)
        w64 = tg.make_window(tg.WindowType.hanning, 512).astype("float64")
        mag_k, angles_k, tables, _ = trc._kernel_inputs(mag_t, angles, w64, 512, 128)
        return ((lambda m: trc._kernel_run(m, angles_k, tables, 512, 128, 0, 0.99,
                                            trc._kernel_step)),
                (lambda m: trc.griffin_lim_kernel_twin(m, angles_k, tables, 512, 128, 0, 0.99)),
                mag_k)
    if name == "mdct":
        fwd, _ = tmdct._consts_for(tg.MdctParams.sine_window(512), False, torch.float32, device)
        return ((lambda x: tmdct._mdct_impl(x, fwd, 512, 256)),
                (lambda x: tmdct._mdct_impl(x, fwd.clone(), 512, 256)),
                torch.randn((3, 16000), generator=g).to(device))
    if name == "delta":
        x = torch.randn((4, 40, 300), generator=g).to(device)
        return (lambda x: dops.launch(x, 9, 2)), (lambda x: dops.delta_reference(x, 9, 2)), x
    mel = tff.KernelConst(mel_filterbank(16000.0, 1024, tg.MelParams(128, 0.0, 8000.0,
                                                                    tg.MelNorm.SLANEY)))
    window = tuple(tg.make_window(tg.WindowType.hanning, 1024).tolist())
    run = tff.fused_factored_features(1024, 256, window, mel, device=str(device),
                                      precision="bf16x3" if name == "fused_features" else "bf16")
    assert run.source == name
    return run, run.plain, torch.randn((3, 16000), generator=g).to(device)


@pytest.mark.card
@pytest.mark.parametrize("name", NAMES)
def test_each_source_launches_once_on_the_current_stream_on_the_card(card, name):
    _build.build_kernels([name])
    call, plain, x = card_case(name, card)
    ref = plain(x)
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    before = _build.launch_counts()
    with torch.cuda.stream(stream):
        got = call(x)
    stream.synchronize()
    moved = tuple(b - a for a, b in zip(before, _build.launch_counts()))
    assert moved == tuple(int(n == name) for n in NAMES)
    if name == "delta":
        assert torch.equal(got, ref)
    elif name == "gammatone":   # float64 RMS, the kernel's multiply-adds fused
        assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-9
    elif name in ("mdct", "griffin_lim"):    # against the dense chain, the twin
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:   # mel power; the tier's 1 pass rounds its products to bf16
        limit = (1e-4 if name == "fused_features" else 5e-3) * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= limit
