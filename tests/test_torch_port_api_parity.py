"""The port's public surface against the JAX package's, module by module.

One case per public module of ``spectrograms_tpu`` outside ``ops.*`` and
``tools.*``, and one for the package itself. Each compares the module's
``__all__`` (its public names where it has none) and, for each public
function and each public method of each public class (its constructor
included), the parameters' names, order, kinds and defaults; a leading
``self``/``cls`` and parameters whose names start with ``_`` are left out.
The differences below are not faults, each for the reason beside it; any
other difference fails.

Beside it, each fault that this comparison found, held against the JAX
function on the same inputs: ``runtime.load_library(build_if_missing=)``,
``torch.batch``/``batch_with_metadata(results=...)`` and
``dtypes.to_numpy_safe``; and the check that ``profiling.trace`` makes of
a trace's kernel launches.
"""

import importlib
import inspect
import pkgutil
import types

import jax  # noqa: F401  (conftest keeps it on the CPU)
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch import profiling
from spectrograms_tpu_torch.errors import FftBackendError
from tests.conftest import noise

# Keywords that only the port's functions take; left out of the port's side
# where the JAX function lacks them.
PORT_KEYWORDS = {
    "device": "results and plans live on a torch device, CUDA unless asked",
    "precision": "the spectrogram one-shots take a plan's tier, as the plans do",
    "init_angles": "griffin_lim takes a starting phase, to compare it with JAX's draw",
}
# Names that only the port's __all__ has.
PORT_NAMES = {
    "Precision": "stands in for jax.lax.Precision",
    "plan_constants_from_numpy": "carries a JAX plan's constants into a port plan",
}
# A JAX name and the port's name for the same function.
RENAMED = {"ulaw_decode_jax": "ulaw_decode_torch"}  # the dequant returns a torch tensor
# Constructor fields of one package alone: (JAX's, the port's).
FIELDS = {
    # a TPU's VMEM; the card's f32 rate outside the tensor cores and its power limit
    "ChipSpec": ({"vmem_mb"}, {"f32_tflops", "power_limit_w"}),
    # the f32 work a tier kernel runs beside its tensor-core products, at that f32 rate
    "CostEstimate": (set(), {"f32_flops"}),
}
# (function, parameter): (JAX's default, the port's).
DEFAULTS = {
    # None takes the route's own rate: the tier kernel's routes are graded at bf16
    ("roofline", "dtype"): ("'float32'", "None"),
}


def _walk(pkg):
    prefix = pkg.__name__ + "."
    return sorted(m.name[len(prefix):] for m in pkgutil.walk_packages(pkg.__path__, prefix))


MODULES = [""] + [m for m in _walk(sg) if m.split(".")[0] not in ("ops", "tools")]


def _module(pkg: str, name: str):
    return importlib.import_module(pkg + ("." + name if name else ""))


def _public(mod) -> list:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return sorted(n for n, o in vars(mod).items()
                  if not n.startswith("_") and not isinstance(o, types.ModuleType))


def _params(fn):
    """[(name, kind, repr of the default)] of ``fn``, or None where Python
    cannot read its signature (builtins)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    out = []
    for i, p in enumerate(sig.parameters.values()):
        if (i == 0 and p.name in ("self", "cls")) or p.name.startswith("_"):
            continue
        out.append((p.name, p.kind.name, "-" if p.default is p.empty else repr(p.default)))
    return out


def _excused(label, jax_params, port_params, used):
    """Both sides with the listed differences taken out."""
    if jax_params is None or port_params is None:
        return jax_params, port_params
    owner, fn = label
    jax_names = {p[0] for p in jax_params}
    port = []
    for p in port_params:
        if p[0] in PORT_KEYWORDS and p[0] not in jax_names:
            used.add(("keyword", p[0]))
            continue
        port.append(p)
    jax_side = list(jax_params)
    if fn == "__init__" and owner in FIELDS:
        theirs, ours = FIELDS[owner]
        used.add(("fields", owner))
        jax_side = [p for p in jax_side if p[0] not in theirs]
        port = [p for p in port if p[0] not in ours]
    for i, p in enumerate(port):
        key = (fn, p[0])
        if (key in DEFAULTS and i < len(jax_side) and jax_side[i][:2] == p[:2]
                and (jax_side[i][2], p[2]) == DEFAULTS[key]):
            used.add(("default", key))
            port[i] = jax_side[i]
    return jax_side, port


def _methods(cls) -> set:
    return {n for n in dir(cls) if not n.startswith("_")
            and callable(getattr(cls, n, None)) and not inspect.isclass(getattr(cls, n))}


def _differences(name: str, used: set) -> list:
    """Every difference of module ``name`` between the packages that the
    lists above do not excuse."""
    jmod, tmod = _module("spectrograms_tpu", name), _module("spectrograms_tpu_torch", name)
    theirs = {RENAMED.get(n, n) for n in _public(jmod)}
    ours = set(_public(tmod))
    for n in ours - theirs:
        if n in PORT_NAMES:
            used.add(("name", n))
    for n in _public(jmod):
        if n in RENAMED:
            used.add(("renamed", n))
    ours -= set(PORT_NAMES)
    out = [f"{name}: only JAX's {sorted(theirs - ours)}, only the port's {sorted(ours - theirs)}"
           ] if theirs != ours else []
    for jname in sorted(_public(jmod)):
        tname = RENAMED.get(jname, jname)
        a, b = getattr(jmod, jname, None), getattr(tmod, tname, None)
        if b is None or not (getattr(a, "__module__", None) or "").startswith("spectrograms_tpu"):
            continue  # missing (reported above), or a constant
        if inspect.isclass(a) != inspect.isclass(b):
            out.append(f"{name}.{jname}: a class in one package only")
            continue
        if inspect.isclass(a):
            pairs = [("__init__", a, b)] + [(m, getattr(a, m, None), getattr(b, m, None))
                                             for m in sorted(_methods(a) | _methods(b))]
            for meth, fa, fb in pairs:
                if fa is None or fb is None:
                    out.append(f"{name}.{jname}.{meth}: in {'JAX' if fb is None else 'the port'}"
                               " only")
                    continue
                ja, pb = _excused((jname, meth), _params(fa), _params(fb), used)
                if ja != pb:
                    out.append(f"{name}.{jname}.{meth}: JAX {ja}, the port {pb}")
        elif callable(a) and callable(b):
            ja, pb = _excused((None, jname), _params(a), _params(b), used)
            if ja != pb:
                out.append(f"{name}.{jname}: JAX {ja}, the port {pb}")
    return out


@pytest.mark.parametrize("name", MODULES, ids=lambda m: m or "package")
def test_public_surface_matches_jax(name):
    assert _differences(name, set()) == []


def test_every_listed_difference_occurs():
    # the lists above hold what the surfaces differ in, and nothing more
    used = set()
    for name in MODULES:
        _differences(name, used)
    listed = ({("keyword", k) for k in PORT_KEYWORDS} | {("name", n) for n in PORT_NAMES}
              | {("renamed", n) for n in RENAMED} | {("fields", c) for c in FIELDS}
              | {("default", k) for k in DEFAULTS})
    assert used == listed


# ---- runtime.load_library(build_if_missing=) --------------------------------------

def test_load_library_without_build_raises_as_jax(tmp_path, monkeypatch):
    from spectrograms_tpu.runtime import native as jn
    from spectrograms_tpu_torch.runtime import native as tn

    # a library path in tmp_path that does not exist, in each package
    monkeypatch.setattr(jn, "_LIB", tmp_path / "jax" / "libsgtpu.so")
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path / "port")
    builds = []
    for m in (jn, tn):
        monkeypatch.setattr(m, "_lib", None)
        monkeypatch.setattr(m, "_load_failed", False)

        def build(force=False, _m=m):
            builds.append(_m)
            raise _m.NativeUnavailable("no compiler here")

        monkeypatch.setattr(m, "build_library", build)
    paths = {jn: jn._LIB, tn: tn.library_path()}
    texts = {}
    for m in (jn, tn):
        with pytest.raises(m.NativeUnavailable, match="not built$"):
            m.load_library(build_if_missing=False)
        assert m._load_failed and m._lib is None
    assert builds == [] and not any(tmp_path.iterdir())  # nothing was built
    # after a failed load, False raises without looking again: the file that
    # appears meanwhile is not loaded
    for m in (jn, tn):
        paths[m].parent.mkdir(parents=True)
        paths[m].write_bytes(b"")
        with pytest.raises(m.NativeUnavailable) as e:
            m.load_library(build_if_missing=False)
        texts[m] = str(e.value)
    assert texts[jn] == texts[tn] == "native library previously failed to load"
    # True builds again
    for m in (jn, tn):
        with pytest.raises(m.NativeUnavailable, match="no compiler here"):
            m.load_library()
    assert builds == [jn, tn]


def test_load_library_builds_and_loads_by_default(monkeypatch):
    from spectrograms_tpu_torch.runtime import native as tn

    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_load_failed", True)  # an earlier failure does not stop True
    lib = tn.load_library()
    assert lib is tn._lib and tn.native_available()
    assert tn.load_library(build_if_missing=False) is lib


# ---- torch.batch / batch_with_metadata(results=...) -------------------------------

def _results(m, lengths):
    kw = dict(device="cpu") if m is tg else {}
    params = m.SpectrogramParams(m.StftParams(512, 128), 16000.0)
    mel = m.MelParams(40, 0.0, 8000.0)
    return [m.compute_mel_db_spectrogram(noise(n, seed=i), params, mel, dtype="float64", **kw)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("pad", [False, True])
def test_torch_batch_takes_results_as_jax(pad):
    import spectrograms_tpu.torch as sgt
    import spectrograms_tpu_torch.torch as tgt

    lengths = [8000, 6000, 8000] if pad else [8000, 8000]
    theirs, ours = _results(sg, lengths), _results(tg, lengths)
    want = sgt.batch(results=theirs, pad=pad)
    got = tgt.batch(results=ours, device="cpu", pad=pad)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    got_m, meta = tgt.batch_with_metadata(results=ours, device="cpu", pad=pad)
    want_m, want_meta = sgt.batch_with_metadata(results=theirs, pad=pad)
    assert torch.equal(got_m, got)
    np.testing.assert_allclose(got_m.numpy(), want_m.numpy(), atol=1e-6)
    assert len(meta) == len(want_meta) == len(lengths)
    for mine, ref in zip(meta, want_meta):
        assert mine.keys() == ref.keys()
        assert tuple(mine["shape"]) == tuple(ref["shape"])
        np.testing.assert_allclose(mine["frequencies"], ref["frequencies"])
        np.testing.assert_allclose(mine["times"], ref["times"])
        np.testing.assert_allclose(mine["db_range"], ref["db_range"], atol=1e-6)


# ---- dtypes.to_numpy_safe -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_to_numpy_safe_matches_jax_on_numpy_and_tensors(dtype):
    from spectrograms_tpu import dtypes as jd
    from spectrograms_tpu_torch import dtypes as td

    assert "to_numpy_safe" in td.__all__
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5))
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal((3, 5))
    x = x.astype(dtype)
    for arr in (x, list(x[0])):
        want, got = jd.to_numpy_safe(arr), td.to_numpy_safe(arr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # a tensor, one that requires grad where the type allows it, a conjugate view
    t = torch.from_numpy(x.copy())
    tensors = [t, t.conj()] if t.is_complex() else [t, t.clone().requires_grad_(True)]
    for ten in tensors:
        got = td.to_numpy_safe(ten)
        want = jd.to_numpy_safe(ten.detach().resolve_conj())
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        got[...] = 0  # a copy: the tensor keeps its values
        assert torch.equal(ten.detach().resolve_conj(), torch.from_numpy(want))


# ---- profiling.trace: kernel launches without their kernels -----------------------

def _event(cat, name, correlation, ts=0.0, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "tid": tid,
            "args": {"correlation": correlation}}


def test_trace_check_finds_launches_whose_kernel_is_missing():
    launches = [_event("cuda_runtime", "cudaLaunchKernel", 1),
                _event("cuda_runtime", "cudaLaunchKernelExC", 2),
                _event("cuda_driver", "cuLaunchKernel", 3),
                _event("cuda_runtime", "cudaMemcpyAsync", 4)]
    kernels = [_event("kernel", "fused_features_kernel<9>", 1),
               _event("kernel", "gemm", 2), _event("kernel", "triton_kernel", 3),
               _event("gpu_memcpy", "Memcpy HtoD", 4)]
    names = ["cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"]
    assert profiling.lost_kernels(launches + kernels) == (names, [])
    assert profiling.lost_kernels(launches + kernels[1:]) == (names, ["cudaLaunchKernel"])
    assert profiling.lost_kernels(launches) == (names, names)
    assert profiling.lost_kernels([]) == ([], [])
    # a launch made while its thread captures a CUDA graph runs no kernel;
    # one after the capture ends, or on another thread, must have its kernel
    window = [_event("cuda_runtime", "cudaStreamBeginCapture", 5, ts=10.0),
              _event("cuda_runtime", "cudaLaunchKernel", 6, ts=11.0),
              _event("cuda_runtime", "cudaLaunchKernel", 7, ts=12.0, tid=2),
              _event("cuda_runtime", "cudaStreamEndCapture", 8, ts=13.0),
              _event("cuda_runtime", "cudaLaunchKernel", 9, ts=14.0)]
    assert profiling.lost_kernels(window) == (["cudaLaunchKernel"] * 2, ["cudaLaunchKernel"] * 2)
    ran = [_event("kernel", "k", 7), _event("kernel", "k", 9)]
    assert profiling.lost_kernels(window + ran) == (["cudaLaunchKernel"] * 2, [])
    # a call that only asks about capture exempts nothing
    asked = [_event("cuda_runtime", "cudaStreamGetCaptureInfo", 5, ts=-1.0),
             _event("cuda_runtime", "cudaThreadExchangeStreamCaptureMode", 6, ts=-1.0)]
    assert profiling.lost_kernels(asked + launches + kernels[1:]) == (names, ["cudaLaunchKernel"])


def test_trace_on_the_cpu_checks_no_kernels(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as tr:
        torch.ones(4).sum()
    assert tr.path is not None and tr.path.startswith(str(tmp_path))


def test_trace_raises_when_the_window_lost_a_kernel(tmp_path, monkeypatch):
    # the exit of a CUDA trace, its synchronize and its events stood in for
    tr = profiling.trace(str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(profiling, "lost_kernels",
                        lambda events: (["cudaLaunchKernel"] * 2, ["cudaLaunchKernel"]))
    with pytest.raises(FftBackendError, match="not the kernels of 1 of them"):
        with tr:
            tr.device = torch.device("cuda")
            torch.ones(4).sum()
    assert tr.path is not None and tr.path.startswith(str(tmp_path))
    # an error raised inside the window is not replaced by the check's
    tr = profiling.trace(str(tmp_path), device="cpu")
    with pytest.raises(KeyError):
        with tr:
            tr.device = torch.device("cuda")
            raise KeyError("inside")
