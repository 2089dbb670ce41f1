"""Generate spectrograms_tpu_torch/__init__.pyi from the runtime surface.

The stub is generated from the live package (signatures via
``inspect.signature``, docs from the runtime docstrings), so it cannot
drift from the implementation; ``tests/test_torch_port_stub.py``
regenerates it and compares. The port's counterpart of the JAX package's
``tools/gen_stub.py``, run on ``spectrograms_tpu_torch`` with arrays typed
as ``torch.Tensor``.

Run from the repository root: python -m spectrograms_tpu_torch.tools.gen_stub [--check]
"""

from __future__ import annotations

import dataclasses
import enum
import inspect
import sys
from pathlib import Path

import spectrograms_tpu_torch as tg

HEADER = '''"""Type stubs for spectrograms_tpu_torch — the complete public surface.

Auto-generated from the runtime by spectrograms_tpu_torch/tools/gen_stub.py;
do not edit by hand.
"""

from enum import Enum
from typing import Any, Callable, Dict, Iterator, List, Optional, Protocol, Sequence, Tuple, Union

import numpy as np
import torch

Array = torch.Tensor
DTypeLike = Any  # str | torch.dtype | np.dtype | type

'''


def _fmt_default(value) -> str:
    if value is inspect.Parameter.empty:
        return ""
    if isinstance(value, enum.Enum):
        return f" = {type(value).__name__}.{value.name}"
    if isinstance(value, (bool, int, str, type(None))):
        return f" = {value!r}"
    if isinstance(value, float):
        return f" = {value!r}"
    return " = ..."


def _fmt_signature(obj, skip_self: bool = False) -> str:
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return "(*args, **kwargs)"
    parts = []
    params = list(sig.parameters.values())
    if skip_self and params and params[0].name in ("self", "cls"):
        params = params[1:]
        parts.append("self")
    for p in params:
        if p.kind == inspect.Parameter.VAR_POSITIONAL:
            parts.append(f"*{p.name}")
        elif p.kind == inspect.Parameter.VAR_KEYWORD:
            parts.append(f"**{p.name}")
        elif p.kind == inspect.Parameter.KEYWORD_ONLY:
            if parts and not any(s.startswith("*") for s in parts):
                parts.append("*")
            parts.append(f"{p.name}{_fmt_default(p.default)}")
        else:
            parts.append(f"{p.name}{_fmt_default(p.default)}")
    return "(" + ", ".join(parts) + ")"


# Standard docs for boilerplate members whose runtime impls are undocumented.
_FALLBACK_DOCS = {
    "__init__": "Construct and validate; raises InvalidInputError on bad arguments.",
    "__array__": "NumPy protocol: device->host copy as an ndarray.",
    "__dlpack__": "DLPack export of the underlying device array (zero-copy).",
    "__dlpack_device__": "DLPack device tuple (device_type, device_id).",
    "__iter__": "Iterate over the produced items.",
    "__call__": "Apply to the given input.",
    "to_numpy": "Device->host copy of the data as a float ndarray.",
    "dtype": "Element dtype name of the computed data ('float32'/'float64').",
    "shape": "Data shape tuple.",
    "n_bins": "Number of frequency bins (rows).",
    "n_frames": "Number of time frames (columns).",
    "n_bands": "Number of output bands this source produces.",
    "sample_rate": "Sample rate of the source signal in Hz.",
    "hop_seconds": "Seconds advanced per output frame.",
    "center_frequencies": "Centre frequency of each output band in Hz.",
    "compute_matrix": "Signal -> (n_bands, n_frames) float matrix.",
    "duration": "Time span covered by the result in seconds.",
    "frequency_range": "(lowest, highest) frequency of the analysis band in Hz.",
    "histogram": "Per-frame histogram over the value range -> (num_bins, n_frames).",
    "compute": "Run the plan on a 1-D signal and return the result object.",
    "compute_power_spectrum": "One-shot |X|^2 of a (windowed) signal.",
    "compute_magnitude_spectrum": "One-shot |X| of a (windowed) signal.",
    "n_fft": "FFT size in samples.",
    "hop_size": "Hop (frame advance) in samples.",
    "window": "Analysis window specification.",
    "centre": "Whether frames are centred with n_fft//2 zero padding.",
    "build": "Finalize the builder into a validated params object.",
    "builder": "Start a builder for this params type.",
    "block_until_ready": "Block until the device computation finishes; returns self.",
    "frame_count": "Number of frames produced for a signal of the given length.",
    "output_shape": "(n_bins, n_frames) for a signal of the given length.",
    "compute_batch": "Batched (B, n) -> (B, n_bins, n_frames) in one device program.",
    "compute_frame": "Streaming single-frame computation at the given frame index.",
    "compute_into": "Compute into a preallocated numpy array (device->host copy).",
    "compute_raw": "Like compute() but returns only the raw device array.",
    "compute_stft": "Complex STFT of a signal via a cached plan.",
}


def _doc_block(obj, indent: str, member_name: str = "") -> str:
    doc = inspect.getdoc(obj)
    if not doc or doc.startswith("Initialize self."):
        doc = _FALLBACK_DOCS.get(member_name, "")
    if not doc:
        return ""
    safe = doc.replace("\\", "\\\\").replace('"""', "'''")
    lines = safe.split("\n")
    if len(lines) == 1:
        return f'{indent}"""{lines[0]}"""\n'
    return f'{indent}"""{lines[0]}\n' + "\n".join(
        (indent + l).rstrip() if l else "" for l in lines[1:]
    ) + f'\n{indent}"""\n'


def _emit_function(name: str, fn, out: list, indent: str = "", skip_self=False):
    deco = ""
    if isinstance(fn, property):
        deco = f"{indent}@property\n"
        fn = fn.fget
        if fn is None:
            return
    elif isinstance(fn, staticmethod):
        deco = f"{indent}@staticmethod\n"
        fn = fn.__func__
        skip_self = False
    elif isinstance(fn, classmethod):
        deco = f"{indent}@classmethod\n"
        fn = fn.__func__
        skip_self = True
    sig = _fmt_signature(fn, skip_self=skip_self)
    out.append(f"{deco}{indent}def {name}{sig}:\n")
    doc = _doc_block(fn, indent + "    ", member_name=name)
    out.append(doc if doc else "")
    out.append(f"{indent}    ...\n\n")


def _emit_enum(name: str, cls, out: list):
    out.append(f"class {name}(Enum):\n")
    out.append(_doc_block(cls, "    "))
    for member in cls:
        out.append(f"    {member.name} = {member.value!r}\n")
    # enum classmethod constructors (e.g. WindowType.kaiser/gaussian/custom)
    for mname, m in sorted(vars(cls).items()):
        if mname.startswith("_"):
            continue
        if isinstance(m, (classmethod, staticmethod)):
            _emit_function(mname, m, out, indent="    ")
        elif callable(m) and not isinstance(m, enum.Enum):
            _emit_function(mname, m, out, indent="    ", skip_self=True)
        elif isinstance(m, property):
            _emit_function(mname, m, out, indent="    ")
    out.append("\n")


def _emit_class(name: str, cls, out: list):
    if isinstance(cls, type) and issubclass(cls, enum.Enum):
        _emit_enum(name, cls, out)
        return
    bases = ""
    if isinstance(cls, type) and getattr(cls, "_is_protocol", False):
        bases = "(Protocol)"
    elif isinstance(cls, type) and issubclass(cls, BaseException):
        parent = cls.__mro__[1]
        bases = f"({parent.__name__})" if parent is not object else "(Exception)"
    out.append(f"class {name}{bases}:\n")
    doc = _doc_block(cls, "    ")
    out.append(doc)
    body_len = len(out)

    if dataclasses.is_dataclass(cls):
        for f in dataclasses.fields(cls):
            default = ""
            if f.default is not dataclasses.MISSING:
                default = _fmt_default(f.default).replace(" = ", " = ", 1) or " = ..."
            elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                default = " = ..."
            out.append(f"    {f.name}: Any{default}\n")
        out.append("\n")

    members = {}
    for klass in reversed(cls.__mro__ if isinstance(cls, type) else [cls]):
        if klass in (object,):
            continue
        members.update(vars(klass))

    if not dataclasses.is_dataclass(cls) and "__init__" in members:
        init = members["__init__"]
        if callable(init) and init is not object.__init__:
            _emit_function("__init__", init, out, indent="    ", skip_self=True)

    for mname in sorted(members):
        m = members[mname]
        if mname.startswith("_") and mname not in (
            "__array__", "__dlpack__", "__dlpack_device__", "__iter__", "__call__",
        ):
            continue
        if isinstance(m, property):
            _emit_function(mname, m, out, indent="    ")
        elif isinstance(m, (staticmethod, classmethod)):
            _emit_function(mname, m, out, indent="    ")
        elif inspect.isfunction(m):
            _emit_function(mname, m, out, indent="    ", skip_self=True)

    if len(out) == body_len and not doc:
        out.append("    ...\n")
    out.append("\n")


def generate() -> str:
    out = [HEADER]
    emitted_classes = []
    names = list(dict.fromkeys(tg.__all__))
    # Pass 1: enums + classes (so functions referencing them come after).
    for name in names:
        obj = getattr(tg, name)
        if isinstance(obj, type):
            _emit_class(name, obj, out)
            emitted_classes.append(name)
    # Pass 2: functions and other callables.
    for name in names:
        obj = getattr(tg, name)
        if isinstance(obj, type):
            continue
        if inspect.ismodule(obj):
            out.append(f"{name}: Any\n\n")
        elif callable(obj):
            _emit_function(name, obj, out)
        else:
            out.append(f"{name}: Any\n\n")
    out.append("__all__: List[str]\n")
    out.append("__version__: str\n")
    return "".join(out)


def main() -> int:
    target = Path(tg.__file__).with_name("__init__.pyi")
    text = generate()
    if "--check" in sys.argv:
        current = target.read_text() if target.exists() else ""
        if current != text:
            print("stale stub: re-run python -m spectrograms_tpu_torch.tools.gen_stub", file=sys.stderr)
            return 1
        print("stub up to date")
        return 0
    target.write_text(text)
    print(f"wrote {target} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
