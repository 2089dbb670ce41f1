"""Serialization of params and results (the reference's ``serde`` feature).

Counterpart of ``spectrograms_tpu.serde``, with its registry and formats,
so that a file written by one package loads in the other:

- **JSON** (``to_json``/``from_json``): human-readable, arrays inlined as
  lists.
- **NPZ** (``save``/``load``): binary, arrays stored as native NumPy
  payloads and the structure as an embedded JSON document.

Plans are not serialized; they are rebuilt from params. Tensors are
written from the host (a copy off the card). On reading, a result's device
data (its ``data`` field, ``_DEVICE_FIELDS``) becomes a tensor on
``device`` (CUDA unless ``device="cpu"``); its axes stay host numpy, as
the port's result classes hold them. Every registered type round-trips:
``from_dict(to_dict(x))`` equals ``x``.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import sys
from typing import Any, Dict, Type

import numpy as np
import torch

from .dtypes import resolve_device
from .errors import InvalidInputError

__all__ = [
    "to_dict",
    "from_dict",
    "to_json",
    "from_json",
    "save",
    "load",
    "register_type",
]

_REGISTRY: Dict[str, Type] = {}
_BUILTINS_LOADED = False

# The result types' fields that live on the device: decoded to tensors on
# ``device``. The field names are the JAX package's (its results' fields,
# or ``vars()`` with one leading underscore stripped, are the same).
_DEVICE_FIELDS = {
    name: ("data",)
    for name in ("Spectrogram", "StftResult", "Mfcc", "Chromagram", "CqtResult",
                 "ItdSpectrogram", "IpdSpectrogram", "IldSpectrogram", "IlrSpectrogram")
}


def register_type(cls: Type, name: str | None = None) -> Type:
    """Register a class for (de)serialization. Usable as a decorator."""
    _REGISTRY[name or cls.__name__] = cls
    return cls


def _registry() -> Dict[str, Type]:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return _REGISTRY
    _BUILTINS_LOADED = True
    # Deferred, and looked up in sys.modules: the package imports every one
    # of these modules and rebinds some names (mfcc, chroma, cqt, mdct) to
    # functions.
    mod = {name: sys.modules[f"{__package__}.{name}"]
           for name in ("binaural", "params", "pipeline", "windows", "mfcc", "chroma",
                        "cqt", "mdct")}
    params_mod, binaural = mod["params"], mod["binaural"]
    for cls in (
        mod["windows"].WindowType,
        params_mod.StftParams,
        params_mod.SpectrogramParams,
        params_mod.LogParams,
        params_mod.MelNorm,
        params_mod.MelParams,
        params_mod.LogHzParams,
        params_mod.ErbSpacing,
        params_mod.ErbParams,
        params_mod.GammatoneParams,
        params_mod.CqtParams,
        params_mod.ChromaNorm,
        params_mod.ChromaParams,
        params_mod.MfccParams,
        mod["mdct"].MdctParams,
        mod["pipeline"].FreqScale,
        mod["pipeline"].AmpScale,
        mod["pipeline"].Spectrogram,
        mod["pipeline"].StftResult,
        mod["mfcc"].Mfcc,
        mod["chroma"].Chromagram,
        mod["cqt"].CqtResult,
        binaural.ITDSpectrogramParams,
        binaural.IPDSpectrogramParams,
        binaural.ILDSpectrogramParams,
        binaural.ILRSpectrogramParams,
        binaural.ItdSpectrogram,
        binaural.IpdSpectrogram,
        binaural.IldSpectrogram,
        binaural.IlrSpectrogram,
    ):
        register_type(cls)
    return _REGISTRY


def _is_array(v: Any) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _encode(v: Any, arrays: list | None = None) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, enum.Enum):
        return {"__enum__": type(v).__name__, "name": v.name}
    if isinstance(v, complex):
        return {"__complex__": [v.real, v.imag]}
    if _is_array(v):
        arr = _host(v)
        if arrays is not None:
            # Binary sink: store the ndarray itself, reference it in the doc.
            arrays.append(arr)
            return {"__npz_ref__": len(arrays) - 1}
        if np.iscomplexobj(arr):
            return {
                "__ndarray__": {
                    "dtype": str(arr.dtype),
                    "shape": list(arr.shape),
                    "real": arr.real.ravel().tolist(),
                    "imag": arr.imag.ravel().tolist(),
                }
            }
        return {
            "__ndarray__": {
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
                "data": arr.ravel().tolist(),
            }
        }
    if isinstance(v, (list, tuple)):
        return {"__seq__": "tuple" if isinstance(v, tuple) else "list",
                "items": [_encode(i, arrays) for i in v]}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return to_dict(v, _arrays=arrays)
    if hasattr(v, "__dict__") and type(v).__name__ in _registry():
        return to_dict(v, _arrays=arrays)
    raise InvalidInputError(f"cannot serialize value of type {type(v).__name__}")


def _decode(v: Any, device) -> Any:
    if isinstance(v, np.ndarray):
        return v  # placed directly by load()
    if not isinstance(v, dict):
        return v
    if "__enum__" in v:
        cls = _registry().get(v["__enum__"])
        if cls is None:
            raise InvalidInputError(f"unknown enum type {v['__enum__']}")
        return cls[v["name"]]
    if "__complex__" in v:
        re, im = v["__complex__"]
        return complex(re, im)
    if "__ndarray__" in v:
        meta = v["__ndarray__"]
        dt = np.dtype(meta["dtype"])
        if "real" in meta:
            arr = np.asarray(meta["real"], dtype=np.float64) + 1j * np.asarray(
                meta["imag"], dtype=np.float64
            )
            return arr.astype(dt).reshape(meta["shape"])
        return np.asarray(meta["data"]).astype(dt).reshape(meta["shape"])
    if "__seq__" in v:
        items = [_decode(i, device) for i in v["items"]]
        return tuple(items) if v["__seq__"] == "tuple" else items
    if "__type__" in v:
        return from_dict(v, device=device)
    return v


def to_dict(obj: Any, _arrays: list | None = None) -> Dict[str, Any]:
    """Serialize a registered params/result object to a JSON-able dict.

    ``_arrays`` is the internal binary sink used by :func:`save`: arrays are
    appended there and referenced instead of inlined as lists."""
    reg = _registry()
    name = type(obj).__name__
    if isinstance(obj, enum.Enum):
        return {"__enum__": name, "name": obj.name}
    if name not in reg:
        raise InvalidInputError(f"type {name} is not registered for serialization")
    if dataclasses.is_dataclass(obj):
        fields = {
            f.name: _encode(getattr(obj, f.name), _arrays)
            for f in dataclasses.fields(obj)
        }
    else:
        # Strip at most ONE leading underscore: lstrip("_") would collapse
        # `_x` and `x` (or a dunder attr) into one key and corrupt round-trips.
        fields = {}
        for k, v in vars(obj).items():
            key = k[1:] if k.startswith("_") else k
            if key in fields:
                raise InvalidInputError(
                    f"serialization key collision on {key!r} for type {name}"
                )
            fields[key] = _encode(v, _arrays)
    return {"__type__": name, "fields": fields}


def from_dict(d: Dict[str, Any], device=None) -> Any:
    """Reconstruct an object serialized by :func:`to_dict`; a result's
    device data goes to ``device`` (CUDA unless ``device="cpu"``)."""
    if "__enum__" in d:
        return _decode(d, device)
    if "__type__" not in d:
        raise InvalidInputError("missing __type__ tag")
    cls = _registry().get(d["__type__"])
    if cls is None:
        raise InvalidInputError(f"unknown type {d['__type__']}")
    kwargs = {k: _decode(v, device) for k, v in d["fields"].items()}
    on_device = [k for k in _DEVICE_FIELDS.get(d["__type__"], ()) if _is_array(kwargs.get(k))]
    if on_device:
        dev = resolve_device(device)
        for k in on_device:
            kwargs[k] = torch.as_tensor(kwargs[k]).to(dev)
    return cls(**kwargs)


def to_json(obj: Any, indent: int | None = None) -> str:
    """Serialize to a JSON string.

    Examples
    --------
    >>> from spectrograms_tpu_torch import StftParams
    >>> from spectrograms_tpu_torch.serde import from_json, to_json
    >>> from_json(to_json(StftParams(1024, 256))) == StftParams(1024, 256)
    True
    """
    return json.dumps(to_dict(obj), indent=indent)


def from_json(s: str, device=None) -> Any:
    """Reconstruct from :func:`to_json` output (``device`` as in
    :func:`from_dict`)."""
    return from_dict(json.loads(s), device=device)


# ---- binary NPZ checkpoint format ------------------------------------------

def _inject_arrays(node: Any, arrays: Dict[str, np.ndarray]) -> Any:
    """Replace {__npz_ref__} nodes with the loaded ndarrays themselves."""
    if isinstance(node, dict):
        if "__npz_ref__" in node:
            return arrays[f"arr_{node['__npz_ref__']}"]
        return {k: _inject_arrays(v, arrays) for k, v in node.items()}
    if isinstance(node, list):
        return [_inject_arrays(v, arrays) for v in node]
    return node


def save(obj: Any, path) -> None:
    """Save a params/result object as an .npz checkpoint (arrays binary,
    never round-tripped through Python lists)."""
    arrays: list = []
    doc = to_dict(obj, _arrays=arrays)
    payload = {f"arr_{i}": a for i, a in enumerate(arrays)}
    payload["__doc__"] = np.frombuffer(
        json.dumps(doc).encode("utf-8"), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez_compressed(f, **payload)


def load(path, device=None) -> Any:
    """Load an object saved by :func:`save` (``device`` as in
    :func:`from_dict`)."""
    with np.load(path, allow_pickle=False) as z:
        doc = json.loads(bytes(z["__doc__"].tobytes()).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != "__doc__"}
    return from_dict(_inject_arrays(doc, arrays), device=device)
