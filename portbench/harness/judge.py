"""The check that decides ``correct``: each number the reference module
compares, taken as the worst over the sampled answers, against the limit
that the configuration's file gives it."""

from __future__ import annotations

import math

import torch


def rel_err(prog: torch.Tensor, ref: torch.Tensor, axis: int) -> float:
    """max over the slices along ``axis`` of max|prog − ref| / max|ref|: each
    slice (a coefficient, a band, a pitch class) on its own scale."""
    p = prog.to(torch.float64)
    r = ref.to(torch.float64)
    dims = [d for d in range(r.ndim) if d != axis % r.ndim]
    num = (p - r).abs().amax(dim=dims)
    den = r.abs().amax(dim=dims).clamp_min(torch.finfo(torch.float64).tiny)
    return float((num / den).max())


def worst(readings: list) -> dict:
    """{name: worst reading} over a list of {name: reading}; NaN is worst."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            v = float(v)
            if k not in out or math.isnan(v) or (not math.isnan(out[k]) and v > out[k]):
                out[k] = v
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}, names that failed). A number
    without a limit fails, and so does a NaN (printed as null); no number at
    all is no check and fails too."""
    checks, failed = {}, []
    for name in sorted(numbers):
        v = float(numbers[name])
        lim = limits.get(name)
        checks[name] = {"value": v if math.isfinite(v) else None, "limit": lim}
        if lim is None or not (v <= lim):
            failed.append(name)
    return bool(numbers) and not failed, checks, failed
