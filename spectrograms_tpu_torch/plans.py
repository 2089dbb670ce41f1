"""Typed spectrogram plan classes.

Counterpart of ``spectrograms_tpu.plans``: the reference's 15-class matrix
``{Linear,Mel,Erb,LogHz,Cqt} × {Power,Magnitude,Db}Plan``
(python/planner.rs:671-882), each a thin subclass of
:class:`~spectrograms_tpu_torch.pipeline.SpectrogramPlan` with its scales
fixed, built directly (``MelDbPlan(params, mel, db)``) or by the planner's
named builders. They take the plan's ``dtype``, ``method``, ``precision``
and ``device`` (CUDA unless ``device="cpu"``); ``auto`` picks the fused
kernels for mel, log-Hz and ERB on CUDA as ``SpectrogramPlan`` does; the
three ``Cqt*Plan`` classes run the CQT of ``ops/cqt.py``.
"""

from __future__ import annotations

from typing import Optional

from .errors import InvalidInputError
from .params import CqtParams, ErbParams, LogHzParams, LogParams, MelParams, SpectrogramParams
from .pipeline import AmpScale, FreqScale, SpectrogramPlan

__all__ = [
    "LinearPowerPlan",
    "LinearMagnitudePlan",
    "LinearDbPlan",
    "MelPowerPlan",
    "MelMagnitudePlan",
    "MelDbPlan",
    "ErbPowerPlan",
    "ErbMagnitudePlan",
    "ErbDbPlan",
    "LogHzPowerPlan",
    "LogHzMagnitudePlan",
    "LogHzDbPlan",
    "CqtPowerPlan",
    "CqtMagnitudePlan",
    "CqtDbPlan",
]

_AMP = {
    "Power": AmpScale.POWER,
    "Magnitude": AmpScale.MAGNITUDE,
    "Db": AmpScale.DECIBELS,
}
_SCALE = {
    "Linear": (FreqScale.LINEAR, None),
    "Mel": (FreqScale.MEL, MelParams),
    "Erb": (FreqScale.ERB, ErbParams),
    "LogHz": (FreqScale.LOG_HZ, LogHzParams),
    "Cqt": (FreqScale.CQT, CqtParams),
}


def _make_plan_class(scale_name: str, amp_name: str):
    scale, params_cls = _SCALE[scale_name]
    amp = _AMP[amp_name]
    takes_db = amp == AmpScale.DECIBELS

    def _init(self, params, scale_params, db, dtype, method, precision, device):
        if db is not None and not takes_db:
            raise InvalidInputError(
                f"{scale_name}{amp_name}Plan does not take dB params "
                "(only *DbPlan classes do)"
            )
        SpectrogramPlan.__init__(
            self, params, scale, amp, scale_params=scale_params,
            log_params=db if takes_db else None, dtype=dtype, method=method,
            precision=precision, device=device,
        )

    if params_cls is None:

        def __init__(self, params: SpectrogramParams, db: Optional[LogParams] = None,
                     dtype=None, method: str = "auto", precision=None, device=None):
            _init(self, params, None, db, dtype, method, precision, device)

    else:

        def __init__(self, params: SpectrogramParams, scale_params, db: Optional[LogParams] = None,
                     dtype=None, method: str = "auto", precision=None, device=None):
            _init(self, params, scale_params, db, dtype, method, precision, device)

    name = f"{scale_name}{amp_name}Plan"
    amp_word = {"Power": "power", "Magnitude": "magnitude", "Db": "decibel"}[amp_name]
    return type(
        name,
        (SpectrogramPlan,),
        {
            "__init__": __init__,
            "__doc__": (
                f"Reusable {scale_name} {amp_word} spectrogram plan "
                f"(typed analog of the reference's ``{name}`` pyclass)."
            ),
            "__module__": __name__,
        },
    )


for _s in _SCALE:
    for _a in _AMP:
        _cls = _make_plan_class(_s, _a)
        globals()[_cls.__name__] = _cls
del _s, _a, _cls
