"""Multi-feature steps: several plans over one batch, one shared front end.

Counterpart of ``spectrograms_tpu.featureset``. Production feature
extraction rarely wants one feature: a music pipeline computes chroma and
MFCC over the same clips, and each multirate plan decimates the same signal.
``FeatureSet`` runs N plans over one batch and shares one
:class:`~spectrograms_tpu_torch.ops.decimate.DecimationCascade` between every
member whose decimation front end matches (same composite mode and
precision key). Sharing is exact for single-stage members (mel / log-Hz /
chroma at depth ≤ 2 get bit-identical inputs: the cascade's pad is zeros and
the banded decimator already zero-extends); deeper chained levels differ
from a standalone cascade only near the signal's ends.

The JAX package traces the step into one program; here each member launches
its own kernels in turn, on the members' device.

>>> import numpy as np, spectrograms_tpu_torch as tg
>>> ch = tg.ChromaPlan(tg.StftParams(4096, 1024), 44100.0,
...                    tg.ChromaParams.music_standard().with_multirate(), device="cpu")
>>> (chroma,) = tg.FeatureSet([ch]).compute_batch(np.zeros((2, 44100), np.float32))
>>> tuple(chroma.shape)
(2, 12, 44)
"""

from __future__ import annotations

from typing import Sequence

import torch

from .errors import InvalidInputError
from .ops.decimate import DecimationCascade
from .spans import span

__all__ = ["FeatureSet"]


def _is_plan(m) -> bool:
    """A port plan: it has the FeatureSet hooks (``_fs_cascade_spec``,
    ``_fs_forward_batch``)."""
    return hasattr(m, "_fs_forward_batch")


class FeatureSet:
    """Compute several feature plans over the same batch.

    ``members`` are port plans (``SpectrogramPlan``, ``MfccPlan``,
    ``ChromaPlan``) and/or callables ``f(batch) -> tensor`` for custom
    stages. Plan members share one dtype and one device; callables get the
    batch on that device.

    ``compute_batch(batch)`` returns a tuple of results in member order;
    ``compute(samples)`` maps one 1-D signal through a singleton batch.
    Each result is what the member's own ``compute_batch`` returns (see the
    module docstring for deep shared levels).
    """

    _span = "tg.plan.FeatureSet"

    def __init__(self, members: Sequence):
        if not members:
            raise InvalidInputError("FeatureSet needs at least one member")
        self._members = list(members)
        self._member_spans = ["tg.member." + (type(m).__name__ if _is_plan(m)
                                              else getattr(m, "__name__", type(m).__name__))
                              for m in self._members]
        self._specs = []
        dtypes, devices = set(), set()
        for m in self._members:
            if not _is_plan(m):
                if not callable(m):
                    raise InvalidInputError(
                        f"FeatureSet member {m!r} is neither a plan with a "
                        "batched forward nor a callable"
                    )
                self._specs.append(None)
                continue
            self._specs.append(m._fs_cascade_spec())
            dtypes.add(m._dtype)
            devices.add(m.device)
        if len(dtypes) > 1:
            raise InvalidInputError(
                f"FeatureSet members must share one dtype, got "
                f"{sorted(str(d).removeprefix('torch.') for d in dtypes)}"
            )
        if len(devices) > 1:
            raise InvalidInputError(
                f"FeatureSet members must share one device, got {sorted(map(str, devices))}"
            )
        self._dtype = dtypes.pop() if dtypes else torch.float32
        # A set of callables alone computes where its input lies.
        self.device = devices.pop() if devices else None

        # Cascade flavours: members with equal (composite, precision) share
        # one cascade padded to the largest member pad, rounded up to the
        # deepest level's 2^d so that every member's slice stays on its grid.
        flavors: dict = {}
        for spec in self._specs:
            if spec is None:
                continue
            composite, precision, pad, depths = spec
            cur_pad, cur_dmax = flavors.get((composite, precision), (0, 0))
            flavors[(composite, precision)] = (max(cur_pad, pad), max(cur_dmax, max(depths)))
        self._flavors = {
            key: -(-pad // (1 << dmax)) * (1 << dmax) for key, (pad, dmax) in flavors.items()
        }

    @property
    def n_members(self) -> int:
        return len(self._members)

    def _step_impl(self, xb: torch.Tensor) -> tuple:
        """Every member over a (B, n) tensor on the set's device."""
        cascades = {
            key: DecimationCascade(xb, pad=pad, precision=key[1], composite=key[0])
            for key, pad in self._flavors.items()
        }
        outs = []
        for m, spec, name in zip(self._members, self._specs, self._member_spans):
            with span(name):
                if not _is_plan(m):
                    outs.append(m(xb))
                else:
                    outs.append(m._fs_forward_batch(xb, None if spec is None
                                                    else cascades[(spec[0], spec[1])]))
        return tuple(outs)

    def compute_batch(self, batch) -> tuple:
        """Run every member over (batch, samples) → tuple of results."""
        with span(self._span):
            xb = torch.as_tensor(batch, dtype=self._dtype, device=self.device)
            if xb.ndim != 2:
                raise InvalidInputError(
                    f"expected a (batch, samples) array, got shape {tuple(xb.shape)}"
                )
            return self._step_impl(xb)

    def compute(self, samples) -> tuple:
        """Run every member over one 1-D signal → tuple of results."""
        with span(self._span):
            x = torch.as_tensor(samples, dtype=self._dtype, device=self.device)
            if x.ndim != 1 or x.shape[0] == 0:
                raise InvalidInputError("expected a non-empty 1-D signal")
            return tuple(r[0] for r in self._step_impl(x[None, :]))
