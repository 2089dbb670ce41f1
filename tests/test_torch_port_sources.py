"""The port's feature sources (``source.py``) against the JAX package's.

Each of the six sources over the same seeded signal in both packages, on
the CPU: ``compute_matrix`` at float64 within the bars of the port tests
that hold the function underneath (the plan, ``cqt``, ``chromagram`` and
``mfcc`` at rtol 1e-9 / atol 1e-12·max; the gammatone bank at rtol 1e-9,
``tests/test_torch_port_erb.py``), and at float32 1e-3 dB for the plan
source on the fused route (its plain version here); ``n_bands``,
``center_frequencies``, ``sample_rate`` and ``hop_seconds`` equal; each an
instance of the runtime-checkable ``SpectrogramSource`` protocol.
"""

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from tests.conftest import noise

SR = 16000.0
CPU = dict(device="cpu")
F64 = dict(rtol=1e-9)


def sources(m):
    """label → (source, float64 tolerance) of one package."""
    kw = CPU if m is tg else {}
    stft = m.StftParams(512, 128)
    mel = m.MelParams(40, 0.0, 8000.0, m.MelNorm.SLANEY)
    plan = m.MelDbPlan(m.SpectrogramParams(stft, SR), mel, m.LogParams(-80.0), dtype="float64",
                       **kw)
    return {
        "plan": m.PlanSource(plan),
        "gammatone": m.GammatoneSource(SR, 512, 256, m.ErbParams(16, 50.0, 7000.0),
                                       dtype="float64", **kw),
        "cqt": m.CqtSource(SR, m.CqtParams(12, 5, 55.0), 256, dtype="float64", **kw),
        "chroma": m.ChromaSource(stft, SR, dtype="float64", **kw),
        "mfcc": m.MfccSource(stft, SR, 40, m.MfccParams(13, include_c0=False), dtype="float64",
                             **kw),
        "mfcc_c0": m.MfccSource(stft, SR, 40, dtype="float64", **kw),
    }


LABELS = ["plan", "gammatone", "cqt", "chroma", "mfcc", "mfcc_c0"]


@pytest.fixture(scope="module")
def both():
    return sources(tg), sources(sg)


@pytest.mark.parametrize("label", LABELS)
def test_source_matches_jax(both, label):
    src, jsrc = both[0][label], both[1][label]
    x = noise(8000, seed=7)
    got = src.compute_matrix(x)
    want = np.asarray(jsrc.compute_matrix(x))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape and got.shape[0] == src.n_bands == jsrc.n_bands
    atol = 1e-12 * float(np.abs(want).max())
    if label == "gammatone":
        atol = 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=atol)
    np.testing.assert_allclose(src.center_frequencies(), jsrc.center_frequencies(),
                               rtol=1e-12, atol=0)
    assert src.sample_rate == jsrc.sample_rate
    assert src.hop_seconds == jsrc.hop_seconds
    assert isinstance(src, tg.SpectrogramSource)
    assert isinstance(jsrc, sg.SpectrogramSource)


def test_plan_source_float32_kernel_route():
    """A float32 ``method="pallas"`` plan behind ``PlanSource``: its
    forward (the kernel's plain version on the CPU) against JAX's plan."""
    stft = tg.StftParams(1024, 256)
    plan = tg.MelDbPlan(tg.SpectrogramParams(stft, SR),
                        tg.MelParams(64, 0.0, 8000.0, tg.MelNorm.SLANEY), tg.LogParams(-80.0),
                        dtype="float32", method="pallas", **CPU)
    jplan = sg.MelDbPlan(sg.SpectrogramParams(sg.StftParams(1024, 256), SR),
                         sg.MelParams(64, 0.0, 8000.0, sg.MelNorm.SLANEY), sg.LogParams(-80.0),
                         dtype="float32", method="matmul")
    x = noise(16000, seed=8).astype(np.float32)
    got = tg.PlanSource(plan).compute_matrix(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(sg.PlanSource(jplan).compute_matrix(x)),
                               rtol=0, atol=1e-3)
    assert torch.equal(got, plan.compute_raw(x))


def test_objects_without_the_protocol_are_not_sources():
    assert not isinstance(object(), tg.SpectrogramSource)
    assert not isinstance(tg.StftParams(512, 128), tg.SpectrogramSource)
