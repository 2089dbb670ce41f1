"""``tests/test_dtype_matrix.py`` held on the port, on the CPU: the parts
that ``tests/test_torch_port_plans.py`` does not already hold.

``test_torch_port_plans.py`` holds the matrix's one-shots × {f32, f64}
(``test_one_shot_dtype``), f32 ≈ f64 (``test_f32_close_to_f64``), the
aliases, the invalid dtypes and the plans' dtypes. This file holds the
STFT's complex dtype, the MFCC and chroma dtypes, the MFCC's f32 ≈ f64, and
``tests/test_params.py``'s bfloat16 guidance. A dtype is a torch dtype here
(``spec.data.dtype == torch.float32`` where JAX compares ``str(dtype)``).
"""

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from tests.conftest import noise, sine

SR = 16000.0
CPU = dict(device="cpu")
X = sine(440.0)


def stft_params(m):
    return m.SpectrogramParams(m.StftParams(512, 128), SR)


@pytest.mark.parametrize("dtype,cplx", [("float32", torch.complex64),
                                        ("float64", torch.complex128)])
def test_stft_complex_dtype(dtype, cplx):
    """``test_dtype_matrix.py::test_stft_complex_dtype``: ``compute_stft``
    gives complex64 at f32 and complex128 at f64, JAX's values."""
    res = tg.compute_stft(X, stft_params(tg), dtype=dtype, **CPU)
    assert res.data.dtype == cplx
    ref = np.asarray(sg.compute_stft(X, stft_params(sg), dtype=dtype).data)
    rtol = 1e-9 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(res.data.numpy(), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mfcc_chroma_dtype(dtype):
    """``test_dtype_matrix.py::test_mfcc_chroma_dtype``: ``compute_mfcc`` and
    ``compute_chromagram`` keep the plan's dtype."""
    m = tg.compute_mfcc(X, stft_params(tg).stft, SR, mfcc_params=tg.MfccParams(13),
                        dtype=dtype, **CPU)
    assert m.data.dtype == getattr(torch, dtype)
    c = tg.compute_chromagram(X, stft_params(tg).stft, SR, dtype=dtype, **CPU)
    assert c.data.dtype == getattr(torch, dtype)


def test_mfcc_f32_close_to_f64():
    """``test_dtype_matrix.py::test_mfcc_f32_close_to_f64``: the f32 MFCC of
    noise within 2e-1 of the f64 one (the JAX test's atol), and the f64 MFCC
    equal to JAX's."""
    x = noise(8000, seed=7)

    def mfcc(m, dtype):
        kw = CPU if m is tg else {}
        return np.asarray(m.compute_mfcc(x, stft_params(m).stft, SR,
                                         mfcc_params=m.MfccParams(13), dtype=dtype, **kw).data)

    a = mfcc(tg, "float32").astype(np.float64)
    b = mfcc(tg, "float64")
    np.testing.assert_allclose(a, b, atol=2e-1)
    np.testing.assert_allclose(b, mfcc(sg, "float64"), rtol=1e-9, atol=1e-9)


def test_bfloat16_plan_dtype_rejected_with_guidance():
    """``tests/test_params.py::test_bfloat16_plan_dtype_rejected_with_guidance``:
    a bfloat16 plan raises, naming the ``precision`` knob that selects the
    bf16 tiers of a float32 plan, as JAX's message does."""
    with pytest.raises(tg.InvalidInputError, match="precision"):
        tg.MelDbPlan(
            tg.SpectrogramParams(tg.StftParams(512, 128), 16000.0),
            tg.MelParams(40, 0.0, 8000.0),
            tg.LogParams(-80.0),
            dtype="bfloat16",
            **CPU,
        )
    with pytest.raises(sg.InvalidInputError, match="precision"):
        sg.MelDbPlan(sg.SpectrogramParams(sg.StftParams(512, 128), 16000.0),
                     sg.MelParams(40, 0.0, 8000.0), sg.LogParams(-80.0), dtype="bfloat16")
