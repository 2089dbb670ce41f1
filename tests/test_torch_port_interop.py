"""The port's interop modules (``spectrograms_tpu_torch.torch`` and
``.jax``) against the JAX package's (``tests/test_torch_interop.py``), case
by case, on the same signal.

The port's results already hold tensors: ``to_torch`` hands back the same
storage, and ``to_jax`` a detached tensor that ``jax.numpy.from_dlpack``
reads (done here: the port imports no JAX). The signal is JAX's test's 440 Hz
sine, whose far bins sit 70 dB below its peak, where f32 rounding moves a
dB value by ~1e-2 in either package: dB values are held to the JAX results
in the power they come from, at ``tests/test_torch_port_plans.py``'s f32
power tolerance (1e-4 of the peak), and to 1e-3 dB (that file's dB bar)
within 40 dB of the peak; axes to 1e-12.
"""

import jax
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu.jax as sgj
import spectrograms_tpu.torch as sgt
import spectrograms_tpu_torch as tg
import spectrograms_tpu_torch.jax as tgj
import spectrograms_tpu_torch.torch as tgt
from tests.conftest import sine

CPU = dict(device="cpu")
DB_ATOL = 1e-3


def assert_db_matches(out, ref):
    out, ref = np.asarray(out, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    p_out, p_ref = 10.0 ** (out / 10.0), 10.0 ** (ref / 10.0)
    np.testing.assert_allclose(p_out, p_ref, rtol=0, atol=1e-4 * p_ref.max())
    near = ref > ref.max() - 40.0
    np.testing.assert_allclose(out[near], ref[near], rtol=0, atol=DB_ATOL)


def _params(pkg):
    return pkg.SpectrogramParams(pkg.StftParams(512, 128), 16000.0)


def _mel(pkg):
    return pkg.MelParams(64, 0.0, 8000.0, pkg.MelNorm.SLANEY)


def _spec(pkg, duration=1.0):
    kw = CPU if pkg is tg else {}
    plan = pkg.MelDbPlan(_params(pkg), _mel(pkg), pkg.LogParams(-80.0), dtype="float32", **kw)
    return plan.compute(sine(440.0, duration=duration, dtype=np.float32))


def test_to_torch_values_match():
    spec, ref = _spec(tg), _spec(sg)
    t = spec.to_torch()
    assert isinstance(t, torch.Tensor)
    assert t.data_ptr() == spec.data.data_ptr() and torch.equal(t, spec.data)  # zero copy
    assert_db_matches(t.numpy(), ref.to_torch().numpy())
    assert tgt.to_torch(spec.data) is spec.data
    a = np.arange(6.0)
    assert np.shares_memory(tgt.to_torch(a).numpy(), a)


def test_to_torch_dtype_conversion():
    spec = _spec(tg)
    t = spec.to_torch(dtype="float64")
    assert t.dtype == torch.float64 == _spec(sg).to_torch(dtype="float64").dtype
    assert torch.equal(t, spec.data.double())
    assert spec.to_torch(dtype=torch.float64, device="cpu").dtype == torch.float64
    assert spec.to_torch(device="cpu").data_ptr() == spec.data.data_ptr()


def test_to_torch_with_metadata():
    spec, ref = _spec(tg), _spec(sg)
    wrapped, theirs = spec.to_torch(with_metadata=True), ref.to_torch(with_metadata=True)
    assert isinstance(wrapped, tgt.TorchSpectrogram)
    assert wrapped.shape == spec.shape == theirs.shape
    np.testing.assert_allclose(wrapped.frequencies, theirs.frequencies, rtol=1e-12)
    np.testing.assert_allclose(wrapped.times, theirs.times, rtol=1e-12)
    assert wrapped.params == spec.params
    assert wrapped.db_range == spec.db_range()
    np.testing.assert_allclose(wrapped.db_range, theirs.db_range, rtol=0, atol=DB_ATOL)
    assert wrapped.tensor.data_ptr() == spec.data.data_ptr()
    moved = wrapped.to(torch.float64)
    assert moved.tensor.dtype == torch.float64 and moved.db_range == wrapped.db_range
    assert wrapped.cpu().tensor.data_ptr() == spec.data.data_ptr()
    np.testing.assert_array_equal(wrapped.cpu().frequencies, wrapped.frequencies)


def test_batch_stacks():
    specs = [_spec(tg) for _ in range(3)]
    t = tgt.batch(specs, device="cpu")
    assert isinstance(t, torch.Tensor)
    assert t.shape == (3,) + specs[0].shape
    ref = sgt.batch([_spec(sg) for _ in range(3)])
    assert_db_matches(t.numpy(), ref.numpy())
    stacked, meta = tgt.batch_with_metadata(specs, device="cpu")
    assert torch.equal(stacked, t) and len(meta) == 3 and meta[0]["db_range"] == specs[0].db_range()


def test_batch_pad_ragged():
    s1, s2 = _spec(tg, 0.5), _spec(tg, 1.0)
    with pytest.raises(tg.InvalidInputError, match="pad=True"):
        tgt.batch([s1, s2], device="cpu")
    t = tgt.batch([s1, s2], device="cpu", pad=True)
    assert t.shape[2] == max(s1.n_frames, s2.n_frames)
    ref = sgt.batch([_spec(sg, 0.5), _spec(sg, 1.0)], pad=True)
    assert tuple(t.shape) == tuple(ref.shape)
    assert_db_matches(t.numpy(), ref.numpy())


def test_stft_result_and_mfcc_to_torch():
    x = sine(440.0, dtype=np.float32)
    res = tg.StftPlan(_params(tg), dtype="float32", **CPU).compute(x)
    t = res.to_torch()
    assert t.is_complex() and t.data_ptr() == res.data.data_ptr()
    assert tuple(t.shape) == tuple(sg.StftPlan(_params(sg), dtype="float32").compute(x).shape)
    m = tg.compute_mfcc(x, _params(tg).stft, 16000.0, mfcc_params=tg.MfccParams(13),
                        dtype="float32", **CPU)
    tm = m.to_torch()
    assert tm.shape == tuple(m.data.shape)
    ref = sg.compute_mfcc(x, _params(sg).stft, 16000.0, mfcc_params=sg.MfccParams(13),
                          dtype="float32")
    assert tm.shape == tuple(ref.to_torch().shape)


def test_every_result_class_is_patched():
    classes = (tg.Spectrogram, tg.StftResult, tg.Mfcc, tg.Chromagram, tg.CqtResult,
               tg.ItdSpectrogram, tg.IpdSpectrogram, tg.IldSpectrogram, tg.IlrSpectrogram)
    for cls in classes:
        assert callable(cls.to_torch) and callable(cls.to_jax), cls


def test_jax_convenience_module():
    spec, ref = _spec(tg), _spec(sg)
    arr = spec.to_jax()
    assert isinstance(arr, torch.Tensor) and not arr.requires_grad and arr.is_contiguous()
    got = jax.numpy.from_dlpack(tgj.to_jax(spec))
    assert_db_matches(np.asarray(got), np.asarray(sgj.to_jax(ref)))
    np.testing.assert_array_equal(np.asarray(got), spec.data.numpy())
    wrapped = spec.to_jax(with_metadata=True)
    assert isinstance(wrapped, tgj.JaxSpectrogram)
    assert wrapped.shape == spec.shape == ref.to_jax(with_metadata=True).shape
    assert wrapped.dtype == torch.float32
    assert wrapped.db_range == spec.db_range()
    np.testing.assert_allclose(wrapped.frequencies, ref.frequencies, rtol=1e-12)
    stacked = tgj.batch([spec, spec], device="cpu")
    assert stacked.shape == (2,) + spec.shape


def test_to_jax_refuses_what_only_jax_can_do():
    spec = _spec(tg)
    with pytest.raises(tg.InvalidInputError, match="from_dlpack"):
        tgj.to_jax(spec, device="cpu")
    with pytest.raises(tg.InvalidInputError, match="from_dlpack"):
        spec.to_jax(dtype="float64")


def test_to_jax_of_a_graph_tensor_is_detached():
    x = torch.ones(4, requires_grad=True) * 2.0
    out = tgj.to_jax(x)
    assert not out.requires_grad and out.data_ptr() == x.data_ptr()
    np.testing.assert_array_equal(np.asarray(jax.numpy.from_dlpack(out)), np.full(4, 2.0))
