"""The port's streaming path against the JAX package's, on the CPU.

- ``StreamingFramer`` (native ring buffer and numpy fallback) pops the same
  frames as JAX's, chunk by chunk, with the same flush and backpressure;
- ``StreamingSpectrogram`` (centred and raw) gives JAX's output, and
  ``plan.compute``'s at ``tests/test_streaming.py:121``'s rtol/atol 1e-4;
- ``compute_frame`` equals JAX's ``compute_frame`` and the column of
  ``compute`` (f64: 1e-10, ``tests/test_streaming.py:27-49``), on a growing
  buffer too, and raises out of range.
"""

import numpy as np
import pytest

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.runtime import streaming as jstream
from spectrograms_tpu_torch.runtime import streaming as tstream
from tests.conftest import sine

SR = 16000.0


def mel_db(m, centre=True, n_fft=512, hop=128, n_mels=40, **kw):
    if m is tg:
        kw.setdefault("device", "cpu")
    return m.SpectrogramPlan(m.SpectrogramParams(m.StftParams(n_fft, hop, centre=centre), SR),
                             m.FreqScale.MEL, m.AmpScale.DECIBELS,
                             scale_params=m.MelParams(n_mels, 0.0, 8000.0, m.MelNorm.SLANEY),
                             log_params=m.LogParams(-80.0), dtype="float32", **kw)


def _drain(framer, x, chunk):
    out = []
    for start in range(0, len(x), chunk):
        rest = x[start:start + chunk]
        while rest.shape[0]:
            n = framer.push(rest)
            rest = rest[n:]
            out.append(framer.pop())
    out.append(framer.pop())
    out.append(framer.flush())
    return np.concatenate(out)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("chunk", [1, 100, 777, 5000])
def test_framer_matches_jax(native, chunk):
    x = np.random.default_rng(chunk).standard_normal(6000).astype(np.float32)
    t, j = tstream.StreamingFramer(512, 128), jstream.StreamingFramer(512, 128)
    assert t.native and j.native
    if not native:
        for f in (t, j):
            f._lib = None
            f._buf = np.zeros(0, dtype=np.float32)
    got, want = _drain(t, x, chunk), _drain(j, x, chunk)
    np.testing.assert_array_equal(got, want)
    # the frames are the direct hop-advanced slices of the stream
    direct = np.stack([x[i * 128:i * 128 + 512] for i in range((6000 - 512) // 128 + 1)])
    np.testing.assert_array_equal(got[:len(direct)], direct)


@pytest.mark.parametrize("native", [True, False])
def test_framer_backpressure_and_validation_match_jax(native):
    t = tstream.StreamingFramer(256, 64, capacity=600)
    j = jstream.StreamingFramer(256, 64, capacity=600)
    if not native:
        for f in (t, j):
            f._lib = None
            f._buf = np.zeros(0, dtype=np.float32)
    x = np.arange(2000, dtype=np.float32)
    assert t.push(x) == j.push(x) < 2000
    assert t.available() == j.available()
    np.testing.assert_array_equal(t.pop(2), j.pop(2))
    np.testing.assert_array_equal(t.flush(), j.flush())
    assert t.flush().shape == (0, 256)
    for bad in ((0, 1), (128, 0), (128, 256)):
        with pytest.raises(tg.InvalidInputError):
            tstream.StreamingFramer(*bad)


@pytest.mark.parametrize("centre", [True, False])
def test_streaming_spectrogram_matches_jax_and_compute(centre):
    x = np.random.default_rng(5).standard_normal(10000).astype(np.float32)
    tp, jp = mel_db(tg, centre=centre), mel_db(sg, centre=centre)
    outs = {}
    for name, plan, mod in (("port", tp, tstream), ("jax", jp, jstream)):
        strm = mod.StreamingSpectrogram(plan, block_frames=16)
        assert strm.centred == centre
        parts = [strm.process(x[s:s + 777]) for s in range(0, len(x), 777)] + [strm.finish()]
        outs[name] = np.concatenate(parts, axis=1)
    assert outs["port"].dtype == np.float32
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0, atol=1e-3)
    if centre:  # centred stream == offline compute, frame for frame
        offline = tp.compute_raw(x).numpy()
        assert outs["port"].shape == offline.shape
        np.testing.assert_allclose(outs["port"], offline, rtol=1e-4, atol=1e-4)
    else:  # raw: frames of the stream, then one zero-padded tail frame
        assert outs["port"].shape == (40, (10000 - 512) // 128 + 2)


def test_uncentred_opt_out_and_empty_outputs():
    strm = tstream.StreamingSpectrogram(mel_db(tg), block_frames=16, centred=False)
    assert not strm.centred
    assert strm.process(np.zeros(100, np.float32)).shape == (40, 0)
    out = strm.process(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    assert out.shape == (40, (4100 - 512) // 128 + 1)
    fresh = tstream.StreamingSpectrogram(mel_db(tg), centred=False)
    assert fresh.finish().shape == (40, 0)


@pytest.mark.parametrize("scale", ["linear", "mel"])
@pytest.mark.parametrize("centre", [True, False])
def test_compute_frame_matches_jax_and_compute(scale, centre):
    def plan(m):
        kw = dict(device="cpu") if m is tg else {}
        fs = m.FreqScale.LINEAR if scale == "linear" else m.FreqScale.MEL
        sp = None if scale == "linear" else m.MelParams(32, 0.0, 8000.0)
        return m.SpectrogramPlan(m.SpectrogramParams(m.StftParams(256, 128, centre=centre), SR),
                                 fs, m.AmpScale.POWER, scale_params=sp, dtype="float64", **kw)

    x = sine(440.0, duration=0.2)
    tp, jp = plan(tg), plan(sg)
    full = tp.compute(x).data.numpy()
    for idx in (0, 1, full.shape[1] // 2, full.shape[1] - 1):
        got = tp.compute_frame(x, idx).numpy()
        assert got.shape == (full.shape[0],)
        np.testing.assert_allclose(got, full[:, idx], rtol=0, atol=1e-10)
        np.testing.assert_allclose(got, np.asarray(jp.compute_frame(x, idx)), rtol=0, atol=1e-10)
    nf = tp.output_shape(len(x))[1]
    for bad in (nf, -1):
        with pytest.raises(tg.InvalidInputError):
            tp.compute_frame(x, bad)


@pytest.mark.parametrize("method", ["matmul", "fft", "pallas"])
def test_compute_frame_growing_buffer(method):
    plan = mel_db(tg, n_fft=1024, hop=256, n_mels=64, method=method)
    x = np.random.default_rng(6).standard_normal(16000).astype(np.float32)
    full = plan.compute(x).data.numpy()
    jplan = mel_db(sg, n_fft=1024, hop=256, n_mels=64, method="matmul")
    for i in (0, 3, 7, 20):
        needed = i * 256 + 1024  # centre padding covers the look-back
        frame = plan.compute_frame(x[:needed], i).numpy()
        np.testing.assert_allclose(frame, full[:, i], rtol=0, atol=1e-3)
        np.testing.assert_allclose(frame, np.asarray(jplan.compute_frame(x[:needed], i)),
                                   rtol=0, atol=1e-3)
