"""The port's ``serde`` against the JAX package's: files load in either.

Counterparts of every test in ``tests/test_serde.py``, with its inputs,
and the exchange both ways: for every registered params type, JAX's
``to_json`` read by the port's ``from_json`` gives the port's equal object
and the reverse; likewise one result of each registered result type,
through JSON and through NPZ, compared field by field (arrays exact, NaN
included; the port's ``data`` a tensor on the requested device, the axes
host numpy). Also the doctests of the port's ``serde`` and ``binaural``.
"""

import doctest
import importlib

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu import serde as jserde
from spectrograms_tpu_torch import serde
from tests.conftest import sine

CPU = dict(device="cpu")


def all_params(m):
    """``tests/test_serde.py``'s ALL_PARAMS in one package."""
    return [
        m.StftParams(512, 128),
        m.StftParams(1024, 256, window=m.WindowType.kaiser(8.0), centre=False),
        m.StftParams(64, 16, window=m.WindowType.custom(np.hamming(64))),
        m.SpectrogramParams(m.StftParams(512, 160), 16000.0),
        m.LogParams(-100.0),
        m.MelParams(80, 20.0, 7600.0, m.MelNorm.SLANEY),
        m.MelParams(40, 0.0, 8000.0, m.MelNorm.NONE),
        m.LogHzParams(64, 32.7, 8000.0),
        m.ErbParams(32, 50.0, 8000.0),
        m.CqtParams(12, 5, 55.0),
        m.ChromaParams.music_standard(),
        m.MfccParams(13),
        m.MdctParams(256, 128),
        m.WindowType.gaussian(0.4),
    ]


def every_params_type(m):
    """One instance of every registered params and enum type."""
    sp = m.SpectrogramParams(m.StftParams(512, 128), 16000.0)
    return all_params(m) + [
        m.GammatoneParams(32, 50.0, 8000.0),  # ErbParams under its gammatone name
        m.ErbSpacing.APPLE_TR35,
        m.ChromaNorm.L2,
        m.MelNorm.L1,
        m.FreqScale.CQT,
        m.AmpScale.DECIBELS,
        m.MelParams(80, 0.0, 4000.0, m.MelNorm.SLANEY, multirate=True),
        m.CqtParams(12, 7, 32.703).with_multirate(),
        m.ITDSpectrogramParams(sp, 60.0, 600.0, 2),
        m.IPDSpectrogramParams(sp, wrapped=True),
        m.ILDSpectrogramParams(sp),
        m.ILRSpectrogramParams(sp, 1500.0, 5000.0),
    ]


PARAM_IDS = [type(p).__name__ + str(i) for i, p in enumerate(every_params_type(tg))]


def test_every_registered_type_is_covered():
    names = {type(p).__name__ for p in every_params_type(tg)} | set(RESULT_TYPES)
    assert names == set(serde._registry()) == set(jserde._registry())


@pytest.mark.parametrize("i", range(len(all_params(tg))),
                         ids=PARAM_IDS[:len(all_params(tg))])
def test_params_json_roundtrip(i):
    obj = all_params(tg)[i]
    assert serde.from_json(serde.to_json(obj)) == obj


@pytest.mark.parametrize("i", range(len(PARAM_IDS)), ids=PARAM_IDS)
def test_params_cross_package(i):
    t_obj, j_obj = every_params_type(tg)[i], every_params_type(sg)[i]
    assert serde.to_json(t_obj) == jserde.to_json(j_obj)
    assert serde.from_json(jserde.to_json(j_obj)) == t_obj
    assert jserde.from_json(serde.to_json(t_obj)) == j_obj


# ---- results ----------------------------------------------------------------------

def results(m):
    """One result of each registered result type, computed in ``m``."""
    kw = CPU if m is tg else {}
    params = m.SpectrogramParams(m.StftParams(512, 128), 16000.0)
    x = sine(440.0, dtype=np.float32)
    left = sine(440.0, dtype=np.float64)
    stereo = np.stack([left, np.roll(left, 8)])
    return {
        "Spectrogram": m.MelDbPlan(params, m.MelParams(64, 0.0, 8000.0, m.MelNorm.SLANEY),
                                   m.LogParams(-80.0), dtype="float32", **kw).compute(x),
        "StftResult": m.StftPlan(m.SpectrogramParams(m.StftParams(256, 64), 8000.0),
                                 dtype="float64", **kw).compute(sine(440.0, sr=8000)),
        "Mfcc": m.MfccPlan(m.StftParams(512, 128), 16000.0, dtype="float32", **kw).compute(x),
        "Chromagram": m.ChromaPlan(m.StftParams(512, 128), 16000.0, dtype="float32",
                                   **kw).compute(x),
        "CqtResult": m.cqt(x[:4000], 16000.0, m.CqtParams(12, 3, 110.0), 256,
                           dtype="float32", **kw),
        "ItdSpectrogram": m.compute_itd_spectrogram(stereo, m.ITDSpectrogramParams(params),
                                                    **kw),
        "IpdSpectrogram": m.compute_ipd_spectrogram(stereo, m.IPDSpectrogramParams(params),
                                                    **kw),
        "IldSpectrogram": m.compute_ild_spectrogram(stereo, m.ILDSpectrogramParams(params),
                                                    **kw),
        "IlrSpectrogram": m.compute_ilr_spectrogram(stereo, m.ILRSpectrogramParams(params),
                                                    **kw),
    }


RESULT_TYPES = ["Spectrogram", "StftResult", "Mfcc", "Chromagram", "CqtResult",
                "ItdSpectrogram", "IpdSpectrogram", "IldSpectrogram", "IlrSpectrogram"]


@pytest.fixture(scope="module")
def both():
    return results(tg), results(sg)


def flatten(obj, sd):
    """(structure, arrays) of a result through a package's ``to_dict``."""
    arrays = []
    doc = sd.to_dict(obj, _arrays=arrays)
    return doc, [np.asarray(a) for a in arrays]


def assert_same(a, sd_a, b, sd_b):
    """Two results equal field by field: structure and arrays (NaN equal)."""
    doc_a, arr_a = flatten(a, sd_a)
    doc_b, arr_b = flatten(b, sd_b)
    assert doc_a == doc_b
    assert len(arr_a) == len(arr_b)
    for x, y in zip(arr_a, arr_b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def check_port_placement(res):
    assert isinstance(res.data, torch.Tensor) and res.data.device == torch.device("cpu")
    for axis in ("frequencies", "times"):
        if hasattr(res, axis):
            assert isinstance(getattr(res, axis), np.ndarray)


@pytest.mark.parametrize("name", RESULT_TYPES)
@pytest.mark.parametrize("fmt", ["json", "npz"])
def test_results_cross_package(both, name, fmt, tmp_path):
    t_res, j_res = both[0][name], both[1][name]
    assert type(t_res).__name__ == type(j_res).__name__ == name
    if fmt == "json":
        from_jax = serde.from_json(jserde.to_json(j_res), **CPU)
        from_port = jserde.from_json(serde.to_json(t_res))
        back = serde.from_json(serde.to_json(t_res), **CPU)
    else:
        jserde.save(j_res, tmp_path / "j.npz")
        serde.save(t_res, tmp_path / "t.npz")
        from_jax = serde.load(tmp_path / "j.npz", **CPU)
        from_port = jserde.load(tmp_path / "t.npz")
        back = serde.load(tmp_path / "t.npz", **CPU)
    assert type(from_jax) is type(t_res) and type(from_port) is type(j_res)
    check_port_placement(from_jax)
    check_port_placement(back)
    assert_same(from_jax, serde, j_res, jserde)   # the JAX file, read by the port
    assert_same(from_port, jserde, t_res, serde)  # the port's file, read by JAX
    assert_same(back, serde, t_res, serde)        # the port's own round trip


def test_result_data_goes_to_the_card_by_default(both):
    s = serde.to_json(both[0]["Mfcc"])
    if torch.cuda.is_available():
        assert serde.from_json(s).data.is_cuda
    else:
        with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
            serde.from_json(s)
    # params need no device
    assert serde.from_json(serde.to_json(tg.MfccParams(13))) == tg.MfccParams(13)


def test_spectrogram_result_roundtrip(tmp_path):
    params = tg.SpectrogramParams(tg.StftParams(512, 128), 16000.0)
    mel = tg.MelParams(64, 0.0, 8000.0, tg.MelNorm.SLANEY)
    spec = tg.MelDbPlan(params, mel, tg.LogParams(-80.0), dtype="float32",
                        **CPU).compute(sine(440.0, dtype=np.float32))
    back = serde.from_json(serde.to_json(spec), **CPU)
    assert isinstance(back, tg.Spectrogram)
    assert torch.equal(back.data, spec.data)
    np.testing.assert_array_equal(back.frequencies, spec.frequencies)
    assert back.freq_scale == spec.freq_scale and back.amp_scale == spec.amp_scale
    assert back.params == spec.params
    p = tmp_path / "spec.npz"
    serde.save(spec, p)
    back2 = serde.load(p, **CPU)
    assert torch.equal(back2.data, spec.data) and back2.params == spec.params


def test_stft_result_complex_roundtrip():
    params = tg.SpectrogramParams(tg.StftParams(256, 64), 8000.0)
    res = tg.StftPlan(params, dtype="float64", **CPU).compute(sine(440.0, sr=8000))
    back = serde.from_json(serde.to_json(res), **CPU)
    assert back.data.is_complex()
    assert torch.equal(back.data, res.data)


def test_binaural_result_roundtrip(tmp_path):
    left = sine(440.0, dtype=np.float64)
    params = tg.ITDSpectrogramParams(tg.SpectrogramParams(tg.StftParams(512, 128), 16000.0))
    itd = tg.compute_itd_spectrogram(np.stack([left, np.roll(left, 8)]), params, **CPU)
    p = tmp_path / "itd.npz"
    serde.save(itd, p)
    back = serde.load(p, **CPU)
    assert isinstance(back, tg.ItdSpectrogram)
    assert torch.equal(back.data, itd.data)
    assert back.params == itd.params


def test_unknown_type_rejected():
    with pytest.raises(tg.InvalidInputError, match="not registered"):
        serde.to_dict(object())
    with pytest.raises(tg.InvalidInputError, match="unknown type Nope"):
        serde.from_dict({"__type__": "Nope", "fields": {}})
    with pytest.raises(tg.InvalidInputError, match="missing __type__"):
        serde.from_dict({"fields": {}})


def test_register_type_before_builtins():
    class Custom:
        def __init__(self, x=1):
            self.x = x

        def __eq__(self, other):
            return self.x == other.x

    serde.register_type(Custom)
    p = tg.StftParams(256, 64)
    assert serde.from_json(serde.to_json(p)) == p
    assert serde.from_dict(serde.to_dict(Custom(5))) == Custom(5)


def test_multirate_params_roundtrip():
    for p in (
        tg.MelParams(80, 0.0, 4000.0, tg.MelNorm.SLANEY, multirate=True),
        tg.LogHzParams(64, 50.0, 4000.0, multirate=True),
        tg.CqtParams(12, 7, 32.703).with_multirate(),
        tg.ChromaParams.music_standard().with_multirate(),
    ):
        q = serde.from_json(serde.to_json(p))
        assert q == p and q.multirate is True


@pytest.mark.parametrize("name", ["spectrograms_tpu_torch.serde",
                                  "spectrograms_tpu_torch.binaural"])
def test_module_doctests(name):
    result = doctest.testmod(importlib.import_module(name), verbose=False)
    assert result.attempted > 0 and result.failed == 0
