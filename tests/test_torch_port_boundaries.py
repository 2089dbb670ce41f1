"""``tests/test_boundaries.py`` held on the port, on the CPU.

Minimal sizes, short signals and extreme parameters. Where the JAX test
checks a contract (a raise, a shape, a frame count) the port must meet the
same contract; where it checks a value, the port's value is held against
the JAX function's on the same numpy input, at the JAX test's tolerance.
The kernel route (``method="pallas"``, its plain version on the CPU) runs
each case the kernels admit (n_fft = 128·2^k in 256..4096) beside the
default route; ``chip_smoke.py`` phase 13 runs the same cases on the card.
"""

import numpy as np
import pytest

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg

SR = 16000.0
CPU = dict(device="cpu")


def params(m, n_fft, hop, centre=True):
    return m.SpectrogramParams(m.StftParams(n_fft, hop, centre=centre), SR)


def both(build, x, **kw):
    """(port result, JAX result) of the same plan built in each package."""
    return (build(tg, **kw, **CPU).compute(x),
            build(sg, **{k: v for k, v in kw.items() if k != "method" or v != "pallas"})
            .compute(x))


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_signal_shorter_than_n_fft_gives_one_frame(method):
    """``test_boundaries.py::test_signal_shorter_than_n_fft_gives_one_frame``:
    100 samples at 512/128 without centring give one frame of 257 bins,
    equal to JAX's."""
    x = np.ones(100, dtype=np.float32)
    out, ref = both(lambda m, **kw: m.LinearPowerPlan(params(m, 512, 128, False), **kw), x,
                    dtype="float32", method=method)
    assert out.shape == (257, 1) == ref.shape
    np.testing.assert_allclose(out.to_numpy(), np.asarray(ref.data), rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref.data).max()))


@pytest.mark.parametrize("n_fft,hop,method", [(64, 16, "auto"), (256, 64, "pallas")])
def test_single_sample_signal(n_fft, hop, method):
    """``test_boundaries.py::test_single_sample_signal``: one sample gives
    at least one finite frame, as in JAX (64/16 as the JAX test; 256/64 on
    the kernel route, whose smallest n_fft is 256)."""
    x = np.ones(1, dtype=np.float32)
    out, ref = both(lambda m, **kw: m.LinearPowerPlan(params(m, n_fft, hop), **kw), x,
                    dtype="float32", method=method)
    assert out.n_frames >= 1 and out.n_frames == ref.n_frames
    assert np.all(np.isfinite(out.to_numpy()))
    np.testing.assert_allclose(out.to_numpy(), np.asarray(ref.data), rtol=1e-5, atol=1e-6)


def test_empty_signal_rejected():
    """``test_boundaries.py::test_empty_signal_rejected``."""
    plan = tg.LinearPowerPlan(params(tg, 64, 16), dtype="float32", **CPU)
    with pytest.raises(tg.InvalidInputError):
        plan.compute(np.zeros(0, dtype=np.float32))


@pytest.mark.parametrize("n_fft,method", [(256, "auto"), (256, "pallas")])
def test_hop_equals_n_fft(n_fft, method):
    """``test_boundaries.py::test_hop_equals_n_fft``: 1024 samples at
    256/256 give (1024 + 256 - 256) // 256 + 1 frames, JAX's values."""
    x = np.ones(1024, dtype=np.float32)
    out, ref = both(lambda m, **kw: m.LinearPowerPlan(params(m, n_fft, n_fft), **kw), x,
                    dtype="float32", method=method)
    assert out.n_frames == (1024 + 256 - 256) // 256 + 1 == ref.n_frames
    np.testing.assert_allclose(out.to_numpy(), np.asarray(ref.data), rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref.data).max()))


@pytest.mark.parametrize("n_fft,n,method", [(32, 64, "auto"), (256, 512, "pallas")])
def test_hop_one(n_fft, n, method):
    """``test_boundaries.py::test_hop_one``: hop 1 without centring gives
    n - n_fft + 1 frames (32 on 64 samples as the JAX test; 256 on 512 on
    the kernel route), JAX's values."""
    x = np.ones(n, dtype=np.float32)
    out, ref = both(lambda m, **kw: m.LinearPowerPlan(params(m, n_fft, 1, False), **kw), x,
                    dtype="float32", method=method)
    assert out.n_frames == n - n_fft + 1 == ref.n_frames
    np.testing.assert_allclose(out.to_numpy(), np.asarray(ref.data), rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref.data).max()))


def test_fft_input_exactly_n_fft():
    """``test_boundaries.py::test_fft_input_exactly_n_fft``: 256 samples
    give 129 bins, equal to JAX's; 257 samples raise."""
    x = np.ones(256)
    spec = tg.fft(x, 256, **CPU)
    assert tuple(spec.shape) == (129,)
    np.testing.assert_allclose(spec.numpy(), np.asarray(sg.fft(x, 256)), atol=1e-9)
    with pytest.raises(tg.InvalidInputError):
        tg.fft(np.ones(257), 256, **CPU)


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_zero_signal_db_floor(method):
    """``test_boundaries.py::test_zero_signal_db_floor``: silence sits at
    the -100 dB floor everywhere (atol 1e-4, the JAX test's)."""
    plan = tg.LinearDbPlan(params(tg, 256, 64), tg.LogParams(-100.0), dtype="float32",
                           method=method, **CPU)
    out = plan.compute(np.zeros(1000, dtype=np.float32)).to_numpy()
    np.testing.assert_allclose(out, -100.0, atol=1e-4)


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_mel_single_band(method):
    """``test_boundaries.py::test_mel_single_band``: one mel band gives one
    output row, JAX's values."""
    x = np.ones(1000, dtype=np.float32)
    out, ref = both(lambda m, **kw: m.MelPowerPlan(params(m, 256, 64),
                                                   m.MelParams(1, 0.0, 8000.0), **kw), x,
                    dtype="float32", method=method)
    assert out.shape[0] == 1 == ref.shape[0]
    np.testing.assert_allclose(out.to_numpy(), np.asarray(ref.data), rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref.data).max()))


def test_istft_single_frame():
    """``test_boundaries.py::test_istft_single_frame``: one frame back
    through ``istft`` gives 256 samples, equal to the input away from the
    window's zero ends (rtol 1e-6, atol 1e-8, the JAX test's) and to JAX's
    reconstruction."""
    x = np.random.default_rng(0).standard_normal(256)
    spec = tg.stft(x[:256], 256, 256, centre=False, **CPU)
    assert spec.shape[1] == 1
    rec = tg.istft(spec, 256, 256, centre=False, **CPU).numpy()
    assert rec.shape[0] == 256
    np.testing.assert_allclose(rec[16:-16], x[16:-16], rtol=1e-6, atol=1e-8)
    jrec = np.asarray(sg.istft(sg.stft(x[:256], 256, 256, centre=False), 256, 256,
                               centre=False))
    np.testing.assert_allclose(rec[16:-16], jrec[16:-16], rtol=1e-6, atol=1e-8)


VALIDATION = [
    lambda m: m.StftParams(0, 1),
    lambda m: m.StftParams(256, 0),
    lambda m: m.StftParams(256, 512),                        # hop > n_fft
    lambda m: m.MelParams(0, 0.0, 8000.0),
    lambda m: m.MelParams(10, 5000.0, 1000.0),               # f_min > f_max
    lambda m: m.SpectrogramParams(m.StftParams(256, 64), 0.0),
    lambda m: m.MelPowerPlan(params(m, 256, 64), m.MelParams(10, 0.0, 9000.0),  # > Nyquist
                             dtype="float32", **(CPU if m is tg else {})),
]


@pytest.mark.parametrize("case", range(len(VALIDATION)))
def test_validation_matrix(case):
    """``test_boundaries.py::test_validation_matrix``: each bad parameter
    raises ``InvalidInputError`` in both packages, with the same message."""
    with pytest.raises(sg.InvalidInputError) as jax_err:
        VALIDATION[case](sg)
    with pytest.raises(tg.InvalidInputError) as port_err:
        VALIDATION[case](tg)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("method", ["auto", "pallas"])
def test_plan_rejects_2d_input(method):
    """``test_boundaries.py::test_plan_rejects_2d_input``: ``compute``
    rejects a (2, n) input; ``compute_batch`` takes it, JAX's values."""
    plan = tg.LinearPowerPlan(params(tg, 256, 64), dtype="float32", method=method, **CPU)
    x = np.ones((2, 1000), dtype=np.float32)
    with pytest.raises(tg.InvalidInputError):
        plan.compute(x)
    out = plan.compute_batch(x)
    assert out.shape[0] == 2
    ref = np.asarray(sg.LinearPowerPlan(params(sg, 256, 64), dtype="float32").compute_batch(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6 * float(np.abs(ref).max()))


# ---- every geometry the kernels admit has a block layout -------------------------

def _mappings(n_fft: int) -> dict:
    """Mapping (n_out, n_bins) and DCT (or None) of the plans the kernels run:
    identity, one and 256 mel bands, MFCC-128 of 256 bands, dense log-Hz
    and ERB banks of 256 rows, chroma; at 44.1 kHz."""
    from spectrograms_tpu_torch.mfcc import _dct_lifter_matrix
    from spectrograms_tpu_torch.ops import filterbanks as fbm

    sr = 44100.0
    mel = lambda n: fbm.mel_filterbank(sr, n_fft, tg.MelParams(n, 0.0, sr / 2, tg.MelNorm.SLANEY))
    return {
        "identity": (np.eye(n_fft // 2 + 1), None),
        "mel-1": (mel(1), None),
        "mel-256": (mel(256), None),
        "mfcc-128": (mel(256), _dct_lifter_matrix(256, 128, 22)),
        "loghz-256": (fbm.loghz_matrix(sr, n_fft, tg.LogHzParams(256, 20.0, sr / 2))[0], None),
        "erb-256": (fbm.erb_filterbank(sr, n_fft, tg.ErbParams(256, 20.0, sr / 2))[0], None),
        "chroma": (fbm.chroma_filterbank(sr, n_fft, tg.ChromaParams()), None),
    }


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_every_admitted_geometry_has_a_kernel_layout(n_fft):
    """``supports_factored_fusion`` admits any hop <= n_fft, and does not ask
    the kernels' host layouts; each layout raises ``InvalidInputError`` when
    a block does not fit in shared memory. At hops 1, 2, 3, 7, 160, n_fft/2,
    n_fft - 1 and n_fft, and the densest mappings a plan builds, both
    kernels' layouts (the f32 kernel's tile, the tier kernel's tile, class
    groups and work items at each tier and form) exist, so no admitted plan
    that ``auto`` sends to a kernel is refused on the card."""
    from spectrograms_tpu_torch.ops import f32_layout as fl32
    from spectrograms_tpu_torch.ops import fused_factored as ff
    from spectrograms_tpu_torch.ops import tier_layout as tl

    for name, (fb, dct) in _mappings(n_fft).items():
        n_items = len(fl32.kernel_pieces(fb)[0])
        ntiles, _, kc, _, kd = ff.tier_geometry(fb, dct, n_fft)
        for hop in sorted({1, 2, 3, 7, 160, n_fft // 2, n_fft - 1, n_fft}):
            assert ff.supports_factored_fusion(n_fft, hop, "float32")
            tile = fl32.tile_frames(n_fft, hop, n_items, fb.shape[0], dct is not None)
            assert fl32.smem_layout(tile, n_fft, hop, n_items, fb.shape[0],
                                    dct is not None)[1] <= fl32.MAX_SMEM
            for gauss in (True, False):
                for x2 in (False, True):
                    lay = tl.tier_layout(n_fft, hop, gauss, x2, kc, kd)
                    assert lay.smem <= tl.MAX_SMEM, (hop, name)
                    tl.outer_items(ntiles, lay.groups, lay.tile_f, tl.block_threads(n_fft) // 32)
