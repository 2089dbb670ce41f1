"""The port's ``FeaturePipeline`` against the JAX package's, on the CPU.

The same PCM16 clips (the ``clips`` fixture of ``tests/test_serving.py:19``)
through both pipelines: features within 1e-3 dB (both sides plain f32 on
the CPU; the JAX int16/ulaw steps run its XLA twin, the port's the plan's
own forward), lengths and masks equal, for each transport, ``run_arrays``,
preload (with the corrupt-file error order), ``pipeline_uploads``,
FeatureSet serving and the MFCC plan. In the port int16 serving is
bit-equal to float32 serving (``tests/test_serving.py:178``), and μ-law
within the bound of ``tests/test_serving.py:319-342``. Also: the preload
budget, ``throughput_report``'s keys, ``warm_preload``, and ``mesh=`` and
``autotune=True`` (against ``mesh=None`` and the JAX pipeline).
"""

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.chroma import ChromaPlan as JaxChromaPlan
from spectrograms_tpu.mfcc import MfccPlan as JaxMfccPlan
from spectrograms_tpu.serving import FeaturePipeline as JaxPipeline
from spectrograms_tpu_torch.runtime import read_wav, write_wav
from spectrograms_tpu_torch.runtime.loader import AudioBatchLoader

SR = 16000
DB_TOL = 1e-3


@pytest.fixture
def clips(tmp_path):
    rng = np.random.default_rng(0)
    paths, lengths = [], [SR, SR // 2, SR * 2, SR, 3 * SR // 4, SR + 123]
    for i, n in enumerate(lengths):
        p = tmp_path / f"c{i}.wav"
        write_wav(p, (0.3 * rng.standard_normal(n)).astype(np.float32), SR, bits=16)
        paths.append(p)
    return paths, lengths


def mel_db(m, n_mels=64, **kw):
    if m is tg:
        kw.setdefault("device", "cpu")
    return m.SpectrogramPlan(m.SpectrogramParams(m.StftParams(512, 128), float(SR)),
                             m.FreqScale.MEL, m.AmpScale.DECIBELS,
                             scale_params=m.MelParams(n_mels, 0.0, 8000.0, m.MelNorm.SLANEY),
                             log_params=m.LogParams(-80.0), dtype="float32", **kw)


def pipes(plan_fn=mel_db, **kw):
    """(port pipeline, JAX pipeline) over the same configuration."""
    return (tg.FeaturePipeline(plan_fn(tg), **kw), JaxPipeline(plan_fn(sg), **kw))


def collect(it):
    return [(b.features.numpy() if isinstance(b.features, torch.Tensor)
             else np.asarray(b.features), np.array(b.lengths), np.array(b.frame_mask))
            for b in it]


def assert_close_batches(got, want, tol=DB_TOL):
    assert len(got) == len(want)
    for (fg, lg, mg), (fw, lw, mw) in zip(got, want):
        assert fg.shape == fw.shape
        np.testing.assert_array_equal(lg, lw)
        np.testing.assert_array_equal(mg, mw)
        np.testing.assert_allclose(fg, fw, rtol=0, atol=tol)


@pytest.mark.parametrize("preload", [False, True])
@pytest.mark.parametrize("transport", ["float32", "int16", "ulaw"])
def test_transports_match_jax(clips, transport, preload):
    paths, lengths = clips
    t, j = pipes(batch_size=4, target_seconds=1.0, transport=transport)
    got = collect(t.run(paths, preload=preload))
    assert_close_batches(got, collect(j.run(paths, preload=preload)))
    assert sum(int((g[1] > 0).sum()) for g in got) == len(paths)
    assert got[0][0].shape == (4, 64, t._n_frames)


def test_int16_is_bit_equal_to_float32_and_ulaw_within_companding(clips):
    paths, _ = clips
    plan = mel_db(tg)
    run = lambda tr: list(tg.FeaturePipeline(plan, batch_size=3, target_seconds=1.0,
                                             transport=tr).run(paths))
    f32, i16, u8 = run("float32"), run("int16"), run("ulaw")
    assert len(f32) == len(i16) == len(u8) == 2
    for a, b, c in zip(f32, i16, u8):
        assert torch.equal(a.features, b.features)
        np.testing.assert_array_equal(a.frame_mask, c.frame_mask)
        am, cm = a.masked().numpy(), c.masked().numpy()
        live = am > -60.0
        assert live.any() and np.abs(am[live] - cm[live]).max() < 3.0  # test_serving.py:342


def test_batches_equal_compute_batch_of_the_loader_rows(clips):
    paths, _ = clips
    plan = mel_db(tg)
    pipe = tg.FeaturePipeline(plan, batch_size=2, target_seconds=1.0, transport="int16")
    got = list(pipe.run(paths))
    loader = AudioBatchLoader(paths, batch_size=2, target_len=SR, expected_sample_rate=SR)
    want = [(plan.compute_batch(d), n) for d, n, _ in loader.iter_with_rates()]
    assert len(got) == len(want) == 3
    for b, (f, n) in zip(got, want):
        assert torch.equal(b.features, f)
        np.testing.assert_array_equal(b.frame_mask, pipe._frame_mask(n))


def test_masks_zero_the_padding_frames(clips):
    paths, _ = clips
    pipe = tg.FeaturePipeline(mel_db(tg), batch_size=3, target_seconds=1.0)
    for batch in pipe.run(paths):
        masked, mask = batch.masked().numpy(), batch.frame_mask
        assert batch.batch_size == 3 and mask.shape == (3, pipe._n_frames)
        for i, n in enumerate(batch.lengths):
            if n == 0:
                assert not mask[i].any()
                np.testing.assert_array_equal(masked[i], 0)
            elif n < SR:
                assert mask[i, 0] and not mask[i, -1]
                np.testing.assert_array_equal(masked[i][:, ~mask[i]], 0)
    lengths = np.array([0, 1, 100, 511, 512, 16000, 20000])
    for geom in ((512, 128, True), (512, 128, False), (1024, 160, True)):
        nf = 126
        want = JaxPipeline._mask_from(lengths, *geom, nf)
        np.testing.assert_array_equal(tg.FeaturePipeline._mask_from(lengths, *geom, nf), want)


@pytest.mark.parametrize("transport", ["float32", "int16", "ulaw"])
def test_run_arrays_matches_jax(clips, transport):
    paths, lengths = clips
    rng = np.random.default_rng(3)
    arrays = [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in lengths]
    arrays[1] = np.clip(np.rint(arrays[1] * 32768.0), -32768, 32767).astype(np.int16)
    t, j = pipes(batch_size=4, target_seconds=1.0, transport=transport)
    got = collect(t.run_arrays(arrays, sample_rates=SR))
    assert_close_batches(got, collect(j.run_arrays(arrays, sample_rates=SR)))
    pre = collect(t.run_arrays(arrays, sample_rates=SR, preload=True))
    for (a, _, _), (b, _, _) in zip(got, pre):
        np.testing.assert_array_equal(a, b)
    with pytest.warns(UserWarning, match="rate check is bypassed"):
        list(t.run_arrays(arrays))
    if transport == "int16":  # int16 rows ship verbatim, as the file loader's
        files = [read_wav(p, mono=True)[0] for p in paths]
        as_i16 = [np.clip(np.rint(a * 32768.0), -32768, 32767).astype(np.int16) for a in files]
        for a, b in zip(t.run(paths), t.run_arrays(as_i16, sample_rates=SR)):
            assert torch.equal(a.masked(), b.masked())


def test_run_arrays_rate_policy(clips):
    arrays = [np.zeros(SR, np.float32), np.ones(2 * SR, np.float32) * 0.1]
    pipe = tg.FeaturePipeline(mel_db(tg), batch_size=2, target_seconds=1.0)
    with pytest.raises(tg.InvalidInputError, match=r"arrays\[1\]"):
        list(pipe.run_arrays(arrays, sample_rates=[SR, 2 * SR]))
    pipe = tg.FeaturePipeline(mel_db(tg), batch_size=2, target_seconds=1.0,
                              on_rate_mismatch="resample")
    (b,) = list(pipe.run_arrays(arrays, sample_rates=[SR, 2 * SR]))
    assert b.lengths.tolist() == [SR, SR]


def test_preload_corrupt_file_behaves_like_serial(clips, tmp_path):
    """Good batches first, then the error; no features for the bad row
    (``tests/test_serving.py:800``), as in the JAX package."""
    paths, _ = clips
    bad = tmp_path / "corrupt.wav"
    bad.write_bytes(b"RIFFgarbage-not-a-wav-file")
    mixed = list(paths[:4]) + [bad] + list(paths[4:])

    def run(pipe, preload):
        got, err = [], None
        try:
            for b in pipe.run(mixed, preload=preload):
                m = b.masked()
                got.append((np.array(b.lengths), m.numpy() if isinstance(m, torch.Tensor)
                            else np.asarray(m)))
        except IOError as e:
            err = e
        return got, err

    t, j = pipes(batch_size=4, target_seconds=1.0, transport="int16")
    serial, serial_err = run(t, False)
    pre, pre_err = run(t, True)
    jax_pre, jax_err = run(j, True)
    assert serial_err is not None and pre_err is not None and jax_err is not None
    assert len(serial) == len(pre) == len(jax_pre) >= 1
    for (ls, fs), (lp, fp), (lj, fj) in zip(serial, pre, jax_pre):
        np.testing.assert_array_equal(ls, lp)
        np.testing.assert_array_equal(ls, lj)
        np.testing.assert_array_equal(fs, fp)
        np.testing.assert_allclose(fs, fj, rtol=0, atol=DB_TOL)
    assert t.last_preload_stats["n_batches"] == len(serial)


def test_pipeline_uploads_matches_serial(clips):
    paths, _ = clips
    plan = mel_db(tg)
    pipe = tg.FeaturePipeline(plan, batch_size=2, target_seconds=1.0, pipeline_uploads=True)
    serial = tg.FeaturePipeline(plan, batch_size=2, target_seconds=1.0)
    got = list(pipe.run(paths))
    assert len(got) == 3
    for a, b in zip(got, serial.run(paths)):
        assert torch.equal(a.masked(), b.masked())
    pre = list(pipe.run(paths, preload=True))
    for a, b in zip(got, pre):
        assert torch.equal(a.features, b.features)
    # leaving early releases the held slots
    it = pipe.run(paths)
    next(it)
    it.close()
    with pytest.raises(tg.InvalidInputError, match="prefetch"):
        tg.FeaturePipeline(plan, batch_size=2, target_seconds=1.0, prefetch_batches=2,
                           pipeline_uploads=True)


def test_preload_budget_guard(clips):
    paths, _ = clips
    pipe = tg.FeaturePipeline(mel_db(tg), batch_size=4, target_seconds=1.0, transport="int16")
    with pytest.raises(tg.InvalidInputError, match="max_preload_bytes"):
        list(pipe.run(paths, preload=True, max_preload_bytes=1024))
    with pytest.raises(tg.InvalidInputError):  # eagerly, before any decode
        pipe.run(["missing.wav"] * 10_000, preload=True, max_preload_bytes=1 << 20)
    # 2 batches of 4 × 16000 int16 samples fit 256 KiB exactly
    assert len(list(pipe.run(paths, preload=True, max_preload_bytes=256 << 10))) == 2


def test_throughput_report_keys_match_jax(clips):
    paths, lengths = clips
    t, j = pipes(batch_size=2, target_seconds=1.0)
    for preload in (False, True):
        rt, rj = t.throughput_report(paths, preload=preload), j.throughput_report(paths,
                                                                                  preload=preload)
        assert set(rt) == set(rj)
        assert rt["audio_seconds"] == rj["audio_seconds"] == sum(min(n, SR) for n in lengths) / SR
        assert rt["audio_s_per_s"] > 0
    assert set(rt["preload_phases"]) == {"stage_s", "compile_s", "n_batches"}
    assert rt["preload_phases"]["n_batches"] == 3


def test_warm_preload_builds_nothing_on_the_cpu(clips):
    pipe = tg.FeaturePipeline(mel_db(tg, method="pallas"), batch_size=2, target_seconds=1.0)
    assert pipe.warm_preload() is True
    from spectrograms_tpu_torch.serving import _kernel_sources

    assert _kernel_sources(pipe.plan) == {"fused_features"}
    tier = tg.MfccPlan(tg.StftParams(2048, 512), 44100.0, precision=tg.Precision.DEFAULT,
                       mel_params=tg.MelParams(80, 0.0, 4000.0).with_multirate(),
                       method="pallas", device="cpu")
    multi = mel_db(tg, method="pallas")
    assert _kernel_sources(tg.FeatureSet([tier, multi, lambda b: b])) == {
        "fused_tier_features", "fused_features"}


def test_not_yet_ported_options_raise(clips):
    """``mesh=`` and ``autotune=True`` work: a 2-entry mesh
    (the CPU, repeated) serves the same batches as ``mesh=None`` bit for
    bit and JAX's pipeline over a 2-device mesh within 1e-3 dB; autotune
    tunes at the block's shape (4 rows over 2 entries) and its winner
    serves the JAX features. What still raises is JAX's: an uneven
    ``batch_size`` over the data axis, and ``autotune=True`` on a
    ``FeatureSet``."""
    from spectrograms_tpu.parallel import create_device_mesh as jax_mesh
    from spectrograms_tpu_torch.parallel import create_device_mesh

    paths, _ = clips
    mesh = create_device_mesh((2,), ("data",), devices=["cpu"] * 2)
    plan = mel_db(tg)
    plain = collect(tg.FeaturePipeline(plan, batch_size=4, target_seconds=1.0).run(paths))
    meshed = tg.FeaturePipeline(plan, batch_size=4, target_seconds=1.0, mesh=mesh,
                                transport="int16")
    got = collect(meshed.run(paths))
    assert len(got) == len(plain) == 2
    for (a, la, ma), (b, lb, mb) in zip(got, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(ma, mb)
    jpipe = JaxPipeline(mel_db(sg), batch_size=4, target_seconds=1.0,
                        mesh=jax_mesh((2,), ("data",)), transport="int16")
    assert_close_batches(got, collect(jpipe.run(paths)))

    tg.clear_wisdom()
    try:
        tuned = tg.FeaturePipeline(mel_db(tg), batch_size=4, target_seconds=1.0, mesh=mesh,
                                   autotune=True)
        r = tuned.autotune_result
        assert r is not None and not r.from_cache and r.winner in ("fft", "matmul")
        assert tuned.plan is r.plan and tuned.plan.method == r.winner
        assert "[2, 16000]" in r.key  # tuned at the block's shape
        assert_close_batches(collect(tuned.run(paths)), collect(jpipe.run(paths)))
        again = tg.FeaturePipeline(mel_db(tg), batch_size=4, target_seconds=1.0, mesh=mesh,
                                   autotune=True)
        assert again.autotune_result.from_cache and again.autotune_result.winner == r.winner
    finally:
        tg.clear_wisdom()

    for m, mk in ((tg, lambda: mesh), (sg, lambda: jax_mesh((2,), ("data",)))):
        cls = tg.FeaturePipeline if m is tg else JaxPipeline
        with pytest.raises(m.InvalidInputError, match="must divide evenly"):
            cls(mel_db(m), batch_size=3, target_seconds=1.0, mesh=mk())
        with pytest.raises(m.InvalidInputError, match="autotune"):
            cls(m.FeatureSet([mel_db(m)]), batch_size=2, target_seconds=1.0, autotune=True)


def test_featureset_served_over_a_mesh(clips):
    """A ``FeatureSet`` over a 4-entry mesh: each member equal to the
    unmeshed set's, rows in order."""
    from spectrograms_tpu_torch.parallel import create_device_mesh

    paths, _ = clips
    fs = tg.FeatureSet([mel_db(tg), mel_db(tg, n_mels=32)])
    mesh = create_device_mesh((4,), ("data",), devices=["cpu"] * 4)
    a = list(tg.FeaturePipeline(fs, batch_size=4, target_seconds=1.0, mesh=mesh).run(paths))
    b = list(tg.FeaturePipeline(fs, batch_size=4, target_seconds=1.0).run(paths))
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert len(x.features) == 2
        for fx, fy in zip(x.features, y.features):
            assert torch.equal(fx, fy)


def test_constructor_validation_matches_jax():
    for m, cls in ((tg, tg.FeaturePipeline), (sg, JaxPipeline)):
        with pytest.raises(m.InvalidInputError, match="transport"):
            cls(mel_db(m), batch_size=2, target_seconds=1.0, transport="int8")
        with pytest.raises(m.InvalidInputError, match="positive"):
            cls(mel_db(m), batch_size=2, target_seconds=0.0)
    with pytest.raises(tg.InvalidInputError, match="disagree"):
        other = tg.SpectrogramPlan(tg.SpectrogramParams(tg.StftParams(512, 128), 2.0 * SR),
                                   tg.FreqScale.MEL, tg.AmpScale.DECIBELS,
                                   scale_params=tg.MelParams(64, 0.0, 8000.0), device="cpu")
        tg.FeaturePipeline(tg.FeatureSet([mel_db(tg), other]), batch_size=4, target_seconds=1.0)
    with pytest.raises(tg.InvalidInputError, match="sample rate"):
        tg.FeaturePipeline(tg.FeatureSet([lambda b: b]), batch_size=4, target_seconds=1.0)


def _fset(m):
    lin = m.SpectrogramPlan(m.SpectrogramParams(m.StftParams(512, 128), float(SR)),
                            m.FreqScale.LINEAR, m.AmpScale.POWER, dtype="float32",
                            **({"device": "cpu"} if m is tg else {}))
    return m.FeatureSet([mel_db(m), lin])


@pytest.mark.parametrize("preload", [False, True])
def test_featureset_serving_matches_jax(clips, preload):
    paths, _ = clips
    t, j = pipes(_fset, batch_size=4, target_seconds=1.0, transport="int16")
    got, want = list(t.run(paths, preload=preload)), list(j.run(paths, preload=preload))
    assert len(got) == len(want) == 2
    for bt, bj in zip(got, want):
        assert isinstance(bt, tg.FeatureSetBatch) and len(bt.features) == 2
        np.testing.assert_array_equal(bt.lengths, bj.lengths)
        for ft, fj, mt, mj, tol in zip(bt.features, bj.features, bt.frame_masks, bj.frame_masks,
                                       (DB_TOL, None)):
            fj = np.asarray(fj)
            np.testing.assert_array_equal(mt, mj)
            np.testing.assert_allclose(ft.numpy(), fj, rtol=0,
                                       atol=tol if tol else 1e-5 * float(np.abs(fj).max()))
        m0, m1 = bt.masked()
        assert m0.shape[0] == 4 and m1.shape[0] == 4 and bt.batch_size == 4


def test_featureset_callable_member_gets_no_mask(clips):
    paths, _ = clips
    fset = tg.FeatureSet([mel_db(tg), lambda xb: xb[:, :100]])
    pipe = tg.FeaturePipeline(fset, batch_size=4, target_seconds=1.0, sample_rate_hz=float(SR))
    for batch in pipe.run(paths):
        assert batch.frame_masks[0] is not None and batch.frame_masks[1] is None
        assert tuple(batch.masked()[1].shape) == (4, 100)


def test_mfcc_plan_and_multirate_members_serve_with_masks(clips):
    """The MFCC plan directly (its rate and geometry come from the mel
    plan), and a multirate chroma member beside a mel member at 44.1 kHz:
    the full-rate frame grid, so equal masks."""
    paths, _ = clips

    def mfcc(m):
        cls = tg.MfccPlan if m is tg else JaxMfccPlan
        return cls(m.StftParams(512, 128), float(SR),
                   mel_params=m.MelParams(64, 0.0, 8000.0, m.MelNorm.SLANEY),
                   mfcc_params=m.MfccParams(13), log_params=m.LogParams(-80.0), dtype="float32",
                   **({"device": "cpu"} if m is tg else {}))

    t, j = pipes(mfcc, batch_size=4, target_seconds=1.0, transport="int16")
    assert t.sample_rate_hz == float(SR)
    got, want = collect(t.run(paths)), collect(j.run(paths))
    scale = max(float(np.abs(w[0]).max()) for w in want)
    assert_close_batches(got, want, tol=1e-4 * scale)
    assert got[0][0].shape[1] == 13

    def multirate_set(m):
        cls = tg.ChromaPlan if m is tg else JaxChromaPlan
        kw = {"device": "cpu"} if m is tg else {}
        ch = cls(m.StftParams(4096, 1024), 44100.0,
                 m.ChromaParams.music_standard().with_multirate(), dtype="float32", **kw)
        mel = m.SpectrogramPlan(m.SpectrogramParams(m.StftParams(4096, 1024), 44100.0),
                                m.FreqScale.MEL, m.AmpScale.DECIBELS,
                                scale_params=m.MelParams(64, 0.0, 22050.0, m.MelNorm.SLANEY),
                                log_params=m.LogParams(-80.0), dtype="float32", **kw)
        return m.FeatureSet([ch, mel])

    t, j = pipes(multirate_set, batch_size=4, target_seconds=0.5, transport="int16",
                 on_rate_mismatch="resample")
    assert t.plan._members[0]._decimation == 2
    for bt, bj in zip(t.run(paths), j.run(paths)):
        for f, m in zip(bt.features, bt.frame_masks):
            assert m is not None and m.shape == (4, f.shape[-1])
        np.testing.assert_array_equal(bt.frame_masks[0], bt.frame_masks[1])
        np.testing.assert_array_equal(bt.frame_masks[0], bj.frame_masks[0])
        cj = np.asarray(bj.features[0])
        np.testing.assert_allclose(bt.features[0].numpy(), cj, rtol=0,
                                   atol=1e-5 * float(np.abs(cj).max()))
