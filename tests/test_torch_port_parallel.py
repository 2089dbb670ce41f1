"""The port's ``parallel/`` against the JAX package's, on the CPU.

Counterparts of ``tests/test_parallel.py`` (less its JAX entry-point
dry run) and ``tests/test_collectives.py``, with their inputs. The port's
meshes may repeat a device, so JAX's 8- and 4-entry meshes are built on the
host's one CPU device. Tolerances are the JAX tests': data parallelism
against ``compute_batch`` at 1e-4 (also against the JAX program's output),
sequence parallelism against ``compute_raw`` at 1e-10 in f64 (and 1e-3 dB
in f32 through the fused route's plain version), stacking and padding
exact. JAX counts collectives in compiled HLO; the port counts calls into
``torch.distributed`` (none on the data-parallel path) and the sequence
path's device copies (P − 1 halos and one gather).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu import parallel as jpar
from spectrograms_tpu_torch.parallel import (
    audio_seconds_per_second,
    batch,
    batch_with_metadata,
    create_device_mesh,
    data_parallel_pipeline,
    initialize_distributed,
    make_named_sharding,
    pad_signals,
    sequence_parallel_spectrogram,
    shard_batch,
)
from spectrograms_tpu_torch.parallel.data import ShardedBatch, plan_replica
from tests.conftest import noise

SR = 16000.0
CPU = dict(device="cpu")


def mesh(n, axis="data"):
    return create_device_mesh((n,), (axis,), devices=["cpu"] * n)


def plan(m, dtype="float32"):
    kw = CPU if m is tg else {}
    return m.SpectrogramPlanner().mel_db_plan(
        m.SpectrogramParams(m.StftParams(256, 128), SR), m.MelParams(32, 0.0, 8000.0),
        dtype=dtype, **kw)


@pytest.fixture
def collectives(monkeypatch):
    """Counts calls into ``torch.distributed``'s communication functions."""
    calls = []
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor", "all_to_all",
                 "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor", "broadcast",
                 "send", "recv", "isend", "irecv", "gather", "scatter", "reduce", "barrier",
                 "all_gather_object", "broadcast_object_list", "batch_isend_irecv"):
        if hasattr(dist, name):
            monkeypatch.setattr(dist, name, lambda *a, _n=name, **k: calls.append(_n))
    return calls


def test_mesh_creation(monkeypatch):
    m = mesh(8)
    assert m.shape["data"] == 8 and m.devices.size == 8 and m.size == 8
    m2 = create_device_mesh((4, 2), ("data", "time"), devices=["cpu"] * 8)
    assert m2.shape == {"data": 4, "time": 2}
    j2 = jpar.create_device_mesh((4, 2), ("data", "time"))
    assert dict(j2.shape) == m2.shape
    for m_, kw in ((tg, dict(devices=["cpu"] * 8)), (sg, {})):
        with pytest.raises(m_.InvalidInputError, match="needs 16 devices, have 8"):
            m_.parallel.create_device_mesh((16,), ("data",), **kw)
        with pytest.raises(m_.InvalidInputError, match="same length"):
            m_.parallel.create_device_mesh((2, 2), ("data",), **kw)
    # the default: this process's cards; without one it raises (never a CPU mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tg.InvalidInputError, match="CUDA is not available"):
        create_device_mesh((1,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    d = create_device_mesh((1,))
    assert d.devices[0] == torch.device("cuda", 0) and d.is_local()
    monkeypatch.undo()
    assert m == mesh(8) and hash(m) == hash(mesh(8)) and m != mesh(4)
    s = make_named_sharding(m, ("data",))
    assert s.mesh is m and tuple(s.spec) == ("data",)


def test_data_parallel_matches_single_device(collectives):
    m = mesh(8)
    p = plan(tg)
    signals = np.stack([noise(4096, seed=i).astype(np.float32) for i in range(16)])
    fn = data_parallel_pipeline(p._forward_impl, m)
    sharded = shard_batch(signals, m)
    assert isinstance(sharded, ShardedBatch) and len(sharded.addressable_shards) == 8
    out = fn(sharded)
    assert out.shape == (16, 32, 33)
    got = np.asarray(out)
    single = p.compute_batch(signals).numpy()
    assert np.allclose(got, single, atol=1e-4)
    jm = jpar.create_device_mesh((8,), ("data",))
    jp = plan(sg)
    want = np.asarray(jpar.data_parallel_pipeline(jp._forward_impl, jm)(
        jpar.shard_batch(signals, jm)))
    assert np.allclose(got, want, atol=1e-4)
    # each block was computed where it lies, two rows a block
    for sh in out.addressable_shards:
        assert sh.device == torch.device("cpu") and sh.data.shape[0] == 2
    assert collectives == []


def test_shard_batch_validation():
    m = mesh(8)
    for pkg, mm in ((tg, m), (sg, jpar.create_device_mesh((8,), ("data",)))):
        with pytest.raises(pkg.InvalidInputError, match="must divide evenly"):
            pkg.parallel.shard_batch(np.ones((7, 100)), mm, pad=False)


def test_shard_batch_pads_uneven_with_mask():
    m = mesh(8)
    x = np.arange(7 * 100, dtype=np.float32).reshape(7, 100) + 1.0
    out, mask = shard_batch(x, m, return_mask=True)
    assert out.shape == (8, 100) and mask.shape == (8,)
    assert bool(mask[:7].all()) and not bool(mask[7])
    np.testing.assert_array_equal(np.asarray(out)[:7], x)
    np.testing.assert_array_equal(np.asarray(out)[7], 0.0)
    with pytest.warns(UserWarning, match="zero-padded the batch from 7 to 8"):
        shard_batch(x, m)
    # the blocks are copies: the caller's array is not aliased
    out.addressable_shards[0].data.fill_(-1.0)
    assert x[0, 0] == 1.0
    # padded rows run through a data-parallel program without disturbing the real rows
    p = plan(tg)
    fn = data_parallel_pipeline(p._forward_impl, m)
    signals = np.stack([noise(4096, seed=i).astype(np.float32) for i in range(7)])
    padded, pm = shard_batch(signals, m, return_mask=True)
    feats = np.asarray(fn(padded))
    single = p.compute_batch(signals).numpy()
    assert np.allclose(feats[np.asarray(pm)], single, atol=1e-4)
    want = np.asarray(plan(sg).compute_batch(signals))
    assert np.allclose(feats[np.asarray(pm)], want, atol=1e-4)


@pytest.mark.parametrize("n_len", [16000, 16001, 40000, 5000])
def test_sequence_parallel_matches_single(n_len):
    m = mesh(4, "time")
    p = plan(tg, "float64")
    fn = sequence_parallel_spectrogram(p, m, axis="time")
    x = noise(n_len, seed=3)
    out = fn(x).numpy()
    ref = p.compute_raw(x).numpy()
    assert out.shape == ref.shape
    assert np.allclose(out, ref, atol=1e-10)
    jfn = jpar.sequence_parallel_spectrogram(plan(sg, "float64"),
                                             jpar.create_device_mesh((4,), ("time",)), "time")
    assert np.allclose(out, np.asarray(jfn(x)), atol=1e-10)


def test_sequence_parallel_f32_runs_the_kernel_route():
    """A float32 ``method="pallas"`` plan: each shard runs the centre-less
    copy's kernel route (its plain version here), against ``compute`` and
    JAX at 1e-3 dB; a 2-D mesh's time axis and its other axis."""
    params = tg.SpectrogramParams(tg.StftParams(1024, 256), SR)
    mel = tg.MelParams(64, 0.0, 8000.0, tg.MelNorm.SLANEY)
    p = tg.MelDbPlan(params, mel, tg.LogParams(-80.0), dtype="float32", method="pallas", **CPU)
    m = create_device_mesh((2, 4), ("data", "time"), devices=["cpu"] * 8)
    x = noise(48000, seed=5).astype(np.float32)
    out = sequence_parallel_spectrogram(p, m, axis="time")(x).numpy()
    ref = p.compute_raw(x).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    copy = p._centreless_copies[torch.device("cpu")]
    assert not copy._centre and copy.method == "pallas" and hasattr(copy, "_kernel_run")
    jp = sg.MelDbPlan(sg.SpectrogramParams(sg.StftParams(1024, 256), SR),
                      sg.MelParams(64, 0.0, 8000.0, sg.MelNorm.SLANEY), sg.LogParams(-80.0),
                      dtype="float32", method="matmul")
    np.testing.assert_allclose(out, np.asarray(jp.compute_raw(x)), rtol=0, atol=1e-3)


def test_sequence_parallel_multirate_warns_and_runs_full_rate():
    sr = 44100.0
    p = tg.MelDbPlan(tg.SpectrogramParams(tg.StftParams(2048, 512), sr),
                     tg.MelParams(64, 0.0, 4000.0, tg.MelNorm.SLANEY, multirate=True),
                     tg.LogParams(-80.0), dtype="float64", **CPU)
    with pytest.warns(UserWarning, match="full rate"):
        fn = sequence_parallel_spectrogram(p, mesh(4, "time"), axis="time")
    x = noise(int(sr * 0.5), seed=2)
    jp = sg.MelDbPlan(sg.SpectrogramParams(sg.StftParams(2048, 512), sr),
                      sg.MelParams(64, 0.0, 4000.0, sg.MelNorm.SLANEY, multirate=True),
                      sg.LogParams(-80.0), dtype="float64")
    with pytest.warns(UserWarning, match="full rate"):
        jfn = jpar.sequence_parallel_spectrogram(jp, jpar.create_device_mesh((4,), ("time",)),
                                                 "time")
    np.testing.assert_allclose(fn(x).numpy(), np.asarray(jfn(x)), rtol=0, atol=1e-9)


def test_batch_stacking():
    p, jp = plan(tg, "float64"), plan(sg, "float64")
    xs = [noise(4000, seed=i) for i in range(3)]
    specs = [p.compute(x) for x in xs]
    arr = batch(specs, **CPU)
    assert arr.shape == (3, 32, specs[0].n_frames)
    want = np.asarray(jpar.batch([jp.compute(x) for x in xs]))
    np.testing.assert_allclose(arr.numpy(), want, rtol=1e-9, atol=1e-9)
    arr2, meta = batch_with_metadata(specs, **CPU)
    assert len(meta) == 3 and meta[0]["params"] is p.params
    assert meta[0]["db_range"] == specs[0].db_range()
    assert torch.equal(arr2, arr)
    assert batch(specs, dtype="float32", **CPU).dtype == torch.float32
    specs.append(p.compute(noise(8000, seed=9)))
    with pytest.raises(tg.InvalidInputError, match="pad=True"):
        batch(specs, **CPU)
    padded = batch(specs, pad=True, **CPU)
    assert padded.shape[2] == max(s.n_frames for s in specs)
    jpad = np.asarray(jpar.batch([jp.compute(x) for x in xs + [noise(8000, seed=9)]], pad=True))
    np.testing.assert_allclose(padded.numpy(), jpad, rtol=1e-9, atol=1e-9)
    with pytest.raises(tg.InvalidInputError, match="empty"):
        batch([], **CPU)


def test_pad_signals():
    sigs = [np.ones(100), np.ones(250), np.ones(97)]
    arr, lengths = pad_signals(sigs, bucket_multiple=64)
    assert arr.shape == (3, 256)
    assert list(lengths) == [100, 250, 97]
    assert arr[0, 100:].sum() == 0.0
    jarr, jlen = jpar.pad_signals(sigs, bucket_multiple=64)
    np.testing.assert_array_equal(arr, jarr)
    np.testing.assert_array_equal(lengths, jlen)
    t_arr, _ = pad_signals([torch.ones(100), torch.ones(3)])
    assert t_arr.shape == (2, 100)
    with pytest.raises(tg.InvalidInputError):
        pad_signals([])


def test_audio_seconds_per_second_and_initialize_distributed():
    m = mesh(8)
    for args in ((32, 10.0, 0.5), (32, 10.0, 0.5, m)):
        jargs = args[:3] + ((jpar.create_device_mesh((8,), ("data",)),) if len(args) == 4
                            else ())
        assert audio_seconds_per_second(*args) == jpar.audio_seconds_per_second(*jargs)
    initialize_distributed()              # one process: a no-op, as in JAX
    initialize_distributed("localhost:1", 1, 0)
    assert not dist.is_initialized()
    with pytest.raises(tg.InvalidInputError, match="coordinator_address"):
        initialize_distributed(None, 2, 0)


# ---- the communication contract (tests/test_collectives.py) --------------------------

def _collective_plan(m):
    kw = CPU if m is tg else {}
    params = m.SpectrogramParams(m.StftParams(512, 128), 16000.0)
    mel = m.MelParams(40, 0.0, 8000.0, m.MelNorm.SLANEY)
    return m.MelDbPlan(params, mel, m.LogParams(-80.0), dtype="float32", **kw)


def test_data_parallel_pipeline_has_zero_collectives(collectives):
    m = mesh(8)
    p = _collective_plan(tg)
    fn = data_parallel_pipeline(p._forward_impl, m)
    x = np.random.default_rng(1).standard_normal((16, 8000)).astype(np.float32)
    out = fn(shard_batch(x, m))
    assert collectives == [], "the data-parallel path must not communicate"
    np.testing.assert_allclose(np.asarray(out), p.compute_batch(x).numpy(), rtol=0, atol=1e-4)


def test_sequence_parallel_uses_only_halo_and_gather(collectives):
    m = mesh(4, "time")
    seq = sequence_parallel_spectrogram(_collective_plan(tg), m, axis="time")
    h0, g0 = sequence_parallel_spectrogram.halo_copies, sequence_parallel_spectrogram.gathers
    seq(np.zeros(16000, np.float32))
    assert collectives == []
    # the halo exchange: one copy from each right neighbour; one terminal gather
    assert sequence_parallel_spectrogram.halo_copies - h0 == 3
    assert sequence_parallel_spectrogram.gathers - g0 == 1


def test_multirate_chroma_dp_has_zero_collectives(collectives):
    m = mesh(8)
    p = tg.ChromaPlan(tg.StftParams(4096, 1024), 44100.0,
                      tg.ChromaParams.music_standard().with_multirate(), dtype="float32", **CPU)
    assert p._decimation == 2
    fn = data_parallel_pipeline(p._forward, m)
    x = np.random.default_rng(2).standard_normal((16, 44100)).astype(np.float32)
    out = fn(shard_batch(x, m))
    assert collectives == [], "multirate chroma DP must not communicate"
    np.testing.assert_allclose(np.asarray(out), p.compute_batch(x).numpy(), rtol=0, atol=1e-6)


def test_plan_replica_is_the_plan_on_its_own_device():
    p = _collective_plan(tg)
    assert plan_replica(p, "cpu") is p
    fs = tg.FeatureSet([p, lambda b: b])
    assert plan_replica(fs, "cpu") is fs
