"""The port's host runtime against the JAX package's, on the CPU.

- WAV files written by either package read the same in the other (PCM16
  and float32), natively and through the stdlib fallback;
- ``resample``: the native kernel and the numpy kernel equal the JAX
  package's (the same source and the same numpy code: exactly);
- μ-law: the LUTs equal JAX's, and ``ulaw_decode_torch`` is exactly the
  host LUT decode for every byte;
- ``AudioBatchLoader``: native and numpy paths, float32/int16/ulaw rows,
  ``from_arrays`` under each rate policy and ``iter_borrowed(hold=2)`` give
  batches, lengths and rates identical to JAX's loader;
- two processes building the native library at once;
- none of the new modules imports JAX or the JAX package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
import spectrograms_tpu_torch as tg
from spectrograms_tpu.runtime import loader as jloader
from spectrograms_tpu.runtime import resample as jresample
from spectrograms_tpu.runtime import ulaw as julaw
from spectrograms_tpu.runtime import wav as jwav
from spectrograms_tpu_torch.runtime import loader as tloader
from spectrograms_tpu_torch.runtime import native as tnative
from spectrograms_tpu_torch.runtime import resample as tresample
from spectrograms_tpu_torch.runtime import ulaw as tulaw
from spectrograms_tpu_torch.runtime import wav as twav

REPO = Path(__file__).resolve().parents[1]
SR = 16000
NEW_MODULES = [
    "spectrograms_tpu_torch/runtime/__init__.py",
    "spectrograms_tpu_torch/runtime/native.py",
    "spectrograms_tpu_torch/runtime/wav.py",
    "spectrograms_tpu_torch/runtime/resample.py",
    "spectrograms_tpu_torch/runtime/ulaw.py",
    "spectrograms_tpu_torch/runtime/loader.py",
    "spectrograms_tpu_torch/runtime/streaming.py",
    "spectrograms_tpu_torch/ops/decimate.py",
    "spectrograms_tpu_torch/featureset.py",
    "spectrograms_tpu_torch/serving.py",
]


@pytest.fixture
def clips(tmp_path):
    """Six PCM16 clips of 0.3·N(0,1) at 16 kHz, of several lengths."""
    rng = np.random.default_rng(0)
    paths, lengths = [], [SR, SR // 2, SR * 2, SR, 3 * SR // 4, SR + 123]
    for i, n in enumerate(lengths):
        p = tmp_path / f"c{i}.wav"
        twav.write_wav(p, (0.3 * rng.standard_normal(n)).astype(np.float32), SR, bits=16)
        paths.append(p)
    return paths, lengths


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wav_files_read_the_same_in_both_packages(tmp_path, writer, bits):
    x = (0.5 * np.random.default_rng(bits).standard_normal((1000, 2))).astype(np.float32)
    p = tmp_path / "x.wav"
    (twav if writer == "port" else jwav).write_wav(p, x, 22050, bits=bits)
    for mono in (False, True):
        a, sr_a = twav.read_wav(p, mono=mono)
        b, sr_b = jwav.read_wav(p, mono=mono)
        assert sr_a == sr_b == 22050
        np.testing.assert_array_equal(a, b)
    if bits == 16:  # the stdlib fallbacks read PCM16 alike
        np.testing.assert_array_equal(twav._read_wav_py(str(p), True)[0],
                                      jwav._read_wav_py(str(p), True)[0])


def test_wav_fallback_writer_matches_jax(tmp_path):
    x = np.linspace(-1.0, 1.0, 257, dtype=np.float32)
    twav._write_wav_py(str(tmp_path / "a.wav"), x[:, None], 8000, 16)
    jwav._write_wav_py(str(tmp_path / "b.wav"), x[:, None], 8000, 16)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    with pytest.raises(ValueError):
        twav._write_wav_py(str(tmp_path / "c.wav"), x[:, None], 8000, 32)


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 16000), (16000, 22050), (8000, 16000),
                                          (44100, 48000)])
def test_resample_matches_jax(sr_in, sr_out):
    x = np.random.default_rng(sr_in + sr_out).standard_normal(3001).astype(np.float32)
    # default design: the native kernel on both sides
    np.testing.assert_array_equal(tresample.resample(x, sr_in, sr_out),
                                  jresample.resample(x, sr_in, sr_out))
    # another design: the numpy kernel on both sides
    a = tresample.resample(x, sr_in, sr_out, half_width=16)
    b = jresample.resample(x, sr_in, sr_out, half_width=16)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(tresample.resample(x64, sr_in, sr_out),
                               jresample.resample(x64, sr_in, sr_out), rtol=0, atol=1e-12)


def test_resample_validation_matches_jax():
    x = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(tresample.resample(x, 8000, 8000), x)
    for bad in ((x, 0, 8000), (np.zeros((2, 2)), 8000, 16000)):
        with pytest.raises(tg.InvalidInputError):
            tresample.resample(*bad)
        with pytest.raises(sg.InvalidInputError):
            jresample.resample(*bad)


def test_ulaw_luts_and_torch_decode_are_exact():
    np.testing.assert_array_equal(tulaw._encode_lut(), julaw._encode_lut())
    np.testing.assert_array_equal(tulaw._decode_lut(), julaw._decode_lut())
    codes = np.arange(256, dtype=np.uint8)
    host = julaw.ulaw_decode_i16(codes)
    for dt in (torch.float32, torch.float64):
        dev = tulaw.ulaw_decode_torch(torch.from_numpy(codes), dt)
        assert dev.dtype == dt
        # exactly the LUT's integers over 32768
        np.testing.assert_array_equal(dev.numpy() * 32768.0, host.astype(np.float64))
    s = np.random.default_rng(1).integers(-32768, 32767, 5000).astype(np.int16)
    f = np.random.default_rng(2).uniform(-1.0, 1.0, 5000)
    for v in (s, f):
        np.testing.assert_array_equal(tulaw.ulaw_encode(v), julaw.ulaw_encode(v))
    assert tulaw.ulaw_encode(np.zeros(4, np.int16)).tolist() == [0] * 4


def _batches(loader, borrowed_hold=None):
    it = (loader.iter_with_rates() if borrowed_hold is None
          else loader.iter_borrowed(hold=borrowed_hold))
    return [(np.array(d), np.array(n), np.array(r)) for d, n, r in it]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (dg, ng, rg), (dw, nw, rw) in zip(got, want):
        assert dg.dtype == dw.dtype
        np.testing.assert_array_equal(dg, dw)
        np.testing.assert_array_equal(ng, nw)
        np.testing.assert_array_equal(rg, rw)


@pytest.mark.parametrize("dtype", ["float32", "int16", "ulaw"])
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_loader_batches_match_jax(clips, path, dtype):
    paths, _ = clips
    kw = dict(batch_size=4, target_len=SR, expected_sample_rate=SR, dtype=dtype, n_threads=2)
    t, j = tloader.AudioBatchLoader(paths, **kw), jloader.AudioBatchLoader(paths, **kw)
    assert t._lib is not None and j._lib is not None
    if path == "numpy":
        t._lib = j._lib = None
    _assert_same_batches(_batches(t), _batches(j))


@pytest.mark.parametrize("dtype", ["float32", "int16", "ulaw"])
def test_iter_borrowed_hold_two_matches_jax(clips, dtype):
    paths, _ = clips
    kw = dict(batch_size=2, target_len=SR, expected_sample_rate=SR, prefetch_batches=4,
              dtype=dtype)
    got = _batches(tloader.AudioBatchLoader(paths, **kw), borrowed_hold=2)
    _assert_same_batches(got, _batches(jloader.AudioBatchLoader(paths, **kw), borrowed_hold=2))
    _assert_same_batches(got, _batches(tloader.AudioBatchLoader(paths, **kw), borrowed_hold=1))
    assert len(got) == 3


def test_iter_borrowed_validation(clips):
    paths, _ = clips
    loader = tloader.AudioBatchLoader(paths, batch_size=2, target_len=SR, prefetch_batches=2)
    with pytest.raises(tg.InvalidInputError):
        next(loader.iter_borrowed(hold=2))  # hold must be < prefetch
    with pytest.raises(tg.InvalidInputError):
        next(loader.iter_borrowed(hold=0))
    one_slot = tloader.AudioBatchLoader(paths, batch_size=2, target_len=SR, prefetch_batches=1)
    assert len(list(one_slot.iter_borrowed())) == 3


@pytest.mark.parametrize("policy", ["error", "resample", "ignore"])
@pytest.mark.parametrize("dtype", ["float32", "int16", "ulaw"])
def test_from_arrays_rate_policies_match_jax(policy, dtype):
    rng = np.random.default_rng(3)
    arrays = [(0.3 * rng.standard_normal(SR)).astype(np.float32),
              (0.3 * rng.standard_normal(2 * SR)).astype(np.float32),
              np.clip(rng.normal(0, 4000, SR // 2), -32768, 32767).astype(np.int16)]
    kw = dict(batch_size=2, target_len=SR, sample_rates=[SR, 2 * SR, SR],
              expected_sample_rate=SR, on_rate_mismatch=policy, dtype=dtype)
    t = tloader.AudioBatchLoader.from_arrays(arrays, **kw)
    j = jloader.AudioBatchLoader.from_arrays(arrays, **kw)
    if policy == "error":
        with pytest.raises(tg.InvalidInputError, match=r"arrays\[1\]"):
            _batches(t)
        with pytest.raises(sg.InvalidInputError, match=r"arrays\[1\]"):
            _batches(j)
        return
    got = _batches(t)
    _assert_same_batches(got, _batches(j))
    if policy == "resample":
        assert got[0][1][1] == SR  # 2 s at 2·SR: a full 1 s window at SR


def test_loader_validation_matches_jax(tmp_path):
    for m, mod in ((tg, tloader), (sg, jloader)):
        with pytest.raises(m.InvalidInputError, match="non-empty"):
            mod.AudioBatchLoader.from_arrays([], batch_size=2, target_len=SR)
        with pytest.raises(m.InvalidInputError, match="sample_rates"):
            mod.AudioBatchLoader.from_arrays([np.ones(8), np.ones(8)], batch_size=2,
                                             target_len=SR, sample_rates=[16000])
        with pytest.raises(m.InvalidInputError):
            mod.AudioBatchLoader([tmp_path / "a.wav"], batch_size=2, target_len=SR, dtype="int8")
        with pytest.raises(m.InvalidInputError):
            mod.AudioBatchLoader([tmp_path / "a.wav"], batch_size=0, target_len=SR)


def test_loader_corrupt_file_raises_after_the_good_batch(clips, tmp_path):
    paths, _ = clips
    bad = tmp_path / "corrupt.wav"
    bad.write_bytes(b"RIFFgarbage-not-a-wav-file")
    seen = 0
    with pytest.raises(IOError):
        for data, lens in tloader.AudioBatchLoader([paths[0], bad], batch_size=1,
                                                   target_len=SR, n_threads=1):
            seen += int(lens[0] > 0)
    assert seen >= 1


_BUILD = """
import sys
from pathlib import Path
from spectrograms_tpu_torch.runtime import native
so = native.build_library(build_dir=Path(sys.argv[1]))
lib = native._bind(__import__("ctypes").CDLL(str(so)))
print(so.name, lib.sg_framer_new(512, 128, 4096) != 0)
"""


def test_two_processes_build_the_native_library_at_once(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.split()[0] for out, _ in outs}
    assert len(names) == 1 and all(out.split()[1] == "True" for out, _ in outs)
    built = sorted(f.name for f in tmp_path.iterdir())
    assert built == sorted([names.pop(), "libsgtpu.lock"])  # no temporary file left
    assert tnative.library_path(tmp_path).exists()


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_imports_neither_jax_nor_the_jax_package(module):
    tree = ast.parse((REPO / module).read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "spectrograms_tpu"), (module, name)


def test_new_modules_load_no_jax():
    mods = ", ".join(m.removesuffix(".py").replace("/", ".").removesuffix(".__init__")
                     for m in NEW_MODULES)
    code = (f"import sys, {mods}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'spectrograms_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
