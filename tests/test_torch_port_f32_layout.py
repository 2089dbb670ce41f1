"""The f32 kernel's decomposition (``csrc/fused_features.cu``), step by step.

The CUDA kernel runs only on a GPU. Here its host layout
(``spectrograms_tpu_torch.ops.f32_layout``: radix plan, twiddle table,
filterbank pieces, signal spans, shared memory) and the plain twin that runs
the kernel's own steps in f32 (span staging, even/odd packing, Stockham
radix passes, the real-FFT split, piece sums) are held against
``torch.fft``, ``fused_features_reference`` and the JAX kernel in interpret
mode, at ``tests/test_pallas.py``'s tolerances for the last (2e-2 dB,
rtol/atol 2e-3·max on power, 5e-3·max on MFCC). Inputs come from numpy
seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu_torch as tg
from spectrograms_tpu.ops import pallas_factored as jpf
from spectrograms_tpu_torch.mfcc import _dct_lifter_matrix
from spectrograms_tpu_torch.ops import f32_layout as fl32
from spectrograms_tpu_torch.ops import fused_factored as tff
from spectrograms_tpu_torch.ops.filterbanks import (chroma_filterbank, erb_filterbank,
                                                    loghz_matrix, mel_filterbank)
from spectrograms_tpu_torch.ops.framing import frame_count, frame_signal

SIZES = [256, 512, 1024, 2048, 4096]
# (n_fft, hop): n_fft 256/1024/4096 under hops 160/256/1024/n_fft, hop <= n_fft
GEOMETRIES = sorted({(n, h) for n in (256, 1024, 4096) for h in (160, 256, 1024, n) if h <= n})


def hann(n_fft):
    return tg.make_window(tg.WindowType.hanning, n_fft)


def mapping(name, n_fft):
    """(n_out, n_bins) f64 mapping and its amp/pre_amp."""
    if name == "mel":
        return mel_filterbank(16000.0, n_fft, tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY)), \
            "decibels", "none"
    if name == "identity":
        return np.eye(n_fft // 2 + 1), "power", "none"
    return chroma_filterbank(22050.0, n_fft, tg.ChromaParams()), "power", "magnitude"


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("n_fft", SIZES)
def test_radix_plan_and_twiddle_table(n_fft):
    m = n_fft // 2
    plan = fl32.radix_plan(m)
    assert int(np.prod(plan)) == m and set(plan[1:]) <= {8} and plan[0] in (2, 4, 8)
    offs, split, total = fl32.twiddle_offsets(m)
    table = fl32.twiddle_table(n_fft)
    assert table.shape == (total, 2)
    # every entry against e^{-2πi k r / (Ns R)}, computed here independently
    ns = plan[0]
    for r in plan[1:]:
        for rr in range(1, r):
            k = np.arange(ns)
            w = table[offs[ns] + (rr - 1) * ns + k]
            want = np.exp(-2j * np.pi * k * rr / (ns * r))
            np.testing.assert_allclose(w[:, 0] + 1j * w[:, 1], want, atol=1e-15)
        ns *= r
    k = np.arange(m // 2 + 1)
    w = table[split:split + m // 2 + 1]
    np.testing.assert_allclose(w[:, 0] + 1j * w[:, 1], np.exp(-2j * np.pi * k / n_fft), atol=1e-15)


@pytest.mark.parametrize("n_fft", SIZES)
def test_radix_passes_match_fft(n_fft):
    """The Stockham passes in f32 against torch.fft.fft, at f32 rounding."""
    m = n_fft // 2
    rng = np.random.default_rng(n_fft)
    z64 = rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))
    z = torch.from_numpy(z64.astype(np.complex64))
    table = torch.tensor(fl32.twiddle_table(n_fft), dtype=torch.float32)
    out = fl32.stockham_fft(z, table)
    assert rel_err(out.to(torch.complex128), torch.fft.fft(torch.from_numpy(z64))) < 1e-6
    assert rel_err(out, torch.fft.fft(z)) < 1e-6


@pytest.mark.parametrize("n_fft", [256, 1024, 4096])
def test_real_split_matches_rfft(n_fft):
    """Packed frame → M-point FFT → split against torch.fft.rfft of the frame."""
    rng = np.random.default_rng(n_fft + 1)
    frames = torch.from_numpy((rng.standard_normal((4, n_fft)) * hann(n_fft)).astype(np.float32))
    table = torch.tensor(fl32.twiddle_table(n_fft), dtype=torch.float32)
    z = torch.complex(frames[:, 0::2], frames[:, 1::2])
    out = fl32.real_split(fl32.stockham_fft(z, table), table, n_fft)
    assert out.shape == (4, n_fft // 2 + 1)
    assert rel_err(out, torch.fft.rfft(frames)) < 1e-6
    assert rel_err(out.to(torch.complex128), torch.fft.rfft(frames.double())) < 1e-6


@pytest.mark.parametrize("fb_name", ["mel", "identity", "chroma", "loghz", "erb", "empty rows"])
def test_band_pieces_cover_each_band(fb_name):
    fb = {
        "mel": lambda: mapping("mel", 1024)[0],
        "identity": lambda: np.eye(513),
        "chroma": lambda: chroma_filterbank(44100.0, 4096, tg.ChromaParams()),
        "loghz": lambda: loghz_matrix(16000.0, 1024, tg.LogHzParams(48, 50.0, 8000.0))[0],
        "erb": lambda: erb_filterbank(16000.0, 1024, tg.ErbParams(32, 50.0, 8000.0))[0],
        "empty rows": lambda: np.vstack([np.zeros((2, 513)), np.eye(513)[100:103]]),
    }[fb_name]()
    items, first, weights = fl32.band_pieces(fb)
    bands = tff.mapping_bands(fb)
    assert items.dtype == first.dtype == np.int32 and len(first) == fb.shape[0] + 1
    assert (items[:, 1] >= 1).all() and (items[:, 1] <= fl32.PIECE).all()
    for m, (lo, hi) in enumerate(bands):
        rows = items[first[m]:first[m + 1]]
        # pieces tile the band in order, their weights packed contiguously
        assert list(rows[:, 0]) == list(range(lo, hi, fl32.PIECE))
        assert rows[:, 1].sum() == hi - lo
        for a, cnt, off, _ in rows:
            np.testing.assert_array_equal(weights[off:off + cnt], fb[m, a:a + cnt])
    p = np.random.default_rng(7).exponential(size=(5, fb.shape[1])).astype(np.float32)
    out = fl32.banded_rows(torch.from_numpy(p), items, first, weights)
    np.testing.assert_allclose(out.numpy(), p.astype(np.float64) @ fb.T, rtol=1e-5,
                               atol=1e-6 * np.abs(p @ fb.T).max())
    if fb_name == "chroma":
        assert len(items) == 588 and len(weights) == 4620   # 12 rows x 385 bins, 44.1 kHz
    if fb_name == "mel":
        assert len(items) == 189 and len(weights) == 1009


@pytest.mark.parametrize("n_fft", [1024, 4096])
def test_dense_mappings_take_longer_pieces(n_fft):
    """ERB rows are dense: their pieces lengthen until a frame's partial sums
    fit in the FFT buffer, which keeps the tile at two frames or more."""
    fb = erb_filterbank(16000.0, n_fft, tg.ErbParams(128, 50.0, 8000.0))[0]
    m = n_fft // 2
    assert len(fl32.band_pieces(fb)[0]) > 2 * (m + m // 16)
    items, first, weights = fl32.kernel_pieces(fb)
    assert len(items) <= 2 * (m + m // 16) and items[:, 1].max() > fl32.PIECE
    assert fl32.tile_frames(n_fft, 256, len(items), 128, True) >= 2
    for name in ("mel", "identity", "chroma"):     # sparse mappings keep PIECE
        fb2 = mapping(name, n_fft)[0]
        assert len(fl32.kernel_pieces(fb2)[0]) == len(fl32.band_pieces(fb2)[0])
    x = np.random.default_rng(13).standard_normal((1, 3 * n_fft)).astype(np.float32)
    win = hann(n_fft)
    twin = fl32.fused_features_twin(x, win, fb, "decibels", -80.0, "none", None, True, n_fft, 256)
    f32 = dict(dtype=torch.float32)
    ref = tff.fused_features_reference(torch.from_numpy(x), torch.tensor(win, **f32),
                                       torch.tensor(fb, **f32), "decibels", -80.0, "none",
                                       None, True, n_fft, 256)
    np.testing.assert_allclose(twin.numpy(), ref.numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
@pytest.mark.parametrize("centre", [True, False])
def test_span_staging_gives_the_frames(n_fft, hop, centre):
    """Each tile's staged span, read at sh + f·hop + t, is frame_signal's frame
    at every 16-byte shift of the row, an odd length and a ragged last tile."""
    n = 3 * n_fft + 7
    row = torch.from_numpy(np.random.default_rng(3).standard_normal(n).astype(np.float32))
    frames = frame_signal(row, n_fft, hop, centre)
    nf = frame_count(n, n_fft, hop, centre)
    pad = n_fft // 2 if centre else 0
    tile = fl32.tile_frames(n_fft, hop, 10, 10, False)
    length = (tile - 1) * hop + n_fft
    for address in range(4):
        for f0 in range(0, nf, tile):
            s0 = f0 * hop - pad
            sh, span = fl32.stage_span(row, s0, length, address)
            assert 0 <= sh < 4 and (address + s0 - sh) % 4 == 0
            assert span.numel() % 4 == 0 and span.numel() <= fl32.span_floats(tile, n_fft, hop)
            for f in range(min(tile, nf - f0)):
                torch.testing.assert_close(span[sh + f * hop: sh + f * hop + n_fft],
                                           frames[f0 + f], rtol=0, atol=0)


@pytest.mark.parametrize("n_fft", SIZES)
@pytest.mark.parametrize("hop", [160, 1024])
def test_smem_layout_regions(n_fft, hop):
    hop = min(hop, n_fft)
    for name in ("mel", "identity", "chroma"):
        fb = mapping(name, n_fft)[0]
        n_items = len(fl32.kernel_pieces(fb)[0])
        for dct in (False, True):
            tile = fl32.tile_frames(n_fft, hop, n_items, fb.shape[0], dct)
            buf_off, smem = fl32.smem_layout(tile, n_fft, hop, n_items, fb.shape[0], dct)
            m = n_fft // 2
            assert buf_off % 4 == 0 and smem <= fl32.MAX_SMEM
            assert buf_off >= max(fl32.span_floats(tile, n_fft, hop), tile * (m + 1),
                                  tile * (fb.shape[0] + 1) if dct else 0)
            assert smem // 4 - buf_off >= max(tile * 2 * (m + m // 16), tile * n_items)
            assert tile * (m // 8) <= fl32.MAX_THREADS


def twin_and_reference(x, n_fft, hop, centre, name, dct=None, **kw):
    fb, amp, pre_amp = mapping(name, n_fft)
    win = hann(n_fft)
    twin = fl32.fused_features_twin(x, win, fb, amp, -80.0, pre_amp, dct, centre, n_fft, hop, **kw)
    f32 = dict(dtype=torch.float32)
    ref = tff.fused_features_reference(
        torch.from_numpy(x), torch.tensor(win, **f32), torch.tensor(fb, **f32), amp, -80.0,
        pre_amp, None if dct is None else torch.tensor(dct, **f32), centre, n_fft, hop)
    return twin, ref, amp


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
@pytest.mark.parametrize("centre", [True, False])
@pytest.mark.parametrize("name", ["mel", "identity", "chroma"])
def test_twin_matches_reference(n_fft, hop, centre, name):
    """The twin against the plain version (frames → rfft → matmuls), both f32:
    they differ in summation order only."""
    x = np.random.default_rng(n_fft + hop).standard_normal((2, 2 * n_fft + 1001)).astype(np.float32)
    twin, ref, amp = twin_and_reference(x, n_fft, hop, centre, name, address=1)
    assert twin.shape == ref.shape
    if amp == "decibels":
        np.testing.assert_allclose(twin.numpy(), ref.numpy(), rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(twin.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(ref.abs().max()))


def test_twin_tiles_and_shifts_agree():
    """A frame's result does not depend on its tile or its span's shift."""
    x = np.random.default_rng(11).standard_normal((2, 5003)).astype(np.float32)
    fb, amp, pre_amp = mapping("mel", 1024)
    run = lambda **kw: fl32.fused_features_twin(x, hann(1024), fb, amp, -80.0, pre_amp, None,
                                                True, 1024, 160, **kw)
    base = run()
    for kw in (dict(tile_f=1), dict(tile_f=3), dict(tile_f=8), dict(address=3)):
        torch.testing.assert_close(run(**kw), base, rtol=0, atol=0)


# (n_fft, hop, centre, mapping): every n_fft, hop and mapping of the sweep
# above, each centre setting, at the JAX interpret-mode kernel's cost.
JAX_CASES = [
    (1024, 256, True, "mel"),
    (1024, 160, False, "mel"),
    (1024, 1024, True, "identity"),
    (256, 160, True, "identity"),
    (256, 256, False, "mel"),
    (256, 256, True, "chroma"),
    (4096, 1024, True, "chroma"),
    (4096, 4096, False, "chroma"),
    (4096, 160, True, "identity"),
    (4096, 256, False, "mel"),
]


@pytest.mark.parametrize("n_fft,hop,centre,name", JAX_CASES)
def test_twin_matches_the_jax_kernel(n_fft, hop, centre, name):
    fb, amp, pre_amp = mapping(name, n_fft)
    x = np.random.default_rng(n_fft * 7 + hop).standard_normal((2, n_fft + 3001)).astype(np.float32)
    jrun = jpf.fused_factored_features(
        n_fft, hop, tuple(hann(n_fft).tolist()),
        "identity" if name == "identity" else jpf.KernelConst(fb), amp=amp, floor_db=-80.0,
        centre=centre, pre_amp=pre_amp, interpret=True)
    ref = np.asarray(jrun(jnp.asarray(x)))
    out = fl32.fused_features_twin(x, hann(n_fft), fb, amp, -80.0, pre_amp, None, centre,
                                   n_fft, hop, address=2).numpy()
    assert out.shape == ref.shape
    if amp == "decibels":
        np.testing.assert_allclose(out, ref, atol=2e-2)
    else:
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("centre", [True, False])
def test_twin_mfcc_matches_reference_and_the_jax_kernel(centre):
    """The flagship: mel-128 dB → DCT-40 (lifter 22, C0 kept)."""
    dct = _dct_lifter_matrix(128, 40, 22)
    x = np.random.default_rng(12).standard_normal((2, 16000)).astype(np.float32)
    twin, ref, _ = twin_and_reference(x, 1024, 256, centre, "mel", dct=dct)
    assert twin.shape == ref.shape
    np.testing.assert_allclose(twin.numpy(), ref.numpy(), atol=1e-4 * float(ref.abs().max()))
    jrun = jpf.fused_factored_features(
        1024, 256, tuple(hann(1024).tolist()), jpf.KernelConst(mapping("mel", 1024)[0]),
        amp="decibels", floor_db=-80.0, centre=centre, dct_key=jpf.KernelConst(dct),
        interpret=True)
    jref = np.asarray(jrun(jnp.asarray(x)))
    np.testing.assert_allclose(twin.numpy(), jref, atol=5e-3 * np.abs(jref).max())
