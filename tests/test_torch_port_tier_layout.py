"""The tier kernel's host layout and its plain twin (``ops/tier_layout.py``).

The tier kernel (``csrc/fused_tier_features.cu``) runs only on a GPU. Here,
on the CPU, the tables it reads are checked against what they stand for
(the outer n-tiles a mapping reads, the compact power tile, the nonzero
k-steps of the filterbank and their packed fragments, the outer DFT's work
items, the block's shared memory), and ``tier_twin``, the kernel's
decomposition step by step in f32, is held against the tier's plain version
``fused_tier_features_reference`` and against the JAX package's Pallas
kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spectrograms_tpu as sg
from spectrograms_tpu.mfcc import _dct_lifter_matrix
from spectrograms_tpu.ops import pallas_factored as jpf
from spectrograms_tpu.ops.filterbanks import (chroma_filterbank, erb_filterbank,
                                              mel_filterbank)
from spectrograms_tpu_torch.ops import _build
from spectrograms_tpu_torch.ops import factored_layout as fl
from spectrograms_tpu_torch.ops import fused_factored as tff
from spectrograms_tpu_torch.ops import tier_layout as tl
from tests.conftest import noise

SR = 16000.0
MAPPINGS = {
    # name: (n_fft, mapping (n_out, n_bins))
    "mel-128 1024": (1024, lambda: mel_filterbank(SR, 1024, sg.MelParams(128, 0.0, 8000.0,
                                                                          sg.MelNorm.SLANEY))),
    "mel-40 512": (512, lambda: mel_filterbank(SR, 512, sg.MelParams(40, 0.0, 8000.0,
                                                                      sg.MelNorm.SLANEY))),
    "identity 256": (256, lambda: np.eye(129)),
    "identity 4096": (4096, lambda: np.eye(2049)),
    "ERB-128 1024": (1024, lambda: erb_filterbank(SR, 1024, sg.ErbParams(128, 50.0, 8000.0))[0]),
    "chroma 4096 44.1 kHz": (4096, lambda: chroma_filterbank(44100.0, 4096, sg.ChromaParams())),
    "chroma 4096 22.05 kHz": (4096, lambda: chroma_filterbank(22050.0, 4096, sg.ChromaParams())),
}


# ---- the inner FFT --------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 4, 8, 16, 32])
def test_inner_fft_is_real_fft_classes_bit_for_bit(r):
    """The kernel's template recursion, twiddles from its f32 table, gives
    the plain version's inner DFT bit for bit, zeros where it has None."""
    xs = [torch.from_numpy(noise(3 * 128, seed=40 + q, dtype=np.float32).reshape(3, 128))
          for q in range(r)]
    for (a_re, a_im), (b_re, b_im) in zip(tl.inner_fft_classes(xs), fl.real_fft_classes(xs)):
        assert torch.equal(a_re, b_re)
        assert (a_im is None) == (b_im is None)
        if a_im is not None:
            assert torch.equal(a_im, b_im)


def test_twiddle_table_is_every_levels_rounding():
    """W_s^c rounded to f32 from np.cos(2πc/s) is the table's entry c·32/s,
    and the table is symmetric as the kernel's literals assume."""
    cos, sin = tl.dft_twiddles()
    for s in (2, 4, 8, 16, 32):
        for c in range(s // 2 + 1):
            assert np.float32(np.cos(2.0 * np.pi * c / s)) == cos[c * 32 // s]
            assert np.float32(np.sin(2.0 * np.pi * c / s)) == sin[c * 32 // s]
    assert all(cos[k] == -cos[16 - k] and sin[k] == sin[16 - k] for k in range(9, 16))
    assert all(sin[k] == cos[8 - k] for k in range(1, 8))
    text = (_build._CSRC / "fused_tier_features.cu").read_text()
    for k in range(1, 8):
        assert f"k == {k} ? {float(cos[k]).hex().replace('0000000p', 'p')}f" in text


# ---- what the mapping reads ------------------------------------------------------

@pytest.mark.parametrize("name", list(MAPPINGS))
def test_ntiles_are_the_columns_the_folded_mapping_reads(name):
    n_fft, make = MAPPINGS[name]
    fb = make()
    r = n_fft // 128
    fold = fl.fold_mapping(fb, n_fft)
    read = np.any(fold != 0.0, axis=1).reshape(r // 2 + 1, 128)
    ntiles = tl.class_ntiles(fb, n_fft)
    assert len(ntiles) == r // 2 + 1
    for c, js in enumerate(ntiles):
        covered = np.zeros(128, bool)
        for j in js:
            covered[8 * j:8 * j + 8] = True
        assert not (read[c] & ~covered).any()          # every read column is kept
        for j in js:
            assert read[c, 8 * j:8 * j + 8].any()       # every kept n-tile is read


def test_chroma_reads_four_ntiles_of_a_complex_class():
    """Chroma at 44.1 kHz: the complex classes read the 25 k1 of
    ``needed_complex_k1`` (0..12, 115..127), 4 of 16 n-tiles; the real
    classes 2; the flagship's mel-128 its real classes 8 each."""
    fb = chroma_filterbank(44100.0, 4096, sg.ChromaParams())
    ks = fl.needed_complex_k1(fb, 32)
    assert len(ks) == 25 and ks == jpf._needed_complex_k1(fb, 32)
    ntiles = tl.class_ntiles(fb, 4096)
    assert sorted({k // 8 for k in ks}) == [0, 1, 14, 15]
    assert all(set(ntiles[c]) <= {0, 1, 14, 15} for c in range(1, 16))
    assert set().union(*(ntiles[c] for c in range(1, 16))) == {0, 1, 14, 15}
    assert len(ntiles[0]) == len(ntiles[16]) == 2
    mel = MAPPINGS["mel-128 1024"][1]()
    assert [len(j) for j in tl.class_ntiles(mel, 1024)] == [8, 16, 16, 16, 8]


@pytest.mark.parametrize("name", list(MAPPINGS))
def test_compact_mapping_reads_the_same_power(name):
    """The compact power tile times the compact mapping is the (c, k1)
    layout times the folded mapping: the dropped columns weigh nothing."""
    n_fft, make = MAPPINGS[name]
    fb = make()
    ntiles = tl.class_ntiles(fb, n_fft)
    slots, kc = tl.power_slots(ntiles)
    assert kc % 16 == 0 and kc >= 8 * int((slots >= 0).sum())
    assert sorted(slots[slots >= 0].tolist()) == list(range(int((slots >= 0).sum())))
    layout = np.random.default_rng(41).exponential(size=(5, (n_fft // 256 + 1) * 128))
    compact = np.zeros((5, kc))
    for c, js in enumerate(ntiles):
        for j in js:
            compact[:, 8 * slots[c, j]:8 * slots[c, j] + 8] = layout[:, c * 128 + 8 * j:c * 128 + 8 * j + 8]
    want = layout @ fl.fold_mapping(fb, n_fft)
    np.testing.assert_allclose(compact @ tl.compact_mapping(fb, n_fft, ntiles), want,
                               rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("name", list(MAPPINGS))
def test_packed_ksteps_rebuild_the_mapping_exactly(name):
    """The packed fragments of the nonzero k-steps, put back in place,
    rebuild the bf16 compact mapping bit for bit; every k-step left out is
    zero."""
    n_fft, make = MAPPINGS[name]
    fb = make()
    ntiles = tl.class_ntiles(fb, n_fft)
    _, kc = tl.power_slots(ntiles)
    cols = -(-fb.shape[0] // 8) * 8
    m = np.zeros((kc, cols))
    m[:, :fb.shape[0]] = tl.compact_mapping(fb, n_fft, ntiles)
    for part in fl.split_bf16(m):
        first, ks = tl.sparse_ksteps(m)
        frag = tl.packed_fragments(part, first, ks)
        dense = fl.mma_b_fragments(part)
        rebuilt = np.zeros_like(dense)
        nt = np.repeat(np.arange(cols // 8), np.diff(first))
        rebuilt[ks, nt] = frag[:len(ks)]
        np.testing.assert_array_equal(rebuilt, dense)
    nz = (m != 0).reshape(kc // 16, 16, cols // 8, 8).any(axis=(1, 3))
    assert len(ks) == int(nz.sum())


def test_flagship_filterbank_skips_as_counted():
    """Mel-128 at 1024: 149 of the compact tile's 32 x 16 = 512 (k-step,
    n-tile) pairs hold a nonzero (149 of 640 in the dense folded layout);
    chroma at 44.1 kHz 64 of 64 (of 272 dense)."""
    for name, want, dense in (("mel-128 1024", 149, 640), ("chroma 4096 44.1 kHz", 64, 272)):
        n_fft, make = MAPPINGS[name]
        fb = make()
        ntiles = tl.class_ntiles(fb, n_fft)
        _, kc = tl.power_slots(ntiles)
        m = np.zeros((kc, -(-fb.shape[0] // 8) * 8))
        m[:, :fb.shape[0]] = tl.compact_mapping(fb, n_fft, ntiles)
        assert len(tl.sparse_ksteps(m)[1]) == want
        fold = np.zeros(((n_fft // 256 + 1) * 128, m.shape[1]))
        fold[:, :fb.shape[0]] = fl.fold_mapping(fb, n_fft)
        assert fold.shape[0] // 16 * (fold.shape[1] // 8) == dense


# ---- the outer DFT's work items --------------------------------------------------

@pytest.mark.parametrize("tile_f", tl.TILES)
@pytest.mark.parametrize("name", list(MAPPINGS))
def test_outer_items_cover_every_read_ntile_once(name, tile_f):
    """Every (class, n-tile) that the mapping reads is computed, each row
    tile of it by one item only, and no item runs a row tile that reads
    nothing."""
    n_fft, make = MAPPINGS[name]
    fb = make()
    r = n_fft // 128
    ntiles = tl.class_ntiles(fb, n_fft)
    groups = tuple((c, min(c + 3, r // 2)) for c in range(1, r // 2, 3)) or ((1, 1),)
    items, first = tl.outer_items(ntiles, groups, tile_f, warps=16)
    assert first[0] == 0 and first[-1] == len(items) and np.all(np.diff(first) >= 0)
    done = set()
    for g, (c0, c1) in enumerate(groups):
        runs = {}                                       # j -> row tiles run
        for kind_j, mask, _, _ in items[first[g]:first[g + 1]]:
            kind, j = kind_j & 3, kind_j >> 2
            mask = int(np.uint32(mask))
            assert mask and bin(mask).count("1") <= 4
            if kind < 2:
                assert g == 0 and mask == (1 << (max(tile_f, 16) // 16)) - 1
                c = 0 if kind == 0 else r // 2
                assert (c, j) not in done and j in ntiles[c]
                done.add((c, j))
                continue
            assert not runs.get(j, 0) & mask                 # a row tile once
            runs[j] = runs.get(j, 0) | mask
        for j, run in runs.items():
            for u in range(32):
                rows = range(16 * u, 16 * u + 16)             # the tile's classes
                classes = {c0 + row // tile_f for row in rows} & set(range(c0, c1))
                if run >> u & 1:                             # it reads something
                    assert any(j in ntiles[c] for c in classes)
            for c in range(c0, c1):
                rows = range((c - c0) * tile_f, (c - c0 + 1) * tile_f)
                if j in ntiles[c]:
                    assert all(run >> (row // 16) & 1 for row in rows)
                    done.add((c, j))
    assert done == {(c, j) for c, js in enumerate(ntiles) for j in js}


def test_outer_items_split_for_the_warps():
    """Chroma at 8 frames (16 warps): the 4 n-tiles of the complex classes
    are split to one row tile an item, so that every warp has two; the
    flagship keeps one item per n-tile (3 row tiles each)."""
    chroma = tl.class_ntiles(MAPPINGS["chroma 4096 44.1 kHz"][1](), 4096)
    items, _ = tl.outer_items(chroma, ((1, 16),), 8, warps=16)
    assert len(items) == 4 + 4 * 8
    mel = tl.class_ntiles(MAPPINGS["mel-128 1024"][1](), 1024)
    items, _ = tl.outer_items(mel, ((1, 4),), 16, warps=8)
    assert len(items) == 16 + 16 and set(items[items[:, 0] & 3 == 2, 1]) == {0b111}


# ---- the block -----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MAPPINGS))
def test_default_layouts_fit(name):
    n_fft, make = MAPPINGS[name]
    fb = make()
    _, kc = tl.power_slots(tl.class_ntiles(fb, n_fft))
    for gauss in (True, False):
        for x2 in (False, True):
            for hop in (n_fft // 4, n_fft):
                lay = tl.tier_layout(n_fft, hop, gauss, x2, kc, 0)
                assert lay.smem <= tl.MAX_SMEM and lay.tile_f in tl.TILES
    # chroma at 1 pass Gauss takes 8 frames, so that its 15 complex classes
    # fit in one group (16 frames would take two, each running the FFT)
    if name == "chroma 4096 44.1 kHz":
        lay = tl.tier_layout(4096, 1024, True, False, kc, 0)
        assert (lay.tile_f, len(lay.groups), lay.staged) == (8, 1, True)
        assert len(tl.tier_layout(4096, 1024, True, False, kc, 0, tile_f=16).groups) == 2


# ---- the twin against the plain version and the JAX kernel ---------------------

GEOMETRIES = {
    # name: (n_fft, hop, sr, mapping, amp, pre_amp, dct, centre, n, kind)
    "flagship MFCC-40": (1024, 256, SR, MAPPINGS["mel-128 1024"][1], "decibels", "none",
                         lambda: _dct_lifter_matrix(128, 40, 22), True, 8000, "mfcc"),
    "mel-40 dB 512/160": (512, 160, SR, MAPPINGS["mel-40 512"][1], "decibels", "none", None,
                          True, 8001, "db"),
    "identity power 512/128": (512, 128, SR, lambda: np.eye(257), "power", "none", None, False,
                               6000, "power"),
    "ERB-128 power": (1024, 256, SR, MAPPINGS["ERB-128 1024"][1], "power", "none", None, True,
                      8000, "power"),
    "chroma 4096/1024": (4096, 1024, 22050.0, MAPPINGS["chroma 4096 22.05 kHz"][1], "power",
                         "magnitude", None, True, 11025, "chroma"),
}
TIERS = {"bf16 Gauss": ("bf16", True), "bf16 packed": ("bf16", False),
         "bf16x2": ("bf16x2", False)}
# chip_smoke.py's limits of the kernel against its plain version (TWIN_DB,
# TWIN_RTOL/TWIN_ATOL, TWIN_MFCC), unchanged
TWIN_DB, TWIN_RTOL, TWIN_ATOL, TWIN_MFCC = 0.5, 2e-3, 1e-5, 1e-2


def _twin_and_reference(geometry, tier, x):
    n_fft, hop, sr, make_fb, amp, pre_amp, make_dct, centre, n, kind = GEOMETRIES[geometry]
    precision, gauss = TIERS[tier]
    fb, dct = make_fb(), None if make_dct is None else make_dct()
    win = np.asarray(sg.make_window("hann", n_fft), np.float64)
    twin = tl.tier_twin(x, n_fft, hop, win, fb, dct, amp, -80.0, pre_amp, centre, precision,
                        gauss, address=3)
    consts = tff.tier_constants(n_fft, win, fb, dct, precision, gauss, "cpu")
    ref = tff.fused_tier_features_reference(torch.from_numpy(x), consts, amp, -80.0, pre_amp,
                                            centre, hop)
    return twin, ref


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_twin_matches_the_plain_version(geometry, tier):
    """Where the twin's order is the plain version's (the inner DFT, the
    twiddle, every bf16 rounding of A), it is bit-equal; its outer and
    filterbank sums run over what the mapping reads only, so the outputs
    are held to chip_smoke.py's unchanged TWIN_* limits (and are mostly
    bit-equal too)."""
    kind = GEOMETRIES[geometry][-1]
    x = np.stack([noise(GEOMETRIES[geometry][8], seed=s, dtype=np.float32) for s in (42, 43)])
    twin, ref = _twin_and_reference(geometry, tier, x)
    assert twin.shape == ref.shape and bool(torch.isfinite(twin).all())
    d = (twin - ref).abs()
    if kind == "db":
        assert float(d.max()) <= TWIN_DB
    elif kind == "mfcc":
        assert float((d.amax(dim=(0, 2)) / ref.abs().amax(dim=(0, 2))).max()) <= TWIN_MFCC
    else:
        assert bool((d <= TWIN_RTOL * ref.abs() + TWIN_ATOL * ref.abs().max()).all())


def test_twin_a_operands_are_the_plain_versions():
    """The bf16 A operands (the only place the kernel rounds its own f32
    values) are bit-equal to the plain version's: frames staged per tile at
    every 16-byte shift, the inner FFT, the twiddle."""
    n_fft, hop = 1024, 160
    x = torch.from_numpy(noise(4001, seed=44, dtype=np.float32))
    win = torch.from_numpy(np.asarray(sg.make_window("hann", n_fft), np.float32))
    from spectrograms_tpu_torch.ops.f32_layout import stage_span
    from spectrograms_tpu_torch.ops.framing import frame_signal
    frames = frame_signal(x, n_fft, hop, True) * win
    for address in range(4):
        staged = torch.stack([stage_span(x, f * hop - 512, n_fft, address)[1][
            (address + f * hop - 512) % 4:][:n_fft] for f in range(frames.shape[0])]) * win
        assert torch.equal(staged, frames)
    chunks = [frames[..., 128 * q:128 * (q + 1)] for q in range(8)]
    tw = torch.from_numpy(fl.class_twiddles(n_fft))
    for (a_re, a_im), (b_re, b_im) in zip(tl.inner_fft_classes(chunks)[1:4],
                                          fl.real_fft_classes(chunks)[1:4]):
        assert torch.equal(a_re * tw[1, :128] - a_im * tw[1, 128:],
                           b_re * tw[1, :128] - b_im * tw[1, 128:])


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_twin_matches_the_jax_kernel(geometry, tier):
    """The twin against the JAX kernel in interpret mode, at
    tests/test_pallas.py's tolerances for each output."""
    n_fft, hop, sr, make_fb, amp, pre_amp, make_dct, centre, n, kind = GEOMETRIES[geometry]
    precision, gauss = TIERS[tier]
    fb, dct = make_fb(), None if make_dct is None else make_dct()
    win = np.asarray(sg.make_window("hann", n_fft), np.float64)
    x = noise(n, seed=45, dtype=np.float32)
    ref = np.asarray(jpf.fused_factored_features(
        n_fft, hop, tuple(win.tolist()), jpf.KernelConst(fb), amp=amp, centre=centre,
        dct_key=None if dct is None else jpf.KernelConst(dct), pre_amp=pre_amp,
        precision=precision, gauss=gauss, interpret=True)(jnp.asarray(x)))
    out = tl.tier_twin(x[None], n_fft, hop, win, fb, dct, amp, -80.0, pre_amp, centre,
                       precision, gauss)[0].numpy()
    assert out.shape == ref.shape
    peak = np.abs(ref).max()
    if kind == "mfcc":
        np.testing.assert_allclose(out, ref, rtol=0, atol=5e-3 * peak)
    elif kind == "db":
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2)
    elif kind == "power":
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3 * peak)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * peak)
