"""The benchmark's bf16 serving configuration, ``speech_mfcc40_bf16``, on the
CPU at small sizes: the port's 1-pass bf16 tier (its plain version, with the
kernel's roundings) and ``tg.delta`` are correct under the configuration's
limits against its plain reference; the control one precision below bf16,
a bf16-rounded answer and one answer altered by a thousandth are not; the
tier kernel's task count at the flagship; and the reference loads nothing
of the port or of JAX."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "portbench"
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import spectrograms_tpu_torch as tg  # noqa: E402
from harness import inputs, judge, manifest  # noqa: E402

CONFIG = "speech_mfcc40_bf16"
CFG = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "batch_32x10s_16k.json").read_text())
REF_PATH = BENCH / "reference" / f"{CONFIG}.py"
REF = manifest.load_module(REF_PATH, "reference")
SEEDS = (7, 8)


def _tier_system():
    """The configuration's entry with the plan's method set to ``pallas``:
    on a CPU tensor the tier kernel's plain version."""
    system = manifest.load_module(BENCH / "configs" / f"{CONFIG}.py", "config")
    s = system.build(CFG, TRAFFIC, "cpu")
    s.plan = tg.MfccPlan(
        tg.StftParams(CFG["n_fft"], CFG["hop"]), CFG["sr"],
        mel_params=tg.MelParams(CFG["n_mels"], CFG["f_min"], CFG["f_max"],
                                tg.MelNorm.SLANEY),
        mfcc_params=tg.MfccParams(CFG["n_mfcc"], include_c0=CFG["include_c0"],
                                  lifter=CFG["lifter"]),
        log_params=tg.LogParams(CFG["floor_db"]), dtype=CFG["dtype"],
        precision=tg.Precision[CFG["precision"]], method="pallas", device="cpu")
    return s


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def answer(request):
    """(4 × 2 s tones batch of the seed, the tier's answer on it)."""
    small = dict(TRAFFIC, clips=4, clip_s=2, pool=1)
    x = inputs.make_pool(small, request.param, torch.device("cpu"))[0]
    return x, _tier_system()(x)


def _verdict(x, out):
    return judge.verdict(REF.check(CFG, TRAFFIC, x, out), CFG["limits"])


def test_tier_is_correct_under_the_limits(answer):
    x, out = answer
    ok, checks, _ = _verdict(x, out)
    assert ok, checks
    # a bf16-grade MFCC, far from float32's, and a float32-grade delta stage
    assert checks["mfcc_err"]["value"] > 1e-3, checks
    assert checks["delta_self_err"]["value"] < 0.1 * CFG["limits"]["delta_self_err"], checks


def test_control_below_bf16_fails(answer):
    x, _ = answer
    ok, checks, failed = _verdict(x, REF.outputs(CFG, x, tf32=True))
    assert not ok, checks
    assert set(failed) == {"mfcc_err", "delta_err", "delta_self_err"}, checks


def _bf16_rounded(out):
    return {k: v.to(torch.bfloat16).to(v.dtype) for k, v in out.items()}


def _altered(out):
    out = {k: v.clone() for k, v in out.items()}
    out["mfcc"][0, 0, 0] += 1e-3 * out["mfcc"][:, 0].abs().max()
    return out


@pytest.mark.parametrize("fault", [_bf16_rounded, _altered], ids=["bf16_rounded", "altered"])
def test_fault_fails_by_delta_self_err(answer, fault):
    x, out = answer
    ok, checks, failed = _verdict(x, fault(out))
    assert not ok and "delta_self_err" in failed, checks


def test_mantissa_round_to_nearest_even():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -4, 1.0 + 3 * 2.0 ** -4, -3.0 + 2.0 ** -10, 0.0])
    want = torch.tensor([1.0, 1.0, 1.0 + 4 * 2.0 ** -4, -3.0, 0.0])  # ties to even
    assert torch.equal(REF.mantissa_round(x), want)
    # float32's exponent range is kept: nothing flushes to zero or overflows
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    y = torch.cat([y, y * 1e-30, y * 1e30])
    rel = ((REF.mantissa_round(y) - y).abs() / y.abs()).max()
    assert 0 < rel <= 2.0 ** -4


def test_tier_task_at_the_flagship():
    """32 × 10 s at 16 kHz, 20,032 frames. A frame's products: FFT 25,600,
    mel 2·1,009 = 2,018, DCT-II 10,240; elementwise: |X|² 1,539, log 128,
    lifter 40. Bytes as ``f32_task``'s."""
    products, elementwise, nbytes = REF.tier_task(CFG, TRAFFIC)
    assert products == 37_858 * 20_032 == 758_371_456
    assert elementwise == 1_707 * 20_032 == 34_194_624
    assert nbytes == 23_685_120
    f32 = manifest.load_module(BENCH / "reference" / "speech_mfcc40.py", "reference")
    assert f32.f32_task(CFG, TRAFFIC) == (products + elementwise, nbytes)
    # the bytes bound it on the H100: 7.07 µs against 0.77 and 0.51
    assert nbytes / 3.35e12 > max(products / 989.4e12, elementwise / 67e12)


def test_reference_loads_nothing_of_the_port_or_jax():
    code = (f"import sys; sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH)!r}]\n"
            "from harness import manifest\n"
            f"manifest.load_module(manifest.BENCH_DIR / 'reference' / {REF_PATH.name!r}, 'r')\n"
            "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    tops = set(out.stdout.split())
    assert "torch" in tops
    assert not tops & {"spectrograms_tpu_torch", "spectrograms_tpu", "jax", "jaxlib"}, tops
