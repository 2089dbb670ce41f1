"""The benchmark's gammatone configuration, ``cochleagram_gt64``, on the CPU at
small sizes (8 bands, 2 × 0.25 s): the port's entry (one batched
``tg.gammatone_iir_spectrogram``) is correct under the configuration's
limit against its plain reference; the reference's centres equal the
port's; its float32 control, half a batch copied over the other half, one
value moved by a thousandth of its band's largest and the bands reversed
are not correct; the task's count of filtered samples is the port's
counter's; the bank's span; and the reference loads nothing of the port or
of JAX."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "portbench"
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import spectrograms_tpu_torch as tg  # noqa: E402
from harness import inputs, judge, manifest  # noqa: E402
from spectrograms_tpu_torch import erb, profiling  # noqa: E402

CONFIG = "cochleagram_gt64"
CFG = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
TRAFFIC_FILE = BENCH / "traffic" / "batch_32x10s_16k_trace2.json"
TRAFFIC = dict(json.loads(TRAFFIC_FILE.read_text()), clips=2, clip_s=0.25, pool=1)
REF_PATH = BENCH / "reference" / f"{CONFIG}.py"
REF = manifest.load_module(REF_PATH, "reference")
SYSTEM = manifest.load_module(BENCH / "configs" / f"{CONFIG}.py", "config")
SEEDS = (7, 2**33 + 8)


def slaney_f_max(lo: float, hi: float, n: int) -> float:
    """The ``f_max`` at which ``ErbSpacing.APPLE_TR35``'s top centre is ``hi``:
    that spacing puts its n centres at ``-s + (lo + s)^(i/n)·(f_max + s)^(1 - i/n)``,
    i = 1..n, with s = EarQ·minBW."""
    s = 9.26449 * 24.7
    return math.exp((n * math.log(hi + s) - math.log(lo + s)) / (n - 1)) - s


SMALL_CFG = dict(CFG, n_bands=8, f_max=slaney_f_max(*CFG["cf_range_hz"], 8))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny sizes: one torch thread, since the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    return SYSTEM.build(SMALL_CFG, TRAFFIC, "cpu")


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def answer(request, system):
    """(2 × 0.25 s tones batch of the seed, the port's answer on it)."""
    x = inputs.make_pool(TRAFFIC, request.param, torch.device("cpu"))[0]
    return x, system(x)


def _verdict(x, out):
    return judge.verdict(REF.check(SMALL_CFG, TRAFFIC, x, out), CFG["limits"])


@pytest.mark.parametrize("cfg", [CFG, SMALL_CFG], ids=["published", "small"])
def test_reference_centres_equal_the_port(cfg):
    """Wang et al.'s ERB-rate centres from both ends, and the library's
    Slaney spacing at the configuration's ``f_max``: the same bands."""
    port = tg.gammatone_center_frequencies(
        tg.ErbParams(int(cfg["n_bands"]), float(cfg["f_min"]), float(cfg["f_max"]),
                     tg.ErbSpacing(cfg["spacing"])))
    ref = REF.centre_frequencies(cfg)
    np.testing.assert_allclose(ref[[0, -1]], cfg["cf_range_hz"], rtol=1e-14, atol=0)
    np.testing.assert_allclose(port, ref, rtol=1e-13, atol=0)


def test_port_is_correct_under_the_limits(answer):
    x, out = answer
    got = out["cochleagram"]
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, 8, REF.n_frames(SMALL_CFG, x.shape[-1]))
    ok, checks, _ = _verdict(x, out)
    assert ok, checks
    # the float32 output's rounding, far inside the limit
    assert checks["gt_db_err"]["value"] < 0.1 * checks["gt_db_err"]["limit"], checks


def test_control_one_precision_below_fails(answer):
    x, _ = answer
    ok, checks, failed = _verdict(x, REF.outputs(SMALL_CFG, x, tf32=True))
    assert not ok and failed == ["gt_db_err"], checks


def _half_batch(out):
    v = out.clone()
    v[1] = v[0]
    return v


def _value_moved(out):
    v = out.clone()
    v[0, 3, 5] += 1e-3 * v[:, 3].abs().max()
    return v


def _bands_reversed(out):
    return out.flip(1)


FAULTS = {"half_batch": _half_batch, "value_moved": _value_moved,
          "bands_reversed": _bands_reversed}


@pytest.mark.parametrize("fault", list(FAULTS), ids=list(FAULTS))
def test_fault_is_not_correct(answer, fault):
    x, out = answer
    ok, checks, failed = _verdict(x, {"cochleagram": FAULTS[fault](out["cochleagram"])})
    assert not ok and failed == ["gt_db_err"], checks


def test_task_count_is_the_counters(system):
    x = inputs.make_pool(TRAFFIC, 3, torch.device("cpu"))[0]
    calls, samples = erb.gt_calls, erb.gt_filtered_samples
    system(x)
    assert erb.gt_calls - calls == 1
    assert erb.gt_filtered_samples - samples == REF.filtered_samples(SMALL_CFG, TRAFFIC)


def test_gt_task_at_the_published_size():
    """32 × 10 s at 16 kHz, frame 320, hop 160: 999 frames a clip. Filtered
    samples 32·64·999·320 = 654,704,640 at 34 operations, plus the window's
    32·999·320 products; bytes: the float32 input read and the float32 output
    written once. The operations bound it on the H100 (0.332 ms against 8.6 µs)."""
    traffic = json.loads(TRAFFIC_FILE.read_text())
    assert REF.filtered_samples(CFG, traffic) == 654_704_640
    flops, nbytes = REF.gt_task(CFG, traffic)
    assert flops == 34 * 654_704_640 + 32 * 999 * 320 == 22_270_187_520
    assert nbytes == 4 * 32 * 160_000 + 4 * 32 * 64 * 999 == 28_663_808
    assert flops / 67e12 > nbytes / 3.35e12


def test_span_under_profiling_trace(tmp_path, system):
    x = inputs.make_pool(TRAFFIC, 9, torch.device("cpu"))[0]
    with profiling.trace(str(tmp_path), device="cpu") as tr:
        for _ in range(2):
            system(x)
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    found = [e["name"] for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("tg.op.erb.")]
    assert found == ["tg.op.erb.gammatone_iir_spectrogram"] * 2


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
