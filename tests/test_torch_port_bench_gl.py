"""The benchmark's Griffin-Lim configuration, ``tts_mel80_gl32``, on the CPU at
small sizes (n_fft 256, hop 64, 2 × 0.25 s, 8 iterations): the port's entry
(``MelDbPlan.compute_batch`` then ``tg.invert_mel_db``) is correct under the
configuration's limits against its plain reference; the reference's float64
Griffin-Lim equals the port's float64 route; a bf16-rounded waveform, one
iteration fewer, classic Griffin-Lim, a negated waveform and one mel band
moved by a thousandth of its range are not correct; the reconstruction
module's counters and spans; and the reference loads nothing of the port or
of JAX."""

import json
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
from spectrograms_tpu_torch import profiling, reconstruct  # noqa: E402

CONFIG = "tts_mel80_gl32"
CFG = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
SMALL_CFG = dict(CFG, n_fft=256, hop=64, n_iter=8)
TRAFFIC = dict(json.loads((BENCH / "traffic" / "batch_32x10s_22k.json").read_text()),
               clips=2, clip_s=0.25, pool=1)
REF_PATH = BENCH / "reference" / f"{CONFIG}.py"
REF = manifest.load_module(REF_PATH, "reference")
SYSTEM = manifest.load_module(BENCH / "configs" / f"{CONFIG}.py", "config")
SEEDS = (7, 8)


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


def test_port_is_correct_under_the_limits(answer):
    x, out = answer
    assert out["mel_db"].dtype == out["audio"].dtype == torch.float32
    assert out["mel_db"].shape == (2, 80, REF._f64.n_frames(x.shape[-1], 256, 64))
    assert out["audio"].shape == x.shape
    ok, checks, _ = _verdict(x, out)
    assert ok, checks
    # float32 on the CPU: each number far inside its limit
    for k, v in checks.items():
        assert v["value"] < 0.1 * v["limit"], checks


def test_reference_griffin_lim_equals_the_port_float64_route(answer):
    """Both start from torch's seed-0 phase; the port's float64 route is
    ``torch.fft`` too, so the two agree to float64 rounding."""
    x, out = answer
    mag = REF.target_magnitude(SMALL_CFG, out["mel_db"].to(torch.float64))
    want = REF.griffin_lim(SMALL_CFG, mag, x.shape[-1])
    got = tg.griffin_lim(mag.transpose(-1, -2), 256, 64, n_iter=8, length=x.shape[-1],
                         device="cpu")
    assert got.dtype == want.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-9 * float(want.abs().max()))


def _invert(system, mel_db, n, **kw):
    mag = torch.sqrt(tg.mel_to_linear(torch.pow(10.0, mel_db / 10.0), system.mel, system.sr,
                                      system.n_fft, device="cpu"))
    return tg.griffin_lim(mag, system.n_fft, system.hop, length=n, device="cpu", **kw)


def _bf16_waveform(system, x, out):
    return dict(out, audio=out["audio"].to(torch.bfloat16).to(torch.float32))


def _one_iteration_fewer(system, x, out):
    return dict(out, audio=_invert(system, out["mel_db"], x.shape[-1], n_iter=7))


def _classic(system, x, out):
    return dict(out, audio=_invert(system, out["mel_db"], x.shape[-1], n_iter=8,
                                   momentum=0.0))


def _negated(system, x, out):
    return dict(out, audio=-out["audio"])


def _band_moved(system, x, out):
    db = out["mel_db"].clone()
    db[:, 5] += 1e-3 * (db[:, 5].max() - db[:, 5].min())
    return dict(out, mel_db=db)


FAULTS = {  # fault: the numbers that must catch it
    "bf16_waveform": (_bf16_waveform, {"sc_self_err"}),
    "one_iteration_fewer": (_one_iteration_fewer, {"sc_self_err"}),
    "momentum_0": (_classic, {"sc_self_err", "wave_err"}),
    "negated": (_negated, {"wave_err"}),
    "band_moved": (_band_moved, {"mel_err"}),
}


@pytest.mark.parametrize("fault", list(FAULTS), ids=list(FAULTS))
def test_fault_is_not_correct(answer, system, fault):
    x, out = answer
    make, catch = FAULTS[fault]
    ok, checks, failed = _verdict(x, make(system, x, out))
    assert not ok and catch <= set(failed), checks


def test_control_one_precision_below_fails(answer):
    x, _ = answer
    ok, checks, failed = _verdict(x, REF.outputs(SMALL_CFG, x, tf32=True))
    assert not ok and "mel_err" in failed, checks


@pytest.mark.parametrize("dtype,route", [(torch.float32, "gl_matmul_calls"),
                                         (torch.float64, "gl_fft_calls")])
def test_counters_count_iterations_and_routes(dtype, route):
    mag = torch.rand(2, 129, 12, generator=torch.Generator().manual_seed(0), dtype=dtype)
    names = ("gl_iterations", "gl_matmul_calls", "gl_fft_calls")
    before = {k: getattr(reconstruct, k) for k in names}
    tg.griffin_lim(mag, 256, 64, n_iter=5, device="cpu")
    tg.griffin_lim(mag, 256, 64, n_iter=3, device="cpu")
    delta = {k: getattr(reconstruct, k) - before[k] for k in names}
    assert delta == {"gl_iterations": 8, "gl_matmul_calls": 0, "gl_fft_calls": 0, route: 2}


def test_spans_under_profiling_trace(tmp_path, system):
    x = inputs.make_pool(TRAFFIC, 9, torch.device("cpu"))[0]
    db = system.plan.compute_batch(x)
    with profiling.trace(str(tmp_path), device="cpu") as tr:
        for _ in range(2):
            tg.invert_mel_db(db, system.mel, system.sr, 256, 64, n_iter=2, device="cpu")
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    found = [e["name"] for e in sorted(events, key=lambda e: float(e.get("ts", 0.0)))
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("tg.op.reconstruct.")]
    assert found == ["tg.op.reconstruct.mel_to_linear", "tg.op.reconstruct.griffin_lim"] * 2


def test_gl_task_at_the_published_size():
    """32 × 10 s at 22.05 kHz, 1024/256 centred: 862 frames a row, 27,584 in
    all. A frame: two transforms 2·2.5·1024·10 = 51,200; windows and
    overlap-add 3·1,024 = 3,072; normalisation 256; 14 a bin · 513 = 7,182:
    61,710. Bytes: magnitude 4·27,584·513; spectrum and previous spectrum
    read and written 32 a bin; the 32 × 221,440 signal written and read."""
    traffic = json.loads((BENCH / "traffic" / "batch_32x10s_22k.json").read_text())
    flops, nbytes = REF.gl_task(CFG, traffic)
    assert flops == 61_710 * 27_584 == 1_702_208_640
    assert nbytes == 36 * 27_584 * 513 + 8 * 32 * 221_440 == 566_109_952
    # the bytes bound it on the H100: 169 µs against 25 µs of operations
    assert nbytes / 3.35e12 > flops / 67e12


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
