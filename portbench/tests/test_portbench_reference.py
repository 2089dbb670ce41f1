"""Each configuration's plain reference against the port on the CPU, the
control one precision down, and the frozen task count."""

import json

import numpy as np
import pytest
import torch

from harness import inputs, judge, manifest
from harness.precision import tf32_round

CONFIGS = {
    # config: (traffic used to size a small batch, rows, seconds)
    "speech_mfcc40": ("batch_32x10s_16k", 2, 1.0),
    "music_cqt84": ("batch_64x5s_44k", 2, 2.0),
}


def _load(config):
    cfg = json.loads((manifest.BENCH_DIR / "configs" / f"{config}.json").read_text())
    system = manifest.load_module(manifest.BENCH_DIR / "configs" / f"{config}.py", "config")
    ref = manifest.load_module(manifest.BENCH_DIR / "reference" / f"{config}.py", "reference")
    traffic = json.loads((manifest.BENCH_DIR / "traffic" / f"{CONFIGS[config][0]}.json")
                         .read_text())
    return cfg, system, ref, traffic


def _small_batch(traffic, rows, seconds, seed=7):
    small = dict(traffic, clips=rows, clip_s=seconds, pool=1)
    return inputs.make_pool(small, seed, torch.device("cpu"))[0]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    config = request.param
    cfg, system, ref, traffic = _load(config)
    _, rows, seconds = CONFIGS[config]
    x = _small_batch(traffic, rows, seconds)
    out = system.build(cfg, traffic, "cpu")(x)
    return config, cfg, ref, traffic, x, out


def test_reference_matches_port(case):
    _, cfg, ref, traffic, x, out = case
    numbers = ref.check(cfg, traffic, x, out)
    ok, checks, failed = judge.verdict(numbers, cfg["limits"])
    assert ok, checks
    # the CPU's plain route agrees to float32 rounding, far inside the limits
    assert all(v < 0.1 * cfg["limits"][k] for k, v in numbers.items()), numbers


def test_bf16_rounded_output_fails(case):
    _, cfg, ref, traffic, x, out = case
    rounded = {k: v.to(torch.bfloat16).to(v.dtype) for k, v in out.items()}
    ok, checks, _ = judge.verdict(ref.check(cfg, traffic, x, rounded), cfg["limits"])
    assert not ok, checks


def test_tf32_control_fails(case):
    _, cfg, ref, traffic, x, _ = case
    control = ref.outputs(cfg, x, tf32=True)
    ok, checks, failed = judge.verdict(ref.check(cfg, traffic, x, control), cfg["limits"])
    assert not ok, checks


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (manifest.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        tops = {name.split(".")[0] for name in names}
        assert not tops & {"spectrograms_tpu_torch", "spectrograms_tpu", "jax"}, (path, tops)


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0 + 2.0 ** -20, 0.0])
    got = tf32_round(x)
    want = torch.tensor([1.0, 1.0, 1.0 + 4 * 2.0 ** -11, -3.0, 0.0])  # ties to even
    assert torch.equal(got, want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rel = ((tf32_round(y) - y).abs() / y.abs()).max()
    assert 0 < rel <= 2.0 ** -11


def test_task_count_at_the_flagship():
    """32 × 10 s at 16 kHz, 1024/256 centred: 626 frames a row, 20,032 in all.
    A frame: FFT 2.5·1024·10 = 25,600; |X|² 3·513 = 1,539; mel 2·1,009
    nonzeros = 2,018; log 128; DCT-II 2·128·40 = 10,240; lifter 40: 39,565.
    Bytes: 4·32·160,000 in, 4·20,032·40 out."""
    cfg, _, ref, traffic = _load("speech_mfcc40")
    fb = ref.mel_filterbank(16000.0, 1024, 128, 0.0, 8000.0)
    assert np.count_nonzero(fb) == 1009
    flops, nbytes = ref.f32_task(cfg, traffic)
    assert flops == 39_565 * 20_032 == 792_566_080
    assert nbytes == 20_480_000 + 3_205_120
    # the least time on the H100: operations bound it (11.83 µs > 7.07 µs)
    assert flops / 67e12 > nbytes / 3.35e12
