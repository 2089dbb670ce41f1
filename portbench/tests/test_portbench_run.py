"""Whole runs of each cell on the CPU at small sizes, with the look for a
card skipped: the check passes on the port, and comes out false when the
timed path is broken underneath. Then the command line's refusals, and on a
card one real run."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from harness import cell as cell_mod
from harness import manifest

ROOT = manifest.BENCH_DIR.parent
SMALL = {  # traffic: the sizes a CPU test can hold
    "batch_32x10s_16k": dict(clips=4, clip_s=1, pool=2, check_samples=2),
    "stream3_32x10s_16k": dict(clips=4, clip_s=1, pool=2, check_samples=2),
    "batch_64x5s_44k": dict(clips=4, clip_s=1, pool=2, check_samples=2),
    "wav_256x10s_16k": dict(files=8, clip_s=1, batch_size=4, target_seconds=1,
                            check_samples=2, trace_passes=1, loader_passes=1),
}
WORKLOADS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(manifest.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, upd in SMALL.items():
        p = root / "portbench" / "traffic" / f"{name}.json"
        p.write_text(json.dumps(dict(json.loads(p.read_text()), **upd)))
    return root


def _run(root, workload, patch=None, trace=False, seed=2**31 + 17):
    return cell_mod.run_cell(root, workload, seed, 0.3, trace, device="cpu",
                             bench_dir=root / "portbench", patch_system=patch)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_the_cpu(small_root, workload):
    result, lines = _run(small_root, workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(result)[-1] == "checks"
    assert {"setup_s", "audio_s_per_s"} <= set(result["metrics"])
    assert lines and all(line.startswith("check ") for line in lines)


def _half_batch(system):
    """Half of the batch left out: its rows replaced by the other half's."""
    def broken(out):
        out = {k: v.clone() for k, v in out.items()}
        for v in out.values():
            h = v.shape[0] // 2
            v[h:2 * h] = v[:h]
        return out
    return _wrap(system, broken)


def _altered(system):
    """One answer altered where it is produced: one element of the first
    output moved by a thousandth of its slice's largest value."""
    def broken(out):
        out = {k: v.clone() for k, v in out.items()}
        v = next(iter(out.values()))
        v[0, 0, 0] += 1e-3 * v[:, 0].abs().max()
        return out
    return _wrap(system, broken)


def _wrap(system, broken):
    class Broken:
        def __call__(self, x):
            return broken(system(x))

        def post(self, feats):
            return broken(system.post(feats))

        def pipeline(self, traffic):
            return system.pipeline(traffic)

    return Broken()


@pytest.mark.parametrize("fault", [_half_batch, _altered], ids=["half_batch", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(small_root, workload, fault):
    result, _ = _run(small_root, workload, patch=fault)
    assert not result["correct"], result["checks"]
    assert result["failed"] > 0


def test_traced_run_without_a_card_reads_no_device_metric(small_root):
    result, _ = _run(small_root, "speech_mfcc40.batch", trace=True)
    assert result["correct"]
    assert "breakdown" not in result and "busy_s" not in result["device"]
    assert set(result["metrics"]) <= {"host_enqueue_ms"}


def _cli(cwd, *args, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _cli(ROOT, "--workload", "speech_mfcc40.batch", "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_bare_directory_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    program is missing, so the run fails and prints no result."""
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(tmp_path, "--workload", "speech_mfcc40.batch", "--seed", "1", "--seconds", "1",
               "--trace", "0", env=env)
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.card
def test_one_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _cli(ROOT, "--workload", "speech_mfcc40.batch", "--seed", "5", "--seconds", "2",
               "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
