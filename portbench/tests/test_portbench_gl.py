"""The Griffin-Lim cell, ``tts_mel80_gl32.batch``: its manifest entry and
files, the frozen task count, the two readers on a program with and
without the ``gl_iterations`` counter, and a whole run on the CPU at small
sizes, correct and, with the timed path broken, not."""

import json
import shutil
from types import SimpleNamespace

import pytest
import torch

from harness import cell as cell_mod
from harness import manifest, tracing

ROOT = manifest.BENCH_DIR.parent
CELL = "tts_mel80_gl32.batch"
SMALL = dict(clips=2, clip_s=0.5, pool=2, check_samples=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny sizes: one torch thread, since the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cell_loads_with_its_ten_per_layer_metrics():
    cell = manifest.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "closed"
    assert [m["name"] for m in cell.end_to_end] == ["audio_s_per_s", "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted([
        "host_enqueue_ms", "step_device_ms", "device_idle_pct", "plan_host_ms", "ops_host_ms",
        "ops_launches", "launch_host_ms", "idle_in_program_pct", "gl_iter_device_ms",
        "gl_roofline_pct"])
    entry = {c["name"]: c for c in manifest.read_manifest(ROOT)["configs"]}["tts_mel80_gl32"]
    assert entry["reduced"] == [] == cell.config["reduced"]


def test_gl_task_is_the_same_whatever_route():
    """The count is an FFT-based iteration's, so a float64 program (the fft
    route) or a larger ``n_fft`` bound (the matmul route there) reads the
    same work."""
    cell = manifest.load_cell(ROOT, CELL)
    task = cell.reference_module.gl_task
    want = task(cell.config, cell.traffic)
    assert want == (1_702_208_640, 566_109_952)
    for change in ({"dtype": "float64"}, {"precision": "HIGHEST"}, {"f32_kernel": None}):
        assert task(dict(cell.config, **change), cell.traffic) == want


def _ctx(cell, steps=4, iterations_per_step=32):
    """A traced window of ``steps`` steps: per step a mel kernel of 0.1 ms and
    Griffin-Lim kernels of 3 ms."""
    ops = []
    for s in range(steps):
        ops.append(("kernel", "void fused_features_kernel<1>(float*)", 10.0 * s, 100.0))
        ops.append(("kernel", "sm80_xmma_gemm_f32f32", 10.0 * s + 1, 3000.0))
    trace = tracing.Trace(ops=ops, spans=[], window=(0.0, 1e6), steps=steps, attempts=1)
    extra = {"gl_iterations_per_step": iterations_per_step}
    return SimpleNamespace(config=cell.config, traffic=cell.traffic, trace=trace,
                           reference=cell.reference_module, device=torch.device("cuda", 0),
                           extra=extra, peak_flops=cell_mod.PEAK_F32_FLOPS,
                           peak_bytes=cell_mod.PEAK_HBM_BYTES)


def test_readers_on_a_counted_window():
    cell = manifest.load_cell(ROOT, CELL)
    ctx = _ctx(cell)
    it = manifest.load_reader("gl_iter_device_ms").read(ctx)
    assert it == pytest.approx(3.0 / 32)  # the mel kernel left out
    pct = manifest.load_reader("gl_roofline_pct").read(ctx)
    least_s = max(1_702_208_640 / 67e12, 566_109_952 / 3.35e12)
    assert pct == pytest.approx(100.0 * least_s / (it * 1e-3))


def test_readers_read_none_without_the_counter(monkeypatch):
    """A program whose reconstruction module has no ``gl_iterations`` (the
    tree before the counter) leaves both metrics out, with a trace on a card."""
    from spectrograms_tpu_torch import reconstruct

    cell = manifest.load_cell(ROOT, CELL)
    monkeypatch.delattr(reconstruct, "gl_iterations")
    for name in ("gl_iter_device_ms", "gl_roofline_pct"):
        ctx = _ctx(cell)
        ctx.extra = {}
        ctx.system = lambda x: pytest.fail("no step runs without the counter")
        reader = manifest.load_reader(name)
        reader.measure(ctx)
        assert reader.read(ctx) is None


def test_readers_read_none_outside_a_traced_card_run():
    cell = manifest.load_cell(ROOT, CELL)
    for name in ("gl_iter_device_ms", "gl_roofline_pct"):
        ctx = _ctx(cell)
        ctx.extra, ctx.trace, ctx.device = {}, None, torch.device("cpu")
        assert manifest.load_reader(name).read(ctx) is None


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_gl")
    shutil.copytree(manifest.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    p = root / "portbench" / "traffic" / "batch_32x10s_22k.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), **SMALL)))
    return root


def _negated(system):
    def broken(x):
        out = system(x)
        return dict(out, audio=-out["audio"])
    return broken


@pytest.mark.parametrize("patch", [None, _negated], ids=["port", "negated"])
def test_whole_run_on_the_cpu(small_root, patch):
    result, lines = cell_mod.run_cell(small_root, CELL, 2**31 + 29, 0.3, False, device="cpu",
                                      bench_dir=small_root / "portbench", patch_system=patch)
    assert result["correct"] is (patch is None), result["checks"]
    assert set(result["checks"]) == {"mel_err", "sc_self_err", "wave_err"}
    assert set(result["metrics"]) == {"setup_s", "audio_s_per_s"}
