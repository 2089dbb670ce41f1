"""The manifest: names and units, files found by name, a cell added as new
files only, and no JAX anywhere in the harness."""

import json
import shutil
import subprocess
import sys

import pytest

from harness import manifest

MANIFEST = json.loads((manifest.BENCH_DIR.parent / "BENCHMARK.json").read_text())


def _names():
    out = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    out += [c["name"] for c in MANIFEST["configs"]]
    for w in MANIFEST["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", _names())
def test_name_uses_allowed_characters(name):
    assert manifest.NAME_RE.match(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert manifest.UNIT_RE.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    # every metric, end to end or per layer, has its reader
    reader = manifest.load_reader(metric["name"])
    assert callable(reader.read)


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_workload_files_found_by_name(workload):
    cell = manifest.load_cell(manifest.BENCH_DIR.parent, workload)
    assert callable(cell.system_module.build)
    assert callable(cell.reference_module.check)
    assert callable(cell.reference_module.outputs)
    assert cell.traffic["kind"] in ("closed", "wav")
    assert cell.config["limits"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "audio_s_per_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"


def test_new_workload_needs_no_edit(tmp_path):
    """A later cell comes as new files and new entries; no file changes."""
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    traffic = json.loads((tmp_path / "portbench/traffic/batch_32x10s_16k.json").read_text())
    traffic.update(clips=16)
    (tmp_path / "portbench/traffic/batch_16x10s_16k.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/rows_per_batch.py").write_text(
        "def read(ctx):\n    return ctx.traffic['clips']\n")
    m = json.loads(json.dumps(MANIFEST))
    m["workloads"].append({"name": "speech_mfcc40.batch16", "config": "speech_mfcc40",
                           "traffic": "batch_16x10s_16k", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "rows_per_batch", "unit": "rows", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "audio_s_per_s", "workloads": ["speech_mfcc40.batch16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.load_cell(tmp_path, "speech_mfcc40.batch16", tmp_path / "portbench")
    assert cell.traffic["clips"] == 16
    assert [p["name"] for p in cell.per_layer] == ["rows_per_batch"]
    reader = manifest.load_reader("rows_per_batch", tmp_path / "portbench")
    assert reader.read(type("C", (), {"traffic": cell.traffic})) == 16
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _modules_after(imports: str) -> set:
    code = (f"import sys; sys.path[:0] = [{str(manifest.BENCH_DIR.parent)!r}, "
            f"{str(manifest.BENCH_DIR)!r}]\n{imports}\n"
            "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    """The harness and every config, traffic, metric and reference module:
    no module whose top-level name is jax, jaxlib, flax or spectrograms_tpu
    (whole names: spectrograms_tpu_torch is the program)."""
    loads = ["import harness.cell, harness.inputs, harness.loops, harness.tracing, "
             "harness.judge, harness.precision, harness.manifest",
             "from harness import manifest",
             "for w in ['speech_mfcc40.batch', 'music_cqt84.batch', 'speech_mfcc40.serve_wav', "
             "'speech_mfcc40.stream']:\n    manifest.load_cell(manifest.BENCH_DIR.parent, w)",
             "for p in (manifest.BENCH_DIR / 'metrics').glob('*.py'):\n"
             "    manifest.load_module(p, 'metric')"]
    tops = _modules_after("\n".join(loads))
    assert "spectrograms_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "spectrograms_tpu"}, tops


def test_references_load_nothing_of_the_program():
    tops = _modules_after(
        "from harness import manifest\n"
        "for p in (manifest.BENCH_DIR / 'reference').glob('*.py'):\n"
        "    manifest.load_module(p, 'reference')")
    assert not tops & {"spectrograms_tpu_torch", "spectrograms_tpu", "jax", "jaxlib"}, tops
