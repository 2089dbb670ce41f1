"""The bf16 serving cell: loading it, with the files it names and its
metrics' readers, brings in no JAX and nothing of the JAX package."""

import subprocess
import sys

from harness import manifest


def test_bf16_cell_loads_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(manifest.BENCH_DIR.parent)!r}, "
            f"{str(manifest.BENCH_DIR)!r}]\n"
            "from harness import cell, manifest\n"
            "c = manifest.load_cell(manifest.BENCH_DIR.parent, 'speech_mfcc40_bf16.batch')\n"
            "for m in c.per_layer + c.end_to_end:\n"
            "    manifest.load_reader(m['name'])\n"
            "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    tops = set(out.stdout.split())
    assert "spectrograms_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "spectrograms_tpu"}, tops
