#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics read from a traced window. The
last line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``; then
``setup`` and, last, ``checks``: each number compared with its limit). The
last lines of standard error repeat the checks.

The run fails, printing no result, without a CUDA device (or with fewer than
the cell asks for), and when JAX or the JAX package ``spectrograms_tpu`` is
loaded once the window has closed. Build and kernel caches stay inside the
checkout, under ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _cache_env() -> None:
    """Fixed cache directories inside the checkout, before torch is imported."""
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_env()
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import cell as cell_mod

    phases = {}
    t0 = cell_mod.process_age_s()
    import torch  # noqa: F401

    t1 = cell_mod.process_age_s()
    phases["python_and_torch_import"] = t1
    import spectrograms_tpu_torch  # noqa: F401

    phases["program_import"] = cell_mod.process_age_s() - t1
    del t0
    try:
        result, lines = cell_mod.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                          bool(args.trace), phases=phases)
    except cell_mod.NoDevice as e:
        print(f"portbench: no device for this cell: {e}", file=sys.stderr)
        return 2
    found = cell_mod.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
