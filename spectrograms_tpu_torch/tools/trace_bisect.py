"""Where in a long-lived process does ``torch.profiler`` stop recording kernels?

Runs ``chip_smoke.py``'s ``main`` (one H100, from the repository root) with
a probe before and after each of its phases 7-11 and in place of phase 12:
config 2's HIGH plan on a (4, 16000) batch and a 64x64 matmul, one call each
inside ``profiling.trace``, then prints the kernels the trace names.

    python3 -m spectrograms_tpu_torch.tools.trace_bisect [--shared-cudart] [--pad S]

``--shared-cudart`` builds the kernels against the shared CUDA runtime;
``--pad S`` sleeps S seconds inside the trace before and after the calls.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch


def probe(label: str, pad: float) -> None:
    import spectrograms_tpu_torch as tg
    from spectrograms_tpu_torch import profiling

    plan = tg.MelDbPlan(tg.SpectrogramParams(tg.StftParams(1024, 256), 16000.0),
                        tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY), tg.LogParams(-80.0),
                        dtype="float32")
    xb = torch.randn(4, 16000, device="cuda")
    a = torch.randn(64, 64, device="cuda")
    plan.compute_batch(xb)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with torch.no_grad(), profiling.trace(tmp) as tr:
            time.sleep(pad)
            plan.compute_batch(xb)
            a @ a
            torch.cuda.synchronize()
            time.sleep(pad)
        with open(tr.path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"][:60] for e in events if e.get("cat") == "kernel"})
    launches = [e["name"] for e in events if e.get("cat") == "cuda_runtime" and "aunch" in e["name"]]
    print(f"PROBE {label}: {len(events)} events; kernels {kernels}; launches {launches}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shared-cudart", action="store_true")
    ap.add_argument("--pad", type=float, default=0.0)
    args = ap.parse_args()
    import chip_smoke
    from spectrograms_tpu_torch.ops import _build

    if args.shared_cudart:
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-cudart", "shared")

    def wrapped(fn, label):
        def run(*a, **k):
            probe(f"before {label}", args.pad)
            out = fn(*a, **k)
            probe(f"after {label}", args.pad)
            return out
        return run

    for name, label in (("serving_phase", "7"), ("surface_phase", "8"), ("config4_phase", "9"),
                        ("fft_image_phase", "10"), ("tuning_parallel_phase", "11")):
        setattr(chip_smoke, name, wrapped(getattr(chip_smoke, name), label))
    chip_smoke.profiling_phase = lambda *a, **k: probe("in place of 12", args.pad)
    chip_smoke.main()


if __name__ == "__main__":
    main()
