"""Does ``profiling.trace`` keep its kernel records across an idle gap?

Starts one process of its own, with ``KINETO_LOG_LEVEL=0`` so that Kineto
logs its record counts (among them the records it dropped as outside the
trace's window). That process runs one probe, sleeps ``--gap`` seconds,
then runs two more. A probe is one ``profiling.trace`` over one
``compute_batch`` of config 2's mel-dB plan at HIGH (the f32 kernel) and at
DEFAULT (the tier kernel) on a (4, 16000) batch and a 64x64 matmul; it
prints the kernel launches the trace holds and those whose kernel it lost.
Run from the repository root on one H100:

    python3 -m spectrograms_tpu_torch.tools.trace_bisect [--gap 75]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch


def probe(label: str) -> None:
    """One trace of the probe's calls, printed as one PROBE line."""
    import spectrograms_tpu_torch as tg
    from spectrograms_tpu_torch import profiling
    from spectrograms_tpu_torch.errors import FftBackendError

    params = tg.SpectrogramParams(tg.StftParams(1024, 256), 16000.0)
    mel = tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY)
    plans = [tg.MelDbPlan(params, mel, tg.LogParams(-80.0), dtype="float32", **kw)
             for kw in ({}, dict(precision=tg.Precision.DEFAULT))]
    xb = torch.randn(4, 16000, device="cuda")
    a = torch.randn(64, 64, device="cuda")
    for plan in plans:
        plan.compute_batch(xb)
    torch.cuda.synchronize()
    raised = ""
    with tempfile.TemporaryDirectory() as tmp:
        tr = profiling.trace(tmp)
        try:
            with torch.no_grad(), tr:
                for plan in plans:
                    plan.compute_batch(xb)
                a @ a
        except FftBackendError as e:
            raised = f" | trace raised: {str(e)[:160]}"
        with open(tr.path) as f:
            launches, lost = profiling.lost_kernels(json.load(f)["traceEvents"])
    print(f"PROBE {label}: launches {launches}; lost {lost}{raised}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gap", type=float, default=75.0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        probe("first")
        time.sleep(args.gap)
        probe(f"after {args.gap:g} s idle")
        probe("again")
        return
    child = subprocess.run(
        [sys.executable, "-m", "spectrograms_tpu_torch.tools.trace_bisect", "--child",
         "--gap", str(args.gap)],
        capture_output=True, text=True, env=dict(os.environ, KINETO_LOG_LEVEL="0"))
    print(child.stdout, end="")
    for line in child.stderr.splitlines():
        if "Record counts" in line or "Out-of-range" in line or "Error" in line:
            print("stderr: " + line[:300])
    sys.exit(child.returncode)


if __name__ == "__main__":
    main()
