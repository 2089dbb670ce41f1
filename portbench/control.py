#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's and the control's, seed by seed.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 ...

For each seed, at the cell's own sizes: the program's numbers (the entry the
window drives, on ``check_samples`` batches of the seed's pool) and the
control's (the plain reference computed one precision below the
configuration's, ``outputs(..., tf32=True)``, put in the program's place),
each held against the float64 reference by the configuration's ``check``.
One JSON line a seed; a summary line last. The benchmark's runs do not run
this. Served cells (``kind: wav``) read their program numbers from the
benchmark's own runs; here they get the control's alone.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(HERE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from harness import inputs, judge, manifest

    cell = manifest.load_cell(ROOT, args.workload)
    cfg, tr, ref = cell.config, cell.traffic, cell.reference_module
    dev = torch.device("cuda", 0)
    system = None if tr["kind"] == "wav" else cell.system_module.build(cfg, tr, dev)
    k = int(tr.get("check_samples", 4))
    prog_all, ctrl_all = [], []
    for seed in args.seeds:
        prog, ctrl = [], []
        if tr["kind"] == "wav":
            pcm = inputs.corpus_pcm(tr, seed)
            bs = int(tr["batch_size"])
            batches = [torch.from_numpy(pcm[i * bs:(i + 1) * bs]).to(dev) for i in range(k)]
            xs = [(b, b.to(torch.float64) / 32768.0) for b in batches]
        else:
            pool = inputs.make_pool(tr, seed, dev)
            xs = [(x, x) for x in pool[:k]]
        for raw, x in xs:
            if system is not None:
                out = system(raw)
                prog.append(ref.check(cfg, tr, raw, out))
                del out
            ctl = ref.outputs(cfg, x.to(torch.float32), tf32=True)
            ctrl.append(ref.check(cfg, tr, x, ctl))
        line = {"seed": seed, "program": judge.worst(prog) if prog else None,
                "control": judge.worst(ctrl)}
        prog_all += prog
        ctrl_all += ctrl
        print(json.dumps(line), flush=True)
    lo = judge.worst(prog_all) if prog_all else {}
    up = {}
    for r in ctrl_all:
        for name, v in r.items():
            up[name] = min(up.get(name, float("inf")), v)
    print(json.dumps({"workload": args.workload, "program_max": lo, "control_min": up,
                      "device": torch.cuda.get_device_name(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
