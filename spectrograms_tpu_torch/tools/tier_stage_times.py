"""Time the tier kernel (``csrc/fused_tier_features.cu``) on one GPU: against
an older tree's, by stage, by register cap and by tile.

Run from the repository root::

    python3 -m spectrograms_tpu_torch.tools.tier_stage_times [--parent DIR]

With ``--parent DIR`` (an unpacked older tree of this repository, e.g. from
``git archive``) it times that tree's tier kernel and this tree's in turns,
parent, this, this, parent, each in a process of its own that imports the
package from its tree, builds its kernel there and loads it through its own
``ctypes`` handle; each turn prints the SM clock and power after it. Then,
in this process, it times variants of this tree's source, each built by one
``nvcc`` (all started together) into ``build/spectrograms_tpu_torch/
tier_stages/`` and launched through the runner's ``launch(x, lib=...)``,
which does not count such launches: stages compiled out (``TIER_SKIP_INNER``:
the inner FFT into A; ``TIER_SKIP_OUTER``: the outer DFT into P;
``TIER_SKIP_TAIL``: filterbank, amplitude and DCT; and their pairs) and
a register cap of 85 (``TIER_MIN_BLOCKS=3``: 256-thread blocks an SM; the
default is 2, 128 registers),
and a build that counts each block's SM clocks between its barriers by
phase (``TIER_CLOCKS``: staging, inner FFT, outer DFT, filterbank, DCT),
printed as each phase's share of a block's time, and splits a warp's outer
DFT items at 1 pass into the wait for their B fragments, the products and
the power stores; and the kernel at each tile (``launch(x, tile_f=...)``), checked bit-equal
to the default tile's output. A stage variant's output is meaningless; only
its time is read. Differences between variants are the stages' costs, up to
the overlap of blocks on an SM.

Shapes: the flagship MFCC batch (32 x 160000, 1024/256, mel-128 dB, DCT-40)
at 1 pass Gauss, 1 pass packed and x2 (packed), and the chroma batch (64 x
220500, 4096/1024, 44.1 kHz, pre_amp magnitude) at 1 pass Gauss and x2;
white noise from seed 0. Times: CUDA events, median and p90 of 100 after
warm-up, the L2 flushed and the device held in a ~1 ms spin before each run,
so that the host's enqueue stays out of the reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's 1980 MHz SM clock
VARIANTS = {
    "no_inner": ["TIER_SKIP_INNER"],
    "no_outer": ["TIER_SKIP_OUTER"],
    "no_tail": ["TIER_SKIP_TAIL"],
    "inner_only": ["TIER_SKIP_OUTER", "TIER_SKIP_TAIL"],
    "none": ["TIER_SKIP_INNER", "TIER_SKIP_OUTER", "TIER_SKIP_TAIL"],
    "blocks3": ["TIER_MIN_BLOCKS=3"],
    "clocks": ["TIER_CLOCKS"],
}
PHASES = ("staging", "inner FFT", "outer DFT", "filterbank", "DCT")
SHAPES = ("flagship 1-pass Gauss", "flagship 1-pass packed", "flagship x2",
          "chroma 1-pass Gauss", "chroma x2")


def time_ms(fn, reps: int = 100) -> tuple:
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        # ~1 ms of device spin: the host enqueues fn() before the start
        # event fires, so its enqueue time stays out of the reading
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(np.percentile(times, 90))


def card(query: str = "name,power.limit") -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def clocks() -> str:
    """SM clock, its maximum, power draw and temperature, read now."""
    return card("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")


def runners() -> dict:
    """{shape: (runner, input)} of the package imported now."""
    import spectrograms_tpu_torch as tg
    from spectrograms_tpu_torch.mfcc import _dct_lifter_matrix
    from spectrograms_tpu_torch.ops import fused_factored as ff
    from spectrograms_tpu_torch.ops.filterbanks import chroma_filterbank, mel_filterbank

    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((32, 160000)).astype(np.float32)).cuda()
    xc = torch.from_numpy(rng.standard_normal((64, 220500)).astype(np.float32)).cuda()
    hann = lambda n: tuple(tg.make_window(tg.WindowType.hanning, n).tolist())
    mel = ff.KernelConst(mel_filterbank(16000.0, 1024, tg.MelParams(128, 0.0, 8000.0,
                                                                    tg.MelNorm.SLANEY)))
    dct = ff.KernelConst(_dct_lifter_matrix(128, 40, 22))
    chroma = ff.KernelConst(chroma_filterbank(44100.0, 4096, tg.ChromaParams()))
    flagship = lambda **kw: ff.fused_factored_features(
        1024, 256, hann(1024), mel, amp="decibels", dct_key=dct, **kw)
    chroma_run = lambda **kw: ff.fused_factored_features(
        4096, 1024, hann(4096), chroma, amp="power", pre_amp="magnitude", **kw)
    return dict(zip(SHAPES, (
        (flagship(precision="bf16"), xb),
        (flagship(precision="bf16", gauss=False), xb),
        (flagship(precision="bf16x2"), xb),
        (chroma_run(precision="bf16"), xc),
        (chroma_run(precision="bf16x2"), xc),
    )))


def worker(root: str) -> None:
    """Time the tier kernel of the tree at ``root``; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    import spectrograms_tpu_torch

    times = {}
    with torch.no_grad():
        for shape, (run, x) in runners().items():
            times[shape] = time_ms(lambda: run(x))
    print(json.dumps({"root": root, "package": spectrograms_tpu_torch.__file__,
                      "card": card(), "clocks": clocks(), **times}), flush=True)


def a_b(parent: str) -> None:
    here = str(Path(__file__).resolve().parents[2])
    results = []
    for label, root in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", root],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{label} run failed:\n{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append((label, res))
        row = " | ".join(f"{s} {res[s][0]:.4f}/{res[s][1]:.4f}" for s in SHAPES)
        print(f"[tier a/b] {label} ({res['card']}), median/p90 ms of 100: {row} | after: "
              f"{res['clocks']}", flush=True)
    for shape in SHAPES:
        par = [r[shape][0] for label, r in results if label == "parent"]
        chg = [r[shape][0] for label, r in results if label == "change"]
        print(f"[tier a/b] {shape}: parent/change median ratio {np.mean(par) / np.mean(chg):.2f}"
              f" (parent {par}, change {chg}; change faster in both turns: "
              f"{max(chg) < min(par)})", flush=True)


def variants_and_tiles() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from spectrograms_tpu_torch.ops import _build
    from spectrograms_tpu_torch.ops import fused_factored as ff

    out = _build.BUILD_DIR / "tier_stages"
    out.mkdir(parents=True, exist_ok=True)
    source = _build._CSRC / "fused_tier_features.cu"
    nvcc = _build.find_nvcc()
    jobs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *(f"-D{d}" for d in defs), "-o", str(out / f"lib{name}.so"),
         str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defs in VARIANTS.items()}
    libs = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        ptxas = " ".join(line.split(":", 1)[-1].strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line)
        print(f"[tier variants] {name}: {ptxas}", flush=True)
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, (argtypes, restype) in ff._TIER_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    clocked = libs.pop("clocks")
    clocked.fused_tier_features_clocks.argtypes = [ctypes.c_void_p]
    clocked.fused_tier_features_clocks.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * (len(PHASES) + 3))()

    print(f"[tier stages] {card()} | median/p90 ms of 100", flush=True)
    with torch.no_grad():
        for shape, (run, x) in runners().items():
            row = [f"full {'/'.join(f'{v:.4f}' for v in time_ms(lambda: run(x)))}"]
            for name, lib in libs.items():
                ms = time_ms(lambda: run.launch(x, lib=lib))
                row.append(f"{name} {ms[0]:.4f}/{ms[1]:.4f}")
            print(f"[tier stages] {shape}: " + " | ".join(row), flush=True)
            clocked.fused_tier_features_clocks(ctypes.addressof(counts))   # reset
            for _ in range(10):
                run.launch(x, lib=clocked)
            torch.cuda.synchronize()
            if clocked.fused_tier_features_clocks(ctypes.addressof(counts)) != 0:
                raise SystemExit("reading the clock counters failed")
            total = sum(counts[:len(PHASES)])
            items = sum(counts[len(PHASES):])
            split = ", ".join(f"{name} {100.0 * c / max(items, 1):.1f} %" for name, c in zip(
                ("B fragments' wait", "products", "power stores"), counts[len(PHASES):]))
            print(f"[tier clocks] {shape}: share of a block's SM clocks by phase: " + ", ".join(
                f"{name} {100.0 * c / total:.1f} %" for name, c in zip(PHASES, counts))
                + f" ({total / 10:.4g} clocks a launch, summed over blocks); a warp's outer "
                f"DFT items at 1 pass: {split}", flush=True)
            ref = run(x)
            row = []
            for tile in (16, 8):
                try:
                    got = run.launch(x, tile_f=tile)
                except Exception as exc:   # a tile that does not fit is reported
                    row.append(f"tile {tile}: {type(exc).__name__}")
                    continue
                same = bool(torch.equal(got, ref))
                ms = time_ms(lambda: run.launch(x, tile_f=tile))
                row.append(f"tile {tile} {ms[0]:.4f}/{ms[1]:.4f}{'' if same else ' DIFFERS'}")
                if not same:
                    raise SystemExit(f"tile {tile} output differs from the default tile's")
            print(f"[tier tiles] {shape}: " + " | ".join(row) + f" | after: {clocks()}",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an older tree to time in turns with this one")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tier_stage_times: needs a GPU", file=sys.stderr)
        sys.exit(1)
    if args.worker:
        worker(args.worker)
        return
    if args.parent:
        a_b(args.parent)
    variants_and_tiles()


if __name__ == "__main__":
    main()
