"""Time the f32 kernel (``csrc/fused_features.cu``) on one GPU: against an
older tree's, by stage, and by tile.

Run from the repository root::

    python3 spectrograms_tpu_torch/tools/f32_kernel_times.py [--parent DIR]

With ``--parent DIR`` (an unpacked older tree of this repository, e.g. from
``git archive``) it times that tree's kernel and this tree's in turns,
parent, this, this, parent, each in a process of its own that imports the
package from its tree and builds its kernel there. Then, in this process,
it times stage variants of this tree's source, built with a stage compiled
out (``FUSED_SKIP_FFT``: the radix passes; ``FUSED_SKIP_TAIL``: filterbank,
amplitude and DCT; both; ``FUSED_SKIP_DCT``: the DCT) or a register cap
(``FUSED_MIN_BLOCKS``), each loaded through its own ``ctypes`` handle and
launched through the runner's ``launch(x, lib=...)``, which does not count
such launches; and the kernel at each tile that fits (``launch(x,
tile_f=...)``), checked bit-equal to the default tile's output. A stage
variant's output is meaningless; only its time is read.

Shapes: the flagship MFCC batch (32 x 160000, 1024/256, mel-128 dB, DCT-40)
and the chroma batch (64 x 220500, 4096/1024, 44.1 kHz, pre_amp
magnitude), white noise from seed 0. Times: CUDA events, median and p90 of
100 after warm-up, the L2 flushed and the device held in a ~1 ms spin before
each run, so that the host's enqueue stays out of the reading.
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
    "no_fft": ["FUSED_SKIP_FFT"],
    "no_tail": ["FUSED_SKIP_TAIL"],
    "neither": ["FUSED_SKIP_FFT", "FUSED_SKIP_TAIL"],
    "no_dct": ["FUSED_SKIP_DCT"],
    "blocks2": ["FUSED_MIN_BLOCKS=2"],
    "blocks3": ["FUSED_MIN_BLOCKS=3"],
    "blocks4": ["FUSED_MIN_BLOCKS=4"],
}


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


def runners():
    """{shape: (runner, input)} of the package imported now."""
    import spectrograms_tpu_torch as tg
    from spectrograms_tpu_torch.mfcc import _dct_lifter_matrix
    from spectrograms_tpu_torch.ops import fused_factored as ff
    from spectrograms_tpu_torch.ops.filterbanks import chroma_filterbank, mel_filterbank

    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((32, 160000)).astype(np.float32)).cuda()
    xc = torch.from_numpy(rng.standard_normal((64, 220500)).astype(np.float32)).cuda()
    hann = lambda n: tuple(tg.make_window(tg.WindowType.hanning, n).tolist())
    mel = mel_filterbank(16000.0, 1024, tg.MelParams(128, 0.0, 8000.0, tg.MelNorm.SLANEY))
    return {
        "flagship": (ff.fused_factored_features(
            1024, 256, hann(1024), ff.KernelConst(mel), amp="decibels",
            dct_key=ff.KernelConst(_dct_lifter_matrix(128, 40, 22))), xb),
        "chroma": (ff.fused_factored_features(
            4096, 1024, hann(4096),
            ff.KernelConst(chroma_filterbank(44100.0, 4096, tg.ChromaParams())),
            amp="power", pre_amp="magnitude"), xc),
    }


def worker(root: str) -> None:
    """Time the kernel of the tree at ``root``; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    import spectrograms_tpu_torch

    times = {}
    with torch.no_grad():
        for shape, (run, x) in runners().items():
            times[shape] = time_ms(lambda: run(x))
    print(json.dumps({"root": root, "package": spectrograms_tpu_torch.__file__,
                      "card": card(), "clocks": clocks(), **times}), flush=True)


def stages_and_tiles() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from spectrograms_tpu_torch.ops import _build
    from spectrograms_tpu_torch.ops import f32_layout as fl32
    from spectrograms_tpu_torch.ops import fused_factored as ff

    out = _build.BUILD_DIR / "f32_stages"
    out.mkdir(parents=True, exist_ok=True)
    source = _build._CSRC / "fused_features.cu"
    flags = list(_build.NVCC_FLAGS)
    nvcc = _build.find_nvcc()
    jobs = {name: subprocess.Popen(
        [nvcc, *flags, *(f"-D{d}" for d in defs), "-o", str(out / f"lib{name}.so"), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defs in VARIANTS.items()}
    libs = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        words = [line.split() for line in log.splitlines() if "registers" in line]
        regs = sorted({int(w) for ws in words for w, nxt in zip(ws, ws[1:])
                       if nxt.startswith("registers")})
        print(f"[f32 variants] {name}: registers {regs}", flush=True)
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, (argtypes, restype) in ff._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib

    print(f"[f32 stages] {card()} | median/p90 ms of 100", flush=True)
    with torch.no_grad():
        for shape, (run, x) in runners().items():
            row = [f"full {'/'.join(f'{v:.4f}' for v in time_ms(lambda: run(x)))}"]
            for name, lib in libs.items():
                ms = time_ms(lambda: run.launch(x, lib=lib))
                row.append(f"{name} {ms[0]:.4f}/{ms[1]:.4f}")
                if name.startswith("blocks"):
                    ms = time_ms(lambda: run.launch(x, lib=lib, tile_f=run.tile_f // 2))
                    row.append(f"{name} at tile {run.tile_f // 2} {ms[0]:.4f}/{ms[1]:.4f}")
            print(f"[f32 stages] {shape}: " + " | ".join(row), flush=True)
            ref = run(x)
            n_fft = 1024 if shape == "flagship" else 4096
            row = []
            tile = fl32.MAX_THREADS // (n_fft // 16)
            while tile >= 1:
                got = run.launch(x, tile_f=tile)
                same = bool(torch.equal(got, ref))
                ms = time_ms(lambda: run.launch(x, tile_f=tile))
                row.append(f"tile {tile} {ms[0]:.4f}/{ms[1]:.4f}{'' if same else ' DIFFERS'}")
                if not same:
                    raise SystemExit(f"tile {tile} output differs from the default tile's")
                tile //= 2
            print(f"[f32 tiles] {shape}: " + " | ".join(row) + f" | after: {clocks()}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an older tree to time in turns with this one")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("f32_kernel_times: needs a GPU", file=sys.stderr)
        sys.exit(1)
    if args.worker:
        worker(args.worker)
        return
    if args.parent:
        here = str(Path(__file__).resolve().parents[2])
        results = []
        for label, root in (("parent", args.parent), ("change", here),
                            ("change", here), ("parent", args.parent)):
            proc = subprocess.run([sys.executable, __file__, "--worker", root],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise SystemExit(f"{label} run failed:\n{proc.stdout}\n{proc.stderr}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            results.append((label, res))
            print(f"[f32 a/b] {label} ({res['card']}): flagship {res['flagship'][0]:.4f}/"
                  f"{res['flagship'][1]:.4f} ms, chroma {res['chroma'][0]:.4f}/"
                  f"{res['chroma'][1]:.4f} ms (median/p90 of 100) | after: {res['clocks']}",
                  flush=True)
        for shape in ("flagship", "chroma"):
            par = [r[shape][0] for label, r in results if label == "parent"]
            chg = [r[shape][0] for label, r in results if label == "change"]
            print(f"[f32 a/b] {shape}: parent/change median ratio "
                  f"{np.mean(par) / np.mean(chg):.2f} (parent {par}, change {chg})", flush=True)
    stages_and_tiles()


if __name__ == "__main__":
    main()
