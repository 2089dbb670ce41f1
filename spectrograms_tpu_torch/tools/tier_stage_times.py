"""Time the tier kernel's stages on one GPU, by compiling them out.

Run from the repository root::

    python3 -m spectrograms_tpu_torch.tools.tier_stage_times

``ncu`` is not available everywhere the kernel is measured, so this splits
``csrc/fused_tier_features.cu`` by subtraction: it builds variants of the
source with a stage compiled out (``SKIP_INNER``: the inner DFT into A;
``SKIP_OUTER``: the outer DFT into P; ``SKIP_TAIL``: filterbank, amplitude
and DCT), one ``nvcc`` each, all started together, into
``build/spectrograms_tpu_torch/stages/``. It then times each variant
through the normal runner (CUDA events, median of 30 after warm-up, the
L2 flushed before each run) at the flagship shape (1-pass Gauss, 1-pass
packed, x2) and on the chroma batch, with the f32 kernel's flagship time
as the yardstick of the call. A variant's output is meaningless; only its
time is read. Differences between variants are the stages' costs, up to
the overlap of blocks on an SM. The process's own build of the kernel,
and its launch count, are restored when the timings end.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

VARIANTS = {
    "full": [],
    "no_inner": ["SKIP_INNER"],
    "no_outer": ["SKIP_OUTER"],
    "no_tail": ["SKIP_TAIL"],
    "inner_only": ["SKIP_OUTER", "SKIP_TAIL"],
    "none": ["SKIP_INNER", "SKIP_OUTER", "SKIP_TAIL"],
}


def _insert(src: str, anchor: str, text: str, after: bool = True) -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"tier_stage_times: the kernel source changed; no single {anchor!r}")
    return src.replace(anchor, anchor + text if after else text + anchor)


def staged_source(src: str) -> str:
    """The kernel source with each stage behind a SKIP_* guard."""
    src = _insert(src, "int n, int b, int f0) {\n", "#ifdef SKIP_INNER\n  return;\n#endif\n")
    src = _insert(src, "int ldp, int c0, int n) {\n", "#ifdef SKIP_OUTER\n  return;\n#endif\n")
    src = _insert(src, "  // 2. Folded filterbank", "#ifndef SKIP_TAIL\n", after=False)
    src = _insert(src, "  if (!with_dct) return;  // uniform across the block\n",
                  "#endif\n#ifndef SKIP_TAIL\n")
    return _insert(src, "\n}\n\ntemplate <int R>\nint launch(", "\n#endif", after=False)


def time_ms(fn, reps: int = 30) -> float:
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> None:
    if not torch.cuda.is_available():
        print("tier_stage_times: needs a GPU", file=sys.stderr)
        sys.exit(1)
    import spectrograms_tpu_torch as tg
    from spectrograms_tpu_torch.mfcc import _dct_lifter_matrix
    from spectrograms_tpu_torch.ops import _build
    from spectrograms_tpu_torch.ops import fused_factored as ff
    from spectrograms_tpu_torch.ops.filterbanks import chroma_filterbank, mel_filterbank

    out = _build.BUILD_DIR / "stages"
    out.mkdir(parents=True, exist_ok=True)
    source = out / "fused_tier_features_staged.cu"
    source.write_text(staged_source((_build._CSRC / "fused_tier_features.cu").read_text()))
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    nvcc = _build.find_nvcc()
    jobs = {
        name: subprocess.Popen(
            [nvcc, *flags, *(f"-D{d}" for d in defs), "-o", str(out / f"lib{name}.so"),
             str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defs in VARIANTS.items()
    }
    libs = {}
    for name, job in jobs.items():
        log = job.communicate()[0]
        if job.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, (argtypes, restype) in ff._TIER_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib

    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((32, 160000)).astype(np.float32)).cuda()
    xc = torch.from_numpy(rng.standard_normal((64, 220500)).astype(np.float32)).cuda()
    mel = ff.KernelConst(mel_filterbank(16000.0, 1024, tg.MelParams(128, 0.0, 8000.0,
                                                                    tg.MelNorm.SLANEY)))
    dct = ff.KernelConst(_dct_lifter_matrix(128, 40, 22))
    chroma = ff.KernelConst(chroma_filterbank(44100.0, 4096, tg.ChromaParams()))
    hann = lambda n: tuple(tg.make_window(tg.WindowType.hanning, n).tolist())
    flagship = lambda **kw: ff.fused_factored_features(
        1024, 256, hann(1024), mel, amp="decibels", dct_key=dct, **kw)
    runs = {
        "flagship MFCC bf16 Gauss": (flagship(precision="bf16"), xb),
        "flagship MFCC bf16 packed": (flagship(precision="bf16", gauss=False), xb),
        "flagship MFCC bf16x2": (flagship(precision="bf16x2"), xb),
        "chroma 4096/1024 bf16 Gauss": (ff.fused_factored_features(
            4096, 1024, hann(4096), chroma, amp="power", pre_amp="magnitude",
            precision="bf16"), xc),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[tier stages] {card} | median ms of 30 per variant")
    # Each variant runs under the kernel's name for the length of its timing
    # only; the built kernel and the launch count are put back afterwards.
    saved_lib = _build._libs.get("fused_tier_features")
    saved_launches = ff.fused_tier_features.launches
    try:
        with torch.no_grad():
            for label, (run, x) in runs.items():
                row = []
                for name in VARIANTS:
                    _build._libs["fused_tier_features"] = libs[name]
                    row.append(f"{name} {time_ms(lambda: run(x)):.4f}")
                print(f"[tier stages] {label}: " + " | ".join(row), flush=True)
    finally:
        if saved_lib is None:
            _build._libs.pop("fused_tier_features", None)
        else:
            _build._libs["fused_tier_features"] = saved_lib
        ff.fused_tier_features.launches = saved_launches
    with torch.no_grad():
        f32 = flagship()
        print(f"[tier stages] f32 kernel, flagship MFCC: {time_ms(lambda: f32(xb)):.4f}")


if __name__ == "__main__":
    main()
