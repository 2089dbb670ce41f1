"""loader_audio_s_per_s: the native loader alone over the cell's own corpus:
``AudioBatchLoader(...).iter_borrowed()`` with the cell's transport, no copy
and no compute. All audio over all the time of ``loader_passes`` passes after
one warm pass."""

import time


def measure(ctx):
    tr = ctx.traffic
    if tr.get("kind") != "wav" or not ctx.paths:
        return
    from spectrograms_tpu_torch.runtime import AudioBatchLoader

    n = int(round(tr["clip_s"] * tr["sr"]))
    audio = 0.0
    t0 = None
    for p in range(1 + int(tr["loader_passes"])):
        if p == 1:
            t0, audio = time.perf_counter(), 0.0
        loader = AudioBatchLoader(ctx.paths, int(tr["batch_size"]), n,
                                  expected_sample_rate=int(tr["sr"]), dtype=tr["transport"])
        for _, lengths, _ in loader.iter_borrowed():
            audio += float(lengths.sum()) / tr["sr"]
    ctx.extra["loader_audio_s_per_s"] = audio / (time.perf_counter() - t0)


def read(ctx):
    return ctx.extra.get("loader_audio_s_per_s")
