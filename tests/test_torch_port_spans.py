"""The port's named spans (``spectrograms_tpu_torch.spans``), on the CPU.

- off: with no profiler recording, no ``tg.*`` span calls
  ``record_function`` (patched to raise) on the flagship entry points, and
  ``span`` hands back one shared object;
- on, under ``profiling.trace(device="cpu")`` or a bare ``torch.profiler``
  session: each span appears the expected number of times a call or a
  batch, nested where it should be (members in order inside
  ``tg.plan.FeatureSet``, ``tg.op.mfcc.delta`` under no plan when called
  alone, the four ``tg.pipeline.*`` spans once a batch) and a kernel
  launch in ``tg.kernel.<source>`` beside its ``.launches`` count.
"""

import json

import numpy as np
import pytest
import torch

import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch import profiling, spans
from spectrograms_tpu_torch.mdct import _consts_for, _imdct_impl, _mdct_impl
from spectrograms_tpu_torch.ops import fused_factored

SR = 16000.0


def mfcc_plan():
    return tg.MfccPlan(tg.StftParams(512, 128), SR, mel_params=tg.MelParams(40, 0.0, 8000.0),
                       mfcc_params=tg.MfccParams(13), dtype="float32", device="cpu")


def chroma_plan():
    return tg.ChromaPlan(tg.StftParams(2048, 512), 44100.0,
                         tg.ChromaParams.music_standard().with_multirate(),
                         dtype="float32", device="cpu")


def mdct_rt(b):
    """The MDCT round trip, as a callable member."""
    mp = tg.MdctParams.sine_window(256)
    fwd, inv = _consts_for(mp, False, b.dtype, b.device)
    c = _mdct_impl(b, fwd, mp.window_size, mp.hop_size)
    return _imdct_impl(c.transpose(-1, -2), inv, mp.window_size, mp.hop_size)[..., : b.shape[-1]]


def feature_set():
    return tg.FeatureSet([mfcc_plan(), chroma_plan(), mdct_rt])


@pytest.fixture(scope="module")
def xb():
    return torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8000)).astype(np.float32))


def clips(n=5):
    rng = np.random.default_rng(1)
    return [(0.1 * rng.standard_normal(int(SR * (0.5 + 0.1 * i)))).astype(np.float32)
            for i in range(n)]


def run_pipeline(plan, preload=False):
    pipe = tg.FeaturePipeline(plan, batch_size=2, target_seconds=1.0, transport="int16")
    return list(pipe.run_arrays(clips(), sample_rates=SR, preload=preload))


CALLS = {
    "MfccPlan.compute_batch": lambda x: mfcc_plan().compute_batch(x),
    "FeatureSet.compute_batch": lambda x: feature_set().compute_batch(x),
    "delta": lambda x: tg.delta(x[:, :400].reshape(2, 4, 100)),
    "FeaturePipeline.run_arrays": lambda x: run_pipeline(mfcc_plan()),
}


def tg_spans(path) -> list:
    """(name, start, end, tid) of every ``tg.*`` span of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e.get("tid")) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("tg.")), key=lambda s: (s[1], -s[2]))


def traced(tmp_path, fn, *args):
    with profiling.trace(str(tmp_path), device="cpu") as tr:
        out = fn(*args)
    return out, tg_spans(tr.path)


def names(found, prefix="tg."):
    return [s[0] for s in found if s[0].startswith(prefix)]


def inside(a, b) -> bool:
    return a[3] == b[3] and b[1] <= a[1] and a[2] <= b[2]


# ---- off ------------------------------------------------------------------------------

@pytest.mark.parametrize("call", list(CALLS), ids=list(CALLS))
def test_no_span_records_while_no_profiler_runs(monkeypatch, xb, call):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    CALLS[call](xb)


def test_span_off_is_one_shared_no_op():
    first, second = spans.span("tg.a"), spans.span("tg.b")
    assert first is second
    with first as value:
        assert value is None
    assert profiling.span is spans.span


# ---- on -------------------------------------------------------------------------------

def test_plan_span_once_a_call(tmp_path, xb):
    plan = mfcc_plan()

    def three():
        for _ in range(3):
            plan.compute_batch(xb)
        plan.compute(xb[0])

    _, found = traced(tmp_path, three)
    assert names(found, "tg.plan.") == ["tg.plan.MfccPlan"] * 4
    # the CPU runs the plain route, inside the plan's span
    ops = [s for s in found if s[0] == "tg.op.mfcc._plain_forward"]
    plans = [s for s in found if s[0] == "tg.plan.MfccPlan"]
    assert len(ops) == 4 and all(any(inside(o, p) for p in plans) for o in ops)


def test_typed_plan_span_names_its_class(tmp_path, xb):
    plan = tg.MelDbPlan(tg.SpectrogramParams(tg.StftParams(512, 128), SR),
                        tg.MelParams(40, 0.0, 8000.0), tg.LogParams(-80.0), device="cpu")
    _, found = traced(tmp_path, plan.compute_batch, xb)
    assert names(found, "tg.plan.") == ["tg.plan.MelDbPlan"]
    assert "tg.op.pipeline._forward_impl" in names(found)


def test_members_in_order_inside_the_feature_set(tmp_path, xb):
    fs = feature_set()
    _, found = traced(tmp_path, lambda: [fs.compute_batch(xb) for _ in range(2)])
    sets = [s for s in found if s[0] == "tg.plan.FeatureSet"]
    members = [s for s in found if s[0].startswith("tg.member.")]
    assert len(sets) == 2
    for fset in sets:
        mine = [m[0] for m in members if inside(m, fset)]
        assert mine == ["tg.member.MfccPlan", "tg.member.ChromaPlan", "tg.member.mdct_rt"]
    # the op spans of each member nest inside it
    for op, member in (("tg.op.chroma._normalize", "tg.member.ChromaPlan"),
                       ("tg.op.mdct._mdct_impl", "tg.member.mdct_rt"),
                       ("tg.op.mdct._imdct_impl", "tg.member.mdct_rt")):
        outer = [s for s in found if s[0] == member]
        got = [s for s in found if s[0] == op]
        assert len(got) == 2 and all(any(inside(g, o) for o in outer) for g in got), op


def test_delta_alone_nests_under_no_plan(tmp_path, xb):
    feats = xb[:, :400].reshape(2, 4, 100)
    _, found = traced(tmp_path, lambda: [tg.delta(feats, 9, o) for o in (1, 2)])
    assert names(found) == ["tg.op.mfcc.delta"] * 2


@pytest.mark.parametrize("preload", [False, True], ids=["serial", "preload"])
def test_pipeline_spans_once_a_batch(tmp_path, preload):
    batches, found = traced(tmp_path, run_pipeline, mfcc_plan(), preload)
    n = len(batches)
    assert n == 3
    for name in ("tg.pipeline.upload", "tg.pipeline.step", "tg.pipeline.batch",
                 "tg.plan.MfccPlan"):
        assert names(found).count(name) == n, name
    # one wait a batch, and the last one finds the loader done
    assert names(found).count("tg.pipeline.loader_wait") == n + 1
    steps = [s for s in found if s[0] == "tg.pipeline.step"]
    plans = [s for s in found if s[0] == "tg.plan.MfccPlan"]
    assert all(any(inside(p, s) for s in steps) for p in plans)
    # the four pipeline spans are siblings: none nests in another
    pipe = [s for s in found if s[0].startswith("tg.pipeline.")]
    assert not any(inside(a, b) for a in pipe for b in pipe if a is not b)


def test_pipeline_of_a_feature_set_spans_each_member(tmp_path):
    fs = tg.FeatureSet([mfcc_plan(), mdct_rt])
    batches, found = traced(tmp_path, run_pipeline, fs)
    n = len(batches)
    assert names(found).count("tg.plan.FeatureSet") == n
    assert names(found, "tg.member.") == ["tg.member.MfccPlan", "tg.member.mdct_rt"] * n


def test_any_profiler_session_records_the_spans(xb):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mfcc_plan().compute_batch(xb)
    found = {e.name for e in prof.events()}
    assert {"tg.plan.MfccPlan", "tg.op.mfcc._plain_forward"} <= found


def test_kernel_launch_is_one_span_beside_its_count(tmp_path):
    """The runner's launch path (a device other than the CPU), with a
    stand-in launch that counts as the kernel's own does."""
    dev = torch.device("meta")

    def launch(xb):
        fused_factored.fused_factored_features.launches += 1
        return torch.empty((xb.shape[0], 4, 2), device=xb.device)

    run = fused_factored._runner(dev, None, launch, "fused_features")
    x = torch.empty((2, 64), device=dev)
    before = fused_factored.fused_factored_features.launches
    _, found = traced(tmp_path, lambda: [run(x), run(x[0]), run(x)])
    assert names(found) == ["tg.kernel.fused_features"] * 3
    assert fused_factored.fused_factored_features.launches - before == 3
