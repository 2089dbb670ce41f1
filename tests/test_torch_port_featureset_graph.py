"""``FeatureSet``'s CUDA graph: which calls replay, capture and run eagerly.

On the CPU the graph's CUDA calls (``featureset._cuda``) are replaced by a
fake recorder whose capture keeps the captured function and whose replay
runs it again on the static input, writing into the static outputs as a
graph would (and launching nothing from the host); CPU batches report
``is_cuda``, and the current stream and its capture state are the fake's:

- CPU batches never capture, and the counters stay 0;
- the second call in a row of a signature captures, later calls replay;
- another signature runs eagerly and keeps the graph, and two calls in a
  row with it replace the graph;
- the outputs of successive calls are fresh tensors;
- a capture that raises leaves its signature eager and is counted;
- batches that require grad and calls on a capturing stream run eagerly;
- callable members run after the plan members, results in member order;
- a replay on another stream first waits on the last replay's stream;
- threads sharing one set each get their own batch's answers;
- a new constants generation (``clear_fft_plan_cache``,
  ``plan_constants_from_numpy``) drops the graph, and the float32 matmul
  precision is part of the signature;
- a replay adds the kernels it runs to their ``.launches`` counters;
- a capture keeps the tensors made before it that the step reads (the
  cascade's cached band matrices), and none of its intermediates.

The tests marked ``card`` hold the graph against the eager step bit for bit
on config 4's set (``benchmarks/suite.py:155-243``) on the card, also after
the cached band matrices were evicted and their memory handed out again,
after ``clear_fft_plan_cache`` and after ``plan_constants_from_numpy``; run
a callable that reads a number back to the host after the replay, and hold
a plan member whose capture raises to the eager path; they skip without
CUDA. This file imports no JAX, so on a card ``python3 -m pytest
--noconftest tests/test_torch_port_featureset_graph.py -m card`` runs them.
"""

import sys
import threading
import weakref

import numpy as np
import pytest
import torch

import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch import featureset as fsm
from spectrograms_tpu_torch.ops import _build
from spectrograms_tpu_torch.ops import decimate as dec
from spectrograms_tpu_torch.ops import fused_factored as ff
from spectrograms_tpu_torch.mdct import _consts_for, _imdct_impl, _mdct_impl

SR = 44100.0
COUNTERS = ("graph_captures", "graph_replays", "graph_eager_steps", "graph_capture_failures")


def counters() -> dict:
    return {k: getattr(fsm, k) for k in COUNTERS}


def moved(before: dict) -> tuple:
    return tuple(getattr(fsm, k) - before[k] for k in COUNTERS)


class FakeStream:
    def __init__(self, name):
        self.name = name


class FakeCuda:
    """The seam's calls on CPU tensors: a capture keeps ``fn`` and its
    static input, a replay runs ``fn`` again into the static outputs."""

    def __init__(self):
        self.capturing_now = False
        self.fail = False
        self.current = FakeStream("s0")
        self.log = []

    def follow(self, cur, prev, x):
        self.log.append(("follow", cur.name, prev.name))

    def capture(self, fn, x):
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        static = x.clone()
        fn(static)
        self.log.append("capture")
        outs = fn(static)

        def replay():
            self.log.append("replay")
            before = _build.launch_counts()
            for o, n in zip(outs, fn(static)):
                o.copy_(n)
            # a graph's replay makes no launch call from the host
            _build.add_launches([b - a for a, b in zip(before, _build.launch_counts())], -1)

        return static, outs, replay, []


@pytest.fixture
def fake(monkeypatch):
    f = FakeCuda()
    monkeypatch.setattr(fsm, "_cuda", f)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: f.capturing_now)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: f.current)
    return f


def chroma_plan():
    return tg.ChromaPlan(tg.StftParams(4096, 1024), SR,
                         tg.ChromaParams.music_standard().with_multirate(),
                         dtype="float32", device="cpu")


def batch(seed, shape=(2, 22050)):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def doubled(b):
    return 2.0 * b


def test_cpu_batches_never_capture():
    fs = tg.FeatureSet([chroma_plan(), doubled])
    before = counters()
    for seed in (0, 0, 0, 1):
        got = fs.compute_batch(batch(seed))
        assert all(torch.equal(g, w) for g, w in zip(got, fs._step_impl(batch(seed))))
    assert fs.compute(batch(2)[0])[0].shape == (12, 22)
    assert moved(before) == (0, 0, 0, 0) and fs._graph is None


def test_second_call_in_a_row_captures_and_later_calls_replay(fake):
    fs = tg.FeatureSet([chroma_plan(), doubled])
    before = counters()
    for seed in (0, 1, 2, 3):
        x = batch(seed)
        got = fs.compute_batch(x)
        assert all(torch.equal(g, w) for g, w in zip(got, fs._step_impl(x)))
    assert moved(before) == (1, 3, 1, 0)
    assert fake.log == ["capture", "replay", "replay", "replay"]
    assert fs._graph.key[:3] == ((2, 22050), torch.float32, torch.device("cpu"))


def test_compute_on_one_signal_replays(fake):
    fs = tg.FeatureSet([chroma_plan()])
    before = counters()
    for seed in (0, 1, 2):
        x = batch(seed)[0]
        (got,) = fs.compute(x)
        assert torch.equal(got, fs._step_impl(x[None, :])[0][0])
    assert moved(before) == (1, 2, 1, 0)
    assert fs._graph.key[0] == (1, 22050)


def test_another_signature_runs_eagerly_until_it_repeats(fake):
    fs = tg.FeatureSet([chroma_plan()])
    a, b = (2, 22050), (3, 11025)
    before = counters()
    for shape, want in ((a, (0, 0, 1, 0)), (a, (1, 1, 1, 0)), (b, (1, 1, 2, 0)),
                        (a, (1, 2, 2, 0)), (b, (1, 2, 3, 0)), (b, (2, 3, 3, 0)),
                        (a, (2, 3, 4, 0)), (b, (2, 4, 4, 0))):
        x = batch(len(fake.log), shape)
        (got,) = fs.compute_batch(x)
        assert torch.equal(got, fs._step_impl(x)[0])
        assert moved(before) == want, shape
    assert fs._graph.key[0] == b


def test_outputs_of_successive_calls_do_not_alias(fake):
    fs = tg.FeatureSet([chroma_plan(), doubled])
    kept = [(batch(seed), fs.compute_batch(batch(seed))) for seed in range(4)]
    assert fake.log.count("replay") == 3
    ptrs = [o.data_ptr() for _, outs in kept for o in outs]
    assert len(set(ptrs)) == len(ptrs)
    assert not any(o.data_ptr() == s.data_ptr() for _, outs in kept for o in outs
                   for s in fs._graph.outs)
    for x, outs in kept:
        assert all(torch.equal(g, w) for g, w in zip(outs, fs._step_impl(x)))


def test_a_capture_that_raises_leaves_the_signature_eager(fake):
    fs = tg.FeatureSet([chroma_plan()])
    fake.fail = True
    before = counters()
    x = batch(0)
    fs.compute_batch(x)
    with pytest.warns(RuntimeWarning, match="capture"):
        (got,) = fs.compute_batch(x)
    assert torch.equal(got, fs._step_impl(x)[0])
    fake.fail = False
    for _ in range(3):
        fs.compute_batch(x)
    assert moved(before) == (0, 0, 5, 1) and fs._graph is None
    # another signature still captures
    fs.compute_batch(batch(1, (3, 11025)))
    fs.compute_batch(batch(2, (3, 11025)))
    assert moved(before) == (1, 1, 6, 1)


@pytest.mark.parametrize("why", ["requires_grad", "capturing"])
def test_grad_and_capturing_calls_run_eagerly(fake, why):
    fs = tg.FeatureSet([chroma_plan()])
    before = counters()
    for seed in range(3):
        x = batch(seed)
        if why == "requires_grad":
            x.requires_grad_(True)
        fake.capturing_now = why == "capturing"
        (got,) = fs.compute_batch(x)
        assert torch.equal(got.detach(), fs._step_impl(x.detach())[0])
        if why == "requires_grad":
            assert got.requires_grad
    assert moved(before) == (0, 0, 3, 0) and fake.log == [] and fs._graph is None
    fake.capturing_now = False
    x = batch(9)
    fs.compute_batch(x)
    fs.compute_batch(x)
    assert moved(before) == (1, 1, 4, 0)


class LoggedPlan:
    """A plan member with the FeatureSet hooks that logs its forwards."""

    def __init__(self, plan, log):
        self.plan, self.log = plan, log
        self._dtype, self.device = plan._dtype, plan.device

    def _fs_cascade_spec(self):
        return None

    def _fs_forward_batch(self, xb, cascade=None):
        self.log.append("plan")
        return self.plan._fs_forward_batch(xb, None)


def test_callables_run_after_the_plan_members_in_member_order(fake):
    log = fake.log

    def first(b):
        log.append("first")
        return b[:, :3]

    def last(b):
        log.append("last")
        return b.sum(dim=-1)

    plan = chroma_plan()
    fs = tg.FeatureSet([first, LoggedPlan(plan, log), last])
    x = batch(0)
    fs.compute_batch(x)
    assert log == ["plan", "first", "last"]
    del log[:]
    fs.compute_batch(x)
    # the warm-up and the capture run the plan, the replay runs it again
    assert log == ["plan", "capture", "plan", "replay", "plan", "first", "last"]
    del log[:]
    y = batch(1)
    got = fs.compute_batch(y)
    assert log == ["replay", "plan", "first", "last"]
    assert torch.equal(got[0], y[:, :3]) and torch.equal(got[2], y.sum(dim=-1))
    assert torch.equal(got[1], plan.compute_batch(y))


def test_a_replay_on_another_stream_waits_on_the_last_one(fake):
    fs = tg.FeatureSet([chroma_plan()])
    x = batch(0)
    for name in ("s0", "s0", "s0", "s1", "s1", "s0"):
        fake.current = FakeStream(name) if fake.current.name != name else fake.current
        fs.compute_batch(x)
    assert [e for e in fake.log if e[0] == "follow"] == [("follow", "s1", "s0"),
                                                         ("follow", "s0", "s1")]


def test_threads_sharing_one_set_get_their_own_answers(fake):
    fs = tg.FeatureSet([chroma_plan()])
    xs = [batch(seed) for seed in range(8)]
    want = [fs._step_impl(x)[0] for x in xs]
    fs.compute_batch(xs[0])
    fs.compute_batch(xs[0])
    errors = []

    def work(i):
        for k in range(6):
            j = (i + k) % len(xs)
            (got,) = fs.compute_batch(xs[j])
            if not torch.equal(got, want[j]):
                errors.append((i, j))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert fake.log.count("capture") == 1 and fake.log.count("replay") == 1 + 12 * 6


def test_a_new_constants_generation_drops_the_graph(fake):
    ch = chroma_plan()
    fs = tg.FeatureSet([ch])
    x = batch(0)
    (first,) = fs.compute_batch(x)
    fs.compute_batch(x)
    before = counters()
    tg.clear_fft_plan_cache()
    (got,) = fs.compute_batch(x)
    assert fs._graph is None and torch.equal(got, first)
    fs.compute_batch(x)
    assert moved(before) == (1, 1, 1, 0)
    # new constants in a member: no replay of the old graph, the new answers
    window = ch._mag_plan._window.double().numpy()
    fb = np.roll(ch._fb_t.T.double().numpy(), 1, axis=0)
    tg.plan_constants_from_numpy(ch, window=window, mapping=fb)
    (got,) = fs.compute_batch(x)
    assert fs._graph is None and moved(before) == (1, 1, 2, 0)
    assert torch.equal(got, fs._step_impl(x)[0]) and not torch.equal(got, first)
    for _ in range(2):
        (got,) = fs.compute_batch(x)
    assert moved(before) == (2, 3, 2, 0) and torch.equal(got, ch.compute_batch(x))


def test_the_matmul_precision_is_part_of_the_signature(fake):
    fs = tg.FeatureSet([chroma_plan()])
    x = batch(0)
    fs.compute_batch(x)
    fs.compute_batch(x)
    before = counters()
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        # the eager step's guard refuses TF32 matmuls; a replay must not hide it
        with pytest.raises(tg.InvalidInputError, match="TF32"):
            fs.compute_batch(x)
    finally:
        torch.set_float32_matmul_precision(old)
    fs.compute_batch(x)
    assert moved(before) == (0, 1, 1, 0) and fake.log.count("replay") == 2


class CountingPlan(LoggedPlan):
    """A plan member that counts a launch of the f32 kernel per forward."""

    def _fs_forward_batch(self, xb, cascade=None):
        ff.fused_factored_features.launches += 1
        return super()._fs_forward_batch(xb, cascade)


def test_a_replay_counts_the_kernels_it_runs(fake):
    fs = tg.FeatureSet([CountingPlan(chroma_plan(), []), doubled])
    before = ff.fused_factored_features.launches
    # the capture's warm-up runs the kernel once more; the capture itself runs nothing
    for seed, want in enumerate((1, 3, 4, 5, 6)):
        fs.compute_batch(batch(seed))
        assert ff.fused_factored_features.launches - before == want
    assert fs._graph.launched == (1, 0, 0, 0, 0, 0) and fake.log.count("replay") == 4


def test_the_reads_keep_what_was_made_before_and_no_intermediate(monkeypatch):
    made = []
    band_matrix = dec._band_matrix
    monkeypatch.setattr(dec, "_band_matrix", lambda *a: made.append(band_matrix(*a)) or made[-1])
    fs = tg.FeatureSet([chroma_plan()])
    x = batch(0)
    with fsm._Reads() as reads:
        (out,) = fs._plans_step(x)
    kept = {id(t) for t in reads.alive()}
    assert made and all(id(b) in kept for b in made)
    assert id(x) in kept and id(out) not in kept
    with fsm._Reads() as reads:
        y = x * 2.0
        z = (y + 1.0).sum()
    probe = weakref.ref(y)
    del y
    assert probe() is None and {id(t) for t in reads.alive()} == {id(x)}
    assert float(z) == pytest.approx(float((x * 2.0 + 1.0).sum()))


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def config4_set(dev):
    """Config 4's set: CQT-84 power, the multirate chroma, the MDCT round trip."""
    params = tg.SpectrogramParams(tg.StftParams(4096, 1024), SR)
    cq = tg.CqtPowerPlan(params, tg.CqtParams(12, 7, 32.703), dtype="float32", device=dev)
    ch = tg.ChromaPlan(params.stft, SR, tg.ChromaParams.music_standard().with_multirate(),
                       dtype="float32", device=dev)
    mp = tg.MdctParams.sine_window(512)

    def mdct_rt(b):
        fwd, inv = _consts_for(mp, False, b.dtype, b.device)
        c = _mdct_impl(b, fwd, mp.window_size, mp.hop_size)
        return _imdct_impl(c.transpose(-1, -2), inv, mp.window_size, mp.hop_size)[
            ..., : b.shape[-1]]

    return tg.FeatureSet([cq, ch, mdct_rt])


@pytest.mark.card
@pytest.mark.parametrize("shape", [(64, 220500), (16, 132300)], ids=["64x5s", "16x3s"])
def test_graph_equals_the_eager_step_on_the_card(card, shape):
    fs = config4_set(card)
    gen = torch.Generator(device=card).manual_seed(shape[0])
    xs = [torch.randn(shape, device=card, generator=gen) for _ in range(4)]
    before = counters()
    got = [fs.compute_batch(x) for x in xs]
    assert moved(before) == (1, 3, 1, 0)
    for x, g in zip(xs, got):
        want = fs._step_impl(x)
        for a, b in zip(g, want):
            assert a.shape == b.shape and torch.equal(a, b), float((a - b).abs().max())
    ptrs = [o.data_ptr() for g in got for o in g]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.card
def test_a_callable_that_syncs_runs_after_the_replay_on_the_card(card):
    params = tg.SpectrogramParams(tg.StftParams(4096, 1024), SR)
    ch = tg.ChromaPlan(params.stft, SR, tg.ChromaParams.music_standard().with_multirate(),
                       dtype="float32", device=card)

    def peak_normalised(b):
        return b / b.abs().max().item()

    fs = tg.FeatureSet([ch, peak_normalised])
    gen = torch.Generator(device=card).manual_seed(5)
    before = counters()
    for _ in range(3):
        x = torch.randn((8, 88200), device=card, generator=gen)
        got = fs.compute_batch(x)
        assert torch.equal(got[0], ch.compute_batch(x))
        assert torch.equal(got[1], x / x.abs().max().item())
    assert moved(before) == (1, 2, 1, 0)


class SyncingPlan:
    """A plan member whose forward reads a number back to the host, which a
    capture forbids."""

    def __init__(self, device):
        self._dtype, self.device = torch.float32, device

    def _fs_cascade_spec(self):
        return None

    def _fs_forward_batch(self, xb, cascade=None):
        return xb / xb.abs().max().item()


@pytest.mark.card
def test_a_plan_member_that_cannot_be_captured_stays_eager_on_the_card(card):
    fs = tg.FeatureSet([SyncingPlan(card)])
    gen = torch.Generator(device=card).manual_seed(6)
    before = counters()
    with pytest.warns(RuntimeWarning, match="capture"):
        for _ in range(4):
            x = torch.randn((4, 1000), device=card, generator=gen)
            (got,) = fs.compute_batch(x)
            assert torch.equal(got, x / x.abs().max().item())
    assert moved(before) == (0, 0, 4, 1) and fs._graph is None


def roll_chroma_filterbank(fs):
    """New constants in the set's chroma member: its filterbank's rows rolled by one."""
    ch = fs._members[1]
    window = ch._mag_plan._window.double().cpu().numpy()
    fb = np.roll(ch._fb_t.T.double().cpu().numpy(), 1, axis=0)
    tg.plan_constants_from_numpy(ch, window=window, mapping=fb)


@pytest.mark.card
@pytest.mark.parametrize("change", ["evicted", "cleared", "new_constants"])
def test_a_graph_after_a_change_of_host_state_equals_the_eager_step_on_the_card(card, change):
    """The cached band matrices evicted (no new generation: the graph's own
    references keep them), the public cache cleared, or new constants
    installed in a member; then memory of the same sizes handed out again
    and filled with NaN before the next replay."""
    fs = config4_set(card)
    gen = torch.Generator(device=card).manual_seed(7)
    xs = [torch.randn((16, 132300), device=card, generator=gen) for _ in range(4)]
    with fsm._Reads() as reads:
        fs._plans_step(xs[0])
    sizes = [t.numel() for t in reads.alive()]
    first = fs.compute_batch(xs[0])
    fs.compute_batch(xs[0])
    assert fs._graph is not None and sizes
    if change == "evicted":
        dec._band_matrix.cache_clear()
    elif change == "cleared":
        tg.clear_fft_plan_cache()
    else:
        roll_chroma_filterbank(fs)
    junk = [torch.full((n,), float("nan"), device=card) for n in sizes for _ in range(4)]
    before = counters()
    got = [fs.compute_batch(x) for x in xs]
    want = (0, 4, 0, 0) if change == "evicted" else (1, 3, 1, 0)
    assert moved(before) == want
    for x, g in zip(xs, got):
        for a, b in zip(g, fs._step_impl(x)):
            assert torch.equal(a, b), float((a - b).abs().max())
    assert torch.equal(got[0][1], first[1]) == (change != "new_constants")
    del junk
