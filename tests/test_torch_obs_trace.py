"""The port's span tracer (``repro_torch.obs.trace``) on the CPU: the
card's clock through an injected event source and host clock, the
no-op off path, spans shown to ``torch.profiler``, the device track of
the Chrome export, the step's phase spans, the snapshot and recovery
spans, and the benchmark's five readers of those spans."""
import json
import os
import sys

import pytest
import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.core.lowdiff import LowDiff
from repro_torch.core.reusing_queue import ReusingQueue
from repro_torch.core.snapshot import SnapshotArena
from repro_torch.core.steps import init_state, make_train_step
from repro_torch.data.synthetic import make_batch
from repro_torch.models.registry import build_model
from repro_torch.obs import trace as tr
from repro_torch.obs.metrics import Counter
from repro_torch.obs.trace import TRACER, SpanTracer, trace_span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from chipbench import harness  # noqa: E402


# ------------------------------------------------------------ fakes
class Clock:
    """A host clock that reads ``now``."""

    def __init__(self, now: float = 100.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


class Event:
    def __init__(self, t: float):
        self.t = t
        self.complete = False


class DeviceClock:
    """A card whose clock reads ``now`` (its own origin and rate), whose
    events complete when ``finish()`` or ``wait`` says so."""

    def __init__(self, now: float = 5.0):
        self.now = now
        self.marks = []
        self.syncs = 0

    def ready(self) -> bool:
        return True

    def mark(self):
        ev = Event(self.now)
        self.marks.append(ev)
        return ev

    def synchronize(self) -> None:
        self.syncs += 1
        self.finish()

    def finish(self) -> None:
        for ev in self.marks:
            ev.complete = True

    def done(self, ev) -> bool:
        return ev.complete

    def wait(self, ev) -> None:
        """Completes ``ev`` and every event recorded before it."""
        for e in self.marks[:self.marks.index(ev) + 1]:
            e.complete = True

    def seconds(self, a, b) -> float:
        assert a.complete and b.complete
        return b.t - a.t


@pytest.fixture
def fake():
    clock, card = Clock(), DeviceClock()
    t = SpanTracer(enabled=True, clock=clock, device_clock=card)
    return t, clock, card


@pytest.fixture
def traced():
    TRACER.clear()
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.clear()


def _floats_only(attrs):
    return all(isinstance(v, (int, float, str)) for v in attrs.values())


# ------------------------------------------------------------ the clock
def test_anchor_maps_card_times_onto_the_host_clock(fake):
    t, clock, card = fake
    clock.now, card.now = 100.0, 5.0
    with t.span("a", device=True):
        card.now, clock.now = 5.5, 100.2      # the card lags the host
    assert card.syncs == 1                    # one anchor
    (_, _, _, _, t0, t1, attrs), = list(t._events)
    assert (t0, t1) == (100.0, 100.2)
    assert "dev_t0" not in attrs and len(t._pending) == 1  # not complete
    card.now = 6.25
    with t.span("b", device=True):
        card.now = 6.75
    assert card.syncs == 1
    events = t.events()                       # waits and resolves all
    assert not t._pending
    a, b = (e[6] for e in events)
    assert a["dev_t0"] == pytest.approx(100.0)
    assert a["dev_t1"] == pytest.approx(100.5)
    assert b["dev_t0"] == pytest.approx(101.25)
    assert b["dev_t1"] == pytest.approx(101.75)
    assert _floats_only(a) and _floats_only(b)


def test_complete_spans_resolve_at_the_next_exit(fake):
    t, _, card = fake
    with t.span("a", device=True):
        card.now += 1.0
    card.finish()
    with t.span("b", device=True):
        pass
    # "a" completed before "b" closed; "b" is still on the card
    assert len(t._pending) == 1 and t._pending[0][0] is t._events[1][6]
    assert "dev_t1" in t._events[0][6]
    assert "dev_t1" not in t._events[1][6]


def test_anchor_is_the_middle_of_its_read(fake):
    t, clock, card = fake

    wait = card.wait

    def slow_wait(ev):            # the host reads 2 ms across the wait
        wait(ev)
        clock.now += 0.002
    card.wait = slow_wait
    clock.now, card.now = 10.0, 0.0
    with t.span("a", device=True):
        pass
    assert t._anchor[1] == pytest.approx(10.001)


def test_anchor_keeps_the_narrowest_read(fake):
    t, clock, card = fake
    widths = iter([0.004, 0.001, 0.002])
    wait = card.wait

    def slow_wait(ev):
        wait(ev)
        clock.now += next(widths)
    card.wait = slow_wait
    clock.now = 10.0
    with t.span("a", device=True):
        pass
    # reads [10, 10.004], [10.004, 10.005], [10.005, 10.007]
    assert t._anchor[0] is card.marks[1]
    assert t._anchor[1] == pytest.approx(10.0045)


def test_clock_error_of_a_drifting_card(fake):
    t, clock, card = fake
    assert t.clock_error() is None            # no anchor yet
    clock.now, card.now = 0.0, 0.0
    with t.span("a", device=True):
        pass
    clock.now, card.now = 60.0, 60.0 * (1 + 2e-6)
    assert t.clock_error() == pytest.approx(120e-6)


def test_clear_drops_the_anchor_and_pending_events(fake):
    t, _, card = fake
    with t.span("a", device=True):
        pass
    t.clear()
    assert t._anchor is None and not t._pending and not t.events()
    with t.span("b", device=True):
        pass
    assert card.syncs == 2


def test_host_spans_take_no_card_event(fake):
    t, _, card = fake
    with t.span("a", "x", n=1):
        pass
    assert card.marks == [] and t.events()[0][6] == {"n": 1}


def test_device_option_does_nothing_on_the_cpu():
    t = SpanTracer(enabled=True)
    with t.span("a", device=True):
        pass
    assert t.events()[0][6] is None and t._anchor is None


# ------------------------------------------------------------ off path
def test_off_path_returns_the_shared_noop():
    assert not TRACER.enabled
    assert trace_span("step", "step", device=True) is tr._NOOP
    assert SpanTracer().span("x", device=True) is tr._NOOP
    with trace_span("step", device=True) as sp:
        sp.set(n=1)
    assert len(TRACER) == 0


# ------------------------------------------------------------ export
def test_chrome_export_puts_card_intervals_on_their_own_track(fake):
    t, clock, card = fake
    clock.now, card.now = 1.0, 0.0
    with t.span("step", "step", device=True):
        clock.now, card.now = 1.5, 0.25
    with t.span("persist.full", "persist"):
        clock.now = 2.0
    doc = t.to_chrome()
    json.dumps(doc)                           # plain JSON: no live events
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    dev = [e for e in xs if e["tid"] == "device"]
    host = [e for e in xs if e["tid"] != "device"]
    assert [e["name"] for e in host] == ["step", "persist.full"]
    assert [e["name"] for e in dev] == ["step"]
    assert dev[0]["ts"] == pytest.approx(1e6)
    assert dev[0]["dur"] == pytest.approx(0.25e6)
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert names["device"] == "device"


# ------------------------------------------------------------ the step
def _tiny(accum: int = 1):
    cfg = get_config("gpt2-l").reduced().replace(grad_accum=accum)
    return cfg, build_model(cfg)


def _step_spans(mode: str, accum: int = 1, steps: int = 1):
    cfg, model = _tiny(accum)
    state = init_state(model, 0, mode=mode, device="cpu")
    step = make_train_step(model, mode=mode)
    for i in range(steps):
        state = step(state, make_batch(cfg, 16, 2, step=i))[0]
    return [(e[0], e[4], e[5]) for e in TRACER.events()]


@pytest.mark.parametrize("mode,accum,phases", [
    ("lowdiff", 1, ["step.forward", "step.backward", "step.compress",
                    "step.apply"]),
    ("dense", 1, ["step.forward", "step.backward", "step.apply"]),
    ("lowdiff_plus", 1, ["step.forward", "step.backward", "step.apply"]),
    ("lowdiff", 2, ["step.forward", "step.backward", "step.forward",
                    "step.backward", "step.compress", "step.apply"]),
])
def test_step_emits_its_phases_nested_in_order(traced, mode, accum,
                                                phases):
    spans = _step_spans(mode, accum)
    (_, s0, s1), = [s for s in spans if s[0] == "step"]
    inner = sorted((s for s in spans if s[0].startswith("step.")),
                   key=lambda s: s[1])
    assert [s[0] for s in inner] == phases
    assert all(s0 <= a <= b <= s1 for _, a, b in inner)
    assert all(x[2] <= y[1] for x, y in zip(inner, inner[1:]))


def test_step_phases_under_the_profiler_enclose_their_ops(traced,
                                                          tmp_path):
    from torch.profiler import ProfilerActivity, profile
    cfg, model = _tiny()
    state = init_state(model, 0, mode="dense", device="cpu")
    step = make_train_step(model, mode="dense")
    batch = make_batch(cfg, 16, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert {"step", "step.forward", "step.backward",
            "step.apply"} <= set(notes)
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]

    def inside(name):
        n = notes[name]
        return [o["name"] for o in ops if o["tid"] == n["tid"]
                and n["ts"] <= o["ts"]
                and o["ts"] + o["dur"] <= n["ts"] + n["dur"]]
    fwd, bwd, app = (inside(n) for n in ("step.forward", "step.backward",
                                         "step.apply"))
    assert "aten::mm" in fwd or "aten::matmul" in fwd
    assert bwd and app
    step_note = notes["step"]
    for name in ("step.forward", "step.backward", "step.apply"):
        n = notes[name]
        assert step_note["ts"] <= n["ts"]
        assert n["ts"] + n["dur"] <= step_note["ts"] + step_note["dur"]
    # off the profiler, a span enters no record_function
    with TRACER.span("step") as sp:
        assert sp._rf is None


# ------------------------------------------------------------ LowDiff
def _lowdiff(tmp_path, steps: int):
    cfg, model = _tiny()
    strat = LowDiff(model, CheckpointStore(str(tmp_path)), full_interval=2,
                    batch_size=1, device="cpu")
    state = init_state(model, 0, device="cpu")
    for i in range(steps):
        state, _ = strat.train_step(state, make_batch(cfg, 16, 2, step=i))
    strat.flush()
    return strat


def test_lowdiff_tags_snapshot_d2h_by_kind(traced, tmp_path):
    strat = _lowdiff(tmp_path, 3)
    try:
        spans = TRACER.events()
        kinds = sorted(a.get("kind") for n, *_, a in
                       ((e[0], e[6] or {}) for e in spans)
                       if n == "snapshot.d2h")
        assert kinds == ["diff", "diff", "diff", "full"]
        assert [e[0] for e in spans].count("lowdiff.handoff") == 3
        for e in spans:
            if e[0] == "snapshot.d2h":
                assert {"shards", "bytes", "wait_ms", "kind"} <= set(e[6])
    finally:
        strat.close()


def test_recovery_spans_upload_and_replay(tmp_path):
    strat = _lowdiff(tmp_path, 3)
    try:
        TRACER.clear()
        TRACER.enable()
        strat.recover()
        spans = {e[0]: e for e in TRACER.events()}
    finally:
        TRACER.disable()
        TRACER.clear()
        strat.close()
    up, rep = spans["recovery.upload"], spans["recovery.replay"]
    assert up[6]["bytes"] > 0
    assert rep[4] <= up[4] <= up[5] <= rep[5]


# ------------------------------------------------------------ instruments
def test_queue_put_block_time_is_a_counter_of_seconds():
    q = ReusingQueue(maxsize=4)
    assert q.stats()["put_block_time"] == 0.0
    blocked = q.put(1, "a") + q.put(2, "b")
    assert q.put_block_time == pytest.approx(blocked)
    assert q.stats()["put_block_time"] == q.put_block_time
    assert isinstance(q.instruments().get("put_block_time"), Counter)


def test_snapshot_arena_keeps_no_stall_histogram():
    arena = SnapshotArena(slots=1)
    assert arena.instruments().keys() == ["snapshots", "stalls"]
    assert arena.stats() == {"slots": 1, "snapshots": 0, "stalls": 0}


# ------------------------------------------------------------ readers
def _reader(name: str):
    path = os.path.join(ROOT, "chipbench", "layer_metrics", f"{name}.py")
    return harness._load(path, "test_reader_" + name.replace(".", "_"))


def _dev(t0, t1, **kw):
    return dict(kw, dev_t0=t0, dev_t1=t1)


#: two window steps on the card clock, and two fulls' copies
SPANS = [
    ("step", 0.0, 0.5, _dev(0.1, 0.9)),
    ("step.forward", 0.0, 0.1, _dev(0.1, 0.3)),
    ("step.backward", 0.1, 0.3, _dev(0.3, 0.7)),
    ("step.compress", 0.3, 0.4, _dev(0.7, 0.75)),
    ("step.apply", 0.4, 0.5, _dev(0.75, 0.85)),
    ("step", 1.0, 1.3, _dev(1.1, 1.9)),
    ("step.forward", 1.0, 1.1, _dev(1.1, 1.3)),
    ("step.backward", 1.1, 1.2, _dev(1.3, 1.7)),
    ("step.compress", 1.2, 1.25, _dev(1.7, 1.8)),
    ("step.apply", 1.25, 1.3, _dev(1.8, 1.9)),
    ("snapshot.d2h", 0.2, 3.2, {"kind": "full", "bytes": 8}),
    ("snapshot.d2h", 0.3, 0.31, {"kind": "diff", "bytes": 1}),
    ("snapshot.d2h", 1.0, 5.0, {"kind": "full", "bytes": 8}),
]
WANT = {"dispatch_ms.train": 400.0, "fwd_bwd_ms.train": 600.0,
        "compress_ms.train": 75.0, "apply_ms.train": 100.0,
        "full_d2h_s.train": 3.5}


def _run(spans, kind="train"):
    return harness.Run(kind=kind, e2e={"step_ms": 1000.0, "setup_s": 1.0},
                       attempted=2, failed=0, memory_peak_bytes=0,
                       numbers={}, units=2, spans=spans)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_spans(name):
    assert _reader(name).read(_run(SPANS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_is_none_without_its_spans(name):
    read = _reader(name).read
    assert read(_run([])) is None
    assert read(_run(SPANS, kind="recover")) is None


@pytest.mark.parametrize("name", ["fwd_bwd_ms.train", "compress_ms.train",
                                  "apply_ms.train"])
def test_card_reader_is_none_without_card_times(name):
    host_only = [(n, a, b, {}) for n, a, b, _ in SPANS]
    assert _reader(name).read(_run(host_only)) is None


def test_full_d2h_reader_is_none_on_the_wrong_kind():
    read = _reader("full_d2h_s.train").read
    diffs = [s for s in SPANS if s[3].get("kind") != "full"]
    untagged = [(n, a, b, {}) for n, a, b, _ in SPANS]
    assert read(_run(diffs)) is None
    assert read(_run(untagged)) is None
