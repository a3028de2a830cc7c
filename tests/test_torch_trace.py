"""The port's span recorder (`benlsip_tpu_torch._trace`) on the CPU: the
span tree of a fused call (the stages run as plain calls, so every span is
timed on the host, and a stage's device interval is its host interval);
the fallback's spans; nothing kept and no CUDA event made while the
recorder is off; the plain and overlapped routes' spans; set-up spans kept
apart and always; the device path (events, the pool, lazy resolution, the
anchor) against fake CUDA events; and the split of a window into device
and idle time on synthetic spans."""
import contextlib
import types

import pytest
import torch

from benlsip_tpu_torch import _loops, _trace
from benlsip_tpu_torch.batch import fused_small
from benlsip_tpu_torch.batch.refine import solve_mixed_precision
from benlsip_tpu_torch.problems.generators import dense_quadratic_family, exp_fit_family
from benlsip_tpu_torch.solver.options import SolverOptions

torch.set_num_threads(2)
OPTS = SolverOptions(max_outer_iter=30, max_inner_iter=100)
MS = 1_000_000   # ns


@pytest.fixture(autouse=True)
def recorder_off():
    _trace.disable()
    _trace.reset()
    yield
    _trace.disable()
    _trace.reset()


@pytest.fixture(scope="module")
def dense():
    # A densequad-like batch at a CPU size: two chunks of 2.
    return dense_quadratic_family(4, n=24, d=64, m=2, seed=1, device="cpu")


@contextlib.contextmanager
def recording():
    _trace.enable()
    _trace.reset()
    try:
        yield _trace.spans
    finally:
        _trace.disable()


def _inside(child, parent):
    return parent.t0 <= child.t0 and child.t1 <= parent.t1


def test_fused_call_span_tree(dense):
    bp, th, X0 = dense
    solve_mixed_precision(bp, th, X0, OPTS, chunk=2, fuse=True)   # the pipeline's buffers made
    with recording() as spans:
        for _ in range(2):
            solve_mixed_precision(bp, th, X0, OPTS, chunk=2, fuse=True)
    got = spans()
    calls = [s for s in got if s.name == "call"]
    assert len(calls) == 2 and calls[0].call != calls[1].call and all(s.parent is None for s in calls)
    for call in calls:
        tree = [s for s in got if s.call == call.call and s is not call]
        assert [(s.name, s.attrs) for s in tree] == [
            ("load", None), ("bulk", {"rows": 2}), ("bulk", {"rows": 2}), ("cert", None), ("finish", None)]
        assert call.attrs == {"rows": 4}
        for s in tree:
            assert s.parent == call.id and _inside(s, call)
            # Host-timed only: no event; on the CPU a stage's device work is its host interval.
            assert s._events is None and s.d0 is None
            assert s.device == ((s.t0, s.t1) if s.name != "finish" else None)
        assert [s.t0 for s in tree] == sorted(s.t0 for s in tree)
    assert call.device is None


def test_forced_fallback_lane_gives_a_fallback_span(dense, monkeypatch):
    # One lane left uncertified by the polish goes to the full f64 refine.
    bp, th, X0 = dense
    finish = fused_small.finish_polish

    def one_lane_uncertified(bp64, theta64, polished, *a, **k):
        ok = polished[2].clone()
        ok[0] = False
        return finish(bp64, theta64, [*polished[:2], ok, *polished[3:]], *a, **k)

    monkeypatch.setattr(fused_small, "finish_polish", one_lane_uncertified)
    with recording() as spans:
        X, _, info = solve_mixed_precision(bp, th, X0, OPTS, chunk=2, fuse=True)
    assert int(info.outer_iters[0]) > 0 and bool(info.converged.all())
    by_name = {s.name: s for s in spans()}
    fallback, finish_span, refine = by_name["fallback"], by_name["finish"], by_name["refine"]
    assert fallback.attrs == {"lanes": 1} and fallback.parent == finish_span.id and _inside(fallback, finish_span)
    assert refine.attrs == {"lanes": 1} and refine.parent == fallback.id and _inside(refine, fallback)
    assert fallback.device is None and refine.device is None


def test_off_keeps_nothing_and_makes_no_event(dense, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.cuda.Event made while the recorder is off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    bp, th, X0 = dense
    n_setup = len(_trace.setup_spans())
    solve_mixed_precision(bp, th, X0, OPTS, chunk=2, fuse=True)
    exp_bp, exp_th, exp_X0 = exp_fit_family(8, d=16, seed=2, device="cpu")
    solve_mixed_precision(exp_bp, exp_th, exp_X0, OPTS, chunk=4, pipeline_overlap=True)
    assert not _trace.ON and _trace.spans() == [] and len(_trace.setup_spans()) == n_setup
    # A site gets the one shared no-op.
    assert _trace.span("bulk", torch.device("cpu"), rows=2) is _trace.call(rows=2) is _trace._NULL


@pytest.mark.parametrize("route", ["plain", "overlap"])
def test_plain_and_overlapped_route_spans(route):
    bp, th, X0 = exp_fit_family(12, d=16, seed=2, device="cpu")
    with recording() as spans:
        solve_mixed_precision(bp, th, X0, OPTS, chunk=8, pipeline_overlap=route == "overlap")
    got = spans()
    (call,) = [s for s in got if s.name == "call"]
    bulks = [s for s in got if s.name == "bulk"]
    certs = [s for s in got if s.name == "certify"]
    rows = [12] if route == "plain" else [8, 4]
    assert [s.attrs["rows"] for s in bulks] == [s.attrs["rows"] for s in certs] == rows
    for bulk, cert in zip(bulks, certs):
        # The overlap certifies chunk i on its worker thread, under the call's root span.
        assert bulk.parent == cert.parent == call.id and bulk.call == cert.call == call.call
        assert _inside(bulk, call) and _inside(cert, call) and bulk.t1 <= cert.t0
        assert bulk.device is None and cert.device is None
    # Each certification ends in the polish's finish.
    finishes = [s for s in got if s.name == "finish"]
    assert len(finishes) == len(certs) and all(f.parent in {c.id for c in certs} for f in finishes)


def test_setup_spans_are_kept_always_and_apart():
    n = len(_trace.setup_spans())
    with _trace.setup_span("capture", stage="bulk") as sp:
        with _trace.span("bulk", torch.device("cpu")):
            pass
    assert _trace.spans() == [] and _trace.setup_spans()[n:] == [sp] and sp.attrs == {"stage": "bulk"}
    with recording() as spans:
        with _trace.setup_span("warmup") as warm:
            with _trace.span("bulk", torch.device("cpu")) as inner:
                pass
        _trace.reset()
        assert spans() == []
    # Under a set-up span a stage is timed on the host alone.
    assert _trace.setup_spans()[-1] is warm and inner.parent == warm.id and inner.device is None


class _FakeEvent:
    """A CUDA timing event on a fake device clock (ms), for the CPU."""

    now = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.ts, self.done = None, True

    def record(self, stream=None):
        self.ts = _FakeEvent.now

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time of an event still running"
        return end.ts - self.ts


@pytest.fixture
def fake_card(monkeypatch):
    cuda = types.SimpleNamespace(Event=_FakeEvent, current_stream=lambda device=None: None,
                                 is_current_stream_capturing=lambda: False, synchronize=lambda device=None: None,
                                 is_available=lambda: True, current_device=lambda: 0)
    monkeypatch.setattr(_trace.torch, "cuda", cuda)
    _FakeEvent.now, _FakeEvent.made = 0.0, 0
    return torch.device("cuda", 0)


def test_device_spans_resolve_lazily_from_a_pool(fake_card, monkeypatch):
    _trace.enable(fake_card)
    _trace.reset()
    clock = _trace.clock()
    assert clock.device == fake_card and clock.half >= 0 and _FakeEvent.made == 1
    with _trace.call():
        _FakeEvent.now = 2.0
        with _trace.span("bulk", fake_card, rows=4) as bulk:
            _FakeEvent.now = 5.0
    bulk._events[1].done = False           # the device still runs the bulk
    with _trace.call(), _trace.span("cert", fake_card) as cert:
        pass                               # read at its open: nothing complete yet
    assert bulk._offsets is None and _trace._PENDING == [bulk, cert] and _FakeEvent.made == 5
    bulk._events[1].done = True
    with _trace.call(), _trace.span("bulk", fake_card) as third:
        pass                               # the device is idle at its open: nothing read
    assert _trace._PENDING == [bulk, cert, third] and _FakeEvent.made == 7
    third._events[1].done = False
    with _trace.call(), _trace.span("cert", fake_card) as fourth:
        pass                               # busy with the third: the complete ones read
    assert bulk._offsets == (2.0, 5.0) and bulk._events is None and cert._offsets == (5.0, 5.0)
    assert _trace._PENDING == [third, fourth] and _FakeEvent.made == 7   # the fourth took two of the pool's four
    third._events[1].done = True
    got = _trace.spans()
    assert got[1] is bulk and bulk.device == (clock.to_host(2.0), clock.to_host(5.0))
    assert bulk.device[1] - bulk.device[0] == pytest.approx(3 * MS * clock.rate)
    assert all(s._events is None and s.device is not None for s in got if s.name != "call")
    # No event under a set-up span, outside eager loops or while a stream captures.
    with _trace.call(), _trace.setup_span("warmup"), _trace.span("bulk", fake_card) as under_setup:
        pass
    with _trace.call(), _loops.loop_mode("all_trips"), _trace.span("bulk", fake_card) as all_trips:
        pass
    monkeypatch.setattr(_trace.torch.cuda, "is_current_stream_capturing", lambda: True)
    with _trace.call(), _trace.span("bulk", fake_card) as capturing:
        pass
    assert all(s._events is None and s.device is None for s in (under_setup, all_trips, capturing))
    _trace.disable()
    # The next enable() on the CPU keeps no clock of this one; a span keeps its own.
    _trace.enable(torch.device("cpu"))
    assert _trace.clock() is None and _trace.spans()[1].device == (clock.to_host(2.0), clock.to_host(5.0))
    _trace.disable()


def test_anchor_arithmetic():
    clock = _trace.Clock(1_000, 1_400)
    assert (clock.host, clock.half, clock.rate) == (1_200, 200, 1.0)
    assert clock.to_host(0.5) == 1_200 + 0.5 * MS
    # A second anchor 1 s later on the device and 1 s − 100 ns later on the host.
    clock.rescale(1_000_001_000, 1_000_001_200, 1_000.0)
    assert clock.rate == pytest.approx((1_000_001_100 - 1_200) / 1e9) and clock.half == 200
    assert clock.to_host(1_000.0) == pytest.approx(1_000_001_100) and clock.to_host(0.0) == 1_200


class _S:
    """A synthetic span: host (t0, t1) and device interval in ms."""

    def __init__(self, id, name, parent, t0, t1, device=None):
        self.id, self.name, self.parent, self.call = id, name, parent, None
        self.t0, self.t1 = t0 * MS, t1 * MS
        self.device = None if device is None else (device[0] * MS, device[1] * MS)


def test_attribute_puts_idle_down_to_the_innermost_host_span():
    spans = [
        _S(1, "call", None, 0, 100),
        _S(2, "load", 1, 0, 10, (2, 8)),
        _S(3, "bulk", 1, 10, 60, (15, 55)),
        _S(4, "cert", 1, 50, 90, (50, 80)),    # its device work overlaps the bulk's
        _S(5, "finish", 1, 90, 100),
        _S(6, "call", None, 120, 150),         # 100-120: between calls, the caller's
        _S(7, "bulk", 6, 120, 140, (125, 135)),
        _S(8, "finish", 6, 140, 150),
        _S(9, "load", None, 150, 160, (151, 158)),   # after the last call: outside the window
    ]
    out = _trace.attribute(spans)
    assert out["calls"] == 2 and out["window_ms"] == 150 and out["busy_ms"] == 81 and out["idle_ms"] == 69
    assert out["device_ms"] == pytest.approx({"load": 3, "bulk": 25, "cert": 15})
    assert out["idle_by"] == pytest.approx({"load": 2, "bulk": 7.5, "cert": 5, "finish": 10, "caller": 10})
    # 80-125 is one idle stretch: cert 10, finish 10, caller 20, the second bulk 5.
    assert out["gaps"] == [(45, "caller", 80), (15, "finish", 135), (7, "bulk", 8), (2, "load", 0)]
    assert out["busy_ms"] + out["idle_ms"] == out["window_ms"]
    # A window that ends inside a device span clips it.
    spans[5].t1 = 134 * MS                       # the second call ends at 134
    cut = _trace.attribute(spans[:7])
    assert cut["window_ms"] == 134 and cut["busy_ms"] == 80 and cut["device_ms"]["bulk"] == pytest.approx(24.5)
