"""The benchmark's arithmetic: the tail over all requests, spreads, the
device's busy union and idle gaps, and the roofline of a launch."""
import statistics

import pytest
import torch

from portbench.harness import arith, trace
from portbench.harness.observe import Observation


def test_p95_is_over_every_request():
    lat = list(range(1, 201))                  # 200 requests
    assert arith.nearest_rank(lat, 95) == 190   # 10 lie above it
    assert arith.nearest_rank([7.0], 95) == 7.0
    assert arith.nearest_rank(list(range(100, 0, -1)), 50) == 50
    with pytest.raises(ValueError):
        arith.nearest_rank([], 95)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10, 11, 12, 13, 14, 15]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert arith.spread(v) == pytest.approx((q3 - q1) / med)


def test_busy_union_and_gaps():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert arith.union_s(ivs) == pytest.approx(3.0)
    assert arith.gaps(ivs, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert arith.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_roofline_counts_each_byte_once():
    # bitmap_vm on CPU tensors launches nothing
    assert arith.bitmap_vm_cost(torch.zeros(2, 2, dtype=torch.int32),
                                torch.zeros(1, 4, dtype=torch.int32)) is None

    class Cuda:                 # a stand-in with a CUDA device and a shape
        def __init__(self, *shape):
            self.shape = shape
            self.device = torch.device("cuda")

        def numel(self):
            n = 1
            for s in self.shape:
                n *= s
            return n
    nb, ops = arith.bitmap_vm_cost(Cuda(129, 65), Cuda(64, 4))
    assert nb == 2 * 129 * 65 * 4 + 64 * 16 + 129 * 4
    assert ops == 64 * 65 + 2 * 129 * 65
    nb, ops = arith.xor_delta_ragged_cost(Cuda(13568), Cuda(13568), Cuda(213))
    assert (nb, ops) == (3 * 13568 * 4 + 4 * 212 + 8 * 213, 2 * 13568)
    assert arith.xor_delta_ragged_cost(Cuda(0), Cuda(0), Cuda(1)) is None
    # bytes bound: 3.35e12 B/s
    assert arith.least_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert arith.least_s(1.0, 67e12) == pytest.approx(1.0)


def test_roofline_share_and_idle_from_a_trace():
    tr = trace.Trace(window_s=10.0, busy_s=0.5, n_device_events=2,
                     device_events=[("bitmap_vm_kernel", 1.0, 1.0 + 2e-6),
                                    ("void other", 2.0, 2.5)])
    obs = Observation(units=2, launches={"k:entry": [(3.35e6, 0.0)]},
                      trace=tr)
    # 3.35e6 B at 3.35e12 B/s = 1e-6 s over 2e-6 s of kernel time
    assert obs.roofline_pct({"k:entry": None}, "bitmap_vm") == \
        pytest.approx(50.0)
    assert obs.roofline_pct({"k:entry": None}, "nothing") is None
    assert obs.device_idle_pct() == pytest.approx(95.0)
    assert Observation(units=2).device_idle_pct() is None
    assert obs.span_ms("plan") is None


def test_idle_gaps_are_split_over_the_innermost_spans():
    # answer 0..10 with decode 2..4 and 6..7 inside it, as Spans keeps it
    timeline = [(0.0, "answer"), (2.0, "decode"), (4.0, "answer"),
                (6.0, "decode"), (7.0, "answer"),
                (10.0, "outside the spanned layers")]
    tr = trace.Trace(gaps=[(-1.0, 0.5), (2.5, 3.5), (4.5, 5.0), (6.5, 7.5),
                           (9.5, 12.0)])
    got = dict(trace.idle_by_host(tr, timeline))
    assert got == pytest.approx({"decode": 1.5, "answer": 2.0,
                                 "outside the spanned layers": 3.0})


def test_self_time_excludes_nested_spans(monkeypatch):
    import sys
    import types

    from portbench.harness.spans import Spans
    mod = types.ModuleType("pb_fake_layers")

    def inner():
        return 1

    def outer():
        return mod.inner() + mod.inner()
    mod.inner, mod.outer = inner, outer
    monkeypatch.setitem(sys.modules, "pb_fake_layers", mod)
    ticks = iter(range(100))
    monkeypatch.setattr("portbench.harness.spans.clock",
                        lambda: float(next(ticks)))
    sp = Spans(keep_timeline=True)
    sp.wrap("pb_fake_layers:inner", "in")
    sp.wrap("pb_fake_layers:outer", "out")
    sp.start()
    assert mod.outer() == 2
    sp.stop()
    sp.close()
    # outer 0..5, inner 1..2 and 3..4: outer's self time is 5 - 2
    assert sp.self_s == {"in": 2.0, "out": 3.0}
    assert sp.calls == {"in": 2, "out": 1}
    assert sp.timeline == [(0.0, "out"), (1.0, "in"), (2.0, "out"),
                           (3.0, "in"), (4.0, "out"),
                           (5.0, "outside the spanned layers")]
    assert mod.inner is inner and mod.outer is outer
