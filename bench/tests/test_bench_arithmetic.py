"""The metric arithmetic on synthetic timelines: rates over the whole
window, a tail over all requests, the trace's busy time and idle gaps,
and the readers."""
from types import SimpleNamespace

import pytest
import torch

from bench_small import ROOT
from yardstick import manifest, timer
from yardstick.kinds.prefill_waves import p95
from yardstick.main import Record

DEV = torch.device("cpu")


def test_p95_is_over_all_requests_and_shows_a_stall():
    lat = [0.40] * 190 + [3.0] * 10          # one stalled wave in twenty
    assert p95(lat) == 0.40
    lat = [0.40] * 180 + [3.0] * 20
    assert p95(lat) == 3.0
    assert p95([1.0]) == 1.0


class _Ev:
    def __init__(self, name, s, d, cuda, annotation=False):
        self._n, self._s, self._d, self._c, self._a = name, s, d, cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._a


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_trace_busy_union_idle_and_host_attribution():
    ms = 1_000_000
    ev = [_Ev(timer.WINDOW, 0, 100 * ms, False),
          _Ev(timer.WINDOW, 0, 100 * ms, True, annotation=True),
          _Ev("aten::mm", 0, 10 * ms, False),
          _Ev("void (anonymous namespace)::flash_h16_kernel<2, false>(P)",
              5 * ms, 20 * ms, True),
          _Ev("gemm", 10 * ms, 20 * ms, True),        # overlaps: union 5-30
          _Ev("aten::sort", 40 * ms, 20 * ms, False),
          _Ev("gemm", 60 * ms, 30 * ms, True),
          _Ev("outside", 150 * ms, 5 * ms, True)]      # past the window
    t = timer.read_trace(_prof(ev))
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.055)           # 5-30 and 60-90
    assert t.kernels["flash_h16_kernel"] == [pytest.approx(0.02), 1]
    assert t.kernels["gemm"][1] == 2
    idle = dict(t.idle_by_host)
    # gaps 0-5 (under aten::mm), 30-60 (under aten::sort at 45), 90-100
    assert idle["aten::mm"] == pytest.approx(0.005)
    assert idle["aten::sort"] == pytest.approx(0.03)
    assert idle["host outside any operation"] == pytest.approx(0.01)


def test_rate_is_all_the_work_over_all_the_window():
    steps = [1.0] * 10
    even = [0.5 * (i + 1) for i in range(10)]
    assert timer.rate(steps, even) == pytest.approx(2.0)
    # one step stalled by 1 s: the whole window's rate shows it
    stalled = [e + (1.0 if i >= 4 else 0.0) for i, e in enumerate(even)]
    assert timer.rate(steps, stalled) == pytest.approx(10 / 6)
    # uneven work (waves of different sizes) counts at its size
    assert timer.rate([3, 1], [1.0, 2.0]) == pytest.approx(2.0)


def test_marks_count_work_over_the_whole_window():
    m = timer.Marks(DEV)
    m.mark()
    m.mark()
    s = m.seconds()
    assert len(s) == 2 and 0 <= s[0] <= s[1]


def test_spans_wrap_and_time_only_while_active():
    ns = SimpleNamespace(f=lambda x: x + 1)
    sp = timer.Spans(DEV)
    sp.wrap(ns, "f", "f")
    assert ns.f(1) == 2 and sp.seconds("f") == []
    sp.active = True
    assert ns.f(2) == 3 and len(sp.seconds("f")) == 1


def _reader(name):
    return manifest.load_reader(ROOT, name)


def _trace(window, busy, kernels):
    return timer.Trace(window_s=window, busy_s=busy, kernels=kernels)


def test_readers_on_synthetic_records():
    a = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 300}
    tr = _trace(2.0, 1.5, {"flash_h16_kernel": [0.5, 10],
                           "bwd_h16_kernel": [0.2, 5],
                           "stats_kernel": [0.05, 5],
                           "dq_post_kernel": [0.05, 5]})
    sp = timer.Spans(DEV)
    sp.records["optimizer"] = [(0.0, 0.1), (0.0, 0.3)]
    rec = Record(a, tr, sp, counters={"prefill_positions": 100,
                                      "prefill_real_positions": 60},
                 work={"steps": 2, "step_flops": 989e12,
                       "flash_fwd_call": (989e12 * 0.01, 0.0),
                       "flash_bwd_call": (989e12 * 0.02, 0.0),
                       "model_flops": 989e12, "flash_fwd": (989e12 * 0.1, 0)})
    assert _reader("device_idle.train").read(rec) == pytest.approx(25.0)
    assert _reader("optimizer_ms.train").read(rec) == pytest.approx(200.0)
    assert _reader("prefill_padding.serve").read(rec) == pytest.approx(40.0)
    assert _reader("mfu.train").read(rec) == pytest.approx(100.0)
    assert _reader("mfu.serve").read(rec) == pytest.approx(50.0)
    # 10 launches x 0.01 s of peak work in 0.5 s
    assert _reader("flash_fwd_roofline.train").read(rec) == pytest.approx(20.0)
    assert _reader("flash_fwd_roofline.serve").read(rec) == pytest.approx(20.0)
    # 5 launches x 0.02 s in 0.3 s (pre-pass, main kernel, post-pass)
    assert _reader("flash_bwd_roofline.train").read(rec) == \
        pytest.approx(100 * 0.1 / 0.3)


def test_readers_find_nothing_and_say_nothing():
    empty = Record({}, None, timer.Spans(DEV))
    for m in manifest.load_manifest(ROOT)["per_layer"]:
        assert _reader(m["name"]).read(empty) is None, m["name"]
