"""``spans.py``'s attribution on a stretch built by hand: the anchors'
offset, device time by the span that launched it (on its own thread, else
the main thread's), idle time by the main thread's span at each gap's
middle; and the readers of the span metrics on it."""

import math
import types

import pytest
import torch

from portbench import harness, spans
from portbench.spans import NONE, UNMATCHED

OFF = 1_000_000  # profiler clock = span clock + OFF


def _rec(name, start, end, tid, parent):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end, tid=tid, parent=parent)


SPANS = [_rec("bench.anchor", 100, 200, 1, -1),
         _rec("train.step", 300, 1000, 1, -1),
         _rec("step.loss", 350, 450, 1, 1),
         _rec("step.backward", 500, 900, 1, 1),
         _rec("render.raster_bwd", 520, 600, 2, 3),   # the engine's thread
         _rec("bench.anchor", 1100, 1200, 1, -1)]
SYNCS = [(OFF + 120, OFF + 180), (OFF + 1130, OFF + 1170)]
# (span-clock launch time, thread, correlation) -> activity (start, end)
LAUNCHES = [(360, 1, 1), (530, 2, 2), (650, 2, 3), (310, 1, 4), (1050, 1, 6)]
ACTS = [(400, 450, 1, "void ssim_k<float>(float*)"), (600, 700, 2, "rasterize_bwd_kernel"),
        (700, 730, 3, "add"), (320, 340, 4, "fill"), (800, 810, 5, "copy"), (1050, 1060, 6, "copy")]


def _attribution(tids=(1, 2)):
    clock = spans.clock_map([(r.start_ns, r.end_ns) for r in SPANS if r.name == "bench.anchor"],
                            SYNCS)
    tid = dict(zip((1, 2), tids))
    return spans.attribute(SPANS, [(OFF + s, OFF + e, c, n) for s, e, c, n in ACTS],
                           [(OFF + t, tid[x], c) for t, x, c in LAUNCHES], clock, 1, 250, 1100,
                           residual_us=clock.residual_us)


def test_the_anchors_map_the_clocks():
    # Offsets -20..20 and -30..30 ns fit the two anchors: the overlap's
    # midpoint, half its width.
    c = spans.clock_map([(100, 200), (1100, 1200)], SYNCS)
    assert (c(150), c(1150), c.drift_us, c.residual_us) == (OFF + 150, OFF + 1150, 0.0, 0.02)
    # A wide first anchor (-950..950) and a narrow last one (-10..30): the
    # narrow one sets the map, 10 +- 20 ns.
    c = spans.clock_map([(0, 2000), (1100, 1200)], [(OFF + 950, OFF + 1050),
                                                     (OFF + 1130, OFF + 1190)])
    assert (c(150), c.residual_us) == (OFF + 160, 0.02)
    # Intervals -20..20 and 60..80 apart: the clocks drifted by 40 ns, the
    # least that fits, along the line between the near ends.
    c = spans.clock_map([(100, 200), (1100, 1200)], [SYNCS[0], (OFF + 1180, OFF + 1260)])
    assert c(150) == OFF + 170 and c(1150) == OFF + 1210 and c(650) == OFF + 690
    assert math.isclose(c.drift_us, 0.04) and c.residual_us == 0.0
    # An event longer than its span fits no offset; a missing anchor none.
    assert spans.clock_map([(100, 110), (1100, 1200)], SYNCS) is None
    assert spans.clock_map([(100, 200)], SYNCS) is None
    # The profiler's own synchronize before the first anchor and after the
    # last: the pair whose intervals overlap is taken. A third anchor whose
    # event fits it only at offsets 20 to 100 ns above the map adds 20 ns.
    extra = [(OFF + 10, OFF + 40), SYNCS[0], (OFF + 700, OFF + 720), SYNCS[1],
             (OFF + 1300, OFF + 1302)]
    c = spans.clock_map([(100, 200), (1100, 1200)], extra)
    assert (c(150), c.drift_us, c.residual_us) == (OFF + 150, 0.0, 0.02)
    c = spans.clock_map([(100, 200), (600, 700), (1100, 1200)], extra)
    assert (c(650), c.drift_us) == (OFF + 650, 0.0) and math.isclose(c.residual_us, 0.04)


@pytest.mark.parametrize("tids", [(1, 2), (7, 7)], ids=["own threads", "threads unknown"])
def test_device_and_idle_time_go_to_their_spans(tids):
    """The trace's thread ids name the spans' threads, or no thread of a
    span (all 7): the deepest open span takes the launch, the same here."""
    a = _attribution(tids)
    ns = 1e-9
    want_dev = {"train.step/step.loss": 50, "train.step/step.backward/render.raster_bwd": 100,
                "train.step/step.backward": 30,   # launched outside the engine's span
                "train.step": 20, UNMATCHED: 10, NONE: 10}
    assert a.device_s.keys() == want_dev.keys()
    for k, v in want_dev.items():
        assert math.isclose(a.device_s[k], v * ns), k
    want_idle = {NONE: 70 + 40, "train.step/step.loss": 60,
                 "train.step/step.backward": 150 + 70, "train.step": 240}
    assert a.idle_s.keys() == want_idle.keys()
    for k, v in want_idle.items():
        assert math.isclose(a.idle_s[k], v * ns), k
    # The idle and the busy time make up the stretch.
    assert math.isclose(sum(a.idle_s.values()) + 220 * ns, a.window_s)
    assert math.isclose(a.window_s, 850 * ns) and a.activities == 6
    assert math.isclose(a.idle_under("train.step"), 520 * ns)
    assert math.isclose(a.device_under("step.backward"), 130 * ns)
    assert math.isclose(a.coverage(("train.step", "step.backward")), 100 * 150 / 220)
    # Each path's device time by kernel symbol.
    assert a.symbols["train.step/step.loss"].keys() == {"ssim_k"}
    assert a.symbols[UNMATCHED].keys() == {"copy"} and a.symbols[NONE].keys() == {"copy"}


def _layer(kind, **kw):
    trace = types.SimpleNamespace(units=2)
    return {"kind": kind, "trace": trace, "views_per_unit": 4, "window_s": 2.0, **kw}


def _custom():
    return spans.Attribution(
        window_s=1.0, residual_us=0.0, activities=9,
        device_s={"train.step/render.project_sh": 0.016,
                  "train.step/step.backward/render.project_sh.bwd": 0.032,
                  "train.step/render.binning": 0.008, "train.step/step.loss": 0.004,
                  "train.step/step.backward/step.loss.bwd": 0.004,
                  "train.step/step.backward/render.reduce": 0.0024,
                  "train.step/step.adam": 0.006, "train.step": 0.001,
                  "train.step/step.backward": 0.001, NONE: 0.0006},
        idle_s={"train.step/step.backward": 0.1, "train.step": 0.05, "train.densify": 0.2,
                NONE: 0.03})


READINGS = [("projection_ms.train", 6.0), ("binning_ms.train", 1.0), ("loss_ms.train", 1.0),
            ("reduce_ms.train", 0.3), ("optimizer_ms.train", 3.0),
            ("step_idle_share.train", 15.0),
            ("span_coverage.train", 100 * (0.075 - 0.0026) / 0.075),
            ("trainer_event_span_share.train", 100 * (0.1 + 0.02) / 2.0)]


@pytest.mark.parametrize("name,want", READINGS)
def test_each_train_reader_reads_its_spans(name, want):
    layer = _layer("train", span_stretch=_custom(),
                   span_window_s={"train.step": 1.5, "train.densify": 0.1, "train.log": 0.02})
    reader = harness.metric_reader(name)
    assert math.isclose(reader.read(layer), want, rel_tol=1e-12)
    assert reader.read(_layer("train")) is None
    assert reader.read(_layer("render", span_stretch=_custom())) is None


def test_each_render_reader_reads_its_spans():
    a = spans.Attribution(
        window_s=1.0, residual_us=0.0, activities=5,
        device_s={"render.frame/render.project_sh": 0.006, "render.frame/render.binning": 0.01,
                  "render.frame/render.raster_fwd": 0.002, "render.frame": 0.002},
        idle_s={"render.frame": 0.3, "render.frame/render.binning": 0.05, NONE: 0.02})
    layer = _layer("render", span_stretch=a)
    layer["views_per_unit"] = 1
    for name, want in (("projection_ms.render", 3.0), ("binning_ms.render", 5.0),
                       ("render_idle_share.render", 35.0), ("span_coverage.render", 90.0)):
        reader = harness.metric_reader(name)
        assert math.isclose(reader.read(layer), want, rel_tol=1e-12), name
        assert reader.read(_layer("render")) is None
        assert reader.read({"kind": "train", "span_stretch": a}) is None


def test_a_span_stretch_on_the_cpu_records_the_spans_and_attributes_nothing():
    """No device activity and no synchronize on the CPU: the program's spans
    between the anchors are kept, spans are off again, and the stretch's
    summary is the plain one."""
    from gaussian_splatting_tpu_torch.utils import profiling

    profiling.reset()
    s = spans.SpanStretch(torch.device("cpu"))
    s.start()
    with profiling.annotate("render.frame"):
        torch.ones(32) * 2
    s.stop(1)
    assert [r.name for r in s.spans] == ["bench.anchor", "render.frame", "bench.anchor"]
    assert not profiling.enabled()
    assert s.attribution() is None
    assert s.summarize().units == 1
