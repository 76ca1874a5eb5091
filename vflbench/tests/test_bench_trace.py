"""The idle-union arithmetic on a synthetic timeline."""
from __future__ import annotations

import pytest

from vflbench import trace
from vflbench.bench import View


def timeline():
    dev = [("rns_montexp_kernel", 10, 40), ("elementwise_kernel", 30, 50),
           ("Memcpy HtoD", 60, 70), ("rns_matvec_kernel", 90, 95),
           ("late_kernel", 95, 130)]
    host = [("he.matvec", 56, 100), ("aten::cat", 52, 58),
            ("cudaStreamSynchronize", 70, 90)]
    return trace.Timeline(0, 120, [(n, s, min(e, 120)) for n, s, e in dev],
                          host)


def test_union_and_busy():
    tl = timeline()
    assert trace.union([(0, 5), (3, 8), (10, 12), (11, 11)], 0, 100) \
        == [(0, 8), (10, 12)]
    # [10, 50] + [60, 70] + [90, 120]: overlaps count once
    assert trace.busy_s(tl) == pytest.approx(80e-9)
    assert trace.gaps(tl) == [(0, 10), (50, 60), (70, 90)]
    assert tl.window_s == pytest.approx(120e-9)


def test_span_seconds_from_the_trace():
    tl = timeline()
    assert trace.span_s(tl, "he.") == pytest.approx(44e-9)
    # overlapping spans count once, and only inside the window
    tl.host += [("he.add_mask", 90, 110), ("he.matvec", 115, 200)]
    assert trace.span_s(tl, "he.") == pytest.approx((110 - 56 + 5) * 1e-9)
    assert trace.span_s(tl, "nothing.") == 0


def test_idle_gaps_by_host():
    got = dict(trace.idle_by_host(timeline()))
    assert got["he.matvec: cudaStreamSynchronize"] == pytest.approx(20e-9)
    assert got["legs: aten::cat"] == pytest.approx(10e-9)
    assert got["legs: python"] == pytest.approx(10e-9)


def test_annotations_are_not_device_work():
    class E:
        def __init__(self, name, dev, s, e):
            self._n, self._d, self._s, self._e = name, dev, s, e

        def name(self):
            return self._n

        def device_type(self):
            class D:
                name = "CUDA" if self._d else "CPU"
            return D()

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._e - self._s

    class P:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [E(trace.WINDOW_SPAN, False, 0, 100),
                            E(trace.WINDOW_SPAN, True, 0, 100),
                            E("he.matvec", True, 10, 90),
                            E("rns_matvec_kernel", True, 20, 30),
                            E("he.matvec", False, 10, 90)]
    tl = trace.from_profiler(P())
    assert [d[0] for d in tl.device] == ["rns_matvec_kernel"]
    assert trace.busy_s(tl) == pytest.approx(10e-9)


def test_kernel_classes_and_readers():
    from vflbench import spec
    tl = timeline()
    by_class, glue, n = trace.kernel_seconds(tl, spec.classes())
    assert n == 4
    assert by_class["ladder"] == pytest.approx(30e-9)
    assert by_class["matvec"] == pytest.approx(5e-9)
    assert glue == pytest.approx((20 + 25) * 1e-9)

    class W:
        seconds = {"ladder": 3e-9, "matvec": 1e-9, "product": 0.0}
        total_s = 4e-9
    v = View(iters=1, window_s=tl.window_s, busy_s=trace.busy_s(tl),
             class_s=by_class, glue_s=glue, launches=n,
             he_span_s=trace.span_s(tl, "he."), s_per_iter=100e-9, work=W(),
             comm_mb_per_iter=1.0, has_device=True)
    assert spec.reader("device_idle")(v) == pytest.approx(100 / 3)
    assert spec.reader("device_ms_per_iter")(v) == pytest.approx(80e-6)
    assert spec.reader("ladder_roofline")(v) == pytest.approx(10.0)
    assert spec.reader("matvec_roofline")(v) == pytest.approx(20.0)
    assert spec.reader("modmul_mfu")(v) == pytest.approx(4.0)
    assert spec.reader("launches_per_iter")(v) == 4
    assert spec.reader("he_ms_per_iter")(v) == pytest.approx(44e-6)
    assert spec.reader("legs_ms_per_iter")(v) == pytest.approx(76e-6)
    # nothing to read: no number, never a 0 share
    empty = View(**{**v.__dict__, "class_s": {}, "has_device": False})
    for name in ("ladder_roofline", "matvec_roofline", "modmul_mfu",
                 "device_idle", "device_ms_per_iter", "glue_ms_per_iter",
                 "launches_per_iter"):
        assert spec.reader(name)(empty) is None
