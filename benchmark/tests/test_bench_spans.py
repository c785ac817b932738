"""The readers of the program's spans and counters on synthetic records:
known shares and times, a kernel counted for the span that launched it, and
every earlier reader reading the same with and without the new keys."""
from __future__ import annotations

import copy
import time

import numpy as np
import pytest

from benchmark.harness import spans as S
from benchmark.harness.trace import breakdown
from benchmark.tests.test_bench_counts import _cfg, _read, _record

SCHED, CLIENT = 11, 22
OLD_READERS = ("ttft_p50_ms", "output_tok_s", "setup_s", "tail.ttft_p95_ms", "tail.tpot_p95_ms",
               "sched.admit_share", "sched.stream_share", "pool.rows_per_pass", "mfu",
               "b4_roofline", "b3_roofline", "device_idle_share.serve")
SPAN_READERS = ("serve.prepare_ms", "admit.device_ms", "pool.decode_pass_ms",
                "device_idle_share.admit")


def _span(i, name, s, e, tid=SCHED, parent=None, rid=None, **attrs):
    return {"id": i, "name": name, "start_ns": s, "end_ns": e, "tid": tid, "parent": parent,
            "rid": rid, "attrs": attrs}


def _with_spans(rec):
    """The slice [1000, 2000) ns: a one-shot admission [1000, 1200) (its tower
    [1050, 1180)), a decode chunk [1200, 1500) (the slice's one pass), a chunked
    admission's last stage [1500, 1600), idle [1600, 2000); three
    ``serve.prepare`` on a client thread, of 20, 40 and 90 ns.  Kernels
    (launch -> run): 1100 -> [1100, 1150), 1170 -> [1210, 1260) (runs during
    the decode chunk, counts for the admission), 1220 -> [1300, 1400),
    1230 -> [1400, 1440), 1550 -> [1560, 1580), and a copy with no runtime
    call matched [1700, 1710).  Idle (730 ns): [1000, 1100) [1150, 1210)
    [1260, 1300) (a runtime call open) [1440, 1560) [1580, 1700)
    [1710, 2000)."""
    rec = copy.deepcopy(rec)
    sl = rec["slice"]
    sl["wall_ns"] = (1000, 2000)
    sl["spans"] = [
        _span(0, "sched.admit", 1000, 1200, rid=1),
        _span(1, "admit.tower", 1050, 1180, parent=0, rid=1),
        _span(2, "sched.decode", 1200, 1500),
        _span(3, "decode.launch", 1200, 1300, parent=2),
        _span(4, "decode.readback", 1300, 1500, parent=2),
        _span(5, "sched.admit_stage", 1500, 1600, rid=2, stage=2, done=True),
        _span(6, "sched.idle", 1600, 2000),
        _span(7, "serve.prepare", 1000, 1020, tid=CLIENT),
        _span(8, "serve.prepare", 1100, 1140, tid=CLIENT),
        _span(9, "serve.prepare", 1300, 1390, tid=CLIENT),
        _span(10, "sched.queue_wait", 900, 1000, tid=CLIENT, rid=1)]
    sl["device"] = {
        "intervals": np.asarray([[1100, 1150], [1210, 1260], [1300, 1400], [1400, 1440],
                                 [1560, 1580], [1700, 1710]], np.int64),
        "launch_ns": np.asarray([1100, 1170, 1220, 1230, 1550, -1], np.int64)}
    sl["runtime"] = {"intervals": np.asarray([[1255, 1305]], np.int64),
                     "names": ["cudaStreamSynchronize"]}
    for c, (wait, live) in ((rec["c0"], (0.5, 8)), (rec["c1"], (0.8, 10))):
        c["stats"] = {**c["stats"], "t_queue_wait": wait}
        c["counts"] = {**c["counts"], "live_decode_passes": live}
    rec["c1"]["stats"].update(prefills=2, chunked_admissions=1)
    return rec


def test_span_readers_on_a_synthetic_record():
    rec = _with_spans(_record(_cfg()))
    # 0.3 s over 2 one-shot + 1 chunked admissions started
    assert _read("sched.queue_wait_ms", rec) == pytest.approx(100.0)
    # 3 passes in the window, 2 live
    assert _read("pool.gated_pass_share", rec) == pytest.approx(100 / 3)
    assert _read("serve.prepare_ms", rec) == pytest.approx(40e-6)
    # admissions: 50 + 50 ns (the second launched at 1170, run in the
    # decode chunk) + 20 ns, over 2 completed
    assert _read("admit.device_ms", rec) == pytest.approx(60e-6)
    # decode: 100 + 40 ns over the slice's one pass
    assert _read("pool.decode_pass_ms", rec) == pytest.approx(140e-6)
    # idle under admissions: [1000, 1100) [1150, 1200) + [1500, 1560) [1580, 1600)
    assert _read("device_idle_share.admit", rec) == pytest.approx(100 * 230 / 1000)
    assert S.idle_s_under(rec, None) == pytest.approx(730e-9)
    assert S.device_s_by_top(rec) == pytest.approx(
        {"sched.admit": 100e-9, "sched.decode": 140e-9, "sched.admit_stage": 20e-9,
         "sched.idle": 10e-9})  # the copy by its own start
    # each gap by its middle: the runtime call open there, else the
    # innermost Scheduler span
    assert S.idle_breakdown(rec) == pytest.approx({
        "span:admit.tower": 100e-9, "span:sched.admit": 60e-9,
        "cudaStreamSynchronize": 40e-9, "span:sched.admit_stage": 120e-9,
        "span:sched.idle": 410e-9})
    assert S.completed_admissions(rec["slice"]["spans"]) == 2
    assert S.scheduler_tid(rec["slice"]["spans"]) == SCHED


def test_new_keys_leave_every_earlier_reading_as_it_was():
    for cfg in (_cfg(), _cfg(weights="int4", kv_cache="int8")):
        plain = _record(cfg)
        rec = _with_spans(plain)
        for name in OLD_READERS:
            assert _read(name, rec) == _read(name, plain), name
        sl = {**plain["slice"], "kinds": {"gemm": 1.0}, "idle_by_host": {"(no runtime call)": 0.2}}
        assert breakdown({**sl, **{k: rec["slice"][k] for k in ("spans", "device", "runtime",
                                                                 "wall_ns")}}) == breakdown(sl)


def test_new_readers_read_nothing_from_a_program_without_them():
    """A record of a program with no recorder, counters or device events (the
    parent's): every new reader gives None and none raises."""
    rec = _record(_cfg())
    rec["slice"]["spans"] = []
    for name in SPAN_READERS + ("sched.queue_wait_ms", "pool.gated_pass_share"):
        assert _read(name, rec) is None, name
    for name in SPAN_READERS:
        assert _read(name, _record(_cfg(), with_slice=False)) is None, name


def test_slice_spans_come_from_the_program_on_its_clock():
    """Without ``spans`` in the slice they are taken from the port's
    recorder, the slice's perf_counter bounds carried to its clock."""
    from visualcla_tpu_torch.utils import profiling

    rec = _record(_cfg())
    profiling.record_spans(True)
    try:
        with profiling.span("serve.prepare"):
            pass
        t0 = time.perf_counter()
        with profiling.span("serve.prepare"):
            time.sleep(0.003)
        t1 = time.perf_counter()
        with profiling.span("serve.prepare"):
            pass
    finally:
        profiling.record_spans(False)
    rec["slice"].update(t0=t0, t1=t1)
    got = _read("serve.prepare_ms", rec)
    assert 3.0 <= got < (t1 - t0) * 1e3
    assert [d["name"] for d in rec["slice"]["spans"]] == ["serve.prepare"]
