"""``pool.admit_replay_share`` on synthetic records: None from a program that
counts no admission stages (or ran none in the window), the replayed share
of the window's stages otherwise; the earlier readers read the same with and
without the new counters."""
from __future__ import annotations

import copy

import pytest

from benchmark.tests.test_bench_counts import _cfg, _read, _record
from benchmark.tests.test_bench_spans import OLD_READERS

NAME = "pool.admit_replay_share"


def _with_admissions(rec, stages, replays):
    """``rec`` whose window ran ``stages`` admission stages, ``replays`` of
    them from a graph (8 stages, all replayed, before it)."""
    rec = copy.deepcopy(rec)
    for c, (s, r) in ((rec["c0"], (8, 8)), (rec["c1"], (8 + stages, 8 + replays))):
        c["counts"] = {**c["counts"], "admit_stages": s, "admit_replays": r,
                       "prefill_passes": s // 4}
    return rec


def test_none_without_the_counters():
    assert _read(NAME, _record(_cfg())) is None
    assert _read(NAME, _record(_cfg(), with_slice=False)) is None
    assert _read(NAME, _with_admissions(_record(_cfg()), 0, 0)) is None  # no admission


@pytest.mark.parametrize("replays, share", [(12, 100.0), (9, 75.0), (0, 0.0)])
def test_replayed_share_of_the_stages(replays, share):
    assert _read(NAME, _with_admissions(_record(_cfg()), 12, replays)) == pytest.approx(share)


def test_earlier_readers_read_the_same_with_the_counters():
    plain = _record(_cfg())
    rec = _with_admissions(plain, 12, 12)
    for name in OLD_READERS + ("pool.gated_pass_share", "sched.queue_wait_ms"):
        assert _read(name, rec) == _read(name, plain), name
