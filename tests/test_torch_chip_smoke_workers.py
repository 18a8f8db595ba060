"""chip_smoke.py's untimed section on the CPU: its worker processes return
each task's result and lines, fail the parent where a task fails, and end;
the build's nvcc processes can be started ahead and waited for one by one.
"""
from __future__ import annotations

import multiprocessing

import pytest

import chip_smoke as cs
from mpc_tpu_torch.ops import _build


def test_workers_return_results_and_lines_and_fail_the_parent(monkeypatch):
    """A task's result comes back through its getter, the lines it emitted
    are emitted in the parent when it is collected, its seconds are kept
    under its key; a task that fails raises its CheckFailed in the parent;
    the workers have ended after ``close``."""
    lines, seconds = [], {}
    monkeypatch.setattr(cs, "emit", lines.append)
    pool = cs.Workers(seconds, n=1)
    try:
        sweep = pool.submit("sweep", "ip_lane_sweep", 12)
        said = pool.submit("said", "emit", {"phase": "rehearsal"})
        failing = pool.submit("failing", "require", False, "rehearsed")
        assert sweep() == (0, 1, 2, 4, 8, 12) and not lines
        assert said() is None and lines == [{"phase": "rehearsal"}]
        assert sweep() == (0, 1, 2, 4, 8, 12) and len(lines) == 1
        with pytest.raises(cs.CheckFailed, match="rehearsed"):
            failing()
        assert sorted(seconds) == ["said", "sweep"]
    finally:
        pool.close()
    assert not multiprocessing.active_children()


def test_build_starts_ahead_and_waits_per_library(monkeypatch, tmp_path):
    """``start_all`` starts one job per library and returns; ``done`` reads
    whether a job has ended; ``load``'s wait takes one library's job alone,
    its output and seconds kept; ``build_all`` waits for the rest."""
    started, ended = [], set()

    class Job:
        def __init__(self, name):
            self.name = name

        def poll(self):
            return 0 if self.name in ended else None

    def start(name):
        started.append(name)
        return tmp_path / name, (Job(name), None, None, None)

    def finish(name, out, job):
        assert job[0].name == name
        return f"log of {name}", 1.5
    monkeypatch.setattr(_build, "_pending", {})
    monkeypatch.setattr(_build, "_built", {})
    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build, "_finish", finish)
    _build.start_all(["fused_gn", "riccati"])
    _build.start_all(["fused_gn"])
    assert started == ["fused_gn", "riccati"]
    assert not _build.done("fused_gn")
    ended.add("fused_gn")
    assert _build.done("fused_gn") and not _build.done("riccati")
    assert _build._wait("fused_gn") == "log of fused_gn"
    assert list(_build._pending) == ["riccati"]
    assert _build.build_all(["fused_gn", "riccati"]) == {
        "fused_gn": "log of fused_gn", "riccati": "log of riccati"}
    assert _build.seconds() == {"fused_gn": 1.5, "riccati": 1.5}
    assert started == ["fused_gn", "riccati"]
