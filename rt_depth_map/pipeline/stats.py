"""Per-stage execution-time statistics.

Re-creates the reference's macro timing subsystem (include/estimator.h:46-80
+ estimator.cpp:265-292): each pipeline call site accumulates a running mean
of its execution time in call order; a report prints per-stage means, the
iteration count, and the overall per-frame sum. The reference prints this on
SIGINT; the Engine wires the same signal plus atexit.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class _StageAcc:
    __slots__ = ("name", "total", "count")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class ExecTimeStats:
    """Call-order stage table (exec_times_tab parity, estimator.h:112-114)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._stages: Dict[str, _StageAcc] = {}
        self._order: List[str] = []
        self.iterations = 0
        self.wall_frames = 0
        self.wall_seconds = 0.0
        self._overlapped: set = set()

    def note_wall(self, frames: int, seconds: float) -> None:
        """Record pipelined-loop wall clock: the loop overlaps stages
        (dispatch N+1 while N executes; d2h pulls overlap), so
        frames/wall is the real throughput -- the per-stage means are NOT
        additive into a frame period."""
        self.wall_frames += frames
        self.wall_seconds += seconds

    def mark_overlapped(self, name: str) -> None:
        """Tag a stage as overlapped with device execution (excluded from
        the sum-of-means frame-period estimate; e.g. d2h result pulls)."""
        self._overlapped.add(name)

    def start_iteration(self) -> None:
        """MEASURE_EXECUTION_TIME_START parity: begin a new frame."""
        self.iterations += 1

    @contextlib.contextmanager
    def measure(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            acc = self._stages.get(name)
            if acc is None:
                acc = _StageAcc(name)
                self._stages[name] = acc
                self._order.append(name)
            acc.total += dt
            acc.count += 1

    def add(self, name: str, seconds: float) -> None:
        acc = self._stages.get(name)
        if acc is None:
            acc = _StageAcc(name)
            self._stages[name] = acc
            self._order.append(name)
        acc.total += seconds
        acc.count += 1

    def report(self) -> str:
        """print_exec_time_stats parity (estimator.cpp:265-292): aligned
        per-stage mean + period count + overall sum."""
        if not self._order:
            return "no timing data collected\n"
        width = max(max(len(n) for n in self._order) + 10, 33)
        lines = ["", "Mean execution times:", ""]
        overall = 0.0
        for name in self._order:
            acc = self._stages[name]
            tag = ""
            if name in self._overlapped:
                tag = " (overlap)"  # runs concurrently with device exec
            else:
                overall += acc.mean
            lines.append(
                f"  {name + tag:<{width}} : {acc.mean * 1e3:9.3f} ms"
                f"  (n={acc.count})"
            )
        lines.append("-" * (width + 30))
        lines.append(
            f"  {'overall (sum of host-stage means)':<{width}} :"
            f" {overall * 1e3:9.3f} ms  over {self.iterations} iterations"
        )
        # The headline is pipelined throughput: frames / loop wall-clock.
        # Summing stage means double-counts overlapped work (it would
        # count overlapped d2h pulls as pipeline cost).
        if self.wall_seconds > 0 and self.wall_frames > 0:
            fps = self.wall_frames / self.wall_seconds
            lines.append(
                f"  {'pipelined throughput':<{width}} : {fps:9.2f} fps"
                f"  ({self.wall_frames} frames / "
                f"{self.wall_seconds:.3f} s wall)"
            )
        elif overall > 0:
            lines.append(
                f"  {'implied fps (unpipelined)':<{width}} :"
                f" {1.0 / overall:9.2f}")
        lines.append("")
        return "\n".join(lines)
