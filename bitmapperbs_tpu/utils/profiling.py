"""Tracing / profiling utilities (SURVEY.md 5.1).

The reference has no built-in profiling (paper benchmarking used external
timing); this package provides:
  * `device_trace(dir)` -- context manager around jax.profiler traces
    (xplane output, viewable in XProf/Perfetto), wired to the CLI's
    `--profile DIR` flag;
  * `StageTimer` -- block_until_ready wall timers for coarse host-side
    stage attribution;
  * `gpu_cards()` -- the cards' names and power limits, which belong beside
    every time measured on them.
"""
from __future__ import annotations

import contextlib
import subprocess
import time

import jax


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """jax.profiler trace of everything inside the block (no-op if None)."""
    if not trace_dir:
        yield
        return
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulating wall timers: `with timer("seed"): ...` (syncs device)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        self.totals[name] = self.totals.get(name, 0.0) + (
            time.perf_counter() - t0)
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "  ".join(
            f"{k}={self.totals[k] * 1e3:.1f}ms/{self.counts[k]}x"
            for k in sorted(self.totals))


def gpu_cards() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`: one line per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"
