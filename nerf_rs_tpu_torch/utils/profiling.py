"""Tracing and profiling, the port of ``nerf_rs_tpu/utils/profiling.py``.

- :class:`Phases`: named wall-clock phase timers; :meth:`Phases.sync`
  waits for the card when the value lies on one.
- :func:`device_trace`: a context manager around ``torch.profiler`` (CPU
  and, where there is a card, CUDA activity) that writes a Chrome trace
  into a directory, for chrome://tracing or Perfetto.
- :class:`Progress`: rate-limited rays/s progress lines.
- :func:`device_label`: what a time taken on a device is stated beside —
  the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch


def _first_tensor(value) -> Optional[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


class Phases:
    """Accumulating named wall-clock timers.

    >>> ph = Phases()
    >>> with ph("coarse"):
    ...     out = coarse_step()
    ...     ph.sync(out)                 # wait for the card
    >>> ph.report()
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    @staticmethod
    def sync(value) -> None:
        """Wait until ``value`` (a tensor, or the first tensor of a nested
        list, tuple or dict) is computed: ``torch.cuda.synchronize()`` on
        its card; a CPU tensor is computed already."""
        t = _first_tensor(value)
        if t is not None and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    def report(self, printer=print) -> Dict[str, float]:
        total = sum(self.totals.values()) or 1.0
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            printer(f"  {name:24s} {t * 1e3:9.1f} ms  ({100 * t / total:5.1f}%)"
                    f"  x{self.counts[name]}")
        return dict(self.totals)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the body when ``log_dir`` is set (CPU
    activity, and CUDA activity where a card is present), written as a
    Chrome trace ``<host>_<pid>.<ns>.pt.trace.json`` into ``log_dir``; a
    no-op otherwise. Yields the path the trace will be written to, or
    None. A profiler that cannot start, or a trace that cannot be written,
    raises: a run asked to trace does not go on without its trace. An
    exception of the body propagates and no trace is written."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield path
    finally:
        prof.__exit__(None, None, None)
    prof.export_chrome_trace(str(path))
    print(f"profiler trace written to {path}")


class Progress:
    """Progress lines with rays/s, at most every ``interval`` seconds and
    at the end."""

    def __init__(self, total_rays: int, interval: float = 2.0) -> None:
        self.total = total_rays
        self.interval = interval
        self.done = 0
        self._start = time.perf_counter()
        self._last = self._start

    def update(self, n_rays: int, printer=print) -> None:
        self.done += n_rays
        now = time.perf_counter()
        if now - self._last >= self.interval or self.done >= self.total:
            rate = self.done / max(now - self._start, 1e-9)
            printer(f"  {self.done}/{self.total} rays ({100 * self.done / self.total:.0f}%), "
                    f"{rate:,.0f} rays/s")
            self._last = now


def device_label(device, timeout: float = 60.0) -> str:
    """The words a time measured on ``device`` is written beside: for a
    CUDA device the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    name alone, from torch, where nvidia-smi fails or takes longer than
    ``timeout`` seconds), else the device's type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=timeout)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(index)}, power limit not read"
