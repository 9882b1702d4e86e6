"""Phase ranges, device traces and a host phase timer.

Port of ``ringzk_tpu.utils.profiling``. The protocol phase functions of
``protocols/{commit,open,linear,sum}.py`` carry :func:`annotate` ranges
under the JAX package's names (``commit_scheme/commit``,
``open_proof/verify``, ...), so one profiled call splits its host and
device time by phase:

* under ``torch.profiler`` (:func:`device_trace`), each range is a
  ``record_function`` event on the host and, where it launched device
  work, a ``gpu_user_annotation`` span on the device timeline, from the
  first to the last kernel or memory operation launched in it and in no
  range nested in it. :func:`device_ranges` sums the device time of each
  range from these spans, :func:`range_parents` names the range each one
  ran in, and :func:`device_work` leaves the spans out of a sum of device
  time, which would otherwise count that time twice;
* under Nsight Systems, ``torch.autograd.profiler.emit_nvtx()`` turns the
  same ranges into NVTX ranges. :func:`annotate` does not call
  ``torch.cuda.nvtx`` itself: a CPU build of torch has no NVTX and raises.

With no profiler on, a range costs only the host's entry into and exit
from ``record_function``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time

import torch


def annotate(name: str):
    """Decorator: runs the function inside
    ``torch.profiler.record_function(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def device_trace(logdir: str | None = None, device=None):
    """Profile a block with ``torch.profiler`` and write its Chrome trace
    (view it in Perfetto or chrome://tracing) into ``logdir`` (default:
    ``ringzk_trace`` under the temporary directory) as
    ``trace_<pid>_<time>.json``. Host and CUDA activity on the card
    (default; raises without one), host activity alone when ``device`` is
    "cpu". Yields the ``torch.profiler.profile`` object, whose events hold
    the ranges of :func:`annotate`."""
    from torch.profiler import ProfilerActivity, profile

    from ..protocols.commit import resolve_device

    device = resolve_device(device)
    logdir = logdir or os.path.join(tempfile.gettempdir(), "ringzk_trace")
    os.makedirs(logdir, exist_ok=True)
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _on_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def device_work(events) -> list:
    """The device events of a profile that are work, kernels and memory
    operations: every CUDA event but the ranges' spans."""
    return [e for e in events if _on_device(e) and not e.is_user_annotation]


def device_ranges(events, since_us: float = float("-inf")) -> dict:
    """{range name: device ms} of a profile's events: each kernel or memory
    operation that starts at or after ``since_us`` counts for the shortest
    range span on its stream that holds it, the innermost range it was
    launched in (a span holds the work of its own range only, so the time
    of a nested range is not its parent's). Work outside every range counts
    for none."""
    spans = sorted((e for e in events if _on_device(e) and e.is_user_annotation),
                   key=lambda e: e.time_range.elapsed_us())
    out = {}
    for w in device_work(events):
        t = w.time_range
        if t.start < since_us:
            continue
        span = next((s for s in spans if s.device_resource_id == w.device_resource_id
                     and s.time_range.start <= t.start and t.end <= s.time_range.end), None)
        if span is not None:
            out[span.name] = out.get(span.name, 0.0) + t.elapsed_us() / 1e3
    return out


def range_parents(events) -> dict:
    """{range name: the name of the range it ran in, or None} from the
    host side of a profile, whose ranges nest as the calls do."""
    parents = {}
    for e in events:
        if _on_device(e) or not e.is_user_annotation:
            continue
        up = e.cpu_parent
        while up is not None and not up.is_user_annotation:
            up = up.cpu_parent
        parents.setdefault(e.name, None if up is None else up.name)
    return parents


class Timer:
    """Wall-clock phase timer with a report() table (host-side; for
    device-accurate numbers use device_trace)."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [
            f"{k:32s} {v * 1e3:10.2f} ms {100 * v / total:5.1f}%"
            for k, v in sorted(self.phases.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
