"""Phase and op ranges, and device traces.

Port of ``ringzk_tpu.utils.profiling``. The protocol phase functions of
``protocols/{commit,open,linear,sum}.py`` carry :func:`annotate` ranges
under the JAX package's names (``commit_scheme/commit``,
``open_proof/verify``, ...), each round trip one range around its whole
call (``open_proof/roundtrip``, chains included) and the dp all-reduce one
(``mesh/all_verified``). The ring algebra's and the key matvec's functions
carry op ranges (``key_matvec``, ``ntt_fwd``, ``norm``, ... : :data:`OPS`),
so one profiled call splits its host and device time by phase and by op:

* a name with a ``/`` is a phase's and records as given; a bare name is an
  op's and records under the innermost open range of the program as
  ``<that range's recorded name>/<op>`` (``open_proof/verify/key_matvec``),
  or as just ``<op>`` outside every range. Each recorded name so has one
  parent, and an op's time stays with the phase it ran in. A range opened
  inside an open range of the same op (or of the same phase name) opens
  none: ``sum_to_centered`` calling ``inv`` is one ``ntt_inv`` range, a
  chained round trip one ``<proof>/roundtrip`` range;
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

A range enters ``record_function`` only while a profiler listens
(:func:`enabled`). With none, a range is one check of that flag and keeps
no state; ``record_function`` itself costs several microseconds a range
on the host even then.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import threading
import time

import torch

# The ops whose functions carry op ranges (the ring algebra's and the key
# matvec's): the last part of every recorded name that is not a phase's.
OPS = ("key_matvec", "ntt_fwd", "ntt_inv", "pointwise", "scalar_mul_add", "challenge",
       "sample", "norm", "modq")

_profiler_enabled = torch._C._autograd._profiler_enabled
_local = threading.local()


def enabled() -> bool:
    """Whether a profiler listens (``torch.profiler.profile``, the
    autograd profiler, ``emit_nvtx``): the check ``record_function``
    itself rests on."""
    return _profiler_enabled()


def _open_ranges() -> list:
    """This thread's open ranges of the program, innermost last, by their
    recorded names (kept only while a profiler listens)."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Range:
    """An entered ``record_function`` under the name :func:`span` gives it."""

    __slots__ = ("name", "rf")

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def __enter__(self):
        stack = _open_ranges()
        top = stack[-1] if stack else None
        if top is not None and (top == self.name or top.endswith("/" + self.name)):
            return self                      # re-entered: the open range holds it
        name = self.name if top is None or "/" in self.name else f"{top}/{self.name}"
        self.rf = torch.profiler.record_function(name)
        self.rf.__enter__()
        stack.append(name)
        return self

    def __exit__(self, *exc):
        if self.rf is None:
            return False
        try:
            self.rf.__exit__(*exc)
        finally:
            _open_ranges().pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager: the block runs inside the range ``name`` (see the
    module's docstring for how the range is named) while a profiler
    listens, and bare otherwise."""
    return _Range(name) if _profiler_enabled() else _OFF


def annotate(name: str):
    """Decorator: runs the function inside :func:`span` ``(name)``, and
    straight through, without entering a context, while no profiler
    listens."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with span(name):
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
