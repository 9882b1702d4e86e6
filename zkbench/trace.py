"""A traced window and what the per-layer readers take from it.

The method is ``chip_smoke.py``'s ``device_split`` (as of the commit that
added this benchmark), frozen here and widened from one call to a window
of several: the first call runs under the profiler before a spin kernel
and takes the profiler's start-up, whose first kernels can go unrecorded;
only device work that starts after the spin counts. Device work is every
kernel and memory operation (``profiling.device_work``): the spans that
the program's phase ranges leave on the device timeline overlap them and
are left out.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from .roofline.bounds import KERNEL_NAMES

HARNESS = "zkbench/"   # prefix of the benchmark's own ranges
NAME_CHARS = 120       # kernel names in the breakdown are cut to this length


def kind(name: str) -> str:
    """K1-K11 by the frozen kernel names, "nccl" for the collectives,
    "other" for the rest (plain torch passes)."""
    k = next((k for k, sub in KERNEL_NAMES.items() if sub in name), None)
    if k is not None:
        return k
    return "nccl" if "nccl" in name.lower() else "other"


@dataclass
class Trace:
    """A traced window of ``batches`` batches: its host wall (``window_s``),
    the union of device work in it (``busy_s``), device ms by kind (K1-K11,
    "nccl", "harness": work under the benchmark's own ranges, "other"),
    device ms under each of the program's ranges (own work only) and the
    range each ran in, and the breakdown's two lists."""

    batches: int
    window_s: float
    busy_s: float
    kinds: dict
    ranges: dict
    parents: dict
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def nested_ms(self, name: str) -> float:
        """Device ms under range ``name`` with the ranges nested in it."""
        return self.ranges.get(name, 0.0) + sum(
            self.nested_ms(c) for c, up in self.parents.items() if up == name)

    @property
    def device_ms(self) -> float:
        return sum(self.kinds.values())


def traced_window(batch, n: int, device) -> Trace | None:
    """Run ``batch()`` once, a spin, then ``n`` times under torch.profiler;
    each call ends synchronised, as in the measured window. None when the
    profiler recorded no device work after the spin."""
    from torch.profiler import ProfilerActivity, profile

    from ringzk_tpu_torch.utils import profiling

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        batch()
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            batch()
        torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
    events = prof.events()
    work = profiling.device_work(events)
    spins = [e.time_range.end for e in work if "spin_kernel" in e.name]
    if not spins:
        return None
    since = max(spins)
    work = sorted((e for e in work if e.time_range.start >= since),
                  key=lambda e: e.time_range.start)
    if not work:
        return None
    ranges = profiling.device_ranges(events, since_us=since)
    harness_ms = sum(v for k, v in ranges.items() if k.startswith(HARNESS))
    kinds, by_name = {}, {}
    for e in work:
        ms = e.time_range.elapsed_us() / 1e3
        kinds[kind(e.name)] = kinds.get(kind(e.name), 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    # work under the benchmark's ranges is plain torch ("other") by name
    kinds["other"] = kinds.get("other", 0.0) - harness_ms
    kinds["harness"] = harness_ms
    busy_us, gaps, end = 0.0, [], None
    for e in work:
        s, t = e.time_range.start, e.time_range.end
        if end is not None and s > end:
            gaps.append((end, s))
        busy_us += max(0.0, t - max(s, end if end is not None else s))
        end = t if end is None else max(end, t)
    host = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    return Trace(
        batches=n, window_s=wall_s, busy_s=busy_us / 1e6, kinds=kinds,
        ranges={k: v for k, v in ranges.items() if not k.startswith(HARNESS)},
        parents=profiling.range_parents(events),
        device_ops=[[name[:NAME_CHARS], ms / 1e3] for name, ms in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[host_label(host, (a + b) / 2), (b - a) / 1e6] for a, b in
                   sorted(gaps, key=lambda g: g[0] - g[1])[:10]])


def host_label(host_events, t_us: float) -> str:
    """What the host was doing at ``t_us``: the innermost range open then
    (the program's phases, the benchmark's own), else the innermost host
    operation, else "no host operation"."""
    best = None
    for prefer_ranges in (True, False):
        for e in host_events:
            if e.is_user_annotation != prefer_ranges:
                continue
            r = e.time_range
            if r.start <= t_us <= r.end and (best is None or r.elapsed_us() < best[0]):
                best = (r.elapsed_us(), e.name)
        if best is not None:
            return best[1][:NAME_CHARS]
    return "no host operation"
