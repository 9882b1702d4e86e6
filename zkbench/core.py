"""The benchmark's harness: it finds a cell's files by name, sets the cell
up from the seed, runs the measured window, reads the per-layer metrics,
decides ``correct`` with the plain reference, and builds the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the deployment (``params``, ``N``);
* ``workloads/<traffic>.json``: the mix: its driver, batch, summands,
  chains, pool of messages, loop (closed: the only kind the harness
  runs), rows checked a batch;
* ``drivers/<driver>.py``: how one kind of traffic drives the program;
* ``metrics/<metric>.py``: ``read(obs)``, one per per-layer metric;
* ``reference/<protocol>.py`` and ``roofline/<protocol>.py``: the plain
  reference and the kernel work of the mix's protocol.
"""

from __future__ import annotations

import hashlib
import importlib.util
import itertools
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

import numpy as np
import torch

from .roofline.wide import is_wide
from .trace import traced_window

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ringzk_tpu")
GIB = 2**30
# more batches than any window holds: the table of sampled rows is made once
MAX_BATCHES = 20000


class CellError(Exception):
    """The cell cannot run here: a file is missing, no card, a name unknown."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``ringzk_tpu_torch`` is not ``ringzk_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(path: Path, name: str) -> ModuleType:
    """A benchmark file loaded by its path as ``zkbench.<name>``; raises
    CellError when it is missing."""
    if not path.is_file():
        raise CellError(f"no file {path.relative_to(ROOT)}")
    full = f"zkbench.{name}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise CellError("no BENCHMARK.json at the checkout's root")
    return json.loads(path.read_text())


def find_cell(spec: dict, name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name`` of ``spec`` with its configuration, traffic mix,
    driver and per-layer metrics, each found by name."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"no workload named {name!r} in BENCHMARK.json")
    conf = next((c for c in spec["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise CellError(f"no configuration named {entry['config']!r}")
    here = root / HERE.name
    cfg_path = root / conf["file"]
    traffic_path = here / "workloads" / f"{entry['traffic']}.json"
    for p in (cfg_path, traffic_path):
        if not p.is_file():
            raise CellError(f"no file {p.relative_to(root)}")
    cfg = json.loads(cfg_path.read_text())
    traffic = json.loads(traffic_path.read_text())
    if traffic.get("loop", "closed") != "closed":
        raise CellError(f"{entry['traffic']}: the harness runs a closed loop only, "
                        f"not {traffic['loop']!r}")
    per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]
    end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    for m in per_layer:
        if not (here / "metrics" / f"{m['name']}.py").is_file():
            raise CellError(f"no reader metrics/{m['name']}.py")
    if not (here / "drivers" / f"{traffic['driver']}.py").is_file():
        raise CellError(f"no driver drivers/{traffic['driver']}.py")
    return SimpleNamespace(name=name, entry=entry, cfg=cfg, traffic=traffic,
                           chips=entry["chips"], per_layer=per_layer, end_to_end=end_to_end,
                           root=root)


def derive_seed(seed: int, *parts) -> int:
    """63 bits of SHA-256 over the seed and a label: one stream per use."""
    digest = hashlib.sha256(repr((seed,) + parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *parts))


def process_start() -> float:
    """This process's start on the wall clock, from /proc (10 ms ticks)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def pin_caches(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port builds into build/ringzk_tpu_torch/ beside its package; these
    cover what torch and triton would build."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "zkbench-cache" / sub)


def card_power_limit() -> str:
    """nvidia-smi's name and power limit of the cards, or why not read."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Tap:
    """Keeps the sampled rows of tensors the program hands between its
    phases. Drivers wrap the program's phase functions with calls to
    :meth:`grab`; while armed, it copies rows ``idx`` of each tensor's
    leading (batch) axis, under the benchmark's own range."""

    def __init__(self):
        self.idx, self.top, self.rec = None, 0, None

    def arm(self, idx: torch.Tensor, top: int) -> None:
        """Keep rows ``idx`` (on the device), whose largest is ``top``."""
        self.idx, self.top, self.rec = idx, top, {}

    def disarm(self) -> dict | None:
        rec, self.idx, self.rec = self.rec, None, None
        return rec

    def grab(self, **tensors) -> None:
        if self.idx is None:
            return
        with torch.profiler.record_function("zkbench/tap"):
            for name, t in tensors.items():
                if t.shape[0] <= self.top:
                    self.rec[f"short:{name}"] = torch.tensor(t.shape[0])
                else:
                    self.rec[name] = t.index_select(0, self.idx)


def sample_table(seed: int, batch: int, per_batch: int) -> np.ndarray:
    """[MAX_BATCHES, per_batch] row indices per batch, drawn from the seed:
    one in each of per_batch equal strata of the batch, so distinct and
    spread over it."""
    rng = np.random.default_rng(derive_seed(seed, "sample"))
    width = batch // per_batch
    return rng.integers(0, width, size=(MAX_BATCHES, per_batch)) + width * np.arange(per_batch)


def quantile(values: list, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics
    (numpy's default), over every value."""
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def stack_rows(records: list, fields) -> dict:
    """Concatenate the per-batch records that hold every one of ``fields``
    into rows [R, ...] per name; a batch that lacks one is left out, and
    ``rows_compared`` then falls short. A tensor handed with too few rows
    ("short:<name>") is kept for ``judge`` to count."""
    done = [r for r in records if all(f in r for f in fields)]
    rows = {f: torch.cat([r[f] for r in done]) for f in fields} if done else {}
    for r in records:
        rows.update({k: v for k, v in r.items() if k.startswith("short:")})
    return rows


def judge(ref, scheme, rows: dict, a1, a2, ar, tampered: dict, expected_rows: int) -> dict:
    """The numbers ``correct`` compares, each as (value, limit, "max" or
    "min"): rows where any output differs from the reference's, tampered
    copies whose verdict differs from the reference's, and rows compared
    against the rows the window should have given."""
    short = sum(1 for k in rows if k.startswith("short:"))
    got = rows["d"].shape[0] if all(k in rows for k in ref.FIELDS) else 0
    checks = {}
    wrong = torch.zeros(got, dtype=torch.bool, device=a1.device)
    per = {}
    if got:
        for name, mask in ref.check(scheme, rows, a1, a2, ar).items():
            per[name] = int(mask.sum())
            wrong |= mask
        ok_ref, op_ref = ref.verdicts(scheme, rows, a1, a2, ar)
        if "okop" in rows:
            v = rows["okop"].bool() != (ok_ref & op_ref)
            per["verdict"] = int(v.sum())
            wrong |= v
        else:
            for name, mine, theirs in (("verdict", rows["ok"], ok_ref),
                                       ("opening_verdict", rows["op"], op_ref)):
                v = mine.bool() != theirs
                per[name] = int(v.sum())
                wrong |= v
    bad_tamper = 0
    for name, (verdict, fields) in tampered.items():
        want = ref.reverify(scheme, {**rows, **fields}, a1, a2, ar)
        bad_tamper += int((verdict.bool() != want).sum()) + int(bool(verdict.any()))
    checks["rows_wrong"] = (int(wrong.sum()) + short, 0, "max")
    checks["tampered_wrong"] = (bad_tamper, 0, "max")
    checks["rows_compared"] = (got, expected_rows, "min")
    return {"checks": checks, "per_check": per}


def passed(checks: dict) -> bool:
    return all(v <= lim if how == "max" else v >= lim for v, lim, how in checks.values())


class Window(SimpleNamespace):
    """What one rank's measured window gave: ``batches``, ``verified`` and
    ``attempted`` proofs, ``elapsed_s`` from the first launch to the last
    batch's synchronised verdicts, each batch's ``batch_ms`` and
    ``dispatch_ms`` (the call's return, before the synchronise), and the
    sampled ``records``."""


def go_local(seconds: float):
    """A single process's window: a batch may start while the window is open."""
    return lambda i, elapsed: elapsed < seconds


def measure(drv, st, pool: list, tap: Tap, table: np.ndarray, table_dev: torch.Tensor, go,
            sync) -> Window:
    """The closed loop: back-to-back batches, each launched after the one
    before it returned its synchronised verdicts, cycling through the pool,
    while ``go(batch index, seconds since the start)``."""
    batch_ms, dispatch_ms, records, pools = [], [], [], []
    verified = None
    attempted = 0
    start = end = time.perf_counter()
    i = 0
    while go(i, time.perf_counter() - start):
        inputs = pool[i % len(pool)]
        tap.arm(table_dev[i], int(table[i].max()))
        t0 = time.perf_counter()
        ret = drv.call(st, inputs)
        t1 = time.perf_counter()
        with torch.profiler.record_function("zkbench/count"):
            mask = drv.verified(ret)
            tap.grab(**drv.verdict_fields(ret))
            verified = mask.sum() if verified is None else verified + mask.sum()
        sync(ret)
        t2 = end = time.perf_counter()
        records.append(tap.disarm())
        pools.append(i % len(pool))
        attempted += mask.shape[0]
        batch_ms.append((t2 - t0) * 1e3)
        dispatch_ms.append((t1 - t0) * 1e3)
        i += 1
    return Window(batches=i, verified=int(verified) if verified is not None else 0,
                  attempted=attempted, elapsed_s=end - start, batch_ms=batch_ms,
                  dispatch_ms=dispatch_ms, records=records, pools=pools)


def plain_batch(drv, st, inputs, sync) -> None:
    """One batch as the window runs it, with nothing sampled."""
    ret = drv.call(st, inputs)
    with torch.profiler.record_function("zkbench/count"):
        drv.verified(ret).sum()
    sync(ret)


def sampled_inputs(drv, pool: list, win: Window, table: np.ndarray) -> list:
    """The inputs the benchmark handed each recorded batch, at its sampled
    rows: the reference's ``x_in`` (and ``g_in``)."""
    out = []
    for i, p in enumerate(win.pools):
        idx = torch.as_tensor(table[i], device=pool[p][0].device)
        out.append(drv.input_fields(tuple(t.index_select(0, idx) for t in pool[p])))
    return out


def reference_check(cell, drv, rows: dict, a1p, a2p, tampered: dict, expected: int,
                    device) -> dict:
    """The plain reference's judgement of the sampled rows (``judge``), on
    ``device``, after the program's state is freed."""
    from .reference.common import Arith, Scheme, key_matrices

    ref = load_module(HERE / "reference" / f"{drv.PROTOCOL}.py", f"reference.{drv.PROTOCOL}")
    scheme = Scheme.of(cell.cfg)
    a1, a2 = key_matrices(scheme, a1p.to(device), a2p.to(device))
    rows = {k: v.to(device) for k, v in rows.items()}
    tampered = {k: (v.to(device), {f: t.to(device) for f, t in fields.items()})
                for k, (v, fields) in tampered.items()}
    with torch.no_grad():
        return judge(ref, scheme, rows, a1, a2, Arith(scheme.modulus), tampered, expected)


def read_metrics(cell, specs: list, obs) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader found
    something to read."""
    out = {}
    for m in specs:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py", f"metrics.{m['name']}")
        value = reader.read(obs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_lines(checks: dict) -> list:
    return [f"check {name}: {v} (limit {'<=' if how == 'max' else '>='} {lim})"
            for name, (v, lim, how) in checks.items()]


def result_line(cell, trace_on: bool, obs, checks: dict, device_info: dict,
                breakdown: dict | None) -> dict:
    metrics = read_metrics(cell, cell.per_layer if trace_on else cell.end_to_end, obs)
    out = {"correct": passed(checks), "attempted": obs.attempted,
           "failed": obs.attempted - obs.verified, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["power_limit"] = card_power_limit()
    out["checks"] = {name: {"value": v, "limit": lim, "kind": how}
                     for name, (v, lim, how) in checks.items()}
    return out


def on_cuda(dev) -> bool:
    return torch.device(dev).type == "cuda"


def sync_device(dev) -> None:
    if on_cuda(dev):
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if on_cuda(dev) else 0


def params_of(cfg: dict):
    from ringzk_tpu_torch.params import Params

    p = cfg["params"]
    return Params(q=p["q"], b=p["b"], n=p["n"], k=p["k"], l=p["l"], kappa=p["kappa"],
                  modulus=p["modulus"])


def draw_dtype(bound: int) -> torch.dtype:
    """The dtype of uniform draws in [-bound, bound]: int32 where the range
    fits it (every narrow ring's sampling bound), int64 from 2^31 on (the
    wide rings', q >= 2^32)."""
    return torch.int32 if bound < 2**31 else torch.int64


def uniform(gen: torch.Generator, bound: int, shape: tuple, dev) -> torch.Tensor:
    """Uniform integers in [-bound, bound] of ``shape`` from ``gen``, in
    ``draw_dtype(bound)``: the one draw of the key's parts and of every
    driver's messages."""
    return torch.randint(-bound, bound + 1, shape, generator=gen, device=dev,
                         dtype=draw_dtype(bound))


def key_parts(params, n_deg: int, seed: int, dev) -> tuple:
    """The key's uniform parts a1p [n, k-n, N], a2p [l, k-n-l, N] in
    [-q, q], from the seed: the benchmark's, handed to the program's
    ``keygen`` and to the reference alike."""
    gen = generator(dev, seed, "key")
    return tuple(uniform(gen, params.q, (rows, cols, n_deg), dev)
                 for rows, cols in ((params.n, params.k - params.n),
                                    (params.l, params.k - params.n - params.l)))


def response_rows(params, t: torch.Tensor) -> torch.Tensor:
    """Sampled response rows as the tampered copies start from them:
    contiguous, and int64 on a wide ring, so that a copy can hold -2^63
    whatever dtype the program handed."""
    return t.to(torch.int64).contiguous() if is_wide(params) else t.contiguous()


def make_pool(drv, params, n_deg: int, traffic: dict, batch: int, seed: int, dev) -> list:
    """The traffic's pool of message batches, from the seed."""
    gen = generator(dev, seed, "pool")
    return [drv.make_inputs(params, n_deg, traffic, batch, gen, dev)
            for _ in range(traffic["pool"])]


def run_rank(ctx, drv, dist_ctx=None) -> dict:
    """One rank's run of the cell: set-up from the seed, the measured
    window, with ``ctx.trace`` a traced window after it, the program's
    verdicts on tampered copies, then, with the program's state freed, the
    reference's judgement. Returns this rank's part of the result."""
    from ringzk_tpu_torch.protocols.commit import keygen

    cell, seed, dev = ctx.cell, ctx.seed, ctx.device
    tr, n_deg = cell.traffic, cell.cfg["N"]
    params = params_of(cell.cfg)
    marks = ctx.marks + [("the port imported", time.time())]
    if on_cuda(dev):
        torch.zeros(1, device=dev)
        sync_device(dev)
        marks.append(("CUDA context", time.time()))
    a1p, a2p = key_parts(params, n_deg, seed, dev)
    ck = keygen(None, params, n_deg, device=dev, a1p=a1p, a2p=a2p)
    sync_device(dev)
    marks.append(("key (the kernel build at a checkout's first run)", time.time()))
    batch = tr["batch"]
    pool = make_pool(drv, params, n_deg, tr, batch, seed, dev)
    st = drv.setup(ck=ck, params=params, gen=generator(dev, seed, "proofs"), traffic=tr,
                   dist=dist_ctx, device=dev)
    pool = [drv.local(st, x) for x in pool]
    rank = dist_ctx.rank if dist_ctx else 0
    table = sample_table(derive_seed(seed, "rank", rank), pool[0][0].shape[0],
                         tr["check_rows_per_batch"])
    table_dev = torch.as_tensor(table, device=dev)
    tap = Tap()
    restore = drv.install(tap, st)
    try:
        sync_device(dev)
        marks.append(("pool and sample table", time.time()))
        # the warm batches run as the window's do, taps and counts included, so
        # that every kernel the window launches is loaded before it opens
        warm = measure(drv, st, pool, tap, table, table_dev,
                       lambda i, elapsed: i < tr["warmup"], drv.sync)
        sync_device(dev)
        marks.append(("warm batches", time.time()))
        setup_peak = peak_bytes(dev)
        if on_cuda(dev):
            torch.cuda.reset_peak_memory_stats(dev)
        t_window = time.time()
        step_s = warm.batch_ms[-1] / 1e3
        go = go_local(ctx.seconds) if dist_ctx is None else dist_ctx.go(ctx.seconds, step_s)
        win = measure(drv, st, pool, tap, table, table_dev, go, drv.sync)
        sync_device(dev)
        win_peak = peak_bytes(dev)
        trace = None
        if ctx.trace and on_cuda(dev):
            n = max(3, math.ceil(1000.0 / statistics.median(win.batch_ms))) if win.batch_ms else 3
            if dist_ctx is not None:
                n = dist_ctx.agree("traced", n)
            turn = itertools.count()
            trace = traced_window(lambda: plain_batch(drv, st, pool[next(turn) % len(pool)],
                                                      drv.sync), n, dev)
        ref = load_module(HERE / "reference" / f"{drv.PROTOCOL}.py",
                          f"reference.{drv.PROTOCOL}")
        for rec, fields in zip(win.records, sampled_inputs(drv, pool, win, table)):
            rec.update(fields)
        rows = stack_rows(win.records, ref.FIELDS + drv.VERDICTS)
        tampered = drv.tampered(st, rows) if "d" in rows else {}
        extra = drv.extra_checks(st, win)
    finally:
        restore()
    found = forbidden_modules()
    expected = win.batches * tr["check_rows_per_batch"]
    del st, ck, pool, tap, table_dev
    if on_cuda(dev):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    judged = reference_check(cell, drv, rows, a1p, a2p, tampered, expected, dev)
    reference_s = time.perf_counter() - t_ref
    judged["checks"].update(extra)
    return {"verified": win.verified, "attempted": win.attempted, "elapsed_s": win.elapsed_s,
            "batches": win.batches, "batch_ms": win.batch_ms, "dispatch_ms": win.dispatch_ms,
            "setup_peak": setup_peak, "window_peak": win_peak, "t_window": t_window,
            "trace": trace, "forbidden": found, "checks": judged["checks"],
            "per_check": judged["per_check"], "batch": batch, "reference_s": reference_s,
            "setup": [[name, t - prev] for (_, prev), (name, t) in zip(marks, marks[1:])]}


def merge_checks(parts: list) -> dict:
    """The ranks' checks added up (a "min" check against the added limits)."""
    out = {}
    for part in parts:
        for name, (v, lim, how) in part.items():
            if name in out:
                ov, ol, _ = out[name]
                out[name] = (ov + v, ol + lim, how)
            else:
                out[name] = (v, lim, how)
    return out


def batch_spread(batch_ms: list) -> str:
    """The window's batch times in a few numbers, to tell a stall (a few
    slow batches) from a slower card (every batch slower)."""
    if not batch_ms:
        return "none"
    med = statistics.median(batch_ms)
    slow = [i for i, b in enumerate(batch_ms) if b > 1.5 * med]
    return (f"median {med:.3f} ms, slowest {max(batch_ms):.3f} ms, {len(slow)} over 1.5 times "
            f"the median ({sum(batch_ms[i] for i in slow) / 1e3:.3f} s; batches {slow[:8]})")


def final(ctx, drv, parts: list) -> tuple:
    """(result line, lines for standard error) from every rank's part; the
    first part is rank 0's, whose clock and trace the line reports."""
    from .reference.common import Scheme

    cell, p0 = ctx.cell, parts[0]
    roof = load_module(HERE / "roofline" / f"{drv.PROTOCOL}.py", f"roofline.{drv.PROTOCOL}")
    obs = SimpleNamespace(
        cell=cell, driver=drv, world=len(parts),
        verified=sum(p["verified"] for p in parts), attempted=sum(p["attempted"] for p in parts),
        elapsed_s=p0["elapsed_s"], batch_ms=p0["batch_ms"], dispatch_ms=p0["dispatch_ms"],
        peak_bytes=max(p["window_peak"] for p in parts), setup_s=p0["t_window"] - ctx.t_proc,
        trace=p0["trace"],
        work=roof.work(Scheme.of(cell.cfg), p0["batch"] // len(parts),
                       cell.traffic.get("vl", 0)))
    checks = merge_checks([p["checks"] for p in parts])
    device = {"platform": "gpu" if on_cuda(ctx.device) else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_cuda(ctx.device) else "cpu",
              "count": len(parts),
              "memory_peak_bytes": max(max(p["setup_peak"], p["window_peak"]) for p in parts)}
    breakdown = None
    traces = [p["trace"] for p in parts]
    if ctx.trace and all(t is not None for t in traces):
        device["busy_s"] = sum(t.busy_s for t in traces) / len(traces)
        device["window_s"] = sum(t.window_s for t in traces) / len(traces)
        breakdown = {"device_ops": p0["trace"].device_ops, "idle_gaps": p0["trace"].idle_gaps}
    line = result_line(cell, ctx.trace, obs, checks, device, breakdown)
    per = {}
    for p in parts:
        for k, v in p["per_check"].items():
            per[k] = per.get(k, 0) + v
    err = ["set-up s on rank 0: " + ", ".join(f"{name} {s:.3f}" for name, s in p0["setup"]),
           f"reference s on rank 0: {p0['reference_s']:.3f} over "
           f"{p0['checks']['rows_compared'][0]} rows",
           f"rows wrong by check: {json.dumps(per, sort_keys=True)}",
           f"window: {p0['batches']} batches on rank 0, "
           f"{obs.verified} of {obs.attempted} proofs verified in {obs.elapsed_s:.3f} s; "
           f"card: {line['power_limit']}",
           "batches on rank 0: " + batch_spread(p0["batch_ms"])] + check_lines(checks)
    return line, err


def single(ctx, drv) -> tuple:
    """A one-process cell: one rank, this process."""
    return final(ctx, drv, [run_rank(ctx, drv)])
