"""Opening-proof traffic over the cards of one host (dp): every step runs
``ringzk_tpu_torch.parallel.mesh.open_step_fn`` on every rank, that is
``protocols.open.roundtrip`` on the rank's block of the batch, each
proof's verdict ANDed with its opening check, then the int32 MIN
all-reduce ``mesh.all_verified``. One process per card: this process is
rank 0 and prints the line; it starts the others itself (``RANK_CODE``:
the checkout, the store's address and the rank; the run's settings are in
the store) and waits for each.

The ranks meet at a TCP store on localhost (a free port), through which
rank 0 sets once, before the window, how many steps every rank runs (the
window's seconds over its last warm step), so that no step waits on the
store; each rank sends its part of the result through it at the end.
Every rank makes the same key and the same global messages from the
seed, keeps its block, and judges its own sampled rows with the
reference on its card. Two further checks read the all-reduce:
each step's ``all_ok`` on rank 0 against the AND of every rank's
verdicts, and after the window one flag set false on the last rank,
which rank 0's ``all_verified`` must report.
"""

from __future__ import annotations

import json
import math
import socket
import subprocess
import sys
import time
from datetime import timedelta
from types import SimpleNamespace

import torch

from zkbench import core

_open = core.load_module(core.HERE / "drivers" / "open.py", "drivers.open")

PROTOCOL = _open.PROTOCOL
COMMIT_RANGE = _open.COMMIT_RANGE
VERIFY_RANGES = _open.VERIFY_RANGES
VERDICTS = ("okop",)
TIMEOUT = timedelta(seconds=300)

make_inputs = _open.make_inputs
input_fields = _open.input_fields
install = _open.install
tampered = _open.tampered
# this process's steps: each rank's verdicts all true, and all_ok
LOG = {"local": [], "all_ok": []}


class Dist(SimpleNamespace):
    """A rank's place: ``rank``, ``world``, ``store`` and ``mesh``."""

    def go(self, seconds: float, step_s: float):
        """The window: rank 0's count of steps, the seconds over its last
        warm step (``step_s``), run by every rank."""
        n = self.agree("steps", max(1, math.ceil(seconds / step_s)))
        return lambda i, elapsed: i < n

    def agree(self, name: str, value: int) -> int:
        if self.rank == 0:
            self.store.set(name, str(value))
            return value
        return int(self.store.get(name))


def setup(ck, params, gen, traffic, dist, device):
    from ringzk_tpu_torch.parallel import mesh as mesh_mod

    st = _open.setup(ck, params, gen, traffic, dist, device)
    st.mesh_mod, st.mesh = mesh_mod, dist.mesh
    st.step = mesh_mod.open_step_fn(dist.mesh, ck, params, traffic["chains"])
    LOG["local"].clear()
    LOG["all_ok"].clear()
    return st


def local(st, inputs: tuple) -> tuple:
    """This rank's block of the global batch, as a copy of its own."""
    return tuple(t.clone() for t in st.mesh_mod.shard_batch(st.mesh, inputs))


def call(st, inputs: tuple):
    return st.step(st.gen, *inputs)


def verified(ret) -> torch.Tensor:
    ok, all_ok = ret
    LOG["local"].append(ok.all())
    LOG["all_ok"].append(all_ok)
    return ok


def verdict_fields(ret) -> dict:
    return {"okop": ret[0]}


def sync(ret) -> None:
    core.sync_device(ret[0].device)


def extra_checks(st, win) -> dict:
    """The all-reduce after the window: a false flag on the last rank
    only, then true flags everywhere; rank 0's answers must be false,
    then true."""
    dev = st.ck.a1.device
    flags = torch.ones(4, dtype=torch.bool, device=dev)
    if st.mesh.rank == st.mesh.world_size - 1:
        flags[0] = False
    one_false = bool(st.mesh_mod.all_verified(st.mesh, flags))
    all_true = bool(st.mesh_mod.all_verified(st.mesh, torch.ones_like(flags)))
    return {"exchange_wrong": (int(one_false) + int(not all_true), 0, "max")}


def _join(ctx, rank: int, store) -> Dist:
    import torch.distributed as dist

    from ringzk_tpu_torch.parallel import mesh as mesh_mod

    world = ctx.cell.chips
    cuda = core.on_cuda(ctx.device)
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", store=dist.PrefixStore("pg", store),
                            world_size=world, rank=rank, timeout=TIMEOUT)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    return Dist(rank=rank, world=world, store=store, mesh=mesh_mod.make_mesh(None, device=device))


def _part(ctx, dist_ctx) -> dict:
    ctx.device = dist_ctx.mesh.device
    part = core.run_rank(ctx, sys.modules[__name__], dist_ctx)
    flags = [bool(x) for x in torch.stack(LOG["local"]).tolist()] if LOG["local"] else []
    oks = [bool(x) for x in torch.stack(LOG["all_ok"]).tolist()] if LOG["all_ok"] else []
    part.update(local=flags, all_ok=oks)
    return part


# how run() starts a rank other than 0: the checkout's root, the store's
# address and the rank, and nothing else; the run's settings come from the store
RANK_CODE = ("import sys; sys.path.insert(0, sys.argv[1]); from zkbench import core; "
             "core.load_module(core.HERE / 'drivers' / 'dp_open.py', 'drivers.dp_open')"
             ".rank_main(sys.argv[2], int(sys.argv[3]))")


def rank_main(address: str, rank: int) -> None:
    """A rank other than 0, in a process of its own: the run that rank 0
    put in the store, then this rank's part handed back through it."""
    import torch.distributed as dist

    t_proc = core.process_start()
    marks = [("start", t_proc), ("python, torch and the harness imported", time.time())]
    if found := core.forbidden_modules():
        raise RuntimeError(f"forbidden modules loaded at start: {found}")
    host, port = address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), None, False, timeout=TIMEOUT)
    run_spec = json.loads(store.get("run"))
    cell = core.find_cell(core.load_spec(core.ROOT), run_spec["workload"], core.ROOT)
    core.pin_caches(core.ROOT)
    torch.set_num_threads(run_spec["threads"])
    ctx = SimpleNamespace(cell=cell, seed=run_spec["seed"], seconds=run_spec["seconds"],
                          trace=run_spec["trace"], device=torch.device(run_spec["device"]),
                          t_proc=t_proc, marks=marks, root=core.ROOT)
    dist_ctx = _join(ctx, rank, store)
    try:
        part = _part(ctx, dist_ctx)
        t = part.pop("trace")
        part["trace"] = None if t is None else {"busy_s": t.busy_s, "window_s": t.window_s}
        store.set(f"part{rank}", json.dumps(part))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(ctx):
    import torch.distributed as dist

    from ringzk_tpu_torch.ops.kernels import _lib

    if core.on_cuda(ctx.device):
        _lib.build()    # once, before the other ranks look for the library
    world = ctx.cell.chips
    port = _free_port()
    store = dist.TCPStore("127.0.0.1", port, world, True, timeout=TIMEOUT,
                          wait_for_workers=False)
    store.set("run", json.dumps({"workload": ctx.cell.name, "seed": ctx.seed,
                                 "seconds": ctx.seconds, "trace": ctx.trace,
                                 "device": ctx.device.type,
                                 "threads": torch.get_num_threads()}))
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, str(ctx.root),
                               f"127.0.0.1:{port}", str(r)], stdout=sys.stderr)
             for r in range(1, world)]
    try:
        dist_ctx = _join(ctx, 0, store)
        parts = [_part(ctx, dist_ctx)]
        for r in range(1, world):
            part = json.loads(store.get(f"part{r}"))
            if part["trace"] is not None:
                part["trace"] = SimpleNamespace(**part["trace"])
            part["checks"] = {k: tuple(v) for k, v in part["checks"].items()}
            parts.append(part)
        dist.destroy_process_group()
    finally:
        for p in procs:
            try:
                p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    steps = len(parts[0]["all_ok"])
    wrong = sum(1 for i in range(steps)
                if parts[0]["all_ok"][i] != all(p["local"][i] for p in parts))
    parts[0]["checks"]["aggregate_wrong"] = (
        wrong + sum(abs(len(p["local"]) - steps) for p in parts), 0, "max")
    if bad := sorted({m for p in parts for m in p["forbidden"]}):
        raise RuntimeError(f"forbidden modules loaded on a rank: {bad}")
    return core.final(ctx, sys.modules[__name__], parts)
