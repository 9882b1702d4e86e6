#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 zkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port,
``ringzk_tpu_torch``. The cell (``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; the run makes the key and a pool of
messages on the card from the seed, warms every shape up, measures for
``--seconds`` seconds, and with ``--trace 1`` traces a window after that.
Then the plain reference (``zkbench/reference/``) judges the sampled
proofs. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``, and a ``breakdown``), the cards' power limit,
and last ``checks``: each number compared beside its limit, which are also
the last lines of standard error.

Exit codes: 0 with a result line; 1 when the run failed (a traceback on
standard error); 2 when the cell's files are missing or unknown; 3 when
CUDA is not available or has fewer cards than the cell asks for; 4 when a
module of jax, jaxlib, flax or the JAX package ``ringzk_tpu`` is loaded.
A four-card cell starts its other ranks itself (``drivers/dp_open.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from zkbench import core

    t_proc = core.process_start()
    if found := core.forbidden_modules():
        print(f"forbidden modules loaded at start: {found}", file=sys.stderr)
        return 4
    marks = [("start", t_proc), ("python, torch and the harness imported", time.time())]
    try:
        cell = core.find_cell(core.load_spec(ROOT), args.workload, ROOT)
        drv = core.load_module(core.HERE / "drivers" / f"{cell.traffic['driver']}.py",
                               f"drivers.{cell.traffic['driver']}")
    except (core.CellError, KeyError, ValueError) as e:
        print(f"cannot run {args.workload}: {e}", file=sys.stderr)
        return 2
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {n} available", file=sys.stderr)
        return 3
    marks.append(("CUDA driver initialised", time.time()))
    core.pin_caches(ROOT)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    ctx = SimpleNamespace(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda", 0),
                          t_proc=t_proc, marks=marks, root=ROOT)
    try:
        line, err = drv.run(ctx)
    except Exception:
        traceback.print_exc()
        return 1
    if found := core.forbidden_modules():
        print(f"forbidden modules loaded once the window closed: {found}", file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    print("\n".join(err), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
