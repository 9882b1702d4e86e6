#!/usr/bin/env python3
"""The control of the benchmark's comparison: the plain reference put in
the program's place and computed one precision lower, judged as a run's
sampled proofs are. It has to come out as not correct.

    python3 zkbench/control.py --workload <name> --seeds <n> [<n> ...] [--batches B]

For each seed it makes the cell's key and message pool as a run does, at
the cell's batch, samples the rows of ``--batches`` batches as a run
does, and has ``reference/<protocol>.py``'s ``produce`` prove and verify
those rows from its own draws with every ring product's exact integer sum
kept to 32 bits (``Arith(wrap32=True)``), as a 32-bit accumulator would
hold it, before the reduction mod q: the step below the 64-bit
accumulation that exact products mod a 32-bit q need (on a wide ring,
whose products need more than 64 bits, a step further below). Only the
sampled rows are computed, since the comparison reads no other. ``judge`` then
compares them with the exact reference, and the script prints each seed's
numbers beside their limits and the verdict. It does not run the program.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def control_rows(cell, seed: int, batches: int, device, wrap32: bool = True):
    """(rows, tampered verdicts, expected rows) of the reference in the
    program's place over ``batches`` batches of the cell, from the seed."""
    from zkbench import core
    from zkbench.reference.common import Arith, Scheme, key_matrices

    tr, n_deg = cell.traffic, cell.cfg["N"]
    params = core.params_of(cell.cfg)
    drv = core.load_module(core.HERE / "drivers" / f"{tr['driver']}.py", f"drivers.{tr['driver']}")
    ref = core.load_module(core.HERE / "reference" / f"{drv.PROTOCOL}.py",
                           f"reference.{drv.PROTOCOL}")
    a1p, a2p = core.key_parts(params, n_deg, seed, device)
    batch = tr["batch"]
    pool = core.make_pool(drv, params, n_deg, tr, batch, seed, device)
    per = tr["check_rows_per_batch"] * cell.chips
    table = core.sample_table(core.derive_seed(seed, "rank", 0), batch, per)
    picked = [tuple(t.index_select(0, torch.as_tensor(table[i], device=device))
                    for t in pool[i % len(pool)]) for i in range(batches)]
    inputs = tuple(torch.cat(parts) for parts in zip(*picked))
    del pool
    scheme = Scheme.of(cell.cfg)
    a1, a2 = key_matrices(scheme, a1p, a2p)
    ar = Arith(scheme.modulus, wrap32=wrap32)
    gen = core.generator(device, seed, "control")
    rows = ref.produce(scheme, inputs[0] if drv.PROTOCOL == "open" else inputs, a1, a2, ar, gen)
    tampered = {}
    names = ("z",) if drv.PROTOCOL == "open" else ("zp", "zs")
    resp = collections.namedtuple("Response", names)(*(rows[k] for k in names))
    from zkbench.tamper import tampered as copies

    for name, bad in copies(drv.PROTOCOL, resp, scheme.verify_bound + 1,
                            core.is_wide(params)).items():
        fields = bad._asdict()
        tampered[name] = (ref.reverify(scheme, {**rows, **fields}, a1, a2, ar), fields)
    return rows, tampered, batches * per, (a1p, a2p), drv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=None,
                    help="batches sampled a seed (default: as many as the traffic's "
                         "'control_batches')")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from zkbench import core

    cell = core.find_cell(core.load_spec(ROOT), args.workload, ROOT)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    batches = args.batches or cell.traffic["control_batches"]
    for seed in args.seeds:
        rows, tampered, expected, (a1p, a2p), drv = control_rows(cell, seed, batches, device)
        judged = core.reference_check(cell, drv, rows, a1p, a2p, tampered, expected, device)
        line = {"workload": args.workload, "seed": seed, "device": str(device),
                "correct": core.passed(judged["checks"]),
                "checks": {k: v[0] for k, v in judged["checks"].items()},
                "per_check": judged["per_check"]}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
