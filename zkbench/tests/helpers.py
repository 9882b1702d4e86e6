"""Runs of a cell on the CPU at a small size, in this process."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from zkbench import core

SMALL_N, SMALL_B = 64, 8
# the four-card cell, as a later entry in BENCHMARK.json would add it
DP = {"name": "open-n512-dp4-b131072", "config": "rzk-default-n512",
      "traffic": "dp-open-b131072", "chips": 4, "why": "the dp path over four ranks"}
# a wide ring (q = 2^33+9, ring-zk's other default parameters), as a later
# configuration would add it, under the open and the sum mixes
Q33 = 2**33 + 9
WIDE = {"name": "rzk-wide-q2e33", "source": "a wide ring of the port",
        "file": "zkbench/configs/rzk-wide-q2e33.json", "reduced": [],
        "why": "q = 2^33+9: K7, K8, int64 residues"}
WIDE_CELLS = [{"name": f"{traffic.split('-')[0]}-q2e33", "config": WIDE["name"],
               "traffic": traffic, "chips": 1, "why": "the wide ring"}
              for traffic in ("open-b131072", "sum-vl4-b24576")]


def small_checkout(root: Path) -> Path:
    """A checkout of the benchmark at a small size under ``root``: the
    benchmark copied, every configuration at degree SMALL_N and every
    traffic mix at SMALL_B proofs a card, the dp cell and the wide ring's
    configuration and cells added to BENCHMARK.json, and the port linked."""
    shutil.copytree(core.HERE, root / "zkbench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "ringzk_tpu_torch").symlink_to(core.ROOT / "ringzk_tpu_torch")
    spec = core.load_spec()
    names = [w["name"] for w in spec["workloads"]]
    spec["workloads"] += [w for w in [DP] + WIDE_CELLS if w["name"] not in names]
    if WIDE["name"] not in [c["name"] for c in spec["configs"]]:
        spec["configs"].append(WIDE)
        base = json.loads((root / spec["configs"][0]["file"]).read_text())
        (root / WIDE["file"]).write_text(json.dumps(dict(
            base, name=WIDE["name"], source=WIDE["source"],
            params=dict(base["params"], q=Q33 // 2, modulus=Q33))))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for conf in spec["configs"]:
        path = root / conf["file"]
        path.write_text(json.dumps(dict(json.loads(path.read_text()), N=SMALL_N)))
    for w in spec["workloads"]:
        path = root / "zkbench" / "workloads" / f"{w['traffic']}.json"
        traffic = json.loads(path.read_text())
        path.write_text(json.dumps(dict(traffic, batch=SMALL_B * w["chips"])))
    return root


def cpu_cell(name: str, root: Path):
    return core.find_cell(core.load_spec(root), name, root)


def driver(cell):
    return core.load_module(core.HERE / "drivers" / f"{cell.traffic['driver']}.py",
                            f"drivers.{cell.traffic['driver']}")


def run_cpu(name: str, root: Path, seed: int = 2**31 + 99, seconds: float = 0.5) -> dict:
    """The result line of one run of cell ``name`` of the checkout ``root``
    on the CPU."""
    cell = cpu_cell(name, root)
    t_proc = core.process_start()
    ctx = SimpleNamespace(cell=cell, seed=seed, seconds=seconds, trace=False,
                          device=torch.device("cpu"), t_proc=t_proc,
                          marks=[("start", t_proc), ("harness imported", time.time())], root=root)
    line, _ = driver(cell).run(ctx)
    return line


def run_cli(*args, timeout=600):
    """run.py in a process of its own: (exit code, stdout, stderr)."""
    import subprocess

    p = subprocess.run([sys.executable, str(core.HERE / "run.py"), *args], capture_output=True,
                       text=True, timeout=timeout, cwd=core.ROOT)
    return p.returncode, p.stdout, p.stderr
