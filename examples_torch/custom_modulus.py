#!/usr/bin/env python
"""Custom parameter sets: the genericity envelope in user code, on the
PyTorch package.

The modulus is a run-time ``Params`` field: any odd modulus below 2^63 with
a power-of-two ring degree works, and the key engine follows from it. Small
moduli keep the int8 digit key path (kernel K3); moduli within ~16.8M of
2^32 exceed the four digits' capacity and take the exact CRT-NTT key path
(K1, K2); moduli of 2^32 and above run the wide int64 ring (K7, K8). Norm
bounds, the challenge and the three sigma protocols do not depend on the
modulus. Each set runs 16 open proofs at N=64 and prints the engine its key
took.

Run on the card:              python examples_torch/custom_modulus.py
or on the CPU:                python examples_torch/custom_modulus.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from ringzk_tpu_torch import Params  # noqa: E402
from ringzk_tpu_torch.ops.ntt import get_ring  # noqa: E402
from ringzk_tpu_torch.protocols import open as open_mod  # noqa: E402
from ringzk_tpu_torch.protocols.commit import keygen, resolve_device  # noqa: E402

N = 64
PROOFS = 16

CONFIGS = [
    ("reference default (q ~ 2^31.7)", Params()),
    ("small 15-bit prime", Params(q=32749 // 2, modulus=32749)),
    ("2^32 - 5 (Montgomery carry regime)", Params(q=4294967291 // 2, modulus=4294967291)),
    ("wider key matrix, 2 msg rows", Params(n=2, k=6, l=2)),
    ("WIDE 2^33 + 9 (int64 ring)", Params(q=(2**33 + 9) // 2, modulus=2**33 + 9)),
    ("WIDE largest prime < 2^63",
     Params(q=9223372036854775783 // 2, modulus=9223372036854775783)),
]


def key_engine(ck, params: Params) -> str:
    """The engine a key's matvecs take: the int8 digits where ``keygen``
    built digit operators, else the wide ring or the CRT-NTT path."""
    if ck.a1_dig is not None:
        return "int8 digits"
    return "wide ring" if get_ring(ck.n_deg, params.modulus).wide else "CRT-NTT"


def run_config(name: str, params: Params, device: torch.device) -> tuple:
    """16 open proofs under ``params``: (engine, all verified)."""
    params.validate()
    gen = torch.Generator(device=device).manual_seed(1)
    ck = keygen(gen, params, N, device)
    ring = get_ring(N, params.modulus)
    x = torch.randint(-params.q, params.q + 1, (PROOFS, params.l, N), generator=gen,
                      device=device, dtype=torch.int64).to(ring.dtype)
    ok, opening_ok = open_mod.roundtrip(gen, ck, x, params)
    verified = bool((ok & opening_ok).all())
    engine = key_engine(ck, params)
    print(f"{name:40s} modulus={params.modulus:>19d} sigma={params.standard_deviation(N):>6d} "
          f"key engine={engine:12s} {PROOFS}/{PROOFS} proofs ok={verified}", flush=True)
    return engine, verified


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu', or default: the CUDA card")
    device = resolve_device(ap.parse_args(argv).device)
    results = [run_config(name, params, device) for name, params in CONFIGS]
    return 0 if all(ok for _, ok in results) else 1


if __name__ == "__main__":
    sys.exit(main())
