#!/usr/bin/env python
"""Two-process prover/verifier over the RZK1 wire format, on the PyTorch
package.

The verifier starts the prover as a fresh interpreter (``subprocess``, not
fork: a CUDA context does not survive a fork) and the two exchange RZK1
blobs over the prover's stdin and stdout, each behind a u64 length prefix:
the key (a1, a2 and their NTT images only, so the prover's key matvecs take
the NTT path, kernels K1 and K2), then the three moves of the open proof.
On the card both processes share it; the prover loads the kernel library
the verifier built, cached by its digest under ``build/``.

Run on the card:    python examples_torch/two_party.py
or on the CPU:      python examples_torch/two_party.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import struct
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from ringzk_tpu_torch import Params, fresh_key, prepare_value  # noqa: E402
from ringzk_tpu_torch.protocols import open as open_mod  # noqa: E402
from ringzk_tpu_torch.protocols.commit import CommitmentKey, keygen, resolve_device  # noqa: E402
from ringzk_tpu_torch.utils import serial  # noqa: E402

N = 64


def send(stream, blob: bytes) -> None:
    stream.write(struct.pack("<Q", len(blob)))
    stream.write(blob)
    stream.flush()


def recv(stream) -> bytes:
    head = stream.read(8)
    if len(head) != 8:
        raise EOFError("the other party closed the pipe")
    return stream.read(struct.unpack("<Q", head)[0])


def prover_main(device: torch.device) -> None:
    """Child process: the prover side of the 3-move protocol."""
    params = Params()
    out, inp = sys.stdout.buffer, sys.stdin.buffer
    ck = serial.rebuild(CommitmentKey, serial.loads(recv(inp)), device=device)
    x = prepare_value(params, [[1, 2, 3, 4]], N, device)
    rctx, pcom = open_mod.prover_commit(fresh_key(device=device), ck, x, params)
    send(out, serial.dumps(pcom))                                        # move 1
    chal = serial.rebuild(open_mod.OpenProofChallenge, serial.loads(recv(inp)),
                          device=device)                                 # move 2
    send(out, serial.dumps(open_mod.create_response(rctx, chal, params)))  # move 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu', or default: the CUDA card")
    ap.add_argument("--prover", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.prover:
        prover_main(device)
        return 0
    params = Params()
    ck = keygen(torch.Generator(device=device).manual_seed(0), params, N, device)
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--prover", "--device", str(device)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=os.environ,
    )
    try:
        # the int8 digit operators are derivable and stay local
        send(child.stdin, serial.dumps(ck._replace(a1_dig=None, a2_dig=None)))
        pcom = serial.rebuild(open_mod.OpenProofCommitment, serial.loads(recv(child.stdout)),
                              device=device)                             # move 1
        # the challenge is the soundness-critical draw: a generator seeded
        # from OS entropy (fresh_key), never a constant the prover can know
        vctx, chal = open_mod.generate_challenge(fresh_key(device=device), pcom, params)
        send(child.stdin, serial.dumps(chal))                            # move 2
        resp = serial.rebuild(open_mod.OpenProofResponse, serial.loads(recv(child.stdout)),
                              device=device)                             # move 3
        ok = bool(open_mod.verify(ck, resp, vctx, params).all())
        print(f"two-party open proof verified: {ok} (prover pid {child.pid}, {device})",
              flush=True)
    finally:
        child.stdin.close()
        code = child.wait(timeout=600)
    return 0 if ok and code == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
