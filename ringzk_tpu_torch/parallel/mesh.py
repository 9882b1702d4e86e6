"""Data parallelism over proof batches with ``torch.distributed`` (dp).

Port of ``ringzk_tpu.parallel.mesh``. One process per device; the proof
batch axis is split over the ranks of a process group, each rank running
complete sigma-protocol round trips on its own contiguous block of the
batch, and the verifier accept bits are AND-reduced across the ranks: the
collective form of the reference's per-proof bool (the psum batch-verify
of BASELINE.json config 5). The only collectives of a step are that
all-reduce and, on request, an all-gather of the verdicts.

Draws. Every rank holds a generator seeded identically; rank r proves with
``commit.chain_generators(gen, world_size)[r]``. A dp step over W ranks is
therefore, proof for proof, the one-process ``commit.chained_roundtrip``
over W chains (for the round trips, ``roundtrip(gen, ck, *data, params,
chains=W)`` when W > 1): the same contiguous slices, in order, and the same
per-chain generators. A per-rank ``chains=c`` nests inside: rank r's
generator splits again into c chains, so the step equals the one-process
W-chain split whose chains each run ``roundtrip(..., chains=c)``.

The key must be the same on every rank: :func:`replicate` broadcasts rank
0's key matrices and rebuilds the NTT images and digit operators on each
rank (``commit.build_key``); a key derived from one seed on every rank
(``multihost.batch_verify_run``) is the same without a broadcast. A batch
of keys (``keygen``'s ``batch_shape``) is replicated whole and must
broadcast against each rank's block, as against a chain's slice.

No NCCL reduction takes a bool: the AND is a MIN over int32. Collectives
run on the tensors' device, which is the mesh's: the CUDA card of the rank
(``cuda:<LOCAL_RANK>``) with NCCL, or the CPU with gloo.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..params import Params
from ..protocols import commit as commit_mod
from ..protocols import linear as linear_mod
from ..protocols import open as open_mod
from ..protocols import sum as sum_mod
from ..protocols.commit import CommitmentKey
from ..utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A dp axis: a process group (None: the default group), this
    process's rank in it, its size, and the device this rank computes on."""

    group: object
    rank: int
    world_size: int
    device: torch.device


def rank_device(device=None) -> torch.device:
    """The device a rank computes on: ``device`` as given, or the CUDA card
    ``cuda:<LOCAL_RANK>`` (made current) when it is None. Raises when there
    is no card and the caller did not name a device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a gloo group")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    return dev


def make_mesh(ranks=None, device=None) -> Mesh:
    """The dp axis over the global ranks ``ranks`` (a new group, made with
    ``dist.new_group``, which every process must call alike), or over the
    default group when None. ``device``: see :func:`rank_device`."""
    group = None if ranks is None else dist.new_group(list(ranks))
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError(f"rank {dist.get_rank()} is not in the dp group {list(ranks)}")
    return Mesh(group, rank, dist.get_world_size(group), rank_device(device))


def _check_batch(mesh: Mesh, *batch_sizes: int) -> None:
    """All data inputs share one leading batch axis, divisible by the rank
    count."""
    if len(set(batch_sizes)) > 1:
        raise ValueError(f"batch axes disagree across inputs: {batch_sizes}")
    if batch_sizes[0] % mesh.world_size:
        raise ValueError(f"batch {batch_sizes[0]} not divisible by {mesh.world_size} devices")


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous block of the leading batch axis of a tensor,
    or of each tensor of a tuple or list, in rank order (as ``P("dp")``
    places it), on the mesh's device."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(mesh, x) for x in tree)
    _check_batch(mesh, tree.shape[0])
    size = tree.shape[0] // mesh.world_size
    return tree[mesh.rank * size:(mesh.rank + 1) * size].to(mesh.device)


def _src(mesh: Mesh) -> int:
    """The global rank of the group's rank 0."""
    return 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)


def replicate(mesh: Mesh, ck: CommitmentKey | None, params: Params) -> CommitmentKey:
    """Rank 0's key on every rank: its matrices a1 and a2 are broadcast
    (other ranks may pass None) and each rank rebuilds the NTT images and
    digit operators on its device with ``commit.build_key``."""
    meta = [None if ck is None else (tuple(ck.a1.shape), tuple(ck.a2.shape), ck.a1.dtype)]
    dist.broadcast_object_list(meta, src=_src(mesh), group=mesh.group, device=mesh.device)
    shape1, shape2, dtype = meta[0]
    mats = []
    for name, shape in (("a1", shape1), ("a2", shape2)):
        t = (getattr(ck, name).to(mesh.device).contiguous() if mesh.rank == 0
             else torch.empty(shape, dtype=dtype, device=mesh.device))
        dist.broadcast(t, src=_src(mesh), group=mesh.group)
        mats.append(t)
    return commit_mod.build_key(*mats, params)


@annotate("mesh/all_verified")
def all_verified(mesh: Mesh, ok: torch.Tensor) -> torch.Tensor:
    """The AND of every rank's verdicts (a bool scalar tensor, identical on
    all ranks): one all-reduce MIN of an int32 flag."""
    flag = ok.all().to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return flag[0].bool()


def gather_ok(mesh: Mesh, ok: torch.Tensor) -> torch.Tensor:
    """Every rank's verdicts in rank order: the global [B] vector that the
    JAX package's sharded array holds. One all-gather."""
    parts = [torch.empty_like(ok) for _ in range(mesh.world_size)]
    dist.all_gather(parts, ok.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _step_fn(mesh: Mesh, roundtrip, ck: CommitmentKey, params: Params, chains: int = 1):
    """One dp step: (gen, *local data) -> (ok, all_ok). Rank r proves its
    block with generator r of ``chain_generators(gen, world_size)`` (no
    generator is split when gen is None, for round trips whose draws are
    injected), ANDs each proof's verdict with its opening checks, and
    AND-reduces over the ranks. ``roundtrip(gen, ck, *data, params,
    chains=...)`` is a protocol's round trip."""

    def step(gen, *data):
        gen_r = (None if gen is None
                 else commit_mod.chain_generators(gen, mesh.world_size)[mesh.rank])
        ok, op_ok = roundtrip(gen_r, ck, *data, params, chains=chains)
        ok = ok & op_ok
        return ok, all_verified(mesh, ok)

    return step


def open_step_fn(mesh: Mesh, ck: CommitmentKey, params: Params, chains: int = 1):
    """dp open-proof step: (gen, x[B/W, l, N]) -> (ok[B/W], all_ok)."""
    return _step_fn(mesh, open_mod.roundtrip, ck, params, chains)


def linear_step_fn(mesh: Mesh, ck: CommitmentKey, params: Params, chains: int = 1):
    """dp linear-proof step: (gen, g[B/W, N], x[B/W, l, N]) -> (ok, all_ok)."""
    return _step_fn(mesh, linear_mod.roundtrip, ck, params, chains)


def sum_step_fn(mesh: Mesh, ck: CommitmentKey, params: Params, chains: int = 1):
    """dp sum-proof step: (gen, gs[B/W, V, N], xs[B/W, V, l, N]) -> (ok, all_ok)."""
    return _step_fn(mesh, sum_mod.roundtrip, ck, params, chains)


def _batched(step_fn, mesh, gen, ck, data, params, chains):
    _check_batch(mesh, *(a.shape[0] for a in data))
    return step_fn(mesh, ck, params, chains)(gen, *shard_batch(mesh, tuple(data)))


def batched_open_prove_verify(mesh: Mesh, gen, ck: CommitmentKey, x: torch.Tensor,
                              params: Params, chains: int = 1):
    """Full open-proof round trip for the global batch x [B, l, N], each
    rank proving its block. Returns (ok, all_ok): this rank's verdicts
    [B/W] (:func:`gather_ok` gives all of them, [B]) and their AND over
    every rank, identical on all ranks. ``ck`` must be the same on every
    rank (:func:`replicate`)."""
    return _batched(open_step_fn, mesh, gen, ck, (x,), params, chains)


def batched_linear_prove_verify(mesh: Mesh, gen, ck: CommitmentKey, g: torch.Tensor,
                                x: torch.Tensor, params: Params, chains: int = 1):
    """Full linear-proof round trip (x' = g*x) for the global batch g
    [B, N], x [B, l, N]. Returns (ok, all_ok) as
    :func:`batched_open_prove_verify`."""
    return _batched(linear_step_fn, mesh, gen, ck, (g, x), params, chains)


def batched_sum_prove_verify(mesh: Mesh, gen, ck: CommitmentKey, gs: torch.Tensor,
                             xs: torch.Tensor, params: Params, chains: int = 1):
    """Full sum-proof round trip (x' = sum_i g_i*x_i) for the global batch
    gs [B, V, N], xs [B, V, l, N]. Returns (ok, all_ok) as
    :func:`batched_open_prove_verify`."""
    return _batched(sum_step_fn, mesh, gen, ck, (gs, xs), params, chains)
