"""Device ms a step of the collective kernels (NCCL) on rank 0, from the
traced window."""


def read(obs):
    t = obs.trace
    if t is None or t.kinds.get("nccl", 0.0) <= 0:
        return None
    return t.kinds["nccl"] / t.batches
