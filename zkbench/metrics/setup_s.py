"""From the start of the process (rank 0's in a multi-card cell) to the
first timed batch: imports, the kernel build at a checkout's first run,
the key, the message pool and the warm-up batches."""


def read(obs):
    return obs.setup_s
