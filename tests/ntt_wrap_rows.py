"""Rows that reach the wrap of K9's butterflies.

Shared by tests/test_torch_ntt_one.py (the port's plain versions against
the JAX package on these rows) and tests/test_torch_cuda.py (K9 against its
plain version on the card). Imports numpy only.

K9 takes uint32 input as given, and the JAX package's MontCtx.sub returns
the wrapped difference a - b, plus p where a < b, while a difference
taken as min(d, d + p) returns another value where a >= 2^32 - p beside a
small b, or a small a beside b >= 2^32 - p. These rows put such pairs on
the first stage of both transforms: the forward pairs lane j with j + N/2,
the inverse lane 2k with 2k + 1.
"""

import numpy as np


def wrap_rows(rows: int, n: int, p: int, rng) -> np.ndarray:
    """uint32 [rows, n]: in the lower half the even lanes lie at or above
    2^32 - p and the odd lanes are small, in the upper half the other way
    round; lane 0 is 2^32 - 1 and lane N/2 is 0."""
    lane = np.arange(n)
    big = (lane < n // 2) == (lane % 2 == 0)
    x = np.where(big, 2**32 - p + rng.integers(0, p, size=(rows, n), dtype=np.uint64),
                 rng.integers(0, 64, size=(rows, n), dtype=np.uint64))
    x[:, 0], x[:, n // 2] = 2**32 - 1, 0
    return x.astype(np.uint32)
