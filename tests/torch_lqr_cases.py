"""The seeded LQR problems of ``tests/test_riccati.py`` as the port takes
them, shared by ``tests/test_torch_pscan.py`` and
``tests/test_torch_pscan_jax.py``."""
import numpy as np
import torch

from mpc_tpu_torch.ops import riccati as TR
from tests.test_riccati import _random_problem


TIGHT = 1e-9                          # float64, the same recursion


def _problems(H, B=3, seed=3):
    """B seeded problems of tests/test_riccati.py, stacked lanes first."""
    rng = np.random.default_rng(seed)
    probs = [_random_problem(rng, H) for _ in range(B)]
    return [np.stack([p[i] for p in probs]) for i in range(11)], probs


def _torch(arrs, dtype):
    Q, Rm, M, qx, qu, QH, qH, A, B, r, dx0 = (
        torch.as_tensor(a, dtype=dtype) for a in arrs)
    return TR.StageQuad(Q, Rm, M, qx, qu), QH, qH, TR.LinDyn(A, B, r), dx0
