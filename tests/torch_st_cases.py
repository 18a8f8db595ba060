"""The ST model's cases that ``tests/test_torch_st.py`` and
``tests/test_torch_st_jax.py`` share: the model's keywords, the slip-rate
pin, seeded states and inputs, and the comparison at float32 bands."""
import numpy as np

from mpc_tpu.models.vehicle import VEHICLE_2 as JV2


ST = dict(model="st", vehicle=JV2)
# the slip-rate pin: a state of the low-speed branch (v = 0.05 < 0.1)
PIN_X = [0.0, 0.0, 0.3, 0.05, 0.1, 0.2, 0.01]
PIN_U = [0.2, 1.0]


def states(seed=0):
    """(B=6, 7) states and (6, 2) inputs: the tire branch at speed, the
    low-speed branch (v = 0.05, -0.05), the v_safe guard (|v| < 1e-3)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, 7)).astype(np.float32) * [1, 1, .2, 1, .3, .3,
                                                       .05]
    x[:, 3] = [14.0, 0.05, -0.05, 5e-4, -2e-4, 8.0]
    u = (rng.normal(size=(6, 2)) * [0.2, 1.5]).astype(np.float32)
    return x.astype(np.float32), u


def _close(ref, got, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(got.detach().double().numpy(),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol)
