"""The port's float64 per-lane loop against the JAX package's committed
regression goldens (the rest of the scenario-to-trajectory path:
``tests/test_torch_planner.py``)."""
import os

import numpy as np
import pytest
import torch

from mpc_tpu_torch.io.config import load_config
from mpc_tpu_torch.planner import closed_loop as cl
from tests.test_torch_planner import ROOT

from asset_paths import CFG, SCN


@pytest.mark.parametrize("config_name,tag,framework", [
    ("config_LF_ZAM_Over-1_1.yaml", "zam_lf_casadi", None),
    ("config_CA_ZAM_Over-1_1.yaml", "zam_ca_casadi", None),
    ("config_LF_USA_Lanker-2_18_T-1.yaml", "usa_lf_casadi", None),
    ("config_LF_ZAM_Over-1_1.yaml", "zam_lf_forcespro", "forcespro"),
    ("config_CA_ZAM_Over-1_1_forcespro_ref.yaml", "zam_ca_forcespro", None),
    ("config_LF_USA_Lanker-2_18_T-1.yaml", "usa_lf_forcespro", "forcespro"),
])
def test_deterministic_regression_goldens(config_name, tag, framework):
    """The port's float64 per-lane loop reproduces the JAX package's
    committed goldens (tests/test_closed_loop.py:179-208) at atol 1e-4."""
    golden = np.loadtxt(os.path.join(ROOT, "tests", "goldens",
                                     f"{tag}_states.txt"))
    c = load_config(os.path.join(CFG, config_name), SCN)
    if framework is not None:
        c = type(c)(**{**c.__dict__, "framework": framework})
    lcfg = cl.make_loop_config(c, noised=False)
    params = cl.make_loop_params(c, lcfg, dtype=torch.float64, device="cpu")
    res = cl.run_closed_loop(lcfg, params, device="cpu")
    np.testing.assert_allclose(res.X.numpy(), golden, atol=1e-4)
