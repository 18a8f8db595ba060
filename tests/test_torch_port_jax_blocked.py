"""The port in a fresh interpreter that cannot import JAX or the JAX
package (the import check itself: ``tests/test_torch_models.py``)."""
import subprocess
import sys

from tests.test_torch_models import ROOT


def test_port_runs_with_jax_blocked():
    """A fresh interpreter in which ``jax`` and ``mpc_tpu`` cannot be
    imported (nor ``matplotlib`` and ``yaml``, which the GPU's machine
    lacks) still imports every port module, solves on the CPU, plans a
    scenario through the CLI, runs a 2-lane ``plan_multi`` and a serving
    step; drawing raises an ImportError that names matplotlib."""
    code = """
import sys
for name in ("jax", "mpc_tpu", "matplotlib", "yaml"):
    sys.modules[name] = None
import importlib, pkgutil
import mpc_tpu_torch
for m in pkgutil.walk_packages(mpc_tpu_torch.__path__, "mpc_tpu_torch."):
    importlib.import_module(m.name)
from mpc_tpu_torch.planner import closed_loop as cl
from mpc_tpu_torch.utils import synthetic
lcfg, p = synthetic.make_bench_loop(3, 4, 2, device="cpu", al_iters=1,
                                    sqp_iters=1, alphas=(),
                                    cold_start_solves=1)
res = cl.closed_loop_batch_vec(lcfg, p, device="cpu")
assert res.X.shape == (2, 3, 5) and bool((res.status >= 0).all())
lcfg, p = synthetic.make_bench_loop(3, 4, 2, device="cpu", method="ip",
                                    ip_sqp_iters=1, ip_iters=2,
                                    cold_start_solves=1)
res = cl.closed_loop_batch_vec(lcfg, p, device="cpu")
assert res.X.shape == (2, 3, 5) and bool((res.status >= 0).all())
from mpc_tpu_torch.planner import cli
assert cli.main(["--device", "cpu", "--deterministic", "--config",
                 "configs/config_LF_ZAM_Over-1_1.yaml",
                 "--scenario-dir", "scenarios"]) == 0
import dataclasses
from mpc_tpu_torch.io.config import load_config
from mpc_tpu_torch.parallel import multi
from mpc_tpu_torch.planner.online import BatchedOnlinePlanner
cfgs = [dataclasses.replace(load_config("configs/" + n, "scenarios"),
                            iter_length=3)
        for n in ("config_LF_ZAM_Over-1_1.yaml",
                  "config_LF_USA_Lanker-2_18_T-1.yaml")]
res, lens = multi.plan_multi(cfgs, device="cpu", noised=False)
assert res.X.shape == (2, 3, 5) and bool((res.status >= 0).all())
fleet = BatchedOnlinePlanner(cfgs[0], n_lanes=2, device="cpu")
u, info = fleet.step(fleet.params.x_init)
assert u.shape == (2, 2) and (info.status >= 0).all()
from mpc_tpu_torch.utils import viz
try:
    viz.pyplot()
    raise AssertionError("drew without matplotlib")
except ImportError as e:
    assert "matplotlib" in str(e)
assert not {"jax", "matplotlib", "yaml"} & {
    m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
