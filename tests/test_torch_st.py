"""The 7-state single-track model with tire dynamics (ST) in the port (CPU)
against the JAX package: the bench loop's lifted start, the kernels'
dual-number helpers and the slip-rate pin, and the rows-form rollout.
The model's ODE and step, the nx=7 sweep, the xla engine, both fused
solves' plain versions (against JAX's interpret-mode kernels, and with
road-boundary rows) and the soft and hard closed loops are
``tests/test_torch_st_jax.py``.

The CUDA kernels' ST instances (``ops/csrc/fused_gn_st.cu``,
``fused_ip_st.cu``, ``riccati.cu`` at nx=7) are held against these plain
versions by ``tests/test_torch_kernel_host.py`` (their sources compiled for
the host) and on the GPU by ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.models import dynamics as JD
from mpc_tpu.models.vehicle import VEHICLE_2 as JV2
from mpc_tpu.ops import fused_gn as JF
from mpc_tpu.ops import riccati_vec as JRV
from mpc_tpu_torch import convert
from mpc_tpu_torch.models import dynamics as TD
from mpc_tpu_torch.models.vehicle import VEHICLE_2 as TV2
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import riccati_vec as TRV
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.utils import synthetic as tsyn
from tests.test_torch_fused_gn import ocp_numpy
from torch_st_cases import ST, PIN_X, PIN_U, states, _close


def test_make_bench_loop_lifts_the_st_start():
    """make_bench_loop(model='st') lifts the start to the ST state before
    the jitter, as the JAX package does: lane 0 less its jitter is JAX's
    lift of the track's first state."""
    n, seed = 3, 0
    lcfg, lp = tsyn.make_bench_loop(4, 6, n, device="cpu", seed=seed, **ST)
    assert lp.x_init.shape == (n, 7)
    scale = np.zeros(7)
    scale[:5] = [0.5, 0.15, 0.0, 0.5, 0.01]
    pert = (np.random.default_rng(seed).standard_normal((n, 7))
            * scale).astype(np.float32)
    path, psi, _ = tsyn.overtake_track(4 + 6 + 2, 15.0, 0.1)
    x5 = jnp.asarray([path[0, 0], path[0, 1], 0.0, 15.0, psi[0]],
                     jnp.float32)
    ref = JD.ks_to_st_state(x5, lcfg.solver.wheelbase, JV2.b)
    _close(ref, lp.x_init[0] - torch.from_numpy(pert[0]), atol=2e-6)


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_dual_number_helpers_match_jax(integrator):
    """The plain version's _st_step_rows and _st_lin_step against the JAX
    kernel helpers on plain arrays, in tests/test_fused_st.py's bands
    (rtol 2e-4, atol 2e-5), the low-speed branch and the guard included."""
    x, u = states(1)
    c = TF.st_consts(TV2)
    jx, ju = [jnp.asarray(r) for r in x.T], [jnp.asarray(r) for r in u.T]
    tx, tu = ([torch.from_numpy(r.copy()) for r in x.T],
              [torch.from_numpy(r.copy()) for r in u.T])
    for ref, got in zip(JF._st_step_rows(jx, ju, 0.1, JV2, integrator),
                        TF._st_step_rows(tx, tu, 0.1, c, integrator)):
        _close(ref, got, rtol=2e-4, atol=2e-5)
    (jA, jB), (tA, tB) = (JF._st_lin_step(jx, ju, 0.1, JV2, integrator),
                          TF._st_lin_step(tx, tu, 0.1, c, integrator))
    for i in range(7):
        for j in range(7):
            _close(jA[i][j], tA[i][j], rtol=2e-4, atol=2e-5)
        for j in range(2):
            _close(jB[i][j], tB[i][j], rtol=2e-4, atol=2e-5)


def test_slip_rate_of_the_kernels_and_of_the_model():
    """The reference's two slip-rate formulas in the low-speed branch: the
    kernels' helpers (fused_gn.py:398-399, 1 + (tan delta lr / l)^2) give
    0.117471, the model and the xla rows (dynamics.py:93-94, 1 + (tan^2
    delta lr / l)^2) 0.120556; the port keeps both, in both places."""
    x, u = np.asarray(PIN_X, np.float32), np.asarray(PIN_U, np.float32)
    kernel = [JF._st_ode_d([JF._Dual(jnp.asarray(v), ()) for v in x],
                           [JF._Dual(jnp.asarray(v), ()) for v in u],
                           JV2)[6].v,
              TF._st_ode_d([TF._Dual(torch.tensor(v)) for v in x],
                           [TF._Dual(torch.tensor(v)) for v in u],
                           TF.st_consts(TV2))[6].v]
    model = [JD.st_ode(jnp.asarray(x), jnp.asarray(u), JV2)[6],
             TD.st_ode(torch.from_numpy(x), torch.from_numpy(u), TV2)[6]]
    rows = TRV._ode_rows("st", TV2.wheelbase, TV2)(
        [torch.tensor(v) for v in x], [torch.tensor(v) for v in u])[6]
    for v in kernel:
        assert abs(float(v) - 0.117471) < 1e-6
    for v in model + [rows]:
        assert abs(float(v) - 0.120556) < 1e-6


def test_feedback_rollout_rows_match_jax():
    """_ode_rows('st') through feedback_rollout_vec at three alphas."""
    rng = np.random.default_rng(2)
    B, H = 3, 6
    x0 = np.concatenate([rng.normal(size=(B, 2)), rng.normal(size=(B, 1))
                         * 0.1, 14.0 + rng.normal(size=(B, 1)),
                         rng.normal(size=(B, 3)) * 0.05], 1)
    x0[0, 3] = 0.05                    # a lane of the low-speed branch
    X = np.repeat(x0[:, None], H + 1, 1) + rng.normal(size=(B, H + 1, 7)) \
        * 0.05
    U = rng.normal(size=(B, H, 2)) * 0.2
    K = rng.normal(size=(B, H, 2, 7)) * 0.1
    d = rng.normal(size=(B, H, 2)) * 0.1
    arrs = [np.asarray(a, np.float32) for a in (x0, X, U, K, d)]
    alphas = (1.0, 0.5, 0.1)
    lo, hi = (-0.4, -11.5), (0.4, 11.5)
    Xa, Ua = JRV.feedback_rollout_vec(
        None, 0.1, JV2.wheelbase, *[jnp.asarray(a) for a in arrs], alphas,
        jnp.asarray(lo), jnp.asarray(hi), "rk4", "st", JV2)
    gX, gU = TRV.feedback_rollout_vec(
        0.1, TV2.wheelbase, *[torch.from_numpy(a) for a in arrs], alphas,
        lo, hi, "rk4", "st", TV2)
    assert gX.shape == (3, B, H + 1, 7)
    _close(Ua, gU, rtol=1e-4, atol=1e-4)
    _close(Xa, gX, rtol=1e-4, atol=1e-4)


def test_st_horizon_bound_names_it():
    """An ST horizon whose block does not fit a block's shared memory is
    outside the AL kernel's envelope, and the reason names the bound."""
    H = TF.MAX_HORIZON_ST + 1
    cfg = TS.SolverConfig(horizon=H, **dict(ST, vehicle=TV2))
    ocp = convert.ocp_params(ocp_numpy(H, 1))
    reason = TF.ineligible_reason(cfg, ocp)
    assert f"H <= {TF.MAX_HORIZON_ST}" in reason
    assert TF.eligible(dataclasses.replace(cfg, horizon=H - 1),
                       convert.ocp_params(ocp_numpy(H - 1, 1)))


def test_st_library_key_covers_the_source_it_includes(tmp_path):
    """fused_gn_st.cu is fused_gn.cu with the ST model: an edit of the
    included source builds both libraries anew, and of neither the IP
    ones."""
    import shutil
    from mpc_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build.lib_path(n, csrc) for n in _build.SIGNATURES}
    src = csrc / "fused_gn.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build.lib_path(n, csrc) for n in _build.SIGNATURES}
    assert {n for n in before if before[n] != after[n]} == {
        "fused_gn", "fused_gn_st"}


def test_st_constants_mirror_the_c_struct():
    """The ST model's constants: the keys of st_consts, the ctypes mirror
    and struct StConsts of csrc/st_model.cuh name the same fields in the
    same order; the argument blocks of both fused kernels end with it."""
    import re
    from mpc_tpu_torch.ops import _build
    src = (_build.CSRC / "st_model.cuh").read_text()
    body = re.search(r"struct StConsts \{(.*?)\};", src, re.S).group(1)
    c_fields = re.findall(r"(\w+)\s*[,;]", body.replace("float", ""))
    assert tuple(c_fields) == TF.ST_CONSTS == tuple(TF.st_consts(TV2))
    assert [f for f, _ in TF.StConsts._fields_] == list(TF.ST_CONSTS)
    for args in (TF.FgnArgs, TFI.IpArgs):
        assert args._fields_[-1] == ("st", TF.StConsts)
