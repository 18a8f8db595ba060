"""The port's batched Riccati sweep and feedback rollout (CPU) against the
JAX package: the lanes-trailing XLA sweep ``riccati_vec.backward_pass_vec``,
the Pallas kernel of the sweep run in interpret mode, and
``riccati_vec.feedback_rollout_vec``.

The CUDA kernel itself (``ops/csrc/riccati.cu``) is held against the plain
version here by ``tests/test_torch_kernel_host.py`` (its source compiled for
the host) and on the GPU by ``chip_smoke.py``.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.ops import riccati as JR
from mpc_tpu.ops import riccati_vec as JRV
from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import riccati_vec as TRV
from tests.test_riccati import _random_problem

ROOT = Path(__file__).resolve().parents[1]


def problems(seed, B, H):
    """B random well-conditioned LQR problems with a nonzero defect r
    (tests/test_riccati.py's generator): JAX and torch inputs."""
    rng = np.random.default_rng(seed)
    probs = [_random_problem(rng, H) for _ in range(B)]
    Q, Rm, M, qx, qu, QH, qH, A, Bm, r, _ = [
        np.stack([p[i] for p in probs]).astype(np.float32)
        for i in range(11)]
    jquad = JR.StageQuad(Q=jnp.asarray(Q), R=jnp.asarray(Rm),
                         M=jnp.asarray(M), qx=jnp.asarray(qx),
                         qu=jnp.asarray(qu))
    jdyn = JR.LinDyn(A=jnp.asarray(A), B=jnp.asarray(Bm), r=jnp.asarray(r))
    return ((jquad, jnp.asarray(QH), jnp.asarray(qH), jdyn),
            (convert.stage_quad(jquad), torch.from_numpy(QH),
             torch.from_numpy(qH), convert.lin_dyn(jdyn)))


def assert_gains_close(got, ref):
    """The bands of tests/test_sqp_vec.py:26-31 (K, d rtol/atol 2e-3; dV1
    rtol 1e-2), and dV2 in the dV1 band."""
    def a(x):
        return np.asarray(x, np.float64)
    np.testing.assert_allclose(got.K.double().numpy(), a(ref.K), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got.d.double().numpy(), a(ref.d), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got.dV1.double().numpy(), a(ref.dV1),
                               rtol=1e-2)
    np.testing.assert_allclose(got.dV2.double().numpy(), a(ref.dV2),
                               rtol=1e-2)


def test_plain_sweep_matches_jax_backward_pass_vec():
    jin, tin = problems(51, B=6, H=12)
    ref = JRV.backward_pass_vec(*jin, 1e-6)
    got = TRV.backward_pass_vec_plain(*tin, 1e-6)
    assert got.K.shape == (6, 12, 2, 5) and got.dV1.shape == (6,)
    assert_gains_close(got, ref)


def test_plain_sweep_matches_the_pallas_kernel_interpret():
    """The TPU kernel this slice ports (tools/ablation/pallas_riccati.py,
    not a package: loaded from its file) in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "pallas_riccati", ROOT / "tools" / "ablation" / "pallas_riccati.py")
    pr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pr)
    jin, tin = problems(7, B=8, H=12)
    ref = pr.backward_pass_pallas(*jin, 1e-6, interpret=True)
    got = TRV.backward_pass_vec_plain(*tin, 1e-6)
    assert_gains_close(got, ref)


def test_sweep_takes_the_plain_version_on_the_cpu():
    _, tin = problems(3, B=3, H=5)
    got = TRV.backward_pass_vec(*tin, 1e-6, device="cpu")
    ref = TRV.backward_pass_vec_plain(*tin, 1e-6)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_sweep_needs_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only contract does not apply")
    _, tin = problems(3, B=2, H=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRV.backward_pass_vec(*tin, 1e-6)


def test_singular_quu_gives_the_same_non_finite_gains_as_jax():
    """Lane 0 has R = 0 and B = 0, so with reg = 0 its Quu is singular and
    the sweep divides by zero: the unguarded solve scrubs such gains
    afterwards, so they must be non-finite on the same entries as in the
    reference; lane 1 stays finite."""
    jin, _ = problems(4, B=2, H=3)
    jq, jQH, jqH, jd = jin
    jq = jq._replace(R=jq.R.at[0].set(0.0))
    jd = jd._replace(B=jd.B.at[0].set(0.0))
    ref = JRV.backward_pass_vec(jq, jQH, jqH, jd, 0.0)
    got = TRV.backward_pass_vec_plain(
        convert.stage_quad(jq), convert.tensor(jQH), convert.tensor(jqH),
        convert.lin_dyn(jd), 0.0)
    for f in ("K", "d", "dV1", "dV2"):
        np.testing.assert_array_equal(
            np.isfinite(getattr(got, f).numpy()),
            np.isfinite(np.asarray(getattr(ref, f))))
    assert not np.isfinite(got.K[0].numpy()).any()
    assert np.isfinite(got.K[1].numpy()).all()


def test_feedback_rollout_matches_jax_at_three_alphas():
    rng = np.random.default_rng(52)
    B, H = 4, 10
    jcfg = JS.SolverConfig(horizon=H)
    x0 = (rng.standard_normal((B, 5)) * 0.1
          + np.array([0, 0, 0, 15, 0])).astype(np.float32)
    U = (0.1 * rng.standard_normal((B, H, 2))).astype(np.float32)
    X = np.array(jax.vmap(lambda p, u: JS._rollout(jcfg, p, u))(
        jnp.asarray(x0), jnp.asarray(U)))
    K = (0.1 * rng.standard_normal((B, H, 2, 5))).astype(np.float32)
    d = (0.5 * rng.standard_normal((B, H, 2))).astype(np.float32)
    alphas = (1.0, 0.35, 0.12)
    u_lo, u_hi, _, _ = jcfg.bounds.as_arrays(jnp.float32)
    Xa, Ua = JRV.feedback_rollout_vec(
        None, jcfg.dt, jcfg.wheelbase, *map(jnp.asarray, (x0, X, U, K, d)),
        alphas, u_lo, u_hi, "rk4")
    t = map(torch.from_numpy, (x0, X, U, K, d))
    tcfg = convert.solver_config(jcfg)
    tlo, thi, _, _ = tcfg.bounds.as_arrays()
    got_X, got_U = TRV.feedback_rollout_vec(
        tcfg.dt, tcfg.wheelbase, *t, alphas, tlo, thi, "rk4")
    assert got_X.shape == (3, B, H + 1, 5) and got_U.shape == (3, B, H, 2)
    # some inputs land on their box: the clamp is part of what is compared
    assert bool((got_U.abs() == 0.4).any())
    np.testing.assert_allclose(got_U.numpy(), np.asarray(Ua), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_X.numpy(), np.asarray(Xa), rtol=1e-4,
                               atol=1e-4)


def test_feedback_rollout_of_the_st_model_raises():
    """The ST rollout (ported since this test's name was given): at rest
    with zero inputs and gains every state stays put, and the ST rows need
    their vehicle."""
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    z = torch.zeros
    Xa, Ua = TRV.feedback_rollout_vec(
        0.1, 2.578, z(1, 7), z(1, 3, 7), z(1, 2, 2), z(1, 2, 2, 7),
        z(1, 2, 2), (1.0,), (-1.0, -1.0), (1.0, 1.0), "rk4", "st", VEHICLE_2)
    assert Xa.shape == (1, 1, 3, 7) and Ua.shape == (1, 1, 2, 2)
    assert torch.equal(Xa, torch.zeros_like(Xa))
    with pytest.raises(ValueError, match="vehicle"):
        TRV.feedback_rollout_vec(0.1, 2.578, z(1, 7), z(1, 3, 7), z(1, 2, 2),
                                 z(1, 2, 2, 7), z(1, 2, 2), (1.0,),
                                 (-1.0, -1.0), (1.0, 1.0), "rk4", "st")
