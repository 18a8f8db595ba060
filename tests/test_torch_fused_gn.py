"""The port's fused AL-SQP solve (plain version, CPU): the wrapper's
guards, the packing and the binding, and the inputs and bands of its
comparisons with the JAX package.  Those against the JAX package's Pallas
kernel run in interpret mode are ``tests/test_torch_fused_gn_interpret.py``.

The CUDA kernel itself is checked against the plain version on the GPU by
``chip_smoke.py``; no test here launches it.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.models import costs as JCO
from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.utils.synthetic import ZAM_LIKE_WEIGHTS, overtake_track


def ocp_numpy(H, B, seed=0, moving=False):
    """OCP arrays of an overtake workload with jittered starts (numpy)."""
    rng = np.random.default_rng(seed)
    path, psi, obstacle = overtake_track(H + 40)
    x0 = np.array([path[0, 0], path[0, 1], 0.0, 15.0, psi[0]], np.float32)
    x0 = x0 + rng.normal(size=(B, 5)) * [0.5, 0.15, 0.0, 0.5, 0.01]
    x_ref = np.stack([path[1:H + 2, 0], path[1:H + 2, 1], np.zeros(H + 1),
                      np.full(H + 1, 15.0), psi[1:H + 2]], -1)
    obs = np.array([obstacle + [0.0, 0.0], obstacle + [1.5, 0.0],
                    obstacle - [1.5, 0.0]])
    # move the obstacle next to the start of the path: the circle rows
    # bind inside a short horizon
    obs = np.broadcast_to(obs - [22.0, 2.0], (B, 3, 2))
    if moving:
        drift = np.arange(H + 1)[:, None, None] * [0.3, 0.05]
        obs = obs[:, None] + drift
    w = {k: np.broadcast_to(np.asarray(v, np.float32), (B, len(v)))
         for k, v in zip(("q", "r", "qN"), (
             [ZAM_LIKE_WEIGHTS[k] for k in JCO.WEIGHT_KEYS[0:5]],
             [ZAM_LIKE_WEIGHTS[k] for k in JCO.WEIGHT_KEYS[5:7]],
             [ZAM_LIKE_WEIGHTS[k] for k in JCO.WEIGHT_KEYS[7:12]]))}
    f32 = np.float32
    return dict(x0=x0.astype(f32),
                x_ref=np.broadcast_to(x_ref, (B, H + 1, 5)).astype(f32),
                obs_centers=np.ascontiguousarray(obs, f32),
                min_dist=np.full((B,), 3.3, f32), weights=w)


def jax_ocp(d):
    return JS.OcpParams(
        x0=jnp.asarray(d["x0"]), x_ref=jnp.asarray(d["x_ref"]),
        obs_centers=jnp.asarray(d["obs_centers"]),
        min_dist=jnp.asarray(d["min_dist"]),
        weights=JCO.Weights(**{k: jnp.asarray(v)
                               for k, v in d["weights"].items()}))


def jax_state(cfg, B):
    return jax.vmap(lambda _: JS.init_state(cfg))(jnp.arange(B))


def assert_solutions_close(got, ref, state=True):
    """The equivalence bands of tests/test_fused_gn.py (U 2e-3, X atol
    2e-2, viol 1e-3, cost rtol 1e-3 atol 1e-2; float32 through different
    operation orders and iterative solves)."""
    def a(x):
        return np.asarray(x, np.float64)

    def t(x):
        return x.double().numpy()

    err = {f: float(np.max(np.abs(a(getattr(ref, f)) - t(getattr(got, f)))))
           for f in ("X", "U", "viol", "cost")}
    print("max abs err vs JAX:", err)
    np.testing.assert_allclose(t(got.U), a(ref.U), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(t(got.X), a(ref.X), rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(t(got.viol), a(ref.viol), atol=1e-3)
    np.testing.assert_allclose(t(got.cost), a(ref.cost), rtol=1e-3,
                               atol=1e-2)
    if state:
        np.testing.assert_allclose(t(got.state.mu), a(ref.state.mu),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(t(got.state.lam_lo), a(ref.state.lam_lo),
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(t(got.state.lam_hi), a(ref.state.lam_hi),
                                   rtol=2e-2, atol=2e-2)


def _tcfg(**kw):
    return TS.SolverConfig(**{"horizon": 4, **kw})


def _tocp(H=4, B=2, **kw):
    return convert.ocp_params(ocp_numpy(H, B, **kw))


def assert_same_solution(got, ref):
    """Two Solutions equal field by field, the warm state's too."""
    for f in TS.Solution._fields:
        a, b = getattr(got, f), getattr(ref, f)
        for x, y in (zip(a, b) if f == "state" else [(a, b)]):
            assert torch.equal(x, y), f


@pytest.mark.parametrize("kw,error,match", [
    # the IP method: the wrapper goes to sqp_vec, which hands it to the
    # per-lane path sqp.solve_batch, as the JAX package falls back
    (dict(method="ip"), None, "IP"),
    # no boundary data: the wrapper goes to sqp_vec, whose rows raise, as
    # the JAX package's fallback does
    (dict(boundary_rows=True), ValueError, "boundaries"),
    # 17 rungs: the wrapper goes to sqp_vec and returns its solution
    (dict(alphas=tuple(0.5 ** i for i in range(17))), None, "rungs"),
])
def test_out_of_envelope_raises(kw, error, match):
    """Outside the kernel's envelope a KS AL problem goes to
    ``sqp_vec.solve_batch_vec`` as in the JAX package (which raises where
    boundary rows have no data), the IP method on to ``sqp.solve_batch``."""
    from mpc_tpu_torch.ops import sqp_vec as TSV
    cfg = _tcfg(**kw)
    p = _tocp()
    assert not TF.eligible(cfg, p)
    assert match in TF.ineligible_reason(cfg, p)
    st = TS.init_state(cfg, batch=2)
    if error is None:
        got = TF.solve_batch_fused(cfg, p, st, device="cpu")
        if cfg.method == "ip":
            assert_same_solution(got, TS.solve_batch(cfg, p, st,
                                                     device="cpu"))
            return
        ref = TSV.solve_batch_vec(cfg, p, st, device="cpu")
        assert torch.equal(got.U, ref.U) and torch.equal(got.status,
                                                         ref.status)
        return
    with pytest.raises(error, match=match):
        TF.solve_batch_fused(cfg, p, st, device="cpu")


def test_st_model_raises():
    """The ST model (ported since this test's name was given) runs on the
    CPU: the wrapper widens the KS-schema OCP and returns the plain
    version's 7-state solution."""
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    cfg = _tcfg(model="st", vehicle=VEHICLE_2)
    p, st = _tocp(), TS.init_state(cfg, batch=2)
    assert TF.eligible(cfg, p)
    got = TF.solve_batch_fused(cfg, p, st, device="cpu")
    ref = TF.to_solution(cfg, TF.solve_batch_fused_plain(cfg, p, st))
    assert got.X.shape == (2, 5, 7) and bool(torch.isfinite(got.X).all())
    assert torch.equal(got.U, ref.U) and torch.equal(got.status, ref.status)


def test_moving_obstacles_are_eligible():
    assert TF.eligible(_tcfg(), _tocp(moving=True))
    assert TF.eligible(_tcfg(formulation="casadi", integrator="euler"),
                       _tocp())


def test_cuda_requested_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only contract does not apply")
    cfg = _tcfg()
    st = TS.init_state(cfg, batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.solve_batch_fused(cfg, _tocp(), st)             # default: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.solve_batch_fused(cfg, _tocp(), st, device="cuda")


def test_horizon_bound_on_either_side():
    """A block holds 32 lanes; its shared memory grows by two floats a
    stage and lane (a merit and an AL term), so the longest horizon is the
    one whose block fits 232,448 bytes at the widest geometry: that H is in
    the envelope and H + 1 is refused with a reason naming the bound.  A
    thread loops over its stages, so the stages a thread bound nothing."""
    H = TF.MAX_HORIZON
    assert TF.ineligible_reason(_tcfg(horizon=H), _tocp(H=H)) is None
    assert max(TF.LANES_PER_BLOCK * TF.lane_smem_bytes(H, t)
               for t in TF.THREADS_PER_LANE) <= TF.SMEM_PER_BLOCK
    reason = TF.ineligible_reason(_tcfg(horizon=H + 1), _tocp(H=H + 1))
    assert reason is not None and f"H <= {H}" in reason
    assert "shared memory" in reason and str(TF.SMEM_PER_BLOCK) in reason
    with pytest.raises(NotImplementedError, match=f"H <= {H}"):
        TF.pack(_tcfg(horizon=H + 1), _tocp(H=H + 1),
                TS.init_state(_tcfg(horizon=H + 1), batch=2))
    # the bench horizon: ~53 KB a block at 4 threads a lane, four blocks
    # (16 warps) an SM
    assert TF.LANES_PER_BLOCK * TF.lane_smem_bytes(30, 4) < 232448 // 4


def test_launch_kernel_refuses_cpu_tensors():
    cfg = _tcfg()
    with pytest.raises(ValueError, match="CUDA"):
        TF.launch_kernel(cfg, _tocp(), TS.init_state(cfg, batch=2))


def test_kernel_argument_block_layout():
    """The ctypes mirror has the C struct's 4-byte fields, in order: 10
    integers, 24 floats, the ladder, then the boundary rows' flag and their
    bound r_ego, then the ST model's 16 constants."""
    assert ctypes.sizeof(TF.FgnArgs) == 4 * (10 + 24 + TF.MAX_ALPHAS + 2
                                             + len(TF.ST_CONSTS))
    b = TF.kernel_args(_tcfg(boundary_rows=True), B=7, moving=False)
    assert b.boundary == 1 and b.r_ego == pytest.approx(1.2)
    a = TF.kernel_args(_tcfg(alphas=(1.0, 0.5), formulation="casadi"),
                       B=7, moving=True)
    assert (a.B, a.H, a.n_alphas, a.forcespro, a.moving) == (7, 4, 2, 0, 1)
    assert list(a.alphas)[:3] == [1.0, 0.5, 0.0]
    assert a.a_cap == pytest.approx(11.5) and a.u_lo1 == pytest.approx(-11.5)
    # the ST model's constants close the block (zero for KS)
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    assert a.st.l == 0.0
    st = TF.kernel_args(_tcfg(model="st", vehicle=VEHICLE_2), B=7,
                        moving=False)
    assert st.st.l == pytest.approx(VEHICLE_2.wheelbase)


def test_ctypes_binding_matches_the_c_source():
    """FgnArgs' fields and the pointer arguments of fused_gn_solve, in the
    order the CUDA source declares them."""
    from mpc_tpu_torch.ops import _build
    src = (_build.CSRC / "fused_gn.cu").read_text()
    struct = re.search(r"struct FgnArgs \{(.*?)\};", src, re.S).group(1)
    c_fields = re.findall(r"(\w+)(?:\[\w+\])?\s*[,;]", struct)
    assert c_fields == [f for f, _ in TF.FgnArgs._fields_]
    sig = re.search(r'extern "C" int fused_gn_solve\((.*?)\)', src,
                    re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert params[0] == "args" and params[-1] == "stream"
    assert tuple(params[1:-1]) == TF.KERNEL_ORDER == (
        TF.KERNEL_INPUTS + TF.KERNEL_STATE + TF.KERNEL_OUTPUTS
        + TF.KERNEL_SCRATCH + TF.KERNEL_TRACE + TF.KERNEL_BOUNDARY)
    fn_name, argtypes = _build.SIGNATURES["fused_gn"]
    assert fn_name == "fused_gn_solve" and len(argtypes) == len(params)


@pytest.mark.parametrize("alphas", [(), (1.0, 0.5)])
def test_pack_lays_lanes_fastest(alphas):
    """The kernel's buffers: lanes on the last axis, inputs copied, trial
    chains only when the ladder is on; unpack gives the public layout."""
    cfg = _tcfg(alphas=alphas)
    p = _tocp(B=3, moving=True)
    st = TS.init_state(cfg, batch=3)
    st = st._replace(U=torch.arange(24.0).reshape(3, 4, 2))
    bufs = TF.pack(cfg, p, st)
    assert bufs["U"].shape == (4, 2, 3) and bufs["U"].is_contiguous()
    assert bufs["obs"].shape == (5, 6, 3)
    assert bufs["lam_lo"].shape == (5, TF.NR, 3)
    assert ("Xc" in bufs) == bool(alphas)
    assert "rung" not in bufs
    traced = TF.pack(cfg, p, st, trace_rungs=True)
    assert ("rung" in traced) == bool(alphas)
    if alphas:
        assert traced["rung"].shape == (cfg.al_iters * cfg.sqp_iters, 3)
    assert bufs["U"].data_ptr() != st.U.data_ptr()
    U = TF.unpack(bufs)[1]
    assert torch.equal(U, st.U)
    with pytest.raises(ValueError, match="CUDA"):
        TF.launch(cfg, bufs)


def test_pack_copies_the_state_of_an_earlier_solve():
    """A state unpacked from kernel buffers is lanes-fastest underneath;
    packing it again must still copy it, since the kernel writes its
    warm-state buffers in place."""
    cfg = _tcfg()
    p = _tocp(B=3)
    bufs = TF.pack(cfg, p, TS.init_state(cfg, batch=3))
    for n in ("X", "diag"):
        bufs[n].zero_()
    state = TF.to_solution(cfg, TF.unpack(bufs)).state
    again = TF.pack(cfg, p, state)
    ptrs = {t.data_ptr() for t in bufs.values()}
    assert not ptrs & {t.data_ptr() for t in again.values()}
    for n, f in (("U", "U"), ("lam_lo", "lam_lo"), ("lam_hi", "lam_hi"),
                 ("pviol", "prev_viol")):
        assert torch.equal(again[n], bufs[n])
        assert torch.equal(TF._aos(again[n]), getattr(state, f))


def test_plain_rung_trace_and_replay():
    """The plain version's rung trace names the first rung of least merit;
    replaying the traced rungs gives the same solve, and replaying alpha=0
    everywhere keeps the inputs where they started."""
    cfg = _tcfg(al_iters=2, sqp_iters=2, alphas=(1.0, 0.5, 0.25))
    p = _tocp(B=3)
    st = TS.init_state(cfg, batch=3)
    st = st._replace(U=torch.full_like(st.U, 0.1))
    rungs = []
    out = TF.solve_batch_fused_plain(cfg, p, st, rungs)
    assert len(rungs) == 4
    for r, merits in rungs:
        assert merits.shape == (4, 3)
        assert torch.equal(r.long(), merits.argmin(0))
    untraced = TF.solve_batch_fused_plain(cfg, p, st)
    follow = torch.stack([r for r, _ in rungs])
    replay = TF.solve_batch_fused_plain(cfg, p, st, follow=follow)
    for a, b, c in zip(out, untraced, replay):
        assert torch.equal(a, b) and torch.equal(a, c)
    held = TF.solve_batch_fused_plain(cfg, p, st,
                                      follow=torch.zeros_like(follow))
    assert torch.equal(held[1], st.U)


def test_lane_layout_round_trip():
    t = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    soa = TF._soa(t)
    assert soa.shape == (3, 4, 2) and soa.is_contiguous()
    assert torch.equal(TF._aos(soa), t)


def test_dispatch_on_cpu_is_the_plain_version():
    cfg = _tcfg(al_iters=1, sqp_iters=2)
    p = _tocp(B=3, moving=True)
    st = TS.init_state(cfg, batch=3)
    sol = TF.solve_batch_fused(cfg, p, st, device="cpu")
    X, U, *_ = TF.solve_batch_fused_plain(cfg, p, st)
    assert torch.equal(sol.X, X) and torch.equal(sol.U, U)
    # the caller's warm state is not written
    assert torch.equal(st.U, torch.zeros_like(st.U))
