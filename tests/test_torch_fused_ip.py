"""The port's fused IP-RTI solve (plain version, CPU): the wrapper's
guards, the packing and the kernel build's cache key, and the inputs and
bands of its comparisons with the JAX package.  Those against the JAX
package's executable spec, the vmapped ``sqp.solve_batch`` with
``method='ip'`` (the solve ``tests/test_fused_ip.py`` holds the Pallas kernel
to), are ``tests/test_torch_fused_ip_spec.py``.

The CUDA kernel itself is checked against the plain version on the GPU by
``chip_smoke.py``; no test here launches it.
"""
import ctypes
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_tpu.ops import sqp as JS
from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import _build
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import fused_ip as TFI
from mpc_tpu_torch.ops import sqp as TS
from tests.test_sqp import W_LF


def ip_ocp_numpy(H, B, seed=0, moving=False, v=14.0):
    """The OCP of tests/test_fused_ip.py (straight reference at v, an
    obstacle 1.6 m beside the line at x = 12 m, clearance 1.2 m) with x0
    jittered by a numpy generator."""
    rng = np.random.default_rng(seed)
    x0 = (np.array([0.0, 0.0, 0.0, v, 0.0])
          + rng.normal(size=(B, 5)) * [0.5, 0.2, 0.0, 0.5, 0.02])
    ts = np.arange(H + 1)
    x_ref = np.stack([v * 0.1 * ts, np.zeros(H + 1), np.zeros(H + 1),
                      np.full(H + 1, v), np.zeros(H + 1)], -1)
    obs = np.broadcast_to(np.array([[12.0, -1.6]] * 3), (B, 3, 2))
    if moving:
        obs = obs[:, None] + ts[:, None, None] * [0.3, 0.05]
    f32 = np.float32
    w = {k: np.broadcast_to(np.asarray(getattr(W_LF, k), f32),
                            (B,) + np.shape(getattr(W_LF, k)))
         for k in ("q", "r", "qN")}
    return dict(x0=x0.astype(f32),
                x_ref=np.broadcast_to(x_ref, (B, H + 1, 5)).astype(f32),
                obs_centers=np.ascontiguousarray(obs, f32),
                min_dist=np.full((B,), 1.2, f32), weights=w)


def jax_ocp(d):
    from mpc_tpu.models import costs as JCO
    return JS.OcpParams(
        x0=jnp.asarray(d["x0"]), x_ref=jnp.asarray(d["x_ref"]),
        obs_centers=jnp.asarray(d["obs_centers"]),
        min_dist=jnp.asarray(d["min_dist"]),
        weights=JCO.Weights(**{k: jnp.asarray(v)
                               for k, v in d["weights"].items()}))


def jax_state(cfg, B):
    return jax.vmap(lambda _: JS.init_state(cfg))(jnp.arange(B))


def assert_ip_solutions_close(got, ref):
    """The bands of tests/test_fused_ip.py:41-57 (U 2e-3, X atol 2e-2, viol
    1e-3, cost rtol 1e-3, stationarity rtol 5e-2, carried duals 5e-2; float32
    through different operation orders and a barrier iteration), status
    equal, and the per-row violation carried in prev_viol."""
    def a(x):
        return np.asarray(x, np.float64)

    def t(x):
        return x.double().numpy()

    err = {f: float(np.max(np.abs(a(getattr(ref, f)) - t(getattr(got, f)))))
           for f in ("X", "U", "viol", "cost", "kkt_stat")}
    print("max abs err vs JAX:", err)
    np.testing.assert_allclose(t(got.U), a(ref.U), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(t(got.X), a(ref.X), rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(t(got.viol), a(ref.viol), atol=1e-3)
    np.testing.assert_allclose(t(got.cost), a(ref.cost), rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(t(got.kkt_stat), a(ref.kkt_stat), rtol=5e-2,
                               atol=5e-3)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    for f in ("lam_lo", "lam_hi"):
        np.testing.assert_allclose(t(getattr(got.state, f)),
                                   a(getattr(ref.state, f)), rtol=5e-2,
                                   atol=5e-2)
    np.testing.assert_allclose(t(got.state.prev_viol), a(ref.state.prev_viol),
                               atol=1e-3)


def _tcfg(**kw):
    return TS.SolverConfig(**{"horizon": 4, "method": "ip", "ip_sqp_iters": 1,
                              "ip_iters": 2, **kw})


def _tocp(H=4, B=2, **kw):
    return convert.ocp_params(ip_ocp_numpy(H, B, **kw))


@pytest.mark.parametrize("kw,error,match", [
    (dict(method="al"), None, "AL"),
    # no boundary data: the ValueError of the JAX package's fallback rows
    (dict(boundary_rows=True), ValueError, "boundaries"),
    (dict(ip_alphas=tuple(0.5 ** i for i in range(17))), None, "rungs"),
])
def test_out_of_envelope_raises(kw, error, match):
    """Outside the kernel's envelope (``match`` names the reason) the
    wrapper returns the per-lane path's solution, ``sqp.solve_batch``, as
    the JAX package falls back to its vmapped solve; boundary rows without
    boundary data raise that path's ``ValueError``."""
    cfg = _tcfg(**kw)
    p = _tocp()
    st = TS.init_state(cfg, batch=2)
    assert not TFI.eligible_ip(cfg, p)
    if error is not None:
        with pytest.raises(error, match=match):
            TFI.solve_batch_fused_ip(cfg, p, st, device="cpu")
        return
    assert match in TFI.ineligible_reason_ip(cfg, p)
    got = TFI.solve_batch_fused_ip(cfg, p, st, device="cpu")
    ref = TS.solve_batch(cfg, p, st, device="cpu")
    for f in ("X", "U", "status", "kkt_stat", "viol", "cost"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert bool(torch.isfinite(got.X).all())


def test_st_model_raises():
    """The ST model (ported since this test's name was given) runs on the
    CPU: the wrapper widens the KS-schema OCP and returns the plain
    version's 7-state solution."""
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    cfg = _tcfg(model="st", vehicle=VEHICLE_2)
    p, st = _tocp(), TS.init_state(cfg, batch=2)
    assert TFI.eligible_ip(cfg, p)
    got = TFI.solve_batch_fused_ip(cfg, p, st, device="cpu")
    ref = TFI.to_solution_ip(cfg, TFI.solve_batch_fused_ip_plain(cfg, p, st),
                             st.mu)
    assert got.X.shape == (2, 5, 7) and bool(torch.isfinite(got.X).all())
    assert torch.equal(got.U, ref.U) and torch.equal(got.status, ref.status)


def test_envelope_variants_are_eligible():
    assert TFI.eligible_ip(_tcfg(), _tocp(moving=True))
    assert TFI.eligible_ip(_tcfg(formulation="casadi", integrator="euler",
                                 ip_warm_duals=True, ip_alphas=()), _tocp())


def test_cuda_requested_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only contract does not apply")
    cfg = _tcfg()
    st = TS.init_state(cfg, batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TFI.solve_batch_fused_ip(cfg, _tocp(), st)            # default: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        TFI.solve_batch_fused_ip(cfg, _tocp(), st, device="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        TFI.launch_kernel_ip(cfg, _tocp(), st)


def test_barrier_count_and_argument_block():
    """n_act counts the bounded sides: 19 a stage (friction 2, circles 9,
    inputs 4, steering and speed 4), 15 at the terminal stage; the ctypes
    mirror has the C struct's 4-byte fields."""
    assert TFI.n_active(_tcfg(horizon=30)) == 30 * 19 + 15
    assert TFI.n_active(_tcfg(formulation="casadi")) == 4 * 19 + 15
    assert ctypes.sizeof(TFI.IpArgs) == 4 * (11 + 18 + TF.MAX_ALPHAS + 2
                                             + len(TF.ST_CONSTS))
    a = TFI.kernel_args_ip(_tcfg(ip_alphas=(1.0, 0.5), ip_warm_duals=True,
                                 formulation="casadi", integrator="euler"),
                           B=7, moving=True)
    assert (a.B, a.H, a.ip_sqp_iters, a.ip_iters, a.n_alphas) == (7, 4, 1, 2,
                                                                  2)
    assert (a.forcespro, a.rk4, a.moving, a.warm) == (0, 0, 1, 1)
    assert list(a.alphas)[:3] == [1.0, 0.5, 0.0]
    assert a.rho == pytest.approx(300.0) and a.a_cap == pytest.approx(11.5)


def test_ctypes_binding_matches_the_c_source():
    """IpArgs' fields and the pointer arguments of fused_ip_solve, in the
    order the CUDA source declares them."""
    src = (_build.CSRC / "fused_ip.cu").read_text()
    struct = re.search(r"struct IpArgs \{(.*?)\};", src, re.S).group(1)
    c_fields = re.findall(r"(\w+)(?:\[\w+\])?\s*[,;]", struct)
    assert c_fields == [f for f, _ in TFI.IpArgs._fields_]
    sig = re.search(r'extern "C" int fused_ip_solve\((.*?)\)', src,
                    re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert params[0] == "args" and params[-1] == "stream"
    assert tuple(params[1:-1]) == TFI.KERNEL_ORDER == (
        TFI.KERNEL_INPUTS + TFI.KERNEL_STATE + TFI.KERNEL_OUTPUTS
        + TFI.KERNEL_TRACE + TFI.KERNEL_BOUNDARY)
    fn_name, argtypes = _build.SIGNATURES["fused_ip"]
    assert fn_name == "fused_ip_solve" and len(argtypes) == len(params)


def test_ring_binding_matches_the_c_source():
    """The ST library's source, fused_ip_ring.cu: its IpArgs is the KS
    source's field for field, and fused_ip_solve takes the KS source's
    buffers, then the Newton state's, in the order of KERNEL_ORDER_RING."""
    def fields(name):
        src = (_build.CSRC / name).read_text()
        struct = re.search(r"struct IpArgs \{(.*?)\};", src, re.S).group(1)
        return re.findall(r"(\w+)(?:\[\w+\])?\s*[,;]", struct)
    assert fields("fused_ip_ring.cu") == fields("fused_ip.cu") == [
        f for f, _ in TFI.IpArgs._fields_]
    src = (_build.CSRC / "fused_ip_ring.cu").read_text()
    sig = re.search(r'extern "C" int fused_ip_solve\((.*?)\)', src,
                    re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    assert params[0] == "args" and params[-1] == "stream"
    assert tuple(params[1:-1]) == TFI.KERNEL_ORDER_RING
    assert '#include "fused_ip_ring.cu"' in (
        _build.CSRC / "fused_ip_st.cu").read_text()
    fn_name, argtypes = _build.SIGNATURES["fused_ip_st"]
    assert fn_name == "fused_ip_solve" and len(argtypes) == len(params)


def test_pack_ip_of_the_st_model_lays_lanes_fastest():
    """The ST model's buffers are the ring kernel's: lanes on the last
    axis, inputs and duals copied, the Newton state's scratch allocated,
    the trial chains a slot a rung with the ladder on; unpack gives the
    public layout."""
    from mpc_tpu_torch.models.vehicle import VEHICLE_2
    cfg = _tcfg(model="st", vehicle=VEHICLE_2, ip_alphas=(1.0, 0.5))
    p = _tocp(B=3, moving=True)
    st = TS.init_state(cfg, batch=3)
    st = st._replace(U=torch.arange(24.0).reshape(3, 4, 2))
    bufs = TFI.pack_ip(cfg, p, st)
    assert bufs["U"].shape == (4, 2, 3) and bufs["U"].is_contiguous()
    assert bufs["obs"].shape == (5, 6, 3) and bufs["x0"].shape == (7, 3)
    assert bufs["lam_lo"].shape == (5, TF.NR, 3)
    assert bufs["AB"].shape == (4, TFI.ab_floats(7), 3)
    assert bufs["Xc"].shape == (3, 5, 7, 3) and bufs["Uc"].shape == (3, 4, 2, 3)
    assert set(bufs) == set(TFI.KERNEL_ORDER_RING) - {"rung", "bnd"}
    assert TFI.ab_floats(7) == 47 and TFI.ab_floats(5) == 23
    for n in ("X", "pviol", "diag"):
        bufs[n].zero_()
    X, U, z_lo, z_hi, pviol, diag = TFI.unpack_ip(bufs)
    assert torch.equal(U, st.U) and torch.equal(z_lo, st.lam_lo)
    assert X.shape == (3, 5, 7) and diag.shape == (3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        TFI.launch_ip(cfg, bufs)


@pytest.mark.parametrize("ip_alphas", [(), (1.0, 0.5)])
def test_pack_ip_copies_and_lays_lanes_fastest(ip_alphas):
    """Lanes leading and contiguous (one lane's data consecutive, the
    layout the kernel's warp per lane loads), every input copied (also a
    state unpacked from earlier buffers), no scratch, the rung trace only
    with the ladder on and asked for; unpack gives the public layout."""
    cfg = _tcfg(ip_alphas=ip_alphas, ip_sqp_iters=3)
    p = _tocp(B=3, moving=True)
    st = TS.init_state(cfg, batch=3)
    st = st._replace(U=torch.arange(24.0).reshape(3, 4, 2),
                     lam_hi=torch.rand(3, 5, TF.NR))
    bufs = TFI.pack_ip(cfg, p, st)
    assert bufs["U"].shape == (3, 4, 2) and bufs["U"].is_contiguous()
    assert bufs["obs"].shape == (3, 5, 6)
    assert bufs["lam_hi"].shape == (3, 5, TF.NR)
    assert all(t.is_contiguous() for t in bufs.values())
    assert set(bufs) == set(TFI.KERNEL_INPUTS + TFI.KERNEL_STATE
                            + TFI.KERNEL_OUTPUTS)
    traced = TFI.pack_ip(cfg, p, st, trace_rungs=True)
    assert ("rung" in traced) == bool(ip_alphas)
    if ip_alphas:
        assert traced["rung"].shape == (3, 3)
    assert bufs["U"].data_ptr() != st.U.data_ptr()
    for n in ("X", "pviol", "diag"):
        bufs[n].zero_()
    X, U, z_lo, z_hi, pviol, diag = TFI.unpack_ip(bufs)
    assert torch.equal(U, st.U) and torch.equal(z_hi, st.lam_hi)
    assert X.shape == (3, 5, 5) and pviol.shape == (3, 5, TF.NR)
    state = TFI.to_solution_ip(cfg, (X, U, z_lo, z_hi, pviol, diag),
                               st.mu).state
    again = TFI.pack_ip(cfg, p, state)
    ptrs = {t.data_ptr() for t in bufs.values()}
    assert not ptrs & {t.data_ptr() for t in again.values()}
    with pytest.raises(ValueError, match="CUDA"):
        TFI.launch_ip(cfg, bufs)


def test_horizon_bound_on_either_side():
    """The kernel holds 2 stages a thread of its warp, 64 a lane: H=63 is
    in the envelope and H=64 is refused with a reason naming that bound.
    The shared-memory footprint of a lane at H=63 fits a block; a block
    that held less would refuse the horizon with a reason naming shared
    memory."""
    ok = TFI.ineligible_reason_ip(_tcfg(horizon=TFI.MAX_HORIZON),
                                  _tocp(B=2, H=TFI.MAX_HORIZON))
    assert ok is None and TFI.MAX_HORIZON == 63
    reason = TFI.ineligible_reason_ip(_tcfg(horizon=64), _tocp(B=2, H=64))
    assert reason is not None and "64 stages a lane" in reason
    assert "H <= 63" in reason
    with pytest.raises(NotImplementedError, match="H <= 63"):
        TFI.pack_ip(_tcfg(horizon=64), _tocp(B=2, H=64),
                    TS.init_state(_tcfg(horizon=64), batch=2))
    # ~19 KB a lane at the bench horizon: 12 lanes a block
    assert TFI.lane_smem_bytes(30) == 19228
    assert TFI.SMEM_PER_BLOCK // TFI.lane_smem_bytes(30) == 12
    small = TFI.lane_smem_bytes(8)
    try:
        TFI.SMEM_PER_BLOCK = small
        assert TFI.ineligible_reason_ip(_tcfg(horizon=8),
                                        _tocp(B=2, H=8)) is None
        reason = TFI.ineligible_reason_ip(_tcfg(horizon=9),
                                          _tocp(B=2, H=9))
        assert f"a block holds {small}" in reason and "shared memory" in reason
    finally:
        TFI.SMEM_PER_BLOCK = 232448


def test_plain_rung_trace_and_replay():
    """The rung trace names the first rung of least merit; replaying it
    gives the same solve, and replaying alpha = 0 keeps U (clipped) where
    it started."""
    cfg = _tcfg(ip_sqp_iters=2, ip_iters=3, ip_alphas=(1.0, 0.5, 0.25))
    p = _tocp(B=3)
    st = TS.init_state(cfg, batch=3)
    st = st._replace(U=torch.full_like(st.U, 0.1))
    rungs = []
    out = TFI.solve_batch_fused_ip_plain(cfg, p, st, rungs)
    assert len(rungs) == 2
    for r, merits in rungs:
        assert merits.shape == (4, 3)
        assert torch.equal(r.long(), merits.argmin(0))
    follow = torch.stack([r for r, _ in rungs])
    replay = TFI.solve_batch_fused_ip_plain(cfg, p, st, follow=follow)
    for a, b in zip(out, replay):
        assert torch.equal(a, b)
    held = TFI.solve_batch_fused_ip_plain(cfg, p, st,
                                          follow=torch.zeros_like(follow))
    assert torch.equal(held[1], st.U)


def test_dispatch_on_cpu_is_the_plain_version():
    cfg = _tcfg(ip_warm_duals=True)
    p = _tocp(B=3, moving=True)
    st = TS.init_state(cfg, batch=3)
    st = st._replace(lam_lo=torch.full_like(st.lam_lo, 0.5))
    sol = TFI.solve_batch_fused_ip(cfg, p, st, device="cpu")
    X, U, z_lo, z_hi, pviol, diag = TFI.solve_batch_fused_ip_plain(cfg, p,
                                                                   st)
    assert torch.equal(sol.X, X) and torch.equal(sol.state.lam_lo, z_lo)
    assert torch.equal(sol.state.prev_viol, pviol)
    assert sol.state.mu is st.mu                      # mu passes through
    assert torch.equal(sol.merit, sol.cost)
    # the caller's warm state is not written
    assert torch.equal(st.lam_lo, torch.full_like(st.lam_lo, 0.5))


def test_kernel_cache_key_covers_the_shared_headers(tmp_path):
    """Editing a header both kernels include builds both anew: lib_path
    hashes every csrc/*.cuh with the source and the flags."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = {n: _build.lib_path(n, csrc) for n in _build.SIGNATURES}
    assert before == {n: _build.lib_path(n) for n in _build.SIGNATURES}
    header = csrc / "ks_rows.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.lib_path(n, csrc) for n in _build.SIGNATURES}
    assert all(after[n] != before[n] for n in before)
    assert after["fused_gn"].parent == _build.BUILD_DIR
