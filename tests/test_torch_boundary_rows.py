"""Road-boundary rows in the port (CPU):

- ``linearize_boundaries`` in chunks, equal to one pass;
- the AL wrapper outside its envelope, which goes to ``sqp_vec`` as JAX's
  does.

The corridors and OCPs that the comparisons with the JAX package take
are ``tests/torch_corridors.py``; those comparisons (``linearize_boundaries``,
both plain versions with boundary rows and the corridor loops) are
``tests/test_torch_boundary_rows_jax.py``, the ST model's
``tests/test_torch_st_jax.py``.  The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` and on the host by ``tests/test_torch_kernel_host.py``.
"""
import torch

from mpc_tpu_torch import convert
from mpc_tpu_torch.ops import fused_gn as TF
from mpc_tpu_torch.ops import sqp as TS
from mpc_tpu_torch.ops import sqp_vec as TSV
from torch_corridors import curved_corridor, _states


# --------------------------------------------------------------------------
# (a) the boundary rows' models
# --------------------------------------------------------------------------


def test_linearize_boundaries_chunks_change_nothing(monkeypatch):
    """Lanes taken in chunks (the bound on the search's temporaries) give
    the same models as all lanes at once."""
    B, H = 5, 4
    cfg = TS.SolverConfig(horizon=H, boundary_rows=True)
    X = torch.from_numpy(_states(B, H + 1, 7))
    bnd, sgn = map(torch.from_numpy, curved_corridor(B, 2.5, -2.5, seed=3))
    whole = TF.linearize_boundaries(cfg, X, bnd, sgn)
    per_lane = TF._LINEARIZE_TEMPS * (H + 1) * 3 * (bnd.shape[2] - 1) * 2 * 4
    monkeypatch.setattr(TF, "LINEARIZE_BYTES", 2 * per_lane)
    calls = []
    real = TF._linearize_lanes
    monkeypatch.setattr(TF, "_linearize_lanes",
                        lambda *a: calls.append(a[1].shape[0]) or real(*a))
    assert torch.equal(TF.linearize_boundaries(cfg, X, bnd, sgn), whole)
    assert calls == [2, 2, 1]


# --------------------------------------------------------------------------
# (b) the corridor OCPs of the plain versions' comparisons
# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# (c) the AL wrapper outside its envelope (C1)
# --------------------------------------------------------------------------


def test_more_rungs_than_the_kernel_takes_go_to_sqp_vec():
    """17 ladder rungs: the wrapper's solution is sqp_vec's, exactly."""
    from tests.test_torch_fused_gn import ocp_numpy
    cfg = TS.SolverConfig(horizon=4,
                          alphas=tuple(0.5 ** i for i in range(17)))
    ocp = convert.ocp_params(ocp_numpy(4, 2))
    st = TS.init_state(cfg, batch=2)
    assert not TF.eligible(cfg, ocp)
    got = TF.solve_batch_fused(cfg, ocp, st, device="cpu")
    ref = TSV.solve_batch_vec(cfg, ocp, st, device="cpu")
    for f in ("X", "U", "status", "viol", "cost", "kkt_stat", "merit"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    for a, b in zip(got.state, ref.state):
        assert torch.equal(a, b)


def test_horizon_beyond_the_kernel_goes_to_sqp_vec(monkeypatch):
    """H > MAX_HORIZON dispatches to sqp_vec (a spy, no solve)."""
    from tests.test_torch_fused_gn import ocp_numpy
    H = TF.MAX_HORIZON + 1
    cfg = TS.SolverConfig(horizon=H)
    ocp = convert.ocp_params(ocp_numpy(H, 2))
    st = TS.init_state(cfg, batch=2)
    calls = []
    monkeypatch.setattr(TSV, "solve_batch_vec",
                        lambda *a, **kw: calls.append((a, kw)) or "spied")
    assert TF.solve_batch_fused(cfg, ocp, st, device="cpu") == "spied"
    (args, kw), = calls
    assert args[0] is cfg and kw["device"] == torch.device("cpu")
