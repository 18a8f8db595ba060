"""The port's scenario fleets (``parallel.multi``) on the CPU: the batch
against the JAX package's ``make_multi_scenario_batch``, its refusals, and
``plan_multi`` on the casadi lane-following pair against the committed
goldens (tests/test_multi_scenario.py)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from mpc_tpu.io.config import load_config as jload
from mpc_tpu.parallel import multi as jmulti
from mpc_tpu_torch import convert
from mpc_tpu_torch.io.config import load_config
from mpc_tpu_torch.parallel import multi

from asset_paths import CFG, SCN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# boundary rows (dummy polylines on three lanes), a moving obstacle (an
# obs_track on every lane), lanes of 30, 100, 30 and 91 steps
FORCESPRO_FLEET = ("config_CA_ZAM_Over-1_1_forcespro.yaml",
                   "config_CA_SYN_Moving-1.yaml",
                   "config_CA_ZAM_Over-1_1_forcespro_ref.yaml",
                   "config_LF_ZAM_Tutorial-1_2_T-1.yaml")
LF_PAIR = ("config_LF_ZAM_Over-1_1.yaml", "config_LF_USA_Lanker-2_18_T-1.yaml")
LF_GOLDENS = ("zam_lf_casadi", "usa_lf_casadi")


def configs(names):
    return [load_config(os.path.join(CFG, n), SCN) for n in names]


def leaves(p):
    """(name, tensor or None) of every leaf of LoopParams."""
    out = []
    for k, v in p._asdict().items():
        if dataclasses.is_dataclass(v):
            out += [(f"{k}.{f.name}", getattr(v, f.name))
                    for f in dataclasses.fields(v)]
        elif hasattr(v, "_asdict"):
            out += [(f"{k}.{a}", b) for a, b in v._asdict().items()]
        else:
            out.append((k, v))
    return out


@pytest.mark.parametrize("names,lengths", [
    (FORCESPRO_FLEET, [30, 100, 30, 91]),
    (LF_PAIR, [30, 70]),
], ids=["forcespro-four", "lf-casadi-pair"])
def test_batch_equals_jax(names, lengths):
    """Leaf by leaf, dtypes included, and the loop config field by field."""
    jl, jp, jlen = jmulti.make_multi_scenario_batch(
        [jload(os.path.join(CFG, n), SCN) for n in names], noised=False)
    tl, tp, tlen = multi.make_multi_scenario_batch(configs(names),
                                                   noised=False, device="cpu")
    assert tlen == jlen == lengths
    assert tl == convert.loop_config(jl)
    got, ref = leaves(tp), leaves(convert.loop_params(jp))
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, a), (_, b) in zip(got, ref):
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), k


def test_forcespro_fleet_layout():
    """Any boundary lane turns on the rows for the batch (the other lanes
    get the dummy polylines 1e6 m out), any moving lane puts the static
    ones on a constant track of n_steps + H + 2 rows."""
    lcfg, p, _ = multi.make_multi_scenario_batch(configs(FORCESPRO_FLEET),
                                                 noised=False, device="cpu")
    assert lcfg.solver.boundary_rows and lcfg.solver.method == "ip"
    far = p.boundaries[..., 1].abs().amin(dim=(1, 2))
    assert far[0] < 1e3 and bool((far[1:] > 1e5).all())
    need = lcfg.n_steps + lcfg.solver.horizon + 2
    assert p.obs_track.shape == (4, need, 3, 2)
    for lane in (0, 2, 3):
        assert torch.equal(p.obs_track[lane],
                           p.obs_centers[lane].expand(need, 3, 2))
    assert float(np.ptp(p.obs_track[1, :, 0, 0].numpy())) > 10.0


@pytest.mark.parametrize("names,kw,match", [
    ((FORCESPRO_FLEET[0], "config_CA_ZAM_Tutorial_Urban-3_2.yaml"), {},
     "mixed delta_t/wheelbase"),
    ((LF_PAIR[0], LF_PAIR[0]), {"framework": "forcespro"},
     "mixed frameworks"),
    ((LF_PAIR[0], LF_PAIR[0]), {"dynamics_model": "st"},
     "mixed dynamics_model"),
    (("config_LF_ZAM_Over-1_1.yaml", "config_CA_ZAM_Over-1_1.yaml"),
     "noised", "mixes use cases"),
    ((), {}, "at least one"),
])
def test_refusals(names, kw, match):
    """The JAX package's refusals, with its messages; a second config is
    changed by ``kw``, or both are noised."""
    cfgs = configs(names)
    if kw == "noised":
        kw = {}
        cfgs = [dataclasses.replace(c, noised=True) for c in cfgs]
    if kw:
        cfgs[1] = dataclasses.replace(cfgs[1], **kw)
    with pytest.raises(ValueError, match=match):
        multi.make_multi_scenario_batch(cfgs, device="cpu")


def test_plan_multi_lf_pair_tracks_its_goldens():
    """Each lane within 0.05 m of its own single run's golden over its own
    length (tests/test_multi_scenario.py:36), every step feasible; past its
    end the ZAM lane brakes toward the frozen target (:44-58).  On the
    lanes-leading engine (``engine='xla'``), as the JAX test runs on the
    CPU: the fused kernel's plain version takes ~1.8x as long here, and
    chip_smoke's fleet phase holds the kernel to the same goldens."""
    cfgs = configs(LF_PAIR)
    res, lens = multi.plan_multi(cfgs, device="cpu", noised=False,
                                 engine="xla")
    assert lens == [30, 70] and res.X.shape == (2, 70, 5)
    for i, tag in enumerate(LF_GOLDENS):
        gold = np.loadtxt(os.path.join(ROOT, "tests", "goldens",
                                       f"{tag}_states.txt"))
        dev = np.abs(res.X[i, :lens[i], :2].numpy() - gold[:, :2]).max()
        assert dev < 0.05, (tag, dev)
        assert bool((res.status[i, :lens[i]] >= 0).all())
    v_tail = res.X[0, lens[0]:, 3].numpy()
    assert np.all(np.diff(v_tail) < 0.05)
    assert v_tail[-1] < 0.5 * cfgs[0].desired_velocity


def test_entry_points_need_a_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CPU-only contract does not apply")
    with pytest.raises(RuntimeError, match="CUDA"):
        multi.make_multi_scenario_batch(configs(LF_PAIR))
    with pytest.raises(RuntimeError, match="CUDA"):
        multi.plan_multi(configs(LF_PAIR))
