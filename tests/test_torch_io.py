"""The port's scenario reader, route planner, config layer and YAML reader
against the JAX package's, on every shipped scenario and config, with the
geometry helpers, the speed profile and the progress index."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mpc_tpu.io import config as jconfig
from mpc_tpu.io import route as jroute
from mpc_tpu.io import scenario as jscenario
from mpc_tpu.planner import reference as jref
from mpc_tpu.utils import geometry as jgeo
from mpc_tpu_torch.io import config as tconfig
from mpc_tpu_torch.io import route as troute
from mpc_tpu_torch.io import scenario as tscenario
from mpc_tpu_torch.io import yaml_subset
from mpc_tpu_torch.planner import reference as tref
from mpc_tpu_torch.utils import geometry as tgeo

from asset_paths import CFG, SCN

SCENARIOS = sorted(f for f in os.listdir(SCN) if f.endswith(".xml"))
CONFIGS = sorted(f for f in os.listdir(CFG) if f.endswith(".yaml"))


def assert_same(a, b, path="."):
    """Field by field: dataclasses by their fields, mappings and sequences
    element-wise, arrays exactly (same shape and values), scalars equal."""
    if dataclasses.is_dataclass(a):
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for name in fa:
            assert_same(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("name", SCENARIOS)
def test_load_scenario_and_route_equal_jax(name):
    path = os.path.join(SCN, name)
    js, ts = jscenario.load_scenario(path), tscenario.load_scenario(path)
    assert_same(ts, js)
    pp = ts.planning_problems[0]
    jpp = js.planning_problems[0]
    jr = jroute.plan_route(js, jpp.initial_position, jpp.goal.position_center,
                           jpp.goal.position_lanelets)
    tr = troute.plan_route(ts, pp.initial_position, pp.goal.position_center,
                           pp.goal.position_lanelets)
    assert_same(tr, jr)


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_equal_jax(name):
    """Every shipped config loads to the JAX package's PlanningConfig,
    field by field, arrays exactly (the vehicle by its fields)."""
    j = jconfig.load_config(os.path.join(CFG, name), SCN)
    t = tconfig.load_config(os.path.join(CFG, name), SCN)
    assert_same(t, j)


@pytest.mark.parametrize("name", CONFIGS)
def test_yaml_reader_equals_safe_load(name):
    path = os.path.join(CFG, name)
    with open(path) as f:
        want = yaml.safe_load(f)
    got = yaml_subset.load(path)
    assert got == want
    assert_same(got, want)


SUBSET_DOC = """\
# a comment line
int: 1
neg: -12
float: -2.5
point: 2.
lead: .5
expo: 1.0e-3
big: 1500
yes_word: True
no_word: false
upper: TRUE
nul: null
tilde: ~
empty:
single: 'it''s # not a comment'
double: "tab\\there"
plain: a plain string   # trailing comment
path: configs/x.yaml
flow: [1, 2.0, x, 'y', [3, 4], true, null]
flow_empty: []
block:
  - 1
  - two
  - [a, b]
  -
    nested: map
same_indent:
- q
- r
nested:
    deeper:
        x: 1
    y: -0.0
1: int key
"""


def test_yaml_reader_constructs_equal_safe_load():
    got = yaml_subset.parse(SUBSET_DOC)
    want = yaml.safe_load(SUBSET_DOC)
    assert got == want
    assert_same(got, want)
    assert yaml_subset.parse("") is None and yaml.safe_load("") is None


def test_yaml_reader_reads_an_exponent_as_a_float():
    """The one documented difference: YAML 1.2 reads 1e-3 as a float,
    PyYAML's 1.1 resolver as a string; a solver setting wants the float."""
    assert yaml_subset.parse("reg: 1e-3") == {"reg": 1e-3}
    assert yaml.safe_load("reg: 1e-3") == {"reg": "1e-3"}


@pytest.mark.parametrize("doc,line,what", [
    ("a: &x 1", 1, "indicator"),
    ("a: 1\nb: *x", 2, "indicator"),
    ("a: !!int 1", 1, "indicator"),
    ("a: |\n  text", 1, "indicator"),
    ("a: {b: 1}", 1, "indicator"),
    ("---\na: 1", 1, "document marker"),
    ("a: yes", 1, "YAML 1.1"),
    ("a: 012", 1, "YAML 1.1"),
    ("a: .inf", 1, "YAML 1.1"),
    ("a: 2001-12-14", 1, "YAML 1.1"),
    ("a: 1\na: 2", 2, "duplicate key"),
    ("a:\n\tb: 1", 2, "tab"),
    ("a: b\n  c", 2, "continuation"),
    ("a: [1, 2", 1, "unclosed"),
    ("- a: 1", 1, "nested"),
    ("a:b", 1, "key: value"),
])
def test_yaml_reader_rejects_outside_the_subset(doc, line, what):
    with pytest.raises(ValueError, match=f"^cfg.yaml:{line}: .*{what}"):
        yaml_subset.parse(doc, name="cfg.yaml")


def test_geometry_equals_jax():
    rng = np.random.default_rng(0)
    poly = np.cumsum(rng.normal(size=(40, 2)) + [1.0, 0.2], axis=0)
    pts = poly[::4] + rng.normal(size=(10, 2))
    for fn in ("compute_polyline_length", "compute_pathlength_from_polyline",
               "compute_orientation_from_polyline",
               "compute_curvature_from_polyline", "chaikins_corner_cutting"):
        np.testing.assert_array_equal(getattr(tgeo, fn)(poly),
                                      getattr(jgeo, fn)(poly))
    np.testing.assert_array_equal(tgeo.resample_polyline(poly, 0.7),
                                  jgeo.resample_polyline(poly, 0.7))
    for p in pts:
        assert tgeo.find_closest_point(poly, p) == \
            jgeo.find_closest_point(poly, p)
        np.testing.assert_array_equal(
            tgeo.lateral_detour(poly, p, 4.0), jgeo.lateral_detour(poly, p,
                                                                   4.0))
    # the traced pair, on tensors (one point a lane, float64 both sides)
    t_poly = torch.tensor(poly)
    idx = tgeo.closest_point_index_t(t_poly, torch.tensor(pts))
    s = tgeo.arclength_projection_t(t_poly, torch.tensor(pts))
    with jax.enable_x64(True):
        for i, p in enumerate(pts):
            assert int(idx[i]) == int(jgeo.closest_point_index_jnp(
                jnp.asarray(poly), jnp.asarray(p)))
            assert float(s[i]) == pytest.approx(float(
                jgeo.arclength_projection_jnp(jnp.asarray(poly),
                                              jnp.asarray(p))), abs=1e-9)


def test_speed_profile_and_progress_index_equal_jax():
    c = tconfig.load_config(os.path.join(CFG, "config_LF_USA_Peach-2_1_T-1"
                                         ".yaml"), SCN)
    args = (c.reference_path, 8.0, 4.0, 5.75, c.wheelbase, 0.4)
    np.testing.assert_array_equal(tref.speed_profile(*args),
                                  jref.speed_profile(*args))
    assert c.v_profile is not None and c.progress_window
    jt = jref.build_track(c.reference_path, c.orientation, c.v_profile, 19,
                          "forcespro")
    tt = tref.build_track(c.reference_path, c.orientation, c.v_profile, 19,
                          "forcespro")
    rng = np.random.default_rng(1)
    for i in rng.integers(0, len(c.reference_path), 8):
        x = np.array([*(c.reference_path[i] + rng.normal(size=2)), 0.0, 5.0,
                      0.0], np.float32)
        assert int(tref.progress_index(tt, torch.tensor(x))) == int(
            jref.progress_index(jt, jnp.asarray(x)))
    # lanes leading: the same indices a lane at a time
    xs = torch.tensor(c.reference_path[::20, :2])
    xs = torch.cat([xs, torch.zeros(len(xs), 3, dtype=xs.dtype)], 1)
    lanes = tt.map(lambda a: a.expand((len(xs),) + a.shape))
    got = tref.progress_index(lanes, xs.float())
    assert got.tolist() == [int(tref.progress_index(tt, x.float()))
                            for x in xs]
