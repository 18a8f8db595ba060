"""The road corridors and corridor OCPs that the port's boundary-row tests
share (``tests/test_torch_boundary_rows*.py``, ``tests/test_torch_st_jax.py``):
edges as numpy polylines, states about them, and the OCP on both sides."""
import jax.numpy as jnp
import numpy as np

from mpc_tpu.ops import sqp as JS
from tests.test_torch_fused_ip import ip_ocp_numpy


NB = 128   # points of a boundary polyline (the JAX loop's resampling)


def straight_corridor(B, y_left, y_right, x_lo=-1e3, x_hi=1e3, n=NB):
    """Two straight edges, the left one directed -x and the right one +x,
    signs +1 (inside positive): the signed distance to a straight line is
    affine, so the kernels' per-stage models are exact."""
    xs = np.linspace(x_hi, x_lo, n)
    left = np.stack([xs, np.full(n, y_left)], 1)
    right = np.stack([xs[::-1], np.full(n, y_right)], 1)
    bnd = np.broadcast_to(np.stack([left, right]), (B, 2, n, 2))
    return (np.ascontiguousarray(bnd, np.float32),
            np.ones((B, 2), np.float32))


def curved_corridor(B, y_left, y_right, x_lo=-20.0, x_hi=40.0, n=61,
                    amp=0.4, seed=None):
    """Edges that bend (a sine of 8 m period), with seeded jitter of their
    points when ``seed`` is given; directions and signs as in
    :func:`straight_corridor`."""
    xs = np.linspace(x_hi, x_lo, n)
    bend = amp * np.sin(xs / 8.0)
    jit = (np.zeros((B, 2, n)) if seed is None
           else 0.1 * np.random.default_rng(seed).standard_normal((B, 2, n)))
    left = np.stack([np.broadcast_to(xs, (B, n)),
                     y_left + bend + jit[:, 0]], -1)
    right = np.stack([np.broadcast_to(xs[::-1], (B, n)),
                      (y_right + bend + jit[:, 1])[:, ::-1]], -1)
    return (np.ascontiguousarray(np.stack([left, right], 1), np.float32),
            np.ones((B, 2), np.float32))


def _states(B, S, seed, y=0.0):
    rng = np.random.default_rng(seed)
    X = np.zeros((B, S, 5), np.float32)
    X[..., 0] = np.linspace(0.0, 12.0, S) + rng.normal(size=(B, S))
    X[..., 1] = y + rng.normal(size=(B, S))
    X[..., 3] = 14.0
    X[..., 4] = 0.3 * rng.normal(size=(B, S))
    return X


def corridor_ocp(H, B, bnd, sgn, seed=0, y_ref=1.8, v=14.0, on_ref=False):
    """A straight reference at y_ref next to the left edge, the obstacle
    far away, x0 jittered (numpy) about y = 0, or about the reference when
    ``on_ref``."""
    d = ip_ocp_numpy(H, B, seed=seed, v=v)
    d["x_ref"] = d["x_ref"].copy()
    d["x_ref"][..., 1] = y_ref
    if on_ref:
        d["x0"][:, 1] += y_ref
    d["obs_centers"] = np.full((B, 3, 2), -1e4, np.float32)
    d["boundaries"], d["boundary_signs"] = bnd, sgn
    return d


def jax_ocp(d):
    from mpc_tpu.models import costs as JCO
    return JS.OcpParams(
        x0=jnp.asarray(d["x0"]), x_ref=jnp.asarray(d["x_ref"]),
        obs_centers=jnp.asarray(d["obs_centers"]),
        min_dist=jnp.asarray(d["min_dist"]),
        weights=JCO.Weights(**{k: jnp.asarray(v)
                               for k, v in d["weights"].items()}),
        boundaries=jnp.asarray(d["boundaries"]),
        boundary_signs=jnp.asarray(d["boundary_signs"]))
