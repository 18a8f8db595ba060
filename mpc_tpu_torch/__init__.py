"""mpc_tpu_torch — the NMPC planner on PyTorch and CUDA.

A port of ``mpc_tpu`` to PyTorch for NVIDIA Hopper GPUs.  Module names follow
the JAX package, so ``mpc_tpu_torch.ops.fused_gn`` is the counterpart of
``mpc_tpu.ops.fused_gn``.  The package imports torch, numpy and the standard
library only; the JAX package stays the reference it is tested against.

Entry points (``python -m mpc_tpu_torch.planner.cli``,
``planner.planner.MPCPlanner``, ``io.config.load_config``,
``planner.closed_loop.make_loop_params``, ``run_closed_loop``,
``closed_loop_batch``, ``closed_loop_batch_vec``,
``utils.synthetic.make_bench_loop``, ``ops.sqp.solve_batch``,
``ops.fused_gn.solve_batch_fused``, ``ops.fused_ip.solve_batch_fused_ip``,
``ops.sqp_vec.solve_batch_vec``, ``ops.riccati_vec.backward_pass_vec``)
run on ``cuda`` unless the caller passes ``device="cpu"``; see
:func:`mpc_tpu_torch.device.resolve_device`.
"""
__version__ = "0.1.0"
