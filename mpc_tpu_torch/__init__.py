"""mpc_tpu_torch — the NMPC planner on PyTorch and CUDA.

A port of ``mpc_tpu`` to PyTorch for NVIDIA Hopper GPUs.  Module names follow
the JAX package, so ``mpc_tpu_torch.ops.fused_gn`` is the counterpart of
``mpc_tpu.ops.fused_gn``.  The package imports torch, numpy and the standard
library only; the JAX package stays the reference it is tested against.

Entry points (``utils.synthetic.make_bench_loop``,
``planner.closed_loop.closed_loop_batch_vec``,
``ops.fused_gn.solve_batch_fused``, ``ops.fused_ip.solve_batch_fused_ip``,
``ops.sqp_vec.solve_batch_vec``, ``ops.riccati_vec.backward_pass_vec``)
run on ``cuda`` unless the caller passes ``device="cpu"``; see
:func:`mpc_tpu_torch.device.resolve_device`.
"""
__version__ = "0.1.0"
