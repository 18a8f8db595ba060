// fused_ip_ks_ring.cu — the fused IP-RTI kernel's instance for the KS model
// with the road-boundary rows, in a library of its own.
//
// Replaces the boundary-row branch of mpc_tpu/ops/fused_ip.py::
// _make_ip_kernel (fused_ip.py:765, :783: 6 more rows a stage from the
// per-stage boundary models).  fused_ip_ring.cu, the IP solve on the ring
// of stage operands, 32 lanes and 4 warps a block, with the KS model; its
// design notes hold here.  Only the boundary rows' instance is built: its
// fused_ip_solve refuses boundary = 0 (B2 without rows is fused_ip.cu's).
// A translation unit of its own, so that nvcc builds it in parallel with
// the other libraries; fused_ip.py loads it as "fused_ip_ks_ring".
#include "fused_ip_ring.cu"
