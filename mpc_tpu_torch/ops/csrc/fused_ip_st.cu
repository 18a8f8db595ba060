// fused_ip_st.cu — the fused IP-RTI kernel's instances for the 7-state ST
// model (tire dynamics), in a library of their own.
//
// Replaces the model='st' branch of mpc_tpu/ops/fused_ip.py::_make_ip_kernel
// (fused_ip.py:100-108: fused_gn.py's _st_step_rows and _st_lin_step, the
// dual-number helpers, in place of the KS ones).  fused_ip_ring.cu, the IP
// solve on the ring of stage operands, 32 lanes a block, with the model's
// policy type StModel (st_model.cuh); its design notes hold here.  A
// translation unit of its own, so that nvcc builds the KS and ST instances
// in parallel; the library exports the C entry points of fused_ip.cu
// (fused_ip_solve with the ring's Newton-state buffers after the others),
// fused_ip.py loads it as "fused_ip_st".
#define FUSED_MODEL_ST
#include "fused_ip_ring.cu"
