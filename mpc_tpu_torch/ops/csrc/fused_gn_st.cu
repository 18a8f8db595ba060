// fused_gn_st.cu — the fused AL-SQP kernel's instances for the 7-state ST
// model (tire dynamics), in a library of their own.
//
// Replaces the model='st' branch of mpc_tpu/ops/fused_gn.py::_make_kernel
// (fused_gn.py:814-822: _st_step_rows and _st_lin_step, the dual-number
// helpers of :285-504, in place of the KS ones).  fused_gn.cu, with the
// model's policy type StModel (st_model.cuh) in place of KsModel; its
// design notes hold here.  A translation unit of its own, so that nvcc
// builds the KS and ST instances in parallel; the library exports the same
// C entry points, fused_gn.py loads it as "fused_gn_st".
#define FUSED_MODEL_ST
#include "fused_gn.cu"
