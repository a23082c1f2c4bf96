// The single-fluid stream-and-collide kernel of lbm_step.cu on int16 state
// buffers (--precision=mixed, ops/mixed.py), the entropic collision (ELBM):
// its 16 instantiations behind the entries lbm_step_mixed_d2q9 / _d3q19, a
// library of their own so that the eight libraries compile in parallel.
// ops/build.py hashes lbm_step.cu into this source's build key.

#define LBM_MIXED 1
#define LBM_MODEL MODEL_ELBM
#include "lbm_step.cu"
