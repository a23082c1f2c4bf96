// The single-fluid stream-and-collide kernel of lbm_step.cu on int16 state
// buffers (--precision=mixed, ops/mixed.py), the collision model BGK: its
// 32 instantiations (2 lattices x 4 force models x wall rows or not x 2
// equilibria) behind the entries lbm_step_mixed_d2q9 / _d3q19, a library
// of their own so that it compiles in parallel with the fp32 libraries.
// ops/build.py hashes lbm_step.cu into this source's build key.

#define LBM_MIXED 1
#include "lbm_step.cu"
