// The single-fluid stream-and-collide kernel of lbm_step.cu with the
// collision model BGK at the local Smagorinsky (LES) rate: its 32
// instantiations (2 lattices x 4 force models x wall rows or not x 2
// equilibria), a library of their own so that the three models compile in
// parallel. ops/build.py hashes lbm_step.cu into this source's build key.

#define LBM_MODEL MODEL_LES
#include "lbm_step.cu"
