// The single-fluid stream-and-collide kernel of lbm_step.cu with the
// entropic collision (ELBM): its 16 instantiations (2 lattices x 4 force
// models x wall rows or not; the compressible equilibrium only), a library
// of their own so that the collision models compile in parallel.
// ops/build.py hashes lbm_step.cu into this source's build key.

#define LBM_MODEL MODEL_ELBM
#include "lbm_step.cu"
