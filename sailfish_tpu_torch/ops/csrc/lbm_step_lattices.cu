// The single-fluid stream-and-collide kernel of lbm_step.cu on the D3Q15
// and D3Q27 lattices: BGK with the compressible or the incompressible
// equilibrium, every force model, wall rows or not, fp32 (2 lattices x 4
// force models x wall rows or not x 2 equilibria = 32 instantiations)
// behind the entries lbm_step_d3q15 / _d3q27, a library of its own so that
// the D2Q9 and D3Q19 libraries build nothing new. ops/build.py hashes
// lbm_step.cu into this source's build key.

#define LBM_LATTICES 1
#include "lbm_step.cu"
