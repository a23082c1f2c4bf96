// The single-fluid stream-and-collide kernel of lbm_step.cu with the rows
// of the outflow family (OUTFLOW = true: NTDoNothing, NTCopy, NTYuOutflow,
// NTNeumann, NTLaminarize and NTGuoDensity; outflow_face in
// lbm_common.cuh): BGK with the compressible or the incompressible
// equilibrium, every force model, wall rows on, fp32 (2 lattices x 4 force
// models x 2 equilibria = 16 instantiations) behind the entries
// lbm_step_outflow_d2q9 / _d3q19, and the laminarize pre-pass
// laminarize_mean_d2q9 / _d3q19; a library of its own, so that the other
// libraries build nothing new. ops/build.py hashes lbm_step.cu into this
// source's build key.

#define LBM_OUTFLOW 1
#include "lbm_step.cu"
