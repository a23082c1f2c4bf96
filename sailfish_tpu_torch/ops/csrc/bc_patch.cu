// Patch-row step for native BCs with spatially varying parameters, for the
// D2Q9 and D3Q19 BGK lattices, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels
//   sailfish_tpu/ops/pallas_step.py   make_bc_patch_kernel_3d  (R z-planes)
//   sailfish_tpu/ops/pallas_step2d.py make_bc_patch_kernel_2d  (R y-blocks)
// which recompute the rows holding a native BC (equilibrium, Zou-He or
// regularized, velocity or density) whose prescribed rho or u varies from
// node to node -- a velocity inlet carrying a Poiseuille profile -- from
// per-node parameter planes, for the main kernel to overlay.
//
// What it computes, for every node of the R listed rows (z-planes in 3D,
// y-rows in 2D) of the (nz, ny, nx) domain:
//   fs_i = A[i, x - c_i]            pull streaming from the PRE-step state
//   mask 0/1/2    collide / full bounce-back / keep, as lbm_step.cu
//   mask 3+j      native BC j of the patch table, with the node's own
//                 prescribed rho and u read from the parameter planes
//                 bcp = (1 + DIM, R, plane): [rho, ux, uy(, uz)]
// and writes the result straight into those rows of B. The host launches it
// after lbm_step on the same stream, so it overwrites what lbm_step stored
// there (the patch-instance nodes carry the keep code in lbm_step's mask).
// It computes the values of the TPU kernel's patch planes, not its DMA and
// block structure: there is no overlay buffer and no y-block tiling.
//
// Bound: launch latency. One row of a 256^2 plane is 65,536 nodes of
// 2*19*4 B of state, a 1-byte mask and 4*4 B of parameters (169 B):
// 11 MB, about 3.3 us at 3.35 TB/s, next to a few us to launch. One thread
// per node, x fastest, so the parameter and mask reads and every store
// coalesce; the per-node math is lbm_step's (lbm_common.cuh).

#include "lbm_common.cuh"

template <int DIM, int Q>
__global__ void __launch_bounds__(LBM_BLOCK)
bc_patch_kernel(const float* __restrict__ a, float* __restrict__ b,
                const int* __restrict__ rows,
                const uint8_t* __restrict__ mask_rows,
                const float* __restrict__ bcp, int nrows,
                const __grid_constant__ LBMParams p) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= p.nx) return;
    // 3D: grid (x blocks, ny, R), row = z; 2D: grid (x blocks, R, 1), row = y
    const int r = DIM == 3 ? blockIdx.z : blockIdx.y;
    const int y = DIM == 3 ? blockIdx.y : rows[r];
    const int z = DIM == 3 ? rows[r] : 0;
    const long long nxy = (long long)p.nx * p.ny;
    const long long n = nxy * p.nz;
    const long long node = z * nxy + (long long)y * p.nx + x;
    const long long plane = DIM == 3 ? nxy : p.nx;
    const long long pr =
        (long long)r * plane + (DIM == 3 ? (long long)y * p.nx : 0) + x;

    float fs[Q];
    pull_node<DIM, Q>(p, a, x, y, z, fs);
    const int m = mask_rows[pr];
    if (!plain_node<DIM, Q>(p, m, fs, b, node, n)) {
        const long long stride = (long long)nrows * plane;
        LBMBC bc = p.bc[m - 3];
        bc.rho = bcp[pr];
#pragma unroll
        for (int d = 0; d < 3; ++d)
            bc.u[d] = d < DIM ? bcp[(1 + d) * stride + pr] : 0.0f;
        float t[Q];
#pragma unroll
        for (int i = 0; i < Q; ++i) t[i] = fs[i];
        bc_node<DIM, Q>(p, bc, t, b, node, n);
    }
}

template <int DIM, int Q>
static int launch(const float* a, float* b, const int* rows,
                  const uint8_t* mask_rows, const float* bcp, int nrows,
                  const LBMParams* p, void* stream) {
    if (nrows <= 0) return 0;
    const int bx = (p->nx + LBM_BLOCK - 1) / LBM_BLOCK;
    const dim3 grid = DIM == 3 ? dim3(bx, p->ny, nrows) : dim3(bx, nrows, 1);
    bc_patch_kernel<DIM, Q><<<grid, LBM_BLOCK, 0, (cudaStream_t)stream>>>(
        a, b, rows, mask_rows, bcp, nrows, *p);
    return (int)cudaGetLastError();
}

extern "C" {

int bc_patch_d2q9(const float* a, float* b, const int* rows,
                  const uint8_t* mask_rows, const float* bcp, int nrows,
                  const LBMParams* p, void* stream) {
    return launch<2, 9>(a, b, rows, mask_rows, bcp, nrows, p, stream);
}

int bc_patch_d3q19(const float* a, float* b, const int* rows,
                   const uint8_t* mask_rows, const float* bcp, int nrows,
                   const LBMParams* p, void* stream) {
    return launch<3, 19>(a, b, rows, mask_rows, bcp, nrows, p, stream);
}

int bc_patch_params_size(void) { return (int)sizeof(LBMParams); }

}  // extern "C"
