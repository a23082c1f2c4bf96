// Fused pull-stream + collide step for the D2Q9 and D3Q19 BGK lattices,
// hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels
//   sailfish_tpu/ops/pallas_step.py   make_kernel_3d  (3D, modes has_mask + kbc)
//   sailfish_tpu/ops/pallas_step2d.py make_kernel_2d  (2D, modes has_mask + kbc)
// in the BGK / fp32 / single-device configuration that the lid-driven
// cavity scenes run, and with them
//   sailfish_tpu/ops/pallas_step.py   make_bc_patch_kernel_3d
//   sailfish_tpu/ops/pallas_step2d.py make_bc_patch_kernel_2d
// which recompute the z-planes / y-blocks that hold a native BC whose
// prescribed rho or u varies from node to node (a velocity inlet carrying a
// Poiseuille profile) from per-node parameter planes. The TPU needs those
// second kernels because a BC's parameters must be scalars in its main
// kernel; here a BC node loads its own.
//
// What it computes, for every node x of the (nz, ny, nx) domain:
//   fs_i = A[i, x - c_i]                    pull streaming, periodic wrap
//   mask 0     collide: fs + (feq(rho, u) - fs) / tau
//   mask 1     full bounce-back wall: store fs reflected, out_opp(i) = fs_i
//   mask 2     keep (excluded / propagation-only): store fs
//   mask 3+j   native BC instance j of the BC table: macroscopic solve,
//              equilibrium / Zou-He / regularized reconstruction, then BGK
//              with the prescribed rho or u (the chain of
//              pallas_step.py:_bc_row_values). The prescribed values are the
//              row's scalars, or (rows with vary[j].varies = 1) the node's own
//              entry of the parameter array bcp: per instance [rho, u_x,
//              u_y(, u_z)], component-major over the instance's bounding
//              box, x fastest, so the lanes of a warp along x coalesce
// and writes the result to B. The host swaps A and B every step: the
// Pallas kernels write in place, which is safe only because the TPU grid
// runs in order; concurrent GPU blocks pulling in place would race.
//
// State layout, parameter block and the per-node pieces (pull, collide,
// reflect, keep, the native-BC chain) are in lbm_common.cuh.
//
// Bound: device-memory bandwidth. Each node reads Q floats, writes Q floats
// and reads a 1-byte mask per step: 2*19*4 + 1 = 153 B for D3Q19, 73 B for
// D2Q9, against ~1.1 flop per byte; a node of a varying BC reads 4 * (1 +
// DIM) B more. One thread per node, x fastest, so the c_x = 0 loads and
// every store coalesce. This simple design does nothing yet about the
// x-shifted (+-1 element) loads, which straddle 32-byte sectors, or about
// the in-place (AA-pattern) alternative that would halve the footprint;
// both are later performance work.
//
// The per-node branches keep the bulk path's distributions in registers:
// the reflection is a permuted store (no register-array indexing), and the
// BC chain, which needs fs[opp(i)], runs in a non-inlined function on a
// local copy that only BC nodes take. The parameter read sits in that
// branch too, so only the nodes of a varying BC pay for it: a scene whose
// BCs are all uniform runs the same kernel at the same speed (measured
// against a build without the read: within 0.5 % at 256^3 and 4096^2), so
// there is one instantiation per lattice.

#include "lbm_common.cuh"

template <int DIM, int Q>
__global__ void __launch_bounds__(LBM_BLOCK)
lbm_step_kernel(const float* __restrict__ a, float* __restrict__ b,
                const uint8_t* __restrict__ mask,
                const __grid_constant__ LBMParams p,
                const float* __restrict__ bcp) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y;
    const int z = blockIdx.z;
    if (x >= p.nx) return;
    const long long nxy = (long long)p.nx * p.ny;
    const long long n = nxy * p.nz;
    const long long node = z * nxy + (long long)y * p.nx + x;

    float fs[Q];
    pull_node<DIM, Q>(p, a, x, y, z, fs);
    const int m = mask[node];
    if (!plain_node<DIM, Q>(p, m, fs, b, node, n)) {
        float t[Q];
#pragma unroll
        for (int i = 0; i < Q; ++i) t[i] = fs[i];
        if (p.vary[m - 3].varies) {
            // this node's own rho and u, from its instance's box
            const LBMVary& v = p.vary[m - 3];
            const long long vol = (long long)v.ext[0] * v.ext[1] * v.ext[2];
            const float* q = bcp + v.offset
                + ((long long)(z - v.lo[2]) * v.ext[1] + (y - v.lo[1]))
                      * v.ext[0]
                + (x - v.lo[0]);
            LBMBC bc = p.bc[m - 3];
            bc.rho = q[0];
#pragma unroll
            for (int d = 0; d < 3; ++d)
                bc.u[d] = d < DIM ? q[(1 + d) * vol] : 0.0f;
            bc_node<DIM, Q>(p, bc, t, b, node, n);
        } else {
            bc_node<DIM, Q>(p, p.bc[m - 3], t, b, node, n);
        }
    }
}

__global__ void lbm_empty_kernel() {}

template <int DIM, int Q>
static int launch(const float* a, float* b, const uint8_t* mask,
                  const float* bcp, const LBMParams* p, void* stream) {
    const dim3 grid((p->nx + LBM_BLOCK - 1) / LBM_BLOCK, p->ny, p->nz);
    lbm_step_kernel<DIM, Q><<<grid, LBM_BLOCK, 0, (cudaStream_t)stream>>>(
        a, b, mask, *p, bcp);
    return (int)cudaGetLastError();
}

extern "C" {

// bcp: the per-node parameter array (never read when no row varies).
int lbm_step_d2q9(const float* a, float* b, const uint8_t* mask,
                  const float* bcp, const LBMParams* p, void* stream) {
    return launch<2, 9>(a, b, mask, bcp, p, stream);
}

int lbm_step_d3q19(const float* a, float* b, const uint8_t* mask,
                   const float* bcp, const LBMParams* p, void* stream) {
    return launch<3, 19>(a, b, mask, bcp, p, stream);
}

int lbm_params_size(void) { return (int)sizeof(LBMParams); }

// One empty block: the per-launch floor a measurement reads bounds against.
int lbm_empty_launch(void* stream) {
    lbm_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

}  // extern "C"
