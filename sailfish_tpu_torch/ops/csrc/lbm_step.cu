// Fused pull-stream + collide step for the D2Q9 and D3Q19 BGK lattices,
// hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels
//   sailfish_tpu/ops/pallas_step.py   make_kernel_3d  (3D, modes has_mask + kbc)
//   sailfish_tpu/ops/pallas_step2d.py make_kernel_2d  (2D, modes has_mask + kbc)
// in the BGK / fp32 / single-device configuration that the lid-driven
// cavity scenes run.
//
// What it computes, for every node x of the (nz, ny, nx) domain:
//   fs_i = A[i, x - c_i]                    pull streaming, periodic wrap
//   mask 0     collide: fs + (feq(rho, u) - fs) / tau
//   mask 1     full bounce-back wall: store fs reflected, out_opp(i) = fs_i
//   mask 2     keep (excluded / propagation-only): store fs
//   mask 3+j   native BC instance j of the BC table: macroscopic solve,
//              equilibrium / Zou-He / regularized reconstruction, then BGK
//              with the prescribed rho or u (the chain of
//              pallas_step.py:_bc_row_values)
// and writes the result to B. The host swaps A and B every step: the
// Pallas kernels write in place, which is safe only because the TPU grid
// runs in order; concurrent GPU blocks pulling in place would race.
//
// State layout, parameter block and the per-node pieces (pull, collide,
// reflect, keep, the native-BC chain) are in lbm_common.cuh, shared with
// bc_patch.cu.
//
// Bound: device-memory bandwidth. Each node reads Q floats, writes Q floats
// and reads a 1-byte mask per step: 2*19*4 + 1 = 153 B for D3Q19, 73 B for
// D2Q9, against ~1.1 flop per byte. One thread per node, x fastest, so the
// c_x = 0 loads and every store coalesce. This simple design does nothing
// yet about the x-shifted (+-1 element) loads, which straddle 32-byte
// sectors, or about the in-place (AA-pattern) alternative that would halve
// the footprint; both are later performance work.
//
// The per-node branches keep the bulk path's distributions in registers:
// the reflection is a permuted store (no register-array indexing), and the
// BC chain, which needs fs[opp(i)], runs in a non-inlined function on a
// local copy that only BC nodes take.

#include "lbm_common.cuh"

template <int DIM, int Q>
__global__ void __launch_bounds__(LBM_BLOCK)
lbm_step_kernel(const float* __restrict__ a, float* __restrict__ b,
                const uint8_t* __restrict__ mask,
                const __grid_constant__ LBMParams p) {
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
        bc_node<DIM, Q>(p, p.bc[m - 3], t, b, node, n);
    }
}

template <int DIM, int Q>
static int launch(const float* a, float* b, const uint8_t* mask,
                  const LBMParams* p, void* stream) {
    const dim3 grid((p->nx + LBM_BLOCK - 1) / LBM_BLOCK, p->ny, p->nz);
    lbm_step_kernel<DIM, Q><<<grid, LBM_BLOCK, 0, (cudaStream_t)stream>>>(
        a, b, mask, *p);
    return (int)cudaGetLastError();
}

extern "C" {

int lbm_step_d2q9(const float* a, float* b, const uint8_t* mask,
                  const LBMParams* p, void* stream) {
    return launch<2, 9>(a, b, mask, p, stream);
}

int lbm_step_d3q19(const float* a, float* b, const uint8_t* mask,
                   const LBMParams* p, void* stream) {
    return launch<3, 19>(a, b, mask, p, stream);
}

int lbm_params_size(void) { return (int)sizeof(LBMParams); }

}  // extern "C"
