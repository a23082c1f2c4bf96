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
// State layout: (Q, nz, ny, nx) fp32, standard direction order of
// sailfish_tpu.lattice. The lattice tables (c, w, opposite) and the BC
// table arrive by value in LBMParams, filled from the Python lattice and
// node classification, so the direction order has a single source.
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

#include <cuda_runtime.h>
#include <stdint.h>

#define LBM_MAX_Q 27
#define LBM_MAX_BC 16
#define LBM_BLOCK 128

// BC kinds; mirrored in sailfish_tpu_torch/ops/lbm_step.py (BC_KINDS).
// Even kinds prescribe velocity, odd kinds density.
enum {
    BC_EQ_VELOCITY = 0,
    BC_EQ_DENSITY = 1,
    BC_ZOUHE_VELOCITY = 2,
    BC_ZOUHE_DENSITY = 3,
    BC_REG_VELOCITY = 4,
    BC_REG_DENSITY = 5,
};

struct LBMBC {
    int kind;
    int axis;       // axis of the inward normal (0 = x, 1 = y, 2 = z)
    int sign;       // +1 / -1: direction of the inward normal
    float rho;      // prescribed density (density kinds)
    float u[3];     // prescribed velocity (velocity kinds)
};

struct LBMParams {
    int nx, ny, nz;
    int nbc;
    float tau_inv;
    int c[LBM_MAX_Q][3];
    float w[LBM_MAX_Q];
    int opp[LBM_MAX_Q];
    LBMBC bc[LBM_MAX_BC];
};

template <int Q>
__device__ __forceinline__ float feq_i(const LBMParams& p, int i, float rho,
                                       const float* u, float usq) {
    const float cu = p.c[i][0] * u[0] + p.c[i][1] * u[1] + p.c[i][2] * u[2];
    const float poly = 3.0f * cu + 4.5f * cu * cu - 1.5f * usq;
    return p.w[i] * (rho + rho * poly);
}

// Native BC chain for one node. t: post-stream distributions (local copy).
template <int DIM, int Q>
__device__ __noinline__ void bc_node(const LBMParams& p, const LBMBC& bc,
                                     float* t, float* __restrict__ b,
                                     long long node, long long n) {
    const int axis = bc.axis;
    const int sign = bc.sign;
    const bool velocity = (bc.kind % 2) == 0;
    const int family = bc.kind / 2;   // 0 equilibrium, 1 Zou-He, 2 regularized

    // macroscopic solve (Zou & He)
    float s0 = 0.0f, s_in = 0.0f;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        const int cn = sign * p.c[i][axis];
        if (cn == 0) s0 += t[i];
        else if (cn < 0) s_in += t[i];
    }
    float rho, u[3];
    if (velocity) {
        const float un = sign > 0 ? bc.u[axis] : -bc.u[axis];
        rho = (s0 + 2.0f * s_in) / (1.0f - un);
        u[0] = bc.u[0]; u[1] = bc.u[1]; u[2] = bc.u[2];
    } else {
        const float un = 1.0f - (s0 + 2.0f * s_in) / bc.rho;
        rho = bc.rho;
        u[0] = u[1] = u[2] = 0.0f;
        u[axis] = sign > 0 ? un : -un;
    }
    if (DIM == 2) u[2] = 0.0f;
    float usq = 0.0f;
#pragma unroll
    for (int a = 0; a < DIM; ++a) usq += u[a] * u[a];

    float feq[Q], f2[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) feq[i] = feq_i<Q>(p, i, rho, u, usq);

    if (family == 0) {
#pragma unroll
        for (int i = 0; i < Q; ++i) f2[i] = feq[i];
    } else {
        // non-equilibrium bounce-back of the unknown (incoming) directions
#pragma unroll
        for (int i = 0; i < Q; ++i) {
            const int o = p.opp[i];
            f2[i] = (sign * p.c[i][axis] > 0) ? t[o] + feq[i] - feq[o] : t[i];
        }
        if (family == 1) {
            // Zou-He tangential momentum fixup
            float mom[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int a = 0; a < DIM; ++a)
#pragma unroll
                for (int i = 0; i < Q; ++i) mom[a] += p.c[i][a] * f2[i];
#pragma unroll
            for (int a = 0; a < DIM; ++a) {
                if (a == axis) continue;
                int denom = 0;
#pragma unroll
                for (int i = 0; i < Q; ++i)
                    if (sign * p.c[i][axis] > 0) denom += p.c[i][a] * p.c[i][a];
                if (denom == 0) continue;
                const float dj = rho * u[a] - mom[a];
#pragma unroll
                for (int i = 0; i < Q; ++i) {
                    const int coeff = (sign * p.c[i][axis] > 0) ? p.c[i][a] : 0;
                    if (coeff != 0) f2[i] += ((float)coeff / (float)denom) * dj;
                }
            }
        } else {
            // regularized: feq + w_i / (2 cs^4) Q_i : Pi^neq
            const float cs2 = 1.0f / 3.0f;
            float pi[3][3];
#pragma unroll
            for (int a = 0; a < DIM; ++a)
#pragma unroll
                for (int c2 = 0; c2 < DIM; ++c2) {
                    float acc = 0.0f;
#pragma unroll
                    for (int i = 0; i < Q; ++i)
                        acc += (p.c[i][a] * p.c[i][c2]) * (f2[i] - feq[i]);
                    pi[a][c2] = acc;
                }
#pragma unroll
            for (int i = 0; i < Q; ++i) {
                float qpi = 0.0f;
#pragma unroll
                for (int a = 0; a < DIM; ++a)
#pragma unroll
                    for (int c2 = 0; c2 < DIM; ++c2) {
                        const float coef = (float)(p.c[i][a] * p.c[i][c2])
                                           - (a == c2 ? cs2 : 0.0f);
                        qpi += coef * pi[a][c2];
                    }
                f2[i] = feq[i] + p.w[i] * qpi / (2.0f * cs2 * cs2);
            }
        }
    }
    // BGK with the prescribed macroscopic fields
#pragma unroll
    for (int i = 0; i < Q; ++i)
        b[i * n + node] = f2[i] + p.tau_inv * (feq[i] - f2[i]);
}

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
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        int xs = x - p.c[i][0];
        xs += xs < 0 ? p.nx : 0;
        xs -= xs >= p.nx ? p.nx : 0;
        int ys = y - p.c[i][1];
        ys += ys < 0 ? p.ny : 0;
        ys -= ys >= p.ny ? p.ny : 0;
        int zs = 0;
        if (DIM == 3) {
            zs = z - p.c[i][2];
            zs += zs < 0 ? p.nz : 0;
            zs -= zs >= p.nz ? p.nz : 0;
        }
        fs[i] = a[i * n + zs * nxy + (long long)ys * p.nx + xs];
    }

    const int m = mask[node];
    if (m == 0) {
        float rho = 0.0f;
#pragma unroll
        for (int i = 0; i < Q; ++i) rho += fs[i];
        float u[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
            float mom = 0.0f;
#pragma unroll
            for (int i = 0; i < Q; ++i) mom += p.c[i][d] * fs[i];
            u[d] = mom / rho;
        }
        float usq = 0.0f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) usq += u[d] * u[d];
#pragma unroll
        for (int i = 0; i < Q; ++i)
            b[i * n + node] =
                fs[i] + p.tau_inv * (feq_i<Q>(p, i, rho, u, usq) - fs[i]);
    } else if (m == 1) {
#pragma unroll
        for (int i = 0; i < Q; ++i) b[(long long)p.opp[i] * n + node] = fs[i];
    } else if (m == 2) {
#pragma unroll
        for (int i = 0; i < Q; ++i) b[i * n + node] = fs[i];
    } else {
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
