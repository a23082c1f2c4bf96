// Binary free-energy (Landau functional) stream-and-collide step for the
// D2Q9 and D3Q19 lattices, hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels
//   sailfish_tpu/ops/pallas_multi2d.py make_kernel_2d_fe  (B8)
//   sailfish_tpu/ops/pallas_multi3d.py make_kernel_3d_fe  (B10)
// in the fp32 / single-device configuration with walls by mask (codes 0
// collide, 1 full bounce-back, 2 keep), the wetting mirror, a uniform Guo
// body force on the fluid grid, the equilibrium-velocity overrides and
// BGK or FE-MRT relaxation of the fluid grid.
//
// The order parameter phi(x) = sum_i A_1[i, x - c_i] arrives from the
// rho_poststream pre-pass of sc_multi.cu (one component, every node). For
// every node x, fe_step<DIM, Q, MRT>:
//   fs_k,i = A_k[i, x - c_i]            k = 0 fluid, 1 order parameter
//   mask 1  store fs reflected, B_k[opp(i), x] = fs_k,i
//   mask 2  store fs
//   mask 0  rho, phi, j from fs; u = j / rho + F / 2;
//           phi_w(y) = phi(y + n_o) - wall_grad at a dry neighbour y of
//           orientation o >= 1 (the wetting mirror, reach 2 from x), phi(y)
//           otherwise; laplacian and gradient of phi_w over the Q - 1
//           neighbours with the isotropic weights wi:
//             grad = sum_i wi c_i phi_w(x + c_i),
//             lap  = 2 sum_i wi (phi_w(x + c_i) - phi(x));
//           mu = A (phi^3 - phi) - kappa lap;
//           feq, geq at u + off0, u + off1 (the eq_force_map overrides as
//           constant offsets), rest direction by the residual
//           feq_0 = rho - sum_{i>0} feq_i (geq_0 likewise);
//           tau0 = tau_b + (clip(phi, -1, 1) + 1) (tau_a - tau_b) / 2;
//           fluid: BGK at 1/tau0 plus the Guo term at the local tau0, or
//           FE-MRT: feq + P_cons z + (1 - 1/tau0) P_shear z + Fi / 2 with
//           z = fs - feq + Fi / 2 (sailfish_tpu/ops/pallas_multi2d.py
//           fe_mrt_relax), formed over the conserved and shear moments;
//           order parameter: BGK at 1/tau_phi.
// The Pallas kernels emit next step's phi from the post-collision planes
// they still hold (emit_rho); a GPU pull kernel cannot see its neighbours'
// post-collision values within one launch, so the pre-pass runs before
// every step.
//
// State layout: (2, Q, nz, ny, nx) fp32, standard direction order of
// sailfish_tpu_torch.lattice; phi (nz, ny, nx) fp32; mask and orientation maps
// (nz, ny, nx) uint8. Lattice tables, free-energy weights, the MRT rows of
// M and columns of M^-1, relaxation times and forces arrive by value in
// FEParams, filled from the Python side, so the direction order has a
// single source. The host swaps A and B every step.
//
// Bound: device-memory bandwidth. Per node and step the step reads 2*Q*4 B,
// writes 2*Q*4 B, reads 4 B of phi (the neighbours' phi come from cache),
// the mask byte and, with walls, the orientation byte; the pre-pass reads
// Q*4 B and writes 4 B: 389 B for D3Q19, 189 B for D2Q9 (+1 with walls).
// One thread per node, x fastest; the 2*Q pulled values stay in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#define FE_MAX_Q 19
#define FE_MAX_MOM 9
#define FE_BLOCK 128

struct FEParams {
    int nx, ny, nz;
    int has_force;                  // uniform Guo body force on grid 0
    int wetting;                    // orientation map given
    int n_mom;                      // FE-MRT moments (conserved, then shear)
    int c[FE_MAX_Q][3];
    int opp[FE_MAX_Q];
    int ov[6][3];                   // orientation vectors, code k -> ov[k-1]
    float w[FE_MAX_Q];              // lattice weights (Guo term)
    float wi[FE_MAX_Q];             // free-energy weights
    float wxx[FE_MAX_Q], wyy[FE_MAX_Q], wzz[FE_MAX_Q];
    float wxy[FE_MAX_Q], wyz[FE_MAX_Q], wxz[FE_MAX_Q];
    float tau_a, tau_b, inv_tau_phi;
    float A, kappa, Gamma, wall_grad;
    float force[3];                 // body force (acceleration) on grid 0
    float off0[3], off1[3];         // equilibrium velocity = u + off_k
    int mom_shear[FE_MAX_MOM];      // 1: shear moment, relaxes at 1/tau0
    float mom_row[FE_MAX_MOM][FE_MAX_Q];  // rows of M
    float minv[FE_MAX_Q][FE_MAX_MOM];     // matching columns of M^-1
};

__device__ __forceinline__ int wrap(int v, int n) {
    v += v < 0 ? n : 0;
    return v - (v >= n ? n : 0);
}

__device__ __forceinline__ long long lin(const FEParams& p, int x, int y,
                                         int z) {
    return ((long long)z * p.ny + y) * p.nx + x;
}

// phi with the wetting mirror at the (wrapped) node (x, y, z).
template <int DIM>
__device__ __forceinline__ float phi_w(const FEParams& p,
                                       const float* __restrict__ phi,
                                       const uint8_t* __restrict__ orient,
                                       int x, int y, int z) {
    const long long t = lin(p, x, y, z);
    if (p.wetting) {
        const int o = orient[t];
        if (o > 0) {
            const int xn = wrap(x + p.ov[o - 1][0], p.nx);
            const int yn = wrap(y + p.ov[o - 1][1], p.ny);
            const int zn = DIM == 3 ? wrap(z + p.ov[o - 1][2], p.nz) : 0;
            return phi[lin(p, xn, yn, zn)] - p.wall_grad;
        }
    }
    return phi[t];
}

template <int DIM, int Q, int MRT>
__global__ void __launch_bounds__(FE_BLOCK)
fe_step_kernel(const float* __restrict__ a, const float* __restrict__ phi_pre,
               float* __restrict__ b, const uint8_t* __restrict__ mask,
               const uint8_t* __restrict__ orient,
               const __grid_constant__ FEParams p) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y;
    const int z = blockIdx.z;
    if (x >= p.nx) return;
    const long long n = (long long)p.nx * p.ny * p.nz;
    const long long node = lin(p, x, y, z);

    float f0[Q], f1[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        const int xs = wrap(x - p.c[i][0], p.nx);
        const int ys = wrap(y - p.c[i][1], p.ny);
        const int zs = DIM == 3 ? wrap(z - p.c[i][2], p.nz) : 0;
        const long long s = lin(p, xs, ys, zs);
        f0[i] = a[(long long)i * n + s];
        f1[i] = a[(long long)(Q + i) * n + s];
    }

    const int m = mask[node];
    if (m == 1) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
            b[(long long)p.opp[i] * n + node] = f0[i];
            b[(long long)(Q + p.opp[i]) * n + node] = f1[i];
        }
        return;
    }
    if (m != 0) {
#pragma unroll
        for (int i = 0; i < Q; ++i) {
            b[(long long)i * n + node] = f0[i];
            b[(long long)(Q + i) * n + node] = f1[i];
        }
        return;
    }

    // moments and the common velocity
    float rho = 0.0f, phi = 0.0f;
    float j[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        rho += f0[i];
        phi += f1[i];
#pragma unroll
        for (int d = 0; d < DIM; ++d) j[d] += p.c[i][d] * f0[i];
    }
    float u[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < DIM; ++d)
        u[d] = j[d] / rho + (p.has_force ? 0.5f * p.force[d] : 0.0f);

    // isotropic laplacian and gradient of phi_w
    float lap = 0.0f, grad[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 1; i < Q; ++i) {
        const int xn = wrap(x + p.c[i][0], p.nx);
        const int yn = wrap(y + p.c[i][1], p.ny);
        const int zn = DIM == 3 ? wrap(z + p.c[i][2], p.nz) : 0;
        const float pn = phi_w<DIM>(p, phi_pre, orient, xn, yn, zn);
        lap += p.wi[i] * (pn - phi);
#pragma unroll
        for (int d = 0; d < DIM; ++d)
            if (p.c[i][d] != 0) grad[d] += (p.wi[i] * p.c[i][d]) * pn;
    }
    lap *= 2.0f;

    // equilibria
    float u0[3], u1[3], usq0 = 0.0f, usq1 = 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        u0[d] = d < DIM ? u[d] + p.off0[d] : 0.0f;
        u1[d] = d < DIM ? u[d] + p.off1[d] : 0.0f;
        usq0 += u0[d] * u0[d];
        usq1 += u1[d] * u1[d];
    }
    const float pb = rho / 3.0f
        + p.A * (-(phi * phi) / 2.0f + 0.75f * (phi * phi) * (phi * phi));
    const float kphl = p.kappa * phi * lap;
    const float mu = p.A * (-phi + phi * phi * phi) - p.kappa * lap;
    const float gx = grad[0], gy = grad[1], gz = grad[2];
    float feq[Q];
    float feq_sum = 0.0f, geq_sum = 0.0f;
#pragma unroll
    for (int i = 1; i < Q; ++i) {
        const float cu = p.c[i][0] * u0[0] + p.c[i][1] * u0[1]
                         + p.c[i][2] * u0[2];
        float t = p.wi[i] * (pb - kphl + rho * cu
                             + 1.5f * (cu * cu * rho - rho * usq0 / 3.0f));
        float sq = p.wxx[i] * gx * gx + p.wyy[i] * gy * gy
                   + p.wxy[i] * gx * gy;
        if (DIM == 3)
            sq += p.wzz[i] * gz * gz + p.wyz[i] * gy * gz + p.wxz[i] * gx * gz;
        t += p.kappa * sq;
        feq[i] = t;
        feq_sum += t;
        const float cu1 = p.c[i][0] * u1[0] + p.c[i][1] * u1[1]
                          + p.c[i][2] * u1[2];
        geq_sum += p.wi[i] * (p.Gamma * mu + cu1 * phi
                              + 1.5f * phi * (cu1 * cu1 - usq1 / 3.0f));
    }
    feq[0] = rho - feq_sum;

    // order parameter: BGK at tau_phi
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        float geq;
        if (i == 0) {
            geq = phi - geq_sum;
        } else {
            const float cu1 = p.c[i][0] * u1[0] + p.c[i][1] * u1[1]
                              + p.c[i][2] * u1[2];
            geq = p.wi[i] * (p.Gamma * mu + cu1 * phi
                             + 1.5f * phi * (cu1 * cu1 - usq1 / 3.0f));
        }
        b[(long long)(Q + i) * n + node] = f1[i] + (geq - f1[i]) * p.inv_tau_phi;
    }

    // fluid: phi-interpolated tau, BGK or FE-MRT, Guo forcing
    const float tau0 = p.tau_b + (fminf(fmaxf(phi, -1.0f), 1.0f) + 1.0f)
                                 * ((p.tau_a - p.tau_b) * 0.5f);
    const float inv_tau0 = 1.0f / tau0;
    float guo[Q];
    const float uF = u[0] * p.force[0] + u[1] * p.force[1] + u[2] * p.force[2];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        guo[i] = 0.0f;
        if (p.has_force) {
            const float cu = p.c[i][0] * u[0] + p.c[i][1] * u[1]
                             + p.c[i][2] * u[2];
            const float cF = p.c[i][0] * p.force[0] + p.c[i][1] * p.force[1]
                             + p.c[i][2] * p.force[2];
            const float pref = MRT ? 0.5f : 1.0f - 0.5f * inv_tau0;
            guo[i] = pref * p.w[i] * (3.0f * (cF - uF) + 9.0f * cu * cF) * rho;
        }
    }
    if (MRT) {
        // z = fneq + Fi / 2, held in f0
#pragma unroll
        for (int i = 0; i < Q; ++i) f0[i] = f0[i] - feq[i] + guo[i];
        float mom[FE_MAX_MOM];
#pragma unroll
        for (int k = 0; k < FE_MAX_MOM; ++k) {
            float acc = 0.0f;
            if (k < p.n_mom) {
#pragma unroll
                for (int i = 0; i < Q; ++i) acc += p.mom_row[k][i] * f0[i];
                if (p.mom_shear[k]) acc *= 1.0f - inv_tau0;
            }
            mom[k] = acc;
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) {
            float out = feq[i] + guo[i];
#pragma unroll
            for (int k = 0; k < FE_MAX_MOM; ++k)
                if (k < p.n_mom) out += p.minv[i][k] * mom[k];
            b[(long long)i * n + node] = out;
        }
    } else {
#pragma unroll
        for (int i = 0; i < Q; ++i)
            b[(long long)i * n + node] =
                f0[i] + (feq[i] - f0[i]) * inv_tau0 + guo[i];
    }
}

template <int DIM, int Q>
static int launch(const float* a, const float* phi, float* b,
                  const uint8_t* mask, const uint8_t* orient, int mrt,
                  const FEParams* p, void* stream) {
    const dim3 grid((p->nx + FE_BLOCK - 1) / FE_BLOCK, p->ny, p->nz);
    if (mrt)
        fe_step_kernel<DIM, Q, 1><<<grid, FE_BLOCK, 0, (cudaStream_t)stream>>>(
            a, phi, b, mask, orient, *p);
    else
        fe_step_kernel<DIM, Q, 0><<<grid, FE_BLOCK, 0, (cudaStream_t)stream>>>(
            a, phi, b, mask, orient, *p);
    return (int)cudaGetLastError();
}

extern "C" {

int fe_step_d2q9(const float* a, const float* phi, float* b,
                 const uint8_t* mask, const uint8_t* orient, int mrt,
                 const FEParams* p, void* stream) {
    return launch<2, 9>(a, phi, b, mask, orient, mrt, p, stream);
}

int fe_step_d3q19(const float* a, const float* phi, float* b,
                  const uint8_t* mask, const uint8_t* orient, int mrt,
                  const FEParams* p, void* stream) {
    return launch<3, 19>(a, phi, b, mask, orient, mrt, p, stream);
}

int fe_params_size(void) { return (int)sizeof(FEParams); }

}  // extern "C"
