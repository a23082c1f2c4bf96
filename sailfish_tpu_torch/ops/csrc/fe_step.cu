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
// every node x, both kernels compute:
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
// (nz, ny, nx) uint8. The physical constants, forces, offsets and the
// FE-MRT rows of M and columns of M^-1 arrive by value in FEParams. The
// host swaps A and B every step.
//
// Bound: device-memory bandwidth. Per node and step the step reads 2*Q*4 B,
// writes 2*Q*4 B, reads 4 B of phi (the neighbours' phi come from cache or
// shared memory), the mask byte and, with walls, the orientation byte; the
// pre-pass reads Q*4 B and writes 4 B: 389 B for D3Q19, 189 B for D2Q9 (+1
// with walls).
//
// fe_step_kernel<2, 9, MRT> (B8): one thread per node, x fastest, blocks
// of 128 nodes of one x-row; the lattice tables arrive in FEParams; the
// 2*Q pulled values stay in registers.
//
// fe3_kernel<MRT, WET> (B10): the per-node instruction count, not
// the bytes, held the one-row design of the 2D kernel back in 3D (5,031
// SASS instructions, 43 % of them integer index arithmetic, against ~3,090
// warp instructions per thread that the card issues in the byte bound;
// PERF.md). So:
// - A block is a tx x ty tile of threads in (x, y) that marches over kz
//   z-planes; the Python wrapper computes tx, ty, kz, the grid and the
//   shared bytes (FETile) and this file checks them.
// - The order parameter's stencil comes from shared memory: a ring of phi
//   planes of (ty + 2) x (tx + 2) (halo 1) holds planes z - 1, z, z + 1
//   while the next plane is copied in with cp.async (double buffering).
//   With wetting, raw phi is staged with a halo of 2 (the mirror reaches
//   one node further) and the orientation byte beside it; phi_w is formed
//   once per staged node into a second ring of halo 1, so the mirror runs
//   once per node instead of once per stencil read. Periodic wrap is in
//   each thread's source address: TMA cannot wrap a box around the domain
//   edge (out-of-bounds elements are zero-filled), a wrapped tile would
//   need up to four boxes per plane, and the plane is a few KB, so
//   per-thread cp.async of 4 B is the simpler copy.
// - The D3Q19 tables (c, opp, orientation vectors, w, wi, wxx..wxz) are
//   compile-time (struct D3Q19 in lattice_tables.cuh, which lbm_step.cu
//   shares): zero terms and the c_i . u products fold away.
//   fe_d3q19_tables copies them out, and ops/fe_step.py checks them
//   against sailfish_tpu_torch.lattice and multigrid.fe_weights at load.
// - Addresses are 32-bit in-plane offsets from the wrapped x +- 1 and
//   y +- 1 of the node, computed once per block, and three plane offsets
//   per z-plane, added to the uniform per-direction base a + i * n.
// - The order-parameter equilibrium is formed once per direction and each
//   g_i is relaxed and stored in turn; BGK does the same for f_i.
// - __launch_bounds__(256, 2): BGK takes 128 registers with or without
//   the cap, 0 spills (a cap at 3 blocks, 80 registers, ran 3 % slower;
//   tools/fe_tile_sweep.py); FE-MRT, with its 9 moments, gets a minimum
//   of 1 block.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lattice_tables.cuh"

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

// ---------------------------------------------------------------------------
// D3Q19: the z-marching tile (B10)

#define FE3_THREADS 256     // most threads of a block (tx * ty)
#define FE3_MAX_FILL 4      // most staged-plane entries per thread

// The tables as fe_d3q19_tables copies them out (mirrored in ops/fe_step.py
// _Tables).
struct FETables {
    int c[19][3];
    int opp[19];
    int ov[6][3];
    float w[19], wi[19];
    float wxx[19], wyy[19], wzz[19], wxy[19], wyz[19], wxz[19];
};

// Launch geometry of fe3_kernel, computed by the Python wrapper.
struct FETile {
    int tx, ty, kz;     // block of tx x ty threads over (x, y); kz z-planes
    int grid[3];        // blocks along x, y, z
    int smem_bytes;     // dynamic shared memory of a block
};

__host__ __device__ __forceinline__ int pos_mod(int v, int n) {
    const int m = v % n;
    return m < 0 ? m + n : m;
}

// Shared bytes of a block: NRAW raw phi planes of (ty + 2h) x (tx + 2h)
// (h = 2 with wetting, else 1); with wetting also three phi_w planes of
// (ty + 2) x (tx + 2) and one orientation plane of the raw layout.
__host__ __device__ __forceinline__ int fe3_smem_bytes(int tx, int ty,
                                                       int wet) {
    const int h = wet ? 2 : 1;
    const int plane = (tx + 2 * h) * (ty + 2 * h);
    if (!wet)
        return 4 * 4 * plane;
    return 4 * 3 * plane + 4 * 3 * (tx + 2) * (ty + 2) + plane;
}

// One collide (or reflect, or keep) at the node whose wrapped source
// columns are xs, rows (times nx) ys and planes (times nx * ny) zs, indexed
// by c + 1 of the pull x - c; st[dz + 1] points at the node in the stencil
// plane z + dz, whose rows are pw1 floats apart.
template <int MRT>
__device__ __forceinline__ void fe3_node(
    const float* __restrict__ a, float* __restrict__ b,
    const uint8_t* __restrict__ mask, const FEParams& p, int n,
    const int (&xs)[3], const int (&ys)[3], const int (&zs)[3],
    const float* const (&st)[3], int pw1) {
    using L = D3Q19;
    constexpr int Q = L::Q;
    const int node = zs[1] + ys[1] + xs[1];
    float f[Q], g[Q];
    static_for<Q>([&](auto I) {
        constexpr int i = decltype(I)::value;
        const int s = zs[1 + L::c(i, 2)] + ys[1 + L::c(i, 1)]
                      + xs[1 + L::c(i, 0)];
        f[i] = a[(size_t)i * n + s];
        g[i] = a[(size_t)(Q + i) * n + s];
    });
    const int m = mask[node];
    if (m == 1) {
        static_for<Q>([&](auto I) {
            constexpr int i = decltype(I)::value;
            b[(size_t)L::opp(i) * n + node] = f[i];
            b[(size_t)(Q + L::opp(i)) * n + node] = g[i];
        });
        return;
    }
    if (m != 0) {
        static_for<Q>([&](auto I) {
            constexpr int i = decltype(I)::value;
            b[(size_t)i * n + node] = f[i];
            b[(size_t)(Q + i) * n + node] = g[i];
        });
        return;
    }

    // moments and the common velocity
    float rho = -0.0f, phi = -0.0f, jx = -0.0f, jy = -0.0f, jz = -0.0f;
    static_for<Q>([&](auto I) {
        constexpr int i = decltype(I)::value;
        rho += f[i];
        phi += g[i];
        if constexpr (L::c(i, 0) > 0) jx += f[i];
        if constexpr (L::c(i, 0) < 0) jx -= f[i];
        if constexpr (L::c(i, 1) > 0) jy += f[i];
        if constexpr (L::c(i, 1) < 0) jy -= f[i];
        if constexpr (L::c(i, 2) > 0) jz += f[i];
        if constexpr (L::c(i, 2) < 0) jz -= f[i];
    });
    // the force is 0 without one, which leaves u and the Guo term 0
    const float ux = jx / rho + 0.5f * p.force[0];
    const float uy = jy / rho + 0.5f * p.force[1];
    const float uz = jz / rho + 0.5f * p.force[2];

    // isotropic laplacian and gradient of phi_w: the axis neighbours
    // (wi = 1/6) and the diagonal ones (wi = 1/12) summed apart, as
    // ops/multigrid.py laplacian_and_grad groups them
    float s_ax = -0.0f, s_dg = -0.0f;
    float g_ax[3] = {-0.0f, -0.0f, -0.0f}, g_dg[3] = {-0.0f, -0.0f, -0.0f};
    static_for<Q>([&](auto I) {
        constexpr int i = decltype(I)::value;
        if constexpr (i > 0) {
            constexpr int cx = L::c(i, 0), cy = L::c(i, 1), cz = L::c(i, 2);
            const float* row = st[cz + 1];
            if constexpr (cy > 0) row += pw1;
            if constexpr (cy < 0) row -= pw1;
            const float pn = row[cx];
            auto add = [&](float& s, float* gd) {
                s += pn;
                if constexpr (cx > 0) gd[0] += pn;
                if constexpr (cx < 0) gd[0] -= pn;
                if constexpr (cy > 0) gd[1] += pn;
                if constexpr (cy < 0) gd[1] -= pn;
                if constexpr (cz > 0) gd[2] += pn;
                if constexpr (cz < 0) gd[2] -= pn;
            };
            if constexpr (L::n2(i) == 1)
                add(s_ax, g_ax);
            else
                add(s_dg, g_dg);
        }
    });
    const float lap = s_dg * (1.0f / 6.0f) + s_ax * (1.0f / 3.0f)
                      - 4.0f * phi;
    const float gx = g_dg[0] * (1.0f / 12.0f) + g_ax[0] * (1.0f / 6.0f);
    const float gy = g_dg[1] * (1.0f / 12.0f) + g_ax[1] * (1.0f / 6.0f);
    const float gz = g_dg[2] * (1.0f / 12.0f) + g_ax[2] * (1.0f / 6.0f);

    // equilibria: feq_i = wi (fbase + rho cu (1 + 1.5 cu)) + kappa sq_i,
    // geq_i = wi (gbase + phi cu1 (1 + 1.5 cu1))
    const float u0x = ux + p.off0[0], u0y = uy + p.off0[1],
                u0z = uz + p.off0[2];
    const float u1x = ux + p.off1[0], u1y = uy + p.off1[1],
                u1z = uz + p.off1[2];
    const float usq0 = u0x * u0x + u0y * u0y + u0z * u0z;
    const float usq1 = u1x * u1x + u1y * u1y + u1z * u1z;
    const float pb = rho * (1.0f / 3.0f)
        + p.A * (-(phi * phi) * 0.5f + 0.75f * (phi * phi) * (phi * phi));
    const float mu = p.A * (-phi + phi * phi * phi) - p.kappa * lap;
    const float fbase = pb - p.kappa * phi * lap - 0.5f * rho * usq0;
    const float gbase = p.Gamma * mu - 0.5f * phi * usq1;
    const float kxx = p.kappa * gx * gx, kyy = p.kappa * gy * gy,
                kzz = p.kappa * gz * gz;
    const float kxy = p.kappa * gx * gy, kyz = p.kappa * gy * gz,
                kxz = p.kappa * gx * gz;

    // order parameter: BGK at tau_phi, each g_i relaxed and stored in turn,
    // the rest direction last
    float geq_sum = 0.0f;
    static_for<Q>([&](auto I) {
        constexpr int i = decltype(I)::value;
        if constexpr (i > 0) {
            const float cu1 = cdot<L, i>(u1x, u1y, u1z);
            const float geq = L::wi(i) * (gbase
                                          + phi * cu1 * (1.0f + 1.5f * cu1));
            geq_sum += geq;
            b[(size_t)(Q + i) * n + node] =
                g[i] + (geq - g[i]) * p.inv_tau_phi;
        }
    });
    b[(size_t)Q * n + node] =
        g[0] + ((phi - geq_sum) - g[0]) * p.inv_tau_phi;

    // fluid: phi-interpolated tau, BGK or FE-MRT, Guo forcing
    const float tau0 = p.tau_b + (fminf(fmaxf(phi, -1.0f), 1.0f) + 1.0f)
                                 * ((p.tau_a - p.tau_b) * 0.5f);
    const float inv_tau0 = 1.0f / tau0;
    const float uF = ux * p.force[0] + uy * p.force[1] + uz * p.force[2];
    const float pref = MRT ? 0.5f : 1.0f - 0.5f * inv_tau0;
    auto feq_of = [&](auto I) {
        constexpr int i = decltype(I)::value;
        const float cu = cdot<L, i>(u0x, u0y, u0z);
        float sq = L::wdd(i, 0) * kxx + L::wdd(i, 1) * kyy
                   + L::wdd(i, 2) * kzz;
        if constexpr (L::wod(i, 0, 1) != 0.0f) sq += L::wod(i, 0, 1) * kxy;
        if constexpr (L::wod(i, 1, 2) != 0.0f) sq += L::wod(i, 1, 2) * kyz;
        if constexpr (L::wod(i, 0, 2) != 0.0f) sq += L::wod(i, 0, 2) * kxz;
        return L::wi(i) * (fbase + rho * cu * (1.0f + 1.5f * cu)) + sq;
    };
    auto guo_of = [&](auto I) {
        constexpr int i = decltype(I)::value;
        const float cu = cdot<L, i>(ux, uy, uz);
        const float cF = cdot<L, i>(p.force[0], p.force[1], p.force[2]);
        return pref * L::w(i) * (3.0f * (cF - uF) + 9.0f * cu * cF) * rho;
    };
    if (!MRT) {
        float feq_sum = 0.0f;
        static_for<Q>([&](auto I) {
            constexpr int i = decltype(I)::value;
            if constexpr (i > 0) {
                const float feq = feq_of(I);
                feq_sum += feq;
                b[(size_t)i * n + node] =
                    f[i] + (feq - f[i]) * inv_tau0 + guo_of(I);
            }
        });
        b[node] = f[0] + ((rho - feq_sum) - f[0]) * inv_tau0
                  + guo_of(Int<0>());
    } else {
        float feq[Q], guo[Q];
        float feq_sum = 0.0f;
        static_for<Q>([&](auto I) {
            constexpr int i = decltype(I)::value;
            if constexpr (i > 0) {
                feq[i] = feq_of(I);
                feq_sum += feq[i];
            }
            guo[i] = guo_of(I);
        });
        feq[0] = rho - feq_sum;
        // z = fneq + Fi / 2, held in f
        static_for<Q>([&](auto I) {
            constexpr int i = decltype(I)::value;
            f[i] = f[i] - feq[i] + guo[i];
        });
        float mom[FE_MAX_MOM];
#pragma unroll
        for (int k = 0; k < FE_MAX_MOM; ++k) {
            float acc = 0.0f;
            if (k < p.n_mom) {
#pragma unroll
                for (int i = 0; i < Q; ++i) acc += p.mom_row[k][i] * f[i];
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
            b[(size_t)i * n + node] = out;
        }
    }
}

template <int MRT, int WET>
__global__ void __launch_bounds__(FE3_THREADS, MRT ? 1 : 2)
fe3_kernel(const float* __restrict__ a, const float* __restrict__ phi_pre,
           float* __restrict__ b, const uint8_t* __restrict__ mask,
           const uint8_t* __restrict__ orient,
           const __grid_constant__ FEParams p, const FETile t) {
    extern __shared__ __align__(16) float fe_smem[];
    constexpr int H = WET ? 2 : 1;          // halo of the raw phi planes
    constexpr int NRAW = WET ? 3 : 4;       // raw phi planes in the ring
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    const int nxy = nx * ny, n = nxy * nz;  // n < 2^31: the wrapper checks
    const int nthr = t.tx * t.ty;
    const int tid = threadIdx.y * t.tx + threadIdx.x;
    const int x0 = blockIdx.x * t.tx, y0 = blockIdx.y * t.ty;
    const int z0 = blockIdx.z * t.kz;
    const int z1 = min(z0 + t.kz, nz);
    const int pw = t.tx + 2 * H, plane = pw * (t.ty + 2 * H);
    const int pw1 = t.tx + 2, plane1 = pw1 * (t.ty + 2);
    float* raw = fe_smem;
    float* phw = WET ? raw + NRAW * plane : raw;       // the stencil's ring
    uint8_t* ori = (uint8_t*)(phw + 3 * plane1);      // with WET only
    // ring slots: raw plane zz >= z0 - 2, stencil plane zz >= z0 - 1
    auto raw_slot = [&](int zz) { return (zz - z0 + 2) % NRAW; };
    auto st_plane = [&](int zz) {
        return WET ? phw + ((zz - z0 + 1) % 3) * plane1
                   : raw + raw_slot(zz) * plane;
    };

    // this thread's entries of a raw plane: entry e = tid + k * nthr at
    // (e / pw, e % pw), the in-plane offset of its wrapped node
    int fill[FE3_MAX_FILL];
#pragma unroll
    for (int k = 0; k < FE3_MAX_FILL; ++k) {
        const int e = tid + k * nthr;
        const int ly = e / pw, lx = e - ly * pw;
        fill[k] = pos_mod(y0 + ly - H, ny) * nx + pos_mod(x0 + lx - H, nx);
    }
    auto stage = [&](int zz) {     // raw phi plane zz, by cp.async
        const float* src = phi_pre + pos_mod(zz, nz) * nxy;
        float* dst = raw + raw_slot(zz) * plane;
#pragma unroll
        for (int k = 0; k < FE3_MAX_FILL; ++k) {
            const int e = tid + k * nthr;
            if (e < plane) __pipeline_memcpy_async(dst + e, src + fill[k], 4);
        }
        __pipeline_commit();
    };

    // wetting: the orientation bytes of a plane pass through registers
    // into the raw layout; each halo-1 entry e1 of a phi_w plane reads
    // the raw layout at src1[k]
    uint8_t o_next[FE3_MAX_FILL];
    int src1[FE3_MAX_FILL];
    if (WET) {
#pragma unroll
        for (int k = 0; k < FE3_MAX_FILL; ++k) {
            const int e1 = tid + k * nthr;
            const int ly = e1 / pw1, lx = e1 - ly * pw1;
            src1[k] = (ly + 1) * pw + lx + 1;
        }
    }
    auto load_orient = [&](int zz) {
        const uint8_t* src = orient + pos_mod(zz, nz) * nxy;
#pragma unroll
        for (int k = 0; k < FE3_MAX_FILL; ++k)
            o_next[k] = tid + k * nthr < plane ? src[fill[k]] : 0;
    };
    auto store_orient = [&]() {
#pragma unroll
        for (int k = 0; k < FE3_MAX_FILL; ++k) {
            const int e = tid + k * nthr;
            if (e < plane) ori[e] = o_next[k];
        }
    };
    auto form = [&](int zk) {      // phi_w plane zk from raw zk - 1 .. zk + 1
        const float* r0 = raw + raw_slot(zk) * plane;
        float* dst = st_plane(zk);
#pragma unroll
        for (int k = 0; k < FE3_MAX_FILL; ++k) {
            const int e1 = tid + k * nthr;
            if (e1 < plane1) {
                const int s = src1[k];
                const int o = ori[s];
                float v;
                if (o == 0) {
                    v = r0[s];
                } else {
                    const int dx = D3Q19::ov(o - 1, 0),
                              dy = D3Q19::ov(o - 1, 1),
                              dz = D3Q19::ov(o - 1, 2);
                    v = raw[raw_slot(zk + dz) * plane + s + dy * pw + dx]
                        - p.wall_grad;
                }
                dst[e1] = v;
            }
        }
    };

    // the node's wrapped source columns, rows and (per plane) planes,
    // indexed by c + 1 of the pull x - c
    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    const bool active = x < nx && y < ny;
    const int xs[3] = {x + 1 < nx ? x + 1 : 0, x, x > 0 ? x - 1 : nx - 1};
    const int ys[3] = {(y + 1 < ny ? y + 1 : 0) * nx, y * nx,
                       (y > 0 ? y - 1 : ny - 1) * nx};
    const int sc = (threadIdx.y + 1) * pw1 + threadIdx.x + 1;

    // prologue: the stencil planes z0 - 1, z0, z0 + 1
    if (WET) {
        stage(z0 - 2);
        stage(z0 - 1);
        for (int zk = z0 - 1; zk <= z0 + 1; ++zk) {
            stage(zk + 1);
            load_orient(zk);
            store_orient();
            __pipeline_wait_prior(0);
            __syncthreads();
            form(zk);
            __syncthreads();
        }
    } else {
        stage(z0 - 1);
        stage(z0);
        stage(z0 + 1);
        __pipeline_wait_prior(0);
        __syncthreads();
    }

    for (int z = z0; z < z1; ++z) {
        const bool more = z + 1 < z1;
        if (more) {            // the next plane's copy, behind this one's work
            if (WET) {
                stage(z + 3);
                load_orient(z + 2);
            } else {
                stage(z + 2);
            }
        }
        if (active) {
            const int zs[3] = {(z + 1 < nz ? z + 1 : 0) * nxy, z * nxy,
                               (z > 0 ? z - 1 : nz - 1) * nxy};
            const float* const st[3] = {st_plane(z - 1) + sc,
                                        st_plane(z) + sc,
                                        st_plane(z + 1) + sc};
            fe3_node<MRT>(a, b, mask, p, n, xs, ys, zs, st, pw1);
        }
        if (more) {
            if (WET) store_orient();
            __pipeline_wait_prior(0);
            __syncthreads();
            if (WET) {
                form(z + 2);
                __syncthreads();
            }
        }
    }
}


template <int MRT, int WET>
static void fe3_launch(const float* a, const float* phi, float* b,
                       const uint8_t* mask, const uint8_t* orient,
                       const FEParams& p, const FETile& t,
                       cudaStream_t stream) {
    const dim3 grid(t.grid[0], t.grid[1], t.grid[2]), block(t.tx, t.ty);
    fe3_kernel<MRT, WET><<<grid, block, t.smem_bytes, stream>>>(
        a, phi, b, mask, orient, p, t);
}

// fe3_kernel after checking the wrapper's geometry against what the kernel
// assumes: a block of at most FE3_THREADS threads, at most FE3_MAX_FILL
// staged entries per thread, a grid that covers the domain, the shared
// bytes of fe3_smem_bytes and fewer than 2^31 nodes.
static int launch3(const float* a, const float* phi, float* b,
                   const uint8_t* mask, const uint8_t* orient, int mrt,
                   const FEParams* p, const FETile* t, void* stream) {
    const int wet = p->wetting && orient != nullptr;
    const int nthr = t->tx * t->ty;
    const int h = wet ? 2 : 1;
    const int plane = (t->tx + 2 * h) * (t->ty + 2 * h);
    if (t->tx < 1 || t->ty < 1 || t->kz < 1 || nthr > FE3_THREADS
        || (plane + nthr - 1) / nthr > FE3_MAX_FILL
        || (long long)t->grid[0] * t->tx < p->nx
        || (long long)t->grid[1] * t->ty < p->ny
        || (long long)t->grid[2] * t->kz < p->nz
        || t->smem_bytes < fe3_smem_bytes(t->tx, t->ty, wet)
        || (long long)p->nx * p->ny * p->nz >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (mrt)
        (wet ? fe3_launch<1, 1> : fe3_launch<1, 0>)(a, phi, b, mask, orient,
                                                    *p, *t, s);
    else
        (wet ? fe3_launch<0, 1> : fe3_launch<0, 0>)(a, phi, b, mask, orient,
                                                    *p, *t, s);
    return (int)cudaGetLastError();
}

static int launch2(const float* a, const float* phi, float* b,
                   const uint8_t* mask, const uint8_t* orient, int mrt,
                   const FEParams* p, void* stream) {
    const dim3 grid((p->nx + FE_BLOCK - 1) / FE_BLOCK, p->ny, p->nz);
    if (mrt)
        fe_step_kernel<2, 9, 1><<<grid, FE_BLOCK, 0, (cudaStream_t)stream>>>(
            a, phi, b, mask, orient, *p);
    else
        fe_step_kernel<2, 9, 0><<<grid, FE_BLOCK, 0, (cudaStream_t)stream>>>(
            a, phi, b, mask, orient, *p);
    return (int)cudaGetLastError();
}

extern "C" {

int fe_step_d2q9(const float* a, const float* phi, float* b,
                 const uint8_t* mask, const uint8_t* orient, int mrt,
                 const FEParams* p, void* stream) {
    return launch2(a, phi, b, mask, orient, mrt, p, stream);
}

int fe_step_d3q19(const float* a, const float* phi, float* b,
                  const uint8_t* mask, const uint8_t* orient, int mrt,
                  const FEParams* p, const FETile* t, void* stream) {
    return launch3(a, phi, b, mask, orient, mrt, p, t, stream);
}

int fe_params_size(void) { return (int)sizeof(FEParams); }

int fe_tables_size(void) { return (int)sizeof(FETables); }

// The compile-time D3Q19 tables of fe3_kernel, for the check at load.
void fe_d3q19_tables(FETables* out) {
    using L = D3Q19;
    for (int i = 0; i < L::Q; ++i) {
        for (int d = 0; d < 3; ++d) out->c[i][d] = L::c(i, d);
        out->opp[i] = L::opp(i);
        out->w[i] = L::w(i);
        out->wi[i] = L::wi(i);
        out->wxx[i] = L::wdd(i, 0);
        out->wyy[i] = L::wdd(i, 1);
        out->wzz[i] = L::wdd(i, 2);
        out->wxy[i] = L::wod(i, 0, 1);
        out->wyz[i] = L::wod(i, 1, 2);
        out->wxz[i] = L::wod(i, 0, 2);
    }
    for (int k = 0; k < 6; ++k)
        for (int d = 0; d < 3; ++d) out->ov[k][d] = L::ov(k, d);
}

}  // extern "C"
