// K-component Shan-Chen step for the D2Q9 and D3Q19 BGK lattices, and
// the post-stream density pre-pass that feeds it; hand-written CUDA C++
// for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels
//   sailfish_tpu/ops/pallas_step.py    make_rho_kernel_3d       (B5)
//   sailfish_tpu/ops/pallas_step2d.py  make_rho_kernel_2d       (B6)
//   sailfish_tpu/ops/pallas_multi2d.py make_kernel_2d_sc_multi  (B7)
//   sailfish_tpu/ops/pallas_multi3d.py make_kernel_3d_sc_multi  (B9)
// in the BGK / fp32 / single-device configuration with walls by mask
// (codes 0 collide, 1 full bounce-back, 2 keep), for K = 2 and 3
// components, each with an optional constant Guo body force.
//
// rho_poststream<DIM, Q>: for every node x and component k,
//   rho_k(x) = sum_i A_k[i, x - c_i]          (periodic wrap, no mask)
// summed in direction order. Wall nodes get a density too: the force at a
// wet node next to a wall reads psi of the wall node's post-stream
// density, as the XLA engine does.
//
// sc_multi_step<DIM, Q, K, FORCED>: for every node x,
//   fs_k,i = A_k[i, x - c_i]                   pull streaming, periodic wrap
//   mask 1  store fs reflected, B_k[opp(i), x] = fs_k,i
//   mask 2  store fs
//   mask 0  rho_k, mom_k from fs_k;
//           u' = (sum_k mom_k / tau_k) / (sum_k rho_k / tau_k);
//           S_k = sum_{i>0} w_i psi(rho_k(x + c_i)) c_i   (pre-pass rho);
//           F_j = -sum_{j<=k} G_jk psi(rho_j) S_k, and for j != k also
//           F_k -= G_jk psi(rho_k) S_j (couplings used symmetrically, in
//           the order of sailfish_tpu/ops/multigrid.py:186-199);
//           u_k = u' + tau_k F_k / rho_k;
//           B_k = fs_k + (feq(rho_k, u_k) - fs_k) / tau_k.
//   FORCED: each component's constant acceleration a_k (zero for an
//           unforced one) shifts the equilibrium velocity after the
//           pseudopotential shift, u_k += a_k / 2, and adds the Guo term
//           at that u_k: (1 - 1/(2 tau_k)) w_i rho_k
//           (3 (c_i.a_k - u_k.a_k) + 9 (c_i.u_k)(c_i.a_k))
//           (sailfish_tpu/ops/pallas_multi3d.py:548-575). a_k comes from
//           the by-value block and adds no bytes per node.
// The Pallas kernels emit next step's densities from the post-collision
// planes they still hold (emit_rho): the TPU grid runs in order. A GPU
// pull kernel cannot see its neighbours' post-collision values within one
// launch, so the density pre-pass runs before every step (the JAX
// wrapper's path with emit_rho off, pallas_multi3d.py:1696-1698).
//
// State layout: (K, Q, nz, ny, nx) fp32, standard direction order of
// sailfish_tpu_torch.lattice; densities (K, nz, ny, nx). Lattice tables,
// relaxation times, couplings and accelerations arrive by value in
// SCParams, filled from the Python lattice, so the direction order has a
// single source. The host swaps A and B every step (a pull step in place
// would race).
//
// Bound: device-memory bandwidth. Per node and step the pre-pass reads
// K*Q*4 B and writes K*4 B; the step reads K*Q*4 B, writes K*Q*4 B and
// reads K*4 B of density (the neighbours' densities come from cache) and
// the 1-byte mask: 473 B for K = 2 D3Q19, 233 B for K = 2 D2Q9, 709 / 349
// B for K = 3. One
// thread per node, x fastest, so the c_x = 0 loads and every store
// coalesce. The K*Q pulled values stay in registers (no cap in this
// version); the pre-pass is a second full read of the state, which
// fusing it into the step (emit_rho) would save.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SC_MAX_Q 27
#define SC_MAX_K 4
#define SC_BLOCK 128

struct SCParams {
    int nx, ny, nz;
    int potential;                  // 0 linear psi = rho, 1 classic 1 - exp(-rho)
    int c[SC_MAX_Q][3];
    float w[SC_MAX_Q];
    int opp[SC_MAX_Q];
    float tau[SC_MAX_K];
    float tau_inv[SC_MAX_K];
    float g[SC_MAX_K][SC_MAX_K];    // G_jk for j <= k; 0 = no coupling
    float force[SC_MAX_K][3];       // constant acceleration a_k (FORCED)
};

__device__ __forceinline__ float psi(const SCParams& p, float rho) {
    return p.potential == 1 ? 1.0f - expf(-rho) : rho;
}

// Linear index of x + s * c_i (s = -1: pull source, +1: neighbour),
// periodic wrap.
template <int DIM>
__device__ __forceinline__ long long shifted(const SCParams& p, int i, int s,
                                             int x, int y, int z) {
    int xs = x + s * p.c[i][0];
    xs += xs < 0 ? p.nx : 0;
    xs -= xs >= p.nx ? p.nx : 0;
    int ys = y + s * p.c[i][1];
    ys += ys < 0 ? p.ny : 0;
    ys -= ys >= p.ny ? p.ny : 0;
    int zs = 0;
    if (DIM == 3) {
        zs = z + s * p.c[i][2];
        zs += zs < 0 ? p.nz : 0;
        zs -= zs >= p.nz ? p.nz : 0;
    }
    return ((long long)zs * p.ny + ys) * p.nx + xs;
}

template <int DIM, int Q>
__global__ void __launch_bounds__(SC_BLOCK)
rho_poststream_kernel(const float* __restrict__ a, float* __restrict__ rho,
                      int nk, const __grid_constant__ SCParams p) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y;
    const int z = blockIdx.z;
    if (x >= p.nx) return;
    const long long n = (long long)p.nx * p.ny * p.nz;
    const long long node = ((long long)z * p.ny + y) * p.nx + x;
    long long src[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) src[i] = shifted<DIM>(p, i, -1, x, y, z);
    for (int k = 0; k < nk; ++k) {
        const float* ak = a + (long long)k * Q * n;
        float r = 0.0f;
#pragma unroll
        for (int i = 0; i < Q; ++i) r += ak[i * n + src[i]];
        rho[k * n + node] = r;
    }
}

template <int DIM, int Q, int K, bool FORCED>
__global__ void __launch_bounds__(SC_BLOCK)
sc_multi_kernel(const float* __restrict__ a, const float* __restrict__ rho,
                float* __restrict__ b, const uint8_t* __restrict__ mask,
                const __grid_constant__ SCParams p) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y;
    const int z = blockIdx.z;
    if (x >= p.nx) return;
    const long long n = (long long)p.nx * p.ny * p.nz;
    const long long node = ((long long)z * p.ny + y) * p.nx + x;

    float fs[K][Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        const long long s = shifted<DIM>(p, i, -1, x, y, z);
#pragma unroll
        for (int k = 0; k < K; ++k) fs[k][i] = a[((long long)k * Q + i) * n + s];
    }

    const int m = mask[node];
    if (m == 1) {
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < Q; ++i)
                b[((long long)k * Q + p.opp[i]) * n + node] = fs[k][i];
        return;
    }
    if (m != 0) {
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
            for (int i = 0; i < Q; ++i)
                b[((long long)k * Q + i) * n + node] = fs[k][i];
        return;
    }

    // moments of each component and the common velocity
    float r[K], ps[K], num[3] = {0.0f, 0.0f, 0.0f}, den = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float rk = 0.0f;
#pragma unroll
        for (int i = 0; i < Q; ++i) rk += fs[k][i];
        r[k] = rk;
        ps[k] = psi(p, rk);
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
            float mom = 0.0f;
#pragma unroll
            for (int i = 0; i < Q; ++i) mom += p.c[i][d] * fs[k][i];
            num[d] += mom / p.tau[k];
        }
        den += rk / p.tau[k];
    }
    float u[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int d = 0; d < DIM; ++d) u[d] = num[d] / den;

    // neighbour sums S_k = sum_i w_i psi(rho_k(x + c_i)) c_i
    float sn[K][3];
#pragma unroll
    for (int k = 0; k < K; ++k)
        sn[k][0] = sn[k][1] = sn[k][2] = 0.0f;
#pragma unroll
    for (int i = 1; i < Q; ++i) {
        const long long t = shifted<DIM>(p, i, 1, x, y, z);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float pn = psi(p, rho[k * n + t]);
#pragma unroll
            for (int d = 0; d < DIM; ++d)
                if (p.c[i][d] != 0) sn[k][d] += (p.w[i] * p.c[i][d]) * pn;
        }
    }

    // pseudopotential forces, couplings j <= k used symmetrically
    float force[K][3];
#pragma unroll
    for (int k = 0; k < K; ++k)
        force[k][0] = force[k][1] = force[k][2] = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
        for (int k = j; k < K; ++k) {
            const float g = p.g[j][k];
            if (g == 0.0f) continue;
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
                force[j][d] += (-g * ps[j]) * sn[k][d];
                if (j != k) force[k][d] += (-g * ps[k]) * sn[j][d];
            }
        }

    // BGK of each component at its shifted equilibrium velocity (the
    // local force[] is the pseudopotential force, p.force the body force)
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float ue[3] = {0.0f, 0.0f, 0.0f};
        float usq = 0.0f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
            ue[d] = u[d] + p.tau[k] * force[k][d] / r[k];
            if constexpr (FORCED) ue[d] += 0.5f * p.force[k][d];
            usq += ue[d] * ue[d];
        }
        float ua = 0.0f, pref = 0.0f;
        if constexpr (FORCED) {
#pragma unroll
            for (int d = 0; d < DIM; ++d) ua += ue[d] * p.force[k][d];
            pref = (1.0f - 0.5f * p.tau_inv[k]) * r[k];
        }
#pragma unroll
        for (int i = 0; i < Q; ++i) {
            const float cu = p.c[i][0] * ue[0] + p.c[i][1] * ue[1]
                             + p.c[i][2] * ue[2];
            const float poly = 3.0f * cu + 4.5f * cu * cu - 1.5f * usq;
            const float feq = p.w[i] * (r[k] + r[k] * poly);
            float v = fs[k][i] + p.tau_inv[k] * (feq - fs[k][i]);
            if constexpr (FORCED) {
                float ca = 0.0f;
#pragma unroll
                for (int d = 0; d < DIM; ++d) ca += p.c[i][d] * p.force[k][d];
                v += (pref * p.w[i]) * (3.0f * (ca - ua) + 9.0f * cu * ca);
            }
            b[((long long)k * Q + i) * n + node] = v;
        }
    }
}

static dim3 node_grid(const SCParams* p) {
    return dim3((p->nx + SC_BLOCK - 1) / SC_BLOCK, p->ny, p->nz);
}

template <int DIM, int Q>
static int launch_rho(const float* a, float* rho, int nk, const SCParams* p,
                      void* stream) {
    rho_poststream_kernel<DIM, Q><<<node_grid(p), SC_BLOCK, 0,
                                    (cudaStream_t)stream>>>(a, rho, nk, *p);
    return (int)cudaGetLastError();
}

template <int DIM, int Q, int K, bool FORCED>
static int launch_step(const float* a, const float* rho, float* b,
                       const uint8_t* mask, const SCParams* p, void* stream) {
    sc_multi_kernel<DIM, Q, K, FORCED><<<node_grid(p), SC_BLOCK, 0,
                                         (cudaStream_t)stream>>>(
        a, rho, b, mask, *p);
    return (int)cudaGetLastError();
}

// The instantiation for nk components (2 or 3), forced or not.
template <int DIM, int Q>
static int dispatch_step(const float* a, const float* rho, float* b,
                         const uint8_t* mask, int nk, int forced,
                         const SCParams* p, void* stream) {
    if (nk == 2)
        return forced ? launch_step<DIM, Q, 2, true>(a, rho, b, mask, p, stream)
                      : launch_step<DIM, Q, 2, false>(a, rho, b, mask, p, stream);
    if (nk == 3)
        return forced ? launch_step<DIM, Q, 3, true>(a, rho, b, mask, p, stream)
                      : launch_step<DIM, Q, 3, false>(a, rho, b, mask, p, stream);
    return (int)cudaErrorInvalidValue;
}

extern "C" {

int rho_poststream_d2q9(const float* a, float* rho, int nk,
                        const SCParams* p, void* stream) {
    return launch_rho<2, 9>(a, rho, nk, p, stream);
}

int rho_poststream_d3q19(const float* a, float* rho, int nk,
                         const SCParams* p, void* stream) {
    return launch_rho<3, 19>(a, rho, nk, p, stream);
}

// nk = 2 (binary) or 3 (ternary) components; forced != 0: the body
// forces of p->force
int sc_multi_d2q9(const float* a, const float* rho, float* b,
                  const uint8_t* mask, int nk, int forced, const SCParams* p,
                  void* stream) {
    return dispatch_step<2, 9>(a, rho, b, mask, nk, forced, p, stream);
}

int sc_multi_d3q19(const float* a, const float* rho, float* b,
                   const uint8_t* mask, int nk, int forced,
                   const SCParams* p, void* stream) {
    return dispatch_step<3, 19>(a, rho, b, mask, nk, forced, p, stream);
}

int sc_params_size(void) { return (int)sizeof(SCParams); }

}  // extern "C"
