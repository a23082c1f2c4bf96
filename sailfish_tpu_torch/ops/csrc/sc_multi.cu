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
// The step, for every node x:
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
// sailfish_tpu_torch.lattice; densities (K, nz, ny, nx). Relaxation times,
// couplings and accelerations arrive by value in SCParams, and so do the
// lattice tables, filled from the Python lattice, for the D2Q9 kernels and
// the pre-pass. The host swaps A and B every step (a pull step in place
// would race).
//
// Bound: device-memory bandwidth. Per node and step the pre-pass reads
// K*Q*4 B and writes K*4 B; the step reads K*Q*4 B, writes K*Q*4 B and
// reads K*4 B of density (the neighbours' densities come from cache or
// shared memory) and the 1-byte mask: 473 B for K = 2 D3Q19, 233 B for
// K = 2 D2Q9, 709 / 349 B for K = 3. The pre-pass is a second full read of
// the state, which fusing it into the step (emit_rho) would save.
//
// sc_multi_kernel<2, 9, K, FORCED> (B7) and rho_poststream<DIM, Q> (B5,
// B6): one thread per node, x fastest, blocks of 128 nodes of one x-row,
// so the c_x = 0 loads and every store coalesce; the lattice tables from
// SCParams; the K*Q pulled values in registers.
//
// sc3_kernel<K, FORCED> (B9), the D3Q19 step. Its byte bound is 313 B per
// node at K = 2 and 469 B at K = 3 (the step alone): at 3.35 TB/s over 132
// SMs a warp of 32 nodes has 394 / 591 ns, about 2,760 / 4,140 warp
// instructions per thread at ~1.75 GHz and 4 issue slots per SM. The
// one-row design took 4,264 / 5,682 SASS instructions per node (6,208
// forced at K = 3), 128-142 registers and a 24 B spill (PERF.md), as the
// one-row B10 had before its redesign. So the design cuts instructions:
// - A block is a tx x ty tile of threads in (x, y) that marches over kz
//   z-planes; the Python wrapper computes tx, ty, kz, the grid and the
//   shared bytes (SCTile) and this file checks them. Uneven edges are
//   masked: the domain need not be a multiple of the tile.
// - psi is staged once per node: per component a ring of four density
//   planes of (ty + 2) x (tx + 2) (halo 1) in shared memory holds planes
//   z - 1, z and z + 1 while the next plane is copied in with cp.async.
//   Each thread applies psi in place to the entries it copied (K expf per
//   node under the classic potential, not 18 K), and S_k reads the ring
//   with the compile-time weights. The periodic wrap is in each thread's
//   source address, as in fe3_kernel (fe_step.cu: TMA cannot wrap a box
//   around the domain edge).
// - The D3Q19 tables are compile-time (struct D3Q19, lattice_tables.cuh):
//   the moments, c_i . u, c_i . a_k and S_k fold into +- adds, zero
//   components vanish and opp(i) is a fixed offset. sc_d3q19_tables copies
//   them out; ops/sc_multi.py checks them against sailfish_tpu_torch.lattice
//   when the library loads.
// - Addresses are 32-bit offsets: the wrapped x +- 1 and y +- 1 once per
//   block, three plane offsets per z-plane, added to the uniform base
//   a + (k Q + i) n of each (component, direction); the wrapper refuses a
//   domain of 2^31 nodes or more.
// - The node's own rho_k is sum_i fs_k,i in direction order: the pre-pass's
//   sum of the same values, so psi(rho_k) at the node is the ring's centre.
// - The relaxation is formed once per component: w_i (1/tau) rho and w_i
//   (1/tau) rho (1 - 1.5 u^2) per weight class, so each direction costs
//   c_i . u_k, two FFMA, a multiply and the final FFMA; with FORCED the
//   Guo prefactor 3 (1 - 1/(2 tau_k)) rho_k w_i and u_k . a_k are formed
//   once per component too, and each direction adds three FFMA.
// - Registers: __launch_bounds__(256, 2), at most 128 registers, so no
//   instantiation keeps fewer than 16 warps resident on an SM. The K Q
//   pulled values stay in registers until the stores, with no stack frame.
//   The other design, each component pulled a second time for its
//   relaxation, spilled 8-16 B at K = 3 and ran 0.2-0.6 % slower on the
//   shipped tile on an H100 (80GB HBM3, 700 W; tools/sc_tile_sweep.py
//   --variants repull, PERF.md).
// - The per-(k, i) bases are formed inside the z loop from an opaque copy
//   of n: hoisted out of it, 2 K Q 64-bit bases held every register and
//   spilled 32-72 B.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lattice_tables.cuh"

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

// ---------------------------------------------------------------------------
// D3Q19: the z-marching tile (B9)

#define SC3_THREADS 256     // most threads of a block (tx * ty)
#define SC3_MAX_FILL 4      // most staged-plane entries per thread

// Launch geometry of sc3_kernel, computed by the Python wrapper.
struct SCTile {
    int tx, ty, kz;     // block of tx x ty threads over (x, y); kz z-planes
    int grid[3];        // blocks along x, y, z
    int smem_bytes;     // dynamic shared memory of a block
};

// The tables as sc_d3q19_tables copies them out (mirrored in
// ops/sc_multi.py _Tables).
struct SCTables {
    int c[19][3];
    int opp[19];
    float w[19];
};

__host__ __device__ __forceinline__ int pos_mod(int v, int n) {
    const int m = v % n;
    return m < 0 ? m + n : m;
}

// v, with the compiler told that it may have changed: what is formed from
// it inside the z loop stays there instead of being hoisted out and held
// in registers across the loop (the staging addresses of each (component,
// entry), the bases of each (component, direction)).
__device__ __forceinline__ int opaque(int v) {
    asm volatile("" : "+r"(v));
    return v;
}

// Shared bytes of a block: per component four density planes of
// (ty + 2) x (tx + 2) floats.
__host__ __device__ __forceinline__ int sc3_smem_bytes(int tx, int ty,
                                                       int nk) {
    return 4 * 4 * nk * (tx + 2) * (ty + 2);
}

// One step of the node whose wrapped source columns are xs, rows (times
// nx) ys and planes (times nx * ny) zs, indexed by c + 1 of the pull
// x - c; st[dz + 1] points at the node in component 0's psi plane z + dz,
// whose rows are pw floats apart; component k's planes are k * kst floats
// further.
template <int K, bool FORCED>
__device__ __forceinline__ void sc3_node(
    const float* __restrict__ a, float* __restrict__ b,
    const uint8_t* __restrict__ mask, const SCParams& p, int n,
    const int (&xs)[3], const int (&ys)[3], const int (&zs)[3],
    const float* const (&st)[3], int pw, int kst) {
    using L = D3Q19;
    constexpr int Q = L::Q;
    static_assert(L::n2(1) == 1 && L::n2(Q - 1) == 2,
                  "direction 1 on an axis, direction Q - 1 diagonal");
    const int node = zs[1] + ys[1] + xs[1];
    // the base of (component k, direction i) is a + (k Q + i) n: formed at
    // each use from nn, which the compiler takes to change every plane, so
    // that it holds none of the 2 K Q 64-bit bases across the z loop
    const unsigned nn = (unsigned)opaque(n);
    float* const b_node = b + node;
    auto pull = [&](auto KI, auto I) {
        constexpr int k = decltype(KI)::value, i = decltype(I)::value;
        const float* base = a + (size_t)(k * Q + i) * nn;
        return base[(unsigned)(zs[1 + L::c(i, 2)] + ys[1 + L::c(i, 1)]
                               + xs[1 + L::c(i, 0)])];
    };
    auto out = [&](auto KI, int i) -> float& {
        constexpr int k = decltype(KI)::value;
        return b_node[(size_t)(k * Q + i) * nn];
    };
    // S_k from the psi ring, before any value is pulled (no pulled value
    // is live meanwhile): the axis neighbours (w = 1/18) and the diagonal
    // ones (w = 1/36) summed apart; psi_k at the node itself
    float sx[K], sy[K], sz[K], ps[K];
    static_for<K>([&](auto KI) {
        constexpr int k = decltype(KI)::value;
        float g1[3] = {-0.0f, -0.0f, -0.0f}, g2[3] = {-0.0f, -0.0f, -0.0f};
        static_for<Q>([&](auto I) {
            constexpr int i = decltype(I)::value;
            if constexpr (i > 0) {
                constexpr int cx = L::c(i, 0), cy = L::c(i, 1),
                              cz = L::c(i, 2);
                const float* row = st[cz + 1] + k * kst;
                if constexpr (cy > 0) row += pw;
                if constexpr (cy < 0) row -= pw;
                const float pn = row[cx];
                auto add = [&](float* g) {
                    if constexpr (cx > 0) g[0] += pn;
                    if constexpr (cx < 0) g[0] -= pn;
                    if constexpr (cy > 0) g[1] += pn;
                    if constexpr (cy < 0) g[1] -= pn;
                    if constexpr (cz > 0) g[2] += pn;
                    if constexpr (cz < 0) g[2] -= pn;
                };
                if constexpr (L::n2(i) == 1)
                    add(g1);
                else
                    add(g2);
            }
        });
        sx[k] = g1[0] * L::w(1) + g2[0] * L::w(Q - 1);
        sy[k] = g1[1] * L::w(1) + g2[1] * L::w(Q - 1);
        sz[k] = g1[2] * L::w(1) + g2[2] * L::w(Q - 1);
        ps[k] = st[1][k * kst];
    });

    // pseudopotential forces, couplings j <= k used symmetrically
    float fx[K], fy[K], fz[K];
#pragma unroll
    for (int k = 0; k < K; ++k) fx[k] = fy[k] = fz[k] = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
        for (int k = j; k < K; ++k) {
            const float g = p.g[j][k];
            if (g == 0.0f) continue;
            fx[j] += (-g * ps[j]) * sx[k];
            fy[j] += (-g * ps[j]) * sy[k];
            fz[j] += (-g * ps[j]) * sz[k];
            if (j != k) {
                fx[k] += (-g * ps[k]) * sx[j];
                fy[k] += (-g * ps[k]) * sy[j];
                fz[k] += (-g * ps[k]) * sz[j];
            }
        }

    // the pulled values, held until the stores
    float f[K][Q];
    static_for<K>([&](auto KI) {
        static_for<Q>([&](auto I) {
            f[decltype(KI)::value][decltype(I)::value] = pull(KI, I);
        });
    });
    auto val = [&](auto KI, auto I) {
        return f[decltype(KI)::value][decltype(I)::value];
    };

    const int m = mask[node];
    if (m == 1) {
        static_for<K>([&](auto KI) {
            static_for<Q>([&](auto I) {
                out(KI, L::opp(decltype(I)::value)) = val(KI, I);
            });
        });
        return;
    }
    if (m != 0) {
        static_for<K>([&](auto KI) {
            static_for<Q>([&](auto I) {
                out(KI, decltype(I)::value) = val(KI, I);
            });
        });
        return;
    }

    // moments of each component (rho_k summed in direction order, as the
    // pre-pass sums) and the common velocity
    float rho[K], jx[K], jy[K], jz[K];
    static_for<K>([&](auto KI) {
        constexpr int k = decltype(KI)::value;
        float r = 0.0f, mx = -0.0f, my = -0.0f, mz = -0.0f;
        static_for<Q>([&](auto I) {
            constexpr int i = decltype(I)::value;
            const float v = val(KI, I);
            r += v;
            if constexpr (L::c(i, 0) > 0) mx += v;
            if constexpr (L::c(i, 0) < 0) mx -= v;
            if constexpr (L::c(i, 1) > 0) my += v;
            if constexpr (L::c(i, 1) < 0) my -= v;
            if constexpr (L::c(i, 2) > 0) mz += v;
            if constexpr (L::c(i, 2) < 0) mz -= v;
        });
        rho[k] = r;
        jx[k] = mx;
        jy[k] = my;
        jz[k] = mz;
    });
    float nux = -0.0f, nuy = -0.0f, nuz = -0.0f, den = -0.0f;
    static_for<K>([&](auto KI) {
        constexpr int k = decltype(KI)::value;
        const float ti = p.tau_inv[k];
        nux += jx[k] * ti;
        nuy += jy[k] * ti;
        nuz += jz[k] * ti;
        den += rho[k] * ti;
    });
    const float inv_den = 1.0f / den;
    const float ux = nux * inv_den, uy = nuy * inv_den, uz = nuz * inv_den;

    // BGK of each component at its shifted equilibrium velocity:
    // B_i = (1 - 1/tau) fs_i + (1/tau) feq_i, (1/tau) feq_i =
    // w_i (1/tau) rho cu (3 + 4.5 cu) + w_i (1/tau) rho (1 - 1.5 u^2),
    // the two factors per weight class (n2 = 0, 1, 2) formed once
    static_for<K>([&](auto KI) {
        constexpr int k = decltype(KI)::value;
        const float r = rho[k];
        const float tr = p.tau[k] / r;
        float ex = ux + tr * fx[k], ey = uy + tr * fy[k],
              ez = uz + tr * fz[k];
        float ax = 0.0f, ay = 0.0f, az = 0.0f;
        if constexpr (FORCED) {
            ax = p.force[k][0];
            ay = p.force[k][1];
            az = p.force[k][2];
            ex += 0.5f * ax;
            ey += 0.5f * ay;
            ez += 0.5f * az;
        }
        const float usq = ex * ex + ey * ey + ez * ez;
        const float ti = p.tau_inv[k];
        const float omt = 1.0f - ti;
        const float tir = ti * r;
        const float tib = tir - 1.5f * tir * usq;
        float wr[3], wb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float w = L::w(c == 0 ? 0 : c == 1 ? 1 : Q - 1);
            wr[c] = w * tir;
            wb[c] = w * tib;
        }
        // Guo: (1 - 1/(2 tau)) rho w_i (3 (ca - ua) + 9 cu ca)
        //    = gp_i (ca (1 + 3 cu) - ua), gp_i = 3 (1 - 1/(2 tau)) rho w_i
        float ua = 0.0f, gp[3] = {0.0f, 0.0f, 0.0f};
        if constexpr (FORCED) {
            ua = ex * ax + ey * ay + ez * az;
            const float pref = 3.0f * (1.0f - 0.5f * ti) * r;
#pragma unroll
            for (int c = 0; c < 3; ++c)
                gp[c] = pref * L::w(c == 0 ? 0 : c == 1 ? 1 : Q - 1);
        }
        static_for<Q>([&](auto I) {
            constexpr int i = decltype(I)::value;
            constexpr int wc = L::n2(i);
            const float cu = cdot<L, i>(ex, ey, ez);
            const float tfeq = wr[wc] * (cu * (3.0f + 4.5f * cu)) + wb[wc];
            float v = omt * val(KI, I) + tfeq;
            if constexpr (FORCED) {
                const float ca = cdot<L, i>(ax, ay, az);
                v += gp[wc] * (ca * (1.0f + 3.0f * cu) - ua);
            }
            out(KI, i) = v;
        });
    });
}

template <int K, bool FORCED>
__global__ void __launch_bounds__(SC3_THREADS, 2)
sc3_kernel(const float* __restrict__ a, const float* __restrict__ rho,
           float* __restrict__ b, const uint8_t* __restrict__ mask,
           const __grid_constant__ SCParams p, const SCTile t) {
    extern __shared__ __align__(16) float sc_smem[];
    const int nx = p.nx, ny = p.ny, nz = p.nz;
    const int nxy = nx * ny, n = nxy * nz;  // n < 2^31: the wrapper checks
    const int nthr = t.tx * t.ty;
    const int tid = threadIdx.y * t.tx + threadIdx.x;
    const int x0 = blockIdx.x * t.tx, y0 = blockIdx.y * t.ty;
    const int z0 = blockIdx.z * t.kz;
    const int z1 = min(z0 + t.kz, nz);
    const int pw = t.tx + 2, plane = pw * (t.ty + 2), kst = 4 * plane;
    // the ring slot of density plane zz >= z0 - 1 (component 0)
    auto slot = [&](int zz) { return sc_smem + ((zz - z0 + 1) & 3) * plane; };

    // this thread's entries of a staged plane: entry e = tid + j * nthr at
    // (e / pw, e % pw), the in-plane offset of its wrapped node
    int fill[SC3_MAX_FILL];
#pragma unroll
    for (int j = 0; j < SC3_MAX_FILL; ++j) {
        const int e = tid + j * nthr;
        const int ly = e / pw, lx = e - ly * pw;
        fill[j] = pos_mod(y0 + ly - 1, ny) * nx + pos_mod(x0 + lx - 1, nx);
    }
    auto stage = [&](int zz) {     // density plane zz of every component
        const float* src = rho + pos_mod(zz, nz) * nxy;
        float* dst = slot(zz);
#pragma unroll
        for (int j = 0; j < SC3_MAX_FILL; ++j) {
            const int e = opaque(tid + j * nthr);
            if (e < plane) {
                const int f = opaque(fill[j]);
#pragma unroll
                for (int k = 0; k < K; ++k)
                    __pipeline_memcpy_async(dst + k * kst + e,
                                            src + (size_t)k * n + f, 4);
            }
        }
        __pipeline_commit();
    };
    // psi in place on this thread's own (already arrived) entries of zz
    auto to_psi = [&](int zz) {
        if (p.potential != 1) return;
        float* dst = slot(zz);
#pragma unroll
        for (int j = 0; j < SC3_MAX_FILL; ++j) {
            const int e = opaque(tid + j * nthr);
            if (e < plane) {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    float* v = dst + k * kst + e;
                    *v = 1.0f - expf(-*v);
                }
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
    const int sc = (threadIdx.y + 1) * pw + threadIdx.x + 1;

    // prologue: the stencil planes z0 - 1, z0, z0 + 1
    stage(z0 - 1);
    stage(z0);
    stage(z0 + 1);
    __pipeline_wait_prior(0);
    to_psi(z0 - 1);
    to_psi(z0);
    to_psi(z0 + 1);
    __syncthreads();

    for (int z = z0; z < z1; ++z) {
        const bool more = z + 1 < z1;
        if (more) stage(z + 2);  // the next plane's copy, behind this work
        if (active) {
            const int zs[3] = {(z + 1 < nz ? z + 1 : 0) * nxy, z * nxy,
                               (z > 0 ? z - 1 : nz - 1) * nxy};
            const float* const st[3] = {slot(z - 1) + sc, slot(z) + sc,
                                        slot(z + 1) + sc};
            sc3_node<K, FORCED>(a, b, mask, p, n, xs, ys, zs, st, pw, kst);
        }
        if (more) {
            __pipeline_wait_prior(0);
            to_psi(z + 2);
            __syncthreads();
        }
    }
}

// ---------------------------------------------------------------------------
// launches

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

template <int K, bool FORCED>
static void launch_step2(const float* a, const float* rho, float* b,
                         const uint8_t* mask, const SCParams* p,
                         cudaStream_t s) {
    sc_multi_kernel<2, 9, K, FORCED><<<node_grid(p), SC_BLOCK, 0, s>>>(
        a, rho, b, mask, *p);
}

template <int K, bool FORCED>
static void launch_step3(const float* a, const float* rho, float* b,
                         const uint8_t* mask, const SCParams* p,
                         const SCTile* t, cudaStream_t s) {
    const dim3 grid(t->grid[0], t->grid[1], t->grid[2]), block(t->tx, t->ty);
    sc3_kernel<K, FORCED><<<grid, block, t->smem_bytes, s>>>(a, rho, b,
                                                            mask, *p, *t);
}

// The D2Q9 instantiation for nk components (2 or 3), forced or not.
static int dispatch_step2(const float* a, const float* rho, float* b,
                          const uint8_t* mask, int nk, int forced,
                          const SCParams* p, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (nk == 2)
        (forced ? launch_step2<2, true> : launch_step2<2, false>)(
            a, rho, b, mask, p, s);
    else if (nk == 3)
        (forced ? launch_step2<3, true> : launch_step2<3, false>)(
            a, rho, b, mask, p, s);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// sc3_kernel after checking the wrapper's geometry against what the kernel
// assumes: a block of at most SC3_THREADS threads, at most SC3_MAX_FILL
// staged entries per thread, a grid that covers the domain, the shared
// bytes of sc3_smem_bytes and fewer than 2^31 nodes.
static int dispatch_step3(const float* a, const float* rho, float* b,
                          const uint8_t* mask, int nk, int forced,
                          const SCParams* p, const SCTile* t, void* stream) {
    const int nthr = t->tx * t->ty;
    const int plane = (t->tx + 2) * (t->ty + 2);
    if ((nk != 2 && nk != 3) || t->tx < 1 || t->ty < 1 || t->kz < 1
        || nthr > SC3_THREADS
        || (plane + nthr - 1) / nthr > SC3_MAX_FILL
        || (long long)t->grid[0] * t->tx < p->nx
        || (long long)t->grid[1] * t->ty < p->ny
        || (long long)t->grid[2] * t->kz < p->nz
        || t->smem_bytes < sc3_smem_bytes(t->tx, t->ty, nk)
        || (long long)p->nx * p->ny * p->nz >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (nk == 2)
        (forced ? launch_step3<2, true> : launch_step3<2, false>)(
            a, rho, b, mask, p, t, s);
    else
        (forced ? launch_step3<3, true> : launch_step3<3, false>)(
            a, rho, b, mask, p, t, s);
    return (int)cudaGetLastError();
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
    return dispatch_step2(a, rho, b, mask, nk, forced, p, stream);
}

int sc_multi_d3q19(const float* a, const float* rho, float* b,
                   const uint8_t* mask, int nk, int forced,
                   const SCParams* p, const SCTile* t, void* stream) {
    return dispatch_step3(a, rho, b, mask, nk, forced, p, t, stream);
}

int sc_params_size(void) { return (int)sizeof(SCParams); }

int sc_tables_size(void) { return (int)sizeof(SCTables); }

// The compile-time D3Q19 tables of sc3_kernel, for the check at load.
void sc_d3q19_tables(SCTables* out) {
    using L = D3Q19;
    for (int i = 0; i < L::Q; ++i) {
        for (int d = 0; d < 3; ++d) out->c[i][d] = L::c(i, d);
        out->opp[i] = L::opp(i);
        out->w[i] = L::w(i);
    }
}

}  // extern "C"
