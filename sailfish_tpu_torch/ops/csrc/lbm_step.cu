// Fused pull-stream + collide step for the D2Q9 and D3Q19 BGK lattices,
// hand-written CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels
//   sailfish_tpu/ops/pallas_step.py   make_kernel_3d  (3D, modes has_mask + kbc)
//   sailfish_tpu/ops/pallas_step2d.py make_kernel_2d  (2D, modes has_mask + kbc)
// in the BGK / fp32 / single-device configuration that the lid-driven
// cavity scenes run, in their forcing mode (a constant body force by the Guo,
// exact-difference or velocity-shift model: pallas_step.py:_moments,
// _force_term, _edm_prep, _edm_term) that the force-driven ducts, cylinders
// and pipes run, in their collision-model mode (MRT/TRT with the parity-split
// rates and the conserved-moment correction, BGK at the local Smagorinsky
// LES rate, the incompressible He-Luo equilibrium: pallas_step.py:_feq_i,
// mrt_pair_rates, _collide_prepass, _mrt_corr, _collide_pair), in the
// shallow-water equilibrium (the D2Q9 branch of _feq_i, pallas_step.py
// :289-294), in the single-component Shan-Chen mode (sc:
// _sc_shift_moments :714-785, the 2D kernel's sc argument) and in the mixed
// mode (int16 state, fp32 math: the int16 sdtype of pallas_step.py:961-978
// with dequant_i / quant_i :1574-1768, pallas_step2d.py:128-132 and
// :455-622, and the patch kernels' :2220-2271 / pallas_step2d.py:921-979),
// and with them
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
//   mask 0     collide: fs + (feq(rho, u) - fs) / tau, or the MRT or LES
//              relaxation, with a body force the model's relaxation and
//              post-collision term (relax_node in lbm_common.cuh); in the
//              Shan-Chen mode u is first shifted by tau F / rho, F the
//              pseudopotential force from the post-stream densities of the
//              node's neighbours, which the pre-pass rho_poststream
//              (sc_multi.cu) wrote into rho_pre (sc_collide_node)
//   mask 1     full bounce-back wall: store fs reflected, out_opp(i) = fs_i
//   mask 2     keep (excluded / propagation-only): store fs
//   mask 3+j   row j of the BC table. A native BC instance: macroscopic
//              solve, equilibrium / Zou-He / regularized reconstruction,
//              then BGK with the prescribed rho or u, under the body force
//              as a mask-0 node (the chain of pallas_step.py:_bc_row_values).
//              The prescribed values are the
//              row's scalars, or (rows with vary[j].varies = 1) the node's own
//              entry of the parameter array bcp: per instance [rho, u_x,
//              u_y(, u_z)], component-major over the instance's bounding
//              box, x fastest, so the lanes of a warp along x coalesce.
//              A wall row (the JAX package's link-tagged, TMS and slip
//              families, which on the TPU go through the patch kernels):
//              half-way bounce-back fills the links marked in the node's
//              word of the int32 map tags with A[opp(i), x], then collides;
//              TMS fills them with the target equilibrium and adds
//              feq(target) - feq(rho, u) after the collision; slip stores
//              the streamed values with the normal component reversed
// and writes the result to B. The host swaps A and B every step: the
// Pallas kernels write in place, which is safe only because the TPU grid
// runs in order; concurrent GPU blocks pulling in place would race.
// Time-dependent values (a DynamicValue density or velocity, a time-only
// body force: the rt_force mode of pallas_step.py:185-232) are written by
// the host into LBMParams or into bcp before each launch; the kernel sees
// constants.
//
// State layout, parameter block and the per-node pieces (pull, collide,
// reflect, keep, the native-BC chain) are in lbm_common.cuh, the lattice
// tables in lattice_tables.cuh.
//
// Bound: device-memory bandwidth. Each node reads Q floats, writes Q floats
// and reads a 1-byte mask per step: 2*19*4 + 1 = 153 B for D3Q19, 73 B for
// D2Q9 (half with int16 codes, below), against ~1.1 flop per byte; a node of a varying BC reads 4 * (1 +
// DIM) B more, a half-way or TMS node 4 B of tags and 4 B per tagged link
// (a TMS node reads its Q stores back). One thread per node, x fastest, blocks of 128 nodes of one
// x-row, so the c_x = 0 loads and every store coalesce. A pull step reads
// every value once, so nothing is staged in shared memory. What the design
// does about the bound:
// - Loads in flight. The card needs about 15 KB in flight per SM to cover
//   its memory latency; a thread has 19 loads of 4 B. With runtime lattice
//   tables the D3Q19 kernel took 225 registers, two blocks (eight warps,
//   19 KB) per SM. With the tables compile-time the index arithmetic and
//   the int-to-float conversions fold away, and
//   __launch_bounds__(128, 4) holds D3Q19 to 128 registers: four blocks, 16
//   warps, 38 KB in flight. D2Q9 needs far fewer registers and gets no cap,
//   but for ELBM (below).
// - Addressing. The y and z wraps are computed once per block (they are
//   uniform), the x wrap is a select that only the end lanes of a row take,
//   and each load is a uniform 64-bit base plus a 32-bit in-plane offset
//   (PullSources).
// - Branches. The reflection is a permuted store at compile-time offsets.
//   The BC chain is dispatched once per BC node on its face (axis, sign)
//   into a body templated on them, so the incoming / tangential sets fold
//   and t[opp(i)] is a register: no local memory anywhere. That matters on a
//   face normal to x, where every x-row has one BC node at each end and one
//   warp in four runs the chain with a single active lane: with runtime
//   tables and a local-memory chain such a face cost 2.9 times a step.
//   The read of a varying row's per-node parameters sits in the BC branch,
//   so only those nodes pay for it.
// - The collision model (BGK, MRT, LES) and the equilibrium (compressible,
//   incompressible or, for D2Q9 BGK without EDM, shallow water) are two
//   more template parameters, picked on the host from LBMParams::coll: six
//   instantiations for each force model and wall switch, and the six
//   shallow-water ones, so the BGK kernels carry none of the other models'
//   code. MRT
//   relaxes each pair (i, opp(i)) at compile-time indices; LES sums the
//   non-equilibrium stress over the node's distributions, which are in
//   registers already. The rates, tau and 36 C^2 are in the parameter
//   block: a step of any model moves the same bytes. This file builds the
//   collision model LBM_MODEL (default BGK); lbm_step_mrt.cu,
//   lbm_step_les.cu and lbm_step_elbm.cu define it and include this file,
//   so the 122 fp32 instantiations compile as four libraries (32 each for
//   MRT and LES, 16 for ELBM, 42 with the shallow-water and Shan-Chen ones
//   for BGK), one nvcc each, in parallel (one library of 96 took 154.5 s),
//   and the host loads the library of its model (ops/lbm_step.py
//   LIBRARIES).
// - The force model is a template parameter: four instantiations per lattice,
//   picked on the host from LBMParams::force.model, so the unforced kernel
//   carries no force code and no branch. The force itself (acceleration,
//   velocity shift, Guo prefactor) is in the parameter block: a forced step
//   moves the same bytes as an unforced one.
// - The wall rows are behind a second template parameter, WALLS, picked on
//   the host from the table's kinds: a scene without a wall row runs the
//   instantiation without their code, the same as before they existed. In
//   the wall rows every tag test is a compile-time bit of the tag word and
//   the slip permutation a compile-time index, so nothing leaves registers.
// - The Shan-Chen mode is the last template parameter, SC, reached only
//   through the entries lbm_step_sc_d2q9 / _d3q19: BGK, the compressible
//   equilibrium, no force or a constant Guo force, no BC row (four
//   instantiations). Its density buffer is a kernel argument of its own;
//   the pre-pass reads the state once more (40 / 80 B per node), and a
//   colliding node reads its own and its Q - 1 neighbours' densities, the
//   neighbours' mostly from cache (4 B per node from memory). The
//   potential (linear or classic) is a run-time, block-uniform branch.
//   The Pallas kernel emits next step's densities itself (emit_rho), which
//   relies on the TPU grid running in order; here the pre-pass runs before
//   every step, as the mixtures' does.
// - The storage type T is the last template parameter: float, or int16_t
//   under --precision=mixed (LBMMixed in lbm_common.cuh), whose
//   instantiations are built by lbm_step_mixed.cu, lbm_step_mixed_mrt.cu
//   and lbm_step_mixed_les.cu (LBM_MIXED; 32 each: every force model, wall
//   rows or not, the compressible or the incompressible equilibrium; no
//   shallow water, no Shan-Chen mode, as in JAX) behind the entries
//   lbm_step_mixed_d2q9 / _d3q19 (and lbm_step_mixed_elbm.cu, 16), whose
//   LBMMixed block is a kernel parameter of its own (the fp32 kernels get
//   an empty one). A node then
//   moves 2 * Q * 2 + 1 = 77 B (D3Q19) / 37 B (D2Q9). Each pulled code is
//   dequantized in registers and each stored value quantized (decode / put:
//   the multiply and the add rounded apart, one saturating round-to-even
//   conversion out), at fluid and BC nodes only: reflect, keep and slip
//   nodes store the pulled codes untouched (w_i = w_opp(i), and the slip
//   mirror keeps the weight), as the Pallas kernel selects the raw codes
//   at dry and keep nodes (pallas_step.py:967-968).
// - The entropic collision (ELBM, MODEL_ELBM: pallas_step.py:_collide_elbm
//   :529-555, called at :691-693, :1668-1694, :2172-2174 and
//   pallas_step2d.py:543-565) is a fourth collision model, built by
//   lbm_step_elbm.cu and lbm_step_mixed_elbm.cu (16 instantiations each:
//   every force model, wall rows or not, the compressible equilibrium; the
//   JAX runner keeps the product-form equilibrium off its kernels,
//   sailfish_tpu/runner.py:375-376, and so does this one). One thread per
//   node as before: each solves its own node's alpha (a Newton loop of its
//   own, 20 steps at most, that only Newton nodes enter; dry and keep nodes
//   never do), where the TPU block iterates all its lanes in lockstep until
//   all converged. Only f[Q] stays live: the product-form feq_i is rebuilt
//   from three per-axis factors wherever it is needed (ProductEq in
//   lbm_common.cuh). Its beta and Newton stops are LBMParams::elbm, at the
//   end of the block. A step still moves the BGK bytes, but the node's
//   work, not its bytes, bounds it on int16 state (1.87 times the int16
//   BGK step with two guarded reciprocals per direction): the alpha's
//   first pass takes one reciprocal per direction, without its guard
//   where the node proves it exact (entropic_alpha), and the D2Q9 ELBM
//   instantiations are held to 64 registers, __launch_bounds__(128, 8):
//   eight blocks, 32 warps, where they took 69-90 registers and got five
//   to seven (on the H100: 0.95 of the uncapped int16 step at 4096^2,
//   PERF.md).
// - The D3Q15 and D3Q27 lattices (the JAX kernel is generic over the
//   lattice: make_kernel_3d takes builder.grid) are built by
//   lbm_step_lattices.cu (LBM_LATTICES): BGK with either equilibrium, every
//   force model, wall rows or not, fp32 (16 instantiations per lattice),
//   behind the entries lbm_step_d3q15 / _d3q27, so the D2Q9 and D3Q19
//   libraries build nothing new. A node moves 2 * 15 * 4 + 1 = 121 B and
//   2 * 27 * 4 + 1 = 217 B; the lattice is the pair (DIM, Q) of LatticeOf,
//   and every direction loop is over its compile-time indices as for D3Q19.
// - The outflow family (pallas_step.py make_kernel_3d patch_rows :812,
//   :834-843, with its XLA prologue compute_patch_plane :2306;
//   pallas_step2d.py make_kernel_2d patch_blocks :57, :138) is the last
//   template parameter, OUTFLOW, built by lbm_step_outflow.cu
//   (LBM_OUTFLOW): BGK with either equilibrium, every force model, wall
//   rows on (2 lattices x 4 force models x 2 equilibria = 16
//   instantiations, fp32), behind the entries lbm_step_outflow_d2q9 /
//   _d3q19. On the TPU an XLA prologue recomputes the z-planes (y-blocks)
//   that hold such nodes and the kernel overlays them, because the kernel
//   writes in place and its grid runs in order. Here the source buffer is
//   read-only during a launch, so a node of an outflow row (outflow_face in
//   lbm_common.cuh) reads its neighbours along the normal -- x + n - c_i,
//   x + 2n - c_i, x + c_i, x + 2n -- from it in the same launch as every
//   other node, on a face normal to any axis; the planes, y-blocks and the
//   patch-fraction limit of the JAX routing are tiling artefacts with no
//   counterpart. Each such node reads up to 2 Q values more than a fluid
//   node; the faces are a small share of the nodes. NTLaminarize blends a
//   node towards the mean of its plane, a reduction over other threads'
//   nodes: the pre-pass laminarize_mean_kernel writes the plane means (one
//   block per plane of each laminarize row) before the step, into the
//   buffer the step reads through its aux argument (the Shan-Chen mode's
//   density pointer, which the outflow instantiations do not use).
// Not done: the x-shifted (+-1 element) loads straddle 32-byte sectors, and
// an in-place (AA-pattern) step would halve the footprint.

#include "lbm_common.cuh"

#ifndef LBM_MODEL
#define LBM_MODEL MODEL_BGK
#endif

// aux: the Shan-Chen mode's pre-pass densities (SC), or the laminarize
// pre-pass's plane means (OUTFLOW); null otherwise.
template <int DIM, int Q, int FORCE, bool WALLS, int MODEL, int EQ, bool SC,
          typename T, bool OUTFLOW = false>
__global__ void __launch_bounds__(LBM_BLOCK,
                                  DIM == 3 ? 4 : MODEL == MODEL_ELBM ? 8 : 1)
lbm_step_kernel(const T* __restrict__ a, T* __restrict__ b,
                const uint8_t* __restrict__ mask,
                const __grid_constant__ LBMParams p,
                const float* __restrict__ bcp,
                const int* __restrict__ tags,
                const float* __restrict__ aux,
                const __grid_constant__ typename ScalesOf<T>::type sc) {
    using L = typename LatticeOf<DIM, Q>::type;
    using P = Physics<FORCE, MODEL, EQ>;
    static_assert(L::Q == Q && L::DIM == DIM, "lattice of the dimension");
    const int nx = p.nx, ny = p.ny;
    const int x = blockIdx.x * LBM_BLOCK + threadIdx.x;
    const int y = blockIdx.y;
    const int z = blockIdx.z;
    if (x >= nx) return;
    const int nxy = nx * ny;
    const size_t n = (size_t)nxy * p.nz;

    PullSources s;
    s.xs[0] = x + 1 == nx ? 0 : x + 1;
    s.xs[1] = x;
    s.xs[2] = x == 0 ? nx - 1 : x - 1;
    s.ys[0] = (y + 1 == ny ? 0 : y + 1) * nx;
    s.ys[1] = y * nx;
    s.ys[2] = (y == 0 ? ny - 1 : y - 1) * nx;
    if (DIM == 3) {
        const int nz = p.nz;
        s.zs[0] = (size_t)(z + 1 == nz ? 0 : z + 1) * nxy;
        s.zs[1] = (size_t)z * nxy;
        s.zs[2] = (size_t)(z == 0 ? nz - 1 : z - 1) * nxy;
    } else {
        s.zs[0] = s.zs[1] = s.zs[2] = 0;
    }
    const size_t node = s.zs[1] + (s.ys[1] + x);

    const int m = mask[node];
    T raw[Q];
    pull_node<L>(a, n, s, raw);
    if (m == 0) {
        float fs[Q];
        decode_node<L>(raw, fs, sc);
        if constexpr (SC)
            sc_collide_node<L, P>(fs, p, aux, s, b, n, node);
        else
            collide_node<L, P>(fs, p.tau_inv, p.force, p.coll, p.elbm, b, n,
                               node, sc);
    } else if (m == 1) {
        reflect_node<L>(raw, b, n, node);
    } else if (m == 2) {
        keep_node<L>(raw, b, n, node);
    } else if constexpr (!SC) {
        // (the Shan-Chen mode has no BC row: its entries refuse a table)
        bc_node<L, P, WALLS, OUTFLOW>(p, m - 3, bcp, tags, a, x, y, z, raw,
                                      b, n, node, sc, aux);
    }
}

#define LAM_BLOCK 128

// The mean of one laminarize entry (a plane normal to a laminarize row's
// normal, one per coordinate along it that its nodes span; ops/lbm_step.py
// lists the entries' nodes) over its nodes lo .. hi - 1 of the post-stream
// values fs_i = a[i, x - c_i], sum / max(count, 1), returned to the
// threads i < Q of the block (sailfish_tpu/ops/step.py:543-561, a
// reduction the JAX package leaves to its XLA prologue). node_of(k) names
// node k's buffer and its flat index there, whose extents p gives (a
// LamNode). Each thread sums a strided share of the nodes, then the
// warps' shuffles and shared memory sum the block: the order of the adds
// depends on the node list alone, so a list gathered from the shards of a
// mesh in the unsharded order gives the unsharded bits.
struct LamNode {
    const float* a;
    long long node;
};

template <typename L, typename Node>
__device__ __forceinline__ float laminarize_block_mean(int lo, int hi,
                                                       const LBMParams& p,
                                                       Node node_of) {
    constexpr int Q = L::Q;
    const size_t n = (size_t)p.nx * p.ny * p.nz;
    float s[Q];
    static_for<Q>([&](auto I) { s[decltype(I)::value] = 0.0f; });
    for (int k = lo + (int)threadIdx.x; k < hi; k += LAM_BLOCK) {
        const LamNode at = node_of(k);
        const float* a = at.a;
        const long long node = at.node;
        const int x = (int)(node % p.nx);
        const long long row = node / p.nx;
        const int y = (int)(row % p.ny);
        const int z = (int)(row / p.ny);
        static_for<Q>([&](auto I) {
            constexpr int i = decltype(I)::value;
            s[i] += value_at<L, i, -L::c(i, 0), -L::c(i, 1), -L::c(i, 2)>(
                a, n, p, x, y, z, LBMNoScales());
        });
    }
    __shared__ float part[LAM_BLOCK / 32][Q];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    static_for<Q>([&](auto I) {
        constexpr int i = decltype(I)::value;
        float v = s[i];
        for (int off = 16; off > 0; off /= 2)
            v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) part[warp][i] = v;
    });
    __syncthreads();
    float t = 0.0f;
    if (threadIdx.x < Q) {
        for (int w = 0; w < LAM_BLOCK / 32; ++w) t += part[w][threadIdx.x];
        t = t / fmaxf((float)(hi - lo), 1.0f);
    }
    return t;
}

// The laminarize pre-pass: for each entry e, its nodes start[e] ..
// start[e + 1] - 1 (flat indices into a), the Q means into mean[e * Q + i].
// One block per entry. Bound: the Q loads of each laminarize node and its
// 8-byte index; a laminarize face is a small share of the domain.
template <int DIM, int Q>
__global__ void __launch_bounds__(LAM_BLOCK)
laminarize_mean_kernel(const float* __restrict__ a,
                       const long long* __restrict__ nodes,
                       const int* __restrict__ start,
                       float* __restrict__ mean,
                       const __grid_constant__ LBMParams p) {
    using L = typename LatticeOf<DIM, Q>::type;
    const int e = blockIdx.x;
    const float t = laminarize_block_mean<L>(
        start[e], start[e + 1], p,
        [=](int k) { return LamNode{a, nodes[k]}; });
    if (threadIdx.x < Q) mean[(size_t)e * Q + threadIdx.x] = t;
}

// The laminarize pre-pass over a mesh (parallel/halo.py MeshLaminarize):
// the shards' padded slabs parts[s], each of p's extents; an entry is a
// plane of a laminarize row of the whole domain, its nodes in the
// unsharded order, each coded as s * (nodes of a slab) + its flat index
// in shard s's slab (an interior node: its pulls stay in the slab). One
// block per entry, as laminarize_mean_kernel, so each mean has the
// unsharded bits; the block then writes it to the entries of every shard
// that read this plane: dst[d] for d in dst_start[e] .. dst_start[e + 1]
// - 1 (Q floats each). The slabs and the destinations of shards on other
// GPUs are read and written through peer access.
template <int DIM, int Q>
__global__ void __launch_bounds__(LAM_BLOCK)
laminarize_mean_ghost_kernel(const float* const* __restrict__ parts,
                             const long long* __restrict__ nodes,
                             const int* __restrict__ start,
                             float* const* __restrict__ dst,
                             const int* __restrict__ dst_start,
                             const __grid_constant__ LBMParams p) {
    using L = typename LatticeOf<DIM, Q>::type;
    const int e = blockIdx.x;
    const long long slab = (long long)p.nx * p.ny * p.nz;
    const float t = laminarize_block_mean<L>(
        start[e], start[e + 1], p,
        [=](int k) {
            const long long code = nodes[k];
            return LamNode{parts[code / slab], code % slab};
        });
    if (threadIdx.x < Q)
        for (int d = dst_start[e]; d < dst_start[e + 1]; ++d)
            dst[d][threadIdx.x] = t;
}

__global__ void lbm_empty_kernel() {}

// Whether the table has a wall row (the WALLS instantiation), and whether
// one of them reads the link tags.
static bool has_kind(const LBMParams* p, int lo, int hi) {
    for (int j = 0; j < p->nbc && j < LBM_MAX_BC; ++j)
        if (p->bc[j].kind >= lo && p->bc[j].kind <= hi) return true;
    return false;
}

template <int DIM, int Q, int FORCE, bool WALLS, int MODEL, int EQ,
          bool SC = false, bool OUTFLOW = false, typename T, typename S>
static int launch_kernel(const T* a, T* b, const uint8_t* mask,
                         const float* bcp, const int* tags,
                         const LBMParams* p, const S& sc, void* stream,
                         const float* aux = nullptr) {
    const dim3 grid((p->nx + LBM_BLOCK - 1) / LBM_BLOCK, p->ny, p->nz);
    lbm_step_kernel<DIM, Q, FORCE, WALLS, MODEL, EQ, SC, T, OUTFLOW>
        <<<grid, LBM_BLOCK, 0, (cudaStream_t)stream>>>(a, b, mask, *p, bcp,
                                                       tags, aux, sc);
    return (int)cudaGetLastError();
}

// The instantiation of the block's equilibrium; a block of another
// collision model than this library's is refused, and so are the
// shallow-water equilibrium outside fp32 D2Q9 BGK or under EDM and the
// incompressible one under ELBM.
template <int DIM, int Q, int FORCE, bool WALLS, typename T, typename S>
static int launch_coll(const T* a, T* b, const uint8_t* mask,
                       const float* bcp, const int* tags, const LBMParams* p,
                       const S& sc, void* stream) {
    if (p->coll.model != LBM_MODEL) return (int)cudaErrorInvalidValue;
    switch (p->coll.equilibrium) {
    case EQ_BGK:
        return launch_kernel<DIM, Q, FORCE, WALLS, LBM_MODEL, EQ_BGK>(
            a, b, mask, bcp, tags, p, sc, stream);
    case EQ_INCOMP:
        // the entropic collision is built with the compressible
        // equilibrium only (its BC rows reconstruct with it)
        if constexpr (LBM_MODEL != MODEL_ELBM)
            return launch_kernel<DIM, Q, FORCE, WALLS, LBM_MODEL, EQ_INCOMP>(
                a, b, mask, bcp, tags, p, sc, stream);
        break;
    case EQ_SHALLOW:
        if constexpr (DIM == 2 && LBM_MODEL == MODEL_BGK
                      && FORCE != FORCE_EDM
                      && std::is_same<T, float>::value)
            return launch_kernel<DIM, Q, FORCE, WALLS, LBM_MODEL,
                                 EQ_SHALLOW>(a, b, mask, bcp, tags, p, sc,
                                             stream);
        break;
    }
    return (int)cudaErrorInvalidValue;
}

// The instantiation of the table's wall rows (with or without).
template <int DIM, int Q, int FORCE, typename T, typename S>
static int launch_model(const T* a, T* b, const uint8_t* mask,
                        const float* bcp, const int* tags,
                        const LBMParams* p, const S& sc, void* stream) {
    if (!has_kind(p, BC_HALFBB, BC_SLIP))
        return launch_coll<DIM, Q, FORCE, false>(a, b, mask, bcp, tags, p,
                                                 sc, stream);
    if (tags == nullptr && has_kind(p, BC_HALFBB, BC_TMS))
        return (int)cudaErrorInvalidValue;
    return launch_coll<DIM, Q, FORCE, true>(a, b, mask, bcp, tags, p, sc,
                                            stream);
}

// The instantiation of the block's force model, with the storage T (float,
// or int16_t with its LBMMixed constants sc).
template <int DIM, int Q, typename T, typename S>
static int launch(const T* a, T* b, const uint8_t* mask,
                  const float* bcp, const int* tags, const LBMParams* p,
                  const S& sc, void* stream) {
    switch (p->force.model) {
    case FORCE_NONE:
        return launch_model<DIM, Q, FORCE_NONE>(a, b, mask, bcp, tags, p,
                                                sc, stream);
    case FORCE_GUO:
        return launch_model<DIM, Q, FORCE_GUO>(a, b, mask, bcp, tags, p, sc,
                                               stream);
    case FORCE_EDM:
        return launch_model<DIM, Q, FORCE_EDM>(a, b, mask, bcp, tags, p, sc,
                                               stream);
    case FORCE_VELOCITY_SHIFT:
        return launch_model<DIM, Q, FORCE_VELOCITY_SHIFT>(a, b, mask, bcp,
                                                          tags, p, sc,
                                                          stream);
    }
    return (int)cudaErrorInvalidValue;
}

// The Shan-Chen mode (BGK, compressible, no BC row) of the block's force
// model, none or Guo; built in the BGK library only.
template <int DIM, int Q>
static int launch_sc(const float* a, const float* rho_pre, float* b,
                     const uint8_t* mask, const LBMParams* p, void* stream) {
    if constexpr (LBM_MODEL != MODEL_BGK) {
        return (int)cudaErrorInvalidValue;
    } else {
        if (p->coll.model != MODEL_BGK || p->coll.equilibrium != EQ_BGK
            || p->nbc != 0 || rho_pre == nullptr)
            return (int)cudaErrorInvalidValue;
        if (p->force.model == FORCE_NONE)
            return launch_kernel<DIM, Q, FORCE_NONE, false, MODEL_BGK,
                                 EQ_BGK, true>(a, b, mask, nullptr, nullptr,
                                               p, LBMNoScales(), stream,
                                               rho_pre);
        if (p->force.model == FORCE_GUO)
            return launch_kernel<DIM, Q, FORCE_GUO, false, MODEL_BGK,
                                 EQ_BGK, true>(a, b, mask, nullptr, nullptr,
                                               p, LBMNoScales(), stream,
                                               rho_pre);
        return (int)cudaErrorInvalidValue;
    }
}

// The outflow instantiations (BGK, wall rows on, fp32) of the block's
// equilibrium, compressible or incompressible.
template <int DIM, int Q, int FORCE>
static int launch_outflow_eq(const float* a, float* b, const uint8_t* mask,
                             const float* bcp, const int* tags,
                             const float* lam, const LBMParams* p,
                             void* stream) {
    if (p->coll.equilibrium == EQ_BGK)
        return launch_kernel<DIM, Q, FORCE, true, MODEL_BGK, EQ_BGK, false,
                             true>(a, b, mask, bcp, tags, p, LBMNoScales(),
                                   stream, lam);
    if (p->coll.equilibrium == EQ_INCOMP)
        return launch_kernel<DIM, Q, FORCE, true, MODEL_BGK, EQ_INCOMP,
                             false, true>(a, b, mask, bcp, tags, p,
                                          LBMNoScales(), stream, lam);
    return (int)cudaErrorInvalidValue;
}

// The outflow instantiation of the block's force model; another collision
// model than BGK is refused.
template <int DIM, int Q>
static int launch_outflow(const float* a, float* b, const uint8_t* mask,
                          const float* bcp, const int* tags,
                          const float* lam, const LBMParams* p,
                          void* stream) {
    if (p->coll.model != MODEL_BGK) return (int)cudaErrorInvalidValue;
    switch (p->force.model) {
    case FORCE_NONE:
        return launch_outflow_eq<DIM, Q, FORCE_NONE>(a, b, mask, bcp, tags,
                                                     lam, p, stream);
    case FORCE_GUO:
        return launch_outflow_eq<DIM, Q, FORCE_GUO>(a, b, mask, bcp, tags,
                                                    lam, p, stream);
    case FORCE_EDM:
        return launch_outflow_eq<DIM, Q, FORCE_EDM>(a, b, mask, bcp, tags,
                                                    lam, p, stream);
    case FORCE_VELOCITY_SHIFT:
        return launch_outflow_eq<DIM, Q, FORCE_VELOCITY_SHIFT>(
            a, b, mask, bcp, tags, lam, p, stream);
    }
    return (int)cudaErrorInvalidValue;
}

template <int DIM, int Q>
static int launch_laminarize(const float* a, const long long* nodes,
                             const int* start, int entries, float* mean,
                             const LBMParams* p, void* stream) {
    if (entries <= 0) return (int)cudaErrorInvalidValue;
    laminarize_mean_kernel<DIM, Q>
        <<<entries, LAM_BLOCK, 0, (cudaStream_t)stream>>>(a, nodes, start,
                                                          mean, *p);
    return (int)cudaGetLastError();
}

template <int DIM, int Q>
static int launch_laminarize_ghost(const float* const* parts,
                                   const long long* nodes, const int* start,
                                   int entries, float* const* dst,
                                   const int* dst_start, const LBMParams* p,
                                   void* stream) {
    if (entries <= 0) return (int)cudaErrorInvalidValue;
    laminarize_mean_ghost_kernel<DIM, Q>
        <<<entries, LAM_BLOCK, 0, (cudaStream_t)stream>>>(
            parts, nodes, start, dst, dst_start, *p);
    return (int)cudaGetLastError();
}

template <typename L>
static void copy_tables(LBMTables* out) {
    *out = LBMTables();
    out->q = L::Q;
    out->dim = L::DIM;
    for (int i = 0; i < L::Q; ++i) {
        for (int d = 0; d < 3; ++d) out->c[i][d] = L::c(i, d);
        out->w[i] = L::w(i);
        out->opp[i] = L::opp(i);
        for (int d = 0; d < L::DIM; ++d) out->slip[d][i] = slip_of<L>(i, d);
        for (int k = 0; k <= L::DIM; ++k)
            out->minv[i][k] = mrt_minv_cons<L>(i, k);
        out->logw[i] = L::logw(i);
    }
}

extern "C" {

#if defined(LBM_OUTFLOW)
// The outflow family (lbm_step_outflow.cu): BGK with the compressible or
// the incompressible equilibrium, every force model, wall rows on, fp32;
// the arguments as lbm_step_d3q19, and lam, the plane means that
// laminarize_mean_<grid> wrote (read by laminarize rows only; may be null
// when there is none).
int lbm_step_outflow_d2q9(const float* a, float* b, const uint8_t* mask,
                          const float* bcp, const int* tags,
                          const float* lam, const LBMParams* p,
                          void* stream) {
    return launch_outflow<2, 9>(a, b, mask, bcp, tags, lam, p, stream);
}

int lbm_step_outflow_d3q19(const float* a, float* b, const uint8_t* mask,
                           const float* bcp, const int* tags,
                           const float* lam, const LBMParams* p,
                           void* stream) {
    return launch_outflow<3, 19>(a, b, mask, bcp, tags, lam, p, stream);
}

// The laminarize pre-pass on the state a: nodes, the flat indices of the
// laminarize rows' nodes, entry by entry; start[e] .. start[e + 1] the
// nodes of entry e (entries + 1 ints); mean, entries * Q floats.
int laminarize_mean_d2q9(const float* a, const long long* nodes,
                         const int* start, int entries, float* mean,
                         const LBMParams* p, void* stream) {
    return launch_laminarize<2, 9>(a, nodes, start, entries, mean, p,
                                   stream);
}

int laminarize_mean_d3q19(const float* a, const long long* nodes,
                          const int* start, int entries, float* mean,
                          const LBMParams* p, void* stream) {
    return launch_laminarize<3, 19>(a, nodes, start, entries, mean, p,
                                    stream);
}

// The laminarize pre-pass over a mesh: parts, the shards' slabs (a device
// array of pointers); nodes, coded shard * (slab nodes) + flat index,
// entry by entry; start[e] .. start[e + 1] the nodes of entry e; dst, the
// device array of the destinations' addresses (Q floats each: a shard's
// entry of the plane), dst_start[e] .. dst_start[e + 1] entry e's; p holds
// a slab's extents. Launched on the device that holds the arrays.
int laminarize_mean_ghost_d2q9(const float* const* parts,
                               const long long* nodes, const int* start,
                               int entries, float* const* dst,
                               const int* dst_start, const LBMParams* p,
                               void* stream) {
    return launch_laminarize_ghost<2, 9>(parts, nodes, start, entries, dst,
                                         dst_start, p, stream);
}

int laminarize_mean_ghost_d3q19(const float* const* parts,
                                const long long* nodes, const int* start,
                                int entries, float* const* dst,
                                const int* dst_start, const LBMParams* p,
                                void* stream) {
    return launch_laminarize_ghost<3, 19>(parts, nodes, start, entries,
                                          dst, dst_start, p, stream);
}
#elif defined(LBM_LATTICES)
// The D3Q15 and D3Q27 lattices (lbm_step_lattices.cu): BGK with the
// compressible or the incompressible equilibrium, every force model, wall
// rows or not, fp32; the arguments as lbm_step_d3q19.
int lbm_step_d3q15(const float* a, float* b, const uint8_t* mask,
                   const float* bcp, const int* tags, const LBMParams* p,
                   void* stream) {
    return launch<3, 15>(a, b, mask, bcp, tags, p, LBMNoScales(), stream);
}

int lbm_step_d3q27(const float* a, float* b, const uint8_t* mask,
                   const float* bcp, const int* tags, const LBMParams* p,
                   void* stream) {
    return launch<3, 27>(a, b, mask, bcp, tags, p, LBMNoScales(), stream);
}
#elif !defined(LBM_MIXED)
// bcp: the per-node parameter array (never read when no row varies);
// tags: the int32 link-tag map, one word per node (read only by the nodes of
// half-way and TMS rows; may be null when there is none).
int lbm_step_d2q9(const float* a, float* b, const uint8_t* mask,
                  const float* bcp, const int* tags, const LBMParams* p,
                  void* stream) {
    return launch<2, 9>(a, b, mask, bcp, tags, p, LBMNoScales(), stream);
}

int lbm_step_d3q19(const float* a, float* b, const uint8_t* mask,
                   const float* bcp, const int* tags, const LBMParams* p,
                   void* stream) {
    return launch<3, 19>(a, b, mask, bcp, tags, p, LBMNoScales(), stream);
}

// The Shan-Chen mode: rho_pre holds the post-stream density of every node
// (the pre-pass rho_poststream of sc_multi.cu, run on a just before).
int lbm_step_sc_d2q9(const float* a, const float* rho_pre, float* b,
                     const uint8_t* mask, const LBMParams* p, void* stream) {
    return launch_sc<2, 9>(a, rho_pre, b, mask, p, stream);
}

int lbm_step_sc_d3q19(const float* a, const float* rho_pre, float* b,
                      const uint8_t* mask, const LBMParams* p,
                      void* stream) {
    return launch_sc<3, 19>(a, rho_pre, b, mask, p, stream);
}
#else
// --precision=mixed: a and b hold int16 codes, mx the constants of their
// grid; the rest as lbm_step_<grid> (every force model, wall rows or not,
// the compressible or the incompressible equilibrium of this library's
// collision model; no shallow water, no Shan-Chen mode).
int lbm_step_mixed_d2q9(const int16_t* a, int16_t* b, const uint8_t* mask,
                        const float* bcp, const int* tags, const LBMParams* p,
                        const LBMMixed* mx, void* stream) {
    return launch<2, 9>(a, b, mask, bcp, tags, p, *mx, stream);
}

int lbm_step_mixed_d3q19(const int16_t* a, int16_t* b, const uint8_t* mask,
                         const float* bcp, const int* tags,
                         const LBMParams* p, const LBMMixed* mx,
                         void* stream) {
    return launch<3, 19>(a, b, mask, bcp, tags, p, *mx, stream);
}
#endif

// Where the ELBM instantiations of this library write each colliding
// node's alpha and branch (lbm_elbm_diag in lbm_common.cuh): out, a (2, n)
// fp32 buffer, or null for none; set on the stream before the launches it
// is for. The other instantiations never read it.
int lbm_elbm_diagnostics(float* out, void* stream) {
    return (int)cudaMemcpyToSymbolAsync(lbm_elbm_diag, &out, sizeof(out), 0,
                                        cudaMemcpyHostToDevice,
                                        (cudaStream_t)stream);
}

int lbm_mixed_size(void) { return (int)sizeof(LBMMixed); }

int lbm_params_size(void) { return (int)sizeof(LBMParams); }

int lbm_tables_size(void) { return (int)sizeof(LBMTables); }

// The compile-time tables of the lattice DdimQq, for the check at load;
// entries beyond Q are 0. Returns 0, or 1 for a lattice without tables.
int lbm_lattice_tables(int dim, int q, LBMTables* out) {
    if (dim == 2 && q == 9) copy_tables<D2Q9>(out);
    else if (dim == 3 && q == 15) copy_tables<D3Q15>(out);
    else if (dim == 3 && q == 19) copy_tables<D3Q19>(out);
    else if (dim == 3 && q == 27) copy_tables<D3Q27>(out);
    else return 1;
    return 0;
}

// One empty block: the per-launch floor a measurement reads bounds against.
int lbm_empty_launch(void* stream) {
    lbm_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

}  // extern "C"
