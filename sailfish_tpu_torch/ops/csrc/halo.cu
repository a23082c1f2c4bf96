// The ghost-plane exchanges of a sharded step (sailfish_tpu_torch/parallel/
// halo.py, halo_multi.py), for shards on one device or on several.
//
// Each shard holds its slab of the state as (K, Q, L + 2G, plane) with G
// ghost planes on each side along the sharded axis (z in 3D, y in 2D; K
// components, G = 1, or 2 for the free-energy model with wetting). After a
// step, ghost plane G - 1 of shard s takes the last interior plane L + G - 1
// of shard s - 1 and ghost plane L + G the first interior plane G of shard
// s + 1 (the ring wraps, as the global domain's periodic streaming does),
// but only in the directions that the next pull step reads from it: those
// with c = +1 along the axis for the low plane (`lo`), c = -1 for the high
// one (`hi`), in every component.
//
// The density exchange is the same copy on a post-stream density buffer
// (K, L + 2G, plane): one "direction" (lo = hi = {0}) and `depth` = G whole
// planes per side, planes 0 ... G - 1 from the last G interior planes of
// shard s - 1 and planes L + G ... L + 2G - 1 from the first G of shard
// s + 1: the densities that the Shan-Chen force (psi one plane out) and the
// free-energy stencil (phi one plane out, two with the wetting mirror) read
// on the ghost planes, which the shard's own pre-pass cannot compute.
//
// Ghost planes are written, interior planes read, so the copies of one
// launch never overlap. One launch fills the ghost planes of the shards
// listed in `dst` (those on the launching device): blockIdx.y picks the
// (shard, component, side and direction, depth) plane, x runs over its copy
// units. A source plane on another device is read through peer access
// (`halo_enable_peer`); the caller orders the launch after the launches
// that wrote its sources, on every device.
//
// The counterpart of the two jax.lax.ppermute calls of
// sailfish_tpu/parallel/halo.py:361-362 that feed make_kernel_3d's ghost
// inputs (sailfish_tpu/ops/pallas_step.py:828-834; make_kernel_2d's ghost
// rows, pallas_step2d.py:36), of the mixtures' face ppermutes
// (sailfish_tpu/parallel/halo_multi.py), and of the density edges those
// re-stream (stream_rho_edges, sailfish_tpu/parallel/halo.py:51-107; the
// rglo / rghi ppermutes, :476-477; the free-energy phi planes,
// halo_multi.py:617-625).

#include <cuda_runtime.h>
#include <stdint.h>

#define HALO_MAX_SHARDS 16
#define HALO_MAX_DIRS 9

struct HaloParams {
    // the shards' state buffers, in ring order
    unsigned long long part[HALO_MAX_SHARDS];
    int n_shards;
    // planes per direction in a buffer: L + 2
    int planes;
    // copy units per plane, and the bytes of one unit (16, 4 or 2)
    int units;
    int unit_bytes;
    // the directions copied into ghost plane 0 (lo) and plane L + 1 (hi)
    int n_lo;
    int n_hi;
    int lo[HALO_MAX_DIRS];
    int hi[HALO_MAX_DIRS];
    // the shards whose ghost planes this launch fills
    int n_dst;
    int dst[HALO_MAX_SHARDS];
    // ghost planes per side (G), planes copied per side and direction, and
    // the components of a buffer, `comp_units` copy units apart
    int ghost;
    int depth;
    int n_comp;
    long long comp_units;
};

template <typename U>
__global__ void halo_exchange_kernel(const HaloParams p) {
    const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (u >= p.units) {
        return;
    }
    const int nd = p.n_lo + p.n_hi;
    int y = blockIdx.y;
    const int d = y % p.depth;
    y /= p.depth;
    const int k = y % nd;
    y /= nd;
    const int c = y % p.n_comp;
    const int s = p.dst[y / p.n_comp];
    const int length = p.planes - 2 * p.ghost;
    int dir, src_shard, src_plane, dst_plane;
    if (k < p.n_lo) {
        dir = p.lo[k];
        src_shard = (s + p.n_shards - 1) % p.n_shards;
        src_plane = length + p.ghost - p.depth + d;
        dst_plane = p.ghost - p.depth + d;
    } else {
        dir = p.hi[k - p.n_lo];
        src_shard = (s + 1) % p.n_shards;
        src_plane = p.ghost + d;
        dst_plane = length + p.ghost + d;
    }
    const long long base = c * p.comp_units;
    const U* src = reinterpret_cast<const U*>(p.part[src_shard]) + base
        + ((long long)dir * p.planes + src_plane) * p.units;
    U* dst = reinterpret_cast<U*>(p.part[s]) + base
        + ((long long)dir * p.planes + dst_plane) * p.units;
    dst[u] = src[u];
}

extern "C" int halo_params_size() { return (int)sizeof(HaloParams); }

// Let `device` read the memory of `peer`: 0 when it can (already enabled
// included), -3 when the pair has no peer access, else the CUDA error.
extern "C" int halo_enable_peer(int device, int peer) {
    int can = 0;
    cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
    if (err != cudaSuccess) {
        return (int)err;
    }
    if (!can) {
        return -3;
    }
    int prev = 0;
    cudaGetDevice(&prev);
    cudaSetDevice(device);
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
        err = cudaSuccess;
    }
    cudaSetDevice(prev);
    return (int)err;
}

extern "C" int halo_exchange(const HaloParams* p, void* stream) {
    const int nd = p->n_lo + p->n_hi;
    if (p->n_shards < 1 || p->n_shards > HALO_MAX_SHARDS || p->n_lo < 0
        || p->n_hi < 0 || p->n_lo > HALO_MAX_DIRS || p->n_hi > HALO_MAX_DIRS
        || p->units < 1 || nd < 1 || p->n_dst < 1
        || p->n_dst > p->n_shards || p->ghost < 1 || p->depth < 1
        || p->depth > p->ghost || p->planes < 3 * p->ghost
        || p->n_comp < 1 || p->comp_units < 0) {
        return -1;
    }
    for (int j = 0; j < p->n_dst; ++j) {
        if (p->dst[j] < 0 || p->dst[j] >= p->n_shards) {
            return -1;
        }
    }
    const int threads = 256;
    const long long rows = (long long)p->n_dst * p->n_comp * nd * p->depth;
    if (rows > 65535) {
        return -1;
    }
    const dim3 grid((unsigned)((p->units + threads - 1) / threads),
                    (unsigned)rows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (p->unit_bytes) {
    case 16:
        halo_exchange_kernel<uint4><<<grid, threads, 0, st>>>(*p);
        break;
    case 4:
        halo_exchange_kernel<uint32_t><<<grid, threads, 0, st>>>(*p);
        break;
    case 2:
        halo_exchange_kernel<uint16_t><<<grid, threads, 0, st>>>(*p);
        break;
    default:
        return -2;
    }
    return (int)cudaGetLastError();
}
