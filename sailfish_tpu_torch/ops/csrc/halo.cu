// The ghost-plane exchange of a sharded step (sailfish_tpu_torch/parallel/
// halo.py), for shards on one device or on several.
//
// Each shard holds its slab of the state as (Q, L + 2, plane) with ghost
// planes at 0 and L + 1 along the sharded axis (z in 3D, y in 2D). After a
// step, ghost plane 0 of shard s takes the last interior plane L of shard
// s - 1 and ghost plane L + 1 the first interior plane 1 of shard s + 1
// (the ring wraps, as the global domain's periodic streaming does), but only
// in the directions that the next pull step reads from it: those with
// c = +1 along the axis for plane 0 (`lo`), c = -1 for plane L + 1 (`hi`).
// Ghost planes are written, interior planes read, so the copies of one
// launch never overlap. One launch fills the ghost planes of the shards
// listed in `dst` (those on the launching device): blockIdx.y picks the
// (shard, side, direction) plane, x runs over its copy units. A source
// plane on another device is read through peer access
// (`halo_enable_peer`); the caller orders the launch after the steps that
// wrote its sources, on every device.
//
// The counterpart of the two jax.lax.ppermute calls of
// sailfish_tpu/parallel/halo.py:361-362 that feed make_kernel_3d's ghost
// inputs (sailfish_tpu/ops/pallas_step.py:828-834; make_kernel_2d's ghost
// rows, pallas_step2d.py:36).

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
};

template <typename U>
__global__ void halo_exchange_kernel(const HaloParams p) {
    const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (u >= p.units) {
        return;
    }
    const int nd = p.n_lo + p.n_hi;
    const int s = p.dst[blockIdx.y / nd];
    const int k = blockIdx.y % nd;
    const int interior = p.planes - 2;
    int dir, src_shard, src_plane, dst_plane;
    if (k < p.n_lo) {
        dir = p.lo[k];
        src_shard = (s + p.n_shards - 1) % p.n_shards;
        src_plane = interior;
        dst_plane = 0;
    } else {
        dir = p.hi[k - p.n_lo];
        src_shard = (s + 1) % p.n_shards;
        src_plane = 1;
        dst_plane = interior + 1;
    }
    const U* src = reinterpret_cast<const U*>(p.part[src_shard])
        + ((long long)dir * p.planes + src_plane) * p.units;
    U* dst = reinterpret_cast<U*>(p.part[s])
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
        || p->planes < 3 || p->units < 1 || nd < 1 || p->n_dst < 1
        || p->n_dst > p->n_shards) {
        return -1;
    }
    for (int j = 0; j < p->n_dst; ++j) {
        if (p->dst[j] < 0 || p->dst[j] >= p->n_shards) {
            return -1;
        }
    }
    const int threads = 256;
    const dim3 grid((unsigned)((p->units + threads - 1) / threads),
                    (unsigned)(p->n_dst * nd));
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
