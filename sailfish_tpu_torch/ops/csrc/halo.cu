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
// On a mesh of two axes (('z', 'y') in 3D, ('y', 'x') in 2D) a slab is
// padded along both sharded axes: (K, Q, Lo + 2G, Li + 2G, R), R the
// values of one row along the axes below the inner one (X in 3D, 1 in 2D),
// and the shards are in mesh order, the outer axis slowest. The edge mode
// (`halo_edge_exchange_kernel`, picked by n_inner > 0) fills, in one
// launch, three kinds of region of each destination shard:
//   - the outer axis's ghost planes over the inner axis's interior rows,
//     from the outer neighbour (directions with c = +1 / -1 along the
//     outer axis), one contiguous run of Li R values per plane;
//   - the inner axis's ghost rows over the outer axis's interior planes,
//     from the inner neighbour (c = +1 / -1 along the inner axis), Lo runs
//     of R values, (Li + 2G) R apart;
//   - the edges (3D; corners in 2D) where two ghost regions cross, read
//     directly from the diagonal neighbour (c = +1 / -1 along both axes),
//     one run of R values per (outer, inner) depth pair.
// Reading the diagonal directly needs no second hop (the JAX package
// forwards the edge entries through the inner neighbour's ghost rows,
// sailfish_tpu/parallel/halo.py:364-377, :402-419, :763-771), so the
// launch needs no ordering point besides the one before it. In 2D a run
// is one value (a ghost column is strided by the slab's row length).
// The density exchange uses the same mode with one direction per region
// and depth G, whole regions: the Shan-Chen psi gradient and the
// free-energy stencil read the diagonal neighbours too.
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
// the directions of one edge region: c = +-1 along both sharded axes
// (D3Q19 / D2Q9 1, D3Q15 2, D3Q27 3)
#define HALO_MAX_EDGE_DIRS 3

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
    // the edge mode (two sharded axes) when n_inner > 0: the shards along
    // the inner axis, its planes per buffer (Li + 2G) and the copy units
    // of one row along it; the units of a plane are then
    // inner_planes * row_units
    int n_inner;
    int inner_planes;
    int row_units;
    // the directions copied into the inner axis's low and high ghost rows
    int n_lo_in;
    int n_hi_in;
    int lo_in[HALO_MAX_DIRS];
    int hi_in[HALO_MAX_DIRS];
    // the directions of the four edges: (outer low, inner low), (low,
    // high), (high, low), (high, high)
    int n_edge[4];
    int edge[4][HALO_MAX_EDGE_DIRS];
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

// The ghost span of one side along an axis with `length` interior planes:
// the first destination and source plane and the count. side -1: the low
// ghost planes from the last interior planes of the neighbour below; +1:
// the high ones from the first of the neighbour above; 0: the interior.
struct HaloSpan {
    int dst;
    int src;
    int count;
};

__device__ __forceinline__ HaloSpan halo_span(int side, int length,
                                              int ghost, int depth, int d) {
    if (side < 0) {
        return {ghost - depth + d, length + ghost - depth + d, 1};
    }
    if (side > 0) {
        return {length + ghost + d, ghost + d, 1};
    }
    return {ghost, ghost, length};
}

template <typename U>
__global__ void halo_edge_exchange_kernel(const HaloParams p) {
    const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int depth = p.depth;
    const int n_plane = (p.n_lo + p.n_hi) * depth;
    const int n_row = (p.n_lo_in + p.n_hi_in) * depth;
    int y = blockIdx.y;
    const int per = n_plane + n_row
        + (p.n_edge[0] + p.n_edge[1] + p.n_edge[2] + p.n_edge[3]) * depth
            * depth;
    int e = y % per;
    y /= per;
    const int c = y % p.n_comp;
    const int s = p.dst[y / p.n_comp];
    const int n_outer = p.n_shards / p.n_inner;
    const int io = s / p.n_inner;
    const int ii = s % p.n_inner;
    const int lo_len = p.planes - 2 * p.ghost;
    const int li_len = p.inner_planes - 2 * p.ghost;
    // the region: its sides along the outer and the inner axis, its
    // direction and its depth pair
    int so, si, dir, d_o = 0, d_i = 0;
    if (e < n_plane) {
        d_o = e % depth;
        const int k = e / depth;
        so = k < p.n_lo ? -1 : 1;
        si = 0;
        dir = k < p.n_lo ? p.lo[k] : p.hi[k - p.n_lo];
    } else if ((e -= n_plane) < n_row) {
        d_i = e % depth;
        const int k = e / depth;
        so = 0;
        si = k < p.n_lo_in ? -1 : 1;
        dir = k < p.n_lo_in ? p.lo_in[k] : p.hi_in[k - p.n_lo_in];
    } else {
        e -= n_row;
        d_i = e % depth;
        e /= depth;
        d_o = e % depth;
        e /= depth;
        int corner = 0;
        while (e >= p.n_edge[corner]) {
            e -= p.n_edge[corner];
            ++corner;
        }
        so = corner < 2 ? -1 : 1;
        si = corner % 2 ? 1 : -1;
        dir = p.edge[corner][e];
    }
    const HaloSpan ao = halo_span(so, lo_len, p.ghost, depth, d_o);
    const HaloSpan ai = halo_span(si, li_len, p.ghost, depth, d_i);
    // the copy: ao.count planes of one run of ai.count rows each
    const long long run = (long long)ai.count * p.row_units;
    if (u >= ao.count * run) {
        return;
    }
    const int src_shard = ((io + so + n_outer) % n_outer) * p.n_inner
        + (ii + si + p.n_inner) % p.n_inner;
    const long long plane = (long long)p.inner_planes * p.row_units;
    const long long k = u / run;
    const long long r = u - k * run;
    const long long base = c * p.comp_units
        + (long long)dir * p.planes * plane + r;
    const U* src = reinterpret_cast<const U*>(p.part[src_shard]) + base
        + (ao.src + k) * plane + (long long)ai.src * p.row_units;
    U* dst = reinterpret_cast<U*>(p.part[s]) + base
        + (ao.dst + k) * plane + (long long)ai.dst * p.row_units;
    *dst = *src;
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

// The edge mode's launch: one row of blocks per (destination shard,
// component, region, direction, depth pair), blocks over the largest
// region's copy units.
static int halo_edge_exchange(const HaloParams* p, void* stream) {
    const int n_edge = p->n_edge[0] + p->n_edge[1] + p->n_edge[2]
        + p->n_edge[3];
    if (p->n_shards < 1 || p->n_shards > HALO_MAX_SHARDS
        || p->n_inner > p->n_shards || p->n_shards % p->n_inner
        || p->n_lo < 0 || p->n_hi < 0 || p->n_lo > HALO_MAX_DIRS
        || p->n_hi > HALO_MAX_DIRS || p->n_lo_in < 0 || p->n_hi_in < 0
        || p->n_lo_in > HALO_MAX_DIRS || p->n_hi_in > HALO_MAX_DIRS
        || p->row_units < 1 || p->n_dst < 1 || p->n_dst > p->n_shards
        || p->ghost < 1 || p->depth < 1 || p->depth > p->ghost
        || p->planes < 3 * p->ghost || p->inner_planes < 3 * p->ghost
        || p->units != (long long)p->inner_planes * p->row_units
        || p->n_comp < 1 || p->comp_units < 0) {
        return -1;
    }
    for (int j = 0; j < 4; ++j) {
        if (p->n_edge[j] < 0 || p->n_edge[j] > HALO_MAX_EDGE_DIRS) {
            return -1;
        }
    }
    for (int j = 0; j < p->n_dst; ++j) {
        if (p->dst[j] < 0 || p->dst[j] >= p->n_shards) {
            return -1;
        }
    }
    const int per = (p->n_lo + p->n_hi + p->n_lo_in + p->n_hi_in) * p->depth
        + n_edge * p->depth * p->depth;
    const long long rows = (long long)p->n_dst * p->n_comp * per;
    if (per < 1 || rows > 65535) {
        return -1;
    }
    const long long lo_len = p->planes - 2 * p->ghost;
    const long long li_len = p->inner_planes - 2 * p->ghost;
    const long long most = (lo_len > li_len ? lo_len : li_len)
        * p->row_units;
    const int threads = 256;
    const dim3 grid((unsigned)((most + threads - 1) / threads),
                    (unsigned)rows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (p->unit_bytes) {
    case 16:
        halo_edge_exchange_kernel<uint4><<<grid, threads, 0, st>>>(*p);
        break;
    case 4:
        halo_edge_exchange_kernel<uint32_t><<<grid, threads, 0, st>>>(*p);
        break;
    case 2:
        halo_edge_exchange_kernel<uint16_t><<<grid, threads, 0, st>>>(*p);
        break;
    default:
        return -2;
    }
    return (int)cudaGetLastError();
}

extern "C" int halo_exchange(const HaloParams* p, void* stream) {
    if (p->n_inner > 0) {
        return halo_edge_exchange(p, stream);
    }
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
