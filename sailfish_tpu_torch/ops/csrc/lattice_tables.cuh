// The lattice tables at compile time, and loops over compile-time indices.
// Shared by lbm_step.cu (through lbm_common.cuh) and fe_step.cu, so the port
// holds one copy of each table; ops/build.py hashes this header into every
// source's build key.
//
// Direction order: that of sailfish_tpu_torch.lattice. Every entry is a
// constexpr function of the index, so a compile-time index folds it into an
// immediate: c_i . u becomes +- adds (cdot), a zero component vanishes, and
// b[opp(i) * n + node] is a fixed offset. lbm_lattice_tables (lbm_step.cu)
// and fe_d3q19_tables (fe_step.cu) copy the tables out, and the Python
// wrappers check them against sailfish_tpu_torch.lattice when a library
// loads.

#pragma once

#include <cuda_runtime.h>

struct D3Q19 {
    static constexpr int DIM = 3;
    static constexpr int Q = 19;
    __host__ __device__ static constexpr int c(int i, int d) {
        constexpr int t[19][3] = {
            {0, 0, 0}, {-1, 0, 0}, {0, -1, 0}, {0, 0, -1}, {0, 0, 1},
            {0, 1, 0}, {1, 0, 0}, {-1, -1, 0}, {-1, 0, -1}, {-1, 0, 1},
            {-1, 1, 0}, {0, -1, -1}, {0, -1, 1}, {0, 1, -1}, {0, 1, 1},
            {1, -1, 0}, {1, 0, -1}, {1, 0, 1}, {1, 1, 0}};
        return t[i][d];
    }
    __host__ __device__ static constexpr int opp(int i) {
        constexpr int t[19] = {0, 6, 5, 4, 3, 2, 1, 18, 17, 16,
                               15, 14, 13, 12, 11, 10, 9, 8, 7};
        return t[i];
    }
    // orientation vector of wall code k + 1: +x, -x, +y, -y, +z, -z
    __host__ __device__ static constexpr int ov(int k, int d) {
        return d == (k >> 1) ? ((k & 1) ? -1 : 1) : 0;
    }
    __host__ __device__ static constexpr int n2(int i) {
        return c(i, 0) * c(i, 0) + c(i, 1) * c(i, 1) + c(i, 2) * c(i, 2);
    }
    // lattice weights
    __host__ __device__ static constexpr float w(int i) {
        return n2(i) == 0 ? (float)(1.0 / 3.0)
             : n2(i) == 1 ? (float)(1.0 / 18.0) : (float)(1.0 / 36.0);
    }
    // ln w_i: the float64 logarithm of the float64 weight, rounded to
    // float32 (the entropy of the entropic collision)
    __host__ __device__ static constexpr float logw(int i) {
        return n2(i) == 0 ? (float)-1.0986122886681098
             : n2(i) == 1 ? (float)-2.890371757896165
                          : (float)-3.58351893845611;
    }
    // free-energy weights (ops/multigrid.py fe_weights)
    __host__ __device__ static constexpr float wi(int i) {
        return n2(i) == 0 ? 0.0f
             : n2(i) == 1 ? (float)(1.0 / 6.0) : (float)(1.0 / 12.0);
    }
    __host__ __device__ static constexpr float wdd(int i, int d) {
        return n2(i) == 0 ? 0.0f
             : n2(i) == 1 ? (c(i, d) != 0 ? (float)(5.0 / 12.0)
                                          : (float)(-1.0 / 3.0))
             : (c(i, d) != 0 ? (float)(-1.0 / 24.0) : (float)(1.0 / 12.0));
    }
    __host__ __device__ static constexpr float wod(int i, int d, int e) {
        return (float)(c(i, d) * c(i, e)) / 4.0f;
    }
};

struct D2Q9 {
    static constexpr int DIM = 2;
    static constexpr int Q = 9;
    // the z component (d = 2) of every direction is 0
    __host__ __device__ static constexpr int c(int i, int d) {
        constexpr int t[9][2] = {
            {0, 0}, {-1, 0}, {0, -1}, {0, 1}, {1, 0},
            {-1, -1}, {-1, 1}, {1, -1}, {1, 1}};
        return d < 2 ? t[i][d] : 0;
    }
    __host__ __device__ static constexpr int opp(int i) {
        constexpr int t[9] = {0, 4, 3, 2, 1, 8, 7, 6, 5};
        return t[i];
    }
    __host__ __device__ static constexpr int n2(int i) {
        return c(i, 0) * c(i, 0) + c(i, 1) * c(i, 1);
    }
    // lattice weights
    __host__ __device__ static constexpr float w(int i) {
        return n2(i) == 0 ? (float)(4.0 / 9.0)
             : n2(i) == 1 ? (float)(1.0 / 9.0) : (float)(1.0 / 36.0);
    }
    // ln w_i, as D3Q19::logw
    __host__ __device__ static constexpr float logw(int i) {
        return n2(i) == 0 ? (float)-0.8109302162163288
             : n2(i) == 1 ? (float)-2.1972245773362196
                          : (float)-3.58351893845611;
    }
};

struct D3Q15 {
    static constexpr int DIM = 3;
    static constexpr int Q = 15;
    __host__ __device__ static constexpr int c(int i, int d) {
        constexpr int t[15][3] = {
            {0, 0, 0}, {-1, 0, 0}, {0, -1, 0}, {0, 0, -1}, {0, 0, 1},
            {0, 1, 0}, {1, 0, 0}, {-1, -1, -1}, {-1, -1, 1}, {-1, 1, -1},
            {-1, 1, 1}, {1, -1, -1}, {1, -1, 1}, {1, 1, -1}, {1, 1, 1}};
        return t[i][d];
    }
    __host__ __device__ static constexpr int opp(int i) {
        constexpr int t[15] = {0, 6, 5, 4, 3, 2, 1, 14, 13, 12, 11, 10, 9,
                               8, 7};
        return t[i];
    }
    __host__ __device__ static constexpr int n2(int i) {
        return c(i, 0) * c(i, 0) + c(i, 1) * c(i, 1) + c(i, 2) * c(i, 2);
    }
    // lattice weights
    __host__ __device__ static constexpr float w(int i) {
        return n2(i) == 0 ? (float)(2.0 / 9.0)
             : n2(i) == 1 ? (float)(1.0 / 9.0) : (float)(1.0 / 72.0);
    }
    // ln w_i, as D3Q19::logw
    __host__ __device__ static constexpr float logw(int i) {
        return n2(i) == 0 ? (float)-1.5040773967762742
             : n2(i) == 1 ? (float)-2.1972245773362196
                          : (float)-4.276666119016055;
    }
};

struct D3Q27 {
    static constexpr int DIM = 3;
    static constexpr int Q = 27;
    __host__ __device__ static constexpr int c(int i, int d) {
        constexpr int t[27][3] = {
            {0, 0, 0}, {-1, 0, 0}, {0, -1, 0}, {0, 0, -1}, {0, 0, 1},
            {0, 1, 0}, {1, 0, 0}, {-1, -1, 0}, {-1, 0, -1}, {-1, 0, 1},
            {-1, 1, 0}, {0, -1, -1}, {0, -1, 1}, {0, 1, -1}, {0, 1, 1},
            {1, -1, 0}, {1, 0, -1}, {1, 0, 1}, {1, 1, 0}, {-1, -1, -1},
            {-1, -1, 1}, {-1, 1, -1}, {-1, 1, 1}, {1, -1, -1}, {1, -1, 1},
            {1, 1, -1}, {1, 1, 1}};
        return t[i][d];
    }
    __host__ __device__ static constexpr int opp(int i) {
        constexpr int t[27] = {0, 6, 5, 4, 3, 2, 1, 18, 17, 16, 15, 14, 13,
                               12, 11, 10, 9, 8, 7, 26, 25, 24, 23, 22, 21,
                               20, 19};
        return t[i];
    }
    __host__ __device__ static constexpr int n2(int i) {
        return c(i, 0) * c(i, 0) + c(i, 1) * c(i, 1) + c(i, 2) * c(i, 2);
    }
    // lattice weights
    __host__ __device__ static constexpr float w(int i) {
        return n2(i) == 0 ? (float)(8.0 / 27.0)
             : n2(i) == 1 ? (float)(2.0 / 27.0)
             : n2(i) == 2 ? (float)(1.0 / 54.0) : (float)(1.0 / 216.0);
    }
    // ln w_i, as D3Q19::logw
    __host__ __device__ static constexpr float logw(int i) {
        return n2(i) == 0 ? (float)-1.2163953243244932
             : n2(i) == 1 ? (float)-2.6026896854443837
             : n2(i) == 2 ? (float)-3.9889840465642745
                          : (float)-5.375278407684165;
    }
};

// The lattice of a dimension and a direction count: LatticeOf<2, 9>::type
// is D2Q9, <3, 15> D3Q15, <3, 19> D3Q19, <3, 27> D3Q27.
template <int DIM, int Q> struct LatticeOf;
template <> struct LatticeOf<2, 9> { using type = D2Q9; };
template <> struct LatticeOf<3, 15> { using type = D3Q15; };
template <> struct LatticeOf<3, 19> { using type = D3Q19; };
template <> struct LatticeOf<3, 27> { using type = D3Q27; };

// The direction of L whose velocity is c_i with its component along axis
// reversed: the slip (specular) reflection of a wall normal to that axis
// (sailfish_tpu_torch.lattice Grid.slip_swap).
template <typename L>
__host__ __device__ constexpr int slip_of(int i, int axis) {
    for (int j = 0; j < L::Q; ++j) {
        bool same = true;
        for (int d = 0; d < 3; ++d) {
            const int want = d == axis ? -L::c(i, d) : L::c(i, d);
            if (L::c(j, d) != want) same = false;
        }
        if (same) return j;
    }
    return -1;
}

// The conserved-moment columns of M^-1 (the inverse of the MRT moment
// matrix of sailfish_tpu_torch.lattice), column k = 0 for the density row
// of M (all ones) and k = 1 + a for the momentum row along axis a (c_ia):
// M^-1[i, 0] = 1 / Q and M^-1[i, 1 + a] = c_ia / sum_j c_ja^2. The MRT
// relaxation of lbm_step restores the zero rate of these moments with them;
// lbm_lattice_tables copies them out and ops/lbm_step.py check_tables holds
// them against lattice.mrt_inv.
template <typename L>
__host__ __device__ constexpr float mrt_minv_axis(int a) {
    int n = 0;
    for (int j = 0; j < L::Q; ++j) n += L::c(j, a) * L::c(j, a);
    return (float)(1.0 / n);
}

template <typename L>
__host__ __device__ constexpr float mrt_minv_cons(int i, int k) {
    return k == 0 ? (float)(1.0 / L::Q)
                  : (float)L::c(i, k - 1) * mrt_minv_axis<L>(k - 1);
}

// f(Int<i>()) for i = 0 .. N - 1 in order; i is a compile-time constant.
template <int... I> struct Seq {};
template <int N, int... I> struct MakeSeq : MakeSeq<N - 1, N - 1, I...> {};
template <int... I> struct MakeSeq<0, I...> { using type = Seq<I...>; };
template <int V> struct Int { static constexpr int value = V; };

template <typename F, int... I>
__device__ __forceinline__ void static_for_seq(F& f, Seq<I...>) {
    (f(Int<I>()), ...);
}

template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
    static_for_seq(f, typename MakeSeq<N>::type());
}

// c_i . v on lattice L with the zero components left out: -0.0f + v folds
// to v, where 0.0f * v would stay a multiply
template <typename L, int I>
__device__ __forceinline__ float cdot(float vx, float vy, float vz) {
    float s = -0.0f;
    if constexpr (L::c(I, 0) > 0) s += vx;
    if constexpr (L::c(I, 0) < 0) s -= vx;
    if constexpr (L::c(I, 1) > 0) s += vy;
    if constexpr (L::c(I, 1) < 0) s -= vy;
    if constexpr (L::c(I, 2) > 0) s += vz;
    if constexpr (L::c(I, 2) < 0) s -= vz;
    return s;
}
