// One thread's share of the kangaroo walk: the body of the CUDA walk
// kernel (jump_kernel.cu), written as __host__ __device__ C++ so that
// g++ runs the same code on the CPU in the tests (host_shim.cpp).
//
// Geometry: a block of THREADS threads owns THREADS * G consecutive
// lanes; thread t of block b owns lanes b*THREADS*G + g*THREADS + t,
// g < G, so that neighbouring threads read neighbouring lanes of each
// row.  The walk kernels run G = GROUP; the probes also G = 32 and 128.
//
// A window (nb_run steps): the thread packs its lanes' state from the
// (16, n) / (8, n) 16-bit limb rows into 32-bit word scratch rows x (8,
// n), y (8, n), d (4, n), walks on the scratch, and unpacks at the end.
// Each step, per lane: jmp = x & 31; dx = qx - x; the thread inverts
// the product of its G dx values once (Montgomery's trick: prefix
// products, one safegcd inversion, unwind); lam = (qy - y) / dx;
// x3 = lam^2 - x - qx (canonical); y3 = lam (qx - x3) - qy (relaxed);
// d += qd mod 2^128; then the DP test on x words 6..7 and the capture
// into slot `count` while count < slots.
//
// Symmetry mode (SYM, the -sym walk over classes {P, -P}): jmp =
// (x & 15) | (symclass << 4); after the add, y3 is made canonical and,
// where y3 > (p-1)/2, replaced by p - y3 while the signed 128-bit
// distance is negated and the class toggled; the DP test and capture
// see the normalized point and distance.  Both passes read the lane's
// class once per step, and only the backward pass writes the new one,
// after both have used the old.  The normalization is word selects, so
// a warp whose lanes flip differently does not diverge.
//
// Memory traffic of this design, per lane and step: the forward pass
// reads x (32 B) and writes the prefix product (32 B, local memory);
// the backward pass reads x, y, d and the prefix product (112 B) and
// writes x, y, d (80 B): 256 B.  A thread's prefix products (G x 32 B)
// do not fit in L1 across the resident blocks, so most of that goes to
// device memory.  Packing and unpacking add 480 B per lane and window
// (0.5 B per step at 1024 steps).  Symmetry mode adds the class: read
// in both passes and written in one, 12 B.
//
// Registers: the backward pass re-gathers qx and qy from the shared
// table where it needs them instead of holding them, loads d only for
// its add, and lets dx die after the unwind, so that the live state at
// a multiply is the running inverse, x, the product's operands and its
// 16-word accumulator; with the inversion's 4 x 9 limbs this fits the
// 128 registers that 4 blocks of 128 threads per SM leave a thread.
//
// The grouped inversion is exact, so canonical x3 is the same whatever
// batching scheme computes it -- with one exception: a lane with dx = 0
// (P = +-Q) zeroes the product of its whole group here, while the JAX
// package's cross-lane fold tree zeroes a different set of lanes.  A
// random walk never reaches such a lane; it is not emulated.
#pragma once

#include <type_traits>

#include "field.cuh"

namespace kt {

constexpr int THREADS = 128;  // threads per block
constexpr int GROUP = 64;     // lanes per thread of the walk kernels
constexpr int LANES = THREADS * GROUP;  // lanes per block
// resident blocks per SM that the walk kernels' launch bounds ask for:
// 4 x 128 threads = 4 warps per scheduler, <= 128 registers a thread;
// 2^22 lanes = 512 blocks then fit one wave on 132 SMs
constexpr int MIN_BLOCKS = 4;
constexpr int NB_JUMP = 32;
constexpr int DPX_ROWS = 10;  // x limbs 0..9 per DP slot

// Jump table packed into words, laid out [word][jump] so that threads
// of a warp reading different jumps of one word hit different banks.
struct JumpTable {
    uint32_t x[8][NB_JUMP];
    uint32_t y[8][NB_JUMP];
    uint32_t d[4][NB_JUMP];
};

// f(std::integral_constant<int, G>{}) for the G (lanes per thread) that
// the walk body is built for: GROUP, and 32 and 128 for the probes' G
// sweep; -1 for another G.
template <class F>
int with_group(int group, F&& f) {
    switch (group) {
        case 32: return f(std::integral_constant<int, 32>{});
        case 64: return f(std::integral_constant<int, 64>{});
        case 128: return f(std::integral_constant<int, 128>{});
        default: return -1;
    }
}

// (rows, N) int32 limb layout <-> words, one lane.
KT_HD void load_words(uint32_t* r, int nw, const int32_t* src, size_t n,
                      size_t lane) {
    for (int w = 0; w < nw; ++w)
        r[w] = (uint32_t)src[(2 * w) * n + lane]
             | ((uint32_t)src[(2 * w + 1) * n + lane] << 16);
}

KT_HD void store_words(int32_t* dst, const uint32_t* r, int nw, size_t n,
                       size_t lane) {
    for (int w = 0; w < nw; ++w) {
        dst[(2 * w) * n + lane] = (int32_t)(r[w] & 0xFFFFu);
        dst[(2 * w + 1) * n + lane] = (int32_t)(r[w] >> 16);
    }
}

// (rows, N) uint32 word rows (the window scratch) <-> words, one lane.
KT_HD void load_packed(uint32_t* r, int nw, const uint32_t* src, size_t n,
                       size_t lane) {
    for (int w = 0; w < nw; ++w) r[w] = src[w * n + lane];
}

KT_HD void store_packed(uint32_t* dst, const uint32_t* r, int nw, size_t n,
                        size_t lane) {
    for (int w = 0; w < nw; ++w) dst[w * n + lane] = r[w];
}

// q[w] = table[w][j]: one lane's gather from the shared table.
KT_HD void gather(uint32_t* q, const uint32_t (*table)[NB_JUMP], int nw,
                  int j) {
    for (int w = 0; w < nw; ++w) q[w] = table[w][j];
}

// A lane's (rows, n) limbs read into r, and written back from r, through
// volatile accesses that the compiler may neither drop nor merge: memory
// traffic with no arithmetic (the extra_traffic probe variant).
KT_HD void load_limbs_volatile(int32_t* r, int rows, const int32_t* src,
                               size_t n, size_t lane) {
    const volatile int32_t* v = src;
    for (int k = 0; k < rows; ++k) r[k] = v[k * n + lane];
}

KT_HD void store_limbs_volatile(int32_t* dst, const int32_t* r, int rows,
                                size_t n, size_t lane) {
    volatile int32_t* v = dst;
    for (int k = 0; k < rows; ++k) v[k * n + lane] = r[k];
}

// Pack entry k of the 8*NB_JUMP word grid (16- or 8-row tables).
KT_HD void pack_table_word(JumpTable* tb, const int32_t* jx,
                           const int32_t* jy, const int32_t* jd, int k) {
    const int w = k / NB_JUMP, j = k % NB_JUMP;
    tb->x[w][j] = (uint32_t)jx[(2 * w) * NB_JUMP + j]
                | ((uint32_t)jx[(2 * w + 1) * NB_JUMP + j] << 16);
    tb->y[w][j] = (uint32_t)jy[(2 * w) * NB_JUMP + j]
                | ((uint32_t)jy[(2 * w + 1) * NB_JUMP + j] << 16);
    if (w < 4)
        tb->d[w][j] = (uint32_t)jd[(2 * w) * NB_JUMP + j]
                    | ((uint32_t)jd[(2 * w + 1) * NB_JUMP + j] << 16);
}

struct WalkArgs {
    int32_t* px;  // (16, n) in/out, canonical
    int32_t* py;  // (16, n) in/out, relaxed
    int32_t* d;   // (8, n) in/out, 128-bit distances
    const int32_t* masks;  // (4,) DP masks for x limbs 12..15
    size_t n;
    int nb_run;
    int slots;
    int32_t* count;  // (n,) zeroed by the caller
    int32_t* dpx;    // (slots, 10, n)
    int32_t* dpd;    // (slots, 8, n)
    int32_t* dstep;  // (slots, n)
    int32_t* symclass;  // (n,) in/out, 0 or 1; symmetry mode only
    uint32_t* scratch;  // (SCRATCH_ROWS, n): x words 0..7, y 8..15, d 16..19
};

constexpr int SCRATCH_ROWS = 8 + 8 + 4;

// Jump index of a lane: x mod 32, or in symmetry mode x mod 16 plus 16
// times the lane's class.
template <bool SYM>
KT_HD int jump_index(const uint32_t x[8], uint32_t sc) {
    if constexpr (SYM)
        return (int)((x[0] & (NB_JUMP / 2 - 1)) | ((sc & 1u) << 4));
    else
        return (int)(x[0] & (NB_JUMP - 1));
}

// The production walk.  The probe kernels (probe_kernels.cu) give
// walk_thread another of these types, with one component switched, and
// attribute the step's cost from the timing deltas; C++17 has no
// class-type template arguments, hence a type of constants.
struct Production {
    static constexpr bool no_inv = false;     // dxi = dx: no inversion
    static constexpr bool no_sqr = false;     // lam in place of lam^2
    static constexpr bool no_y3mul = false;   // y3 = (qx - x3) - qy
    static constexpr bool extra_mul = false;  // y3 *= lam after the add
    static constexpr bool extra_sub = false;  // y3 -= lam after the add
    static constexpr bool no_dp = false;      // no DP test, no capture
    static constexpr bool fixed_gather = false;  // jmp = step & 31
    // the forward pass reads each lane's y (64 B) and writes it back
    // unchanged: 128 B more traffic per lane and step, no arithmetic
    static constexpr bool extra_traffic = false;
};

// Jump index of a lane in variant V: the production index, or the
// step's when V::fixed_gather.
template <bool SYM, class V>
KT_HD int lane_jump(const uint32_t x[8], uint32_t sc, int step) {
    if constexpr (V::fixed_gather)
        return step & (NB_JUMP - 1);
    else
        return jump_index<SYM>(x, sc);
}

// The whole launch window (nb_run steps) for thread t of block b, which
// owns G lanes.  `acc` is the thread's scratch for its G prefix products.
template <bool SYM, class V = Production, int G = GROUP>
KT_HD void walk_thread(const WalkArgs& a, const JumpTable& tb, size_t b,
                       int t, uint32_t (*acc)[8]) {
    const uint32_t mlo = (uint32_t)a.masks[0] | ((uint32_t)a.masks[1] << 16);
    const uint32_t mhi = (uint32_t)a.masks[2] | ((uint32_t)a.masks[3] << 16);
    const size_t base = b * (size_t)(THREADS * G) + (size_t)t;
    const size_t n = a.n;
    uint32_t* const sx = a.scratch;
    uint32_t* const sy = a.scratch + 8 * n;
    uint32_t* const sd = a.scratch + 16 * n;
    for (int g = 0; g < G; ++g) {  // pack the window's state
        const size_t lane = base + (size_t)g * THREADS;
        uint32_t w[8];
        load_words(w, 8, a.px, n, lane);
        store_packed(sx, w, 8, n, lane);
        load_words(w, 8, a.py, n, lane);
        store_packed(sy, w, 8, n, lane);
        load_words(w, 4, a.d, n, lane);
        store_packed(sd, w, 4, n, lane);
    }
    for (int step = 0; step < a.nb_run; ++step) {
        uint32_t inv[8];
        if constexpr (!V::no_inv) {
            // forward: prefix products of dx over the group, the running
            // product in registers, each but the last stored
            for (int g = 0; g < G; ++g) {
                const size_t lane = base + (size_t)g * THREADS;
                uint32_t x[8], dx[8];
                load_packed(x, 8, sx, n, lane);
                [[maybe_unused]] int32_t held[16];
                if constexpr (V::extra_traffic)
                    load_limbs_volatile(held, 16, a.py, n, lane);
                const uint32_t sc = SYM ? (uint32_t)a.symclass[lane] : 0u;
                gather(dx, tb.x, 8, lane_jump<SYM, V>(x, sc, step));
                fe_sub(dx, dx, x);
                if (g == 0)
                    fe_copy(inv, dx);
                else
                    fe_mul(inv, inv, dx);
                if (g < G - 1) fe_copy(acc[g], inv);
                if constexpr (V::extra_traffic)
                    store_limbs_volatile(a.py, held, 16, n, lane);
            }
            fe_inv(inv, inv);
        }
        // backward: unwind the inverse lane by lane, then the affine add
        for (int g = G - 1; g >= 0; --g) {
            const size_t lane = base + (size_t)g * THREADS;
            uint32_t x[8], lam[8], x3[8], y3[8], t1[8];
            load_packed(x, 8, sx, n, lane);
            const uint32_t sc = SYM ? (uint32_t)a.symclass[lane] : 0u;
            const int j = lane_jump<SYM, V>(x, sc, step);
            {
                uint32_t dx[8], dxi[8];
                gather(dx, tb.x, 8, j);
                fe_sub(dx, dx, x);
                if constexpr (V::no_inv) {
                    fe_copy(dxi, dx);
                } else if (g > 0) {
                    fe_mul(dxi, inv, acc[g - 1]);  // 1/dx_g
                    fe_mul(inv, inv, dx);          // 1/(dx_0 ... dx_{g-1})
                } else {
                    fe_copy(dxi, inv);
                }
                load_packed(t1, 8, sy, n, lane);
                gather(lam, tb.y, 8, j);
                fe_sub(t1, lam, t1);  // qy - y
                fe_mul(lam, t1, dxi);
            }
            if constexpr (V::no_sqr)
                fe_copy(x3, lam);
            else
                fe_sqr(x3, lam);
            fe_sub(x3, x3, x);
            gather(t1, tb.x, 8, j);
            fe_sub(x3, x3, t1);
            fe_canon(x3);
            fe_sub(t1, t1, x3);  // qx - x3
            if constexpr (V::no_y3mul)
                fe_copy(y3, t1);
            else
                fe_mul(y3, lam, t1);
            gather(t1, tb.y, 8, j);
            fe_sub(y3, y3, t1);
            if constexpr (V::extra_mul) fe_mul(y3, y3, lam);
            if constexpr (V::extra_sub) fe_sub(y3, y3, lam);
            uint32_t dd[4], qd[4];
            load_packed(dd, 4, sd, n, lane);
            gather(qd, tb.d, 4, j);
            add_u128(dd, qd);
            if constexpr (SYM) {
                fe_canon(y3);
                const uint32_t high = fe_is_high(y3);
                const uint32_t m = 0u - high;
                uint32_t ny[8], nd[4];
                fe_neg(ny, y3);
                sel_words(y3, ny, y3, 8, m);
                for (int w = 0; w < 4; ++w) nd[w] = dd[w];
                neg_u128(nd);
                sel_words(dd, nd, dd, 4, m);
                a.symclass[lane] = (int32_t)(sc ^ high);
            }
            store_packed(sx, x3, 8, n, lane);
            store_packed(sy, y3, 8, n, lane);
            store_packed(sd, dd, 4, n, lane);
            if (!V::no_dp && ((x3[6] & mlo) | (x3[7] & mhi)) == 0) {
                const int c = a.count[lane];
                if (c < a.slots) {
                    for (int w = 0; w < DPX_ROWS / 2; ++w) {
                        a.dpx[((size_t)c * DPX_ROWS + 2 * w) * n + lane] =
                            (int32_t)(x3[w] & 0xFFFFu);
                        a.dpx[((size_t)c * DPX_ROWS + 2 * w + 1) * n + lane] =
                            (int32_t)(x3[w] >> 16);
                    }
                    store_words(a.dpd + (size_t)c * 8 * n, dd, 4, n, lane);
                    a.dstep[(size_t)c * n + lane] = step;
                }
                a.count[lane] = c + 1;
            }
        }
    }
    for (int g = 0; g < G; ++g) {  // unpack
        const size_t lane = base + (size_t)g * THREADS;
        uint32_t w[8];
        load_packed(w, 8, sx, n, lane);
        store_words(a.px, w, 8, n, lane);
        load_packed(w, 8, sy, n, lane);
        store_words(a.py, w, 8, n, lane);
        load_packed(w, 4, sd, n, lane);
        store_words(a.d, w, 4, n, lane);
    }
}

}  // namespace kt
