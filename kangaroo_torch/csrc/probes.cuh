// Per-thread bodies of the probe kernels (probe_kernels.cu), written as
// __host__ __device__ C++ like the walk body, so that g++ runs the same
// code on the CPU in the tests (host_shim.cpp).
//
//   P1 field chains: a <- op(a, b) `rounds` times, one lane per thread
//      (field.cuh's ops, the jump-table gather), or a jump step without
//      DP or distance over a thread's GROUP lanes with its grouped
//      inversion (the walk's geometry).
//   P2 raw chains: one 32-bit instruction per element and iteration,
//      ILP independent chains per thread, the loop index mixed in.
//   P3 is walk_thread itself with a variant type (walk.cuh), and base
//      also at G = 32 and 128; the variants are defined here.
//   P4 inversion chains: the walk's per-thread Montgomery inversion
//      over G lanes, x <- canon(fn(x) - x) | 1 `iters` times.
//
// Every non-field operation of a chain (the gather's xor, the step's
// x3 ^ y3, P4's | 1) reads a canonical value, so that the chain does
// not depend on which relaxed representative the arithmetic produced.
#pragma once

#include <tuple>
#include <utility>

#include "walk.cuh"

#if defined(__CUDA_ARCH__)
#define KT_FADD(a, b) __fadd_rn(a, b)
#define KT_FMUL(a, b) __fmul_rn(a, b)
#define KT_FMA(a, b, c) __fmaf_rn(a, b, c)
#else
#include <cmath>
#define KT_FADD(a, b) ((a) + (b))
#define KT_FMUL(a, b) ((a) * (b))
#define KT_FMA(a, b, c) std::fma(a, b, c)
#endif

namespace kt {

// ---- P1: field chains ----

enum FieldOp {
    F_MUL, F_SQR, F_SUB, F_ADD, F_FOLD, F_CANON, F_INV, F_GATHER, F_STEP,
    F_NOPS
};

// One round of op on lane value a, with the lane's fixed operand b.
template <int OP>
KT_HD void field_round(uint32_t a[8], const uint32_t b[8],
                       const JumpTable& tb) {
    if constexpr (OP == F_MUL) {
        fe_mul(a, a, b);
    } else if constexpr (OP == F_SQR) {
        fe_sqr(a, a);
    } else if constexpr (OP == F_SUB) {
        fe_sub(a, a, b);
    } else if constexpr (OP == F_ADD) {
        fe_add(a, a, b);
    } else if constexpr (OP == F_FOLD) {
        fe_fold(a, b[0] & 1u);  // a + (b & 1) * 2^256, folded
    } else if constexpr (OP == F_CANON) {
        fe_canon(a);
    } else if constexpr (OP == F_INV) {
        fe_inv(a, a);
    } else if constexpr (OP == F_GATHER) {
        const int j = (int)(a[0] & (NB_JUMP - 1));
        for (int w = 0; w < 8; ++w) a[w] ^= tb.x[w][j];
    }
}

// Rounds per trip of the add-class chains' loop on the device, so that
// one trip's SASS holds that many rounds (probes/pkbench.py counts its
// instructions per round: CHAIN_UNROLL there).
constexpr int CHAIN_UNROLL = 4;

// `rounds` rounds on one lane of the (16, n) limb arrays x (in place)
// and b.
template <int OP>
KT_HD void field_chain_lane(int32_t* x, const int32_t* b, size_t n,
                            size_t lane, int rounds, const JumpTable& tb) {
    uint32_t a[8], c[8];
    load_words(a, 8, x, n, lane);
    load_words(c, 8, b, n, lane);
    if constexpr (OP == F_SUB || OP == F_ADD || OP == F_FOLD) {
#if defined(__CUDA_ARCH__)
#pragma unroll CHAIN_UNROLL
#endif
        for (int r = 0; r < rounds; ++r) field_round<OP>(a, c, tb);
    } else {
        for (int r = 0; r < rounds; ++r) field_round<OP>(a, c, tb);
    }
    store_words(x, a, 8, n, lane);
}

// `rounds` jump steps without DP or distance for thread t of block blk,
// on the walk's geometry: (x, y = b) += table[x & 31] with the thread's
// grouped inversion, then x <- x3 ^ canon(y3); y stays b.
KT_HD void step_chain_thread(int32_t* px, const int32_t* py, size_t n,
                             size_t blk, int t, int rounds,
                             const JumpTable& tb, uint32_t (*acc)[8]) {
    const size_t base = blk * (size_t)LANES + (size_t)t;
    for (int r = 0; r < rounds; ++r) {
        uint32_t x[8], q[8], dx[8], inv[8];
        for (int g = 0; g < GROUP; ++g) {
            const size_t lane = base + (size_t)g * THREADS;
            load_words(x, 8, px, n, lane);
            const int j = (int)(x[0] & (NB_JUMP - 1));
            for (int w = 0; w < 8; ++w) q[w] = tb.x[w][j];
            fe_sub(dx, q, x);
            if (g == 0)
                fe_copy(acc[0], dx);
            else
                fe_mul(acc[g], acc[g - 1], dx);
        }
        fe_inv(inv, acc[GROUP - 1]);
        for (int g = GROUP - 1; g >= 0; --g) {
            const size_t lane = base + (size_t)g * THREADS;
            uint32_t y[8], qy[8], dxi[8], lam[8], x3[8], y3[8], t1[8];
            load_words(x, 8, px, n, lane);
            load_words(y, 8, py, n, lane);
            const int j = (int)(x[0] & (NB_JUMP - 1));
            for (int w = 0; w < 8; ++w) {
                q[w] = tb.x[w][j];
                qy[w] = tb.y[w][j];
            }
            fe_sub(dx, q, x);
            if (g > 0) {
                fe_mul(dxi, inv, acc[g - 1]);
                fe_mul(inv, inv, dx);
            } else {
                fe_copy(dxi, inv);
            }
            fe_sub(t1, qy, y);
            fe_mul(lam, t1, dxi);
            fe_sqr(x3, lam);
            fe_sub(x3, x3, x);
            fe_sub(x3, x3, q);
            fe_canon(x3);
            fe_sub(t1, q, x3);
            fe_mul(y3, lam, t1);
            fe_sub(y3, y3, qy);
            fe_canon(y3);
            for (int w = 0; w < 8; ++w) x3[w] ^= y3[w];
            store_words(px, x3, 8, n, lane);
        }
    }
}

// f.template run<OP>() for field op `op`; -1 for an unknown op.
template <class F>
int with_field_op(int op, F&& f) {
    switch (op) {
        case F_MUL: return f.template run<F_MUL>();
        case F_SQR: return f.template run<F_SQR>();
        case F_SUB: return f.template run<F_SUB>();
        case F_ADD: return f.template run<F_ADD>();
        case F_FOLD: return f.template run<F_FOLD>();
        case F_CANON: return f.template run<F_CANON>();
        case F_INV: return f.template run<F_INV>();
        case F_GATHER: return f.template run<F_GATHER>();
        case F_STEP: return f.template run<F_STEP>();
        default: return -1;
    }
}

// ---- P2: raw instruction chains ----

enum RawOp {
    R_U32ADD, R_U32MUL, R_MASK16, R_SHR16, R_I32MUL, R_F32ADD, R_F32MUL,
    R_F32FMA, R_WIDE, R_LAYOUT, R_EMPTY, R_NOPS
};

template <int OP>
struct RawType {
    using type = uint32_t;
};
template <>
struct RawType<R_F32ADD> {
    using type = float;
};
template <>
struct RawType<R_F32MUL> {
    using type = float;
};
template <>
struct RawType<R_F32FMA> {
    using type = float;
};

// One iteration i of chain (a, b).  The probe_ops rows (as
// scripts/probe_ops.py): a <- op(a, b) + mix(i), then b <- a ^ b (u32),
// a + 1 (i32, f32).  R_WIDE is the 32x32->64 multiply-add field.cuh is
// built from, split into its halves.  The layout rows (as
// scripts/layout_probe.py): x <- x * (x ^ (i + 1)) + 1, and the loop
// alone, x <- x + 1 (which the compilers sum in closed form: the launch
// and memory floor).
template <int OP, class T>
KT_HD void raw_iter(T& a, T& b, int i) {
    const uint32_t u = (uint32_t)i;
    if constexpr (OP == R_U32ADD) {
        a = (a + b) + u;
        b = a ^ b;
    } else if constexpr (OP == R_U32MUL) {
        a = a * b + u;
        b = a ^ b;
    } else if constexpr (OP == R_MASK16) {
        a = (a & 0xFFFFu) + u;
        b = a ^ b;
    } else if constexpr (OP == R_SHR16) {
        a = (a >> 16) + u;
        b = a ^ b;
    } else if constexpr (OP == R_I32MUL) {
        a = a * b + u;  // the int32 product's bits, without signed overflow
        b = a + 1u;
    } else if constexpr (OP == R_WIDE) {
        const uint64_t w = (uint64_t)a * b + u;
        a = (uint32_t)w + (uint32_t)(w >> 32);
        b = a ^ b;
    } else if constexpr (OP == R_LAYOUT) {
        a = a * (a ^ (u + 1u)) + 1u;
    } else if constexpr (OP == R_EMPTY) {
        a = a + 1u;
    } else {
        const float m = KT_FADD(1.0f, KT_FMUL((float)i, 1e-9f));
        if constexpr (OP == R_F32ADD)
            a = KT_FADD(KT_FADD(a, b), m);
        else if constexpr (OP == R_F32MUL)
            a = KT_FADD(KT_FMUL(a, b), m);
        else
            a = KT_FADD(KT_FMA(a, b, b), m);
        b = KT_FADD(a, 1.0f);
    }
}

// Thread tid of nthreads runs ILP chains, on elements tid + k * nthreads
// (neighbouring threads on neighbouring elements), in place.  The
// probe_ops rows store a + b, the layout rows x.
template <int OP, int ILP>
KT_HD void raw_chain_thread(typename RawType<OP>::type* x, size_t tid,
                            size_t nthreads, int inner) {
    using T = typename RawType<OP>::type;
    T a[ILP], b[ILP];
    for (int k = 0; k < ILP; ++k) a[k] = b[k] = x[tid + k * nthreads];
    for (int i = 0; i < inner; ++i)
        for (int k = 0; k < ILP; ++k) raw_iter<OP>(a[k], b[k], i);
    for (int k = 0; k < ILP; ++k) {
        if constexpr (OP == R_LAYOUT || OP == R_EMPTY)
            x[tid + k * nthreads] = a[k];
        else if constexpr (OP == R_F32ADD || OP == R_F32MUL ||
                           OP == R_F32FMA)
            x[tid + k * nthreads] = KT_FADD(a[k], b[k]);
        else
            x[tid + k * nthreads] = a[k] + b[k];
    }
}

// f.template run<OP, ILP>() for the (op, ILP) pairs the probes run: the
// probe_ops rows at ILP 4, the layout chain at the ILPs of the
// layout_probe variants, the empty loop at ILP 1; -1 for another pair.
template <class F>
int with_raw_chain(int op, int ilp, F&& f) {
    if (op == R_LAYOUT) {
        switch (ilp) {
            case 1: return f.template run<R_LAYOUT, 1>();
            case 2: return f.template run<R_LAYOUT, 2>();
            case 4: return f.template run<R_LAYOUT, 4>();
            case 16: return f.template run<R_LAYOUT, 16>();
            default: return -1;
        }
    }
    if (op == R_EMPTY) return ilp == 1 ? f.template run<R_EMPTY, 1>() : -1;
    if (ilp != 4) return -1;
    switch (op) {
        case R_U32ADD: return f.template run<R_U32ADD, 4>();
        case R_U32MUL: return f.template run<R_U32MUL, 4>();
        case R_MASK16: return f.template run<R_MASK16, 4>();
        case R_SHR16: return f.template run<R_SHR16, 4>();
        case R_I32MUL: return f.template run<R_I32MUL, 4>();
        case R_F32ADD: return f.template run<R_F32ADD, 4>();
        case R_F32MUL: return f.template run<R_F32MUL, 4>();
        case R_F32FMA: return f.template run<R_F32FMA, 4>();
        case R_WIDE: return f.template run<R_WIDE, 4>();
        default: return -1;
    }
}

// ---- P3: walk variants (walk_thread<false, V>) ----

struct NoInv : Production {
    static constexpr bool no_inv = true;
};
struct NoSqr : Production {
    static constexpr bool no_sqr = true;
};
struct NoY3Mul : Production {
    static constexpr bool no_y3mul = true;
};
struct ExtraMul : Production {
    static constexpr bool extra_mul = true;
};
struct ExtraSub : Production {
    static constexpr bool extra_sub = true;
};
struct NoDp : Production {
    static constexpr bool no_dp = true;
};
struct FixedGather : Production {
    static constexpr bool fixed_gather = true;
};
struct ExtraTraffic : Production {
    static constexpr bool extra_traffic = true;
};

// The variants by id: base, no_inv, no_sqr, no_y3mul, extra_mul,
// extra_sub, no_dp, fixed_gather, extra_traffic.
using DeltaVariants = std::tuple<Production, NoInv, NoSqr, NoY3Mul, ExtraMul,
                                 ExtraSub, NoDp, FixedGather, ExtraTraffic>;
constexpr int DELTA_NVARIANTS = (int)std::tuple_size<DeltaVariants>::value;

template <int LO, class F, int... I>
int with_delta_variant_seq(int id, F& f, std::integer_sequence<int, I...>) {
    int rc = -1;
    ((id == LO + I
          ? (void)(rc = f(std::tuple_element_t<LO + I, DeltaVariants>{}))
          : (void)0),
     ...);
    return rc;
}

// Whether variant `id` is built at G lanes per thread: base at every G
// of with_group (the G sweep), the others at the walk kernels' GROUP.
inline bool delta_has_group(int id, int group) {
    return group == GROUP
        || (id == 0 && with_group(group, [](auto) { return 0; }) == 0);
}

// f(V{}) for the variant with id `id` among ids LO..HI-1 (all of them
// by default; only those are instantiated); returns f's result, or -1
// for another id.
template <int LO = 0, int HI = DELTA_NVARIANTS, class F>
int with_delta_variant(int id, F&& f) {
    return with_delta_variant_seq<LO>(id, f,
                                      std::make_integer_sequence<int, HI - LO>{});
}

// ---- P4: batch-inversion chains ----

enum InvVariant { INV_CUR, INV_NODIV, INV_NONE, INV_NVARIANTS };

// y <- canon(y - x) | 1: the chain's step from fn(x) = y back to x.
// The | 1 sets the low bit of every 16-bit limb, as scripts/pkinv.py's
// does on its (16, W) limb array.
KT_HD void inv_chain_next(uint32_t y[8], const uint32_t x[8]) {
    fe_sub(y, y, x);
    fe_canon(y);
    for (int w = 0; w < 8; ++w) y[w] |= 0x00010001u;
}

// `iters` rounds for thread t of block blk, which owns lanes
// blk * THREADS * G + g * THREADS + t, g < G (the walk's layout), in
// place.  cur: Montgomery's trick over the G lanes (prefix products,
// one fe_inv -- the walk's safegcd --, the unwind); nodiv: the same with
// fe_inv replaced by a copy; none: fn(x) = x - x.
template <int VAR, int G>
KT_HD void inv_chain_thread(int32_t* px, size_t n, size_t blk, int t,
                            int iters, uint32_t (*acc)[8]) {
    const size_t base = blk * (size_t)(THREADS * G) + (size_t)t;
    for (int it = 0; it < iters; ++it) {
        uint32_t x[8], y[8], inv[8];
        if constexpr (VAR == INV_NONE) {
            for (int g = 0; g < G; ++g) {
                const size_t lane = base + (size_t)g * THREADS;
                load_words(x, 8, px, n, lane);
                fe_sub(y, x, x);
                inv_chain_next(y, x);
                store_words(px, y, 8, n, lane);
            }
        } else {
            for (int g = 0; g < G; ++g) {
                load_words(x, 8, px, n, base + (size_t)g * THREADS);
                if (g == 0)
                    fe_copy(acc[0], x);
                else
                    fe_mul(acc[g], acc[g - 1], x);
            }
            if constexpr (VAR == INV_CUR)
                fe_inv(inv, acc[G - 1]);
            else
                fe_copy(inv, acc[G - 1]);
            for (int g = G - 1; g >= 0; --g) {
                const size_t lane = base + (size_t)g * THREADS;
                load_words(x, 8, px, n, lane);
                if (g > 0) {
                    fe_mul(y, inv, acc[g - 1]);
                    fe_mul(inv, inv, x);
                } else {
                    fe_copy(y, inv);
                }
                inv_chain_next(y, x);
                store_words(px, y, 8, n, lane);
            }
        }
    }
}

// f(kernel-or-body for <VAR, G>) over the instantiated pairs: cur and
// nodiv at G in {32, 64, 128, 256}, none at 128; -1 for another pair.
template <class F>
int with_inv_variant(int var, int group, F&& f) {
    if (var == INV_NONE)
        return group == GROUP ? f.template run<INV_NONE, GROUP>() : -1;
    if (var == INV_CUR) {
        switch (group) {
            case 32: return f.template run<INV_CUR, 32>();
            case 64: return f.template run<INV_CUR, 64>();
            case 128: return f.template run<INV_CUR, 128>();
            case 256: return f.template run<INV_CUR, 256>();
        }
    } else if (var == INV_NODIV) {
        switch (group) {
            case 32: return f.template run<INV_NODIV, 32>();
            case 64: return f.template run<INV_NODIV, 64>();
            case 128: return f.template run<INV_NODIV, 128>();
            case 256: return f.template run<INV_NODIV, 256>();
        }
    }
    return -1;
}

}  // namespace kt
