// Per-thread bodies of the probe kernels (probe_kernels.cu), written as
// __host__ __device__ C++ like the walk body, so that g++ runs the same
// code on the CPU in the tests (host_shim.cpp).
//
//   P1 field chains: a <- op(a, b) `rounds` times, one lane per thread
//      (field.cuh's ops, the jump-table gather), or a jump step without
//      DP or distance over a thread's GROUP lanes with its grouped
//      inversion (the walk's geometry).
//   P2 raw chains: one 32-bit instruction per element and iteration,
//      ILP independent chains per thread, the loop index mixed in;
//      trips of RAW_TRIP element-iterations unrolled.
//   P3 is walk_thread itself with a variant type (walk.cuh), and base
//      also at G = 32 and 128; the variants are defined here.
//   P4 inversion chains: the walk's per-thread Montgomery inversion
//      over G lanes, x <- canon(fn(x) - x) | 1 `iters` times, in the
//      walk's layout (state in device and local memory) and in an
//      on-chip form (state in shared memory for the whole launch).
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
    R_F32FMA, R_WIDE, R_LAYOUT, R_EMPTY, R_SHR16_MIX, R_SHR16_HI, R_NOPS
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

#if defined(__CUDA_ARCH__)
#define KT_UNROLL _Pragma("unroll")
#define KT_NO_UNROLL _Pragma("unroll 1")
#else
#define KT_UNROLL
#define KT_NO_UNROLL
#endif

// hi32(a * b) + c: on the card one PTX mad.hi.u32.  ptxas issues it as
// IMAD.HI.U32 (two slots of the multiply-add pipe: half that pipe's
// IMAD rate, probes/probe_ops.py's shr16_hi) where b is a register it
// cannot read as a constant, and turns b = 2^16 into a shift-and-add
// (LEA.HI, one ALU-pipe slot at that pipe's rate).  On the host its
// twin: the same word.
KT_HD uint32_t mulhi_add(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
    uint32_t d;
    asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
#else
    return (uint32_t)(((uint64_t)a * b) >> 32) + c;
#endif
}

// a ^ b ^ c: on the card one PTX lop3.b32 (LOP3.LUT 0x96), so that the
// layout chain's xor with its index, base ^ (j + 1), stays one LOP3
// with base in a register and j + 1 an immediate (written as two xors,
// nvcc may compute the index once for a thread's chains with an add of
// its own); on the host its twin.
KT_HD uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
#if defined(__CUDA_ARCH__)
    uint32_t d;
    asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
#else
    return a ^ b ^ c;
#endif
}

// The multiplier of shr16's shift-and-add: mulhi_add(a, SHR_MUL, u) is
// (a >> 16) + u.  A launch passes it as an argument too, so that the
// chains meant for the multiply-add pipe keep their IMAD.HI.
constexpr uint32_t SHR_MUL = 1u << 16;

// Chains of a shr16 thread (ILP) whose shift-and-add runs on the
// multiply-add pipe (IMAD.HI, from the launch's multiplier); the others
// take the constant and run on the ALU pipe (LEA.HI).  shr16 is all
// LEA.HI: its LOP3s and LEA.HIs fill the ALU pipe, and the split that
// bound_ms assumes does not pay, since IMAD.HI takes two slots of the
// multiply-add pipe and ptxas gives each IMAD.HI its own copy of the
// uniform index there (IMAD.U32): shr16_mix (SHR16_MIX_CHAINS of the
// chains on IMAD.HI, the best split measured) and shr16_hi (all) show
// it.
constexpr int SHR16_MIX_CHAINS = 1;
template <int OP, int ILP>
constexpr int raw_hi_chains() {
    return OP == R_SHR16_HI ? ILP : OP == R_SHR16_MIX ? SHR16_MIX_CHAINS : 0;
}

// Element-iterations of a thread in one trip of a raw chain's loop: the
// trip unrolls RAW_TRIP / ILP iterations (the empty loop RAW_TRIP, as
// narrow1), so that the loop's counter, compare and branch, and the
// latency of its branch, are paid once a trip.
constexpr int RAW_TRIP = 128;

// The index term of iteration i = base + j of a trip of U iterations,
// base a multiple of U, as a pair (t, c) whose xor it is: i for the
// probe_ops rows, i + 1 for the layout chain.  There i + 1 = base ^
// (j + 1), base's low bits being 0, but at the trip's last iteration,
// where it is base + U, the next trip's base (the loop counter): the
// chain's three-input LOP3 (xor3) takes j + 1 as an immediate, and no
// instruction computes the index.
template <int OP, int U>
KT_HD void raw_index(uint32_t base, int j, uint32_t& t, uint32_t& c) {
    if constexpr (OP == R_LAYOUT) {
        t = j + 1 < U ? base : base + (uint32_t)U;
        c = j + 1 < U ? (uint32_t)(j + 1) : 0u;
    } else {
        t = base + (uint32_t)j;
        c = 0u;
    }
}

// One iteration of chain (a, b) with index term u ^ c (raw_index; c is
// 0 but in the layout chain's trips) and, for the shr16 rows, the
// multiplier mul of mulhi_add.  The probe_ops rows
// (as scripts/probe_ops.py): a <- op(a, b) + mix(i), then b <- a ^ b
// (u32), a + 1 (i32, f32).  R_WIDE is the 32x32->64 multiply-add
// field.cuh is built from, split into its halves.  The layout rows (as
// scripts/layout_probe.py): x <- x * (x ^ (i + 1)) + 1, and the loop
// alone, x <- x + 1 (the compilers add a trip's ones at once).
template <int OP, class T>
KT_HD void raw_iter(T& a, T& b, uint32_t u, uint32_t c, uint32_t mul) {
    if constexpr (OP == R_U32ADD) {
        a = (a + b) + u;
        b = a ^ b;
    } else if constexpr (OP == R_U32MUL) {
        a = a * b + u;
        b = a ^ b;
    } else if constexpr (OP == R_MASK16) {
        a = (a & 0xFFFFu) + u;
        b = a ^ b;
    } else if constexpr (OP == R_SHR16 || OP == R_SHR16_MIX ||
                         OP == R_SHR16_HI) {
        a = mulhi_add(a, mul, u);  // (a >> 16) + u
        b = a ^ b;
    } else if constexpr (OP == R_I32MUL) {
        a = a * b + u;  // the int32 product's bits, without signed overflow
        b = a + 1u;
    } else if constexpr (OP == R_WIDE) {
        const uint64_t w = (uint64_t)a * b + u;
        a = (uint32_t)w + (uint32_t)(w >> 32);
        b = a ^ b;
    } else if constexpr (OP == R_LAYOUT) {
        a = a * xor3(a, u, c) + 1u;
    } else if constexpr (OP == R_EMPTY) {
        a = a + 1u;
    } else {
        const float m = KT_FADD(1.0f, KT_FMUL((float)(int)u, 1e-9f));
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
// (neighbouring threads on neighbouring elements), in place: trips of U
// iterations unrolled and no further (the compilers would fold 16 of the
// empty loop's into one), then the inner % U left one at a time.  Chains
// k < H take the launch's multiplier mul (the shr16 contrasts' IMAD.HI
// chains), the others SHR_MUL.  The probe_ops rows store a + b, the
// layout rows x.
template <int OP, int ILP>
KT_HD void raw_chain_thread(typename RawType<OP>::type* x, size_t tid,
                            size_t nthreads, int inner, uint32_t mul) {
    using T = typename RawType<OP>::type;
    constexpr int U = RAW_TRIP / ILP;
    constexpr int H = raw_hi_chains<OP, ILP>();
    T a[ILP], b[ILP];
    KT_UNROLL
    for (int k = 0; k < ILP; ++k) a[k] = b[k] = x[tid + k * nthreads];
    int i = 0;
    KT_NO_UNROLL
    for (; i + U <= inner; i += U) {
        KT_UNROLL
        for (int j = 0; j < U; ++j) {
            uint32_t u, c;
            raw_index<OP, U>((uint32_t)i, j, u, c);
            KT_UNROLL
            for (int k = 0; k < ILP; ++k)
                raw_iter<OP>(a[k], b[k], u, c, k < H ? mul : SHR_MUL);
        }
    }
    for (; i < inner; ++i) {
        const uint32_t u = (uint32_t)i + (OP == R_LAYOUT ? 1u : 0u);
        KT_UNROLL
        for (int k = 0; k < ILP; ++k)
            raw_iter<OP>(a[k], b[k], u, 0u, k < H ? mul : SHR_MUL);
    }
    KT_UNROLL
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
        case R_SHR16_MIX: return f.template run<R_SHR16_MIX, 4>();
        case R_SHR16_HI: return f.template run<R_SHR16_HI, 4>();
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

// ---- P4, on-chip form: the state never leaves the SM ----
//
// The same chain on the same lane sets as inv_chain_thread (thread t of
// block blk owns lanes blk * THREADS * G + g * THREADS + t, g < G), so
// that its output equals the walk layout's at the same G.  What differs
// is where the state lives: the thread's G lanes of x and their prefix
// products stay in shared memory for the whole launch, so that x is
// read from device memory once and written once and nothing goes to
// local memory.  Each 32-byte slot s of thread t lies word-transposed,
// word w at sm[(s * 8 + w) * THREADS + t], so that a warp's 32 threads
// touch 32 consecutive words (no bank conflict); no thread reads
// another's slots, so the body needs no barrier.
//
// Shared memory, not the registers, bounds the lanes an SM holds: ~4096
// at 56 B a lane.  So one block of 4 warps an SM runs G = 32, too few
// warps to hide a multiply chain's latency.  The thread's G lanes are
// therefore K = G / CHIP_RUN runs of CHIP_RUN consecutive slots whose
// prefix products advance side by side (K independent multiply chains);
// Montgomery's trick over the K run products in registers leaves one
// fe_inv a thread.  Slots 0..G-1 hold x (each overwritten by its next
// value in the unwind, after its last read); run k's prefix products
// acc[1..CHIP_RUN-2] lie at slots G + k * (CHIP_RUN - 2) + 0.. (its
// acc[0] is x's slot, its last product stays in registers).  none keeps
// x only.
//
// Shared memory a block: InvChip::slots x 32 B x THREADS; with 1 KB
// reserved a block and 228 KB an SM that gives 2 and 1 resident blocks
// of cur and nodiv at G = 16, 32 (K = 2, 4): 4096 lanes an SM each
// time.  min_blocks is what the kernel's launch bounds ask for, so that
// its registers do not hold it below that.
constexpr int CHIP_RUN = 8;

template <int VAR, int G>
struct InvChip {
    static_assert(G % CHIP_RUN == 0, "G is a whole number of runs");
    static constexpr int runs = G / CHIP_RUN;
    static constexpr int slots =
        VAR == INV_NONE ? G : G + runs * (CHIP_RUN - 2);
    static constexpr int smem = slots * 32 * THREADS;
    static constexpr int min_blocks = (228 * 1024) / (smem + 1024);
};

KT_HD void chip_load(uint32_t r[8], const uint32_t* sm, int s, int t) {
    for (int w = 0; w < 8; ++w) r[w] = sm[(s * 8 + w) * THREADS + t];
}

KT_HD void chip_store(uint32_t* sm, const uint32_t r[8], int s, int t) {
    for (int w = 0; w < 8; ++w) sm[(s * 8 + w) * THREADS + t] = r[w];
}

// `iters` rounds for thread t of block blk on its G lanes of x (16, n),
// in place; sm is the block's shared memory (InvChip<VAR, G>::smem
// bytes).
template <int VAR, int G>
KT_HD void inv_chip_thread(int32_t* px, size_t n, size_t blk, int t,
                           int iters, uint32_t* sm) {
    constexpr int K = InvChip<VAR, G>::runs, L = CHIP_RUN;
    const size_t base = blk * (size_t)(THREADS * G) + (size_t)t;
    uint32_t x[8], y[8];
    for (int g = 0; g < G; ++g) {
        load_words(x, 8, px, n, base + (size_t)g * THREADS);
        chip_store(sm, x, g, t);
    }
    for (int it = 0; it < iters; ++it) {
        if constexpr (VAR == INV_NONE) {
#if defined(__CUDA_ARCH__)
#pragma unroll 4
#endif
            for (int g = 0; g < G; ++g) {
                chip_load(x, sm, g, t);
                fe_sub(y, x, x);
                inv_chain_next(y, x);
                chip_store(sm, y, g, t);
            }
        } else {
            // prod[k]: run k's prefix product, then its whole product;
            // inv[k]: the products of runs 0..k, then the inverse of run
            // k's running prefix in the unwind
            uint32_t prod[K][8], inv[K][8];
            KT_UNROLL
            for (int k = 0; k < K; ++k) chip_load(prod[k], sm, k * L, t);
            for (int j = 1; j < L; ++j) {
                KT_UNROLL
                for (int k = 0; k < K; ++k) {
                    chip_load(x, sm, k * L + j, t);
                    fe_mul(prod[k], prod[k], x);
                    if (j < L - 1)
                        chip_store(sm, prod[k], G + k * (L - 2) + j - 1, t);
                }
            }
            fe_copy(inv[0], prod[0]);
            KT_UNROLL
            for (int k = 1; k < K; ++k) fe_mul(inv[k], inv[k - 1], prod[k]);
            if constexpr (VAR == INV_CUR)
                fe_inv(y, inv[K - 1]);
            else
                fe_copy(y, inv[K - 1]);
            KT_UNROLL
            for (int k = K - 1; k > 0; --k) {
                fe_mul(inv[k], y, inv[k - 1]);
                fe_mul(y, y, prod[k]);
            }
            fe_copy(inv[0], y);
            for (int j = L - 1; j > 0; --j) {
                KT_UNROLL
                for (int k = 0; k < K; ++k) {
                    chip_load(x, sm, k * L + j, t);
                    chip_load(y, sm, j == 1 ? k * L : G + k * (L - 2) + j - 2,
                              t);
                    fe_mul(y, inv[k], y);
                    fe_mul(inv[k], inv[k], x);
                    inv_chain_next(y, x);
                    chip_store(sm, y, k * L + j, t);
                }
            }
            KT_UNROLL
            for (int k = 0; k < K; ++k) {
                chip_load(x, sm, k * L, t);
                inv_chain_next(inv[k], x);
                chip_store(sm, inv[k], k * L, t);
            }
        }
    }
    for (int g = 0; g < G; ++g) {
        chip_load(x, sm, g, t);
        store_words(px, x, 8, n, base + (size_t)g * THREADS);
    }
}

// f.template run<VAR, G>() over the on-chip form's instantiated pairs:
// every variant at G in {16, 32}; -1 for another pair.
template <class F>
int with_inv_chip(int var, int group, F&& f) {
    if (var < 0 || var >= INV_NVARIANTS) return -1;
    auto at = [&](auto vc) {
        constexpr int V = decltype(vc)::value;
        switch (group) {
            case 16: return f.template run<V, 16>();
            case 32: return f.template run<V, 32>();
            default: return -1;
        }
    };
    switch (var) {
        case INV_CUR: return at(std::integral_constant<int, INV_CUR>{});
        case INV_NODIV: return at(std::integral_constant<int, INV_NODIV>{});
        default: return at(std::integral_constant<int, INV_NONE>{});
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
