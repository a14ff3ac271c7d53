// secp256k1 field arithmetic for the walk kernel, 8 x 32-bit words.
//
// Plain C++ marked __host__ __device__: nvcc builds it into the walk
// kernel (jump_kernel.cu) and g++ builds the very same code for the
// CPU tests (host_shim.cpp), so the kernel's own arithmetic is checked
// without a card.  The add-class ops (fe_fold, fe_add, fe_sub_c,
// fe_sub) are carry chains written once over the six one-word carry
// primitives below, and so are the words of the multiply-class ops
// (fe_mul, fe_sqr, fe_reduce512), which add wide products up: on the
// device each primitive is one PTX carry instruction (add.cc.u32 ...
// subc.u32) in inline PTX, on the host a C++ twin with the same carry
// semantics, so the g++ build checks the chains themselves
// (tests/test_torch_field_cuh.py holds them against Python ints, on
// every carry pattern of tests/carry_cases.py, and against the JAX
// package) and only the primitives differ.  No other inline PTX.
//
// A field element is uint32_t[8], least-significant word first.  Word w
// holds the 16-bit limbs 2w (low half) and 2w+1 (high half) of the
// (16, N) limb layout used at the Python functions.  Values are relaxed
// (any representative < 2^256) unless a function says canonical (< p).
// Reduction folds with 2^256 == K1C = 2^32 + 977 (mod p).
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define KT_HD __host__ __device__ __forceinline__
#else
#define KT_HD inline
#endif

// full unrolling of a chain's word loop, so that its words stay in
// registers
#if defined(__CUDA_ARCH__)
#define KT_UNROLL _Pragma("unroll")
#else
#define KT_UNROLL
#endif

namespace kt {

constexpr uint32_t C_LOW = 977u;  // K1C = 2^32 + C_LOW

KT_HD void fe_copy(uint32_t r[8], const uint32_t a[8]) {
    for (int i = 0; i < 8; ++i) r[i] = a[i];
}

// ---- one-word carry primitives ----
//
// A chain is a run of calls on one Carry: add_cc or sub_cc starts it,
// each *_cc call passes the flag on, addc or subc ends it.  The flag is
// the carry of a + b, or of a + ~b + 1 for a - b (1 where there is no
// borrow), as the card keeps it; so an add chain's carry is read as
// addc(cy, 0, 0) (0 or 1) and a sub chain's borrow as subc(cy, 0, 0) (0
// or all ones), and the families are not mixed: addc after sub.cc reads
// the borrow's complement.  On the device the flag is PTX's CC.CF and
// `cy` is not read: each call is an asm volatile, so a chain's
// instructions stay in program order, and the compiler emits no carry
// instruction of its own between them.  On the host the flag is cy.cf,
// kept the same way, so a chain that mixed the families fails on the
// host too.
struct Carry {
    uint32_t cf = 0;
};

KT_HD uint32_t add_cc(Carry& cy, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    uint32_t r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
#else
    const uint32_t r = a + b;
    cy.cf = r < a;
    return r;
#endif
}

KT_HD uint32_t addc_cc(Carry& cy, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    uint32_t r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
#else
    const uint64_t s = (uint64_t)a + b + cy.cf;
    cy.cf = (uint32_t)(s >> 32);
    return (uint32_t)s;
#endif
}

KT_HD uint32_t addc(Carry& cy, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    uint32_t r;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
#else
    return a + b + cy.cf;
#endif
}

KT_HD uint32_t sub_cc(Carry& cy, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    uint32_t r;
    asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
#else
    cy.cf = a >= b;
    return a - b;
#endif
}

KT_HD uint32_t subc_cc(Carry& cy, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    uint32_t r;
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
#else
    const uint64_t d = (uint64_t)a + (uint32_t)~b + cy.cf;
    cy.cf = (uint32_t)(d >> 32);
    return (uint32_t)d;
#endif
}

KT_HD uint32_t subc(Carry& cy, uint32_t a, uint32_t b) {
#if defined(__CUDA_ARCH__)
    uint32_t r;
    asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
#else
    return a + ~b + cy.cf;
#endif
}

// ---- add-class ops: carry chains, no data-dependent branch ----

// r += w0 + w1 2^32 + w2 2^64 over the 8 words; returns the carry out
// of 2^256 (0 or 1).
KT_HD uint32_t add3_words(uint32_t r[8], uint32_t w0, uint32_t w1,
                          uint32_t w2) {
    Carry cy;
    r[0] = add_cc(cy, r[0], w0);
    r[1] = addc_cc(cy, r[1], w1);
    r[2] = addc_cc(cy, r[2], w2);
    KT_UNROLL
    for (int i = 3; i < 8; ++i) r[i] = addc_cc(cy, r[i], 0u);
    return addc(cy, 0u, 0u);
}

// r += k * K1C for k < 2^34, then once more for the (0/1) carry out of
// 2^256.  k * K1C = k * 977 + k * 2^32 spans words 0-2: with k = kl +
// kh 2^32 (kh < 4), word 0 is the low half of the wide product kl *
// 977, word 1 its high half + kh * 977 + kl (< 2^10 + 2^12 + 2^32, so
// it may carry), word 2 kh and that carry.  After a carry out the low
// part is < 2^67, so the second pass reaches word 2 and no further.
// Result < 2^256, congruent to r + k*2^256.
KT_HD void fe_fold(uint32_t r[8], uint64_t k) {
    const uint32_t kl = (uint32_t)k, kh = (uint32_t)(k >> 32);
    const uint64_t w = (uint64_t)kl * C_LOW;
    Carry cy;
    const uint32_t w1 = add_cc(cy, (uint32_t)(w >> 32) + kh * C_LOW, kl);
    const uint32_t w2 = addc(cy, kh, 0u);
    const uint32_t k2 = add3_words(r, (uint32_t)w, w1, w2);
    r[0] = add_cc(cy, r[0], k2 * C_LOW);
    r[1] = addc_cc(cy, r[1], k2);
    r[2] = addc(cy, r[2], 0u);
}

// r = (a + b) mod p, relaxed: the 8-word sum, its carry c folded (r +=
// c * K1C), and that pass's carry out folded once more: after it r <
// K1C, so the second pass ends at word 1.
KT_HD void fe_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    Carry cy;
    r[0] = add_cc(cy, a[0], b[0]);
    KT_UNROLL
    for (int i = 1; i < 8; ++i) r[i] = addc_cc(cy, a[i], b[i]);
    const uint32_t c = addc(cy, 0u, 0u);
    const uint32_t c2 = add3_words(r, c * C_LOW, c, 0u);
    r[0] = add_cc(cy, r[0], c2 * C_LOW);
    r[1] = addc(cy, r[1], c2);
}

// r -= k * K1C (k in {0, 1}) over the 8 words; returns the borrow out
// of 2^256 (0 or 1).
KT_HD uint32_t fe_sub_c(uint32_t r[8], uint32_t k) {
    Carry cy;
    r[0] = sub_cc(cy, r[0], k * C_LOW);
    r[1] = subc_cc(cy, r[1], k);
    KT_UNROLL
    for (int i = 2; i < 8; ++i) r[i] = subc_cc(cy, r[i], 0u);
    return subc(cy, 0u, 0u) & 1u;
}

// r = (a - b) mod p, relaxed, for any a, b < 2^256.  A borrow means the
// 256-bit difference wrapped by 2^256; adding p is subtracting K1C
// modulo 2^256 (fe_sub_c).  That borrows again only when the wrapped
// difference was < K1C (b - a > p); then r >= 2^256 - K1C, so the
// second subtraction of K1C ends at word 1 without a borrow.
KT_HD void fe_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    Carry cy;
    r[0] = sub_cc(cy, a[0], b[0]);
    KT_UNROLL
    for (int i = 1; i < 8; ++i) r[i] = subc_cc(cy, a[i], b[i]);
    const uint32_t k = subc(cy, 0u, 0u) & 1u;
    const uint32_t k2 = fe_sub_c(r, k);
    r[0] = sub_cc(cy, r[0], k2 * C_LOW);
    r[1] = subc(cy, r[1], k2);
}

// ---- multiply-class ops: wide products and add chains ----
//
// A wide product a * b (a, b < 2^32) is one IMAD.WIDE.U32 on the card:
// both its words in two issue slots of the multiply-add pipe.  A row of
// them, a * b[0..N-1], is N + 1 words once word j adds the low half of
// product j to the high half of product j - 1: one add chain, which the
// card issues on its ALU pipe, beside the products.  A second chain adds
// the row into the running sum.  So every word of every product is
// added once, by a carry instruction off the multiply-add pipe (a
// 64-bit accumulator's carries took slots there as IMAD.X).  A row
// computes its products first and then runs its chains:
// nothing but chain primitives stands between an instruction that sets
// the carry and the one that reads it, and g++ runs the same chains over
// the primitives' twins.

KT_HD uint32_t lo32(uint64_t p) { return (uint32_t)p; }
KT_HD uint32_t hi32(uint64_t p) { return (uint32_t)(p >> 32); }

// s[0..N] = a * b[0..N-1]
template <int N>
KT_HD void row_product(uint32_t* s, uint32_t a, const uint32_t* b) {
    uint64_t p[N];
    KT_UNROLL
    for (int j = 0; j < N; ++j) p[j] = (uint64_t)a * b[j];
    s[0] = lo32(p[0]);
    if constexpr (N == 1) {
        s[1] = hi32(p[0]);
    } else {
        Carry cy;
        s[1] = add_cc(cy, lo32(p[1]), hi32(p[0]));
        KT_UNROLL
        for (int j = 2; j < N; ++j)
            s[j] = addc_cc(cy, lo32(p[j]), hi32(p[j - 1]));
        // a * b < 2^(32 (N + 1)): the top word takes the last carry
        s[N] = addc(cy, hi32(p[N - 1]), 0u);
    }
}

// r[0..N] = a * b[0..N-1] + r[0..N-1]; r[N] is written, not read, and
// the caller knows the sum fits in N + 1 words.  FIRST: r[0..N-1] are 0
// and not read either.
template <int N, bool FIRST = false>
KT_HD void row_mul_add(uint32_t* r, uint32_t a, const uint32_t* b) {
    uint32_t s[N + 1];
    row_product<N>(s, a, b);
    if constexpr (FIRST) {
        KT_UNROLL
        for (int j = 0; j <= N; ++j) r[j] = s[j];
    } else {
        Carry cy;
        r[0] = add_cc(cy, r[0], s[0]);
        KT_UNROLL
        for (int j = 1; j < N; ++j) r[j] = addc_cc(cy, r[j], s[j]);
        r[N] = addc(cy, s[N], 0u);
    }
}

// r = t mod p, relaxed, for a 512-bit t (16 words): fold the high half,
// T_hi * 2^256 == T_hi * 977 + T_hi * 2^32.  Here each wide product
// takes its word of T_lo as the addend, 977 t[8 + i] + t[i] < 2^42, and
// one add chain joins them into w = T_lo + 977 T_hi < 978 * 2^256 (a
// top word w[8] below 978); T_hi added one word up (words 1-8) leaves
// above 2^256 k = w[8] + t[15] + a carry < 2^32 + 979, within fe_fold's
// k < 2^34.
KT_HD void fe_reduce512(uint32_t r[8], const uint32_t t[16]) {
    uint64_t p[8];
    KT_UNROLL
    for (int i = 0; i < 8; ++i) p[i] = (uint64_t)t[8 + i] * C_LOW + t[i];
    uint32_t w[9];
    Carry cy;
    w[0] = lo32(p[0]);
    w[1] = add_cc(cy, lo32(p[1]), hi32(p[0]));
    KT_UNROLL
    for (int i = 2; i < 8; ++i) w[i] = addc_cc(cy, lo32(p[i]), hi32(p[i - 1]));
    w[8] = addc(cy, hi32(p[7]), 0u);
    r[0] = w[0];
    r[1] = add_cc(cy, w[1], t[8]);
    KT_UNROLL
    for (int i = 2; i < 8; ++i) r[i] = addc_cc(cy, w[i], t[7 + i]);
    const uint32_t k = addc_cc(cy, w[8], t[15]);
    const uint32_t kh = addc(cy, 0u, 0u);
    fe_fold(r, ((uint64_t)kh << 32) | k);
}

// r = (a * b) mod p, relaxed: the 512-bit product as 8 rows (operand
// scanning: row i adds a[i] * b into words i..i+8), then fe_reduce512.
// After row i the product so far is < 2^(32 (i + 9)), so no row carries
// out of its top word.
KT_HD void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t t[16];
    row_mul_add<8, true>(t, a[0], b);
    KT_UNROLL
    for (int i = 1; i < 8; ++i) row_mul_add<8>(t + i, a[i], b);
    fe_reduce512(r, t);
}

// r = a^2 mod p, relaxed: the 28 cross products a[i] a[j] (i < j) as 7
// rows (row i adds a[i] * a[i+1..7] into words 2i+1..i+8; after it the
// sum is < 2^(32 (i + 9))), doubled by an add chain (the cross sum is <
// 2^511, so no bit is lost), plus the 8 squares a[i]^2 at words 2i,
// 2i+1 in one chain (the total is a^2 < 2^512); then fe_reduce512.
KT_HD void fe_sqr(uint32_t r[8], const uint32_t a[8]) {
    uint32_t t[16];
    row_mul_add<7, true>(t + 1, a[0], a + 1);
    row_mul_add<6>(t + 3, a[1], a + 2);
    row_mul_add<5>(t + 5, a[2], a + 3);
    row_mul_add<4>(t + 7, a[3], a + 4);
    row_mul_add<3>(t + 9, a[4], a + 5);
    row_mul_add<2>(t + 11, a[5], a + 6);
    row_mul_add<1>(t + 13, a[6], a + 7);
    uint64_t q[8];
    KT_UNROLL
    for (int i = 0; i < 8; ++i) q[i] = (uint64_t)a[i] * a[i];
    Carry cy;
    t[1] = add_cc(cy, t[1], t[1]);
    KT_UNROLL
    for (int i = 2; i < 15; ++i) t[i] = addc_cc(cy, t[i], t[i]);
    t[15] = addc(cy, 0u, 0u);
    t[0] = lo32(q[0]);
    t[1] = add_cc(cy, t[1], hi32(q[0]));
    KT_UNROLL
    for (int i = 2; i < 15; ++i)
        t[i] = addc_cc(cy, t[i], (i & 1) ? hi32(q[i >> 1]) : lo32(q[i >> 1]));
    t[15] = addc(cy, t[15], hi32(q[7]));
    fe_reduce512(r, t);
}

// Canonical form: subtract p once when r >= p (r + K1C carries out).
KT_HD void fe_canon(uint32_t r[8]) {
    uint32_t s[8];
    uint64_t c = (uint64_t)r[0] + C_LOW;
    s[0] = (uint32_t)c;
    c >>= 32;
    c += (uint64_t)r[1] + 1u;
    s[1] = (uint32_t)c;
    c >>= 32;
    for (int i = 2; i < 8; ++i) {
        c += r[i];
        s[i] = (uint32_t)c;
        c >>= 32;
    }
    if (c) fe_copy(r, s);
}

// ---- inversion: safegcd (Bernstein-Yang), constant time ----
//
// The counterpart of kangaroo_tpu/ops/field.py:806 modinv, in the form
// of libsecp256k1's modinv32: values as 9 signed 30-bit limbs (S30),
// 20 batches of 30 half-delta divsteps, each batch's 2x2 transition
// matrix of int32 entries applied to (f, g) and to the Bezout
// coefficients (d, e) mod p.  600 divsteps cover the 590 that any
// 256-bit input needs.  Every step is masks and adds, with no
// data-dependent branch, so the lanes of a warp never diverge.  The
// coefficients are kept exact mod p by adding a multiple of p that
// clears their low 30 bits before each shift (p^-1 mod 2^30), so no
// 2^-600 scale is left to undo (the TPU's modinv multiplies by one).

struct S30 {
    int32_t v[9];  // value = sum v[i] 2^(30 i); limbs in (-2^30, 2^30)
};

constexpr int32_t M30 = 0x3FFFFFFF;
constexpr int INV_BATCHES = 20;      // x 30 divsteps >= 590
constexpr uint32_t P_INV30 = 0x2DDACACFu;  // p^-1 mod 2^30
// p = -977 - 4 * 2^30 + 65536 * 2^240: limbs 0, 1 and 8, the rest zero
KT_HD int32_t p30(int i) { return i == 0 ? -977 : i == 1 ? -4 : i == 8 ? 65536 : 0; }

// 30 divsteps on the low words of f (odd) and g from zeta = -(delta +
// 1/2); returns the new zeta and the transition matrix t = (u, v, q,
// r), scaled by 2^30: [f', g'] 2^30 = [[u, v], [q, r]] [f, g].
KT_HD int32_t divsteps_30(int32_t zeta, uint32_t f, uint32_t g,
                          int32_t t[4]) {
    uint32_t u = 1, v = 0, q = 0, r = 1;
    for (int i = 0; i < 30; ++i) {
        const uint32_t neg = (uint32_t)(zeta >> 31);  // zeta < 0
        const uint32_t odd = 0u - (g & 1u);
        // g += +-f (and q, r with u, v) where g is odd: -f when zeta < 0
        g += ((f ^ neg) - neg) & odd;
        q += ((u ^ neg) - neg) & odd;
        r += ((v ^ neg) - neg) & odd;
        const uint32_t swap = neg & odd;
        zeta = (zeta ^ (int32_t)swap) - 1;  // -zeta - 2 on a swap
        f += g & swap;  // with g = g - f: f <- the old g
        u += q & swap;
        v += r & swap;
        g >>= 1;
        u <<= 1;
        v <<= 1;
    }
    t[0] = (int32_t)u;
    t[1] = (int32_t)v;
    t[2] = (int32_t)q;
    t[3] = (int32_t)r;
    return zeta;
}

// (d, e) <- t [d, e] / 2^30 mod p, with d, e in (-2p, p) kept there.
KT_HD void update_de_30(S30& d, S30& e, const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
    // md, me: multiples of p to add, start from [u, q] where d < 0 and
    // [v, r] where e < 0, then corrected so the low 30 bits clear
    int32_t md = (u & sd) + (v & se);
    int32_t me = (q & sd) + (r & se);
    int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
    int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
    md -= (int32_t)((P_INV30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
    me -= (int32_t)((P_INV30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
    cd += (int64_t)p30(0) * md;
    ce += (int64_t)p30(0) * me;
    cd >>= 30;  // the low 30 bits are zero
    ce >>= 30;
    for (int i = 1; i < 9; ++i) {
        const int32_t di = d.v[i], ei = e.v[i];
        cd += (int64_t)u * di + (int64_t)v * ei;
        ce += (int64_t)q * di + (int64_t)r * ei;
        if (p30(i)) {
            cd += (int64_t)p30(i) * md;
            ce += (int64_t)p30(i) * me;
        }
        d.v[i - 1] = (int32_t)cd & M30;
        cd >>= 30;
        e.v[i - 1] = (int32_t)ce & M30;
        ce >>= 30;
    }
    d.v[8] = (int32_t)cd;
    e.v[8] = (int32_t)ce;
}

// (f, g) <- t [f, g] / 2^30 (exact: the divsteps cleared 30 low bits).
KT_HD void update_fg_30(S30& f, S30& g, const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
    int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
    cf >>= 30;
    cg >>= 30;
    for (int i = 1; i < 9; ++i) {
        const int32_t fi = f.v[i], gi = g.v[i];
        cf += (int64_t)u * fi + (int64_t)v * gi;
        cg += (int64_t)q * fi + (int64_t)r * gi;
        f.v[i - 1] = (int32_t)cf & M30;
        cf >>= 30;
        g.v[i - 1] = (int32_t)cg & M30;
        cg >>= 30;
    }
    f.v[8] = (int32_t)cf;
    g.v[8] = (int32_t)cg;
}

// r <- r when sign >= 0, else -r, brought from (-2p, p) into [0, p):
// add p where negative, negate, propagate, add p where still negative,
// propagate (masks only).
KT_HD void normalize_30(S30& r, int32_t sign) {
    int32_t m = r.v[8] >> 31;
    for (int i = 0; i < 9; ++i) r.v[i] += p30(i) & m;
    const int32_t neg = sign >> 31;
    for (int i = 0; i < 9; ++i) r.v[i] = (r.v[i] ^ neg) - neg;
    for (int i = 0; i < 8; ++i) {
        r.v[i + 1] += r.v[i] >> 30;
        r.v[i] &= M30;
    }
    m = r.v[8] >> 31;
    for (int i = 0; i < 9; ++i) r.v[i] += p30(i) & m;
    for (int i = 0; i < 8; ++i) {
        r.v[i + 1] += r.v[i] >> 30;
        r.v[i] &= M30;
    }
}

// r = a^-1 mod p (inv(0) = 0), canonical, for any a < 2^256.
KT_HD void fe_inv(uint32_t r[8], const uint32_t a[8]) {
    uint32_t c[8];
    fe_copy(c, a);
    fe_canon(c);  // < 2^256 needs one subtraction of p at most
    S30 f, g, d, e;
    g.v[0] = (int32_t)(c[0] & (uint32_t)M30);
    for (int i = 1; i < 8; ++i)  // bits 30i.. = word i-1 from bit 32-2i
        g.v[i] = (int32_t)(((c[i - 1] >> (32 - 2 * i)) | (c[i] << (2 * i)))
                           & (uint32_t)M30);
    g.v[8] = (int32_t)(c[7] >> 16);
    for (int i = 0; i < 9; ++i) {
        f.v[i] = p30(i);
        d.v[i] = 0;
        e.v[i] = i == 0;
    }
    int32_t zeta = -1;  // delta = 1/2
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
    for (int b = 0; b < INV_BATCHES; ++b) {
        int32_t t[4];
        zeta = divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
        update_de_30(d, e, t);
        update_fg_30(f, g, t);
    }
    // g = 0 and f = +-1 (f = p, d = 0 for a = 0): d is +-a^-1
    normalize_30(d, f.v[8]);
    for (int w = 0; w < 8; ++w)  // bits 32w.. = limb w from bit 2w
        r[w] = ((uint32_t)d.v[w] >> (2 * w))
             | ((uint32_t)d.v[w + 1] << (30 - 2 * w));
}

// d = (d + e) mod 2^128 on 4-word device distances.
KT_HD void add_u128(uint32_t d[4], const uint32_t e[4]) {
    uint64_t c = 0;
    for (int i = 0; i < 4; ++i) {
        c += (uint64_t)d[i] + e[i];
        d[i] = (uint32_t)c;
        c >>= 32;
    }
}

// ---- symmetry walk: class normalization (y <= (p-1)/2) ----

// 1 when canonical y > (p-1)/2, else 0: y + (2^256 - (p+1)/2) carries
// out of 2^256.  The addend is 2^255 + 2^31 + 488: words 0 and 7 only.
KT_HD uint32_t fe_is_high(const uint32_t y[8]) {
    uint64_t c = (uint64_t)y[0] + 0x800001E8u;
    c >>= 32;
    for (int i = 1; i < 7; ++i) c = (c + y[i]) >> 32;
    c += (uint64_t)y[7] + 0x80000000u;
    return (uint32_t)(c >> 32);
}

// r = (p - y) mod 2^256: the canonical negation for canonical 0 < y < p.
KT_HD void fe_neg(uint32_t r[8], const uint32_t y[8]) {
    uint64_t br = 0;
    for (int i = 0; i < 8; ++i) {
        const uint32_t pw = i == 0 ? 0xFFFFFC2Fu
                          : i == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu;
        const uint64_t d = (uint64_t)pw - y[i] - br;
        r[i] = (uint32_t)d;
        br = d >> 63;
    }
}

// d = -d mod 2^128 (two's complement) on 4-word signed distances.
KT_HD void neg_u128(uint32_t d[4]) {
    uint64_t c = 1;
    for (int i = 0; i < 4; ++i) {
        c += (uint32_t)~d[i];
        d[i] = (uint32_t)c;
        c >>= 32;
    }
}

// r[w] = m ? a[w] : b[w] for a mask m of all ones or all zeros: a word
// select, so that lanes of a warp that differ in m do not diverge.
KT_HD void sel_words(uint32_t* r, const uint32_t* a, const uint32_t* b,
                     int nw, uint32_t m) {
    for (int w = 0; w < nw; ++w) r[w] = (a[w] & m) | (b[w] & ~m);
}

}  // namespace kt
