// secp256k1 field arithmetic for the walk kernel, 8 x 32-bit words.
//
// Plain C++ marked __host__ __device__: nvcc builds it into the walk
// kernel (jump_kernel.cu) and g++ builds the very same code for the
// CPU tests (host_shim.cpp), so the kernel's own arithmetic is checked
// without a card.  No inline PTX.
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

namespace kt {

constexpr uint32_t C_LOW = 977u;  // K1C = 2^32 + C_LOW

KT_HD void fe_copy(uint32_t r[8], const uint32_t a[8]) {
    for (int i = 0; i < 8; ++i) r[i] = a[i];
}

// r += k * K1C for k < 2^34, then once more for the (0/1) carry out of
// 2^256.  After a carry out the low part is < 2^67, so the second fold
// cannot carry again.  Result < 2^256, congruent to r + k*2^256.
KT_HD void fe_fold(uint32_t r[8], uint64_t k) {
    uint64_t c = (uint64_t)r[0] + k * C_LOW;
    r[0] = (uint32_t)c;
    c >>= 32;
    c += (uint64_t)r[1] + k;
    r[1] = (uint32_t)c;
    c >>= 32;
    for (int i = 2; i < 8; ++i) {
        c += r[i];
        r[i] = (uint32_t)c;
        c >>= 32;
    }
    const uint64_t k2 = c;
    c = (uint64_t)r[0] + k2 * C_LOW;
    r[0] = (uint32_t)c;
    c >>= 32;
    c += (uint64_t)r[1] + k2;
    r[1] = (uint32_t)c;
    c >>= 32;
    for (int i = 2; i < 8; ++i) {
        c += r[i];
        r[i] = (uint32_t)c;
        c >>= 32;
    }
}

// r = (a + b) mod p, relaxed.
KT_HD void fe_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint64_t c = 0;
    for (int i = 0; i < 8; ++i) {
        c += (uint64_t)a[i] + b[i];
        r[i] = (uint32_t)c;
        c >>= 32;
    }
    fe_fold(r, c);
}

// r -= k * K1C (k in {0, 1}); returns the borrow out of 2^256.
KT_HD uint32_t fe_sub_c(uint32_t r[8], uint32_t k) {
    uint64_t d = (uint64_t)r[0] - (uint64_t)k * C_LOW;
    r[0] = (uint32_t)d;
    uint64_t br = d >> 63;
    d = (uint64_t)r[1] - k - br;
    r[1] = (uint32_t)d;
    br = d >> 63;
    for (int i = 2; i < 8; ++i) {
        d = (uint64_t)r[i] - br;
        r[i] = (uint32_t)d;
        br = d >> 63;
    }
    return (uint32_t)br;
}

// r = (a - b) mod p, relaxed, for any a, b < 2^256.  A borrow means the
// 256-bit difference wrapped by 2^256; adding p is subtracting K1C
// modulo 2^256, needed a second time when b - a > p.
KT_HD void fe_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint64_t br = 0;
    for (int i = 0; i < 8; ++i) {
        const uint64_t d = (uint64_t)a[i] - b[i] - br;
        r[i] = (uint32_t)d;
        br = d >> 63;
    }
    const uint32_t b2 = fe_sub_c(r, (uint32_t)br);
    fe_sub_c(r, b2);
}

// r = t mod p, relaxed, for a 512-bit t (16 words): fold the high half,
// T_hi * 2^256 == T_hi * 977 + T_hi * 2^32 (8 wide multiply-adds).
KT_HD void fe_reduce512(uint32_t r[8], const uint32_t t[16]) {
    uint64_t c = 0;
    for (int i = 0; i < 8; ++i) {
        c += (uint64_t)t[i] + (uint64_t)t[8 + i] * C_LOW;
        if (i > 0) c += t[7 + i];
        r[i] = (uint32_t)c;
        c >>= 32;
    }
    c += t[15];  // the top high word, shifted by 32 bits, lands at 2^256
    fe_fold(r, c);
}

// r = (a * b) mod p, relaxed.  Schoolbook 8x8 product with 64-bit
// accumulators (64 wide multiply-adds), then fe_reduce512.
KT_HD void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
    uint32_t t[16];
    for (int i = 0; i < 16; ++i) t[i] = 0;
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
        for (int j = 0; j < 8; ++j) {
            // (2^32-1)^2 + 2 * (2^32-1) == 2^64 - 1: never overflows
            c += (uint64_t)a[i] * b[j] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + 8] = (uint32_t)c;
    }
    fe_reduce512(r, t);
}

// r = a^2 mod p, relaxed.  36 wide multiply-adds instead of 64: the 28
// cross products a[i] a[j] (i < j) once, doubled by a shift, plus the 8
// squares a[i]^2; then fe_reduce512.
KT_HD void fe_sqr(uint32_t r[8], const uint32_t a[8]) {
    uint32_t t[16];
    for (int i = 0; i < 16; ++i) t[i] = 0;
    for (int i = 0; i < 7; ++i) {
        uint64_t c = 0;
        for (int j = i + 1; j < 8; ++j) {
            c += (uint64_t)a[i] * a[j] + t[i + j];
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + 8] = (uint32_t)c;
    }
    // the cross sum is < 2^511, so doubling it drops no bit
    uint32_t top = 0;
    for (int i = 0; i < 16; ++i) {
        const uint32_t w = t[i];
        t[i] = (w << 1) | top;
        top = w >> 31;
    }
    uint64_t c = 0;
    for (int i = 0; i < 8; ++i) {
        const uint64_t sq = (uint64_t)a[i] * a[i];
        c += (uint64_t)t[2 * i] + (uint32_t)sq;
        t[2 * i] = (uint32_t)c;
        c >>= 32;
        c += (uint64_t)t[2 * i + 1] + (sq >> 32);
        t[2 * i + 1] = (uint32_t)c;
        c >>= 32;
    }
    fe_reduce512(r, t);
}

// r = a^(2^n)
KT_HD void fe_sqr_n(uint32_t r[8], const uint32_t a[8], int n) {
    fe_sqr(r, a);
    for (int i = 1; i < n; ++i) fe_sqr(r, r);
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

// r = a^(p-2) = a^-1 mod p (Fermat; inv(0) = 0), canonical.  The
// addition chain of libsecp256k1's field inverse: 255 squarings and
// 15 multiplications, a fixed sequence with no data-dependent control.
KT_HD void fe_inv(uint32_t r[8], const uint32_t a[8]) {
    uint32_t x2[8], x3[8], x6[8], x9[8], x11[8], x22[8], x44[8], x88[8];
    uint32_t t[8];
    fe_sqr(x2, a);
    fe_mul(x2, x2, a);            // a^(2^2-1)
    fe_sqr(x3, x2);
    fe_mul(x3, x3, a);            // a^(2^3-1)
    fe_sqr_n(x6, x3, 3);
    fe_mul(x6, x6, x3);
    fe_sqr_n(x9, x6, 3);
    fe_mul(x9, x9, x3);
    fe_sqr_n(x11, x9, 2);
    fe_mul(x11, x11, x2);
    fe_sqr_n(x22, x11, 11);
    fe_mul(x22, x22, x11);
    fe_sqr_n(x44, x22, 22);
    fe_mul(x44, x44, x22);
    fe_sqr_n(x88, x44, 44);
    fe_mul(x88, x88, x44);
    fe_sqr_n(t, x88, 88);
    fe_mul(t, t, x88);            // x176
    fe_sqr_n(t, t, 44);
    fe_mul(t, t, x44);            // x220
    fe_sqr_n(t, t, 3);
    fe_mul(t, t, x3);             // x223
    fe_sqr_n(t, t, 23);
    fe_mul(t, t, x22);
    fe_sqr_n(t, t, 5);
    fe_mul(t, t, a);
    fe_sqr_n(t, t, 3);
    fe_mul(t, t, x2);
    fe_sqr_n(t, t, 2);
    fe_mul(r, t, a);
    fe_canon(r);
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
