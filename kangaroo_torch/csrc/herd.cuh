// One thread's share of the herd's start positions: the body of the
// CUDA herd kernel (herd_kernel.cu), written as __host__ __device__ C++
// so that g++ runs the same code on the CPU in the tests
// (host_shim.cpp).
//
// The function, lane by lane: P = |d| G by byte windows over the
// generator table (ops/ec.py `_gtable_np`: entry [w][j] = (j + 1)
// 2^(8w) G), negated (p - y) on `neg` lanes, and keyToSearch + P on
// wild lanes.  It is computed as a short walk: window w adds the table
// entry [w][b_w - 1], b_w being byte w of |d|, to the lane's
// accumulator, and a last step adds the fixed point keyToSearch on wild
// lanes.  Each step is an affine add whose inversions a thread shares
// over its G lanes by Montgomery's trick and one safegcd fe_inv, as the
// walk does (walk.cuh).  The masks are those of the plain version
// (ec.affine_add_batch_masked, ec.signed_mult_base, and the key add of
// herd_cuda.positions_plain):
//   - a lane with b_w = 0 keeps its accumulator;
//   - an accumulator that is still the identity takes the table point;
//   - such lanes feed 1 into the thread's product (they are left out of
//     it), and so do tame lanes in the key step;
//   - a |d| = 0 lane comes out as the last window's first entry,
//     2^248 G, not negated, as the plain 32-window multiply leaves it;
//   - the key step adds keyToSearch to every wild lane, |d| = 0 lanes
//     included.
// Outputs are canonical.
//
// Geometry: a block of THREADS threads owns THREADS * G consecutive
// lanes, thread t of block b the lanes b*THREADS*G + g*THREADS + t for
// g < G (neighbouring threads on neighbouring lanes), lanes at or past n
// left out.  G is a launch argument (1..MAX_GROUP) that the wrapper
// picks from the lane count.
//
// State: while the windows run, a lane's accumulator lives in the
// output rows as 32-bit words (x in px rows 0..7, y in py rows 0..7);
// the last step reads them and writes the lane's 16 limb rows of px and
// py.  Whether the accumulator is still the identity is a bit of a
// per-thread mask (|d| mod 2^(8w) = 0), so no flag row is read.
//
// The grouped inversion is exact, so the canonical outputs do not
// depend on G -- with one exception: a lane with dx = 0 (P = +-Q)
// zeroes the product of its whole group here, while the plain fold tree
// zeroes a different set of lanes.  The windows never meet one (an
// accumulator m G with 0 < m < 2^(8w) is never +-(b 2^(8w)) G, since
// b 2^(8w) < 2^256 - 2^248 < n), and the key step meets one only on a
// lane that starts on +-keyToSearch.  It is not emulated.
#pragma once

#include "walk.cuh"

namespace kt {

constexpr int MAX_GROUP = 64;   // lanes per thread at most (a 64-bit mask)
constexpr int G_WINDOWS = 32;   // byte windows of the generator table
constexpr int G_ENTRIES = 256;  // entries a window
constexpr int G_WORDS = 16;     // words an entry: x 0..7, y 8..15

struct HerdArgs {
    const int32_t* mag;    // (16, n) 16-bit limbs of |d|
    const uint8_t* neg;    // (n,) 1: take p - y
    const uint8_t* wild;   // (n,) 1: add keyToSearch
    const uint32_t* table; // (G_WINDOWS, G_ENTRIES, G_WORDS) words
    int32_t* px;           // (16, n) out, canonical
    int32_t* py;           // (16, n) out, canonical
    size_t n;
    int windows;  // byte windows of |d| (1..G_WINDOWS)
    int group;    // lanes per thread (1..MAX_GROUP)
    int has_key;  // 0: no key step (keyToSearch at infinity)
    uint32_t kx[8], ky[8];  // keyToSearch, canonical words
};

// Fill `a` from a launch's arguments; false for arguments the body does
// not take.  `key` is 16 words (x, then y) or null.
inline bool herd_args(HerdArgs& a, const void* mag, const void* neg,
                      const void* wild, const void* table, void* px,
                      void* py, int n, int windows, int group,
                      const uint32_t* key) {
    if (n <= 0 || windows < 1 || windows > G_WINDOWS || group < 1 ||
        group > MAX_GROUP || !mag || !neg || !wild || !table || !px || !py)
        return false;
    a.mag = static_cast<const int32_t*>(mag);
    a.neg = static_cast<const uint8_t*>(neg);
    a.wild = static_cast<const uint8_t*>(wild);
    a.table = static_cast<const uint32_t*>(table);
    a.px = static_cast<int32_t*>(px);
    a.py = static_cast<int32_t*>(py);
    a.n = (size_t)n;
    a.windows = windows;
    a.group = group;
    a.has_key = key != nullptr;
    for (int w = 0; w < 8; ++w) {
        a.kx[w] = key ? key[w] : 0u;
        a.ky[w] = key ? key[8 + w] : 0u;
    }
    return true;
}

// nw words of table entry [w][j] from word `off` on (x: 0, y: 8); the
// card reads them as 16-byte loads through the read-only path.
KT_HD void table_words(uint32_t* r, const uint32_t* table, int w, int j,
                       int off, int nw) {
    const uint32_t* e = table + ((size_t)w * G_ENTRIES + j) * G_WORDS + off;
#if defined(__CUDA_ARCH__)
    for (int k = 0; k < nw; k += 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(e + k));
        r[k] = v.x;
        r[k + 1] = v.y;
        r[k + 2] = v.z;
        r[k + 3] = v.w;
    }
#else
    for (int k = 0; k < nw; ++k) r[k] = e[k];
#endif
}

// Byte w of a lane's |d|.
KT_HD uint32_t mag_byte(const HerdArgs& a, size_t lane, int w) {
    return ((uint32_t)a.mag[(size_t)(w >> 1) * a.n + lane] >> (8 * (w & 1)))
           & 0xFFu;
}

// x3, y3 = P + Q for P = (x, y), Q = (qx, qy) and dxi = 1 / (qx - x):
// the affine add of ec.affine_add_batch_masked, canonical outputs.
KT_HD void affine_add(uint32_t x3[8], uint32_t y3[8], const uint32_t x[8],
                      const uint32_t y[8], const uint32_t qx[8],
                      const uint32_t qy[8], const uint32_t dxi[8]) {
    uint32_t lam[8], t[8];
    fe_sub(t, qy, y);
    fe_mul(lam, t, dxi);
    fe_sqr(x3, lam);
    fe_sub(x3, x3, x);
    fe_sub(x3, x3, qx);
    fe_canon(x3);
    fe_sub(t, qx, x3);
    fe_mul(y3, lam, t);
    fe_sub(y3, y3, qy);
    fe_canon(y3);
}

// A lane's signed multiple before the key step: +-acc, or 2^248 G for
// |d| = 0 (the identity, which has no affine coordinates).
KT_HD void signed_point(uint32_t x[8], uint32_t y[8], const HerdArgs& a,
                        size_t lane, bool nonzero) {
    if (!nonzero) {
        table_words(x, a.table, G_WINDOWS - 1, 0, 0, 8);
        table_words(y, a.table, G_WINDOWS - 1, 0, 8, 8);
        return;
    }
    const uint32_t* sx = reinterpret_cast<const uint32_t*>(a.px);
    const uint32_t* sy = reinterpret_cast<const uint32_t*>(a.py);
    load_packed(x, 8, sx, a.n, lane);
    load_packed(y, 8, sy, a.n, lane);
    if (a.neg[lane]) {
        uint32_t ny[8];
        fe_neg(ny, y);  // every y lies in (0, p): no point of order 2
        fe_copy(y, ny);
    }
}

// The whole herd for thread t of block b.  `acc` is the thread's
// scratch for its group's prefix products (group - 1 of them).
KT_HD void herd_thread(const HerdArgs& a, size_t b, int t,
                       uint32_t (*acc)[8]) {
    const int G = a.group;
    const size_t base = b * (size_t)THREADS * G + (size_t)t;
    const size_t n = a.n;
    uint32_t* const sx = reinterpret_cast<uint32_t*>(a.px);
    uint32_t* const sy = reinterpret_cast<uint32_t*>(a.py);
    uint64_t nz = 0;  // bit g: lane g's accumulator is not the identity
    for (int w = 0; w < a.windows; ++w) {
        // forward: the product of the adding lanes' dx, with prefixes
        uint32_t inv[8] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        bool any = false;
        for (int g = 0; g < G; ++g) {
            const size_t lane = base + (size_t)g * THREADS;
            if (lane < n && ((nz >> g) & 1u)) {
                const uint32_t bw = mag_byte(a, lane, w);
                if (bw) {
                    uint32_t x[8], dx[8];
                    load_packed(x, 8, sx, n, lane);
                    table_words(dx, a.table, w, (int)bw - 1, 0, 8);
                    fe_sub(dx, dx, x);
                    fe_mul(inv, inv, dx);
                    any = true;
                }
            }
            if (g < G - 1) fe_copy(acc[g], inv);
        }
        if (any) fe_inv(inv, inv);
        // backward: unwind the inverse lane by lane and add
        for (int g = G - 1; g >= 0; --g) {
            const size_t lane = base + (size_t)g * THREADS;
            if (lane >= n) continue;
            const uint32_t bw = mag_byte(a, lane, w);
            if (!bw) continue;  // the accumulator stays
            uint32_t qx[8], qy[8];
            table_words(qx, a.table, w, (int)bw - 1, 0, 8);
            table_words(qy, a.table, w, (int)bw - 1, 8, 8);
            if (!((nz >> g) & 1u)) {  // the identity takes the point
                store_packed(sx, qx, 8, n, lane);
                store_packed(sy, qy, 8, n, lane);
                nz |= (uint64_t)1 << g;
                continue;
            }
            uint32_t x[8], y[8], dx[8], dxi[8], x3[8], y3[8];
            load_packed(x, 8, sx, n, lane);
            load_packed(y, 8, sy, n, lane);
            fe_sub(dx, qx, x);
            if (g > 0) {
                fe_mul(dxi, inv, acc[g - 1]);  // 1/dx_g
                fe_mul(inv, inv, dx);          // 1/(dx_0 ... dx_{g-1})
            } else {
                fe_copy(dxi, inv);
            }
            affine_add(x3, y3, x, y, qx, qy, dxi);
            store_packed(sx, x3, 8, n, lane);
            store_packed(sy, y3, 8, n, lane);
        }
    }
    // the key step on wild lanes, then the lane's 16 limb rows
    uint32_t inv[8] = {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    bool any = false;
    if (a.has_key) {
        for (int g = 0; g < G; ++g) {
            const size_t lane = base + (size_t)g * THREADS;
            if (lane < n && a.wild[lane]) {
                uint32_t x[8], y[8], dx[8];
                signed_point(x, y, a, lane, (nz >> g) & 1u);
                fe_sub(dx, a.kx, x);
                fe_mul(inv, inv, dx);
                any = true;
            }
            if (g < G - 1) fe_copy(acc[g], inv);
        }
        if (any) fe_inv(inv, inv);
    }
    for (int g = G - 1; g >= 0; --g) {
        const size_t lane = base + (size_t)g * THREADS;
        if (lane >= n) continue;
        uint32_t x[8], y[8];
        signed_point(x, y, a, lane, (nz >> g) & 1u);
        if (a.has_key && a.wild[lane]) {
            uint32_t dx[8], dxi[8], x3[8], y3[8];
            fe_sub(dx, a.kx, x);
            if (g > 0) {
                fe_mul(dxi, inv, acc[g - 1]);
                fe_mul(inv, inv, dx);
            } else {
                fe_copy(dxi, inv);
            }
            affine_add(x3, y3, x, y, a.kx, a.ky, dxi);
            fe_copy(x, x3);
            fe_copy(y, y3);
        }
        store_words(a.px, x, 8, n, lane);
        store_words(a.py, y, 8, n, lane);
    }
}

}  // namespace kt
