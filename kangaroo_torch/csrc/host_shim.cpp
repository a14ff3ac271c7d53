// Host build of the walk kernel's arithmetic and per-thread body, for
// the CPU tests: g++ compiles field.cuh and walk.cuh (the same code
// nvcc builds into jump_kernel.cu) and the tests call these C entry
// points through ctypes.  Field elements are passed as arrays of n
// elements of 8 uint32 words each (4 words for distances).
#include <vector>

#include "walk.cuh"

extern "C" {

int kt_lane_quantum() { return kt::LANES; }

void kt_fe_add_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n) {
    for (int i = 0; i < n; ++i) kt::fe_add(r + 8 * i, a + 8 * i, b + 8 * i);
}

void kt_fe_sub_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n) {
    for (int i = 0; i < n; ++i) kt::fe_sub(r + 8 * i, a + 8 * i, b + 8 * i);
}

void kt_fe_mul_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n) {
    for (int i = 0; i < n; ++i) kt::fe_mul(r + 8 * i, a + 8 * i, b + 8 * i);
}

void kt_fe_sqr_n(uint32_t* r, const uint32_t* a, int n) {
    for (int i = 0; i < n; ++i) kt::fe_sqr(r + 8 * i, a + 8 * i);
}

void kt_fe_inv_n(uint32_t* r, const uint32_t* a, int n) {
    for (int i = 0; i < n; ++i) kt::fe_inv(r + 8 * i, a + 8 * i);
}

void kt_fe_canon_n(uint32_t* r, int n) {
    for (int i = 0; i < n; ++i) kt::fe_canon(r + 8 * i);
}

void kt_add_u128_n(uint32_t* d, const uint32_t* e, int n) {
    for (int i = 0; i < n; ++i) kt::add_u128(d + 4 * i, e + 4 * i);
}

void kt_fe_is_high_n(uint32_t* r, const uint32_t* y, int n) {
    for (int i = 0; i < n; ++i) r[i] = kt::fe_is_high(y + 8 * i);
}

void kt_fe_neg_n(uint32_t* r, const uint32_t* y, int n) {
    for (int i = 0; i < n; ++i) kt::fe_neg(r + 8 * i, y + 8 * i);
}

void kt_neg_u128_n(uint32_t* d, int n) {
    for (int i = 0; i < n; ++i) kt::neg_u128(d + 4 * i);
}

// The kernel's launch, run thread by thread on the host (same argument
// layout as kt_jump_steps in jump_kernel.cu; symmetry mode when
// symclass is not null).  Returns 0, or 1 for a lane count that is not
// a multiple of the lane quantum.
int kt_walk_host(int32_t* px, int32_t* py, int32_t* d, const int32_t* jx,
                 const int32_t* jy, const int32_t* jd, const int32_t* masks,
                 int n, int nb_run, int slots, int32_t* count, int32_t* dpx,
                 int32_t* dpd, int32_t* dstep, int32_t* symclass) {
    if (n <= 0 || n % kt::LANES != 0) return 1;
    kt::JumpTable tb;
    for (int k = 0; k < 8 * kt::NB_JUMP; ++k)
        kt::pack_table_word(&tb, jx, jy, jd, k);
    kt::WalkArgs a{px, py, d, masks, (size_t)n, nb_run, slots,
                   count, dpx, dpd, dstep, symclass};
    std::vector<uint32_t> acc(8 * kt::GROUP);
    const int blocks = n / kt::LANES;
    auto* scratch = reinterpret_cast<uint32_t (*)[8]>(acc.data());
    for (int b = 0; b < blocks; ++b)
        for (int t = 0; t < kt::THREADS; ++t) {
            if (symclass)
                kt::walk_thread<true>(a, tb, (size_t)b, t, scratch);
            else
                kt::walk_thread<false>(a, tb, (size_t)b, t, scratch);
        }
    return 0;
}

}  // extern "C"
