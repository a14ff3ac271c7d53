// Host build of the walk kernel's arithmetic and per-thread body, of
// the herd and compaction kernels' bodies and of the probe kernels'
// bodies, for the CPU: g++ compiles field.cuh, walk.cuh, herd.cuh,
// compact.cuh and probes.cuh (the same code nvcc builds into
// jump_kernel.cu, herd_kernel.cu, compact_kernel.cu and
// probe_kernels.cu) and kangaroo_torch/ops/host_kernel.py binds these C
// entry points with ctypes.  Field
// elements are passed as arrays of n elements of 8 uint32 words each
// (4 words for distances).
#include <vector>

#include "compact.cuh"
#include "herd.cuh"
#include "probes.cuh"

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

// r[i] <- fe_reduce512(t[i]), t of 16 words each
void kt_fe_reduce512_n(uint32_t* r, const uint32_t* t, int n) {
    for (int i = 0; i < n; ++i) kt::fe_reduce512(r + 8 * i, t + 16 * i);
}

// One carry primitive of field.cuh (op: 0 add_cc, 1 addc_cc, 2 addc, 3
// sub_cc, 4 subc_cc, 5 subc) on a[i], b[i] with the flag cf[i] coming
// in: r[i] its result, cf[i] the flag it leaves.  Returns 1 for an
// unknown op.
int kt_carry_op_n(int op, uint32_t* r, uint32_t* cf, const uint32_t* a,
                  const uint32_t* b, int n) {
    if (op < 0 || op > 5) return 1;
    for (int i = 0; i < n; ++i) {
        kt::Carry cy;
        cy.cf = cf[i];
        const uint32_t x = a[i], y = b[i];
        r[i] = op == 0 ? kt::add_cc(cy, x, y)
             : op == 1 ? kt::addc_cc(cy, x, y)
             : op == 2 ? kt::addc(cy, x, y)
             : op == 3 ? kt::sub_cc(cy, x, y)
             : op == 4 ? kt::subc_cc(cy, x, y)
                       : kt::subc(cy, x, y);
        cf[i] = cy.cf;
    }
    return 0;
}

void kt_fe_inv_n(uint32_t* r, const uint32_t* a, int n) {
    for (int i = 0; i < n; ++i) kt::fe_inv(r + 8 * i, a + 8 * i);
}

// r[i] <- hi32(a[i] * b[i]) + c[i]: probes.cuh's mulhi_add (the host
// twin of the card's mad.hi.u32)
void kt_mulhi_add_n(uint32_t* r, const uint32_t* a, const uint32_t* b,
                    const uint32_t* c, int n) {
    for (int i = 0; i < n; ++i) r[i] = kt::mulhi_add(a[i], b[i], c[i]);
}

// r[i] <- a[i] ^ b[i] ^ c[i]: probes.cuh's xor3 (the host twin of the
// card's lop3.b32)
void kt_xor3_n(uint32_t* r, const uint32_t* a, const uint32_t* b,
               const uint32_t* c, int n) {
    for (int i = 0; i < n; ++i) r[i] = kt::xor3(a[i], b[i], c[i]);
}

// r[i] <- fe_fold(r[i], k[i]) in place, k[i] < 2^34
void kt_fe_fold_n(uint32_t* r, const uint64_t* k, int n) {
    for (int i = 0; i < n; ++i) kt::fe_fold(r + 8 * i, k[i]);
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

// The kernel's launch, run thread by thread on the host: same arguments
// as kt_jump_steps in jump_kernel.cu (symmetry mode when symclass is not
// null; scratch of SCRATCH_ROWS x n words), no stream.  Returns 0, or 1
// for a lane count that is not a multiple of LANES.
int kt_walk_host(int32_t* px, int32_t* py, int32_t* d, const int32_t* jx,
                 const int32_t* jy, const int32_t* jd, const int32_t* masks,
                 int n, int nb_run, int slots, int32_t* count, int32_t* dpx,
                 int32_t* dpd, int32_t* dstep, int32_t* symclass,
                 uint32_t* scratch) {
    if (n <= 0 || n % kt::LANES != 0 || !scratch) return 1;
    kt::JumpTable tb;
    for (int k = 0; k < 8 * kt::NB_JUMP; ++k)
        kt::pack_table_word(&tb, jx, jy, jd, k);
    kt::WalkArgs a{px, py, d, masks, (size_t)n, nb_run, slots,
                   count, dpx, dpd, dstep, symclass, scratch};
    std::vector<uint32_t> acc(8 * kt::GROUP);
    auto* sc = reinterpret_cast<uint32_t (*)[8]>(acc.data());
    for (int b = 0; b < n / kt::LANES; ++b)
        for (int t = 0; t < kt::THREADS; ++t) {
            if (symclass)
                kt::walk_thread<true>(a, tb, (size_t)b, t, sc);
            else
                kt::walk_thread<false>(a, tb, (size_t)b, t, sc);
        }
    return 0;
}

// The herd kernel's launch, run thread by thread on the host: same
// arguments as kt_herd_positions in herd_kernel.cu, no stream.  Returns
// 0, or 1 for arguments the kernel refuses.
int kt_herd_host(const int32_t* mag, const uint8_t* neg,
                 const uint8_t* wild, const uint32_t* table, int32_t* px,
                 int32_t* py, int n, int windows, int group,
                 const uint32_t* key) {
    kt::HerdArgs a;
    if (!kt::herd_args(a, mag, neg, wild, table, px, py, n, windows, group,
                       key))
        return 1;
    std::vector<uint32_t> acc(8 * kt::MAX_GROUP);
    auto* sc = reinterpret_cast<uint32_t (*)[8]>(acc.data());
    const size_t lanes = (size_t)kt::THREADS * group;
    for (size_t b = 0; b < ((size_t)n + lanes - 1) / lanes; ++b)
        for (int t = 0; t < kt::THREADS; ++t) kt::herd_thread(a, b, t, sc);
    return 0;
}

// The compaction kernels' gather over every launch of windows, run
// thread by thread on the host: records of ranks [r0, r1) to out.
static int compact_gather_host(const void* const* count,
                               const void* const* dpx,
                               const void* const* dpd,
                               const void* const* step, int windows, int n,
                               int slots, int nb_run, long long lo,
                               void* scratch, long long r0, long long r1,
                               int32_t* out) {
    kt::CompactArgs a;
    std::vector<int> c2(kt::C_THREADS * kt::C_LANES);
    for (int w0 = 0; w0 < windows; w0 += kt::C_MAX_WINDOWS) {
        if (!kt::compact_args(a, count, dpx, dpd, step, w0, windows, n,
                              slots, nb_run, lo, scratch))
            return 1;
        for (int j = 0; j < a.group; ++j)
            for (size_t tile = 0; tile < a.tiles; ++tile) {
                for (int t = 0; t < kt::C_THREADS; ++t)
                    kt::thread_slots(a, j, tile, t, &c2[t * kt::C_LANES]);
                for (int s = 0; s < slots; ++s) {
                    const size_t e = kt::entry(a, w0 + j, s, tile);
                    const int64_t cnt = kt::tile_count(a)[e];
                    if (cnt == 0) break;
                    int64_t rank = kt::tile_off(a)[e];
                    if (rank >= r1 || rank + cnt <= r0) continue;
                    for (int t = 0; t < kt::C_THREADS; ++t) {
                        const int* c = &c2[t * kt::C_LANES];
                        kt::thread_records(a, j, tile, t, s, c, rank, r0,
                                           r1, out);
                        rank += kt::slot_hits(c, s);
                    }
                }
            }
    }
    return 0;
}

// The compaction kernels' launches, run thread by thread on the host:
// same arguments as kt_compact in compact_kernel.cu, without the copy
// to the host and the stream.  A block's sums and scans over its
// threads go in thread order.  Returns 0, or 1 for arguments the
// kernels refuse.
int kt_compact_host(const void* const* count, const void* const* dpx,
                    const void* const* dpd, const void* const* step,
                    int windows, int n, int slots, int nb_run, long long lo,
                    void* scratch, int32_t* out, long long cap) {
    kt::CompactArgs a;
    if (cap < 0 || !out ||
        !kt::compact_args(a, count, dpx, dpd, step, 0, windows, n, slots,
                          nb_run, lo, scratch))
        return 1;
    // 1. count
    for (int w0 = 0; w0 < windows; w0 += kt::C_MAX_WINDOWS) {
        kt::compact_args(a, count, dpx, dpd, step, w0, windows, n, slots,
                         nb_run, lo, scratch);
        for (int j = 0; j < a.group; ++j)
            for (size_t tile = 0; tile < a.tiles; ++tile) {
                std::vector<int64_t> hits(slots, 0);
                int64_t lost = 0;
                for (int t = 0; t < kt::C_THREADS; ++t) {
                    int c2[kt::C_LANES];
                    lost += kt::thread_slots(a, j, tile, t, c2);
                    for (int s = 0; s < slots; ++s)
                        hits[s] += kt::slot_hits(c2, s);
                }
                for (int s = 0; s < slots; ++s)
                    kt::tile_count(a)[kt::entry(a, w0 + j, s, tile)] =
                        hits[s];
                kt::tile_lost(a)[(size_t)(w0 + j) * a.tiles + tile] = lost;
            }
    }
    // 2. scan
    int64_t m = 0, lost = 0;
    for (int t = 0; t < kt::C_SCAN_THREADS; ++t) {
        size_t b, e;
        kt::scan_share(kt::entries(a), t, kt::C_SCAN_THREADS, b, e);
        kt::run_offsets(a, b, e, m);
        m += kt::run_sum(kt::tile_count(a), b, e);
        kt::scan_share((size_t)windows * a.tiles, t, kt::C_SCAN_THREADS, b,
                       e);
        lost += kt::run_sum(kt::tile_lost(a), b, e);
    }
    kt::write_header(out, lost, m);
    // 3. gather
    return compact_gather_host(count, dpx, dpd, step, windows, n, slots,
                               nb_run, lo, scratch, 0, cap,
                               out + kt::REC_WORDS);
}

// The records of ranks [r0, r1) of the last kt_compact_host over the
// same windows and scratch, to `out`: kt_compact_rest on the host.
int kt_compact_rest_host(const void* const* count, const void* const* dpx,
                         const void* const* dpd, const void* const* step,
                         int windows, int n, int slots, int nb_run,
                         long long lo, void* scratch, long long r0,
                         long long r1, int32_t* out) {
    if (r0 < 0 || r1 < r0 || !out) return 1;
    return compact_gather_host(count, dpx, dpd, step, windows, n, slots,
                               nb_run, lo, scratch, r0, r1, out);
}

}  // extern "C"

namespace {

struct FieldHost {
    int32_t* x;
    const int32_t* b;
    size_t n;
    int rounds;
    const kt::JumpTable& tb;
    template <int OP>
    int run() {
        if constexpr (OP == kt::F_STEP) {
            std::vector<uint32_t> acc(8 * kt::GROUP);
            auto* scratch = reinterpret_cast<uint32_t (*)[8]>(acc.data());
            for (size_t blk = 0; blk < n / kt::LANES; ++blk)
                for (int t = 0; t < kt::THREADS; ++t)
                    kt::step_chain_thread(x, b, n, blk, t, rounds, tb,
                                          scratch);
        } else {
            for (size_t lane = 0; lane < n; ++lane)
                kt::field_chain_lane<OP>(x, b, n, lane, rounds, tb);
        }
        return 0;
    }
};

struct RawHost {
    void* x;
    size_t nthreads;
    int inner;
    template <int OP, int ILP>
    int run() {
        auto* v = static_cast<typename kt::RawType<OP>::type*>(x);
        for (size_t tid = 0; tid < nthreads; ++tid)
            kt::raw_chain_thread<OP, ILP>(v, tid, nthreads, inner,
                                          kt::SHR_MUL);
        return 0;
    }
};

struct InvHost {
    int32_t* x;
    size_t n;
    int iters;
    template <int VAR, int G>
    int run() {
        std::vector<uint32_t> acc(8 * G);
        auto* scratch = reinterpret_cast<uint32_t (*)[8]>(acc.data());
        for (size_t blk = 0; blk < n / (kt::THREADS * G); ++blk)
            for (int t = 0; t < kt::THREADS; ++t)
                kt::inv_chain_thread<VAR, G>(x, n, blk, t, iters, scratch);
        return 0;
    }
};

// The on-chip form: each block's shared memory is a host buffer that
// its threads, run one after another, share as on the card.
struct ChipHost {
    int32_t* x;
    size_t n;
    int iters;
    template <int VAR, int G>
    int run() {
        std::vector<uint32_t> sm(kt::InvChip<VAR, G>::smem / 4);
        for (size_t blk = 0; blk < n / (kt::THREADS * G); ++blk)
            for (int t = 0; t < kt::THREADS; ++t)
                kt::inv_chip_thread<VAR, G>(x, n, blk, t, iters, sm.data());
        return 0;
    }
};

}  // namespace

extern "C" {

// The probe kernels' launches, run thread by thread on the host, with
// the arguments of their kt_*_launch counterparts in probe_kernels.cu
// (no stream).  Each returns 0, or 1 for arguments the kernel refuses.

int kt_field_chain_host(int op, int32_t* x, const int32_t* b,
                        const int32_t* jx, const int32_t* jy, int n,
                        int rounds) {
    const int quantum = op == kt::F_STEP ? kt::LANES : kt::THREADS;
    const bool table = op == kt::F_GATHER || op == kt::F_STEP;
    if (n <= 0 || rounds < 0 || n % quantum || (table && !(jx && jy)))
        return 1;
    kt::JumpTable tb{};
    if (table)
        for (int k = 0; k < 8 * kt::NB_JUMP; ++k)
            kt::pack_table_word(&tb, jx, jy, jx, k);
    FieldHost h{x, b, (size_t)n, rounds, tb};
    return kt::with_field_op(op, h) == 0 ? 0 : 1;
}

int kt_raw_chain_host(int op, int ilp, void* x, int n_elems, int inner) {
    if (ilp <= 0 || n_elems <= 0 || n_elems % ilp || inner < 0) return 1;
    RawHost h{x, (size_t)n_elems / ilp, inner};
    return kt::with_raw_chain(op, ilp, h) == 0 ? 0 : 1;
}

int kt_delta_host(int variant, int group, int32_t* px, int32_t* py,
                  int32_t* d, const int32_t* jx, const int32_t* jy,
                  const int32_t* jd, const int32_t* masks, int n, int nb_run,
                  int slots, int32_t* count, int32_t* dpx, int32_t* dpd,
                  int32_t* dstep, uint32_t* scratch) {
    if (!kt::delta_has_group(variant, group) || n <= 0 ||
        n % (kt::THREADS * group) != 0 || !scratch)
        return 1;
    kt::JumpTable tb;
    for (int k = 0; k < 8 * kt::NB_JUMP; ++k)
        kt::pack_table_word(&tb, jx, jy, jd, k);
    kt::WalkArgs a{px, py, d, masks, (size_t)n, nb_run, slots,
                   count, dpx, dpd, dstep, nullptr, scratch};
    const int rc = kt::with_delta_variant(variant, [&](auto v) {
        using V = decltype(v);
        auto run = [&](auto gc) {
            constexpr int G = decltype(gc)::value;
            std::vector<uint32_t> acc(8 * G);
            auto* sc = reinterpret_cast<uint32_t (*)[8]>(acc.data());
            for (int b = 0; b < n / (kt::THREADS * G); ++b)
                for (int t = 0; t < kt::THREADS; ++t)
                    kt::walk_thread<false, V, G>(a, tb, (size_t)b, t, sc);
            return 0;
        };
        // each variant at the G it is built for on the card
        if constexpr (std::is_same<V, kt::Production>::value)
            return kt::with_group(group, run);
        else
            return run(std::integral_constant<int, kt::GROUP>{});
    });
    return rc == 0 ? 0 : 1;
}

int kt_inv_chain_host(int variant, int group, int32_t* x, int n,
                      int iters) {
    if (group <= 0 || n <= 0 || n % (kt::THREADS * group) != 0 || iters < 0)
        return 1;
    InvHost h{x, (size_t)n, iters};
    return kt::with_inv_variant(variant, group, h) == 0 ? 0 : 1;
}

int kt_inv_chip_host(int variant, int group, int32_t* x, int n, int iters) {
    if (group <= 0 || n <= 0 || n % (kt::THREADS * group) != 0 || iters < 0)
        return 1;
    ChipHost h{x, (size_t)n, iters};
    return kt::with_inv_chip(variant, group, h) == 0 ? 0 : 1;
}

int kt_inv_chip_run_host() { return kt::CHIP_RUN; }

}  // extern "C"
