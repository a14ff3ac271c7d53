// One thread's share of a tick's DP compaction: the body of the CUDA
// compaction kernels (compact_kernel.cu), written as __host__
// __device__ C++ so that g++ runs the same code on the CPU in the tests
// (host_shim.cpp).
//
// The function (ops/compact_cuda.py `compact_plain`, the solver's
// per-tick pull before this kernel): a shard's windows of one tick each
// hold a lane's DP count and its `slots` capture slots (x limbs, d
// limbs, step); a cell (window w, slot s, lane l) is occupied when
// s < min(count[l], slots).  The occupied cells, in cell order (window,
// then slot, then lane), become records of REC_WORDS int32:
//   [x limbs 0..9 | d limbs 0..7 | w * nb_run + step | lane + lo]
// and the DPs beyond a lane's slots are counted as lost (exactly, in 64
// bits).  The output block is a header row -- lost and m, the record
// count, as two little-endian int64, then zeros -- and then the
// records, row r + 1 holding the record of rank r.
//
// Geometry: a block of C_THREADS threads owns a tile of C_TILE
// consecutive lanes of one window, thread t the C_LANES lanes from
// tile * C_TILE + t * C_LANES on; lanes at or past n are left out.  The
// order of the records is fixed by a scan, never by atomics:
//   1. count: each block counts its tile's occupied cells of every slot,
//      and its lost DPs, into the scratch (entry (w, s, tile));
//   2. scan: one block takes the exclusive prefix sum of the entries in
//      (w, s, tile) order, the record offset of each tile's slot, sums
//      the lost DPs and writes the header;
//   3. gather: each block scans its threads' hits of a slot, adds the
//      tile's offset, and writes the records whose rank lies in a given
//      range [r0, r1) -- so that a block of fixed capacity takes the
//      first ranks, and the rest can be written later from the same
//      scratch.
// Between the phases a block sums or scans its threads' numbers; the
// card does it with warp shuffles (compact_kernel.cu), the host shim in
// thread order, so both give the same block.
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define KT_CHD __host__ __device__ __forceinline__
#else
#define KT_CHD inline
#endif

namespace kt {

constexpr int C_THREADS = 256;       // threads a block (count, gather)
constexpr int C_LANES = 4;           // consecutive lanes a thread
constexpr int C_TILE = C_THREADS * C_LANES;  // lanes a block
constexpr int C_SCAN_THREADS = 1024;  // threads of the scan's one block
constexpr int C_MAX_WINDOWS = 64;    // windows one launch takes
constexpr int C_MAX_SLOTS = 64;      // slots a window (slots_for_window)
constexpr int C_X_ROWS = 10;         // x limbs a slot (walk.cuh DPX_ROWS)
constexpr int C_D_ROWS = 8;          // d limbs a slot
constexpr int REC_WORDS = 20;        // int32 a record (and the header row)

struct CompactArgs {
    // windows w0 .. w0 + group - 1 of the tick, in launch order: count
    // (n,), dpx (slots, C_X_ROWS, n), dpd (slots, C_D_ROWS, n), step
    // (slots, n), int32
    const int32_t* count[C_MAX_WINDOWS];
    const int32_t* dpx[C_MAX_WINDOWS];
    const int32_t* dpd[C_MAX_WINDOWS];
    const int32_t* step[C_MAX_WINDOWS];
    int w0;
    int group;
    int windows;  // the tick's windows, all launches
    int slots;
    int nb_run;
    int64_t lo;   // the shard's first lane in the herd
    size_t n;
    size_t tiles;
    // entries (windows * slots * tiles) of tile counts, then as many
    // offsets, then windows * tiles lost counts (compact_cuda.py
    // scratch_words)
    int64_t* scratch;
};

KT_CHD size_t compact_tiles(size_t n) { return (n + C_TILE - 1) / C_TILE; }

// Fill `a` for the launch of windows w0 .. (at most C_MAX_WINDOWS);
// false for arguments the body does not take.  Each pointer array
// holds the tick's `windows` pointers.
inline bool compact_args(CompactArgs& a, const void* const* count,
                         const void* const* dpx, const void* const* dpd,
                         const void* const* step, int w0, int windows,
                         int n, int slots, int nb_run, int64_t lo,
                         void* scratch) {
    if (n <= 0 || windows < 1 || w0 < 0 || w0 >= windows || slots < 1 ||
        slots > C_MAX_SLOTS || nb_run < 0 || !count || !dpx || !dpd ||
        !step || !scratch)
        return false;
    a.w0 = w0;
    a.group = windows - w0 < C_MAX_WINDOWS ? windows - w0 : C_MAX_WINDOWS;
    for (int j = 0; j < a.group; ++j) {
        a.count[j] = static_cast<const int32_t*>(count[w0 + j]);
        a.dpx[j] = static_cast<const int32_t*>(dpx[w0 + j]);
        a.dpd[j] = static_cast<const int32_t*>(dpd[w0 + j]);
        a.step[j] = static_cast<const int32_t*>(step[w0 + j]);
        if (!a.count[j] || !a.dpx[j] || !a.dpd[j] || !a.step[j])
            return false;
    }
    a.windows = windows;
    a.slots = slots;
    a.nb_run = nb_run;
    a.lo = lo;
    a.n = (size_t)n;
    a.tiles = compact_tiles(a.n);
    a.scratch = static_cast<int64_t*>(scratch);
    return true;
}

KT_CHD size_t entries(const CompactArgs& a) {
    return (size_t)a.windows * a.slots * a.tiles;
}

// scratch entry of (window w of the tick, slot s, tile)
KT_CHD size_t entry(const CompactArgs& a, int w, int s, size_t tile) {
    return ((size_t)w * a.slots + s) * a.tiles + tile;
}

KT_CHD int64_t* tile_count(const CompactArgs& a) { return a.scratch; }
KT_CHD int64_t* tile_off(const CompactArgs& a) {
    return a.scratch + entries(a);
}
KT_CHD int64_t* tile_lost(const CompactArgs& a) {
    return a.scratch + 2 * entries(a);
}

// Thread t of `tile` in launch window j: its lanes' occupied slots,
// min(count, slots), into c2; returns their DPs beyond the slots.
KT_CHD int64_t thread_slots(const CompactArgs& a, int j, size_t tile, int t,
                            int c2[C_LANES]) {
    const size_t l0 = tile * C_TILE + (size_t)t * C_LANES;
    int64_t lost = 0;
    for (int k = 0; k < C_LANES; ++k) {
        const int c = l0 + k < a.n ? a.count[j][l0 + k] : 0;
        c2[k] = c < a.slots ? c : a.slots;
        lost += c - c2[k];
    }
    return lost;
}

// The thread's occupied cells of slot s.
KT_CHD int slot_hits(const int c2[C_LANES], int s) {
    int h = 0;
    for (int k = 0; k < C_LANES; ++k) h += c2[k] > s;
    return h;
}

// The record of (launch window j, slot s, lane) into dst's REC_WORDS.
KT_CHD void store_record(int32_t* dst, const CompactArgs& a, int j, int s,
                         size_t lane) {
    const size_t n = a.n;
    int32_t r[REC_WORDS];
    const int32_t* x = a.dpx[j] + (size_t)s * C_X_ROWS * n + lane;
    for (int k = 0; k < C_X_ROWS; ++k) r[k] = x[k * n];
    const int32_t* d = a.dpd[j] + (size_t)s * C_D_ROWS * n + lane;
    for (int k = 0; k < C_D_ROWS; ++k) r[C_X_ROWS + k] = d[k * n];
    // int32 sums that wrap as the plain version's int32 tensors do
    r[18] = (int32_t)((uint32_t)a.step[j][(size_t)s * n + lane] +
                      (uint32_t)(a.w0 + j) * (uint32_t)a.nb_run);
    r[19] = (int32_t)(uint32_t)((uint64_t)a.lo + lane);
#if defined(__CUDA_ARCH__)
    int4* o = reinterpret_cast<int4*>(dst);  // rows are 80 B: 16-B aligned
    for (int k = 0; k < REC_WORDS / 4; ++k)
        o[k] = make_int4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
#else
    for (int k = 0; k < REC_WORDS; ++k) dst[k] = r[k];
#endif
}

// The thread's records of slot s, ranks from `rank` on in lane order;
// a rank in [r0, r1) goes to out row rank - r0.
KT_CHD void thread_records(const CompactArgs& a, int j, size_t tile, int t,
                           int s, const int c2[C_LANES], int64_t rank,
                           int64_t r0, int64_t r1, int32_t* out) {
    const size_t l0 = tile * C_TILE + (size_t)t * C_LANES;
    for (int k = 0; k < C_LANES; ++k) {
        if (c2[k] <= s) continue;
        if (rank >= r0 && rank < r1)
            store_record(out + (size_t)(rank - r0) * REC_WORDS, a, j, s,
                         l0 + k);
        ++rank;
    }
}

// The scan's share [b, e) of thread t of nthreads over `total` entries.
KT_CHD void scan_share(size_t total, int t, int nthreads, size_t& b,
                       size_t& e) {
    const size_t per = (total + nthreads - 1) / nthreads;
    b = (size_t)t * per < total ? (size_t)t * per : total;
    e = b + per < total ? b + per : total;
}

KT_CHD int64_t run_sum(const int64_t* v, size_t b, size_t e) {
    int64_t s = 0;
    for (size_t i = b; i < e; ++i) s += v[i];
    return s;
}

// Offsets of entries [b, e), the first at `base`.
KT_CHD void run_offsets(const CompactArgs& a, size_t b, size_t e,
                        int64_t base) {
    const int64_t* c = tile_count(a);
    int64_t* off = tile_off(a);
    for (size_t i = b; i < e; ++i) {
        off[i] = base;
        base += c[i];
    }
}

// The header row: lost and m as little-endian int64, then zeros.
KT_CHD void write_header(int32_t* out, int64_t lost, int64_t m) {
    out[0] = (int32_t)(uint32_t)(uint64_t)lost;
    out[1] = (int32_t)(uint32_t)((uint64_t)lost >> 32);
    out[2] = (int32_t)(uint32_t)(uint64_t)m;
    out[3] = (int32_t)(uint32_t)((uint64_t)m >> 32);
    for (int k = 4; k < REC_WORDS; ++k) out[k] = 0;
}

}  // namespace kt
