// Hopper (sm_90a) DP compaction: one shard's distinguished points of a
// tick, every window's, compacted on the card into one block (a header
// row and the records in the solver's walk order) and copied to pinned
// host memory, all queued on the shard's stream behind its last walk
// window.  The per-thread body lives in compact.cuh; this file adds the
// block-wide sums and scans, the three kernels and the C entry points
// bound with ctypes by kangaroo_torch/ops/compact_cuda.py.
//
// It replaces no Pallas kernel: its JAX counterpart is the XLA program
// `compact_fn` of kangaroo_tpu/core/solver.py (a cumsum over the
// occupied cells, a scatter of their positions, gathers at a fixed
// width, one blocking read a tick).  The port's first version was ~17
// PyTorch ops a window with three blocking reads (nonzero's size, the
// pageable copy, the lost count), kept as the CPU path and the
// yardstick (`compact_plain`); on the card the host waited through
// them after every tick while the card was idle.
//
// What bounds it on this card: bytes.  A tick reads every lane's count
// (4 B a lane and window) and, for each record, 76 B gathered from the
// slot rows (10 x limbs, 8 d limbs, the step) and writes 80 B; the scan
// reads and writes 16 B an entry of the scratch, one entry per slot and
// tile of 1024 lanes.  At 2^22 lanes and 65,536 DPs a tick that is
// ~27 MB, ~8 us at 3.35 TB/s; at 8192 lanes and ~2,048 DPs it is ~0.3
// MB, and the three launches' latency sets the time.  What the design
// does about it:
//   - a tick is three launches behind the walk on the shard's stream
//     (count, scan, gather) and one copy, with no host read between
//     them: the host waits once, on the tick's event, and reads the
//     pinned block;
//   - counts are read once in the count phase and once in the gather,
//     4 consecutive lanes a thread; a tile whose slot holds no record
//     (or none in the written rank range) is skipped whole, so the
//     sparse slot rows are read only where a record is;
//   - the records' order comes from the scan, not from atomics, so a
//     block is bit-equal to the plain version's, run after run;
//   - each record is written as five 16-byte stores.
#include <cuda_runtime.h>

#include "compact.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

// Exclusive prefix of v over the block's threads, in thread order; the
// block's total into *total.  sh holds one T a warp.
template <typename T, int NT>
__device__ T block_exclusive_scan(T v, T* sh, T* total) {
    constexpr int NW = NT / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) sh[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T s = lane < NW ? sh[lane] : T(0);
        for (int o = 1; o < NW; o <<= 1) {
            const T y = __shfl_up_sync(FULL, s, o);
            if (lane >= o) s += y;
        }
        if (lane < NW) sh[lane] = s;
    }
    __syncthreads();
    const T out = x - v + (warp ? sh[warp - 1] : T(0));
    *total = sh[NW - 1];
    __syncthreads();  // sh is free for the next call
    return out;
}

// 1. count: block (tile, j) counts its occupied cells of every slot and
// its lost DPs into the scratch.
__global__ void __launch_bounds__(kt::C_THREADS)
kt_compact_count(kt::CompactArgs a) {
    constexpr int NW = kt::C_THREADS / 32;
    __shared__ int hits[kt::C_MAX_SLOTS][NW];
    __shared__ long long lost_w[NW];
    const int j = blockIdx.y, t = threadIdx.x;
    const size_t tile = blockIdx.x;
    const int lane = t & 31, warp = t >> 5;
    int c2[kt::C_LANES];
    long long lost = kt::thread_slots(a, j, tile, t, c2);
    for (int s = 0; s < a.slots; ++s) {
        const unsigned h =
            __reduce_add_sync(FULL, (unsigned)kt::slot_hits(c2, s));
        if (lane == 0) hits[s][warp] = (int)h;
    }
    for (int o = 16; o; o >>= 1) lost += __shfl_down_sync(FULL, lost, o);
    if (lane == 0) lost_w[warp] = lost;
    __syncthreads();
    const int w = a.w0 + j;
    if (t < a.slots) {
        long long sum = 0;
        for (int k = 0; k < NW; ++k) sum += hits[t][k];
        kt::tile_count(a)[kt::entry(a, w, t, tile)] = sum;
    }
    if (t == 0) {
        long long sum = 0;
        for (int k = 0; k < NW; ++k) sum += lost_w[k];
        kt::tile_lost(a)[(size_t)w * a.tiles + tile] = sum;
    }
}

// 2. scan: the entries' offsets, the record count and the lost DPs, in
// one block; thread 0 writes the header row.
__global__ void __launch_bounds__(kt::C_SCAN_THREADS)
kt_compact_scan(kt::CompactArgs a, int32_t* out) {
    __shared__ long long sh[kt::C_SCAN_THREADS / 32];
    const int t = threadIdx.x;
    size_t b, e;
    kt::scan_share(kt::entries(a), t, kt::C_SCAN_THREADS, b, e);
    long long m;
    const long long base = block_exclusive_scan<long long,
        kt::C_SCAN_THREADS>(kt::run_sum(kt::tile_count(a), b, e), sh, &m);
    kt::run_offsets(a, b, e, base);
    kt::scan_share((size_t)a.windows * a.tiles, t, kt::C_SCAN_THREADS, b, e);
    long long lost;
    block_exclusive_scan<long long, kt::C_SCAN_THREADS>(
        kt::run_sum(kt::tile_lost(a), b, e), sh, &lost);
    if (t == 0) kt::write_header(out, lost, m);
}

// 3. gather: block (tile, j) writes its records of ranks [r0, r1) to
// out row rank - r0.
__global__ void __launch_bounds__(kt::C_THREADS)
kt_compact_kernel(kt::CompactArgs a, long long r0, long long r1,
                  int32_t* out) {
    __shared__ int sh[kt::C_THREADS / 32];
    const int j = blockIdx.y, t = threadIdx.x;
    const size_t tile = blockIdx.x;
    const int w = a.w0 + j;
    int c2[kt::C_LANES];
    kt::thread_slots(a, j, tile, t, c2);
    for (int s = 0; s < a.slots; ++s) {
        const size_t e = kt::entry(a, w, s, tile);
        const long long cnt = kt::tile_count(a)[e];
        if (cnt == 0) break;  // a lane's occupied slots are a prefix
        const long long base = kt::tile_off(a)[e];
        if (base >= r1 || base + cnt <= r0) continue;  // the whole block
        int hits;
        const int before = block_exclusive_scan<int, kt::C_THREADS>(
            kt::slot_hits(c2, s), sh, &hits);
        kt::thread_records(a, j, tile, t, s, c2, base + before, r0, r1, out);
    }
}

// The gather over every launch of windows, records of ranks [r0, r1)
// to out.
cudaError_t gather(const void* const* count, const void* const* dpx,
                   const void* const* dpd, const void* const* step,
                   int windows, int n, int slots, int nb_run, long long lo,
                   void* scratch, long long r0, long long r1, int32_t* out,
                   cudaStream_t st) {
    kt::CompactArgs a;
    for (int w0 = 0; w0 < windows && r1 > r0; w0 += kt::C_MAX_WINDOWS) {
        if (!kt::compact_args(a, count, dpx, dpd, step, w0, windows, n,
                              slots, nb_run, lo, scratch))
            return cudaErrorInvalidValue;
        kt_compact_kernel<<<dim3((unsigned)a.tiles, a.group), kt::C_THREADS,
                            0, st>>>(a, r0, r1, out);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Queue one shard's compaction of a tick on `stream` (no
// synchronization): the `windows` windows' count, dpx, dpd and step
// (arrays of `windows` device pointers, in launch order) of n lanes and
// `slots` slots, nb_run steps a window, the shard's first lane `lo`;
// `scratch` of compact_cuda.scratch_words int64; `out` a device block
// of 1 + cap rows of REC_WORDS int32 that takes the header and the
// records of ranks [0, cap); then, if `host` is not null, out's 1 + cap
// rows are copied to `host` (pinned) on the same stream.  Returns the
// cudaError_t of the launches and the copy (0 on success).
int kt_compact(const void* const* count, const void* const* dpx,
               const void* const* dpd, const void* const* step, int windows,
               int n, int slots, int nb_run, long long lo, void* scratch,
               void* out, long long cap, void* host, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    kt::CompactArgs a;
    if (cap < 0 || !out ||
        !kt::compact_args(a, count, dpx, dpd, step, 0, windows, n, slots,
                          nb_run, lo, scratch))
        return (int)cudaErrorInvalidValue;
    for (int w0 = 0; w0 < windows; w0 += kt::C_MAX_WINDOWS) {
        kt::compact_args(a, count, dpx, dpd, step, w0, windows, n, slots,
                         nb_run, lo, scratch);
        kt_compact_count<<<dim3((unsigned)a.tiles, a.group), kt::C_THREADS,
                           0, st>>>(a);
    }
    int32_t* blk = static_cast<int32_t*>(out);
    kt_compact_scan<<<1, kt::C_SCAN_THREADS, 0, st>>>(a, blk);
    cudaError_t err = gather(count, dpx, dpd, step, windows, n, slots,
                             nb_run, lo, scratch, 0, cap,
                             blk + kt::REC_WORDS, st);
    if (err != cudaSuccess) return (int)err;
    if (host) {
        err = cudaMemcpyAsync(host, out,
                              (size_t)(1 + cap) * kt::REC_WORDS * 4,
                              cudaMemcpyDeviceToHost, st);
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

// The records of ranks [r0, r1) of the last kt_compact over the same
// windows and scratch, to `out` (r1 - r0 rows), on `stream`.
int kt_compact_rest(const void* const* count, const void* const* dpx,
                    const void* const* dpd, const void* const* step,
                    int windows, int n, int slots, int nb_run, long long lo,
                    void* scratch, long long r0, long long r1, void* out,
                    void* stream) {
    if (r0 < 0 || r1 < r0 || !out) return (int)cudaErrorInvalidValue;
    return (int)gather(count, dpx, dpd, step, windows, n, slots, nb_run, lo,
                       scratch, r0, r1, static_cast<int32_t*>(out),
                       static_cast<cudaStream_t>(stream));
}

const char* kt_compact_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
