// Hopper (sm_90a) herd kernel: every lane's start position, |d| G
// (negated on `neg` lanes) plus keyToSearch on wild lanes, in one
// launch.  The per-thread body lives in herd.cuh; this file adds the
// kernel and the C entry points bound with ctypes by
// kangaroo_torch/ops/herd_cuda.py.
//
// It replaces no TPU kernel: the JAX package's k*G is XLA code
// (kangaroo_tpu/ops/ec.py), and the port's first counterpart was plain
// PyTorch (ops/ec.py), kept as the CPU path and the yardstick.  It was
// added because that plain version is launch-bound on a card: each
// window's affine add is a fold tree of ~2 log2(N) field multiplies of
// ~70 int64 tensor ops each, with its root inverted on the host, so a
// 40-bit herd of 8192 lanes took ~34,000 launches and six host
// round trips for well under a millisecond of arithmetic.
//
// What bounds it on this card.  A window is one affine add a lane, the
// walk's step without the distance and DP work: the function needs
// about the walk's `imad_per_jump` 32-bit multiply-add issue slots per
// lane and window (ops/jump_cuda.py; one inversion a window for the
// whole herd), and a key step more on wild lanes; its memory traffic is
// small beside that (the table entry gathered from L2, 64 B, and the
// accumulator's 64 B read and written a lane and window).  So it is
// bound by IMAD issue, as the walk is, and the design is the walk's:
//   - one safegcd inversion per thread and window (field.cuh), shared by
//     the thread's G lanes through Montgomery's trick, lanes that do not
//     add left out of the product;
//   - G chosen by the wrapper from the lane count: 64 where the herd
//     still gives every SM a block (2^22 lanes: 512 blocks of 128
//     threads, one wave at the walk's 4 blocks per SM), smaller down to
//     1 for a small herd, so that a batch key's 8192 lanes run on 64 SMs
//     instead of one and a few reset lanes on one thread each;
//   - the accumulators packed as 32-bit words in the output rows and the
//     identity flags in a register mask, so a window moves 32-B rows;
//   - the generator table (32 x 256 entries x 64 B, 512 KB) read through
//     the read-only path as 16-byte loads: L2-resident after the first
//     window's misses, uploaded once per process and device.
#include <cuda_runtime.h>

#include "herd.cuh"

namespace {

__global__ void __launch_bounds__(kt::THREADS, kt::MIN_BLOCKS)
kt_herd_kernel(kt::HerdArgs a) {
    uint32_t acc[kt::MAX_GROUP - 1][8];  // prefix products (local memory)
    kt::herd_thread(a, blockIdx.x, threadIdx.x, acc);
}

}  // namespace

extern "C" {

// Launch the herd's positions on `stream` (no synchronization): mag
// (16, n) int32 limbs of |d|, neg and wild (n,) bytes, the generator
// table (32, 256, 16) words, px and py (16, n) int32 outputs, `windows`
// byte windows, `group` lanes a thread, `key` 16 words (keyToSearch's
// x, then y) or null for no key step.  Returns the cudaError_t of the
// launch (0 on success).
int kt_herd_positions(const void* mag, const void* neg, const void* wild,
                      const void* table, void* px, void* py, int n,
                      int windows, int group, const uint32_t* key,
                      void* stream) {
    kt::HerdArgs a;
    if (!kt::herd_args(a, mag, neg, wild, table, px, py, n, windows, group,
                       key))
        return (int)cudaErrorInvalidValue;
    const size_t lanes = (size_t)kt::THREADS * group;
    const unsigned blocks = (unsigned)(((size_t)n + lanes - 1) / lanes);
    kt_herd_kernel<<<blocks, kt::THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

const char* kt_herd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
