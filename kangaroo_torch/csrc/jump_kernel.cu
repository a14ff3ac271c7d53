// Hopper (sm_90a) kangaroo walk kernel: nb_run jumps for every lane in
// one launch, with distinguished-point capture into per-lane slots.
//
// Replaces the TPU kernel kangaroo_tpu/ops/jump_pallas.py:471
// (jump_steps_with_dp: plain branch :378-403, slot capture :417-433,
// and the symmetry branch -- eager class normalization :406-415, the
// deferred-flip walk :331-377 and its XLA epilogue :585-607, whose
// output contract the symmetry kernel computes eagerly).  The
// per-thread body lives in walk.cuh, a template on the symmetry mode;
// this file instantiates it as two kernels, so that the plain kernel's
// code is untouched by the symmetry branch, and adds the shared-memory
// jump table and the C entry points bound with ctypes by
// kangaroo_torch/ops/jump_cuda.py.
//
// The TPU deferred the symmetry flips to the window's end because a
// per-step canonicalize, compare and two wide selects cost its vector
// unit much; here they are ~80 integer adds and logic ops per lane and
// step, no multiply, against ~830 multiply-adds, so the kernel
// normalizes eagerly.
//
// What bounds it on this card.  The function itself needs ~832 32-bit
// integer multiply-add issue slots per jump (ops/jump_cuda.py counts
// them: a field multiply is 64 + 8 wide multiply-adds, a squaring
// 36 + 8; per jump 5 multiplies and 1 squaring on the lane, and one
// safegcd inversion of 20 batches of 78 wide and 2 narrow products a
// step, which at least can be shared by the whole herd) and next to
// nothing of device memory.  This design shares an inversion among the
// G = 64 lanes of a thread, ~874 slots per jump, and adds its own
// traffic, 256 B per lane and step (268 B in symmetry mode, walk.cuh):
// a floor above the multiply-add bound at 3.35 TB/s.  What sets its time is the issue of
// dependent multiply and carry chains, then that traffic.  What the
// design does about each:
//   - one safegcd inversion per thread and step (field.cuh), shared by
//     G = 64 lanes (Montgomery's trick): 3160 multiply-add slots
//     against a Fermat chain's 25,680, and a dependent chain short
//     enough for 64 lanes to hide, so that 2^22 lanes make 65,536
//     threads;
//   - 4 resident blocks of 128 threads per SM (launch bounds: at most
//     128 registers a thread, no spill), 4 warps per scheduler to hide
//     the dependent chains; 2^22 lanes are 512 blocks, one wave;
//   - the window's state packed into 32-bit words (walk.cuh), so a step
//     moves 256 B per lane instead of the 448 B of 16-bit limbs;
//   - the jump table in shared memory, each row coalesced across the
//     warp.
#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

template <bool SYM>
__global__ void __launch_bounds__(kt::THREADS, kt::MIN_BLOCKS)
kt_jump_kernel(kt::WalkArgs a, const int32_t* __restrict__ jx,
               const int32_t* __restrict__ jy,
               const int32_t* __restrict__ jd) {
    __shared__ kt::JumpTable tb;
    for (int k = threadIdx.x; k < 8 * kt::NB_JUMP; k += blockDim.x)
        kt::pack_table_word(&tb, jx, jy, jd, k);
    __syncthreads();
    uint32_t acc[kt::GROUP][8];  // prefix products (local memory)
    kt::walk_thread<SYM>(a, tb, blockIdx.x, threadIdx.x, acc);
}

const void* walk_kernel(bool sym) {
    return sym ? (const void*)kt_jump_kernel<true>
               : (const void*)kt_jump_kernel<false>;
}

}  // namespace

extern "C" {

// The kernels' geometry: out[0] threads per block, out[1] lanes per
// thread (G; n must be a multiple of THREADS * G), out[2] the resident
// blocks per SM the launch bounds ask for, out[3] scratch rows.
void kt_walk_geometry(int* out) {
    out[0] = kt::THREADS;
    out[1] = kt::GROUP;
    out[2] = kt::MIN_BLOCKS;
    out[3] = kt::SCRATCH_ROWS;
}

// Attributes of the plain (sym = 0) or the symmetry walk kernel: out[0]
// registers per thread, out[1] local memory bytes per thread, out[2]
// static shared memory per block, out[3] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a
// cudaError_t.
int kt_walk_occupancy(int sym, int* out) {
    const void* fn = walk_kernel(sym != 0);
    cudaFuncAttributes at;
    cudaError_t e = cudaFuncGetAttributes(&at, fn);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      kt::THREADS, 0);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = (int)at.sharedSizeBytes;
    out[3] = blocks;
    return (int)e;
}

// Launch one window on `stream` (no synchronization): the symmetry
// kernel when `symclass` is not null, else the plain one.  `scratch` is
// (SCRATCH_ROWS, n) 32-bit words that the window's state is packed into.
// Returns the cudaError_t of the launch (0 on success).
int kt_jump_steps(void* px, void* py, void* d, const void* jx,
                  const void* jy, const void* jd, const void* masks, int n,
                  int nb_run, int slots, void* count, void* dpx, void* dpd,
                  void* dstep, void* symclass, void* scratch, void* stream) {
    if (n <= 0 || n % kt::LANES != 0 || nb_run <= 0 || slots <= 0 ||
        !scratch)
        return (int)cudaErrorInvalidValue;
    kt::WalkArgs a;
    a.px = static_cast<int32_t*>(px);
    a.py = static_cast<int32_t*>(py);
    a.d = static_cast<int32_t*>(d);
    a.masks = static_cast<const int32_t*>(masks);
    a.n = (size_t)n;
    a.nb_run = nb_run;
    a.slots = slots;
    a.count = static_cast<int32_t*>(count);
    a.dpx = static_cast<int32_t*>(dpx);
    a.dpd = static_cast<int32_t*>(dpd);
    a.dstep = static_cast<int32_t*>(dstep);
    a.symclass = static_cast<int32_t*>(symclass);
    a.scratch = static_cast<uint32_t*>(scratch);
    const auto tx = static_cast<const int32_t*>(jx);
    const auto ty = static_cast<const int32_t*>(jy);
    const auto td = static_cast<const int32_t*>(jd);
    const auto st = static_cast<cudaStream_t>(stream);
    if (symclass)
        kt_jump_kernel<true><<<n / kt::LANES, kt::THREADS, 0, st>>>(a, tx, ty,
                                                                   td);
    else
        kt_jump_kernel<false><<<n / kt::LANES, kt::THREADS, 0, st>>>(a, tx,
                                                                    ty, td);
    return (int)cudaGetLastError();
}

const char* kt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
