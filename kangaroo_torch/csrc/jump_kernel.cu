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
// jump table and the C entry point bound with ctypes by
// kangaroo_torch/ops/jump_cuda.py.
//
// The TPU deferred the symmetry flips to the window's end because a
// per-step canonicalize, compare and two wide selects cost its vector
// unit much; here they are ~80 integer adds and logic ops per lane and
// step, no multiply, against ~1030 multiply-adds, so the kernel
// normalizes eagerly.
//
// What bounds it on this card.  The function itself needs ~1030 32-bit
// integer multiply-add issue slots per jump (ops/jump_cuda.py counts
// them: a field multiply is 64 + 8 wide multiply-adds, a squaring
// 36 + 8; per jump 5 multiplies and 1 squaring on the lane plus
// 1/GROUP of the Fermat inversion's 255 squarings and 15 multiplies),
// and next to nothing of
// device memory.  This design adds its own traffic: it re-streams the
// limb state and the prefix products through device memory every step,
// 448 B per lane and step (460 B in symmetry mode, walk.cuh), a floor
// above the multiply-add bound at 3.35 TB/s.  It shares one inversion
// across GROUP lanes (Montgomery's trick), keeps the jump table in
// shared memory, and coalesces each limb row across the warp; holding
// the state in registers across steps is later work.
#include <cuda_runtime.h>

#include "walk.cuh"

namespace {

template <bool SYM>
__global__ void __launch_bounds__(kt::THREADS)
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

}  // namespace

extern "C" {

// Lanes per block: n must be a multiple of this.
int kt_lane_quantum() { return kt::LANES; }

// Launch one window on `stream` (no synchronization): the symmetry
// kernel when `symclass` is not null, else the plain one.  Returns the
// cudaError_t of the launch (0 on success).
int kt_jump_steps(void* px, void* py, void* d, const void* jx,
                  const void* jy, const void* jd, const void* masks, int n,
                  int nb_run, int slots, void* count, void* dpx, void* dpd,
                  void* dstep, void* symclass, void* stream) {
    if (n <= 0 || n % kt::LANES != 0 || nb_run <= 0 || slots <= 0)
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
