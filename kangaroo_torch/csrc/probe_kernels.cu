// Hopper (sm_90a) probe kernels: the counterparts of the repository's
// five TPU probe kernels, each measuring one part of the walk kernel's
// cost on the card.
//
//   kt_field_chain<Op>     replaces scripts/pkbench.py:62 run_chain (body
//                          chain_kernel :46): a <- op(a, b) `rounds`
//                          times per lane, op one of field.cuh's
//                          fe_mul, fe_sqr, fe_sub, fe_add, fe_fold,
//                          fe_canon, fe_inv, the shared-memory table
//                          gather, or a jump step without DP or distance
//                          on the walk's geometry.  At one round it is
//                          -check's field-volume oracle on the card.
//   kt_reduce512_kernel    replaces none: fe_reduce512 once on any
//                          512-bit input, for the card tests of the
//                          reduction's carry chains.
//   kt_raw_chain<Op, ILP>  replaces scripts/probe_ops.py:49 and
//                          scripts/layout_probe.py:109: on Hopper both
//                          are a chain of one 32-bit instruction per
//                          element and iteration with ILP independent
//                          chains per thread; they differ only in ILP
//                          and thread count.  Each trip of the loop
//                          unrolls 128 element-iterations of a thread
//                          (probes.cuh RAW_TRIP): the counter, compare
//                          and branch once a trip; the layout chain's
//                          index i + 1 folded into its LOP3; shr16's
//                          shift-and-add one LEA.HI (its IMAD.HI
//                          forms are contrasts).  Dynamic shared
//                          memory pads a launch down to a chosen
//                          occupancy.
//   kt_delta_kernel<V, G>  replaces scripts/pkdelta.py:213 run_variant:
//                          the production walk body (walk.cuh) with one
//                          component switched by V, at the walk
//                          kernels' G and launch bounds; V =
//                          kt::Production at G = GROUP is the production
//                          kernel's own code, and runs at G = 32 and 128
//                          as well (the G sweep).
//   kt_inv_chain<Var, G>   replaces scripts/pkinv.py:129 run: the walk's
//                          per-thread Montgomery inversion over G lanes
//                          (cur), without its fe_inv (nodiv), or none,
//                          in the walk's layout: every lane read and
//                          written in device memory in both passes of
//                          every iteration, the G prefix products in
//                          local memory (the walk's attribution).
//   kt_inv_chip<Var, G>    the same function as the TPU kernel designs
//                          it (its (16, W) block in VMEM for the whole
//                          loop): the thread's G lanes and their prefix
//                          products in shared memory for the whole
//                          launch, x read and written once, no local
//                          memory; one wave of the blocks that stay
//                          resident (probes.cuh, inv_chip_thread).
//
// What bounds them: P1's multiply ops, P3 and P4 issue 32-bit integer
// multiply-adds (the walk's bound); the add, subtract, canonicalize and
// fold chains, and P4's none, integer adds and logic ops on the ALU
// pipe; the gather shared-memory loads; P2 the one pipe its instruction
// runs on.  Each state array is read once and written once per launch,
// so every probe is bound by operations at its default shape
// (ops/probe_cuda.py counts them).  The bodies live in probes.cuh and
// walk.cuh, built by g++ for the CPU tests too; this file adds the
// launches, a table of kernels for the attributes and occupancy, and
// the C entry points bound with ctypes by kangaroo_torch/ops/
// probe_cuda.py.
//
// Built in parts, one nvcc each, all started together and linked into
// one library (ops/probe_cuda.py), so that the build takes the time of
// its slowest part: the kernels that hold a whole walk body take the
// longest.  KT_PROBE_PART
// selects what a part compiles: 0 the entry points, P1's one-lane
// chains but fe_inv, and P2; 1 P1's fe_inv; 2 P1's step; 3 and 4 P4
// below and from G = 128; 5-8 the walk variants of P3 with ids 0-2
// (base at each G), 3-4, 5-6, 7-8; 9 and 10 P4's on-chip form, cur and
// the others.  Without KT_PROBE_PART one compile builds everything.
#include <cuda_runtime.h>

#include "probes.cuh"

#ifndef KT_PROBE_PART
#define KT_PROBE_PART -1
#endif
#define KT_PART(p) (KT_PROBE_PART < 0 || KT_PROBE_PART == (p))

using FieldFn = void (*)(int32_t*, const int32_t*, size_t, int,
                         const int32_t*, const int32_t*);
using RawFn = void (*)(void*, size_t, int, uint32_t);
using DeltaFn = void (*)(kt::WalkArgs, const int32_t*, const int32_t*,
                         const int32_t*);
using InvFn = void (*)(int32_t*, size_t, int);

// The kernel of an op or variant, or null; each getter is defined in
// the part that compiles its kernels.
FieldFn kt_field_kernel_light(int op);
FieldFn kt_field_kernel_inv(int op);
FieldFn kt_field_kernel_step(int op);
RawFn kt_raw_kernel(int op, int ilp);
InvFn kt_inv_kernel_below128(int var, int group);
InvFn kt_inv_kernel_from128(int var, int group);
InvFn kt_inv_chip_kernel_cur(int var, int group);
InvFn kt_inv_chip_kernel_rest(int var, int group);
DeltaFn kt_delta_kernel_0_3(int id, int group);
DeltaFn kt_delta_kernel_3_5(int id, int group);
DeltaFn kt_delta_kernel_5_7(int id, int group);
DeltaFn kt_delta_kernel_7_9(int id, int group);
static_assert(kt::DELTA_NVARIANTS == 9, "the P3 parts cover ids 0..8");

namespace {

template <class V, int G>
__global__ void __launch_bounds__(kt::THREADS, kt::MIN_BLOCKS)
kt_delta_kernel(kt::WalkArgs a, const int32_t* __restrict__ jx,
                const int32_t* __restrict__ jy,
                const int32_t* __restrict__ jd) {
    __shared__ kt::JumpTable tb;
    for (int k = threadIdx.x; k < 8 * kt::NB_JUMP; k += blockDim.x)
        kt::pack_table_word(&tb, jx, jy, jd, k);
    __syncthreads();
    uint32_t acc[G][8];
    kt::walk_thread<false, V, G>(a, tb, blockIdx.x, threadIdx.x, acc);
}

// The kernel of variant `id` at G = group among ids LO..HI-1 (only those
// are instantiated, each at the G of kt::delta_has_group), or null.
template <int LO, int HI>
DeltaFn delta_kernel_in(int id, int group) {
    DeltaFn fn = nullptr;
    if (!kt::delta_has_group(id, group)) return fn;
    kt::with_delta_variant<LO, HI>(id, [&](auto v) {
        using V = decltype(v);
        if constexpr (std::is_same<V, kt::Production>::value)
            kt::with_group(group, [&](auto gc) {
                fn = kt_delta_kernel<V, decltype(gc)::value>;
                return 0;
            });
        else
            fn = kt_delta_kernel<V, kt::GROUP>;
        return 0;
    });
    return fn;
}

template <int VAR, int G>
__global__ void __launch_bounds__(kt::THREADS)
kt_inv_chain(int32_t* x, size_t n, int iters) {
    uint32_t acc[VAR == kt::INV_NONE ? 1 : G][8];
    kt::inv_chain_thread<VAR, G>(x, n, blockIdx.x, threadIdx.x, iters, acc);
}

// The inversion chain kernel of (VAR, G) for G in GLO..GHI-1 (only
// those are instantiated), or null.
template <int GLO, int GHI>
struct InvPick {
    InvFn fn = nullptr;
    template <int VAR, int G>
    int run() {
        if constexpr (G >= GLO && G < GHI) fn = kt_inv_chain<VAR, G>;
        return 0;
    }
};

template <int GLO, int GHI>
InvFn inv_kernel_in(int var, int group) {
    InvPick<GLO, GHI> p;
    kt::with_inv_variant(var, group, p);
    return p.fn;
}

template <int VAR, int G>
__global__ void __launch_bounds__(kt::THREADS,
                                  kt::InvChip<VAR, G>::min_blocks)
kt_inv_chip(int32_t* x, size_t n, int iters) {
    extern __shared__ uint32_t sm[];
    kt::inv_chip_thread<VAR, G>(x, n, blockIdx.x, threadIdx.x, iters, sm);
}

// The on-chip kernel of (VAR, G) for the variants VARS (only those are
// instantiated), or null; and its dynamic shared memory per block.
template <int... VARS>
struct ChipPick {
    InvFn fn = nullptr;
    template <int VAR, int G>
    int run() {
        if constexpr (((VAR == VARS) || ...)) fn = kt_inv_chip<VAR, G>;
        return 0;
    }
};

struct ChipSmem {
    template <int VAR, int G>
    int run() {
        return kt::InvChip<VAR, G>::smem;
    }
};

template <int OP>
__global__ void __launch_bounds__(kt::THREADS)
kt_field_chain(int32_t* x, const int32_t* b, size_t n, int rounds,
               const int32_t* jx, const int32_t* jy) {
    __shared__ kt::JumpTable tb;
    if constexpr (OP == kt::F_GATHER || OP == kt::F_STEP) {
        // the (16, 32) tables jx, jy (jd unused: jx's first 8 rows)
        for (int k = threadIdx.x; k < 8 * kt::NB_JUMP; k += blockDim.x)
            kt::pack_table_word(&tb, jx, jy, jx, k);
        __syncthreads();
    }
    if constexpr (OP == kt::F_STEP) {
        uint32_t acc[kt::GROUP][8];
        kt::step_chain_thread(x, b, n, blockIdx.x, threadIdx.x, rounds, tb,
                              acc);
    } else {
        const size_t lane = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
        kt::field_chain_lane<OP>(x, b, n, lane, rounds, tb);
    }
}

// The field chain kernel of op, for the ops OPS (only those are
// instantiated), or null.
template <int... OPS>
struct FieldPick {
    FieldFn fn = nullptr;
    template <int OP>
    int run() {
        if constexpr (((OP == OPS) || ...)) fn = kt_field_chain<OP>;
        return 0;
    }
};

template <int... OPS>
FieldFn field_kernel_of(int op) {
    FieldPick<OPS...> p;
    kt::with_field_op(op, p);
    return p.fn;
}

}  // namespace

#if KT_PART(0)
namespace {

// fe_reduce512 once on each lane of lo + hi * 2^256 ((16, n) limbs
// each, the P1 layout): the reduction's carry chains on any 512-bit
// input, which no product of two field elements reaches.
__global__ void __launch_bounds__(kt::THREADS)
kt_reduce512_kernel(int32_t* r, const int32_t* lo, const int32_t* hi,
                    size_t n) {
    const size_t lane = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (lane >= n) return;
    uint32_t t[16], w[8];
    kt::load_words(t, 8, lo, n, lane);
    kt::load_words(t + 8, 8, hi, n, lane);
    kt::fe_reduce512(w, t);
    kt::store_words(r, w, 8, n, lane);
}

template <int OP, int ILP>
__global__ void __launch_bounds__(kt::THREADS)
kt_raw_chain(void* x, size_t nthreads, int inner, uint32_t mul) {
    const size_t tid = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (tid < nthreads)
        kt::raw_chain_thread<OP, ILP>(
            static_cast<typename kt::RawType<OP>::type*>(x), tid, nthreads,
            inner, mul);
}

struct RawPick {
    RawFn fn = nullptr;
    template <int OP, int ILP>
    int run() {
        fn = kt_raw_chain<OP, ILP>;
        return 0;
    }
};

FieldFn field_kernel(int op) {
    FieldFn fn = kt_field_kernel_light(op);
    if (!fn) fn = kt_field_kernel_inv(op);
    if (!fn) fn = kt_field_kernel_step(op);
    return fn;
}

DeltaFn delta_kernel(int id, int group) {
    DeltaFn fn = kt_delta_kernel_0_3(id, group);
    if (!fn) fn = kt_delta_kernel_3_5(id, group);
    if (!fn) fn = kt_delta_kernel_5_7(id, group);
    if (!fn) fn = kt_delta_kernel_7_9(id, group);
    return fn;
}

InvFn inv_kernel(int var, int group) {
    const InvFn fn = kt_inv_kernel_below128(var, group);
    return fn ? fn : kt_inv_kernel_from128(var, group);
}

InvFn inv_chip_kernel(int var, int group) {
    const InvFn fn = kt_inv_chip_kernel_cur(var, group);
    return fn ? fn : kt_inv_chip_kernel_rest(var, group);
}

// The kernel of (family, id, arg): 0 field chain op, 1 raw chain (op,
// ilp), 2 walk variant (variant, group), 3 inversion chain (variant,
// group), 4 its on-chip form (variant, group).
const void* probe_kernel(int family, int id, int arg) {
    switch (family) {
        case 0: return (const void*)field_kernel(id);
        case 1: return (const void*)kt_raw_kernel(id, arg);
        case 2: return (const void*)delta_kernel(id, arg);
        case 3: return (const void*)inv_kernel(id, arg);
        case 4: return (const void*)inv_chip_kernel(id, arg);
        default: return nullptr;
    }
}

// Let fn take smem bytes of dynamic shared memory (above the default
// 48 KB a block may have without asking).
cudaError_t allow_smem(const void* fn, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

FieldFn kt_field_kernel_light(int op) {
    return field_kernel_of<kt::F_MUL, kt::F_SQR, kt::F_SUB, kt::F_ADD,
                           kt::F_FOLD, kt::F_CANON, kt::F_GATHER>(op);
}

RawFn kt_raw_kernel(int op, int ilp) {
    RawPick p;
    kt::with_raw_chain(op, ilp, p);
    return p.fn;
}
#endif

#if KT_PART(1)
FieldFn kt_field_kernel_inv(int op) { return field_kernel_of<kt::F_INV>(op); }
#endif
#if KT_PART(2)
FieldFn kt_field_kernel_step(int op) {
    return field_kernel_of<kt::F_STEP>(op);
}
#endif
#if KT_PART(3)
InvFn kt_inv_kernel_below128(int var, int group) {
    return inv_kernel_in<0, 128>(var, group);
}
#endif
#if KT_PART(4)
InvFn kt_inv_kernel_from128(int var, int group) {
    return inv_kernel_in<128, 1 << 30>(var, group);
}
#endif
#if KT_PART(9)
InvFn kt_inv_chip_kernel_cur(int var, int group) {
    ChipPick<kt::INV_CUR> p;
    kt::with_inv_chip(var, group, p);
    return p.fn;
}
#endif
#if KT_PART(10)
InvFn kt_inv_chip_kernel_rest(int var, int group) {
    ChipPick<kt::INV_NODIV, kt::INV_NONE> p;
    kt::with_inv_chip(var, group, p);
    return p.fn;
}
#endif
#if KT_PART(5)
DeltaFn kt_delta_kernel_0_3(int id, int group) {
    return delta_kernel_in<0, 3>(id, group);
}
#endif
#if KT_PART(6)
DeltaFn kt_delta_kernel_3_5(int id, int group) {
    return delta_kernel_in<3, 5>(id, group);
}
#endif
#if KT_PART(7)
DeltaFn kt_delta_kernel_5_7(int id, int group) {
    return delta_kernel_in<5, 7>(id, group);
}
#endif
#if KT_PART(8)
DeltaFn kt_delta_kernel_7_9(int id, int group) {
    return delta_kernel_in<7, 9>(id, group);
}
#endif

#if KT_PART(0)
extern "C" {

int kt_probe_threads() { return kt::THREADS; }

int kt_probe_group() { return kt::GROUP; }

int kt_probe_min_blocks() { return kt::MIN_BLOCKS; }

// P1: `rounds` rounds of op on x (16, n) in place with b (16, n); jx,
// jy (16, 32) tables for the gather and the step (may be null for the
// others).  n is a multiple of THREADS, and of THREADS * GROUP for the
// step.  smem bytes of dynamic shared memory per block pad the launch
// down to a chosen occupancy.
int kt_field_chain_launch(int op, void* x, const void* b, const void* jx,
                          const void* jy, int n, int rounds, int smem,
                          void* stream) {
    const FieldFn fn = field_kernel(op);
    const int quantum = op == kt::F_STEP ? kt::LANES : kt::THREADS;
    const bool table = op == kt::F_GATHER || op == kt::F_STEP;
    if (!fn || n <= 0 || rounds < 0 || smem < 0 || n % quantum ||
        (table && !(jx && jy)))
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = allow_smem((const void*)fn, smem);
    if (e != cudaSuccess) return (int)e;
    fn<<<n / quantum, kt::THREADS, (size_t)smem,
         static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(x), static_cast<const int32_t*>(b), (size_t)n,
        rounds, static_cast<const int32_t*>(jx),
        static_cast<const int32_t*>(jy));
    return (int)cudaGetLastError();
}

// r (16, n) <- fe_reduce512(lo + hi * 2^256), lo and hi (16, n) limbs.
int kt_reduce512_launch(void* r, const void* lo, const void* hi, int n,
                        void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    kt_reduce512_kernel<<<(n + kt::THREADS - 1) / kt::THREADS, kt::THREADS,
                          0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(r), static_cast<const int32_t*>(lo),
        static_cast<const int32_t*>(hi), (size_t)n);
    return (int)cudaGetLastError();
}

// P2: `inner` iterations of op on n_elems elements of x in place (u32
// bits or f32), ILP chains per thread, blocks of THREADS threads (for
// narrow1's 2^16 threads 512 blocks: 3 or 4 an SM, each block's warps
// one a scheduler, 4 warps on the busiest of the 528 schedulers, as
// ceil(2048 / 528) allows); smem bytes of dynamic shared memory per
// block pad the launch down to a chosen occupancy.  The shr16 rows'
// multiplier 2^16 goes as an argument, so that ptxas keeps the IMAD.HI
// of the chains meant for the multiply-add pipe (probes.cuh
// mulhi_add).
int kt_raw_chain_launch(int op, int ilp, void* x, int n_elems, int inner,
                        int smem, void* stream) {
    const RawFn fn = kt_raw_kernel(op, ilp);
    if (!fn || n_elems <= 0 || n_elems % ilp || inner < 0 || smem < 0)
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = allow_smem((const void*)fn, smem);
    if (e != cudaSuccess) return (int)e;
    const size_t threads = (size_t)n_elems / ilp;
    const size_t blocks = (threads + kt::THREADS - 1) / kt::THREADS;
    fn<<<(unsigned)blocks, kt::THREADS, (size_t)smem,
         static_cast<cudaStream_t>(stream)>>>(x, threads, inner,
                                              kt::SHR_MUL);
    return (int)cudaGetLastError();
}

// P3: one window of walk variant `variant` at G = group lanes per thread
// (kt_jump_steps' arguments, plain mode; n a multiple of THREADS * G).
int kt_delta_launch(int variant, int group, void* px, void* py, void* d,
                    const void* jx, const void* jy, const void* jd,
                    const void* masks, int n, int nb_run, int slots,
                    void* count, void* dpx, void* dpd, void* dstep,
                    void* scratch, void* stream) {
    const DeltaFn fn = delta_kernel(variant, group);
    if (!fn || n <= 0 || n % (kt::THREADS * group) != 0 || nb_run <= 0 ||
        slots <= 0 || !scratch)
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
    a.symclass = nullptr;
    a.scratch = static_cast<uint32_t*>(scratch);
    fn<<<n / (kt::THREADS * group), kt::THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const int32_t*>(jx), static_cast<const int32_t*>(jy),
        static_cast<const int32_t*>(jd));
    return (int)cudaGetLastError();
}

// P4: `iters` rounds of variant (0 cur, 1 nodiv, 2 none) at G = group
// lanes per thread on x (16, n) in place; n a multiple of THREADS * G.
int kt_inv_chain_launch(int variant, int group, void* x, int n, int iters,
                        void* stream) {
    const InvFn fn = inv_kernel(variant, group);
    if (!fn || n <= 0 || n % (kt::THREADS * group) != 0 || iters < 0)
        return (int)cudaErrorInvalidValue;
    fn<<<n / (kt::THREADS * group), kt::THREADS, 0,
         static_cast<cudaStream_t>(stream)>>>(static_cast<int32_t*>(x),
                                              (size_t)n, iters);
    return (int)cudaGetLastError();
}

// P4's on-chip form: `iters` rounds of variant (0 cur, 1 nodiv, 2 none)
// at G = group lanes per thread on x (16, n) in place, n a multiple of
// THREADS * G, with kt_inv_chip_smem bytes of shared memory a block.
int kt_inv_chip_launch(int variant, int group, void* x, int n, int iters,
                       void* stream) {
    const InvFn fn = inv_chip_kernel(variant, group);
    if (!fn || n <= 0 || n % (kt::THREADS * group) != 0 || iters < 0)
        return (int)cudaErrorInvalidValue;
    const int smem = kt::with_inv_chip(variant, group, ChipSmem{});
    const cudaError_t e = allow_smem((const void*)fn, smem);
    if (e != cudaSuccess) return (int)e;
    fn<<<n / (kt::THREADS * group), kt::THREADS, (size_t)smem,
         static_cast<cudaStream_t>(stream)>>>(static_cast<int32_t*>(x),
                                              (size_t)n, iters);
    return (int)cudaGetLastError();
}

// Dynamic shared memory per block of the on-chip kernel of (variant,
// group), or -1 where there is no such kernel.
int kt_inv_chip_smem(int variant, int group) {
    return kt::with_inv_chip(variant, group, ChipSmem{});
}

// Lanes of a run of the on-chip kernel (probes.cuh CHIP_RUN).
int kt_inv_chip_run() { return kt::CHIP_RUN; }

// Attributes of the kernel of (family, id, arg) (see probe_kernel) with
// smem bytes of dynamic shared memory: out[0] registers per thread,
// out[1] local memory bytes per thread, out[2] static shared memory per
// block, out[3] resident blocks per SM.  Returns a cudaError_t.
int kt_probe_attrs(int family, int id, int arg, int smem, int* out) {
    const void* fn = probe_kernel(family, id, arg);
    if (!fn) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes at;
    cudaError_t e = cudaFuncGetAttributes(&at, fn);
    if (e == cudaSuccess) e = allow_smem(fn, smem);
    if (e != cudaSuccess) return (int)e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      kt::THREADS, smem);
    out[0] = at.numRegs;
    out[1] = (int)at.localSizeBytes;
    out[2] = (int)at.sharedSizeBytes;
    out[3] = blocks;
    return (int)e;
}

const char* kt_probe_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
#endif
