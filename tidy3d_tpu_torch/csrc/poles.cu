// The pole-current update of the pallas2 tier for NVIDIA Hopper (sm_90a):
// every pole slot, component and copy of a runner or brick in one launch.
//
// Replaces no pallas_call: in the JAX package the update is XLA code inside
// the jitted FDTDRunner._step, FDTDRunner._update_poles
// (tidy3d_tpu/solver/fdtd.py:1145-1184, called at :1691), after the E
// update, the J sources and the modulation and nonlinear passes. Eager
// PyTorch (solver/kernels/poles.py update_poles, the plain version) takes
// some seven full-grid launches per (slot, component, copy). Per slot p and
// component c, in place on the slot's currents:
//
//   esum = E^{n+1} + E^n                       (once per copy and component)
//   qr'  = Re(A) qr - Im(A) qi  [+ B0r mask esum | + br esum]
//   qi'  = Im(A) qr + Re(A) qi  [+ B0i mask esum | + bi esum]
//
// the bracket by the slot's kind on c (pole_B_meta): none (ZERO), the
// scalar B0 = (re, im) times a support mask (MASK; mask * esum formed
// first, a zero part skipped, as the reference does) or the dense residue
// maps (br, bi) (DENSE).
//
// Storage: the fields and the currents are float32 or bfloat16
// (T3D_FIELD_BF16, T3D_Q_BF16: one library per combination). The rounding
// points are the plain version's, which are the reference's under JAX's
// promotion rules: a Python scalar keeps a tensor's type, so each product
// A * q, and their sum, is rounded to the currents' type, and esum to the
// fields'; the float32 residue term and the sum with it are float32, and
// Q' is rounded once more where it is stored. Every operation is rounded
// as written (the _rn intrinsics, no contraction), so with bfloat16 storage
// the kernel gives the plain version's values bit for bit, and in float32
// those of the out-of-place plain update (pole_update).
//
// The slots come from a device table of PoleSlot (the layout of the fused
// kernel's, q_out equal to q here), grouped by copy, staged in shared
// memory once a block; a table of more than MAX_SLOTS records runs as
// consecutive launches over parts of it (each with its own copy ranges and
// E arrays), which give the one launch's values: a record reads only its
// own currents and its copy's E^{n+1} and E^n. A thread takes VW = 4 cells a pass (one 16-byte
// load of each float32 array, 8 bytes in bfloat16, where every array is
// aligned to 4 values and the cell count divides by 4; else cell by cell):
// per copy and component it loads E^{n+1} and E^n once, then per slot the
// currents and the mask or the dense maps once, and stores Q' once.
//
// The bound is HBM bandwidth: every slot's six currents read and written,
// E^{n+1} and E^n of each (copy, component) a residue reads, and each
// distinct mask or dense map read once (a mask shared by the slots of one
// metal is re-read from L1/L2 by the same thread). Nothing else is moved;
// the arithmetic is a few operations a byte below the card's float32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int VW = 4;            // cells a thread takes a pass
constexpr int MAX_COPIES = 2;    // MAX_COPIES in solver/kernels/poles.py
constexpr int MAX_SLOTS = 240;   // MAX_SLOTS: the staged table under 48 KB
                                 // (the host cuts a larger table into
                                 // launches of at most this many)

enum { POLE_ZERO = 0, POLE_MASK = 1, POLE_DENSE = 2 };

#ifdef T3D_FIELD_BF16
typedef __nv_bfloat16 field_t;
#else
typedef float field_t;
#endif
#ifdef T3D_Q_BF16
typedef __nv_bfloat16 q_t;
#else
typedef float q_t;
#endif

// One pole slot of one copy. Mirrored by PoleSlot in
// tidy3d_tpu_torch/solver/kernels/poles.py; the layout of csrc/fused.cu's
// PoleSlot, its last word the copy.
struct PoleSlot {
    const q_t* q[6];          // [comp * 2 + (0 qr, 1 qi)]
    q_t* q_out[6];            // Q' (here q: the update is in place)
    const float* b[6];        // the mask (part 0) or the dense re/im maps
    float gc_re, gc_im;       // Gc = a (A + 1) (read by the E update only)
    float a_re, a_im;         // A = (1 + a dt/2) / (1 - a dt/2)
    float b0[6];              // mask kind: B0 (re, im) per comp
    int32_t kind[3];          // POLE_* per comp
    int32_t copy;             // the copy whose E^{n+1} and E^n it reads
};
static_assert(sizeof(PoleSlot) % 8 == 0, "the table stages in 8-byte words");

// Mirrored by PoleParams in tidy3d_tpu_torch/solver/kernels/poles.py.
struct PoleParams {
    const field_t* e_new[MAX_COPIES * 3];  // E^{n+1} of [copy * 3 + comp],
    const field_t* e_old[MAX_COPIES * 3];  // E^n; null where no slot of the
                                           // copy has a residue on comp
    const PoleSlot* slots;     // the table, copy 0's slots first
    int32_t first[MAX_COPIES + 1];  // copy c: slots first[c] .. first[c+1]-1
    int32_t num_copies;
    int32_t n;                 // cells of a component (< 2^31)
    int32_t vec;               // every array aligned to VW values, n % VW == 0
};

__device__ __forceinline__ float wid(float v) { return v; }
__device__ __forceinline__ float wid(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// v rounded to nearest even at the storage type T, widened back
template <class T>
__device__ __forceinline__ float rnd(float v) {
    if constexpr (sizeof(T) == 2)
        return __bfloat162float(__float2bfloat16_rn(v));
    else
        return v;
}

__device__ __forceinline__ float lo16(unsigned w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi16(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16;
}

// VW values at p (aligned): RO through the read-only path (E, the maps),
// else a plain load (the currents, which the same thread then overwrites)
template <bool RO>
__device__ __forceinline__ void ld4(const float* p, float (&v)[VW]) {
    const float4 t = RO ? __ldg(reinterpret_cast<const float4*>(p))
                        : *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
template <bool RO>
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&v)[VW]) {
    const uint2 t = RO ? __ldg(reinterpret_cast<const uint2*>(p))
                       : *reinterpret_cast<const uint2*>(p);
    v[0] = lo16(t.x); v[1] = hi16(t.x); v[2] = lo16(t.y); v[3] = hi16(t.y);
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st4(float* p, const float (&v)[VW]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[VW]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]),
                                              pack2(v[2], v[3]));
}

// The cnt (<= VW) values from p + i0, widened; zeros past cnt.
template <bool VEC, bool RO, class T>
__device__ __forceinline__ void load(const T* p, int i0, int cnt,
                                     float (&v)[VW]) {
    if (VEC) {
        ld4<RO>(p + i0, v);
    } else {
#pragma unroll
        for (int k = 0; k < VW; ++k)
            v[k] = k < cnt ? wid(p[i0 + k]) : 0.0f;
    }
}

template <bool VEC, class T>
__device__ __forceinline__ void store(T* p, int i0, int cnt,
                                      const float (&v)[VW]) {
    if (VEC) {
        st4(p + i0, v);
    } else {
#pragma unroll
        for (int k = 0; k < VW; ++k)
            if (k < cnt) st1(p + i0 + k, v[k]);
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
poles_kernel(const __grid_constant__ PoleParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const PoleSlot* tab = reinterpret_cast<const PoleSlot*>(smem);
    {
        const int words = p.first[p.num_copies] * (int)sizeof(PoleSlot) / 8;
        const uint2* src = reinterpret_cast<const uint2*>(p.slots);
        uint2* dst = reinterpret_cast<uint2*>(smem);
        for (int w = threadIdx.x; w < words; w += THREADS) dst[w] = src[w];
    }
    __syncthreads();
    const int units = (p.n + VW - 1) / VW;
    const int stride = gridDim.x * THREADS;
    for (int u = blockIdx.x * THREADS + threadIdx.x; u < units; u += stride) {
        const int i0 = u * VW;
        const int cnt = min(VW, p.n - i0);
        for (int c = 0; c < p.num_copies; ++c) {
#pragma unroll 1
            for (int i = 0; i < 3; ++i) {
                float es[VW] = {0.0f, 0.0f, 0.0f, 0.0f};
                if (p.e_new[c * 3 + i]) {
                    float eo[VW];
                    load<VEC, true>(p.e_new[c * 3 + i], i0, cnt, es);
                    load<VEC, true>(p.e_old[c * 3 + i], i0, cnt, eo);
#pragma unroll
                    for (int k = 0; k < VW; ++k)
                        es[k] = rnd<field_t>(__fadd_rn(es[k], eo[k]));
                }
                for (int s = p.first[c]; s < p.first[c + 1]; ++s) {
                    const PoleSlot& sl = tab[s];
                    float r[VW], m[VW];
                    load<VEC, false>(sl.q[2 * i], i0, cnt, r);
                    load<VEC, false>(sl.q[2 * i + 1], i0, cnt, m);
                    const float are = sl.a_re, aim = sl.a_im;
#pragma unroll
                    for (int k = 0; k < VW; ++k) {
                        const float qr = r[k], qi = m[k];
                        const float rr = rnd<q_t>(__fmul_rn(qr, are));
                        const float ri = rnd<q_t>(__fmul_rn(qi, aim));
                        const float mr = rnd<q_t>(__fmul_rn(qr, aim));
                        const float mi = rnd<q_t>(__fmul_rn(qi, are));
                        r[k] = rnd<q_t>(__fsub_rn(rr, ri));
                        m[k] = rnd<q_t>(__fadd_rn(mr, mi));
                    }
                    const int kind = sl.kind[i];
                    if (kind == POLE_MASK) {
                        float mk[VW];
                        load<VEC, true>(sl.b[2 * i], i0, cnt, mk);
                        const float br = sl.b0[2 * i], bi = sl.b0[2 * i + 1];
#pragma unroll
                        for (int k = 0; k < VW; ++k) {
                            const float mes = __fmul_rn(mk[k], es[k]);
                            if (br != 0.0f)
                                r[k] = __fadd_rn(r[k], __fmul_rn(br, mes));
                            if (bi != 0.0f)
                                m[k] = __fadd_rn(m[k], __fmul_rn(bi, mes));
                        }
                    } else if (kind == POLE_DENSE) {
                        float br[VW], bi[VW];
                        load<VEC, true>(sl.b[2 * i], i0, cnt, br);
                        load<VEC, true>(sl.b[2 * i + 1], i0, cnt, bi);
#pragma unroll
                        for (int k = 0; k < VW; ++k) {
                            r[k] = __fadd_rn(r[k], __fmul_rn(br[k], es[k]));
                            m[k] = __fadd_rn(m[k], __fmul_rn(bi[k], es[k]));
                        }
                    }
                    store<VEC>(sl.q_out[2 * i], i0, cnt, r);
                    store<VEC>(sl.q_out[2 * i + 1], i0, cnt, m);
                }
            }
        }
    }
}

typedef void (*KernelFn)(PoleParams);

static KernelFn kernel_for(bool vec) {
    return vec ? poles_kernel<true> : poles_kernel<false>;
}

extern "C" int t3d_poles_params_size() { return (int)sizeof(PoleParams); }
extern "C" int t3d_poles_slot_size() { return (int)sizeof(PoleSlot); }

// The bytes of the field and pole-current values this library stores.
extern "C" void t3d_poles_storage(int32_t* sizes) {
    sizes[0] = (int32_t)sizeof(field_t);
    sizes[1] = (int32_t)sizeof(q_t);
}

// Threads, shared bytes, blocks per SM and registers of the aligned (vec)
// or cell-by-cell instantiation with num_slots slots staged; a CUDA error
// code, or 0.
extern "C" int t3d_poles_info(int vec, int num_slots, int32_t* out) {
    const KernelFn fn = kernel_for(vec != 0);
    const size_t shared = (size_t)num_slots * sizeof(PoleSlot);
    out[0] = THREADS;
    out[1] = (int32_t)shared;
    int blocks = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, (const void*)fn, THREADS, shared);
    if (err != cudaSuccess) return (int)err;
    out[2] = blocks;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, (const void*)fn);
    out[3] = attr.numRegs;
    return (int)err;
}

// One launch over every cell, slot, component and copy. counts (may be
// null): blocks, launches.
extern "C" int t3d_poles(const PoleParams* p, void* stream, int32_t* counts) {
    if (p->n <= 0) return 0;
    if (p->num_copies < 1 || p->num_copies > MAX_COPIES || !p->slots)
        return (int)cudaErrorInvalidValue;
    const int num_slots = p->first[p->num_copies];
    if (p->first[0] != 0 || num_slots < 1 || num_slots > MAX_SLOTS)
        return (int)cudaErrorInvalidValue;
    for (int c = 0; c < p->num_copies; ++c)
        if (p->first[c + 1] < p->first[c]) return (int)cudaErrorInvalidValue;
    const uintptr_t fa = VW * sizeof(field_t);
    if (p->vec) {
        if (p->n % VW) return (int)cudaErrorInvalidValue;
        for (int j = 0; j < 3 * p->num_copies; ++j)
            if ((uintptr_t)p->e_new[j] % fa || (uintptr_t)p->e_old[j] % fa)
                return (int)cudaErrorMisalignedAddress;
    }
    const KernelFn fn = kernel_for(p->vec != 0);
    const size_t shared = (size_t)num_slots * sizeof(PoleSlot);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, (const void*)fn, THREADS, shared);
    if (err != cudaSuccess) return (int)err;
    const int64_t need = ((int64_t)(p->n + VW - 1) / VW + THREADS - 1)
                         / THREADS;
    const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const int blocks = (int)(need < most ? need : most);
    fn<<<blocks, THREADS, shared, (cudaStream_t)stream>>>(*p);
    err = cudaGetLastError();
    if (counts) {
        counts[0] = blocks;
        counts[1] = 1;
    }
    return (int)err;
}
