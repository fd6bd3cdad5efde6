// The passes between the E update and the pole update, for NVIDIA Hopper
// (sm_90a): the semi-implicit solve of time-modulated permittivity and
// conductivity, then the chi3 / Kerr / two-photon-absorption fixed point.
//
// Replaces no pallas_call: in the JAX package these passes are XLA code
// inside the jitted FDTDRunner._step (tidy3d_tpu/solver/fdtd.py:1632-1688),
// which XLA fuses into one loop over the cells. Eager PyTorch would launch
// some ten operations per component, entry and sweep; this kernel does all
// of it in one launch. Per cell and component it loads E_lin (the E family
// with its J sources) and E (the field before the step) once, and each
// coefficient map once, and stores E' once, in place over E_lin:
//
//   for each modulation entry (in order) that modulates the component:
//     num = Beps1 c_n + Beps2 s_n - S,  den = Beps1 c_n1 + Beps2 s_n1 + S,
//     S = Bsig1 c_h + Bsig2 s_h,  E_lin = (E_lin + num E) / (1 + den)
//   then num_iters sweeps from E' = E_lin:
//     E' = E_lin - B (E'^3 - E^3) - K ((E + E') / 2)^3
//
// A coefficient is a per-cell float32 map or, where uniform, a scalar in
// the parameter block; the entries' time samples (c_n ... s_h) of this
// step come by value. Every operation is rounded as written (the _rn
// intrinsics, no contraction), so in float32 the kernel gives the plain
// version's values (solver/nonlinear.py post_e_reference) bit for bit.
//
// Storage: E_lin, E and E' are float32 or bfloat16 (T3D_FIELD_BF16, one
// library each); they are widened where loaded and E' is rounded once, to
// nearest even, where it is stored.
//
// A grid-stride loop over z pairs (two cells a thread: one 64-bit load of
// each field in float32, 32-bit in bfloat16, where the arrays are aligned
// to a pair and the cell count is even; else cell by cell). The bound is
// HBM bandwidth: E_lin and E read and E' written per active component, plus
// the maps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_ENTRIES = 8;   // MAX_ENTRIES in solver/kernels/post_e.py
constexpr int THREADS = 256;

#ifdef T3D_FIELD_BF16
typedef __nv_bfloat16 field_t;
#else
typedef float field_t;
#endif

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
    return __uint_as_float(
        (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float2 ld2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));
    return make_float2(__uint_as_float(v << 16),
                       __uint_as_float(v & 0xffff0000u));
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st2(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float2 v) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v.x));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(v.y));
    *reinterpret_cast<unsigned*>(p) = lo | hi << 16;
}

// One modulation entry on one component. Mirrored by ModTerm in
// tidy3d_tpu_torch/solver/kernels/post_e.py.
struct ModTerm {
    const float* b[4];   // Beps1, Beps2, Bsig1, Bsig2 per cell, or null
    float bs[4];         // the scalar where the map is null
    int32_t has_eps;
    int32_t has_sig;
};

// Mirrored by PostEParams in tidy3d_tpu_torch/solver/kernels/post_e.py.
struct PostEParams {
    field_t* e[3];               // E_lin in, E' out (in place)
    const field_t* e_old[3];     // E before the step
    const float* nl_b[3];        // B per cell, or null for nl_bs
    const float* nl_k[3];        // K per cell, or null for nl_ks
    ModTerm mod[MAX_ENTRIES][3];
    float t[MAX_ENTRIES][6];     // c_n, s_n, c_n1, s_n1, c_h, s_h
    float nl_bs[3];
    float nl_ks[3];
    int32_t has_b[3];
    int32_t has_k[3];
    int32_t active[3];           // the component has a pass
    int32_t num_entries;
    int32_t num_iters;
    int32_t n;                   // cells of a component (< 2^31)
    int32_t vec;                 // set by t3d_post_e: pairs aligned
};
static_assert(sizeof(PostEParams) <= 4096,
              "kernel parameters must fit the 4 KB launch limit");

__device__ __forceinline__ float coef(const float* a, float s, int i) {
    return a ? __ldg(a + i) : s;
}

__device__ __forceinline__ float cube(float v) {
    return __fmul_rn(__fmul_rn(v, v), v);
}

// E' of one cell i of component c from E_lin v and E o.
__device__ __forceinline__ float cell(const PostEParams& p, int c, int i,
                                      float v, float o) {
    for (int en = 0; en < p.num_entries; ++en) {
        const ModTerm& m = p.mod[en][c];
        if (!m.has_eps && !m.has_sig) continue;
        const float* t = p.t[en];
        float num = 0.0f, den = 0.0f;
        if (m.has_eps) {
            const float b1 = coef(m.b[0], m.bs[0], i);
            const float b2 = coef(m.b[1], m.bs[1], i);
            num = __fadd_rn(num, __fadd_rn(__fmul_rn(b1, t[0]),
                                           __fmul_rn(b2, t[1])));
            den = __fadd_rn(den, __fadd_rn(__fmul_rn(b1, t[2]),
                                           __fmul_rn(b2, t[3])));
        }
        if (m.has_sig) {
            const float s = __fadd_rn(
                __fmul_rn(coef(m.b[2], m.bs[2], i), t[4]),
                __fmul_rn(coef(m.b[3], m.bs[3], i), t[5]));
            num = __fsub_rn(num, s);
            den = __fadd_rn(den, s);
        }
        v = __fdiv_rn(__fadd_rn(v, __fmul_rn(num, o)), __fadd_rn(1.0f, den));
    }
    if (p.has_b[c] || p.has_k[c]) {
        const float B = p.has_b[c] ? coef(p.nl_b[c], p.nl_bs[c], i) : 0.0f;
        const float K = p.has_k[c] ? coef(p.nl_k[c], p.nl_ks[c], i) : 0.0f;
        const float lin = v, o3 = cube(o);
        float it = v;
        for (int s = 0; s < p.num_iters; ++s) {
            float nw = lin;
            if (p.has_b[c])
                nw = __fsub_rn(nw, __fmul_rn(B, __fsub_rn(cube(it), o3)));
            if (p.has_k[c])
                nw = __fsub_rn(nw, __fmul_rn(K, cube(__fmul_rn(
                                                    0.5f, __fadd_rn(o, it)))));
            it = nw;
        }
        v = it;
    }
    return v;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
post_e_kernel(const __grid_constant__ PostEParams p) {
    const int npairs = (p.n + 1) / 2;
    const int stride = gridDim.x * THREADS;
    for (int k = blockIdx.x * THREADS + threadIdx.x; k < npairs;
         k += stride) {
        const int i0 = 2 * k;
        const bool two = i0 + 1 < p.n;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            if (!p.active[c]) continue;
            float2 v, o;
            if (VEC) {
                v = ld2(p.e[c] + i0);
                o = ld2(p.e_old[c] + i0);
            } else {
                v = make_float2(ld1(p.e[c] + i0),
                                two ? ld1(p.e[c] + i0 + 1) : 0.0f);
                o = make_float2(ld1(p.e_old[c] + i0),
                                two ? ld1(p.e_old[c] + i0 + 1) : 0.0f);
            }
            v.x = cell(p, c, i0, v.x, o.x);
            if (two) v.y = cell(p, c, i0 + 1, v.y, o.y);
            if (VEC) {
                st2(p.e[c] + i0, v);
            } else {
                st1(p.e[c] + i0, v.x);
                if (two) st1(p.e[c] + i0 + 1, v.y);
            }
        }
    }
}

typedef void (*KernelFn)(PostEParams);

static KernelFn kernel_for(bool vec) {
    return vec ? post_e_kernel<true> : post_e_kernel<false>;
}

extern "C" int t3d_post_e_params_size() { return (int)sizeof(PostEParams); }
extern "C" int t3d_post_e_field_bytes() { return (int)sizeof(field_t); }

// Threads, shared bytes, blocks per SM and registers of the pair-aligned
// (vec) or cell-by-cell instantiation; a CUDA error code, or 0.
extern "C" int t3d_post_e_info(int vec, int32_t* out) {
    const KernelFn fn = kernel_for(vec != 0);
    out[0] = THREADS;
    out[1] = 0;
    int blocks = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, (const void*)fn, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    out[2] = blocks;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, (const void*)fn);
    out[3] = attr.numRegs;
    return (int)err;
}

// One launch over every cell. counts (may be null): blocks, launches.
extern "C" int t3d_post_e(const PostEParams* p, void* stream,
                          int32_t* counts) {
    if (p->n <= 0) return 0;
    if (p->num_entries < 0 || p->num_entries > MAX_ENTRIES ||
        p->num_iters < 0)
        return (int)cudaErrorInvalidValue;
    PostEParams q = *p;
    bool vec = q.n % 2 == 0;
    const uintptr_t fa = 2 * sizeof(field_t);
    for (int c = 0; c < 3; ++c)
        if (q.active[c] &&
            ((uintptr_t)q.e[c] % fa || (uintptr_t)q.e_old[c] % fa))
            vec = false;
    q.vec = vec;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    const KernelFn fn = kernel_for(vec);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, (const void*)fn, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    const int64_t need = ((int64_t)(q.n + 1) / 2 + THREADS - 1) / THREADS;
    const int blocks = (int)(need < (int64_t)sms * per_sm
                                 ? need : (int64_t)sms * per_sm);
    fn<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(q);
    err = cudaGetLastError();
    if (counts) {
        counts[0] = blocks;
        counts[1] = 1;
    }
    return (int)err;
}
