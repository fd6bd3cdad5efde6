// Kernel lab: one vacuum leapfrog step per launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel make_step (scripts/kernel_lab.py:29, pallas_call at
// :117) and computes what lab_step_reference in
// tidy3d_tpu_torch/labs/kernel_lab.py specifies. One launch does both
// updates of one step on n^3 fields, E then H:
//
//   E' = ca * E + cb * curl_b(H)    backward differences; along x plane 0 is
//                                   its own neighbour (the clamped lo plane)
//   H' = ca * H - cb * curl_f(E')   forward differences; past plane n-1 the
//                                   x difference reads a virtual E' plane
//                                   computed with a zero x difference (the
//                                   clamped hi plane)
//
// y and z are periodic. The variant is a template parameter: CURL as above,
// NOROLL with neighbour = self in y and z (f - f * keep), COPY the 6 fields
// read and written. Storage is float or bf16; for bf16 every operation is
// rounded to bf16, as the JAX lab computes in bf16.
//
// Bound: bytes. 12 fields of n^3 once (2.72 GB at 384^3 f32: 0.811 ms at
// 3.35 TB/s) against 36 flops a cell (0.03 ms at 67 TFLOP/s).
//
// The copy variant has a launch of its own: each field as a flat run of
// 16-byte vectors, 4 loaded by a thread before it stores any, so that a
// bf16 request fills whole sectors and enough bytes are in flight. On the
// H100 it moves 2.90 TB/s (0.938 ms a step in f32, 0.475 in bf16 at 384^3:
// 0.88x and 0.78x torch._foreach_copy_ of the same fields; one value a
// thread and plane took 1.280 and 1.011, PERF.md). The stencil variants
// keep one value a thread: their staged E' and its y and z neighbours are
// indexed per cell, so 16-byte rows do not carry over unchanged.
//
// Design of the stencil variants: one block of 32 x 8 threads per (bx x
// planes, 8 y rows, 32 z cells); a warp reads 32 neighbouring z values.
// The block first computes
// E' on its cells and one more plane, row and column (the forward
// neighbours H' needs: the next block's first plane, or the virtual plane
// at the hi end) into shared memory, storing its own cells' E', then H' of
// its cells from shared memory. The y and z neighbours of the E' stage and
// the x neighbour plane come from L1/L2: each field is read from device
// memory about once.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored by LabStepParams in tidy3d_tpu_torch/labs/kernel_lab.py.
struct LabStepParams {
    const void* inp[6];   // Ex Ey Ez Hx Hy Hz, (n, n, n), z contiguous
    void* out[6];
    int64_t n;
    int32_t bx;           // x planes per block; divides n
    int32_t variant;      // 0 curl, 1 noroll, 2 copy
    int32_t bf16;         // storage (and arithmetic) in bf16
    float ca, cb, keep;   // rounded to bf16 by the wrapper for bf16
};

enum { CURL = 0, NOROLL = 1, COPY = 2 };

constexpr int TZ = 32;
constexpr int TY = 8;
constexpr int BZ = TZ + 1;  // the E' stage: one more row and column
constexpr int BY = TY + 1;
constexpr int MAX_BX = 32;
constexpr int COPY_THREADS = 256;  // the copy variant's block
constexpr int COPY_UNROLL = 4;     // 16-byte vectors in flight a thread

template <typename T> struct Num;
template <> struct Num<float> {
    static __device__ __forceinline__ float ld(const float* p, int64_t i) {
        return __ldg(p + i);
    }
    static __device__ __forceinline__ void st(float* p, int64_t i, float v) {
        p[i] = v;
    }
    static __device__ __forceinline__ float r(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
    static __device__ __forceinline__ float ld(const __nv_bfloat16* p,
                                               int64_t i) {
        return __bfloat162float(p[i]);
    }
    static __device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i,
                                              float v) {
        p[i] = __float2bfloat16_rn(v);
    }
    // every bf16 operation rounds its float result to bf16
    static __device__ __forceinline__ float r(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
};

template <int V, typename T>
__device__ __forceinline__ float bdiff(float f, float prev, float keep) {
    using N = Num<T>;
    if (V == NOROLL) return N::r(f - N::r(f * keep));
    return N::r(f - prev);
}

template <int V, typename T>
__device__ __forceinline__ float fdiff(float f, float next, float keep) {
    using N = Num<T>;
    if (V == NOROLL) return N::r(N::r(f * keep) - f);
    return N::r(next - f);
}

template <int V, typename T>
__global__ void __launch_bounds__(TZ * TY)
lab_step_kernel(const LabStepParams p) {
    using N = Num<T>;
    extern __shared__ float stage[];  // E' [3][bx + 1][BY][BZ]
    const int64_t n = p.n;
    const int bx = p.bx;
    const int64_t x0 = (int64_t)blockIdx.z * bx;
    const int64_t y0 = (int64_t)blockIdx.y * TY;
    const int64_t z0 = (int64_t)blockIdx.x * TZ;
    const int64_t sy = n, sx = n * n;
    const T* in[6];
    T* out[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
        in[c] = (const T*)p.inp[c];
        out[c] = (T*)p.out[c];
    }
    const int tid = threadIdx.y * TZ + threadIdx.x;

    const float ca = p.ca, cb = p.cb, keep = p.keep;
    const int plane = BY * BZ;
    const int span = (bx + 1) * plane;
    float* sEx = stage;
    float* sEy = stage + span;
    float* sEz = stage + 2 * span;
    const T* Ex = in[0]; const T* Ey = in[1]; const T* Ez = in[2];
    const T* Hx = in[3]; const T* Hy = in[4]; const T* Hz = in[5];

    // E' on planes [x0, x0 + bx], rows [y0, y0 + TY], columns [z0, z0 + TZ]
    for (int idx = tid; idx < span; idx += TZ * TY) {
        const int r = idx / plane;
        const int rem = idx - r * plane;
        const int j = rem / BZ;
        const int kz = rem - j * BZ;
        const int64_t x = x0 + r;             // n at the virtual plane
        const int64_t xs = x < n ? x : n - 1;  // the plane read
        const int64_t xm = x > 0 ? x - 1 : 0;  // its x neighbour (clamped)
        const int64_t y = (y0 + j) % n;
        const int64_t z = (z0 + kz) % n;
        const int64_t ym = y > 0 ? y - 1 : n - 1;
        const int64_t zm = z > 0 ? z - 1 : n - 1;
        const int64_t cell = xs * sx + y * sy + z;
        const int64_t cxm = xm * sx + y * sy + z;
        const int64_t cym = xs * sx + ym * sy + z;
        const int64_t czm = xs * sx + y * sy + zm;
        const float hx = N::ld(Hx, cell), hy = N::ld(Hy, cell),
                    hz = N::ld(Hz, cell);
        const float d_hz_y = bdiff<V, T>(hz, V == CURL ? N::ld(Hz, cym) : 0.f,
                                         keep);
        const float d_hy_z = bdiff<V, T>(hy, V == CURL ? N::ld(Hy, czm) : 0.f,
                                         keep);
        const float d_hx_z = bdiff<V, T>(hx, V == CURL ? N::ld(Hx, czm) : 0.f,
                                         keep);
        const float d_hx_y = bdiff<V, T>(hx, V == CURL ? N::ld(Hx, cym) : 0.f,
                                         keep);
        const float d_hz_x = N::r(hz - N::ld(Hz, cxm));
        const float d_hy_x = N::r(hy - N::ld(Hy, cxm));
        const float ex = N::r(N::r(ca * N::ld(Ex, cell)) +
                              N::r(cb * N::r(d_hz_y - d_hy_z)));
        const float ey = N::r(N::r(ca * N::ld(Ey, cell)) +
                              N::r(cb * N::r(d_hx_z - d_hz_x)));
        const float ez = N::r(N::r(ca * N::ld(Ez, cell)) +
                              N::r(cb * N::r(d_hy_x - d_hx_y)));
        sEx[idx] = ex;
        sEy[idx] = ey;
        sEz[idx] = ez;
        if (r < bx && j < TY && kz < TZ && y0 + j < n && z0 + kz < n) {
            N::st(out[0], cell, ex);
            N::st(out[1], cell, ey);
            N::st(out[2], cell, ez);
        }
    }
    __syncthreads();

    // H' on the block's own cells
    const int j = threadIdx.y, kz = threadIdx.x;
    const int64_t y = y0 + j, z = z0 + kz;
    if (y >= n || z >= n) return;
    for (int r = 0; r < bx; ++r) {
        const int s = r * plane + j * BZ + kz;
        const int64_t cell = (x0 + r) * sx + y * sy + z;
        const float ex = sEx[s], ey = sEy[s], ez = sEz[s];
        const float d_ez_y = fdiff<V, T>(ez, sEz[s + BZ], keep);
        const float d_ey_z = fdiff<V, T>(ey, sEy[s + 1], keep);
        const float d_ex_z = fdiff<V, T>(ex, sEx[s + 1], keep);
        const float d_ex_y = fdiff<V, T>(ex, sEx[s + BZ], keep);
        const float d_ez_x = N::r(sEz[s + plane] - ez);
        const float d_ey_x = N::r(sEy[s + plane] - ey);
        N::st(out[3], cell, N::r(N::r(ca * N::ld(Hx, cell)) -
                                 N::r(cb * N::r(d_ez_y - d_ey_z))));
        N::st(out[4], cell, N::r(N::r(ca * N::ld(Hy, cell)) -
                                 N::r(cb * N::r(d_ex_z - d_ez_x))));
        N::st(out[5], cell, N::r(N::r(ca * N::ld(Hz, cell)) -
                                 N::r(cb * N::r(d_ey_x - d_ex_y))));
    }
}

// The copy variant: each field as a flat run of 16-byte vectors (4 floats,
// 8 bf16), COPY_UNROLL of them loaded by a thread before it stores any; the
// n^3 mod (16 / sizeof(T)) values left at the end of a field one by one.
// T only sets the element size: the bits are moved as they are.
template <typename T>
__global__ void __launch_bounds__(COPY_THREADS)
lab_copy_kernel(const LabStepParams p) {
    constexpr int PER_VEC = 16 / sizeof(T);
    const int64_t total = p.n * p.n * p.n;
    const int64_t nvec = total / PER_VEC;
    const int64_t base =
        (int64_t)blockIdx.x * COPY_THREADS * COPY_UNROLL + threadIdx.x;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
        const int4* src = (const int4*)p.inp[c];
        int4* dst = (int4*)p.out[c];
        int4 v[COPY_UNROLL];
#pragma unroll
        for (int u = 0; u < COPY_UNROLL; ++u) {
            const int64_t i = base + u * COPY_THREADS;
            if (i < nvec) v[u] = __ldg(src + i);
        }
#pragma unroll
        for (int u = 0; u < COPY_UNROLL; ++u) {
            const int64_t i = base + u * COPY_THREADS;
            if (i < nvec) dst[i] = v[u];
        }
        const int64_t tail = nvec * PER_VEC + threadIdx.x;
        if (blockIdx.x == 0 && tail < total)
            ((T*)p.out[c])[tail] = ((const T*)p.inp[c])[tail];
    }
}

template <typename T>
static int launch_copy(const LabStepParams& p, cudaStream_t s) {
    const int64_t nvec = p.n * p.n * p.n / (16 / sizeof(T));
    const int64_t blocks = std::max<int64_t>(
        1, (nvec + COPY_THREADS * COPY_UNROLL - 1) /
               (COPY_THREADS * COPY_UNROLL));
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    lab_copy_kernel<T><<<(unsigned)blocks, COPY_THREADS, 0, s>>>(p);
    return (int)cudaGetLastError();
}

template <int V, typename T>
static int launch(const LabStepParams& p, cudaStream_t s) {
    if constexpr (V == COPY) return launch_copy<T>(p, s);
    const int64_t gz = (p.n + TZ - 1) / TZ;
    const int64_t gy = (p.n + TY - 1) / TY;
    const int64_t gx = p.n / p.bx;
    if (gy > 65535 || gx > 65535) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = sizeof(float) * 3 * (p.bx + 1) * BY * BZ;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            lab_step_kernel<V, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    lab_step_kernel<V, T><<<dim3((unsigned)gz, (unsigned)gy, (unsigned)gx),
                            dim3(TZ, TY), smem, s>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_variant(const LabStepParams& p, cudaStream_t s) {
    switch (p.variant) {
        case CURL: return launch<CURL, T>(p, s);
        case NOROLL: return launch<NOROLL, T>(p, s);
        case COPY: return launch<COPY, T>(p, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" int t3d_lab_step_params_size() {
    return (int)sizeof(LabStepParams);
}

extern "C" int t3d_lab_step(const LabStepParams* p, void* stream) {
    if (p->n <= 0) return 0;
    if (p->bx < 1 || p->bx > MAX_BX || p->n % p->bx)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return p->bf16 ? launch_variant<__nv_bfloat16>(*p, s)
                   : launch_variant<float>(*p, s);
}
