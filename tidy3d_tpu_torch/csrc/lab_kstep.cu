// Temporal-blocking lab: k vacuum leapfrog steps per launch, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel make_kstep (scripts/kernel_lab2.py:26, pallas_call
// at :118) and computes what lab_kstep_reference in
// tidy3d_tpu_torch/labs/kernel_lab2.py specifies: each x-window of
// W = bx + 2 hw planes (hw planes below the block, its bx planes, hw above,
// the halo windows clamped at the x ends as the Pallas index maps clamp
// them) takes k steps of
//
//   E = ca * E + cb * curl_b(H),  H = ca * H - cb * curl_f(E)
//
// with x differences zero at the window's end planes, y and z periodic; the
// block's own bx planes are written. Storage float or bf16, arithmetic in
// float, one rounding at the store. k is a template parameter (1 to 4).
//
// Bound: bytes. 12 fields of n^3 once per group: 0.811 / k ms per step at
// 384^3 f32 (3.35 TB/s), half that in bf16; 36 flops per cell and step.
//
// Design (classic temporal blocking): one block of 512 threads per x-window
// and (TY x 32) y/z tile holds the 6 fields of the window and of the tile
// with a periodic halo of k cells on each y and z side in shared memory,
// converted to float, and does the k steps there, E then H, each a pass
// over the whole box; a halo cell's value goes stale one cell further in
// at each step, so after k steps the tile's cells are exact. TY is the
// largest of 8, 4, 2, 1 whose box fits in 227 KB (8 up to k = 3 at
// bx = 8, 4 at k = 4). The box re-reads the halos from device memory
// (L2 holds most), and the k steps redo the halo cells' work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored by LabKStepParams in tidy3d_tpu_torch/labs/kernel_lab2.py.
struct LabKStepParams {
    const void* inp[6];   // Ex Ey Ez Hx Hy Hz, (n, n, n), z contiguous
    void* out[6];
    int64_t n;
    int32_t bx;           // planes a window writes; divides n
    int32_t k;            // steps per launch (1 to 4)
    int32_t hw;           // halo planes per side: smallest >= k dividing bx
    int32_t bf16;         // storage in bf16
    float ca, cb;
};

constexpr int TZ = 32;
constexpr int THREADS = 512;
constexpr int SMEM_MAX = 232448;  // 227 KB a block can use

template <typename T> struct Store;
template <> struct Store<float> {
    static __device__ __forceinline__ float ld(const float* p, int64_t i) {
        return __ldg(p + i);
    }
    static __device__ __forceinline__ void st(float* p, int64_t i, float v) {
        p[i] = v;
    }
};
template <> struct Store<__nv_bfloat16> {
    static __device__ __forceinline__ float ld(const __nv_bfloat16* p,
                                               int64_t i) {
        return __bfloat162float(p[i]);
    }
    static __device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i,
                                              float v) {
        p[i] = __float2bfloat16_rn(v);
    }
};

__host__ __device__ constexpr int box_bytes(int w, int ty, int k) {
    return 6 * w * (ty + 2 * k) * (TZ + 2 * k) * (int)sizeof(float);
}

template <int K, typename T>
__global__ void __launch_bounds__(THREADS)
lab_kstep_kernel(const LabKStepParams p, const int ty) {
    using S = Store<T>;
    constexpr int ZT = TZ + 2 * K;
    extern __shared__ float box[];  // [6][W][YT][ZT]
    const int64_t n = p.n;
    const int bx = p.bx, hw = p.hw;
    const int W = bx + 2 * hw;
    const int YT = ty + 2 * K;
    const int plane = YT * ZT;
    const int vol = W * plane;
    float* sEx = box;
    float* sEy = box + vol;
    float* sEz = box + 2 * vol;
    float* sHx = box + 3 * vol;
    float* sHy = box + 4 * vol;
    float* sHz = box + 5 * vol;

    const int i = blockIdx.z;                  // the window
    const int64_t s0 = (int64_t)i * bx;
    const int rb = bx / hw;
    const int64_t nb = n / hw;
    const int64_t lo = (int64_t)(i * rb > 0 ? i * rb - 1 : 0) * hw;
    const int64_t up = (int64_t)i * rb + rb;
    const int64_t hi = (up < nb - 1 ? up : nb - 1) * hw;
    const int64_t y0 = (int64_t)blockIdx.y * ty;
    const int64_t z0 = (int64_t)blockIdx.x * TZ;
    const int64_t sx = n * n;

    // load the window, the tile and its periodic y/z halos
    for (int idx = threadIdx.x; idx < vol; idx += THREADS) {
        const int w = idx / plane;
        const int rem = idx - w * plane;
        const int j = rem / ZT;
        const int kz = rem - j * ZT;
        const int64_t g = w < hw ? lo + w
                        : w < hw + bx ? s0 + (w - hw) : hi + (w - hw - bx);
        const int64_t y = ((y0 - K + j) % n + n) % n;
        const int64_t z = ((z0 - K + kz) % n + n) % n;
        const int64_t cell = g * sx + y * n + z;
#pragma unroll
        for (int c = 0; c < 6; ++c)
            box[c * vol + idx] = S::ld((const T*)p.inp[c], cell);
    }
    __syncthreads();

    const float ca = p.ca, cb = p.cb;
#pragma unroll 1
    for (int step = 0; step < K; ++step) {
        for (int o = threadIdx.x; o < vol; o += THREADS) {
            const int w = o / plane;
            const int rem = o - w * plane;
            const int j = rem / ZT;
            const int kz = rem - j * ZT;
            const float hx = sHx[o], hy = sHy[o], hz = sHz[o];
            const float hz_ym = j > 0 ? sHz[o - ZT] : hz;
            const float hx_ym = j > 0 ? sHx[o - ZT] : hx;
            const float hy_zm = kz > 0 ? sHy[o - 1] : hy;
            const float hx_zm = kz > 0 ? sHx[o - 1] : hx;
            const float hz_xm = w > 0 ? sHz[o - plane] : hz;
            const float hy_xm = w > 0 ? sHy[o - plane] : hy;
            sEx[o] = ca * sEx[o] + cb * ((hz - hz_ym) - (hy - hy_zm));
            sEy[o] = ca * sEy[o] + cb * ((hx - hx_zm) - (hz - hz_xm));
            sEz[o] = ca * sEz[o] + cb * ((hy - hy_xm) - (hx - hx_ym));
        }
        __syncthreads();
        for (int o = threadIdx.x; o < vol; o += THREADS) {
            const int w = o / plane;
            const int rem = o - w * plane;
            const int j = rem / ZT;
            const int kz = rem - j * ZT;
            const float ex = sEx[o], ey = sEy[o], ez = sEz[o];
            const float ez_yp = j < YT - 1 ? sEz[o + ZT] : ez;
            const float ex_yp = j < YT - 1 ? sEx[o + ZT] : ex;
            const float ey_zp = kz < ZT - 1 ? sEy[o + 1] : ey;
            const float ex_zp = kz < ZT - 1 ? sEx[o + 1] : ex;
            const float ez_xp = w < W - 1 ? sEz[o + plane] : ez;
            const float ey_xp = w < W - 1 ? sEy[o + plane] : ey;
            sHx[o] = ca * sHx[o] - cb * ((ez_yp - ez) - (ey_zp - ey));
            sHy[o] = ca * sHy[o] - cb * ((ex_zp - ex) - (ez_xp - ez));
            sHz[o] = ca * sHz[o] - cb * ((ey_xp - ey) - (ex_yp - ex));
        }
        __syncthreads();
    }

    // the block's own planes, rows and columns
    const int core = ty * TZ;
    for (int idx = threadIdx.x; idx < bx * core; idx += THREADS) {
        const int r = idx / core;
        const int rem = idx - r * core;
        const int jj = rem / TZ;
        const int kk = rem - jj * TZ;
        const int64_t y = y0 + jj, z = z0 + kk;
        if (y >= n || z >= n) continue;
        const int o = ((hw + r) * YT + K + jj) * ZT + K + kk;
        const int64_t cell = (s0 + r) * sx + y * n + z;
#pragma unroll
        for (int c = 0; c < 6; ++c)
            S::st((T*)p.out[c], cell, box[c * vol + o]);
    }
}

template <int K, typename T>
static int launch(const LabKStepParams& p, cudaStream_t s) {
    const int W = p.bx + 2 * p.hw;
    int ty = 8;
    while (ty > 1 && box_bytes(W, ty, K) > SMEM_MAX) ty /= 2;
    const int smem = box_bytes(W, ty, K);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    const int64_t gz = (p.n + TZ - 1) / TZ;
    const int64_t gy = (p.n + ty - 1) / ty;
    const int64_t gx = p.n / p.bx;
    if (gy > 65535 || gx > 65535) return (int)cudaErrorInvalidConfiguration;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            lab_kstep_kernel<K, T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    lab_kstep_kernel<K, T><<<dim3((unsigned)gz, (unsigned)gy, (unsigned)gx),
                             THREADS, smem, s>>>(p, ty);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_k(const LabKStepParams& p, cudaStream_t s) {
    switch (p.k) {
        case 1: return launch<1, T>(p, s);
        case 2: return launch<2, T>(p, s);
        case 3: return launch<3, T>(p, s);
        case 4: return launch<4, T>(p, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" int t3d_lab_kstep_params_size() {
    return (int)sizeof(LabKStepParams);
}

extern "C" int t3d_lab_kstep(const LabKStepParams* p, void* stream) {
    if (p->n <= 0) return 0;
    if (p->bx < 1 || p->n % p->bx || p->hw < p->k || p->bx % p->hw ||
        p->n % p->hw)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return p->bf16 ? launch_k<__nv_bfloat16>(*p, s)
                   : launch_k<float>(*p, s);
}
