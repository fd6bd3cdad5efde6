// Pole lab: the f32 FMA ceiling and the ADE pole update on one on-chip
// window, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of scripts/pole_lab.py: make_vpu_peak (:53,
// pallas_call :71), make_pole_chan (:103, :145; and its bf16 form, :242),
// make_pole_packed (:167, :212), make_fma_peak (:250, :267) and
// make_curl_mix (:280, :304). Computes what the *_reference functions of
// tidy3d_tpu_torch/labs/pole_lab.py specify: each variant repeats its
// update `reps` times on a (wx, wy, z) window, `grid` times over, and writes
// repeat g into slice g of a (grid, wx, wy, z) output, so every repeat is
// live work.
//
// Bound: operations. The inputs are read once (a few MB); the lab's flop
// model (an FMA counts 2) times reps and grid over 67 TFLOP/s: 3.606 ms
// (vpu_peak), 1.803 (fma_peak), 6.000 (pole_chan, pole_packed), 1.521
// (curl_mix) at the lab's sizes.
//
// Design: the first four variants are pointwise, one thread per cell and
// repeat, every carry in registers (pole_chan: 3 E and 30 Q values), loops
// over poles, components and slots unrolled. pole_chan takes its 6 x 7
// coefficients as kernel parameters, so they stay in the constant bank as
// instruction operands; pole_packed reads its 4 x 30 coefficient vectors
// from memory (staged once in shared memory) inside the repeat loop.
// pole_chan_bf16 computes as the JAX lab's bf16 arithmetic does, every
// multiply, add and subtract rounded to bf16 (nearest even), left to right:
// a thread takes two neighbouring cells as __nv_bfloat162 (the 3 E and 30 Q
// carries in 33 registers), and each operation is one native bf16x2
// instruction with an explicit .rn rounding (mul/add/sub.rn.bf16x2), which
// the compiler does not contract into an FMA: the spec rounds product and
// sum apart. Its constants arrive as bf16x2 bit patterns in the parameter
// block. Bound: operations; without contraction one operation a lane and
// instruction, so its floor is twice the bound at the bf16 peak. curl_mix
// mixes y and z neighbours, periodic in the window's plane: one block per
// (x plane, repeat) holds the plane's 6 fields in shared memory (196 KB at
// 64 x 128). Built without fast-math: a*b + c contracts to one FMA, as the
// TPU's and the flop model's FMA does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int NR = 4;                // real poles
constexpr int NC = 3;                // complex poles
constexpr int NP = NR + NC;
constexpr int C = NR * 3 + NC * 6;   // Q channels (30)
constexpr int NSLOT = NR + 2 * NC;   // 3-channel slots of the packed layout
constexpr int SMEM_MAX = 232448;     // 227 KB a block can use

// Mirrored by LabPoleParams in tidy3d_tpu_torch/labs/pole_lab.py.
struct LabPoleParams {
    const void* x;      // (wx, wy, z) f32: vpu_peak, fma_peak, curl_mix
    const void* e;      // (wx, 3, wy, z): the pole variants
    const void* m;      // (wx, wy, z) mask
    const void* q;      // (wx, C, wy, z)
    const float* cv;    // (4, C): ARV, AIV, B0V, GRV (pole_packed)
    void* out;          // (grid, wx, wy, z)
    int64_t wx, wy, z;
    int32_t reps, grid;
    int32_t variant;    // 0 vpu_peak, 1 fma_peak, 2 pole_chan,
                        // 3 pole_packed, 4 curl_mix
    int32_t bf16;       // pole_chan on bf16
    float ca, cb;       // 0.999 and 0.37 as the arithmetic sees them
    float ar[8], ai[8], b0r[8], b0i[8], gr[8], gi[8];  // pole_chan's
    // pole_chan_bf16's constants, each a bf16x2 of the constant twice
    uint32_t ca2, cb2;
    uint32_t ar2[8], ai2[8], b0r2[8], b0i2[8], gr2[8], gi2[8];
};

enum { VPU_PEAK = 0, FMA_PEAK = 1, POLE_CHAN = 2, POLE_PACKED = 3,
       CURL_MIX = 4 };

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
vpu_peak_kernel(const LabPoleParams p) {
    const int64_t cells = p.wx * p.wy * p.z;
    const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= cells * p.grid) return;
    const float v = __ldg((const float*)p.x + idx % cells);
    float a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = (float)(0.1 * i);
#pragma unroll 1
    for (int r = 0; r < p.reps; ++r) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int f = 0; f < 8; ++f) a[i] = a[i] * 1.000001f + v;
        }
    }
    float s = a[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) s = s + a[i];
    ((float*)p.out)[idx] = s;
}

__global__ void __launch_bounds__(THREADS)
fma_peak_kernel(const LabPoleParams p) {
    const int64_t cells = p.wx * p.wy * p.z;
    const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= cells * p.grid) return;
    const float v = __ldg((const float*)p.x + idx % cells);
    float a = 0.f, b = 1.f;
#pragma unroll 1
    for (int r = 0; r < p.reps; ++r) {
#pragma unroll
        for (int f = 0; f < 16; ++f) {
            a = a * 1.0000001f + v;
            b = b * 0.9999999f + v;
        }
    }
    ((float*)p.out)[idx] = a + b;
}

// first channel of pole pp in the per-channel layout: real poles 3 channels
// (qr), complex poles 6 (3 qr, then 3 qi)
__host__ __device__ constexpr int ch0_of(int pp) {
    return pp < NR ? pp * 3 : NR * 3 + (pp - NR) * 6;
}

__global__ void __launch_bounds__(THREADS)
pole_chan_kernel(const LabPoleParams p) {
    const int64_t wyz = p.wy * p.z;
    const int64_t cells = p.wx * wyz;
    const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= cells * p.grid) return;
    const int64_t cell = idx % cells;
    const int64_t x = cell / wyz, yz = cell - x * wyz;
    const float* e = (const float*)p.e;
    const float* q = (const float*)p.q;
    const float mask = __ldg((const float*)p.m + cell);
    float es[3], qs[C];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) es[ci] = __ldg(e + (x * 3 + ci) * wyz + yz);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) qs[ch] = __ldg(q + (x * C + ch) * wyz + yz);
    const float ca = p.ca, cb = p.cb;

#pragma unroll 1
    for (int r = 0; r < p.reps; ++r) {
        float ne[3];
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
            float pt = 0.f;
#pragma unroll
            for (int pp = 0; pp < NP; ++pp) {
                const int ch0 = ch0_of(pp);
                float t = p.gr[pp] * qs[ch0 + ci];
                if (pp >= NR) t = t - p.gi[pp] * qs[ch0 + 3 + ci];
                pt = pp == 0 ? t : pt + t;
            }
            ne[ci] = ca * es[ci] + cb * pt;
        }
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
            const float mes = mask * (ne[ci] + es[ci]);
#pragma unroll
            for (int pp = 0; pp < NP; ++pp) {
                const int ch0 = ch0_of(pp);
                const float qr = qs[ch0 + ci];
                float nqr = p.ar[pp] * qr;
                if (pp >= NR) {
                    const float qi = qs[ch0 + 3 + ci];
                    nqr = nqr - p.ai[pp] * qi;
                    qs[ch0 + 3 + ci] =
                        p.ai[pp] * qr + p.ar[pp] * qi + p.b0i[pp] * mes;
                }
                qs[ch0 + ci] = nqr + p.b0r[pp] * mes;
            }
            es[ci] = ne[ci];
        }
    }
    ((float*)p.out)[idx] = es[0] + es[1] + es[2] + qs[0];
}

// bf16x2 arithmetic, each operation rounded once to nearest even; the
// explicit .rn keeps ptxas from contracting a multiply and an add
struct B2 {
    uint32_t v;
};
__device__ __forceinline__ B2 operator*(B2 a, B2 b) {
    B2 d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d.v) : "r"(a.v), "r"(b.v));
    return d;
}
__device__ __forceinline__ B2 operator+(B2 a, B2 b) {
    B2 d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d.v) : "r"(a.v), "r"(b.v));
    return d;
}
__device__ __forceinline__ B2 operator-(B2 a, B2 b) {
    B2 d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d.v) : "r"(a.v), "r"(b.v));
    return d;
}
__device__ __forceinline__ B2 pair(const __nv_bfloat16* p, int64_t i0,
                                   int64_t i1) {
    const uint16_t lo = __bfloat16_as_ushort(p[i0]);
    const uint16_t hi = __bfloat16_as_ushort(p[i1]);
    return B2{(uint32_t)lo | ((uint32_t)hi << 16)};
}

// pole_chan on bf16: a thread takes cells 2t and 2t + 1 of the (grid, wx,
// wy, z) output, whatever rows they lie in (the update is pointwise)
__global__ void __launch_bounds__(THREADS)
pole_chan_bf16_kernel(const LabPoleParams p) {
    const int64_t wyz = p.wy * p.z;
    const int64_t cells = p.wx * wyz;
    const int64_t total = cells * p.grid;
    const int64_t i0 = 2 * ((int64_t)blockIdx.x * THREADS + threadIdx.x);
    if (i0 >= total) return;
    const int64_t i1 = i0 + 1 < total ? i0 + 1 : i0;
    const int64_t c0 = i0 % cells, c1 = i1 % cells;
    const int64_t x0 = c0 / wyz, yz0 = c0 - x0 * wyz;
    const int64_t x1 = c1 / wyz, yz1 = c1 - x1 * wyz;
    const __nv_bfloat16* e = (const __nv_bfloat16*)p.e;
    const __nv_bfloat16* q = (const __nv_bfloat16*)p.q;
    const B2 mask = pair((const __nv_bfloat16*)p.m, c0, c1);
    B2 es[3], qs[C];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
        es[ci] = pair(e, (x0 * 3 + ci) * wyz + yz0, (x1 * 3 + ci) * wyz + yz1);
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
        qs[ch] = pair(q, (x0 * C + ch) * wyz + yz0, (x1 * C + ch) * wyz + yz1);
    const B2 ca{p.ca2}, cb{p.cb2};

#pragma unroll 1
    for (int r = 0; r < p.reps; ++r) {
        B2 ne[3];
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
            B2 pt{0};
#pragma unroll
            for (int pp = 0; pp < NP; ++pp) {
                const int ch0 = ch0_of(pp);
                B2 t = B2{p.gr2[pp]} * qs[ch0 + ci];
                if (pp >= NR) t = t - B2{p.gi2[pp]} * qs[ch0 + 3 + ci];
                pt = pp == 0 ? t : pt + t;
            }
            ne[ci] = ca * es[ci] + cb * pt;
        }
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
            const B2 mes = mask * (ne[ci] + es[ci]);
#pragma unroll
            for (int pp = 0; pp < NP; ++pp) {
                const int ch0 = ch0_of(pp);
                const B2 qr = qs[ch0 + ci];
                const B2 ar{p.ar2[pp]};
                B2 nqr = ar * qr;
                if (pp >= NR) {
                    const B2 ai{p.ai2[pp]};
                    const B2 qi = qs[ch0 + 3 + ci];
                    nqr = nqr - ai * qi;
                    qs[ch0 + 3 + ci] = ai * qr + ar * qi + B2{p.b0i2[pp]} * mes;
                }
                qs[ch0 + ci] = nqr + B2{p.b0r2[pp]} * mes;
            }
            es[ci] = ne[ci];
        }
    }
    const B2 sum = es[0] + es[1] + es[2] + qs[0];
    uint16_t* out = (uint16_t*)p.out;
    out[i0] = (uint16_t)(sum.v & 0xffff);
    if (i1 != i0) out[i1] = (uint16_t)(sum.v >> 16);
}

__global__ void __launch_bounds__(THREADS)
pole_packed_kernel(const LabPoleParams p) {
    __shared__ float cv[4 * C];
    for (int i = threadIdx.x; i < 4 * C; i += THREADS) cv[i] = p.cv[i];
    __syncthreads();
    const float* ARV = cv;
    const float* AIV = cv + C;
    const float* B0V = cv + 2 * C;
    const float* GRV = cv + 3 * C;

    const int64_t wyz = p.wy * p.z;
    const int64_t cells = p.wx * wyz;
    const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= cells * p.grid) return;
    const int64_t cell = idx % cells;
    const int64_t x = cell / wyz, yz = cell - x * wyz;
    const float* e = (const float*)p.e;
    const float* q = (const float*)p.q;
    const float mask = __ldg((const float*)p.m + cell);
    float es[3], Q[C];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) es[ci] = __ldg(e + (x * 3 + ci) * wyz + yz);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) Q[ch] = __ldg(q + (x * C + ch) * wyz + yz);

#pragma unroll 1
    for (int r = 0; r < p.reps; ++r) {
        float S[3], mes[3], nQ[C];
#pragma unroll
        for (int slot = 0; slot < NSLOT; ++slot) {
#pragma unroll
            for (int ci = 0; ci < 3; ++ci) {
                const int c = 3 * slot + ci;
                const float w = GRV[c] * Q[c];
                S[ci] = slot == 0 ? w : S[ci] + w;
            }
        }
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
            const float ne = 0.999f * es[ci] + 0.37f * S[ci];
            mes[ci] = mask * (ne + es[ci]);
            es[ci] = ne;
        }
#pragma unroll
        for (int slot = 0; slot < NSLOT; ++slot) {
#pragma unroll
            for (int ci = 0; ci < 3; ++ci) {
                const int c = 3 * slot + ci;
                float v = ARV[c] * Q[c];
                if (slot >= NR) {  // complex: qr swaps with qi, qi with qr
                    const float sw = slot < NR + NC ? Q[c + 3 * NC]
                                                    : Q[c - 3 * NC];
                    v = v + AIV[c] * sw;
                }
                nQ[c] = v + B0V[c] * mes[ci];
            }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) Q[c] = nQ[c];
    }
    ((float*)p.out)[idx] = es[0] + es[1] + es[2] + Q[0];
}

// one block per (x plane, repeat); threads over (y, z) as 32 x 32
constexpr int CM_TZ = 32;
constexpr int CM_TY = 32;

__global__ void __launch_bounds__(CM_TZ * CM_TY)
curl_mix_kernel(const LabPoleParams p) {
    extern __shared__ float f[];  // [6][wy][z]: e0 e1 e2 h0 h1 h2
    const int wy = (int)p.wy, nz = (int)p.z;
    const int P = wy * nz;
    const int64_t plane = blockIdx.x % p.wx;
    const float* x = (const float*)p.x + plane * P;
    for (int y = threadIdx.y; y < wy; y += CM_TY)
        for (int z = threadIdx.x; z < nz; z += CM_TZ) {
            const float v = __ldg(x + y * nz + z);
#pragma unroll
            for (int i = 0; i < 6; ++i)
                f[i * P + y * nz + z] = v * (float)(0.1 * i + 0.1);
        }
    __syncthreads();
    float* e = f;
    float* h = f + 3 * P;
#pragma unroll 1
    for (int r = 0; r < p.reps; ++r) {
        for (int y = threadIdx.y; y < wy; y += CM_TY) {
            const int ym = y > 0 ? y - 1 : wy - 1;
            for (int z = threadIdx.x; z < nz; z += CM_TZ) {
                const int zm = z > 0 ? z - 1 : nz - 1;
                const int o = y * nz + z;
#pragma unroll
                for (int ci = 0; ci < 3; ++ci) {
                    const float* hj = h + ((ci + 1) % 3) * P;
                    const float* hk = h + ((ci + 2) % 3) * P;
                    const float d1 = (hj[o] - hj[ym * nz + z]) * 0.5f;
                    const float d2 = (hk[o] - hk[y * nz + zm]) * 0.5f;
                    e[ci * P + o] = 0.999f * e[ci * P + o] + 0.37f * (d1 - d2);
                }
            }
        }
        __syncthreads();
        for (int y = threadIdx.y; y < wy; y += CM_TY) {
            const int yp = y < wy - 1 ? y + 1 : 0;
            for (int z = threadIdx.x; z < nz; z += CM_TZ) {
                const int zp = z < nz - 1 ? z + 1 : 0;
                const int o = y * nz + z;
#pragma unroll
                for (int ci = 0; ci < 3; ++ci) {
                    const float* ej = e + ((ci + 1) % 3) * P;
                    const float* ek = e + ((ci + 2) % 3) * P;
                    const float d1 = (ej[yp * nz + z] - ej[o]) * 0.5f;
                    const float d2 = (ek[y * nz + zp] - ek[o]) * 0.5f;
                    h[ci * P + o] = 0.999f * h[ci * P + o] - 0.37f * (d1 - d2);
                }
            }
        }
        __syncthreads();
    }
    float* out = (float*)p.out + (int64_t)blockIdx.x * P;
    for (int y = threadIdx.y; y < wy; y += CM_TY)
        for (int z = threadIdx.x; z < nz; z += CM_TZ)
            out[y * nz + z] = e[y * nz + z] + h[y * nz + z];
}

extern "C" int t3d_lab_pole_params_size() {
    return (int)sizeof(LabPoleParams);
}

extern "C" int t3d_lab_pole(const LabPoleParams* p, void* stream) {
    if (p->wx <= 0 || p->wy <= 0 || p->z <= 0 || p->grid <= 0 || p->reps < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t total = p->wx * p->wy * p->z * p->grid;
    const int64_t blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    switch (p->variant) {
        case VPU_PEAK:
            vpu_peak_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(*p);
            break;
        case FMA_PEAK:
            fma_peak_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(*p);
            break;
        case POLE_CHAN:
            if (p->bf16)
                pole_chan_bf16_kernel<<<(unsigned)((blocks + 1) / 2), THREADS,
                                        0, s>>>(*p);
            else
                pole_chan_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(*p);
            break;
        case POLE_PACKED:
            pole_packed_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(*p);
            break;
        case CURL_MIX: {
            const int64_t smem = 6 * p->wy * p->z * (int64_t)sizeof(float);
            if (smem > SMEM_MAX || p->wx * p->grid > 0x7fffffffLL)
                return (int)cudaErrorInvalidValue;
            if (smem > 48 * 1024) {
                const cudaError_t err = cudaFuncSetAttribute(
                    curl_mix_kernel,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
                if (err != cudaSuccess) return (int)err;
            }
            curl_mix_kernel<<<(unsigned)(p->wx * p->grid),
                              dim3(CM_TZ, CM_TY), (size_t)smem, s>>>(*p);
            break;
        }
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
