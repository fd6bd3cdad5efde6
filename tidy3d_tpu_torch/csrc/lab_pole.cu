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
// Bound: operations. The inputs are read once (a few MB). Two counts of the
// operations, an FMA as 2, times reps and grid over 67 TFLOP/s at the lab's
// sizes: the function's own operations (pole_lab.ops, what PERF.md's table
// and chip_smoke.py hold a kernel to): 3.606 ms (vpu_peak), 1.803
// (fma_peak), 5.578 (pole_chan, pole_packed; pole_chan_bf16 2.793 at the
// bf16 peak), 1.352 (curl_mix, 48 a cell and repeat); the JAX lab's flop
// model (pole_lab.flops, for TFLOP/s only) charges the pole update 213 a
// cell and repeat (6.000 ms) and curl_mix 54 (1.521 ms).
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
// instruction, so its floor is twice the bound at the bf16 peak.
//
// curl_mix mixes y and z neighbours, periodic in the window's plane. Its six
// fields stay in registers across all repeats: a plane (64 x 128 x 6 =
// 49152 floats at the lab's size) is one block of 512 threads of up to 128
// registers, a thread 4 y rows x 4 z cells (96 carries), a warp all 128 z
// cells, so three of a cell's four neighbours are the thread's own, the z
// one across lanes comes by shuffle (the z wrap stays in the warp) and the
// y one across warps is an edge row that the neighbour warp stores into
// shared memory before a block barrier: 6 edge stores and 6 edge loads of
// 16 bytes a thread and repeat instead of 36 shared accesses a cell. (A
// plane split over a cluster of two blocks, its block edges exchanged
// through distributed shared memory, measured slower than one block:
// PERF.md, Findings.) It takes z = 128 and wy a multiple of 4 up to 64.
// Built without fast-math: a*b + c contracts to one FMA, as the TPU's and
// the flop model's FMA does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int NR = 4;                // real poles
constexpr int NC = 3;                // complex poles
constexpr int NP = NR + NC;
constexpr int C = NR * 3 + NC * 6;   // Q channels (30)
constexpr int NSLOT = NR + 2 * NC;   // 3-channel slots of the packed layout

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

// curl_mix: one block per (window plane, copy); a thread holds CM_ROWS y
// rows x CM_CELLS consecutive z cells of all six fields in registers for
// all repeats, a warp the whole z extent (CM_Z = 32 CM_CELLS).
constexpr int CM_CELLS = 4;          // z cells a lane
constexpr int CM_Z = 32 * CM_CELLS;  // the window's z
constexpr int CM_ROWS = 4;           // y rows a thread
constexpr int CM_MAX_WARPS = 16;     // wy up to 16 CM_ROWS (512 threads)
constexpr int CM_EDGE = 3 * CM_Z;    // floats of one warp's edge row

// e[ci] of one row from h: d1 along y (ym: the row below, of hj), d2 along
// z (the cell before: from the lane before for cell 0, periodic in the warp)
__device__ __forceinline__ void curl_mix_e(float (&e)[CM_CELLS],
                                           const float (&hj)[CM_CELLS],
                                           const float (&ym)[CM_CELLS],
                                           const float (&hk)[CM_CELLS],
                                           int lane) {
    const float last = __shfl_sync(0xffffffffu, hk[CM_CELLS - 1],
                                   (lane + 31) & 31);
#pragma unroll
    for (int c = 0; c < CM_CELLS; ++c) {
        const float d1 = (hj[c] - ym[c]) * 0.5f;
        const float d2 = (hk[c] - (c > 0 ? hk[c - 1] : last)) * 0.5f;
        e[c] = 0.999f * e[c] + 0.37f * (d1 - d2);
    }
}

// h[ci] of one row from e: d1 along y (yp: the row above, of ej), d2 along
// z (the cell after: from the lane after for the last cell)
__device__ __forceinline__ void curl_mix_h(float (&h)[CM_CELLS],
                                           const float (&ej)[CM_CELLS],
                                           const float (&yp)[CM_CELLS],
                                           const float (&ek)[CM_CELLS],
                                           int lane) {
    const float first = __shfl_sync(0xffffffffu, ek[0], (lane + 1) & 31);
#pragma unroll
    for (int c = 0; c < CM_CELLS; ++c) {
        const float d1 = (yp[c] - ej[c]) * 0.5f;
        const float d2 = ((c < CM_CELLS - 1 ? ek[c + 1] : first) - ek[c]) * 0.5f;
        h[c] = 0.999f * h[c] - 0.37f * (d1 - d2);
    }
}

__device__ __forceinline__ void ld4(float (&v)[4], const float* s) {
    const float4 t = *(const float4*)s;
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
}
__device__ __forceinline__ void st4(float* s, const float (&v)[4]) {
    *(float4*)s = make_float4(v[0], v[1], v[2], v[3]);
}

// Edges, per half-step: each warp stores the row its neighbour warp needs
// into that warp's slot in shared memory (its last H row for the warp
// above, read as its first row's y - 1; its first E row for the warp below,
// read as its last row's y + 1), the last and first warp wrapping round
// the window's y; one barrier orders the stores before the reads. The
// rows that need no edge are updated first.
__global__ void __launch_bounds__(32 * CM_MAX_WARPS, 1)
curl_mix_kernel(const __grid_constant__ LabPoleParams p) {
    extern __shared__ __align__(16) float edges[];  // [2][warps][3][CM_Z]
    const int warps = blockDim.x / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* hin = edges;                      // the H row below a warp
    float* ein = edges + warps * CM_EDGE;    // the E row above a warp
    const int64_t window = blockIdx.x;       // copy * wx + plane
    const int64_t P = p.wy * CM_Z;
    const int64_t cell0 = (int64_t)warp * CM_ROWS * CM_Z + lane * CM_CELLS;
    const float* x = (const float*)p.x + (window % p.wx) * P + cell0;
    float* hdst = hin + (warp + 1) % warps * CM_EDGE + lane * CM_CELLS;
    float* edst = ein + (warp + warps - 1) % warps * CM_EDGE +
                  lane * CM_CELLS;
    const float* hown = hin + warp * CM_EDGE + lane * CM_CELLS;
    const float* eown = ein + warp * CM_EDGE + lane * CM_CELLS;
    constexpr int L = CM_ROWS - 1;

    float e[3][CM_ROWS][CM_CELLS], h[3][CM_ROWS][CM_CELLS];
#pragma unroll
    for (int r = 0; r < CM_ROWS; ++r) {
        float v[4];
        ld4(v, x + r * CM_Z);
#pragma unroll
        for (int c = 0; c < CM_CELLS; ++c)
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                e[i][r][c] = v[c] * (float)(0.1 * i + 0.1);
                h[i][r][c] = v[c] * (float)(0.1 * (i + 3) + 0.1);
            }
    }
#pragma unroll 1
    for (int rep = 0; rep < p.reps; ++rep) {
#pragma unroll
        for (int i = 0; i < 3; ++i) st4(hdst + i * CM_Z, h[i][L]);
        __syncthreads();
#pragma unroll
        for (int r = L; r > 0; --r)
#pragma unroll
            for (int ci = 0; ci < 3; ++ci)
                curl_mix_e(e[ci][r], h[(ci + 1) % 3][r],
                           h[(ci + 1) % 3][r - 1], h[(ci + 2) % 3][r], lane);
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
            float ym[CM_CELLS];
            ld4(ym, hown + (ci + 1) % 3 * CM_Z);
            curl_mix_e(e[ci][0], h[(ci + 1) % 3][0], ym, h[(ci + 2) % 3][0],
                       lane);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) st4(edst + i * CM_Z, e[i][0]);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < L; ++r)
#pragma unroll
            for (int ci = 0; ci < 3; ++ci)
                curl_mix_h(h[ci][r], e[(ci + 1) % 3][r],
                           e[(ci + 1) % 3][r + 1], e[(ci + 2) % 3][r], lane);
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
            float yp[CM_CELLS];
            ld4(yp, eown + (ci + 1) % 3 * CM_Z);
            curl_mix_h(h[ci][L], e[(ci + 1) % 3][L], yp, e[(ci + 2) % 3][L],
                       lane);
        }
    }
    float* out = (float*)p.out + window * P + cell0;
#pragma unroll
    for (int r = 0; r < CM_ROWS; ++r) {
        float v[4];
#pragma unroll
        for (int c = 0; c < CM_CELLS; ++c) v[c] = e[0][r][c] + h[0][r][c];
        st4(out + r * CM_Z, v);
    }
}

// the warps of a curl_mix block for window height wy, or 0 if the kernel
// does not take (wy, z)
static int curl_mix_warps(int64_t wy, int64_t z) {
    if (z != CM_Z || wy % CM_ROWS || wy < CM_ROWS ||
        wy / CM_ROWS > CM_MAX_WARPS)
        return 0;
    return (int)(wy / CM_ROWS);
}

extern "C" int t3d_lab_pole_params_size() {
    return (int)sizeof(LabPoleParams);
}

// curl_mix's resources at window height p->wy: threads, shared bytes,
// blocks per SM, registers
extern "C" int t3d_lab_pole_curl_mix_info(const LabPoleParams* p, int* out) {
    const int warps = curl_mix_warps(p->wy, p->z);
    if (!warps) return (int)cudaErrorInvalidValue;
    out[0] = 32 * warps;
    out[1] = 2 * warps * CM_EDGE * (int)sizeof(float);
    int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], curl_mix_kernel, out[0], out[1]);
    if (err) return err;
    cudaFuncAttributes attr;
    err = (int)cudaFuncGetAttributes(&attr, curl_mix_kernel);
    out[3] = attr.numRegs;
    return err;
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
            const int warps = curl_mix_warps(p->wy, p->z);
            if (!warps || p->wx * p->grid > 0x7fffffffLL)
                return (int)cudaErrorInvalidValue;
            curl_mix_kernel<<<(unsigned)(p->wx * p->grid), 32 * warps,
                              2 * warps * CM_EDGE * sizeof(float), s>>>(*p);
            break;
        }
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
