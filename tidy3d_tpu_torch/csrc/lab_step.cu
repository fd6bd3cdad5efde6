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
// thread and plane took 1.280 and 1.011, PERF.md).
//
// Design of the stencil variants (an x-march): a block owns a y/z tile of
// TY x TZ cells and the bx x planes of one chunk, and marches through them.
// A thread takes two z-neighbour cells (a pair: float2, or bf16x2 whose
// every operation is one .rn bf16x2 instruction, no conversion to float).
// The 6 fields of each plane are staged as stored by cp.async of pairs
// (NST planes deep, two in flight while one is read) over the tile plus one
// row below and above and one pair (two columns) on each side. At march
// position x the block computes E'(x) on the tile plus one row and column
// above (the forward neighbours H' reads; one warp takes those 32 extra
// pairs) into a ring of two shared E' planes, then H'(x - 1) of its own
// cells: y/z neighbours of E'(x - 1) from the ring, E'(x) and the x
// neighbours of H from registers. One barrier a plane. A chunk first reads
// a lead-in plane (x0 - 1, or plane 0 again: Hy and Hz only, the carry of
// the x difference) and ends with a lead-out plane (E' of x0 + bx on the
// own cells, or at the hi end plane n - 1 again, whose x difference is then
// zero: the virtual plane); neither is stored. The index math (wrapped y/z
// offsets of the staged pairs, the own cells) runs once a block in 32-bit
// ints; a plane adds one 64-bit offset. Odd n, or fields not aligned to a
// pair, stage and store cell by cell (the same march, an instantiation of
// its own). NOROLL reads no y or z neighbour: it keeps no ring and computes
// no extra pairs, and stages the same planes.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored by LabStepParams in tidy3d_tpu_torch/labs/kernel_lab.py.
struct LabStepParams {
    const void* inp[6];   // Ex Ey Ez Hx Hy Hz, (n, n, n), z contiguous
    void* out[6];
    int64_t n;
    int32_t bx;           // x planes a block writes; divides n
    int32_t variant;      // 0 curl, 1 noroll, 2 copy
    int32_t bf16;         // storage (and arithmetic) in bf16
    float ca, cb, keep;   // rounded to bf16 by the wrapper for bf16
};

enum { CURL = 0, NOROLL = 1, COPY = 2 };

constexpr int TZ = 32;              // owned z columns of a tile
constexpr int TY = 16;              // owned y rows of a tile
constexpr int PZ = TZ / 2;          // owned pairs of a row
constexpr int ZE = TZ + 4;          // staged columns: z0 - 2 .. z0 + 33
constexpr int PE = ZE / 2;          // staged pairs of a row
constexpr int YE = TY + 2;          // staged rows: y0 - 1 .. y0 + TY
constexpr int SPLANE = YE * ZE;     // values of a staged field plane
constexpr int RZ = 2 * (PZ + 1);    // values of a ring row (E' pairs + 1)
constexpr int RPLANE = (TY + 1) * RZ;  // values of a ring field plane
constexpr int NST = 3;              // staged planes (two in flight)
constexpr int THREADS = TY * PZ;    // one own pair a thread
constexpr int EXTRA_WARP = THREADS / 32 - 1;  // takes the 32 extra pairs
static_assert(TY + PZ == 32, "the extra E' pairs fill one warp");
constexpr int STAGED = YE * PE;     // staged pairs of a field plane
constexpr int STAGE_ITEMS = (STAGED + THREADS - 1) / THREADS;
constexpr int MAX_N = 46340;        // y n + z in 32 bits
constexpr int COPY_THREADS = 256;  // the copy variant's block
constexpr int COPY_UNROLL = 4;     // 16-byte vectors in flight a thread

__host__ __device__ constexpr int step_smem(int tbytes) {
    return (NST * 6 * SPLANE + 2 * 3 * RPLANE) * tbytes;
}

// a pair of float cells
struct F2 {
    float x, y;
};
__device__ __forceinline__ F2 operator+(F2 a, F2 b) {
    return {a.x + b.x, a.y + b.y};
}
__device__ __forceinline__ F2 operator-(F2 a, F2 b) {
    return {a.x - b.x, a.y - b.y};
}
__device__ __forceinline__ F2 operator*(F2 a, F2 b) {
    return {a.x * b.x, a.y * b.y};
}

// a pair of bf16 cells; each operation rounds once to nearest even, and the
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

// loads, stores and z shifts of a pair; s points at the pair's first cell
template <typename T> struct Pair;
template <> struct Pair<float> {
    using V = F2;
    static __device__ __forceinline__ V splat(float c) { return {c, c}; }
    static __device__ __forceinline__ V ld(const float* s) {
        const float2 v = *(const float2*)s;
        return {v.x, v.y};
    }
    static __device__ __forceinline__ void st(float* s, V v) {
        *(float2*)s = make_float2(v.x, v.y);
    }
    static __device__ __forceinline__ void st_cell(float* s, V v, int i) {
        *s = i ? v.y : v.x;
    }
    // the pair one cell lower in z: the cell before s, then s's first
    static __device__ __forceinline__ V lower(const float* s, V cur) {
        return {s[-1], cur.x};
    }
    // the pair one cell higher: cur's second cell, then next's first
    static __device__ __forceinline__ V upper(V cur, const float* next) {
        return {cur.y, next[0]};
    }
};
template <> struct Pair<__nv_bfloat16> {
    using V = B2;
    static __device__ __forceinline__ V splat(float c) {
        const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(c));
        return {b | b << 16};
    }
    static __device__ __forceinline__ V ld(const __nv_bfloat16* s) {
        return {*(const uint32_t*)s};
    }
    static __device__ __forceinline__ void st(__nv_bfloat16* s, V v) {
        *(uint32_t*)s = v.v;
    }
    static __device__ __forceinline__ void st_cell(__nv_bfloat16* s, V v,
                                                   int i) {
        *(uint16_t*)s = (uint16_t)(i ? v.v >> 16 : v.v);
    }
    static __device__ __forceinline__ V lower(const __nv_bfloat16* s,
                                              V cur) {
        return {__byte_perm(*(const uint32_t*)(s - 2), cur.v, 0x5432)};
    }
    static __device__ __forceinline__ V upper(V cur,
                                              const __nv_bfloat16* next) {
        return {__byte_perm(cur.v, *(const uint32_t*)next, 0x5432)};
    }
};

// an asynchronous copy of a pair into shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(gmem), "n"(BYTES));
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ int wrap(int v, int n) {
    return (v % n + n) % n;
}

// VEC: n even and every field aligned to a pair (pairs staged by cp.async
// and stored whole); else cell by cell
template <int VAR, typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
lab_step_kernel(const __grid_constant__ LabStepParams p) {
    using P = Pair<T>;
    using V = typename P::V;
    extern __shared__ __align__(16) unsigned char smem[];
    T* const stage = (T*)smem;                     // [NST][6][YE][ZE]
    T* const ring = stage + NST * 6 * SPLANE;      // [2][3][TY + 1][RZ]
    const int n = (int)p.n;
    const int64_t n2 = p.n * p.n;
    const int bx = p.bx;
    const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY;
    const int x0 = blockIdx.z * bx;
    const int t = threadIdx.x;
    const bool extra = t / 32 == EXTRA_WARP;

    // the staged pairs this thread copies: shared offset, the global y n +
    // z of both cells
    int soff[STAGE_ITEMS], ga[STAGE_ITEMS], gb[STAGE_ITEMS];
#pragma unroll
    for (int k = 0; k < STAGE_ITEMS; ++k) {
        const int s = t + k * THREADS;
        const int j = s / PE, q = s - j * PE;
        const int y = wrap(y0 - 1 + j, n);
        soff[k] = s < STAGED ? j * ZE + 2 * q : -1;
        ga[k] = y * n + wrap(z0 - 2 + 2 * q, n);
        gb[k] = y * n + wrap(z0 - 1 + 2 * q, n);
    }
    // the own pair (row j, pair pp of the tile), and the extra E' pair of
    // the extra warp: the row above the tile, then the column after it
    const int j = 1 + t / PZ, pp = t % PZ;
    const int so = j * ZE + 2 * (pp + 1);          // staged offset
    const int ro = (j - 1) * RZ + 2 * pp;          // ring offset
    const int lane = t % 32;
    const int xj = lane < PZ ? TY + 1 : 1 + lane - PZ;
    const int xp = lane < PZ ? lane : PZ;
    const int xso = xj * ZE + 2 * (xp + 1);
    const int xro = (xj - 1) * RZ + 2 * xp;
    const int oy = y0 + j - 1, oz = z0 + 2 * pp;
    const bool own0 = oy < n && oz < n, own1 = oy < n && oz + 1 < n;
    const int gown = oy * n + oz;

    const V ca = P::splat(p.ca), cb = P::splat(p.cb), keep = P::splat(p.keep);

    // starts the copy of march position pos into stage slot (one group,
    // maybe empty): the lead-in, the chunk's planes, the lead-out
    auto stage_plane = [&](int pos, int slot) {
        if (pos <= bx + 1) {
            const int x = pos == 0 ? max(x0 - 1, 0)
                        : pos <= bx ? x0 + pos - 1 : min(x0 + bx, n - 1);
            const int64_t base = x * n2;
#pragma unroll
            for (int c = 0; c < 6; ++c) {
                if (pos == 0 && c < 4) continue;   // the lead-in: Hy, Hz
                const T* src = (const T*)p.inp[c] + base;
                T* dst = stage + (slot * 6 + c) * SPLANE;
#pragma unroll
                for (int k = 0; k < STAGE_ITEMS; ++k) {
                    if (soff[k] < 0) continue;
                    if constexpr (VEC) {
                        cp_async<2 * sizeof(T)>(dst + soff[k], src + ga[k]);
                    } else {
                        dst[soff[k]] = src[ga[k]];
                        dst[soff[k] + 1] = src[gb[k]];
                    }
                }
            }
        }
        cp_commit();
    };

    // E' of the pair at staged offset s from the staged plane slot and the
    // carried Hy, Hz of the plane before (hp); also returns the pair's H
    auto curl_e = [&](int slot, int s, const V (&hp)[2], V (&e)[3],
                      V (&h)[3]) {
        const T* f = stage + slot * 6 * SPLANE + s;
#pragma unroll
        for (int c = 0; c < 3; ++c) h[c] = P::ld(f + (3 + c) * SPLANE);
        V dzy, dyz, dxz, dxy;
        if constexpr (VAR == CURL) {
            dzy = h[2] - P::ld(f + 5 * SPLANE - ZE);
            dyz = h[1] - P::lower(f + 4 * SPLANE, h[1]);
            dxz = h[0] - P::lower(f + 3 * SPLANE, h[0]);
            dxy = h[0] - P::ld(f + 3 * SPLANE - ZE);
        } else {
            dzy = h[2] - h[2] * keep;
            dyz = h[1] - h[1] * keep;
            dxz = h[0] - h[0] * keep;
            dxy = dxz;
        }
        const V dzx = h[2] - hp[1], dyx = h[1] - hp[0];
        e[0] = ca * P::ld(f) + cb * (dzy - dyz);
        e[1] = ca * P::ld(f + SPLANE) + cb * (dxz - dzx);
        e[2] = ca * P::ld(f + 2 * SPLANE) + cb * (dyx - dxy);
    };

    // H' of the own pair at plane x - 1: E'(x - 1)'s y/z neighbours from
    // ring plane par, its own value eo, E'(x) en, H(x - 1) ho
    auto curl_h = [&](int par, const V (&eo)[3], const V (&en)[3],
                      const V (&ho)[3], V (&h)[3]) {
        const T* r = ring + par * 3 * RPLANE + ro;
        V dzy, dyz, dxz, dxy;
        if constexpr (VAR == CURL) {
            dzy = P::ld(r + 2 * RPLANE + RZ) - eo[2];
            dyz = P::upper(eo[1], r + RPLANE + 2) - eo[1];
            dxz = P::upper(eo[0], r + 2) - eo[0];
            dxy = P::ld(r + RZ) - eo[0];
        } else {
            dzy = eo[2] * keep - eo[2];
            dyz = eo[1] * keep - eo[1];
            dxz = eo[0] * keep - eo[0];
            dxy = dxz;
        }
        const V dzx = en[2] - eo[2], dyx = en[1] - eo[1];
        h[0] = ca * ho[0] - cb * (dzy - dyz);
        h[1] = ca * ho[1] - cb * (dxz - dzx);
        h[2] = ca * ho[2] - cb * (dyx - dxy);
    };

    auto put_ring = [&](int par, int r, const V (&e)[3]) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
            P::st(ring + (par * 3 + c) * RPLANE + r, e[c]);
    };

    auto store = [&](int c0, int x, const V (&v)[3]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            T* dst = (T*)p.out[c0 + c] + x * n2 + gown;
            if constexpr (VEC) {
                if (own0) P::st(dst, v[c]);
            } else {
                if (own0) P::st_cell(dst, v[c], 0);
                if (own1) P::st_cell(dst + 1, v[c], 1);
            }
        }
    };

    V eo[3], ho[3], hp[2], xh[2];
    stage_plane(0, 0);
    stage_plane(1, 1);
    int slot = 0;
#pragma unroll 1
    for (int pos = 0; pos <= bx + 1; ++pos) {
        cp_wait<NST - 2>();
        __syncthreads();
        stage_plane(pos + 2, slot == 0 ? NST - 1 : slot - 1);
        if (pos == 0) {
            const T* f = stage + slot * 6 * SPLANE;
            hp[0] = P::ld(f + 4 * SPLANE + so);
            hp[1] = P::ld(f + 5 * SPLANE + so);
            if (extra) {
                xh[0] = P::ld(f + 4 * SPLANE + xso);
                xh[1] = P::ld(f + 5 * SPLANE + xso);
            }
        } else {
            const int x = x0 + pos - 1;  // E' plane (x0 + bx: the lead-out)
            V e[3], h[3];
            curl_e(slot, so, hp, e, h);
            if (pos <= bx) {
                if (VAR == CURL) put_ring(x & 1, ro, e);
                store(0, x, e);
            }
            if (pos >= 2) {
                V hn[3];
                curl_h((x - 1) & 1, eo, e, ho, hn);
                store(3, x - 1, hn);
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                eo[c] = e[c];
                ho[c] = h[c];
            }
            hp[0] = h[1];
            hp[1] = h[2];
            if (VAR == CURL && extra && pos <= bx) {  // the ring's edge
                curl_e(slot, xso, xh, e, h);
                put_ring(x & 1, xro, e);
                xh[0] = h[1];
                xh[1] = h[2];
            }
        }
        slot = slot == NST - 1 ? 0 : slot + 1;
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

template <int V, typename T, bool VEC>
static int configure(int* threads, int* smem) {
    *threads = THREADS;
    *smem = step_smem((int)sizeof(T));
    if (*smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            lab_step_kernel<V, T, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

static bool pair_aligned(const LabStepParams& p, int tbytes) {
    if (p.n % 2) return false;
    for (int c = 0; c < 6; ++c)
        if ((uintptr_t)p.inp[c] % (2 * tbytes) ||
            (uintptr_t)p.out[c] % (2 * tbytes))
            return false;
    return true;
}

template <int V, typename T, bool VEC>
static int launch_stencil(const LabStepParams& p, cudaStream_t s) {
    int threads, smem;
    const int err = configure<V, T, VEC>(&threads, &smem);
    if (err) return err;
    const int64_t gz = (p.n + TZ - 1) / TZ;
    const int64_t gy = (p.n + TY - 1) / TY;
    const int64_t gx = p.n / p.bx;
    if (gy > 65535 || gx > 65535) return (int)cudaErrorInvalidConfiguration;
    lab_step_kernel<V, T, VEC>
        <<<dim3((unsigned)gz, (unsigned)gy, (unsigned)gx), threads, smem,
           s>>>(p);
    return (int)cudaGetLastError();
}

template <int V, typename T>
static int launch(const LabStepParams& p, cudaStream_t s) {
    if constexpr (V == COPY)
        return launch_copy<T>(p, s);
    else
        return pair_aligned(p, (int)sizeof(T)) ? launch_stencil<V, T, true>(p, s)
                                               : launch_stencil<V, T, false>(p, s);
}

// threads, shared bytes, blocks per SM, registers and owned y rows of a
// tile of a stencil instantiation (the one of pair-aligned fields)
template <int V, typename T>
static int info(int* out) {
    int err = configure<V, T, true>(&out[0], &out[1]);
    if (err) return err;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], lab_step_kernel<V, T, true>, out[0], out[1]);
    if (err) return err;
    cudaFuncAttributes attr;
    err = (int)cudaFuncGetAttributes(&attr, lab_step_kernel<V, T, true>);
    out[3] = attr.numRegs;
    out[4] = TY;
    return err;
}

template <typename T>
static int launch_variant(const LabStepParams& p, cudaStream_t s, int* out) {
    switch (p.variant) {
        case CURL: return out ? info<CURL, T>(out) : launch<CURL, T>(p, s);
        case NOROLL:
            return out ? info<NOROLL, T>(out) : launch<NOROLL, T>(p, s);
        case COPY:
            return out ? (int)cudaErrorInvalidValue : launch<COPY, T>(p, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" int t3d_lab_step_params_size() {
    return (int)sizeof(LabStepParams);
}

extern "C" int t3d_lab_step_info(const LabStepParams* p, int* out) {
    return p->bf16 ? launch_variant<__nv_bfloat16>(*p, 0, out)
                   : launch_variant<float>(*p, 0, out);
}

extern "C" int t3d_lab_step(const LabStepParams* p, void* stream) {
    if (p->n <= 0) return 0;
    if (p->bx < 1 || p->n % p->bx)
        return (int)cudaErrorInvalidValue;
    if (p->variant != COPY && p->n > MAX_N) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return p->bf16 ? launch_variant<__nv_bfloat16>(*p, s, nullptr)
                   : launch_variant<float>(*p, s, nullptr);
}
