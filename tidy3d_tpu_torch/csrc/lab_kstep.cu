// Temporal-blocking lab: k vacuum leapfrog steps per launch, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel make_kstep (scripts/kernel_lab2.py:26, pallas_call
// at :118) and computes what lab_kstep_reference in
// tidy3d_tpu_torch/labs/kernel_lab2.py specifies. Read as one computation:
// V is the x sequence [0, hw) ++ [0, n) ++ [n - hw, n) (hw the halo width,
// the smallest width >= k that divides bx; its first and last hw rows are
// the Pallas kernel's clamped halo windows); V takes k steps of
//
//   E = ca * E + cb * curl_b(H),  H = ca * H - cb * curl_f(E)
//
// with x differences zero at V's two end rows, y and z periodic; the output
// is V's rows [hw, hw + n). Every Pallas window is a slice of V of bx + 2 hw
// rows, and its stale zone (k rows at each end) never reaches the rows it
// writes, so the windows and V give the same output. Storage float or bf16,
// arithmetic in float, one rounding at the store. k is a template parameter
// (1 to 4).
//
// Bound: bytes. 12 fields of n^3 once per group: 0.811 ms a group at 384^3
// f32 (3.35 TB/s), half that in bf16; 36 flops per cell and step.
//
// Design (an x-march): a block owns a y/z tile of ty x 32 cells (ty per K,
// a compile-time constant, so every shared-memory plane offset is an
// immediate) and works on it with a halo of K cells in y and K rounded up
// to even in z (a halo value goes stale one cell further in at each level,
// so after K levels the tile is exact). It marches along x through a chunk
// of V: at march position m, level 0 is V's plane m, and level s (the s-th
// step) computes E_s at plane m - s + 1 and H_s at plane m - s, one plane
// behind level s - 1. A thread keeps its 2 cells' x neighbours in
// registers (E_s and H_{s-1} of the plane before); shared memory holds what
// the y and z differences read: the H plane of levels 1..K-1 and two E
// planes (by parity) of levels 1..K, 9 K - 3 float planes of the extended
// tile. Level 0 is staged as stored by 4- or 8-byte cp.async of z pairs,
// 3 planes deep (2 in flight while one is read); level 1 reads its H
// neighbours from the staged plane. Each written cell is stored once,
// after level K. A chunk that does not touch V's ends takes K lead-in and
// K lead-out planes that are computed and not stored; the chunk count is
// the host's choice (kernel_lab2.chunk_count: the fewest waves of blocks
// times march length). The index math runs once per kernel (cells,
// wrapped y/z offsets, shared neighbour offsets) and once per plane (the
// plane's global row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored by LabKStepParams in tidy3d_tpu_torch/labs/kernel_lab2.py.
struct LabKStepParams {
    const void* inp[6];   // Ex Ey Ez Hx Hy Hz, (n, n, n), z contiguous
    void* out[6];
    int64_t n;
    int32_t bx;           // planes a Pallas window writes; divides n
    int32_t k;            // steps per launch (1 to 4)
    int32_t hw;           // V's halo rows at each end
    int32_t bf16;         // storage in bf16
    float ca, cb;
    int32_t chunks;       // x chunks of V's output rows per tile
};

constexpr int TZ = 32;           // owned z columns of a tile
constexpr int NST = 3;           // level-0 planes staged (2 in flight)
constexpr int CPT = 2;           // cells of the extended tile a thread takes
constexpr int MAX_THREADS = 512;
// blocks per SM each K's registers are capped for (more spill and lose)
__host__ __device__ constexpr int min_blocks(int k) { return k == 1 ? 2 : 1; }
// owned y rows of a tile
__host__ __device__ constexpr int ty_of(int k) {
    return k == 2 ? 24 : k == 3 ? 18 : 16;
}
constexpr int SMEM_MAX = 232448;  // 227 KB a block can use

// the z halo, K rounded up to even: staged pairs of z cells stay aligned
__host__ __device__ constexpr int zhalo(int k) { return (k + 1) / 2 * 2; }
__host__ __device__ constexpr int ext_z(int k) { return TZ + 2 * zhalo(k); }
__host__ __device__ constexpr int tile_cells(int k, int ty) {
    return (ty + 2 * k) * ext_z(k);
}
__host__ __device__ constexpr int tile_threads(int k, int ty) {
    return 32 * ((tile_cells(k, ty) + 32 * CPT - 1) / (32 * CPT));
}
// NST staged planes of the 6 stored fields, then the float planes: H of
// levels 1..K-1, two E planes of levels 1..K
__host__ __device__ constexpr int tile_smem(int k, int ty, int tbytes) {
    return tile_cells(k, ty) * (NST * 6 * tbytes + (9 * k - 3) * 4);
}

template <typename T> struct Store;
template <> struct Store<float> {
    static __device__ __forceinline__ float f(float v) { return v; }
    static __device__ __forceinline__ void st(float* p, int64_t i, float v) {
        p[i] = v;
    }
};
template <> struct Store<__nv_bfloat16> {
    static __device__ __forceinline__ float f(__nv_bfloat16 v) {
        return __bfloat162float(v);
    }
    static __device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i,
                                              float v) {
        p[i] = __float2bfloat16_rn(v);
    }
};

// an asynchronous copy of two neighbouring z cells into shared memory
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

// what a thread carries from one march position to the next
template <int K> struct Carry {
    float h[K][3][CPT];   // H_s (s = 0..K-1) of the plane before, own cells
    float e[K][3][CPT];   // E_{s+1} of the plane before, own cells
};

template <int K, typename T>
struct March {
    static constexpr int ZE = ext_z(K), TY = ty_of(K);
    static constexpr int ncell = tile_cells(K, TY);
    const LabKStepParams& p;
    T* stage;                    // [NST][6][cell] level-0 planes as stored
    float* fl;                   // float planes
    int64_t n2;
    int a, b, s_out, e_out, hw;  // V rows (n + 2 hw of them)
    int off[CPT], oym[CPT], ozm[CPT], oyp[CPT], ozp[CPT];
    bool act[CPT];
    int own[CPT];                // y n + z of an owned cell (n^2 < 2^31)
    int gpair;                   // y n + z of the thread's staged pair, or -1

    __device__ __forceinline__ float* hplane(int s, int c) const {
        return fl + (3 * (s - 1) + c) * ncell;
    }
    __device__ __forceinline__ float* eplane(int s, int parity, int c) const {
        return fl + (3 * (K - 1) + 6 * (s - 1) + 3 * parity + c) * ncell;
    }
    __device__ __forceinline__ T* staged(int slot, int c) const {
        return stage + (slot * 6 + c) * ncell;
    }

    // V row v's plane of the stored fields
    __device__ __forceinline__ int vplane(int v) const {
        const int n = (int)p.n;
        return v < hw ? v : v < hw + n ? v - hw : v - 2 * hw;
    }

    // starts the copy of V's plane v into stage slot (one group, maybe
    // empty)
    __device__ __forceinline__ void issue(int v, int slot) const {
        if (v < b && gpair >= 0) {
            const int64_t base = vplane(v) * n2 + gpair;
#pragma unroll
            for (int c = 0; c < 6; ++c)
                cp_async<2 * sizeof(T)>(staged(slot, c) + 2 * threadIdx.x,
                                        (const T*)p.inp[c] + base);
        }
        cp_commit();
    }

    // the owned cells of plane x of V into fields c0 .. c0 + 2
    __device__ __forceinline__ void store(int x, int c0,
                                          const float (&v)[3][CPT]) const {
        if (x < s_out || x >= e_out) return;
        const int64_t row = (x - hw) * n2;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            T* dst = (T*)p.out[c0 + c] + row;
#pragma unroll
            for (int i = 0; i < CPT; ++i)
                if (own[i] >= 0) Store<T>::st(dst, own[i], v[c][i]);
        }
    }

    // one march position: level 0 is plane m (stage slot), level s makes
    // E_s(m - s + 1) and H_s(m - s)
    __device__ __forceinline__ void step(int m, int slot,
                                         Carry<K>& cy) const {
        using S = Store<T>;
        const float ca = p.ca, cb = p.cb;
        cp_wait<NST - 2>();
        __syncthreads();
        issue(m + NST - 1, slot == 0 ? NST - 1 : slot - 1);
        float hcur[3][CPT], ecur[3][CPT];  // level s - 1 at plane m - s + 1
        if (m < b) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int i = 0; i < CPT; ++i) {
                    ecur[c][i] = S::f(staged(slot, c)[off[i]]);
                    hcur[c][i] = S::f(staged(slot, 3 + c)[off[i]]);
                }
        }
#pragma unroll
        for (int s = 1; s <= K; ++s) {
            const int xe = m - s + 1, xh = m - s;
            const bool doE = xe >= a && xe < b;
            const bool doH = xh >= a && xh < b;
            const int sp = s > 1 ? s - 2 : 0;  // E_{s-1}'s carry (s > 1)
            float enew[3][CPT], hnew[3][CPT];
            if (doE) {
                float* ex = eplane(s, xe & 1, 0);
                float* ey = eplane(s, xe & 1, 1);
                float* ez = eplane(s, xe & 1, 2);
                // E_{s-1} at plane xe: level 0's, else the carry
                const bool first = xe == a;
#pragma unroll
                for (int i = 0; i < CPT; ++i) {
                    const float hc0 = hcur[0][i], hc1 = hcur[1][i],
                                hc2 = hcur[2][i];
                    const float hp1 = first ? hc1 : cy.h[s - 1][1][i];
                    const float hp2 = first ? hc2 : cy.h[s - 1][2][i];
                    const float ec0 = s == 1 ? ecur[0][i] : cy.e[sp][0][i];
                    const float ec1 = s == 1 ? ecur[1][i] : cy.e[sp][1][i];
                    const float ec2 = s == 1 ? ecur[2][i] : cy.e[sp][2][i];
                    float hz_ym, hx_ym, hy_zm, hx_zm;
                    if (s == 1) {  // H_0 from the staged plane
                        const T* hx = staged(slot, 3);
                        const T* hy = staged(slot, 4);
                        const T* hz = staged(slot, 5);
                        hz_ym = S::f(hz[oym[i]]);
                        hx_ym = S::f(hx[oym[i]]);
                        hy_zm = S::f(hy[ozm[i]]);
                        hx_zm = S::f(hx[ozm[i]]);
                    } else {
                        const float* hx = hplane(s - 1, 0);
                        const float* hy = hplane(s - 1, 1);
                        const float* hz = hplane(s - 1, 2);
                        hz_ym = hz[oym[i]];
                        hx_ym = hx[oym[i]];
                        hy_zm = hy[ozm[i]];
                        hx_zm = hx[ozm[i]];
                    }
                    enew[0][i] = ca * ec0 + cb * ((hc2 - hz_ym) - (hc1 - hy_zm));
                    enew[1][i] = ca * ec1 + cb * ((hc0 - hx_zm) - (hc2 - hp2));
                    enew[2][i] = ca * ec2 + cb * ((hc1 - hp1) - (hc0 - hx_ym));
                    if (act[i]) {
                        ex[off[i]] = enew[0][i];
                        ey[off[i]] = enew[1][i];
                        ez[off[i]] = enew[2][i];
                    }
                }
                if (s == K) store(xe, 0, enew);
            }
            if (doH) {
                const float* ex = eplane(s, xh & 1, 0);
                const float* ey = eplane(s, xh & 1, 1);
                const float* ez = eplane(s, xh & 1, 2);
#pragma unroll
                for (int i = 0; i < CPT; ++i) {
                    const float eo0 = cy.e[s - 1][0][i],
                                eo1 = cy.e[s - 1][1][i],
                                eo2 = cy.e[s - 1][2][i];
                    const float en1 = doE ? enew[1][i] : eo1;
                    const float en2 = doE ? enew[2][i] : eo2;
                    const float ez_yp = ez[oyp[i]], ex_yp = ex[oyp[i]];
                    const float ey_zp = ey[ozp[i]], ex_zp = ex[ozp[i]];
                    hnew[0][i] = ca * cy.h[s - 1][0][i]
                               - cb * ((ez_yp - eo2) - (ey_zp - eo1));
                    hnew[1][i] = ca * cy.h[s - 1][1][i]
                               - cb * ((ex_zp - eo0) - (en2 - eo2));
                    hnew[2][i] = ca * cy.h[s - 1][2][i]
                               - cb * ((en1 - eo1) - (ex_yp - eo0));
                    if (s < K && act[i]) {
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                            hplane(s, c)[off[i]] = hnew[c][i];
                    }
                }
                if (s == K) store(xh, 3, hnew);
            }
            // the carries of level s - 1 are spent: H_{s-1} and E_{s-1}
            // move on to plane m - s + 1
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int i = 0; i < CPT; ++i) {
                    cy.h[s - 1][c][i] = hcur[c][i];
                    if (s > 1) cy.e[sp][c][i] = ecur[c][i];
                    hcur[c][i] = hnew[c][i];
                    ecur[c][i] = enew[c][i];
                }
            if (s < K) __syncthreads();
        }
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
            for (int i = 0; i < CPT; ++i) cy.e[K - 1][c][i] = ecur[c][i];
    }
};

template <int K, typename T>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks(K))
lab_kstep_kernel(const __grid_constant__ LabKStepParams p) {
    using M = March<K, T>;
    constexpr int ZE = M::ZE, ZH = zhalo(K), ty = M::TY;
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t n = p.n;
    M mr{p};
    mr.stage = (T*)smem;
    mr.fl = (float*)(smem + NST * 6 * M::ncell * sizeof(T));
    mr.n2 = n * n;
    mr.hw = p.hw;
    const int L = (int)n + 2 * p.hw;
    const int64_t c = blockIdx.z;
    mr.s_out = p.hw + (int)(c * n / p.chunks);
    mr.e_out = p.hw + (int)((c + 1) * n / p.chunks);
    mr.a = mr.s_out - K > 0 ? mr.s_out - K : 0;
    mr.b = mr.e_out + K < L ? mr.e_out + K : L;
    const int64_t y0 = (int64_t)blockIdx.y * ty;
    const int64_t z0 = (int64_t)blockIdx.x * TZ;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int raw = threadIdx.x + i * blockDim.x;
        mr.act[i] = raw < M::ncell;
        const int cell = mr.act[i] ? raw : 0;
        const int j = cell / ZE, kz = cell - j * ZE;
        mr.off[i] = cell;
        mr.oym[i] = j > 0 ? cell - ZE : cell;
        mr.ozm[i] = kz > 0 ? cell - 1 : cell;
        mr.oyp[i] = j < ty + 2 * K - 1 ? cell + ZE : cell;
        mr.ozp[i] = kz < ZE - 1 ? cell + 1 : cell;
        const int64_t yo = y0 + j - K, zo = z0 + kz - ZH;
        mr.own[i] = mr.act[i] && j >= K && j < K + ty && kz >= ZH &&
                    kz < ZH + TZ && yo < n && zo < n ? (int)(yo * n + zo) : -1;
    }
    {   // the pair of z cells this thread stages: cells 2t and 2t + 1
        const int cell = 2 * threadIdx.x;
        const int j = cell / ZE, kz = cell - j * ZE;
        const int64_t y = ((y0 - K + j) % n + n) % n;
        const int64_t z = ((z0 - ZH + kz) % n + n) % n;
        mr.gpair = cell < M::ncell ? (int)(y * n + z) : -1;
    }

    Carry<K> cy;
#pragma unroll
    for (int st = 0; st < NST - 1; ++st) mr.issue(mr.a + st, st);
    const int end = mr.b + K;
    int slot = 0;
#pragma unroll 1
    for (int m = mr.a; m < end; ++m) {
        mr.step(m, slot, cy);
        slot = slot == NST - 1 ? 0 : slot + 1;
    }
}

template <int K, typename T>
static int configure(int* threads, int* smem) {
    *threads = tile_threads(K, ty_of(K));
    *smem = tile_smem(K, ty_of(K), (int)sizeof(T));
    if (*threads > MAX_THREADS || *smem > SMEM_MAX)
        return (int)cudaErrorInvalidValue;
    if (*smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            lab_kstep_kernel<K, T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

template <int K, typename T>
static int launch(const LabKStepParams& p, cudaStream_t s) {
    int threads, smem;
    const int err = configure<K, T>(&threads, &smem);
    if (err) return err;
    const int64_t gz = (p.n + TZ - 1) / TZ;
    const int64_t gy = (p.n + ty_of(K) - 1) / ty_of(K);
    if (gy > 65535 || p.chunks > 65535)
        return (int)cudaErrorInvalidConfiguration;
    lab_kstep_kernel<K, T><<<dim3((unsigned)gz, (unsigned)gy,
                                  (unsigned)p.chunks),
                             threads, smem, s>>>(p);
    return (int)cudaGetLastError();
}

// threads, shared bytes, blocks per SM, registers and owned y rows of a
// tile of an instantiation
template <int K, typename T>
static int info(int* out) {
    int err = configure<K, T>(&out[0], &out[1]);
    if (err) return err;
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], lab_kstep_kernel<K, T>, out[0], out[1]);
    if (err) return err;
    cudaFuncAttributes attr;
    err = (int)cudaFuncGetAttributes(&attr, lab_kstep_kernel<K, T>);
    out[3] = attr.numRegs;
    out[4] = ty_of(K);
    return err;
}

template <typename T>
static int dispatch(const LabKStepParams& p, cudaStream_t s, int* out) {
    switch (p.k) {
        case 1: return out ? info<1, T>(out) : launch<1, T>(p, s);
        case 2: return out ? info<2, T>(out) : launch<2, T>(p, s);
        case 3: return out ? info<3, T>(out) : launch<3, T>(p, s);
        case 4: return out ? info<4, T>(out) : launch<4, T>(p, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" int t3d_lab_kstep_params_size() {
    return (int)sizeof(LabKStepParams);
}

extern "C" int t3d_lab_kstep_info(const LabKStepParams* p, int* out) {
    return p->bf16 ? dispatch<__nv_bfloat16>(*p, 0, out)
                   : dispatch<float>(*p, 0, out);
}

extern "C" int t3d_lab_kstep(const LabKStepParams* p, void* stream) {
    if (p->n <= 0) return 0;
    if (p->bx < 1 || p->n % p->bx || p->hw < p->k || p->bx % p->hw ||
        p->n % p->hw || p->chunks < 1 || p->chunks > p->n ||
        p->n % 2 || p->n > 46340)  // staged z pairs; y n + z in 32 bits
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return p->bf16 ? dispatch<__nv_bfloat16>(*p, s, nullptr)
                   : dispatch<float>(*p, s, nullptr);
}
