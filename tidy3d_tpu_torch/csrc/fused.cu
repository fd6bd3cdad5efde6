// One whole leapfrog step of the FDTD update in one call, the pole update
// included, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels PallasFusedStepper.step_update
// (tidy3d_tpu/solver/kernels/pallas_fused.py:109, pallas_call at :557) and
// PallasFusedStepper.x_fixup (:579, pallas_call at :897), together with the
// XLA corrections and the pole update of FDTDRunner._step_fused
// (tidy3d_tpu/solver/fdtd.py:1505). It computes what the XLA step
// FDTDRunner._step (fdtd.py:1614) computes up to the H-side sources, for
// real runs with any number of pole slots:
//
//   E' = ca_E * E + cb_E * (curl H + psi_E' - sum_p Re(Gc_p Q_p)),
//        zeroed on the PEC lo walls, plus the J source terms of this step
//   Q_p' = A_p Q_p + B_p (E' + E)                (FDTDRunner._update_poles)
//   H' = ca_H * H - cb_H * (curl E' + psi_H')
//
// with the CPML memories psi' = b * psi + c * d of all three axes of both
// families (the x axis included: on the TPU that was x_fixup's job). B_p is
// B0 times a support mask (pole_kind MASK) or a dense per-cell map (DENSE),
// the layout of KStepParams in kstep.cu. Every output goes to a buffer of
// its own: neighbouring blocks recompute E' of the cells around their tile,
// which reads Q, so Q' must not overwrite it.
//
// Design (an x-march, the one of lab_step.cu). A block of 256 threads owns
// a y/z tile of TY x TZ cells and one chunk of BX x planes. A thread takes
// two z-neighbour cells (a pair: one 64-bit load in float32, one 32-bit
// load in bfloat16). E and H of each plane are staged as stored by
// asynchronous copies of pairs (NST planes deep, two in flight while one is
// read) over the tile plus one row below and above and one pair on each
// side. At march position x the block computes E'(x) on the tile plus the
// row above it and the pair after it (the forward neighbours that H'
// reads; one warp takes those 32 extra pairs, whose E' is computed in full
// and never stored) into a ring of two float32 E' planes in shared memory,
// then H'(x - 1) of its own cells: the y/z neighbours of E'(x - 1) from the
// ring, E'(x) and the x neighbours of H from registers. One barrier a
// plane. The chunk's first plane reads H(x0 - 1) from global memory; its
// last position computes E' of the next chunk's first plane on the own
// cells (not stored), or meets the x hi wall. E is computed on (TY + 1) *
// (TZ + 2) / (TY * TZ) * (BX + 1) / BX = 1.19 times the cells it writes.
// Q, the per-cell coefficients and the residue maps load as pairs straight
// from global memory: staging 6 P arrays would cut the blocks an SM holds.
// A component's 2 P pole currents are held at a time (the pole term of E'_i
// and then Q'_{p,i}).
//
// More than MAX_POLES slots (a metal on an adhesion layer, two metals) do
// not fit the parameter block: such a call reads its slots from a device
// table of PoleSlot (`poles`, built by the host wrapper) on the MANY
// instantiations, one slot at a time, loading each current again for its
// update rather than holding them (2 P of them would not fit the
// registers at P = 13).
//
// Tiles whose cells meet no psi slab, no wall and no source box and lie
// clear of the domain's edge run the bulk instantiation (a launch of its
// own over the box of such tiles) with none of those branches; the rest
// run the shell instantiation, whose psi terms gather every load of a
// component (two cells, two slots) before any is used, and only on the
// axes where the tile meets a slab. Odd z sizes and arrays not aligned to
// a pair take a shell instantiation of their own (vec false: staged and
// loaded cell by cell, the pole slots counted at run time). Index math is
// 32-bit (fewer than 2^31 cells); the wrapped y/z offsets of the staged
// pairs are computed once a block.
//
// Storage. The fields, the psi slabs and the pole currents are stored as
// float32 or bfloat16, each chosen at compile time (T3D_FIELD_BF16,
// T3D_PSI_BF16, T3D_Q_BF16: one library per combination). A value is
// widened to float32 where it is loaded and everything is computed in
// float32; E', H', psi' and Q' are rounded once, to nearest even, where
// they are stored. The ring keeps E' in float32, so H' reads the E' that
// was computed, not the stored one, as step_update's H half-step does. The
// J terms are added to E' before its store. E' + E of the pole update
// takes E' rounded to the field type, the value the next step reads.
//
// The floor is HBM bandwidth: per cell E, H read and E', H' written (24 B
// each way in float32), per pole Q read and Q' written (24 B each way), the
// per-cell ca/cb and residue arrays where the medium varies, and the psi
// slabs (PERF.md).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_POLES = 8;     // MAX_POLES in solver/kernels/step.py
constexpr int MANY = -2;         // the NP of the table instantiations
constexpr int MAX_SOURCES = 32;  // MAX_SOURCES in solver/kernels/fused.py

constexpr int TZ = 32;              // owned z columns of a tile
constexpr int TY = 16;              // owned y rows of a tile
constexpr int BX = 16;              // x planes of a chunk
constexpr int PZ = TZ / 2;          // owned pairs of a row
constexpr int ZE = TZ + 4;          // staged columns: z0 - 2 .. z0 + TZ + 1
constexpr int PE = ZE / 2;          // staged pairs of a row
constexpr int YE = TY + 2;          // staged rows: y0 - 1 .. y0 + TY
constexpr int SPLANE = YE * ZE;     // values of a staged field plane
constexpr int RZ = TZ + 2;          // ring row: own columns + the extra pair
constexpr int RPLANE = (TY + 1) * RZ;  // values of a ring field plane
constexpr int NST = 3;              // staged planes (two in flight)
constexpr int THREADS = TY * PZ;    // one own pair a thread
constexpr int EXTRA_WARP = THREADS / 32 - 1;  // takes the 32 extra pairs
static_assert(TY + PZ == 32, "the extra E' pairs fill one warp");
constexpr int STAGED = YE * PE;     // staged pairs of a field plane
constexpr int STAGE_ITEMS = (STAGED + THREADS - 1) / THREADS;

enum { WALL_PEC = 0, WALL_PMC = 1, WALL_WRAP = 2 };
enum { POLE_ZERO = 0, POLE_MASK = 1, POLE_DENSE = 2 };

#ifdef T3D_FIELD_BF16
typedef __nv_bfloat16 field_t;
#else
typedef float field_t;
#endif
#ifdef T3D_PSI_BF16
typedef __nv_bfloat16 psi_t;
#else
typedef float psi_t;
#endif
#ifdef T3D_Q_BF16
typedef __nv_bfloat16 q_t;
#else
typedef float q_t;
#endif

__host__ __device__ constexpr int smem_bytes() {
    return NST * 6 * SPLANE * (int)sizeof(field_t) + 2 * 3 * RPLANE * 4;
}

// Loads (widened to float32) and stores (rounded to nearest even) of one
// value or of a pair of z neighbours (p at the pair's first cell).
__device__ __forceinline__ float wid(float v) { return v; }
__device__ __forceinline__ float wid(__nv_bfloat16 v) {
    return __uint_as_float((unsigned)__bfloat16_as_ushort(v) << 16);
}
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
// from shared memory
__device__ __forceinline__ float2 sh2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 sh2(const __nv_bfloat16* p) {
    const unsigned v = *reinterpret_cast<const unsigned*>(p);
    return make_float2(__uint_as_float(v << 16),
                       __uint_as_float(v & 0xffff0000u));
}
// the staged value before the pair at p (z - 1 of its first cell) and the
// one after it (the next pair's first cell), as 32-bit shared loads: a
// bfloat16 pair's word holds both cells, the first in its low half
__device__ __forceinline__ float sh_before(const float* p) { return p[-1]; }
__device__ __forceinline__ float sh_before(const __nv_bfloat16* p) {
    return __uint_as_float(*reinterpret_cast<const unsigned*>(p - 2) &
                           0xffff0000u);
}
__device__ __forceinline__ float sh_after(const float* p) { return p[2]; }
__device__ __forceinline__ float sh_after(const __nv_bfloat16* p) {
    return __uint_as_float(*reinterpret_cast<const unsigned*>(p + 2) << 16);
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
// a float32 value rounded to the storage type T and widened back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
    return wid(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 operator*(float2 a, float2 b) {
    return make_float2(a.x * b.x, a.y * b.y);
}
__device__ __forceinline__ float2 operator*(float a, float2 b) {
    return make_float2(a * b.x, a * b.y);
}
__device__ __forceinline__ float2 f2(float v) { return make_float2(v, v); }
__device__ __forceinline__ float cell(float2 v, int q) {
    return q ? v.y : v.x;
}
__device__ __forceinline__ void set_cell(float2& v, int q, float s) {
    if (q) v.y = s; else v.x = s;
}

// One J source term: E'_comp[lo:hi] += term * w (term is the hi - lo box,
// contiguous, with -cb folded in).
struct SrcBox {
    const float* term;
    int32_t comp;
    int32_t lo[3];
    int32_t hi[3];
    float w;
};

// One pole slot of a call with more than MAX_POLES of them, in a device
// table. Mirrored by PoleSlot in tidy3d_tpu_torch/solver/kernels/fused.py.
struct PoleSlot {
    const q_t* q[6];          // [comp * 2 + (0 qr, 1 qi)]
    q_t* q_out[6];
    const float* b[6];        // the mask (part 0) or the dense re/im maps
    float gc_re, gc_im;       // Gc = a (A + 1)
    float a_re, a_im;         // A = (1 + a dt/2) / (1 - a dt/2)
    float b0[6];              // mask kind: B0 (re, im) per comp
    int32_t kind[3];          // POLE_* per comp
    int32_t pad;
};

// Mirrored by FusedParams in tidy3d_tpu_torch/solver/kernels/fused.py.
struct FusedParams {
    const field_t* e_old[3];
    const field_t* h_old[3];
    field_t* e_new[3];
    field_t* h_new[3];
    const float* ca_e[3];      // per-cell coefficient, or null for the scalar
    const float* cb_e[3];
    const float* ca_h[3];
    const float* cb_h[3];
    const float* inv_e[3];     // E stencil inverse steps (kappa folded in)
    const float* inv_h[3];     // H stencil inverse steps
    const psi_t* psi_in_e[12];  // [(2 * comp + slot) * 2 + side]: slot 0 is
    psi_t* psi_out_e[12];       // axis comp+1, slot 1 axis comp+2
    const psi_t* psi_in_h[12];
    psi_t* psi_out_h[12];
    const float* pml_b_e[6];   // [2 * axis + side]
    const float* pml_c_e[6];
    const float* pml_b_h[6];
    const float* pml_c_h[6];
    const q_t* q[6 * MAX_POLES];  // [(pole * 3 + comp) * 2 + (0 qr, 1 qi)]
    q_t* q_out[6 * MAX_POLES];
    const float* pole_b[6 * MAX_POLES];  // the mask (part 0) or the dense
                                         // re/im residue maps
    SrcBox src[MAX_SOURCES];
    float ca_s_e[3];
    float cb_s_e[3];
    float ca_s_h[3];
    float cb_s_h[3];
    float gc_re[MAX_POLES];    // Gc = a (A + 1)
    float gc_im[MAX_POLES];
    float a_re[MAX_POLES];     // A = (1 + a dt/2) / (1 - a dt/2)
    float a_im[MAX_POLES];
    float pole_b0[6 * MAX_POLES];  // mask kind: B0 (re, im) per (pole, comp)
    int32_t pole_kind[3 * MAX_POLES];
    int32_t n[3];              // interior shape (x, y, z), z contiguous;
                               // fewer than 2^31 cells
    int32_t w_e[6];            // psi slab widths [2 * axis + side]
    int32_t w_h[6];
    int32_t bk_lo[3];          // wall the E stencil crosses at lo
    int32_t bk_hi[3];          // wall the H stencil crosses at hi
    int32_t pec_lo[3];         // the lo wall of the axis is PEC (E masks)
    int32_t bulk_lo[3];        // [bulk_lo, bulk_hi) per axis: no psi slab
    int32_t bulk_hi[3];        // and no wall reaches either update there
    int32_t num_poles;
    int32_t num_src;
    int32_t vec;               // set by t3d_fused_step: pairs aligned
    const PoleSlot* poles;     // the table of num_poles slots (MANY), or null
};

static_assert(sizeof(FusedParams) <= 4096,
              "kernel parameters must fit the 4 KB launch limit");

__host__ __device__ __forceinline__ int wrap(int v, int n) {
    return (v % n + n) % n;
}

// Whether the box [lo, hi) meets the cells [a0, a1) of an axis of n cells
// (cells at n and above stand for their wrapped images).
__device__ __forceinline__ bool span_hits(int lo, int hi, int a0, int a1,
                                          int n) {
    if (lo < min(a1, n) && hi > a0) return true;
    return a1 > n && lo < a1 - n;
}

// Whether the tile (chunk x0.., rows y0.., columns z0..) runs on the bulk
// path: every cell whose E' it computes (x0..x0 + BX, y0..y0 + TY, z0..z0 +
// TZ + 1) lies in the bulk (so do the staged neighbours, and the H' cells)
// and no source box reaches them.
__device__ __forceinline__ bool tile_bulk(const FusedParams& p, int x0,
                                          int y0, int z0) {
    const int x_end = x0 + BX;
    if (x0 < p.bulk_lo[0] || x_end >= p.bulk_hi[0] || y0 < p.bulk_lo[1] ||
        y0 + TY >= p.bulk_hi[1] || z0 < max(p.bulk_lo[2], 2) ||
        z0 + TZ + 1 >= p.bulk_hi[2])
        return false;
    for (int s = 0; s < p.num_src; ++s) {
        const SrcBox& b = p.src[s];
        if (b.lo[0] <= x_end && b.hi[0] > x0 && b.lo[1] <= y0 + TY &&
            b.hi[1] > y0 && b.lo[2] <= z0 + TZ + 1 && b.hi[2] > z0)
            return false;
    }
    return true;
}

// A pair of cells: logical row y and column z (of the first cell; cells at
// n and above are the wrapped images of the cells at 0 and above), their
// wrapped offsets inside a plane, whether each is a cell of the domain, and
// the inverse steps of the E or H stencil along y (one row) and z.
struct PairAt {
    int y, z;            // logical
    int yw, zw0, zw1;    // wrapped
    int off0, off1;      // wrapped y * nz + z of both cells
    bool own0, own1;     // a cell of the domain (written by its owner)
    float inv_y;
    float2 inv_z;
};

__device__ __forceinline__ PairAt pair_at(const FusedParams& p, int y, int z,
                                          const float* const* inv) {
    PairAt c;
    c.y = y;
    c.z = z;
    c.yw = wrap(y, p.n[1]);
    c.zw0 = wrap(z, p.n[2]);
    c.zw1 = wrap(z + 1, p.n[2]);
    c.off0 = c.yw * p.n[2] + c.zw0;
    c.off1 = c.yw * p.n[2] + c.zw1;
    c.own0 = y < p.n[1] && z < p.n[2];
    c.own1 = y < p.n[1] && z + 1 < p.n[2];
    c.inv_y = __ldg(inv[1] + c.yw);
    c.inv_z = make_float2(__ldg(inv[2] + c.zw0), __ldg(inv[2] + c.zw1));
    return c;
}

// Where the slab on axis A that holds the cell at wrapped coordinates c
// keeps the cell's psi (in, out) and its CPML b and c; idx0: the (comp,
// slot) entry of the psi arrays, (2 * comp + slot) * 2, to which the side
// adds. Where no slab holds the cell, ok is false and every pointer is
// spare (a valid address, read and not used), so that the loads of several
// cells and slots issue together, without a branch.
struct PsiRef {
    const psi_t* in;
    psi_t* out;
    const float* b;
    const float* c;
    bool ok;
};

template <int A>
__device__ __forceinline__ PsiRef psi_ref(
    const psi_t* const* psi_in, psi_t* const* psi_out,
    const float* const* pml_b, const float* const* pml_c, const int32_t* w,
    const int32_t* n, int idx0, const int* c, const float* spare) {
    const int wl = w[2 * A], wh = w[2 * A + 1];
    const bool hi = c[A] >= n[A] - wh;
    const int side = hi ? 1 : 0;
    const int loc = hi ? c[A] - (n[A] - wh) : c[A];
    const int wd = hi ? wh : wl;
    // the slab spans every cell of the other two axes
    const int off = A == 0 ? (loc * n[1] + c[1]) * n[2] + c[2]
                  : A == 1 ? (c[0] * wd + loc) * n[2] + c[2]
                           : (c[0] * n[1] + c[1]) * wd + loc;
    PsiRef r;
    r.ok = hi || c[A] < wl;
    r.in = r.ok ? psi_in[idx0 + side] + off
                : reinterpret_cast<const psi_t*>(spare);
    r.out = psi_out[idx0 + side] + off;
    r.b = r.ok ? pml_b[2 * A + side] + loc : spare;
    r.c = r.ok ? pml_c[2 * A + side] + loc : spare;
    return r;
}

// rhs (+ psi_j') (- psi_k') of the pair c at plane xw for the psi slabs of
// (comp I, slots j and k) on the axes psi_axes names: all loads first,
// then psi' = b * psi + c * d, stored where store and the cell is owned.
template <int I>
__device__ __forceinline__ float2 psi_terms(
    const psi_t* const* psi_in, psi_t* const* psi_out,
    const float* const* pml_b, const float* const* pml_c, const int32_t* w,
    const int32_t* n, const PairAt& c, int xw, float2 rhs, float2 d1,
    float2 d2, bool store, unsigned psi_axes, const float* spare) {
    constexpr int j = (I + 1) % 3, k = (I + 2) % 3;
    PsiRef r[2][2];
    float v[2][2][3];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int cw[3] = {xw, c.yw, q ? c.zw1 : c.zw0};
        r[q][0] = psi_ref<j>(psi_in, psi_out, pml_b, pml_c, w, n, 4 * I, cw,
                             spare);
        r[q][1] = psi_ref<k>(psi_in, psi_out, pml_b, pml_c, w, n, 4 * I + 2,
                             cw, spare);
        r[q][0].ok = r[q][0].ok && (psi_axes >> j & 1);
        r[q][1].ok = r[q][1].ok && (psi_axes >> k & 1);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            v[q][s][0] = __ldg(r[q][s].b);
            v[q][s][1] = __ldg(r[q][s].c);
            v[q][s][2] = ld1(r[q][s].in);
        }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const bool st = store && (q ? c.own1 : c.own0);
        float out = cell(rhs, q);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            if (!r[q][s].ok) continue;
            const float psi = v[q][s][0] * v[q][s][2] +
                              v[q][s][1] * cell(s ? d2 : d1, q);
            if (st) st1(r[q][s].out, psi);
            out = s ? out - psi : out + psi;
        }
        set_cell(rhs, q, out);
    }
    return rhs;
}

// a float32 per-cell array (a coefficient or residue map) at the pair
template <bool VEC>
__device__ __forceinline__ float2 coef2(const float* a, int base,
                                        const PairAt& c) {
    if (VEC) return ld2(a + base + c.off0);
    return make_float2(__ldg(a + base + c.off0), __ldg(a + base + c.off1));
}
template <bool VEC, typename T>
__device__ __forceinline__ float2 val2(const T* a, int base,
                                       const PairAt& c) {
    if (VEC) return ld2(a + base + c.off0);
    return make_float2(ld1(a + base + c.off0), ld1(a + base + c.off1));
}
template <bool VEC, typename T>
__device__ __forceinline__ void store2(T* a, int base, const PairAt& c,
                                       float2 v) {
    if (VEC) {
        if (c.own0) st2(a + base + c.off0, v);
    } else {
        if (c.own0) st1(a + base + c.off0, v.x);
        if (c.own1) st1(a + base + c.off1, v.y);
    }
}

// the wall value of a stencil neighbour across a non-wrapping wall
__device__ __forceinline__ float wall(int kind, float self) {
    return kind == WALL_PEC ? 0.0f : self;
}

// E'_i of the pair c of plane x (logical; wrapped xw, base = xw * ny * nz)
// from its curl terms d1 (along j) and d2 (along k), into e; when store
// (an own plane), E', psi_E' and the pole currents Q' of the owned cells
// are written. q_base: the pole currents' offset (base). esum of the pole
// update: E' rounded to the field type, widened, plus E.
template <int I, int NP, bool BULK, bool VEC>
__device__ __forceinline__ float2 e_comp(const FusedParams& p,
                                         const PairAt& c, int xw, int base,
                                         float2 d1, float2 d2, float2 eold,
                                         bool store, unsigned smask,
                                         unsigned psi_axes) {
    constexpr int i = I, j = (I + 1) % 3, k = (I + 2) % 3;
    float2 rhs = d1 - d2;
    if (!BULK && (psi_axes & (1u << j | 1u << k)))
        rhs = psi_terms<I>(p.psi_in_e, p.psi_out_e, p.pml_b_e, p.pml_c_e,
                           p.w_e, p.n, c, xw, rhs, d1, d2, store, psi_axes,
                           p.inv_e[0]);
    // the pole term: NP >= 0 holds the component's 2 NP currents for the
    // update below (a specialization per slot count: measured faster at 7
    // slots than holding none); NP < 0 (the slots in use read at run time)
    // holds none and loads each again there
    constexpr int NQ = NP > 0 ? NP : 1;
    const int np = NP < 0 ? p.num_poles : NP;
    float2 qr[NQ], qi[NQ];
    auto current = [&](int q, float2* r, float2* m) {
        *r = val2<VEC>(p.q[(q * 3 + i) * 2], base, c);
        *m = val2<VEC>(p.q[(q * 3 + i) * 2 + 1], base, c);
    };
    if constexpr (NP == MANY) {
        for (int q = 0; q < np; ++q) {
            const PoleSlot& slot = p.poles[q];
            const float2 r = val2<VEC>(slot.q[2 * i], base, c);
            const float2 m = val2<VEC>(slot.q[2 * i + 1], base, c);
            rhs = rhs - (slot.gc_re * r - slot.gc_im * m);
        }
    } else if (NP >= 0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            if (q >= np) break;
            current(q, &qr[q], &qi[q]);
            rhs = rhs - (p.gc_re[q] * qr[q] - p.gc_im[q] * qi[q]);
        }
    } else {
        for (int q = 0; q < np; ++q) {
            float2 r, m;
            current(q, &r, &m);
            rhs = rhs - (p.gc_re[q] * r - p.gc_im[q] * m);
        }
    }
    const float2 ca = p.ca_e[i] ? coef2<VEC>(p.ca_e[i], base, c)
                                : f2(p.ca_s_e[i]);
    const float2 cb = p.cb_e[i] ? coef2<VEC>(p.cb_e[i], base, c)
                                : f2(p.cb_s_e[i]);
    float2 out = ca * eold + cb * rhs;
    if (!BULK) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int cw[3] = {xw, c.yw, q ? c.zw1 : c.zw0};
            float v = cell(out, q);
            if ((p.pec_lo[j] && cw[j] == 0) || (p.pec_lo[k] && cw[k] == 0))
                v = 0.0f;
            for (unsigned m = smask; m; m &= m - 1) {
                const SrcBox& b = p.src[__ffs(m) - 1];
                if (b.comp != i || cw[0] < b.lo[0] || cw[0] >= b.hi[0] ||
                    cw[1] < b.lo[1] || cw[1] >= b.hi[1] ||
                    cw[2] < b.lo[2] || cw[2] >= b.hi[2])
                    continue;
                const int off = ((cw[0] - b.lo[0]) * (b.hi[1] - b.lo[1]) +
                                 (cw[1] - b.lo[1])) * (b.hi[2] - b.lo[2]) +
                                (cw[2] - b.lo[2]);
                v = v + __ldg(b.term + off) * b.w;
            }
            set_cell(out, q, v);
        }
    }
    if (store) {
        store2<VEC>(p.e_new[i], base, c, out);
        if (NP != 0 && np > 0) {
            const float2 esum = make_float2(rnd<field_t>(out.x),
                                            rnd<field_t>(out.y)) + eold;
            auto update = [&](int q, float2 cr, float2 ci) {
                const int qx = (q * 3 + i) * 2;
                const float are = p.a_re[q], aim = p.a_im[q];
                const float2 im_qr = aim * cr;
                float2 r = are * cr + (-aim) * ci;
                float2 m = are * ci + im_qr;
                const int kind = p.pole_kind[q * 3 + i];
                if (kind == POLE_MASK) {
                    const float2 mes = coef2<VEC>(p.pole_b[qx], base, c) *
                                       esum;
                    r = r + p.pole_b0[qx] * mes;
                    m = m + p.pole_b0[qx + 1] * mes;
                } else if (kind == POLE_DENSE) {
                    r = r + coef2<VEC>(p.pole_b[qx], base, c) * esum;
                    m = m + coef2<VEC>(p.pole_b[qx + 1], base, c) * esum;
                }
                store2<VEC>(p.q_out[qx], base, c, r);
                store2<VEC>(p.q_out[qx + 1], base, c, m);
            };
            if constexpr (NP == MANY) {
                for (int q = 0; q < np; ++q) {
                    const PoleSlot& slot = p.poles[q];
                    const float2 cr = val2<VEC>(slot.q[2 * i], base, c);
                    const float2 ci = val2<VEC>(slot.q[2 * i + 1], base, c);
                    float2 r = slot.a_re * cr + (-slot.a_im) * ci;
                    float2 m = slot.a_re * ci + slot.a_im * cr;
                    const int kind = slot.kind[i];
                    if (kind == POLE_MASK) {
                        const float2 mes =
                            coef2<VEC>(slot.b[2 * i], base, c) * esum;
                        r = r + slot.b0[2 * i] * mes;
                        m = m + slot.b0[2 * i + 1] * mes;
                    } else if (kind == POLE_DENSE) {
                        r = r + coef2<VEC>(slot.b[2 * i], base, c) * esum;
                        m = m + coef2<VEC>(slot.b[2 * i + 1], base, c) * esum;
                    }
                    store2<VEC>(slot.q_out[2 * i], base, c, r);
                    store2<VEC>(slot.q_out[2 * i + 1], base, c, m);
                }
            } else if (NP >= 0) {
#pragma unroll
                for (int q = 0; q < NQ; ++q)
                    if (q < np) update(q, qr[q], qi[q]);
            } else {
                for (int q = 0; q < np; ++q) {
                    float2 r, m;
                    current(q, &r, &m);
                    update(q, r, m);
                }
            }
        }
    }
    return out;
}

// E' of the pair c at staged offset s of plane x (slot f of the stage,
// wrapped xw) from the staged H(x), its neighbours below in y and z, and
// hp = (Hy, Hz) of plane x - 1; returns H(x) of the pair in h.
template <int NP, bool BULK, bool VEC>
__device__ __forceinline__ void e_pair(const FusedParams& p, const PairAt& c,
                                       const field_t* f, int x, int xw,
                                       float inv_x, const float2 (&hp)[2],
                                       bool store, unsigned smask,
                                       unsigned psi_axes, float2 (&e)[3],
                                       float2 (&h)[3]) {
    const int base = xw * p.n[1] * p.n[2];
#pragma unroll
    for (int m = 0; m < 3; ++m) h[m] = sh2(f + (3 + m) * SPLANE);
    // the neighbours at -1: along y (row below), z (cell before), x (hp)
    float2 pz_y = sh2(f + 5 * SPLANE - ZE);
    float2 px_y = sh2(f + 3 * SPLANE - ZE);
    float2 py_z = make_float2(sh_before(f + 4 * SPLANE), h[1].x);
    float2 px_z = make_float2(sh_before(f + 3 * SPLANE), h[0].x);
    float2 py_x = hp[0], pz_x = hp[1];
    if (!BULK) {
        if (c.y == 0 && p.bk_lo[1] != WALL_WRAP) {
            pz_y = make_float2(wall(p.bk_lo[1], h[2].x),
                               wall(p.bk_lo[1], h[2].y));
            px_y = make_float2(wall(p.bk_lo[1], h[0].x),
                               wall(p.bk_lo[1], h[0].y));
        }
        if (c.z == 0 && p.bk_lo[2] != WALL_WRAP) {
            py_z.x = wall(p.bk_lo[2], h[1].x);
            px_z.x = wall(p.bk_lo[2], h[0].x);
        }
        if (x == 0 && p.bk_lo[0] != WALL_WRAP) {
            py_x = make_float2(wall(p.bk_lo[0], h[1].x),
                               wall(p.bk_lo[0], h[1].y));
            pz_x = make_float2(wall(p.bk_lo[0], h[2].x),
                               wall(p.bk_lo[0], h[2].y));
        }
    }
    const float2 dz_y = c.inv_y * (h[2] - pz_y);
    const float2 dy_z = (h[1] - py_z) * c.inv_z;
    const float2 dx_z = (h[0] - px_z) * c.inv_z;
    const float2 dz_x = inv_x * (h[2] - pz_x);
    const float2 dy_x = inv_x * (h[1] - py_x);
    const float2 dx_y = c.inv_y * (h[0] - px_y);
    e[0] = e_comp<0, NP, BULK, VEC>(p, c, xw, base, dz_y, dy_z, sh2(f),
                                    store, smask, psi_axes);
    e[1] = e_comp<1, NP, BULK, VEC>(p, c, xw, base, dx_z, dz_x,
                                    sh2(f + SPLANE), store, smask, psi_axes);
    e[2] = e_comp<2, NP, BULK, VEC>(p, c, xw, base, dy_x, dx_y,
                                    sh2(f + 2 * SPLANE), store, smask,
                                    psi_axes);
}

// H'_i of the own pair from its curl terms, with psi_H' (shell).
template <int I, bool BULK, bool VEC>
__device__ __forceinline__ void h_comp(const FusedParams& p,
                                       const PairAt& c, int xw, int base,
                                       float2 d1, float2 d2, float2 hold,
                                       unsigned psi_axes) {
    constexpr int i = I, j = (I + 1) % 3, k = (I + 2) % 3;
    float2 rhs = d1 - d2;
    if (!BULK && (psi_axes & (1u << j | 1u << k)))
        rhs = psi_terms<I>(p.psi_in_h, p.psi_out_h, p.pml_b_h, p.pml_c_h,
                           p.w_h, p.n, c, xw, rhs, d1, d2, true, psi_axes,
                           p.inv_h[0]);
    const float2 ca = p.ca_h[i] ? coef2<VEC>(p.ca_h[i], base, c)
                                : f2(p.ca_s_h[i]);
    const float2 cb = p.cb_h[i] ? coef2<VEC>(p.cb_h[i], base, c)
                                : f2(p.cb_s_h[i]);
    store2<VEC>(p.h_new[i], base, c, ca * hold - cb * rhs);
}

// H' of the own pair c of plane x (< n[0]) from E'(x) (eo), its y/z
// neighbours in ring plane r, E'(x + 1) (en, unless the x hi wall is
// crossed) and H(x) (ho).
template <bool BULK, bool VEC>
__device__ __forceinline__ void h_pair(const FusedParams& p, const PairAt& c,
                                       const float* r, int x, float inv_x,
                                       const float2 (&eo)[3],
                                       const float2 (&en)[3],
                                       const float2 (&ho)[3],
                                       unsigned psi_axes) {
    const int base = x * p.n[1] * p.n[2];
    // the neighbours at +1: along y (ring row above), z, x (en)
    float2 ez_y = sh2(r + 2 * RPLANE + RZ);
    float2 ex_y = sh2(r + RZ);
    float2 ey_z = make_float2(eo[1].y, r[RPLANE + 2]);
    float2 ex_z = make_float2(eo[0].y, r[2]);
    float2 ey_x = en[1], ez_x = en[2];
    if (!BULK) {
        if (c.y == p.n[1] - 1 && p.bk_hi[1] != WALL_WRAP) {
            ez_y = make_float2(wall(p.bk_hi[1], eo[2].x),
                               wall(p.bk_hi[1], eo[2].y));
            ex_y = make_float2(wall(p.bk_hi[1], eo[0].x),
                               wall(p.bk_hi[1], eo[0].y));
        }
        if (p.bk_hi[2] != WALL_WRAP) {
            if (c.z == p.n[2] - 1) {
                ey_z.x = wall(p.bk_hi[2], eo[1].x);
                ex_z.x = wall(p.bk_hi[2], eo[0].x);
            }
            if (c.z + 1 == p.n[2] - 1) {
                ey_z.y = wall(p.bk_hi[2], eo[1].y);
                ex_z.y = wall(p.bk_hi[2], eo[0].y);
            }
        }
        if (x == p.n[0] - 1 && p.bk_hi[0] != WALL_WRAP) {
            ey_x = make_float2(wall(p.bk_hi[0], eo[1].x),
                               wall(p.bk_hi[0], eo[1].y));
            ez_x = make_float2(wall(p.bk_hi[0], eo[2].x),
                               wall(p.bk_hi[0], eo[2].y));
        }
    }
    h_comp<0, BULK, VEC>(p, c, x, base, c.inv_y * (ez_y - eo[2]),
                         (ey_z - eo[1]) * c.inv_z, ho[0], psi_axes);
    h_comp<1, BULK, VEC>(p, c, x, base, (ex_z - eo[0]) * c.inv_z,
                         inv_x * (ez_x - eo[2]), ho[1], psi_axes);
    h_comp<2, BULK, VEC>(p, c, x, base, inv_x * (ey_x - eo[1]),
                         c.inv_y * (ex_y - eo[0]), ho[2], psi_axes);
}

__device__ __forceinline__ void put_ring(float* r, const float2 (&e)[3]) {
#pragma unroll
    for (int m = 0; m < 3; ++m)
        *reinterpret_cast<float2*>(r + m * RPLANE) = e[m];
}

// The march of one tile (blockIdx + base: the tile's z, y and x chunk
// index). BULK: the tile is a bulk tile (no wall, psi slab, source or wrap
// on its path); else the shell path, which returns at once for a bulk tile
// when p.vec (the bulk launch takes it). VEC: pairs staged and loaded
// whole (p.vec; the bulk path always). NP < 0: the pole slots in use are
// read at run time (the shell of unaligned arrays). Up to two pole slots
// the bulk path is held to three blocks an SM (85 registers) and the
// shell path to two; more slots are held to none: each measured faster
// so (PERF.md).
template <int NP, bool BULK, bool VEC>
__global__ void __launch_bounds__(THREADS,
                                  NP < 0 || NP > 2 ? 1 : BULK ? 3 : 2)
fused_step_kernel(const __grid_constant__ FusedParams p, int base_z,
                  int base_y, int base_x) {
    extern __shared__ __align__(16) unsigned char smem[];
    field_t* const stage = reinterpret_cast<field_t*>(smem);  // [NST][6][YE][ZE]
    float* const ring = reinterpret_cast<float*>(
        smem + NST * 6 * SPLANE * sizeof(field_t));           // [2][3][TY+1][RZ]
    const int nx = p.n[0], ny = p.n[1], nz = p.n[2];
    const int z0 = (blockIdx.x + base_z) * TZ;
    const int y0 = (blockIdx.y + base_y) * TY;
    const int x0 = (blockIdx.z + base_x) * BX;
    if (z0 >= nz || y0 >= ny || x0 >= nx) return;
    const int x_end = min(x0 + BX, nx);
    const bool bulk = tile_bulk(p, x0, y0, z0);
    if (BULK ? !bulk : (bulk && p.vec)) return;
    static_assert(VEC || !BULK, "the bulk path loads pairs");
    constexpr bool vec = VEC;
    // the source boxes that reach the cells whose E' the tile computes
    unsigned smask = 0;
    if (!BULK) {
        for (int s = 0; s < p.num_src; ++s) {
            const SrcBox& b = p.src[s];
            if (span_hits(b.lo[0], b.hi[0], x0, x_end + 1, nx) &&
                span_hits(b.lo[1], b.hi[1], y0, y0 + TY + 1, ny) &&
                span_hits(b.lo[2], b.hi[2], z0, z0 + TZ + 2, nz))
                smask |= 1u << s;
        }
    }
    // the axes on which the cells whose E' (H') the tile computes meet a
    // psi slab of the family (cells at n and above count as meeting one)
    unsigned psi_e = 0, psi_h = 0;
    if (!BULK) {
        const int lo[3] = {x0, y0, z0};
        const int hi_e[3] = {x_end, y0 + TY, z0 + TZ + 1};
        const int hi_h[3] = {x_end - 1, y0 + TY - 1, z0 + TZ - 1};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            if (lo[a] < p.w_e[2 * a] || hi_e[a] >= p.n[a] - p.w_e[2 * a + 1])
                psi_e |= 1u << a;
            if (lo[a] < p.w_h[2 * a] || hi_h[a] >= p.n[a] - p.w_h[2 * a + 1])
                psi_h |= 1u << a;
        }
    }
    const int t = threadIdx.x;
    const int lane = t % 32;
    const bool extra = t / 32 == EXTRA_WARP;

    // the staged pairs this thread copies: shared offset, wrapped y * nz + z
    // of both cells
    int soff[STAGE_ITEMS], ga[STAGE_ITEMS], gb[STAGE_ITEMS];
#pragma unroll
    for (int it = 0; it < STAGE_ITEMS; ++it) {
        const int s = t + it * THREADS;
        const int jj = s / PE, qq = s - jj * PE;
        const int y = BULK ? y0 - 1 + jj : wrap(y0 - 1 + jj, ny);
        soff[it] = s < STAGED ? jj * ZE + 2 * qq : -1;
        ga[it] = y * nz + (BULK ? z0 - 2 + 2 * qq : wrap(z0 - 2 + 2 * qq, nz));
        gb[it] = y * nz + (BULK ? z0 - 1 + 2 * qq : wrap(z0 - 1 + 2 * qq, nz));
    }
    // the own pair (tile row oj, pair op) and the extra pair of the extra
    // warp: the row above the tile, then the pair after it
    const int oj = t / PZ, op = t % PZ;
    const int so = (oj + 1) * ZE + 2 * (op + 1);
    const int ro = oj * RZ + 2 * op;
    const int xj = lane < PZ ? TY : lane - PZ;
    const int xp = lane < PZ ? lane : PZ;
    const int xso = (xj + 1) * ZE + 2 * (xp + 1);
    const int xro = xj * RZ + 2 * xp;
    const PairAt own = pair_at(p, y0 + oj, z0 + 2 * op, p.inv_e);
    const PairAt hown = pair_at(p, y0 + oj, z0 + 2 * op, p.inv_h);
    const PairAt xtra = pair_at(p, y0 + xj, z0 + 2 * xp, p.inv_e);
    const int nyz = ny * nz;

    // the last march position computes E' of plane x_end on the own
    // cells unless the x hi wall ends the domain there
    const int nown = x_end - x0;
    const bool lead_out = x_end < nx || p.bk_hi[0] == WALL_WRAP;
    const int nstage = nown + (lead_out ? 1 : 0);

    auto stage_plane = [&](int pos) {
        if (pos < nstage) {
            const int xw = BULK ? x0 + pos : wrap(x0 + pos, nx);
            const int base = xw * nyz;
            field_t* const dst0 = stage + (pos % NST) * 6 * SPLANE;
#pragma unroll
            for (int m = 0; m < 6; ++m) {
                const field_t* src = (m < 3 ? p.e_old[m] : p.h_old[m - 3]) +
                                     base;
                field_t* dst = dst0 + m * SPLANE;
#pragma unroll
                for (int it = 0; it < STAGE_ITEMS; ++it) {
                    if (soff[it] < 0) continue;
                    if (vec) {
                        __pipeline_memcpy_async(dst + soff[it], src + ga[it],
                                                2 * sizeof(field_t));
                    } else {
                        dst[soff[it]] = src[ga[it]];
                        dst[soff[it] + 1] = src[gb[it]];
                    }
                }
            }
        }
        __pipeline_commit();
    };

    // H of plane x0 - 1 (Hy, Hz): the x neighbours of the first E' plane
    float2 hp[2], xh[2];
    {
        const int base = (BULK ? x0 - 1 : wrap(x0 - 1, nx)) * nyz;
        hp[0] = vec ? val2<true>(p.h_old[1], base, own)
                    : val2<false>(p.h_old[1], base, own);
        hp[1] = vec ? val2<true>(p.h_old[2], base, own)
                    : val2<false>(p.h_old[2], base, own);
        if (extra) {
            xh[0] = vec ? val2<true>(p.h_old[1], base, xtra)
                        : val2<false>(p.h_old[1], base, xtra);
            xh[1] = vec ? val2<true>(p.h_old[2], base, xtra)
                        : val2<false>(p.h_old[2], base, xtra);
        }
    }

    float2 eo[3], ho[3];
    stage_plane(0);
    stage_plane(1);
#pragma unroll 1
    for (int pos = 0; pos <= nown; ++pos) {
        __pipeline_wait_prior(NST - 2);
        __syncthreads();
        stage_plane(pos + 2);
        const int x = x0 + pos;
        const int xw = BULK ? x : wrap(x, nx);
        const field_t* const f = stage + (pos % NST) * 6 * SPLANE;
        float* const rcur = ring + (pos & 1) * 3 * RPLANE;
        float2 e[3], h[3];
        if (pos < nstage) {
            const bool owned = pos < nown;
            const float inv_x = __ldg(p.inv_e[0] + xw);
            if (vec)
                e_pair<NP, BULK, true>(p, own, f + so, x, xw, inv_x, hp,
                                       owned, smask, psi_e, e, h);
            else
                e_pair<NP, BULK, false>(p, own, f + so, x, xw, inv_x, hp,
                                        owned, smask, psi_e, e, h);
            if (owned) {
                put_ring(rcur + ro, e);
                if (extra) {  // the ring's edge
                    float2 xe[3], xhn[3];
                    if (vec)
                        e_pair<NP, BULK, true>(p, xtra, f + xso, x, xw, inv_x,
                                               xh, false, smask, psi_e, xe,
                                               xhn);
                    else
                        e_pair<NP, BULK, false>(p, xtra, f + xso, x, xw,
                                                inv_x, xh, false, smask,
                                                psi_e, xe, xhn);
                    put_ring(rcur + xro, xe);
                    xh[0] = xhn[1];
                    xh[1] = xhn[2];
                }
            }
        }
        if (pos >= 1) {
            const float inv_hx = __ldg(p.inv_h[0] + x - 1);
            const float* const rprev = ring + ((pos - 1) & 1) * 3 * RPLANE +
                                       ro;
            if (vec)
                h_pair<BULK, true>(p, hown, rprev, x - 1, inv_hx, eo, e, ho,
                                   psi_h);
            else
                h_pair<BULK, false>(p, hown, rprev, x - 1, inv_hx, eo, e, ho,
                                    psi_h);
        }
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            eo[m] = e[m];
            ho[m] = h[m];
        }
        hp[0] = h[1];
        hp[1] = h[2];
    }
}

typedef void (*KernelFn)(FusedParams, int, int, int);

// The instantiation for np pole slots (bulk, or shell); the shell of
// arrays not aligned to a pair has one for every slot count, which reads
// the slots in use at run time.
template <int NP>
static KernelFn kernel_np(bool bulk, bool vec) {
    if (!vec) return fused_step_kernel<-1, false, false>;
    return bulk ? fused_step_kernel<NP, true, true>
                : fused_step_kernel<NP, false, true>;
}

static KernelFn kernel_for(int np, bool bulk, bool vec = true) {
    if (np > MAX_POLES)
        return !vec ? fused_step_kernel<MANY, false, false>
               : bulk ? fused_step_kernel<MANY, true, true>
                      : fused_step_kernel<MANY, false, true>;
    switch (np) {
        case 0: return kernel_np<0>(bulk, vec);
        case 1: return kernel_np<1>(bulk, vec);
        case 2: return kernel_np<2>(bulk, vec);
        case 3: return kernel_np<3>(bulk, vec);
        case 4: return kernel_np<4>(bulk, vec);
        case 5: return kernel_np<5>(bulk, vec);
        case 6: return kernel_np<6>(bulk, vec);
        case 7: return kernel_np<7>(bulk, vec);
        case 8: return kernel_np<8>(bulk, vec);
    }
    return nullptr;
}

static cudaError_t prepare(KernelFn fn) {
    return cudaFuncSetAttribute((const void*)fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes());
}

// Every array a pair load reads or a pair store writes is aligned to a
// pair, and z holds an even number of cells.
static bool pair_aligned(const FusedParams& p) {
    if (p.n[2] % 2) return false;
    const uintptr_t fa = 2 * sizeof(field_t), qa = 2 * sizeof(q_t);
    for (int i = 0; i < 3; ++i) {
        if ((uintptr_t)p.e_old[i] % fa || (uintptr_t)p.h_old[i] % fa ||
            (uintptr_t)p.e_new[i] % fa || (uintptr_t)p.h_new[i] % fa ||
            (uintptr_t)p.ca_e[i] % 8 || (uintptr_t)p.cb_e[i] % 8 ||
            (uintptr_t)p.ca_h[i] % 8 || (uintptr_t)p.cb_h[i] % 8)
            return false;
    }
    if (!p.poles)   // (the currents of a table: checked by the host wrapper)
        for (int i = 0; i < 6 * p.num_poles; ++i)
            if ((uintptr_t)p.q[i] % qa || (uintptr_t)p.q_out[i] % qa ||
                (uintptr_t)p.pole_b[i] % 8)
                return false;
    return true;
}

// The tiles [lo, hi) of an axis whose bulk condition holds on that axis
// (tile_bulk's per-axis part), for a tile of `len` cells that computes E'
// on `reach` more past its end.
static void bulk_range(int lo_cell, int hi_cell, int len, int reach,
                       int tiles, int* lo, int* hi) {
    *lo = (lo_cell + len - 1) / len;
    *hi = *lo;
    while (*hi < tiles && *hi * len + len - 1 + reach < hi_cell) ++*hi;
}

extern "C" int t3d_fused_params_size() { return (int)sizeof(FusedParams); }
extern "C" int t3d_fused_pole_slot_size() { return (int)sizeof(PoleSlot); }

// The bytes of the field, psi and pole-current values this library stores.
extern "C" void t3d_fused_storage(int32_t* out) {
    out[0] = (int32_t)sizeof(field_t);
    out[1] = (int32_t)sizeof(psi_t);
    out[2] = (int32_t)sizeof(q_t);
}

// Threads, shared bytes, blocks per SM and registers of the instantiation
// for np pole slots (bulk, or the shell of pair-aligned arrays; np above
// MAX_POLES: the table's); a CUDA error code, or 0.
extern "C" int t3d_fused_info(int np, int bulk, int32_t* out) {
    const KernelFn fn = kernel_for(np, bulk != 0);
    if (!fn) return (int)cudaErrorInvalidValue;
    cudaError_t err = prepare(fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = THREADS;
    out[1] = smem_bytes();
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, (const void*)fn, THREADS, smem_bytes());
    if (err != cudaSuccess) return (int)err;
    out[2] = blocks;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, (const void*)fn);
    out[3] = attr.numRegs;
    return (int)err;
}

// The bulk launch over the box of tiles that may be bulk tiles (when the
// arrays are pair-aligned), then the shell launch over every tile.
// counts (may be null): the two launches' blocks and the launches made.
extern "C" int t3d_fused_step(const FusedParams* p, void* stream,
                              int32_t* counts) {
    if (p->n[0] <= 0 || p->n[1] <= 0 || p->n[2] <= 0) return 0;
    if (p->num_poles < 0 || (p->num_poles > MAX_POLES) != (p->poles != 0) ||
        p->num_src < 0 ||
        p->num_src > MAX_SOURCES ||
        (int64_t)p->n[0] * p->n[1] * p->n[2] > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    FusedParams q = *p;
    q.vec = pair_aligned(q) ? 1 : 0;
    const int tiles[3] = {(q.n[2] + TZ - 1) / TZ, (q.n[1] + TY - 1) / TY,
                          (q.n[0] + BX - 1) / BX};
    if (tiles[1] > 65535 || tiles[2] > 65535)
        return (int)cudaErrorInvalidConfiguration;
    const KernelFn shell = kernel_for(q.num_poles, false, q.vec != 0);
    const KernelFn bulk = kernel_for(q.num_poles, true);
    cudaError_t err = prepare(shell);
    if (err == cudaSuccess) err = prepare(bulk);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_bytes();
    cfg.stream = (cudaStream_t)stream;
    int lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
    if (q.vec) {
        // E' reaches the pair after a tile's columns, the row above it and
        // the plane after its chunk (tile_bulk)
        bulk_range(max(q.bulk_lo[2], 2), q.bulk_hi[2], TZ, 2, tiles[0],
                   &lo[0], &hi[0]);
        bulk_range(q.bulk_lo[1], q.bulk_hi[1], TY, 1, tiles[1], &lo[1],
                   &hi[1]);
        bulk_range(q.bulk_lo[0], q.bulk_hi[0], BX, 1, tiles[2], &lo[2],
                   &hi[2]);
    }
    const int64_t nbulk = (int64_t)(hi[0] - lo[0]) * (hi[1] - lo[1]) *
                          (hi[2] - lo[2]);
    if (nbulk > 0) {
        cfg.gridDim = dim3(hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2]);
        err = cudaLaunchKernelEx(&cfg, bulk, q, lo[0], lo[1], lo[2]);
        if (err == cudaSuccess) err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    cfg.gridDim = dim3(tiles[0], tiles[1], tiles[2]);
    err = cudaLaunchKernelEx(&cfg, shell, q, 0, 0, 0);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (counts) {
        counts[0] = (int32_t)nbulk;
        counts[1] = tiles[0] * tiles[1] * tiles[2];
        counts[2] = nbulk > 0 ? 2 : 1;
    }
    return (int)err;
}
