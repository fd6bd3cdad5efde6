// Half-step family update of the FDTD leapfrog, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel PallasStepper.family_update
// (tidy3d_tpu/solver/kernels/pallas_step.py:118, pallas_call at :417) and
// computes what FDTDRunner._update_field_family (tidy3d_tpu/solver/fdtd.py:982)
// specifies, for real runs with any number of dispersive pole slots and for
// the two real copies of a Bloch (complex) run.
// One call updates one family (E from H, or H from E^{n+1}) for all three
// components:
//
//   d1 = sgn * (F_k - F_k[shifted along j]) * inv_j     (component i,
//   d2 = sgn * (F_j - F_j[shifted along k]) * inv_k      j = i+1, k = i+2)
//   rhs = d1 - d2 (+ psi_j') (- psi_k')
//   E: rhs -= Re(Gc_p) qr_p - Im(Gc_p) qi_p for each pole p
//      (pallas_step.py:331-334), then
//      out = ca * old + cb * rhs, zeroed on the PEC lo walls
//   H: out = ca * old - cb * rhs
//
// E takes backward differences (F(-1) across the lo wall), H forward
// differences (F(N) across the hi wall): PEC gives 0, PMC a mirror, periodic
// the wrap. The 1/kappa CPML stretch is folded into inv. The CPML memories
// psi' = b * psi + c * d are updated on all three axes here: slabs span the
// corners, so a corner cell updates the psi of both of its axes. (The TPU
// kernel did the x slabs as an XLA post-pass only because x slabs do not
// block along its x grid.)
//
// Storage. The fields, the psi slabs and the pole currents are stored as
// float32 or bfloat16, each chosen at compile time (T3D_FIELD_BF16,
// T3D_PSI_BF16, T3D_Q_BF16: one library per combination): a value is
// widened to float32 where it is loaded, everything is computed in float32
// and out and psi_out are rounded once, to nearest even, where they are
// stored, as the TPU kernel loads bf16, computes in f32 and rounds at its
// store (pallas_step.py:65, :363, :411). The coefficients stay float32.
//
// Design (an x-march). A block of 256 threads owns a y/z tile of TY x TZ
// cells and one chunk of BX x planes; a thread takes two z-neighbour cells
// (a pair: one 64-bit load in float32, one 32-bit load in bfloat16). The
// three source components of each plane are staged as stored by
// asynchronous copies of pairs (NST planes deep, two in flight while one is
// read) over the tile plus the row and the pair its stencil reaches (below
// and before for E, above and after for H). E marches up in x and H down,
// so the x neighbour of the source (x - 1 for E, x + 1 for H) is the plane
// before in the march, carried in registers; the chunk's first plane reads
// it from global memory. The old values, the per-cell coefficients and the
// pole currents load as pairs straight from global memory (each is read
// once). One barrier a plane. Index math is 32-bit (fewer than 2^31 cells).
// Tiles that meet no psi slab and no wall run the bulk instantiation (a
// launch of its own over the box of such tiles) with none of those
// branches; the rest run the shell instantiation, which also takes odd z
// sizes and arrays not aligned to a pair (vec false: staged and loaded cell
// by cell).
//
// Pole slots. Up to MAX_POLES slots ride in the parameter block (gc_re,
// gc_im, q); a call with more reads them from a device table of PoleSlot
// (`poles`, built by the host wrapper; the TAB instantiations), one slot at
// a time, each holding a component's two currents only while it is used.
//
// Bloch runs step two real copies (re, im) of the fields, each with its own
// pole currents (Q and Q1). One call of t3d_family_update_bloch updates the
// family of both copies: BlochParams holds a FamilyParams per copy, the
// launch's z blocks are the x chunks of copy 0 and then those of copy 1.
// Bulk tiles meet no wall, so they run as in a real run (the table path
// for the poles). Shell tiles stage their planes value by value: a staged
// cell past a Bloch wall (logical coordinate below 0 or at n and above on
// an axis with a phase e^{i phi}) takes the other copy's value too and is
// rotated, F(-1) = e^{-i phi} F(n - 1) and F(n) = e^{i phi} F(0) (the
// port of FDTDRunner._wrap_col, tidy3d_tpu/solver/fdtd.py:861-893): copy 0
// stores c F0 - s' F1 and copy 1 c F1 + s' F0, s' = +-s by the side. The
// chunk's lead-in x plane rotates the same way. In bfloat16 storage the
// rotated value is rounded once more where it is staged.
//
// The bound is HBM bandwidth: 36 B per cell (3 source, 3 old and 3 new
// float32 values), plus the per-cell ca/cb arrays where the medium varies
// and the psi slabs; each pole adds 24 B per cell to the E family (its 3 qr
// and 3 qi values). bfloat16 storage halves the bytes of the values stored
// in it.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_POLES = 8;  // MAX_POLES in solver/kernels/step.py

constexpr int TZ = 32;              // owned z columns of a tile
constexpr int TY = 16;              // owned y rows of a tile
constexpr int BX = 16;              // x planes of a chunk
constexpr int PZ = TZ / 2;          // owned pairs of a row
constexpr int ZS = TZ + 2;          // staged columns: the tile and one pair
constexpr int PS = ZS / 2;          // staged pairs of a row
constexpr int YS = TY + 1;          // staged rows: the tile and one row
constexpr int SPLANE = YS * ZS;     // values of a staged field plane
constexpr int NST = 3;              // staged planes (two in flight)
constexpr int THREADS = TY * PZ;    // one own pair a thread
constexpr int STAGED = YS * PS;     // staged pairs of a field plane
constexpr int STAGE_ITEMS = (STAGED + THREADS - 1) / THREADS;

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
    return NST * 3 * SPLANE * (int)sizeof(field_t);
}

// Loads (widened to float32) and stores (rounded to nearest even) of one
// value or of a pair of z neighbours (p at the pair's first cell).
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

// One pole slot of a call that reads its slots from a device table.
// Mirrored by PoleSlot in tidy3d_tpu_torch/solver/kernels/step.py.
struct PoleSlot {
    const q_t* q[6];          // [comp * 2 + (0 qr, 1 qi)]
    float gc_re, gc_im;       // Gc = a (A + 1)
};

// Mirrored by FamilyParams in tidy3d_tpu_torch/solver/kernels/step.py.
struct FamilyParams {
    const field_t* src[3];    // source components (H for E, E^{n+1} for H)
    const field_t* old[3];    // the family's current components
    field_t* out[3];          // the family's new components
    const float* ca[3];       // per-cell coefficient, or null for ca_s
    const float* cb[3];       // per-cell coefficient, or null for cb_s
    const float* inv[3];      // inverse steps per axis (kappa folded in)
    const psi_t* psi_in[12];  // [(2 * comp + slot) * 2 + side]: slot 0 is
    psi_t* psi_out[12];       // axis j = comp+1, slot 1 axis k = comp+2
    const float* pml_b[6];    // [2 * axis + side], width w[2 * axis + side]
    const float* pml_c[6];
    float ca_s[3];
    float cb_s[3];
    int32_t n[3];             // interior shape (x, y, z), z contiguous;
                              // fewer than 2^31 cells
    int32_t w[6];             // psi slab widths [2 * axis + side]
    int32_t bkind[3];         // wall the stencil crosses: 0 PEC, 1 PMC, 2 wrap
    int32_t pec_lo[3];        // E family: the lo wall of the axis is PEC
    int32_t bulk_lo[3];       // set by t3d_family_update: [bulk_lo,
    int32_t bulk_hi[3];       // bulk_hi) meets no psi slab and no wall
    int32_t is_e;
    int32_t num_poles;        // E family: pole slots in use (<= MAX_POLES)
    int32_t vec;              // set by t3d_family_update: pairs aligned
    float gc_re[MAX_POLES];   // Re and Im of Gc = a (A + 1) per pole
    float gc_im[MAX_POLES];
    const q_t* q[6 * MAX_POLES];  // [(pole * 3 + comp) * 2 + (0 qr, 1 qi)]
    const PoleSlot* poles;    // the table of num_poles slots (TAB), or null
};

// Both copies of a Bloch run. Mirrored by BlochParams in step.py.
struct BlochParams {
    FamilyParams c[2];        // copy 0 (re) and copy 1 (im)
    float bc[3];              // cos and sin of the phase of each axis
    float bs[3];
    int32_t bloch[3];         // the axis wraps with a phase
    int32_t nchunk;           // set by t3d_family_update_bloch: x chunks of
                              // a copy in the launch
};
static_assert(sizeof(BlochParams) <= 4096,
              "kernel parameters must fit the 4 KB launch limit");

enum { WALL_PEC = 0, WALL_PMC = 1, WALL_WRAP = 2 };

__host__ __device__ __forceinline__ int wrap(int v, int n) {
    return (v % n + n) % n;
}

// Whether the tile (chunk x0.., rows y0.., columns z0..) runs on the
// bulk path: the whole tile lies in the bulk box (which keeps the staged
// neighbours inside the domain).
__device__ __forceinline__ bool tile_bulk(const FamilyParams& p, int x0,
                                          int y0, int z0) {
    return x0 >= p.bulk_lo[0] && x0 + BX <= p.bulk_hi[0] &&
           y0 >= p.bulk_lo[1] && y0 + TY <= p.bulk_hi[1] &&
           z0 >= max(p.bulk_lo[2], 2) && z0 + TZ <= p.bulk_hi[2];
}

// psi' = b * psi + c * d of the slab on axis A that holds the cell at
// wrapped coordinates c, if one does (written when store); idx0: the
// (comp, slot) entry of the psi arrays, (2 * comp + slot) * 2, to which the
// side adds. Returns whether a slab holds the cell, with psi' in *out.
template <int A>
__device__ __forceinline__ bool psi_at(const FamilyParams& p, int idx0,
                                       const int* c, float d, bool store,
                                       float* out) {
    const int wl = p.w[2 * A], wh = p.w[2 * A + 1];
    int side, loc;
    if (c[A] < wl) {
        side = 0;
        loc = c[A];
    } else if (c[A] >= p.n[A] - wh) {
        side = 1;
        loc = c[A] - (p.n[A] - wh);
    } else {
        return false;
    }
    // the slab spans every cell of the other two axes
    const int wd = side ? wh : wl;
    const int off = A == 0 ? (loc * p.n[1] + c[1]) * p.n[2] + c[2]
                  : A == 1 ? (c[0] * wd + loc) * p.n[2] + c[2]
                           : (c[0] * p.n[1] + c[1]) * wd + loc;
    const float v = __ldg(p.pml_b[2 * A + side] + loc) *
                        ld1(p.psi_in[idx0 + side] + off) +
                    __ldg(p.pml_c[2 * A + side] + loc) * d;
    if (store) st1(p.psi_out[idx0 + side] + off, v);
    *out = v;
    return true;
}

// The own pair of a thread: logical row y and column z of its first cell
// (cells at n and above are the wrapped images of those at 0 and above),
// wrapped offsets inside a plane, whether each cell lies in the domain, and
// the inverse steps along y and z.
struct PairAt {
    int y, z;
    int yw, zw0, zw1;
    int off0, off1;
    bool own0, own1;
    float inv_y;
    float2 inv_z;
};

template <bool VEC, typename T>
__device__ __forceinline__ float2 val2(const T* a, int base,
                                       const PairAt& c) {
    if (VEC) return ld2(a + base + c.off0);
    return make_float2(ld1(a + base + c.off0), ld1(a + base + c.off1));
}

__device__ __forceinline__ float wall(int kind, float self) {
    return kind == WALL_PEC ? 0.0f : self;
}

// Component I of the family at the own pair of plane x (wrapped xw, base
// = xw * ny * nz) from its curl terms d1 (along j) and d2 (along k).
template <int I, bool IS_E, bool BULK, bool VEC, bool TAB>
__device__ __forceinline__ void comp_update(const FamilyParams& p,
                                            const PairAt& c, int xw, int base,
                                            float2 d1, float2 d2,
                                            unsigned psi_axes) {
    constexpr int i = I, j = (I + 1) % 3, k = (I + 2) % 3;
    float2 rhs = d1 - d2;
    if (!BULK && (psi_axes & (1u << j | 1u << k))) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int cw[3] = {xw, c.yw, q ? c.zw1 : c.zw0};
            const bool st = q ? c.own1 : c.own0;
            float psi;
            float r = cell(rhs, q);
            if ((psi_axes >> j & 1) &&
                psi_at<j>(p, 4 * i, cw, cell(d1, q), st, &psi))
                r = r + psi;
            if ((psi_axes >> k & 1) &&
                psi_at<k>(p, 4 * i + 2, cw, cell(d2, q), st, &psi))
                r = r - psi;
            set_cell(rhs, q, r);
        }
    }
    if constexpr (IS_E && TAB) {
        for (int q = 0; q < p.num_poles; ++q) {
            const PoleSlot& slot = p.poles[q];
            const float2 qr = val2<VEC>(slot.q[2 * i], base, c);
            const float2 qi = val2<VEC>(slot.q[2 * i + 1], base, c);
            rhs = rhs - (slot.gc_re * qr - slot.gc_im * qi);
        }
    } else if constexpr (IS_E) {
        for (int q = 0; q < p.num_poles; ++q) {
            const float2 qr = val2<VEC>(p.q[(q * 3 + i) * 2], base, c);
            const float2 qi = val2<VEC>(p.q[(q * 3 + i) * 2 + 1], base, c);
            rhs = rhs - (p.gc_re[q] * qr - p.gc_im[q] * qi);
        }
    }
    const float2 ca = p.ca[i] ? val2<VEC>(p.ca[i], base, c) : f2(p.ca_s[i]);
    const float2 cb = p.cb[i] ? val2<VEC>(p.cb[i], base, c) : f2(p.cb_s[i]);
    const float2 old = val2<VEC>(p.old[i], base, c);
    float2 out = IS_E ? ca * old + cb * rhs : ca * old - cb * rhs;
    if (IS_E && !BULK) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int cw[3] = {xw, c.yw, q ? c.zw1 : c.zw0};
            if ((p.pec_lo[j] && cw[j] == 0) || (p.pec_lo[k] && cw[k] == 0))
                set_cell(out, q, 0.0f);
        }
    }
    field_t* const dst = p.out[i] + base;
    if (VEC) {
        if (c.own0) st2(dst + c.off0, out);
    } else {
        if (c.own0) st1(dst + c.off0, out.x);
        if (c.own1) st1(dst + c.off1, out.y);
    }
}

// The family's three components of the own pair at plane x (wrapped xw)
// from the staged source plane f (at the pair) and the source's x
// neighbour (cx: components 1 and 2 of plane x - 1 for E, x + 1 for H).
template <bool IS_E, bool BULK, bool VEC, bool TAB>
__device__ __forceinline__ void update_pair(const FamilyParams& p,
                                            const PairAt& c,
                                            const field_t* f, int x, int xw,
                                            const float2 (&cx)[2],
                                            unsigned psi_axes,
                                            float2 (&fo)[3]) {
    const int base = xw * p.n[1] * p.n[2];
    const float inv_x = __ldg(p.inv[0] + xw);
#pragma unroll
    for (int m = 0; m < 3; ++m) fo[m] = sh2(f + m * SPLANE);
    // the neighbours of the source components along y and z (at -1 for
    // E, +1 for H) and x
    float2 n2_y, n0_y, n1_z, n0_z;
    float2 n1_x = cx[0], n2_x = cx[1];
    if (IS_E) {
        n2_y = sh2(f + 2 * SPLANE - ZS);
        n0_y = sh2(f - ZS);
        n1_z = make_float2(sh_before(f + SPLANE), fo[1].x);
        n0_z = make_float2(sh_before(f), fo[0].x);
    } else {
        n2_y = sh2(f + 2 * SPLANE + ZS);
        n0_y = sh2(f + ZS);
        n1_z = make_float2(fo[1].y, sh_after(f + SPLANE));
        n0_z = make_float2(fo[0].y, sh_after(f));
    }
    if (!BULK) {
        // the wall the stencil crosses: at 0 for E, at n - 1 for H
        const int edge_y = IS_E ? 0 : p.n[1] - 1;
        if (c.y == edge_y && p.bkind[1] != WALL_WRAP) {
            n2_y = make_float2(wall(p.bkind[1], fo[2].x),
                               wall(p.bkind[1], fo[2].y));
            n0_y = make_float2(wall(p.bkind[1], fo[0].x),
                               wall(p.bkind[1], fo[0].y));
        }
        if (p.bkind[2] != WALL_WRAP) {
            if (IS_E ? c.z == 0 : c.z == p.n[2] - 1) {
                n1_z.x = wall(p.bkind[2], fo[1].x);
                n0_z.x = wall(p.bkind[2], fo[0].x);
            }
            if (!IS_E && c.z + 1 == p.n[2] - 1) {
                n1_z.y = wall(p.bkind[2], fo[1].y);
                n0_z.y = wall(p.bkind[2], fo[0].y);
            }
        }
        if (x == (IS_E ? 0 : p.n[0] - 1) && p.bkind[0] != WALL_WRAP) {
            n1_x = make_float2(wall(p.bkind[0], fo[1].x),
                               wall(p.bkind[0], fo[1].y));
            n2_x = make_float2(wall(p.bkind[0], fo[2].x),
                               wall(p.bkind[0], fo[2].y));
        }
    }
    // sgn * (F - F_shifted) * inv: F - F(-1) for E, F(+1) - F for H
    const float2 d2y = IS_E ? c.inv_y * (fo[2] - n2_y)
                            : c.inv_y * (n2_y - fo[2]);
    const float2 d0y = IS_E ? c.inv_y * (fo[0] - n0_y)
                            : c.inv_y * (n0_y - fo[0]);
    const float2 d1z = IS_E ? (fo[1] - n1_z) * c.inv_z
                            : (n1_z - fo[1]) * c.inv_z;
    const float2 d0z = IS_E ? (fo[0] - n0_z) * c.inv_z
                            : (n0_z - fo[0]) * c.inv_z;
    const float2 d1x = IS_E ? inv_x * (fo[1] - n1_x)
                            : inv_x * (n1_x - fo[1]);
    const float2 d2x = IS_E ? inv_x * (fo[2] - n2_x)
                            : inv_x * (n2_x - fo[2]);
    comp_update<0, IS_E, BULK, VEC, TAB>(p, c, xw, base, d2y, d1z,
                                         psi_axes);
    comp_update<1, IS_E, BULK, VEC, TAB>(p, c, xw, base, d0z, d2x,
                                         psi_axes);
    comp_update<2, IS_E, BULK, VEC, TAB>(p, c, xw, base, d1x, d0y,
                                         psi_axes);
}

// The phase of a staged cell at logical (x, y, z) of a Bloch run: the
// product of e^{+-i phi} over the axes it lies past (cos in *pc, sin in
// *ps); false when it lies past none.
__device__ __forceinline__ bool bloch_phase(const BlochParams& b,
                                            const int* n, int x, int y,
                                            int z, float* pc, float* ps) {
    const int cw[3] = {x, y, z};
    float c = 1.0f, s = 0.0f;
    bool any = false;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        if (!b.bloch[a] || (cw[a] >= 0 && cw[a] < n[a])) continue;
        const float sa = cw[a] < 0 ? -b.bs[a] : b.bs[a];
        const float nc = c * b.bc[a] - s * sa;
        s = c * sa + s * b.bc[a];
        c = nc;
        any = true;
    }
    *pc = c;
    *ps = s;
    return any;
}

// The value of copy `part` at a cell whose own value is v and the other
// copy's vp, turned by the phase (pc, ps): Re or Im of (pc + i ps)(F0 + i
// F1).
__device__ __forceinline__ float rotate(int part, float v, float vp,
                                        float pc, float ps) {
    return part == 0 ? pc * v - ps * vp : pc * v + ps * vp;
}

// The march of one tile (tz, ty, tx: the tile's z, y and x chunk index):
// E up in x, H down. BULK: a bulk tile; else the shell path, which returns
// at once for a bulk tile when p.vec (the bulk launch takes it). VEC: pairs
// staged and loaded whole (p.vec; the bulk path always). TAB: the pole
// slots from the table p.poles. BLOCH: copy `part` of a Bloch run, whose
// other copy is pp and whose phases are bl (shell tiles stage value by
// value, rotating the cells past a Bloch wall).
template <bool IS_E, bool BULK, bool VEC, bool TAB, bool BLOCH>
__device__ __forceinline__ void march(const FamilyParams& p,
                                      const FamilyParams& pp,
                                      const BlochParams* bl, int part,
                                      int tz, int ty, int tx) {
    extern __shared__ __align__(16) unsigned char smem[];
    field_t* const stage = reinterpret_cast<field_t*>(smem);  // [NST][3][YS][ZS]
    const int nx = p.n[0], ny = p.n[1], nz = p.n[2];
    const int z0 = tz * TZ;
    const int y0 = ty * TY;
    const int x0 = tx * BX;
    if (z0 >= nz || y0 >= ny || x0 >= nx) return;
    const int x_end = min(x0 + BX, nx);
    const bool bulk = tile_bulk(p, x0, y0, z0);
    if (BULK ? !bulk : (bulk && p.vec)) return;
    static_assert(VEC || !BULK, "the bulk path loads pairs");
    constexpr bool vec = VEC;
    const int t = threadIdx.x;
    const int nyz = ny * nz;
    // the axes on which the tile's cells meet a psi slab
    unsigned psi_axes = 0;
    if (!BULK) {
        const int lo[3] = {x0, y0, z0};
        const int hi[3] = {x_end - 1, y0 + TY - 1, z0 + TZ - 1};
#pragma unroll
        for (int a = 0; a < 3; ++a)
            if (lo[a] < p.w[2 * a] || hi[a] >= p.n[a] - p.w[2 * a + 1])
                psi_axes |= 1u << a;
    }

    // the staged region: rows from ry0, columns from cz0
    const int ry0 = IS_E ? y0 - 1 : y0;
    const int cz0 = IS_E ? z0 - 2 : z0;
    // a Bloch shell tile stages value by value, rotating past the walls
    constexpr bool ROT = BLOCH && !BULK;
    int soff[STAGE_ITEMS], ga[STAGE_ITEMS], gb[STAGE_ITEMS];
#pragma unroll
    for (int it = 0; it < STAGE_ITEMS; ++it) {
        const int s = t + it * THREADS;
        const int jj = s / PS, qq = s - jj * PS;
        const int y = BULK ? ry0 + jj : wrap(ry0 + jj, ny);
        soff[it] = s < STAGED ? jj * ZS + 2 * qq : -1;
        ga[it] = y * nz + (BULK ? cz0 + 2 * qq : wrap(cz0 + 2 * qq, nz));
        gb[it] = y * nz + (BULK ? cz0 + 1 + 2 * qq
                                : wrap(cz0 + 1 + 2 * qq, nz));
    }
    const int oj = t / PZ, op = t % PZ;
    const int so = IS_E ? (oj + 1) * ZS + 2 * (op + 1) : oj * ZS + 2 * op;
    PairAt c;
    c.y = y0 + oj;
    c.z = z0 + 2 * op;
    c.yw = wrap(c.y, ny);
    c.zw0 = wrap(c.z, nz);
    c.zw1 = wrap(c.z + 1, nz);
    c.off0 = c.yw * nz + c.zw0;
    c.off1 = c.yw * nz + c.zw1;
    c.own0 = c.y < ny && c.z < nz;
    c.own1 = c.y < ny && c.z + 1 < nz;
    c.inv_y = __ldg(p.inv[1] + c.yw);
    c.inv_z = make_float2(__ldg(p.inv[2] + c.zw0), __ldg(p.inv[2] + c.zw1));

    // march position pos is plane x0 + pos (E) or x_end - 1 - pos (H)
    const int nown = x_end - x0;
    auto plane = [&](int pos) { return IS_E ? x0 + pos : x_end - 1 - pos; };
    auto stage_plane = [&](int pos) {
        if (pos < nown) {
            const int base = plane(pos) * nyz;
            field_t* const dst0 = stage + (pos % NST) * 3 * SPLANE;
#pragma unroll
            for (int m = 0; m < 3; ++m) {
                const field_t* src = p.src[m] + base;
                field_t* dst = dst0 + m * SPLANE;
#pragma unroll
                for (int it = 0; it < STAGE_ITEMS; ++it) {
                    if (soff[it] < 0) continue;
                    if constexpr (ROT) {
                        const int s = t + it * THREADS;
                        const int jj = s / PS, qq = s - jj * PS;
                        const int g2[2] = {ga[it], gb[it]};
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            float v = ld1(src + g2[h]), pc, ps;
                            if (bloch_phase(*bl, p.n, plane(pos), ry0 + jj,
                                            cz0 + 2 * qq + h, &pc, &ps))
                                v = rotate(part, v,
                                           ld1(pp.src[m] + base + g2[h]),
                                           pc, ps);
                            st1(dst + soff[it] + h, v);
                        }
                    } else if (vec) {
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

    // components 1 and 2 of the source at the chunk's lead-in plane
    float2 cx[2];
    {
        const int xl = IS_E ? x0 - 1 : x_end;
        const int base = (BULK ? xl : wrap(xl, nx)) * nyz;
        cx[0] = vec ? val2<true>(p.src[1], base, c)
                    : val2<false>(p.src[1], base, c);
        cx[1] = vec ? val2<true>(p.src[2], base, c)
                    : val2<false>(p.src[2], base, c);
        if constexpr (ROT) {
            float pc, ps;
            if (bloch_phase(*bl, p.n, xl, 0, 0, &pc, &ps)) {
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    const float2 o = val2<false>(pp.src[1 + m], base, c);
                    cx[m] = make_float2(rotate(part, cx[m].x, o.x, pc, ps),
                                        rotate(part, cx[m].y, o.y, pc, ps));
                }
            }
        }
    }
    stage_plane(0);
    stage_plane(1);
#pragma unroll 1
    for (int pos = 0; pos < nown; ++pos) {
        __pipeline_wait_prior(NST - 2);
        __syncthreads();
        stage_plane(pos + 2);
        const int x = plane(pos);
        const field_t* const f = stage + (pos % NST) * 3 * SPLANE + so;
        float2 fo[3];
        if (vec)
            update_pair<IS_E, BULK, true, TAB>(p, c, f, x, x, cx, psi_axes,
                                               fo);
        else
            update_pair<IS_E, BULK, false, TAB>(p, c, f, x, x, cx, psi_axes,
                                                fo);
        cx[0] = fo[1];
        cx[1] = fo[2];
    }
}

// A real run's tile (blockIdx + base: its z, y and x chunk index). TAB: the
// pole slots from the table (more than MAX_POLES).
template <bool IS_E, bool BULK, bool VEC, bool TAB>
__global__ void __launch_bounds__(THREADS)
family_update_kernel(const __grid_constant__ FamilyParams p, int base_z,
                     int base_y, int base_x) {
    march<IS_E, BULK, VEC, TAB, false>(p, p, nullptr, 0, blockIdx.x + base_z,
                                       blockIdx.y + base_y,
                                       blockIdx.z + base_x);
}

// A Bloch run's tile: z blocks [0, nchunk) are copy 0's x chunks, the rest
// copy 1's.
template <bool IS_E, bool BULK, bool VEC>
__global__ void __launch_bounds__(THREADS)
family_update_bloch_kernel(const __grid_constant__ BlochParams b, int base_z,
                           int base_y, int base_x) {
    const int part = blockIdx.z >= (unsigned)b.nchunk;
    const int chunk = blockIdx.z - part * b.nchunk;
    march<IS_E, BULK, VEC, true, true>(b.c[part], b.c[1 - part], &b, part,
                                       blockIdx.x + base_z,
                                       blockIdx.y + base_y, chunk + base_x);
}

typedef void (*KernelFn)(FamilyParams, int, int, int);
typedef void (*BlochFn)(BlochParams, int, int, int);

template <bool TAB>
static KernelFn kernel_tab(bool is_e, bool bulk, bool vec) {
    if (is_e)
        return bulk ? family_update_kernel<true, true, true, TAB>
               : vec ? family_update_kernel<true, false, true, TAB>
                     : family_update_kernel<true, false, false, TAB>;
    return bulk ? family_update_kernel<false, true, true, false>
           : vec ? family_update_kernel<false, false, true, false>
                 : family_update_kernel<false, false, false, false>;
}

static KernelFn kernel_for(bool is_e, bool bulk, bool vec = true,
                           bool tab = false) {
    return tab ? kernel_tab<true>(is_e, bulk, vec)
               : kernel_tab<false>(is_e, bulk, vec);
}

static BlochFn bloch_for(bool is_e, bool bulk, bool vec = true) {
    if (is_e)
        return bulk ? family_update_bloch_kernel<true, true, true>
               : vec ? family_update_bloch_kernel<true, false, true>
                     : family_update_bloch_kernel<true, false, false>;
    return bulk ? family_update_bloch_kernel<false, true, true>
           : vec ? family_update_bloch_kernel<false, false, true>
                 : family_update_bloch_kernel<false, false, false>;
}

static cudaError_t prepare(const void* fn) {
    return cudaFuncSetAttribute(fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes());
}

// Every array a pair load reads or a pair store writes is aligned to a
// pair, and z holds an even number of cells (the currents of a table are
// checked by the host wrapper).
static bool pair_aligned(const FamilyParams& p) {
    if (p.n[2] % 2) return false;
    const uintptr_t fa = 2 * sizeof(field_t), qa = 2 * sizeof(q_t);
    for (int i = 0; i < 3; ++i)
        if ((uintptr_t)p.src[i] % fa || (uintptr_t)p.old[i] % fa ||
            (uintptr_t)p.out[i] % fa || (uintptr_t)p.ca[i] % 8 ||
            (uintptr_t)p.cb[i] % 8)
            return false;
    if (!p.poles)
        for (int i = 0; i < 6 * p.num_poles; ++i)
            if ((uintptr_t)p.q[i] % qa) return false;
    return true;
}

// The tiles [lo, hi) of an axis whose cells (len a tile) all lie in
// [lo_cell, hi_cell).
static void bulk_range(int lo_cell, int hi_cell, int len, int tiles, int* lo,
                       int* hi) {
    *lo = (lo_cell + len - 1) / len;
    *hi = *lo;
    while (*hi < tiles && (*hi + 1) * len <= hi_cell) ++*hi;
}

extern "C" int t3d_family_params_size() { return (int)sizeof(FamilyParams); }
extern "C" int t3d_family_bloch_params_size() {
    return (int)sizeof(BlochParams);
}
extern "C" int t3d_family_pole_slot_size() { return (int)sizeof(PoleSlot); }

// The bytes of the field, psi and pole-current values this library stores.
extern "C" void t3d_family_storage(int32_t* out) {
    out[0] = (int32_t)sizeof(field_t);
    out[1] = (int32_t)sizeof(psi_t);
    out[2] = (int32_t)sizeof(q_t);
}

// Threads, shared bytes, blocks per SM and registers of the E (is_e) or H
// instantiation, bulk or the shell of pair-aligned arrays, of a real run
// (mode 0), a real run with the pole table (mode 1) or a Bloch run (mode
// 2); a CUDA error code, or 0.
extern "C" int t3d_family_info(int is_e, int bulk, int mode,
                               int32_t* out) {
    const void* fn = mode == 2 ? (const void*)bloch_for(is_e != 0, bulk != 0)
                               : (const void*)kernel_for(is_e != 0, bulk != 0,
                                                         true, mode == 1);
    cudaError_t err = prepare(fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = THREADS;
    out[1] = smem_bytes();
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                        smem_bytes());
    if (err != cudaSuccess) return (int)err;
    out[2] = blocks;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    out[3] = attr.numRegs;
    return (int)err;
}

// Checks the call, marks pair alignment and sets the bulk box of q; the
// grid's tiles (z, y, x chunk) in tiles and the bulk tiles' box in lo/hi.
static cudaError_t plan_call(FamilyParams& q, int* tiles, int* lo, int* hi) {
    if (q.num_poles < 0 || (!q.poles && q.num_poles > MAX_POLES) ||
        (int64_t)q.n[0] * q.n[1] * q.n[2] > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    q.vec = pair_aligned(q) ? 1 : 0;
    const bool is_e = q.is_e != 0;
    for (int a = 0; a < 3; ++a) {
        // E: c - 1 in the domain (c >= 1); H: c + 1 (c <= n - 2)
        q.bulk_lo[a] = is_e ? max(1, q.w[2 * a]) : q.w[2 * a];
        q.bulk_hi[a] = is_e ? q.n[a] - q.w[2 * a + 1]
                            : min(q.n[a] - 1, q.n[a] - q.w[2 * a + 1]);
    }
    tiles[0] = (q.n[2] + TZ - 1) / TZ;
    tiles[1] = (q.n[1] + TY - 1) / TY;
    tiles[2] = (q.n[0] + BX - 1) / BX;
    if (tiles[1] > 65535 || 2 * tiles[2] > 65535)
        return cudaErrorInvalidConfiguration;
    for (int a = 0; a < 3; ++a) lo[a] = hi[a] = 0;
    if (q.vec) {
        bulk_range(max(q.bulk_lo[2], 2), q.bulk_hi[2], TZ, tiles[0], &lo[0],
                   &hi[0]);
        bulk_range(q.bulk_lo[1], q.bulk_hi[1], TY, tiles[1], &lo[1], &hi[1]);
        bulk_range(q.bulk_lo[0], q.bulk_hi[0], BX, tiles[2], &lo[2], &hi[2]);
    }
    return cudaSuccess;
}

// The bulk launch over the box of bulk tiles (when the arrays are
// pair-aligned), then the shell launch over every tile; `copies` z blocks
// per x chunk (2: both copies of a Bloch run). counts (may be null): the
// two launches' blocks and the launches made.
template <typename Fn, typename Params>
static int launch_pair(Fn bulk, Fn shell, Params& q, const int* tiles,
                       const int* lo, const int* hi, int copies,
                       int* nchunk, void* stream, int32_t* counts) {
    cudaError_t err = prepare((const void*)shell);
    if (err == cudaSuccess) err = prepare((const void*)bulk);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_bytes();
    cfg.stream = (cudaStream_t)stream;
    const int64_t nbulk = (int64_t)(hi[0] - lo[0]) * (hi[1] - lo[1]) *
                          (hi[2] - lo[2]);
    if (nbulk > 0) {
        if (nchunk) *nchunk = hi[2] - lo[2];
        cfg.gridDim = dim3(hi[0] - lo[0], hi[1] - lo[1],
                           copies * (hi[2] - lo[2]));
        err = cudaLaunchKernelEx(&cfg, bulk, q, lo[0], lo[1], lo[2]);
        if (err == cudaSuccess) err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (nchunk) *nchunk = tiles[2];
    cfg.gridDim = dim3(tiles[0], tiles[1], copies * tiles[2]);
    err = cudaLaunchKernelEx(&cfg, shell, q, 0, 0, 0);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (counts) {
        counts[0] = (int32_t)(copies * nbulk);
        counts[1] = copies * tiles[0] * tiles[1] * tiles[2];
        counts[2] = nbulk > 0 ? 2 : 1;
    }
    return (int)err;
}

// One family of a real run: with p->poles, the pole slots from that table
// (any number), else up to MAX_POLES from the parameter block.
extern "C" int t3d_family_update(const FamilyParams* p, void* stream,
                                 int32_t* counts) {
    if (p->n[0] <= 0 || p->n[1] <= 0 || p->n[2] <= 0) return 0;
    FamilyParams q = *p;
    int tiles[3], lo[3], hi[3];
    cudaError_t err = plan_call(q, tiles, lo, hi);
    if (err != cudaSuccess) return (int)err;
    const bool is_e = q.is_e != 0, tab = q.poles != nullptr;
    return launch_pair(kernel_for(is_e, true, true, tab),
                       kernel_for(is_e, false, q.vec != 0, tab), q, tiles,
                       lo, hi, 1, nullptr, stream, counts);
}

// One family of both copies of a Bloch run (each copy's poles from its
// table); the copies share the layout.
extern "C" int t3d_family_update_bloch(const BlochParams* b, void* stream,
                                       int32_t* counts) {
    if (b->c[0].n[0] <= 0 || b->c[0].n[1] <= 0 || b->c[0].n[2] <= 0)
        return 0;
    BlochParams q = *b;
    int tiles[3], lo[3], hi[3], tiles1[3], lo1[3], hi1[3];
    cudaError_t err = plan_call(q.c[0], tiles, lo, hi);
    if (err == cudaSuccess) err = plan_call(q.c[1], tiles1, lo1, hi1);
    if (err != cudaSuccess) return (int)err;
    for (int a = 0; a < 3; ++a)
        if (q.c[1].n[a] != q.c[0].n[a] || q.c[1].w[2 * a] != q.c[0].w[2 * a] ||
            q.c[1].w[2 * a + 1] != q.c[0].w[2 * a + 1])
            return (int)cudaErrorInvalidValue;
    if (q.c[0].vec != q.c[1].vec || (q.c[0].num_poles && !q.c[0].poles) ||
        (q.c[1].num_poles && !q.c[1].poles))
        return (int)cudaErrorInvalidValue;
    const bool is_e = q.c[0].is_e != 0;
    return launch_pair(bloch_for(is_e, true), bloch_for(is_e, false,
                                                        q.c[0].vec != 0),
                       q, tiles, lo, hi, 2, &q.nchunk, stream, counts);
}
