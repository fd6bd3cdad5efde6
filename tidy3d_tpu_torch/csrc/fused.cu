// One whole leapfrog step of the FDTD update in one launch, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels PallasFusedStepper.step_update
// (tidy3d_tpu/solver/kernels/pallas_fused.py:109, pallas_call at :557) and
// PallasFusedStepper.x_fixup (:579, pallas_call at :897), together with the
// XLA corrections of FDTDRunner._step_fused (tidy3d_tpu/solver/fdtd.py:1505).
// It computes what the XLA step FDTDRunner._step (fdtd.py:1614) computes up to
// the H half-step, for real runs with up to MAX_POLES poles:
//
//   E' = ca_E * E + cb_E * (curl H + psi_E' - sum_p Re(Gc_p Q_p)),
//        zeroed on the PEC lo walls, plus the J source terms of this step
//   H' = ca_H * H - cb_H * (curl E' + psi_H')
//
// with the CPML memories psi' = b * psi + c * d of all three axes of both
// families (the x axis included: on the TPU that was x_fixup's job). The
// outputs go to new buffers: the pole update that follows reads E' and the
// old E.
//
// Design. A block of TZ x TY threads (z fastest, one warp per row) computes
// E' on a TY x TZ tile of one x plane into shared memory, and marches over BX
// consecutive x planes. H' of plane x needs E' at +1 in x, y and z: the
// next plane's tile gives x + 1, and the tiles of neighbouring blocks
// overlap by one row and one column, so that the last row and column of a
// tile give y + 1 and z + 1. A block therefore owns (writes E', psi_E', H',
// psi_H' of) the first TY - 1 rows and TZ - 1 columns of its tile, and only
// computes the last row and column: every thread does the same E work, and
// no psi value has two writers. A halo cell's E' is computed in full (its
// psi_E recursion, pole term, walls and sources). The first plane of each
// block's x range is computed twice (as the last block's +1 plane too), so
// E costs TY * TZ * (BX + 1) / ((TY - 1) * (TZ - 1) * BX) of one pass.
// Three shared buffers rotate, so one barrier per plane separates a plane's
// E' from the H' that reads it.
//
// Tiles that lie in the bulk (no psi slab, no wall, no source box) take a
// path without those branches; most of a large grid does.
//
// Storage. The fields, the psi slabs and the pole currents are stored as
// float32 or bfloat16, each chosen at compile time (T3D_FIELD_BF16,
// T3D_PSI_BF16, T3D_Q_BF16: one library per combination). A value is
// widened to float32 where it is loaded and everything is computed in
// float32; E', H' and psi' are rounded once, to nearest even, where they are
// stored, as step_update loads bf16, computes in f32 and rounds at its
// stores (pallas_fused.py:381, :487, :551). The shared tile keeps E' in
// float32, so H' reads the E' that was computed, not the stored one, as
// step_update's H half-step does. The J terms are added to E' before its
// store: the TPU tier adds them after the kernel, rounded to bf16, and
// carries them into H' with one more rounding (fdtd.py:1505-1524).
//
// The floor is HBM bandwidth: 24 B read (E, H) and 24 B written (E', H') per
// cell, plus 24 B per pole (Q), plus the per-cell ca/cb arrays where the
// medium varies and the psi slabs. The neighbour reads of the E stencil (x-1
// plane, y-1 row) hit L1/L2: the x-1 plane is the one this block just read.
// On the H100 the kernel reaches 1.2-1.6 TB/s of that traffic and is bound
// by instructions and occupancy (40 registers, 6 blocks per SM), not by
// HBM: the variants that lowered either were the ones that ran faster
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_POLES = 8;     // MAX_POLES in solver/kernels/step.py
constexpr int MAX_SOURCES = 32;  // MAX_SOURCES in solver/kernels/fused.py

constexpr int TZ = 32;           // tile width in z: one warp per row
constexpr int TY = 8;            // tile rows in y: 8 warps per block
constexpr int BX = 8;            // x planes per block
constexpr int OZ = TZ - 1;       // owned columns and rows of a tile
constexpr int OY = TY - 1;

enum { WALL_PEC = 0, WALL_PMC = 1, WALL_WRAP = 2 };

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

// A stored value, widened to float32 (exact) through the read-only path.
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __uint_as_float(
        (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// A float32 value stored, rounded to nearest even in bfloat16.
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
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
    SrcBox src[MAX_SOURCES];
    float ca_s_e[3];
    float cb_s_e[3];
    float ca_s_h[3];
    float cb_s_h[3];
    float gc_re[MAX_POLES];
    float gc_im[MAX_POLES];
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
};

static_assert(sizeof(FusedParams) <= 4096,
              "kernel parameters must fit the 4 KB launch limit");

typedef float Plane[3][TY][TZ];

// psi' = b * psi + c * d for the slab of (comp, slot) on axis a that holds
// cell c, if one does; written back only by the cell's owner.
__device__ __forceinline__ bool psi_step(
    const psi_t* const* psi_in, psi_t* const* psi_out,
    const float* const* pml_b, const float* const* pml_c, const int32_t* w,
    const int32_t* n, int comp, int slot, int a, const int* c, float d,
    bool owner, float* psi) {
    for (int side = 0; side < 2; ++side) {
        const int wd = w[2 * a + side];
        if (wd == 0) continue;
        const int loc = side == 0 ? c[a] : c[a] - (n[a] - wd);
        if (loc < 0 || loc >= wd) continue;
        const int idx = (2 * comp + slot) * 2 + side;
        int dim[3] = {n[0], n[1], n[2]};
        int l[3] = {c[0], c[1], c[2]};
        dim[a] = wd;
        l[a] = loc;
        const int off = (l[0] * dim[1] + l[1]) * dim[2] + l[2];
        const float v = __ldg(pml_b[2 * a + side] + loc) *
                            ld(psi_in[idx] + off) +
                        __ldg(pml_c[2 * a + side] + loc) * d;
        if (owner) st(psi_out[idx] + off, v);
        *psi = v;
        return true;
    }
    return false;
}

// (F - F[c - e_a]) * inv_e[a] with the lo wall of axis a (never reached in
// the bulk).
template <bool BULK>
__device__ __forceinline__ float diff_back(const FusedParams& p,
                                           const field_t* __restrict__ F,
                                           int cell, const int* c,
                                           const int* stride, int a) {
    const float f = ld(F + cell);
    float prev;
    if (BULK || c[a] > 0) {
        prev = ld(F + cell - stride[a]);
    } else if (p.bk_lo[a] == WALL_PEC) {
        prev = 0.0f;
    } else if (p.bk_lo[a] == WALL_PMC) {
        prev = f;
    } else {
        prev = ld(F + cell + (p.n[a] - 1) * stride[a]);
    }
    return (f - prev) * __ldg(p.inv_e[a] + c[a]);
}

// E'_i at in-domain cell c, as the XLA E half-step and J injection give it.
// BULK: c lies in the bulk and no source box holds it, so the psi, wall and
// source terms are known to vanish there.
template <bool BULK>
__device__ __forceinline__ float e_value(const FusedParams& p, int i,
                                         const int* c, const int* stride,
                                         bool owner) {
    const int j = (i + 1) % 3;
    const int k = (i + 2) % 3;
    const int cell = c[0] * stride[0] + c[1] * stride[1] + c[2];
    const float d1 = diff_back<BULK>(p, p.h_old[k], cell, c, stride, j);
    const float d2 = diff_back<BULK>(p, p.h_old[j], cell, c, stride, k);
    float rhs = d1 - d2;
    float psi;
    if (!BULK && psi_step(p.psi_in_e, p.psi_out_e, p.pml_b_e, p.pml_c_e,
                          p.w_e, p.n, i, 0, j, c, d1, owner, &psi))
        rhs = rhs + psi;
    if (!BULK && psi_step(p.psi_in_e, p.psi_out_e, p.pml_b_e, p.pml_c_e,
                          p.w_e, p.n, i, 1, k, c, d2, owner, &psi))
        rhs = rhs - psi;
    for (int q = 0; q < p.num_poles; ++q) {
        const float qr = ld(p.q[(q * 3 + i) * 2] + cell);
        const float qi = ld(p.q[(q * 3 + i) * 2 + 1] + cell);
        rhs = rhs - (p.gc_re[q] * qr - p.gc_im[q] * qi);
    }
    const float ca = p.ca_e[i] ? __ldg(p.ca_e[i] + cell) : p.ca_s_e[i];
    const float cb = p.cb_e[i] ? __ldg(p.cb_e[i] + cell) : p.cb_s_e[i];
    float out = ca * ld(p.e_old[i] + cell) + cb * rhs;
    if (BULK) return out;
    if ((p.pec_lo[j] && c[j] == 0) || (p.pec_lo[k] && c[k] == 0)) out = 0.0f;
    for (int s = 0; s < p.num_src; ++s) {
        const SrcBox& b = p.src[s];
        if (b.comp != i || c[0] < b.lo[0] || c[0] >= b.hi[0] ||
            c[1] < b.lo[1] || c[1] >= b.hi[1] || c[2] < b.lo[2] ||
            c[2] >= b.hi[2])
            continue;
        const int off = ((c[0] - b.lo[0]) * (b.hi[1] - b.lo[1]) +
                         (c[1] - b.lo[1])) * (b.hi[2] - b.lo[2]) +
                        (c[2] - b.lo[2]);
        out = out + __ldg(b.term + off) * b.w;
    }
    return out;
}

// Whether [lo, lo + len) lies in the bulk of axis a.
__device__ __forceinline__ bool in_bulk(const FusedParams& p, int a, int lo,
                                        int len) {
    return lo >= p.bulk_lo[a] && lo + len <= p.bulk_hi[a];
}

// This thread's slot of plane x of the shared tile: E' of its cell, written
// out with its psi_E' where the block owns the cell. A slot past the hi wall
// of a periodic axis holds E' at cell 0 of that axis; any other slot
// outside the domain holds 0.
template <bool BULK>
__device__ __forceinline__ void fill_slot(const FusedParams& p, Plane& s,
                                          int x, int y0, int z0,
                                          bool own_plane, const int* stride) {
    const int tz = threadIdx.x;
    const int ty = threadIdx.y;
    int c[3] = {x, y0 + ty, z0 + tz};
    bool owner = own_plane && ty < OY && tz < OZ;
    bool valid = true;
#pragma unroll
    for (int a = 1; a < 3; ++a) {
        if (BULK || c[a] < p.n[a]) continue;
        if (c[a] == p.n[a] && p.bk_hi[a] == WALL_WRAP) {
            c[a] = 0;
            owner = false;
        } else {
            valid = false;
        }
    }
    const int cell = c[0] * stride[0] + c[1] * stride[1] + c[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        float v = 0.0f;
        if (valid) {
            v = e_value<BULK>(p, i, c, stride, owner);
            if (owner) st(p.e_new[i] + cell, v);
        }
        s[i][ty][tz] = v;
    }
}

// Plane x of the tile on the bulk path when it lies in the bulk and
// src_free says no source box reaches the block.
__device__ __forceinline__ void fill_plane(const FusedParams& p, Plane& s,
                                           int x, int y0, int z0,
                                           bool own_plane, bool src_free,
                                           const int* stride) {
    if (src_free && in_bulk(p, 0, x, 1) && in_bulk(p, 1, y0, TY) &&
        in_bulk(p, 2, z0, TZ))
        fill_slot<true>(p, s, x, y0, z0, own_plane, stride);
    else
        fill_slot<false>(p, s, x, y0, z0, own_plane, stride);
}

// The E' neighbour at c + e_a for the forward difference of the H stencil.
template <bool BULK>
__device__ __forceinline__ float e_next(const FusedParams& p, const Plane& cur,
                                        const Plane& nxt, int comp, int a,
                                        const int* c, int ty, int tz) {
    if (!BULK && c[a] + 1 >= p.n[a] && p.bk_hi[a] != WALL_WRAP)
        return p.bk_hi[a] == WALL_PEC ? 0.0f : cur[comp][ty][tz];
    if (a == 0) return nxt[comp][ty][tz];
    if (a == 1) return cur[comp][ty + 1][tz];
    return cur[comp][ty][tz + 1];
}

// H'_i of this thread's cell of plane x from the shared E' of plane x
// (cur) and x + 1 (nxt). BULK: the owned tile lies in the bulk, so no psi
// slab and no wall reaches it.
template <bool BULK>
__device__ __forceinline__ void h_update(const FusedParams& p,
                                         const Plane& cur, const Plane& nxt,
                                         int x, int y0, int z0,
                                         const int* stride) {
    const int tz = threadIdx.x;
    const int ty = threadIdx.y;
    const int c[3] = {x, y0 + ty, z0 + tz};
    const int cell = x * stride[0] + c[1] * stride[1] + c[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int j = (i + 1) % 3;
        const int k = (i + 2) % 3;
        // H_i from E': forward differences of E'_k along j and of E'_j
        // along k
        const float d1 = (e_next<BULK>(p, cur, nxt, k, j, c, ty, tz) -
                          cur[k][ty][tz]) * __ldg(p.inv_h[j] + c[j]);
        const float d2 = (e_next<BULK>(p, cur, nxt, j, k, c, ty, tz) -
                          cur[j][ty][tz]) * __ldg(p.inv_h[k] + c[k]);
        float rhs = d1 - d2;
        float psi;
        if (!BULK && psi_step(p.psi_in_h, p.psi_out_h, p.pml_b_h, p.pml_c_h,
                              p.w_h, p.n, i, 0, j, c, d1, true, &psi))
            rhs = rhs + psi;
        if (!BULK && psi_step(p.psi_in_h, p.psi_out_h, p.pml_b_h, p.pml_c_h,
                              p.w_h, p.n, i, 1, k, c, d2, true, &psi))
            rhs = rhs - psi;
        const float ca = p.ca_h[i] ? __ldg(p.ca_h[i] + cell) : p.ca_s_h[i];
        const float cb = p.cb_h[i] ? __ldg(p.cb_h[i] + cell) : p.cb_s_h[i];
        st(p.h_new[i] + cell, ca * ld(p.h_old[i] + cell) - cb * rhs);
    }
}

__global__ void __launch_bounds__(TZ * TY)
fused_step_kernel(const FusedParams p) {
    __shared__ float tile[3][3][TY][TZ];
    const int tz = threadIdx.x;
    const int ty = threadIdx.y;
    const int z0 = blockIdx.x * OZ;
    const int y0 = blockIdx.y * OY;
    const int x_begin = blockIdx.z * BX;
    const int x_end = min(x_begin + BX, p.n[0]);
    const int stride[3] = {p.n[1] * p.n[2], p.n[2], 1};
    const bool owns = ty < OY && tz < OZ && y0 + ty < p.n[1] &&
                      z0 + tz < p.n[2];
    const bool h_bulk_yz = in_bulk(p, 1, y0, OY) && in_bulk(p, 2, z0, OZ);
    // whether any J source box reaches the block's tile
    bool src_free = true;
    for (int s = 0; s < p.num_src; ++s) {
        const SrcBox& b = p.src[s];
        if (b.lo[0] <= x_end && b.hi[0] > x_begin && b.lo[1] < y0 + TY &&
            b.hi[1] > y0 && b.lo[2] < z0 + TZ && b.hi[2] > z0)
            src_free = false;
    }

    int cur = 0;
    fill_plane(p, tile[cur], x_begin, y0, z0, true, src_free, stride);
    for (int x = x_begin; x < x_end; ++x) {
        const int nxt = cur == 2 ? 0 : cur + 1;
        int xn = x + 1;
        bool have_next = true;
        if (xn >= p.n[0]) {
            if (p.bk_hi[0] == WALL_WRAP) xn = 0;
            else have_next = false;
        }
        if (have_next)
            fill_plane(p, tile[nxt], xn, y0, z0, x + 1 < x_end, src_free,
                       stride);
        // one barrier per plane: the buffer filled next is the one read
        // two planes back, which every thread has left by now
        __syncthreads();
        if (owns) {
            if (h_bulk_yz && in_bulk(p, 0, x, 1))
                h_update<true>(p, tile[cur], tile[nxt], x, y0, z0, stride);
            else
                h_update<false>(p, tile[cur], tile[nxt], x, y0, z0, stride);
        }
        cur = nxt;
    }
}

extern "C" int t3d_fused_params_size() { return (int)sizeof(FusedParams); }

// The bytes of the field, psi and pole-current values this library stores.
extern "C" void t3d_fused_storage(int32_t* out) {
    out[0] = (int32_t)sizeof(field_t);
    out[1] = (int32_t)sizeof(psi_t);
    out[2] = (int32_t)sizeof(q_t);
}

// Blocks of the kernel that fit on an SM (negative: a CUDA error).
extern "C" int t3d_fused_occupancy() {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, (const void*)fused_step_kernel, TZ * TY, 0);
    return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int t3d_fused_step(const FusedParams* p, void* stream) {
    if (p->n[0] <= 0 || p->n[1] <= 0 || p->n[2] <= 0) return 0;
    if (p->num_poles < 0 || p->num_poles > MAX_POLES || p->num_src < 0 ||
        p->num_src > MAX_SOURCES ||
        (int64_t)p->n[0] * p->n[1] * p->n[2] > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const int64_t gz = (p->n[2] + OZ - 1) / OZ;
    const int64_t gy = (p->n[1] + OY - 1) / OY;
    const int64_t gx = (p->n[0] + BX - 1) / BX;
    if (gy > 65535 || gx > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)gz, (unsigned)gy, (unsigned)gx);
    const dim3 block(TZ, TY);
    fused_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}
