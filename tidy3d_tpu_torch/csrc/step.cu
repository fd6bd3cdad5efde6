// Half-step family update of the FDTD leapfrog, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel PallasStepper.family_update
// (tidy3d_tpu/solver/kernels/pallas_step.py:118, pallas_call at :417) and
// computes what FDTDRunner._update_field_family (tidy3d_tpu/solver/fdtd.py:982)
// specifies, for real runs with up to MAX_POLES dispersive poles.
// One launch updates one family (E from H, or H from E^{n+1}) for all three
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
// Design: one thread per cell, z fastest, so a warp reads 32 neighbouring
// values of each array; a 3D launch grid (x planes, y rows, z cells), so no
// thread divides to find its cell; 64-bit offsets; float32 arithmetic. The
// bound is HBM bandwidth: 36 B per cell (3 source, 3 old and 3 new float32 values), plus
// the per-cell ca/cb arrays where the medium varies, plus the re-reads of the
// x and y neighbour planes and the psi slabs where L2 does not hold them.
// At 3.35 TB/s that is about 10.7 ps per cell and family at best; each pole
// adds 24 B per cell to the E family (its 3 qr and 3 qi values). bfloat16
// storage halves the bytes of the values stored in it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_POLES = 8;  // MAX_POLES in solver/kernels/step.py

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
    int64_t n[3];             // interior shape (x, y, z), z contiguous
    int32_t w[6];             // psi slab widths [2 * axis + side]
    int32_t bkind[3];         // wall the stencil crosses: 0 PEC, 1 PMC, 2 wrap
    int32_t pec_lo[3];        // E family: the lo wall of the axis is PEC
    int32_t is_e;
    int32_t num_poles;        // E family: pole slots in use (<= MAX_POLES)
    float gc_re[MAX_POLES];   // Re and Im of Gc = a (A + 1) per pole
    float gc_im[MAX_POLES];
    const q_t* q[6 * MAX_POLES];  // [(pole * 3 + comp) * 2 + (0 qr, 1 qi)]
};

enum { WALL_PEC = 0, WALL_PMC = 1, WALL_WRAP = 2 };

// one warp spans 32 consecutive z cells of one (x, y) row
constexpr int BLOCK_Z = 32;
constexpr int BLOCK_Y = 8;

// sgn * (F - F_shifted) * inv along axis a at this cell.
template <bool IS_E>
__device__ __forceinline__ float diff_along(const FamilyParams& p,
                                            const field_t* __restrict__ F,
                                            int64_t cell, const int64_t* c,
                                            const int64_t* stride, int a) {
    const float f = ld(F + cell);
    const float inv = __ldg(p.inv[a] + c[a]);
    const int64_t na = p.n[a];
    if (IS_E) {
        float prev;
        if (c[a] > 0) {
            prev = ld(F + cell - stride[a]);
        } else if (p.bkind[a] == WALL_PEC) {
            prev = 0.0f;
        } else if (p.bkind[a] == WALL_PMC) {
            prev = f;
        } else {
            prev = ld(F + cell + (na - 1) * stride[a]);
        }
        return (f - prev) * inv;
    }
    float nxt;
    if (c[a] < na - 1) {
        nxt = ld(F + cell + stride[a]);
    } else if (p.bkind[a] == WALL_PEC) {
        nxt = 0.0f;
    } else if (p.bkind[a] == WALL_PMC) {
        nxt = f;
    } else {
        nxt = ld(F + cell - (na - 1) * stride[a]);
    }
    return (nxt - f) * inv;
}

// Updates the psi slab of (comp, slot) on axis a that holds this cell, if
// one does; returns whether it did, with the new value in *psi.
__device__ __forceinline__ bool psi_update(const FamilyParams& p, int comp,
                                           int slot, int a, const int64_t* c,
                                           float d, float* psi) {
    for (int side = 0; side < 2; ++side) {
        const int64_t w = p.w[2 * a + side];
        if (w == 0) continue;
        const int64_t loc = side == 0 ? c[a] : c[a] - (p.n[a] - w);
        if (loc < 0 || loc >= w) continue;
        const int idx = (2 * comp + slot) * 2 + side;
        int64_t dim[3] = {p.n[0], p.n[1], p.n[2]};
        int64_t l[3] = {c[0], c[1], c[2]};
        dim[a] = w;
        l[a] = loc;
        const int64_t off = (l[0] * dim[1] + l[1]) * dim[2] + l[2];
        const float v = __ldg(p.pml_b[2 * a + side] + loc) *
                            ld(p.psi_in[idx] + off) +
                        __ldg(p.pml_c[2 * a + side] + loc) * d;
        st(p.psi_out[idx] + off, v);
        *psi = v;
        return true;
    }
    return false;
}

template <bool IS_E>
__global__ void __launch_bounds__(BLOCK_Z * BLOCK_Y)
family_update_kernel(const FamilyParams p) {
    // blockIdx.z is the x plane, (blockIdx.y, threadIdx.y) the y row and
    // (blockIdx.x, threadIdx.x) the z cell: no integer division per cell
    int64_t c[3];
    c[0] = blockIdx.z;
    c[1] = (int64_t)blockIdx.y * BLOCK_Y + threadIdx.y;
    c[2] = (int64_t)blockIdx.x * BLOCK_Z + threadIdx.x;
    if (c[1] >= p.n[1] || c[2] >= p.n[2]) return;
    const int64_t stride[3] = {p.n[1] * p.n[2], p.n[2], 1};
    const int64_t cell = c[0] * stride[0] + c[1] * stride[1] + c[2];

#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int j = (i + 1) % 3;
        const int k = (i + 2) % 3;
        const float d1 = diff_along<IS_E>(p, p.src[k], cell, c, stride, j);
        const float d2 = diff_along<IS_E>(p, p.src[j], cell, c, stride, k);
        float rhs = d1 - d2;
        float psi;
        if (psi_update(p, i, 0, j, c, d1, &psi)) rhs = rhs + psi;
        if (psi_update(p, i, 1, k, c, d2, &psi)) rhs = rhs - psi;
        if (IS_E) {
            for (int q = 0; q < p.num_poles; ++q) {
                const float qr = ld(p.q[(q * 3 + i) * 2] + cell);
                const float qi = ld(p.q[(q * 3 + i) * 2 + 1] + cell);
                rhs = rhs - (p.gc_re[q] * qr - p.gc_im[q] * qi);
            }
        }
        const float ca = p.ca[i] ? __ldg(p.ca[i] + cell) : p.ca_s[i];
        const float cb = p.cb[i] ? __ldg(p.cb[i] + cell) : p.cb_s[i];
        const float old = ld(p.old[i] + cell);
        float out;
        if (IS_E) {
            out = ca * old + cb * rhs;
            if ((p.pec_lo[j] && c[j] == 0) || (p.pec_lo[k] && c[k] == 0))
                out = 0.0f;
        } else {
            out = ca * old - cb * rhs;
        }
        st(p.out[i] + cell, out);
    }
}

extern "C" int t3d_family_params_size() { return (int)sizeof(FamilyParams); }

// The bytes of the field, psi and pole-current values this library stores.
extern "C" void t3d_family_storage(int32_t* out) {
    out[0] = (int32_t)sizeof(field_t);
    out[1] = (int32_t)sizeof(psi_t);
    out[2] = (int32_t)sizeof(q_t);
}

// Blocks of the E (is_e) or H instantiation that fit on an SM (negative: a
// CUDA error).
extern "C" int t3d_family_occupancy(int is_e) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks,
        is_e ? (const void*)family_update_kernel<true>
             : (const void*)family_update_kernel<false>,
        BLOCK_Z * BLOCK_Y, 0);
    return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int t3d_family_update(const FamilyParams* p, void* stream) {
    if (p->n[0] <= 0 || p->n[1] <= 0 || p->n[2] <= 0) return 0;
    if (p->num_poles < 0 || p->num_poles > MAX_POLES)
        return (int)cudaErrorInvalidValue;
    const int64_t gz = (p->n[2] + BLOCK_Z - 1) / BLOCK_Z;
    const int64_t gy = (p->n[1] + BLOCK_Y - 1) / BLOCK_Y;
    if (gz > 0x7fffffffLL || gy > 65535 || p->n[0] > 65535)
        return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)gz, (unsigned)gy, (unsigned)p->n[0]);
    const dim3 block(BLOCK_Z, BLOCK_Y);
    cudaStream_t s = (cudaStream_t)stream;
    if (p->is_e) {
        family_update_kernel<true><<<grid, block, 0, s>>>(*p);
    } else {
        family_update_kernel<false><<<grid, block, 0, s>>>(*p);
    }
    return (int)cudaGetLastError();
}
