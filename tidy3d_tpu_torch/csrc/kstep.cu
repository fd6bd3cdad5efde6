// K leapfrog steps of the FDTD update in one launch (temporal blocking), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel PallasKStepper.step_group
// (tidy3d_tpu/solver/kernels/pallas_kstep.py:1425, _region_call at :1468,
// pallas_call at :1785): real runs with up to MAX_POLES pole slots, and
// pole-free Bloch (complex) ones with their two copies (the Bloch part
// below), at the storage types below. One call computes K substeps; substep j (0-based), as
// the substep loop of pallas_kstep.py:2474-2590 orders it and the XLA step
// FDTDRunner._step (tidy3d_tpu/solver/fdtd.py:1614) specifies:
//
//   E' = ca_E * E + cb_E * (curl H + psi_E' - sum_p Re(Gc_p Q_p)),
//        zeroed on the PEC lo walls, plus the J source terms at t0 + j
//   Q_p' = A_p Q_p + B_p (E' + E)           (semi-implicit pole update)
//   H' = ca_H * H - cb_H * (curl E' + psi_H'), plus the M source terms
//
// with the CPML memories psi' = b * psi + c * d of all three axes of both
// families. The inputs (E, H, psi, Q) are one buffer set, the outputs the
// other: nothing is updated in place.
//
// Design. K is 2. A block owns a (BX, OY, OZ) box of cells and computes a
// (TY, TZ) tile in y and z that extends it by HALO_LO = K - 1 cells on the
// lo side and HALO_HI = K on the hi side (OY = TY - HALO_LO - HALO_HI, OZ
// likewise), and as many planes in x: E at level j of a cell needs H at
// level j - 1 one cell lower on each axis, H at level j needs E at level j
// one cell higher, so after K levels exactly the owned core is exact (the
// dependency cone). One thread holds one (y, z) column
// of the tile and the block marches over x. At march position m, level 1
// computes its E plane at x = m, then its H plane at x = m - 1; level 2 its
// E plane at m - 1 and its H plane at m - 2. A level's E and H planes sit in
// shared-memory rings, two planes per level, and 3 barriers per position
// separate every write from the reads of other threads. Level 2's H goes
// straight to device memory.
//
// Level 0 (the input E and H) is staged through shared memory by
// asynchronous copies (cp.async, 4 bytes a thread and value): while the
// block computes position m, the copies of plane m + 2 are in flight into
// the buffer that plane m frees after level 1's E, and the barrier before
// level 2's H waits for plane m + 1. The staged H tile has one more row
// and column (the y - 1 and z - 1 neighbours of the tile's first row and
// column); the x neighbour, plane m - 1 of the thread's own column, stays
// in registers from the previous position. So each level-0 value is loaded
// from device memory once per block, and level 1 reads its stencil as the
// higher levels read theirs. The wall rules apply once, when a column or
// plane is staged: past a PEC lo wall zeros, past a PMC lo wall the mirror
// (the wall cell itself), on a periodic axis the wrapped cell; in a Bloch
// run a virtual cell is staged already rotated (below). psi, which only
// the PML slabs hold, goes from level 1 to level 2 through per-thread
// shared-memory slots, two planes deep. The pole currents pass from level
// 1 to level 2 in registers (Carry): level 1 computes Q1 of plane x at
// position x and hands on the Q1 of plane x - 1, which level 2 uses at the
// same position. The kernel is instantiated per NP, the number of pole
// slots, so that every index into the carries is a compile-time constant.
//
// Bulk and shell. The host (solver/kernels/kstep.py) splits the blocks into
// two lists once per layout: a bulk block's cone (its owned box grown by
// HALO_LO cells on the lo side and HALO_HI on the hi side of every axis,
// the cells whose updates it computes; t3d_kstep_tile reports the numbers)
// lies where no psi slab, no wall and no wrap reaches an update, so the
// level-0 cells it reads, one more on the lo side, are domain cells. Bulk
// blocks run an instantiation without psi code or slots, wall rules or
// Bloch rotation (61 KB of shared memory against the shell's 109 KB, 40 %
// of the shell's instructions in the pole-free march); shell blocks run the
// general one. Each list is one launch on the caller's stream, the second a
// programmatic dependent launch whose blocks fill the SMs the first one's
// last wave leaves idle, and which ends after it: shell first where two
// blocks fit on an SM, bulk first where one fits (one launch with a
// block-uniform dispatch, and the other orders, measured slower, PERF.md;
// so was every block through the shell instantiation at one pole).
//
// Only the owner of a cell writes its E, H, psi or Q (every other block
// that computes the cell does so in its halo and discards it), so no value
// has two writers. Walls at level 2: a periodic axis wraps the tile's
// coordinates (a halo row past the wall is the cell on the other side); at
// a PEC or PMC wall the stencil takes the wall rule, halo cells too.
//
// What bounds it. Per group a cell's E, H and Q are read once from device
// memory (times the recompute factor TY * TZ * (BX + 2K - 1) / (OY * OZ *
// BX), 1.49) and written once: with one pole, ((24 + 24 + 24 + 4) * 1.49 +
// 48) / 2 = 81 B per cell-step. The recompute multiplies the arithmetic by
// the same factor, so the kernel is bound by instructions and by the warps
// that fit on an SM, not by device memory: at 384^3 on the H100 it runs at
// 4.1x its byte bound pole-free, 3.5x with one pole, 3.2x with 7 poles, and
// its time followed its instruction count. Neither load latency nor
// shared-memory reads bound it: prefetching the next plane's Q and
// coefficients into L2, staging Q by cp.async beside E and H, and keeping
// the thread's own column of levels 1 and 2 in registers were each slower or
// no faster; the shell blocks, 43 % of the blocks at 384^3, took 54 % of the
// time while the two launches ran apart (PERF.md). Up to one pole two
// 512-thread blocks fit on an SM (64 registers); from two poles the carries
// take 12 NP registers and one block fits (128). A design without carries
// (level 2 recomputing Q1 from Q read again, two blocks for every NP) was
// slower from 4 poles on (7 poles: 10.4 against 8.7 ms a group), and carries
// forced into 64 registers spill (18.2 ms); carries in shared memory do not
// fit beside the shell's 109 KB. Aligned 16-byte staging copies would need
// an owned z width of 32 columns and so 35 columns a tile, more than one
// warp holds; the rows stay 4-byte copies. K is 2: a build at K = 4 (3.12
// recompute with 14 rows, to fit its shared memory) was slower on every case
// measured (PERF.md).
//
// Bloch (complex) runs. A run with a Bloch phase e^{i phi_a} on a periodic
// axis a steps two real copies of the fields, re (copy 0) and im (copy 1),
// as the XLA step does (FDTDRunner._wrap_col, fdtd.py:861-893); it replaces
// the dual-copy machinery of PallasKStepper (pallas_kstep.py:135-151,
// :1042-1100, :1931-1976). The kernel (BL = true, pole-free only) gives
// each copy its own blocks: the copy is folded into the block index. Away
// from the wrap the update of both copies is the same, and no axis with a
// Bloch phase has a PML, so every coefficient is periodic along it. A
// halo cell whose unwrapped coordinate lies m_a periods past the domain
// along each axis is therefore a virtual cell, e^{i sum_a m_a phi_a} times
// the real cell it wraps to, and its evolution over the K levels is the
// rotation of the real cell's. So only two things change: every level-0
// value a block reads for a virtual cell (E, H, and psi of the other axes)
// is rotated, which needs the other copy's value there and nowhere else;
// and the source terms of virtual cells are rotated (the "virtual profile"
// of pallas_kstep.py:1081-1100). E and H are rotated once, when the staging
// copies them (the per-load test is out of the march); psi, read by the
// slab cells only, at its load. Each source term is complex, (term + i
// term_im) (w[key] + i w[key_im]), and copy c adds its real (c = 0) or
// imaginary (c = 1) part. Only owners write, and an owned cell is never
// virtual.
//
// Storage. The fields, the psi slabs and the pole currents are stored as
// float32 or bfloat16, each chosen at compile time (T3D_FIELD_BF16,
// T3D_PSI_BF16, T3D_Q_BF16), one library per combination, as the TPU kernel
// takes dtype, psi_dtype and q_dtype (pallas_kstep.py:132, :158-175). A
// value is widened to float32 where it is loaded and everything is computed
// in float32. The fields and the pole currents round once, at the group's
// store: levels 1 and 2 pass them on in float32 (the rings, the carries),
// as the TPU kernel keeps its substep values and writes back with one cast
// (:2590-2600). psi rounds where the TPU kernel's single-region form (the
// one it runs for Bloch runs and small grids) rounds it: the x and y psi
// live in scratch at psi_dtype between substeps (:1769, :2120-2130), so
// level 1's x and y psi pass to level 2 rounded; the packed z psi is a
// float32 value until its store (:2386, :2602). A level uses its own new
// psi unrounded, as :2346-2348 do. (The TPU kernel's split-region form
// keeps x and y psi in float32 too.) Level 0 of bfloat16 fields: cp.async
// copies 4, 8 or 16 bytes, not a 2-byte value, so a bulk block stages each
// row as 4-byte pairs of bf16 values from an even z (a tile row of 32
// columns and the z - 1 one in 17 pairs), kept in bf16 and widened where
// level 1 reads them; where nz is odd or an array is not 4-byte aligned,
// the same pairs are loaded two values at a time (stage_pairs). A shell
// block, whose columns may be walls, wraps or virtual cells, loads its
// entries one by one, widened into the float32 tiles.
//
// Sharded runs (shard-local mode, xpad = K). It replaces the sharded mode
// of the same TPU kernel (pallas_kstep.py:109-115, the halo exchange
// _exchange_halos at :1386): an x-slab decomposition in which each shard
// steps its own nx_loc planes (n[0]). Every x-spanning array of the shard
// (fields, Q, per-cell coefficients and residues, the x inverse steps, the
// psi slabs of y and z) carries K halo planes on each x side, so local
// plane x lives at padded plane x + xpad; the x psi slabs, which only the
// edge shards hold, keep their own planes. Before each launch the caller
// fills the halo planes with the neighbours' core edges (ring exchange).
// A side that reads its halo (x_halo) treats its K halo planes as part of
// the domain: the block's dependency cone reaches exactly K planes past
// the core, so the owned planes come out exact, and the march never needs
// a plane beyond the halo. Such a side has no wall; the global x walls
// apply only on a side that does not read its halo (an edge shard of a
// non-periodic x). The caller gives x-psi slab widths, bulk bounds, PEC
// masks and source boxes in the shard's local coordinates. Unsharded runs
// are the case xpad = 0 with no halo side.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_POLES = 8;     // MAX_POLES in solver/kernels/step.py
constexpr int NQ = 6 * MAX_POLES;

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

// v as a psi slab stores it (rounded in bfloat16 storage), in float32.
__device__ __forceinline__ float psi_rounded(float v) {
#ifdef T3D_PSI_BF16
    return __bfloat162float(__float2bfloat16_rn(v));
#else
    return v;
#endif
}
constexpr int SRC_INTS = 12;     // SRC_INTS in solver/kernels/kstep.py
constexpr int K = 2;             // substeps per launch: KS in kstep.py
static_assert(K == 2, "the march is written for two levels");

// The tile (TILE_Y, TILE_Z, SLAB_X and the halo in kstep.py, checked
// against t3d_kstep_tile when the library loads): TZ columns in z, one warp
// a row, TY rows, BX owned x planes per block.
constexpr int TZ = 32;
constexpr int TY = 16;
constexpr int BX = 32;
constexpr int TILE = TY * TZ;
constexpr int HALO_LO = K - 1;       // the cone past the owned box, every
constexpr int HALO_HI = K;           // axis: cells computed, not written
constexpr int OY = TY - HALO_LO - HALO_HI;   // owned rows and columns
constexpr int OZ = TZ - HALO_LO - HALO_HI;
// Blocks per SM each instantiation is built for: two (64 registers) up
// to one pole slot, one (128 registers) from two on, where the pole
// carries need the registers (PERF.md).
__host__ __device__ constexpr int min_blocks(int np) { return np <= 1 ? 2 : 1; }
constexpr int SZ = TZ + 1;           // a staged H row: the z - 1 column
constexpr int STILE = (TY + 1) * SZ; // a staged H tile: the y - 1 row too
// A bf16 row staged in pairs: 17 pairs from the even z at or below the
// tile's z - 1 column (the bulk of a bf16 run; it fits a float row).
constexpr int NPAIR = (TZ + 2) / 2;
constexpr int RW = 2 * NPAIR;
static_assert(TY * RW <= 2 * TILE && (TY + 1) * RW <= 2 * STILE,
              "a tile of bf16 pairs fits the float32 tile it replaces");
#ifdef T3D_FIELD_BF16
constexpr bool FIELD_BF16 = true;
#else
constexpr bool FIELD_BF16 = false;
#endif
// Whether an instantiation stages level 0 in bf16 pairs, and the strides
// of its staged tiles in their elements (floats, or bf16 values).
template <bool BULK>
__host__ __device__ constexpr bool pairs() { return BULK && FIELD_BF16; }
template <bool BULK>
__host__ __device__ constexpr int e_comp() { return pairs<BULK>() ? 2 * TILE : TILE; }
template <bool BULK>
__host__ __device__ constexpr int h_comp() { return pairs<BULK>() ? 2 * STILE : STILE; }
template <bool BULK>
__host__ __device__ constexpr int h_row() { return pairs<BULK>() ? RW : SZ; }

// Shared memory, in floats: the E rings of levels 1 and 2 and the H ring
// of level 1 (two planes each), the staged level 0 (two planes of E, two
// of H), and in the shell instantiation the psi slots of level 1.
constexpr int RING_FLOATS = 18 * TILE;
constexpr int STAGE_E = RING_FLOATS;
constexpr int STAGE_H = STAGE_E + 6 * TILE;
constexpr int PSI_SLOTS = STAGE_H + 6 * STILE;
constexpr int SMEM_BULK = PSI_SLOTS;
constexpr int SMEM_SHELL = PSI_SLOTS + 24 * TILE;

enum { WALL_PEC = 0, WALL_PMC = 1, WALL_WRAP = 2 };
enum { POLE_ZERO = 0, POLE_MASK = 1, POLE_DENSE = 2 };

// Mirrored by KStepParams in tidy3d_tpu_torch/solver/kernels/kstep.py.
struct KStepParams {
    const field_t* e_old[2][3];  // input set, [copy][comp]: copy 1 (the
    const field_t* h_old[2][3];  // imaginary part) only in a complex run
    field_t* e_new[2][3];        // output set
    field_t* h_new[2][3];
    const float* ca_e[3];      // per-cell coefficient, or null for the scalar
    const float* cb_e[3];
    const float* ca_h[3];
    const float* cb_h[3];
    const float* inv_e[3];     // E stencil inverse steps (kappa folded in)
    const float* inv_h[3];     // H stencil inverse steps
    const psi_t* psi_in_e[2][12];  // [copy][(2 * comp + slot) * 2 + side]:
    psi_t* psi_out_e[2][12];       // slot 0 is axis comp+1, slot 1 axis
    const psi_t* psi_in_h[2][12];  // comp+2
    psi_t* psi_out_h[2][12];
    const float* pml_b_e[6];   // [2 * axis + side]
    const float* pml_c_e[6];
    const float* pml_b_h[6];
    const float* pml_c_h[6];
    const q_t* q[NQ];          // [(pole * 3 + comp) * 2 + (0 qr, 1 qi)]
    q_t* q_out[NQ];
    const float* pole_b[NQ];   // [(pole * 3 + comp) * 2 + part]: the mask
                               // (part 0) or the dense re/im residue maps
    const int32_t* src_box[2]; // [0 J, 1 M]: num_src rows of SRC_INTS ints:
                               // comp, lo[3], hi[3], term offset, waveform
                               // row, the imaginary part's term offset and
                               // waveform row (-1: none), unused
    const float* src_term;     // the boxes' terms (-cb * profile), packed
    const float* wf;           // waveform table, wf_len steps per row
    float ca_s_e[3];
    float cb_s_e[3];
    float ca_s_h[3];
    float cb_s_h[3];
    float a_re[MAX_POLES];     // A = (1 + a dt/2) / (1 - a dt/2)
    float a_im[MAX_POLES];
    float gc_re[MAX_POLES];    // Gc = a (A + 1)
    float gc_im[MAX_POLES];
    float pole_b0[NQ];         // mask kind: B0 (re, im) per (pole, comp)
    float bloch_c[3];          // Bloch phase e^{i phi} = c + i s per axis:
    float bloch_s[3];          // (1, 0) where the axis carries none
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
    int32_t num_src[2];
    int32_t wf_len;
    int32_t t0;                // global step of the group's first substep
    int32_t k;                 // substeps per launch: K, checked
    int32_t ncopy;             // 1 (real run) or 2 (complex, pole-free)
    int32_t xpad;              // shard-local run: K halo planes on each x
                               // side of every x-spanning array (0: none)
    int32_t x_halo[2];         // the (lo, hi) x side reads its halo planes
                               // (a neighbour shard) instead of a wall
    int32_t pair_async;        // bf16 pairs are 4-byte aligned (nz even,
                               // aligned arrays): stage them by cp.async
};

static_assert(sizeof(KStepParams) + sizeof(void*) <= 4096,
              "kernel parameters must fit the 4 KB launch limit");

// A phase e^{i theta} as (cos theta, sin theta).
struct Rot {
    float c, s;
};

__device__ __forceinline__ bool is_one(Rot r) {
    return r.c == 1.0f && r.s == 0.0f;
}

// The pole currents level 1 hands to level 2 in registers: Q1 of the
// plane level 1 just computed (q_slot) and of the plane before (q). Every
// index into them is known at compile time, so they stay in registers (a
// run-time pole count would put them in local memory).
template <int NP>
struct Carry {
    static constexpr int QN = NP > 0 ? 6 * NP : 1;
    float q_slot[QN];
    float q[QN];
};

// Per-thread constants of a block.
struct Col {
    int ty, tz, tid;
    int sidx;             // the column's entry in a staged H tile
    int eidx;             // and in a staged E tile
    int pair_off;         // bf16 pairs: the y-z offset of the H pair this
                          // thread stages (-1: none), its E pair's is one
                          // row further
    int pair_dst;         // and the pair's entry in the staged tiles
    bool pair_e;          // the thread stages an E pair too
    int cy, cz;           // the column's (wrapped) y and z
    bool in_yz;           // the column lies in the domain
    bool own_yz;          // the block owns the column
    bool bulk_yz;         // the column lies in the bulk of y and z
    int xb, xe;           // the block's owned planes [xb, xe)
    int stride0;
    bool wrap[3];
    bool src[2];          // a source box of the family reaches the block
    float inv_e_yz[2];    // the column's E and H inverse steps in y and z
    float inv_h_yz[2];
    int cp;               // the copy the block steps (complex runs)
    Rot rot;              // the column's Bloch phase across y and z
    int off;              // the staged column's y-z offset (-1: zeros)
    int x_sidx;           // the thread's extra staged entry (-1: none)
    int x_off;            // and its y-z offset (-1: zeros)
    Rot x_rot;            // and phase
};

__device__ __forceinline__ Rot rot_mul(Rot a, Rot b) {
    return {a.c * b.c - a.s * b.s, a.c * b.s + a.s * b.c};
}

// e^{i m phi_a}: the phase of a cell m periods past the domain along axis
// a (exactly (1, 0) on an axis without a Bloch phase).
__device__ __forceinline__ Rot rot_axis(const KStepParams& p, int a, int m) {
    Rot r = {1.0f, 0.0f};
    const Rot u = {p.bloch_c[a], m < 0 ? -p.bloch_s[a] : p.bloch_s[a]};
    for (int i = m < 0 ? -m : m; i > 0; --i) r = rot_mul(r, u);
    return r;
}

// The phase of the cell at unwrapped plane x (wrapped: cx) of the column.
template <bool BL>
__device__ __forceinline__ Rot cell_rot(const KStepParams& p, const Col& t,
                                        int x, int cx) {
    if (!BL) return {1.0f, 0.0f};
    return x == cx ? t.rot
                   : rot_mul(t.rot, rot_axis(p, 0, (x - cx) / p.n[0]));
}

// The value of copy cp at idx (f: copy cp's array, g: the other copy's),
// seen from a cell whose phase is r: for a virtual cell (r != 1) copy cp
// of r (F0 + i F1), which reads the other copy there.
template <bool BL, typename T>
__device__ __forceinline__ float load0(const T* f, const T* g, int cp,
                                       int64_t idx, Rot r) {
    const float v = ld(f + idx);
    if (!BL || is_one(r)) return v;
    const float w = ld(g + idx);
    return cp == 0 ? r.c * v - r.s * w : r.c * v + r.s * w;
}

__device__ __forceinline__ int wrap_index(int v, int n) {
    v %= n;
    return v < 0 ? v + n : v;
}

// Asynchronous 4-byte copy from device to shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float* e_ring(float* sm, int level, int x,
                                         int comp) {
    return sm + (((level - 1) * 2 + (x & 1)) * 3 + comp) * TILE;
}

__device__ __forceinline__ float* h_ring(float* sm, int x, int comp) {
    return sm + (12 + (x & 1) * 3 + comp) * TILE;
}

// The staged E (3 tiles) and H (3 tiles of STILE) of plane x.
__device__ __forceinline__ float* stage_e(float* sm, int x) {
    return sm + STAGE_E + (x & 1) * 3 * TILE;
}

__device__ __forceinline__ float* stage_h(float* sm, int x) {
    return sm + STAGE_H + (x & 1) * 3 * STILE;
}

// Entry idx of a staged tile, in float32: a float, or in a bulk block of a
// bf16 run a bf16 value.
template <bool BULK>
__device__ __forceinline__ float staged(const float* tile, int idx) {
    if constexpr (pairs<BULK>())
        return __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(tile)[idx]);
    return tile[idx];
}

// psi of level 1 at plane x, E (idx 0-5) and H (6-11), per thread,
// double-buffered by plane parity: level 1 writes plane x at one march
// position and level 2 reads it at the next, while level 1 writes x+1.
__device__ __forceinline__ float* psi_slot(float* sm, int x, int idx) {
    return sm + PSI_SLOTS + ((x & 1) * 12 + idx) * TILE;
}

// The slab of axis a that holds cell c: side and index along a, or false.
__device__ __forceinline__ bool slab_of(const int32_t* w, const int32_t* n,
                                        int a, const int* c, int* side,
                                        int* loc) {
    const int wl = w[2 * a], wh = w[2 * a + 1];
    if (wl && c[a] < wl) {
        *side = 0;
        *loc = c[a];
        return true;
    }
    if (wh && c[a] >= n[a] - wh) {
        *side = 1;
        *loc = c[a] - (n[a] - wh);
        return true;
    }
    return false;
}

// The offset of cell c in the psi slab of axis a: an x slab holds its own
// planes, the y and z slabs span the padded x planes of a shard.
__device__ __forceinline__ int slab_offset(const KStepParams& p, int a,
                                           int wd, int loc, const int* c) {
    int dim[3] = {p.n[0], p.n[1], p.n[2]};
    int l[3] = {c[0] + p.xpad, c[1], c[2]};
    dim[a] = wd;
    l[a] = loc;
    return (l[0] * dim[1] + l[1]) * dim[2] + l[2];
}

// The lo (side 0) or hi (side 1) end of axis a is a wall the stencil
// meets: a shard's x side that reads its halo planes is none.
__device__ __forceinline__ bool walled(const KStepParams& p, int a,
                                       int side) {
    return a != 0 || !p.x_halo[side];
}

// Adds the source terms of family fam at cell c and step t to v. In a
// complex run (BL) copy cp adds its part of r (term + i term_im) (w[key] +
// i w[key_im]), r being the cell's phase.
template <bool BL>
__device__ __forceinline__ float add_sources(const KStepParams& p, int fam,
                                             int comp, const int* c, int t,
                                             float v, int cp, Rot r) {
    const int32_t* box = p.src_box[fam];
    for (int s = 0; s < p.num_src[fam]; ++s, box += SRC_INTS) {
        if (box[0] != comp || c[0] < box[1] || c[0] >= box[4] ||
            c[1] < box[2] || c[1] >= box[5] || c[2] < box[3] ||
            c[2] >= box[6])
            continue;
        const int off = ((c[0] - box[1]) * (box[5] - box[2]) +
                         (c[1] - box[2])) * (box[6] - box[3]) +
                        (c[2] - box[3]);
        const float tr = __ldg(p.src_term + box[7] + off);
        const float wr = __ldg(p.wf + (int64_t)box[8] * p.wf_len + t);
        if (!BL) {
            v = v + tr * wr;
            continue;
        }
        const float ti = box[9] >= 0 ? __ldg(p.src_term + box[9] + off) : 0.0f;
        const float wi =
            box[10] >= 0 ? __ldg(p.wf + (int64_t)box[10] * p.wf_len + t)
                         : 0.0f;
        const float zr = tr * wr - ti * wi;
        const float zi = tr * wi + ti * wr;
        v = v + (cp == 0 ? r.c * zr - r.s * zi : r.s * zr + r.c * zi);
    }
    return v;
}

// The plane x (unwrapped march coordinate) of the domain, wrapped on a
// periodic x axis; false if it lies outside a non-periodic domain. In a
// shard-local run a side that reads its halo extends the domain by its
// K halo planes (local planes -K..-1 or n..n+K-1, padded planes
// x + xpad), which hold the neighbour's core edge.
__device__ __forceinline__ bool plane_of(const KStepParams& p, const Col& t,
                                         int x, int* cx) {
    if (x >= (p.x_halo[0] ? -K : 0) && x < p.n[0] + (p.x_halo[1] ? K : 0)) {
        *cx = x;
        return true;
    }
    if (!t.wrap[0]) return false;
    *cx = wrap_index(x, p.n[0]);
    return true;
}

// The y-z offset of the cell that level 0 holds at unwrapped (uy, uz) and
// its phase: the cell itself in the domain, the wrapped cell on a periodic
// axis, the wall cell one cell past a PMC lo wall (the mirror); -1 (zeros)
// past a PEC lo wall and anywhere else outside the domain.
template <bool BL>
__device__ __forceinline__ int stage_column(const KStepParams& p,
                                            const Col& t, int uy, int uz,
                                            Rot* r) {
    int c[3] = {0, uy, uz};
    *r = {1.0f, 0.0f};
#pragma unroll
    for (int a = 1; a < 3; ++a) {
        const int u = c[a];
        if (u >= 0 && u < p.n[a]) continue;
        if (t.wrap[a]) {
            c[a] = wrap_index(u, p.n[a]);
            if (BL) *r = rot_mul(*r, rot_axis(p, a, (u - c[a]) / p.n[a]));
        } else if (u == -1 && p.bk_lo[a] == WALL_PMC) {
            c[a] = 0;
        } else {
            return -1;
        }
    }
    return c[1] * p.n[2] + c[2];
}

// Level 0 of one staged entry (y-z offset off, phase r) at padded plane
// offset base: E (e, 3 tiles apart; null: none) and H (h, 3 tiles of
// STILE apart). A plain float32 entry is copied asynchronously, a plain
// bfloat16 one loaded and widened; a virtual one is loaded and rotated;
// one outside the domain holds zeros.
template <bool BL>
__device__ __forceinline__ void stage_entry(const KStepParams& p, int cp,
                                            int base, int off, Rot r,
                                            float* e, float* h) {
    if (off < 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) h[i * STILE] = 0.0f;
        return;
    }
    const int idx = base + off;
    if (!BL || is_one(r)) {
#ifdef T3D_FIELD_BF16
        if (e) {
#pragma unroll
            for (int i = 0; i < 3; ++i) e[i * TILE] = ld(p.e_old[cp][i] + idx);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) h[i * STILE] = ld(p.h_old[cp][i] + idx);
#else
        if (e) {
#pragma unroll
            for (int i = 0; i < 3; ++i) cp_async4(e + i * TILE, p.e_old[cp][i] + idx);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) cp_async4(h + i * STILE, p.h_old[cp][i] + idx);
#endif
        return;
    }
    if (e) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
            e[i * TILE] = load0<BL>(p.e_old[cp][i], p.e_old[1 - cp][i], cp,
                                    idx, r);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
        h[i * STILE] = load0<BL>(p.h_old[cp][i], p.h_old[1 - cp][i], cp, idx,
                                 r);
}

// A bulk block of a bf16 run: stages this thread's pairs of plane x (a
// domain plane), the H pair and with_e the E pair, each component's.
template <bool BULK>
__device__ __forceinline__ void stage_pairs(const KStepParams& p,
                                            const Col& t, float* sm, int x,
                                            bool with_e) {
    if (t.pair_off < 0) return;
    const int64_t idx = (int64_t)(x + p.xpad) * t.stride0 + t.pair_off;
    __nv_bfloat16* sh =
        reinterpret_cast<__nv_bfloat16*>(stage_h(sm, x)) + t.pair_dst;
    __nv_bfloat16* se =
        reinterpret_cast<__nv_bfloat16*>(stage_e(sm, x)) + t.pair_dst;
    const bool e = with_e && t.pair_e;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const field_t* hs = p.h_old[t.cp][i] + idx;
        const field_t* es = p.e_old[t.cp][i] + idx + p.n[2];
        if (p.pair_async) {
            cp_async4(sh + i * 2 * STILE, hs);
            if (e) cp_async4(se + i * 2 * TILE, es);
        } else {
            sh[i * 2 * STILE] = hs[0];
            sh[i * 2 * STILE + 1] = hs[1];
            if (e) {
                se[i * 2 * TILE] = es[0];
                se[i * 2 * TILE + 1] = es[1];
            }
        }
    }
}

// Stages level 0 of plane x (unwrapped) into its buffers, E too if with_e.
// A plane past a PMC lo wall is the wall plane; past a PEC lo wall, and
// outside a non-periodic domain, the column's own H entry (the only one a
// computed cell reads there, as its x neighbour) holds zeros.
template <bool BL, bool BULK>
__device__ __forceinline__ void stage(const KStepParams& p, const Col& t,
                                      float* sm, int x, bool with_e) {
    if constexpr (pairs<BULK>()) {
        stage_pairs<BULK>(p, t, sm, x, with_e);
        return;
    }
    float* se = stage_e(sm, x) + t.tid;
    float* sh = stage_h(sm, x);
    int sx = x;
    Rot rx = {1.0f, 0.0f};
    if (!BULK && !plane_of(p, t, x, &sx)) {
        if (x == -1 && walled(p, 0, 0) && p.bk_lo[0] == WALL_PMC) {
            sx = 0;
        } else {
#pragma unroll
            for (int i = 0; i < 3; ++i) sh[i * STILE + t.sidx] = 0.0f;
            return;
        }
    }
    if (BL && !BULK && sx != x) rx = rot_axis(p, 0, (x - sx) / p.n[0]);
    const int base = (sx + p.xpad) * t.stride0;
    stage_entry<BL>(p, t.cp, base, t.off, rot_mul(t.rot, rx),
                    with_e && t.in_yz ? se : nullptr, sh + t.sidx);
    if (t.x_sidx >= 0)
        stage_entry<BL>(p, t.cp, base, t.x_off, rot_mul(t.x_rot, rx),
                        nullptr, sh + t.x_sidx);
}

// H of level 1 at c - e_a (f: its value at c), for level 2's E stencil.
// bulk: c lies in the bulk, so c - e_a is a domain cell and no wall rule
// applies.
template <bool BULK>
__device__ __forceinline__ float h_back(const KStepParams& p, const Col& t,
                                        float* sm, int comp, int a, int x,
                                        const int* c, float f, bool bulk) {
    if (!BULK && !bulk && c[a] == 0 && !t.wrap[a] && walled(p, a, 0))
        return p.bk_lo[a] == WALL_PEC ? 0.0f : f;
    if (a == 0) return h_ring(sm, x - 1, comp)[t.tid];
    if (a == 1) return t.ty > 0 ? h_ring(sm, x, comp)[t.tid - TZ] : 0.0f;
    return t.tz > 0 ? h_ring(sm, x, comp)[t.tid - 1] : 0.0f;
}

// E of level L at c + e_a (f: its value at c), for the H stencil.
template <bool BULK>
__device__ __forceinline__ float e_fwd(const KStepParams& p, const Col& t,
                                       float* sm, int level, int comp, int a,
                                       int x, const int* c, float f,
                                       bool bulk) {
    if (!BULK && !bulk && c[a] == p.n[a] - 1 && !t.wrap[a] && walled(p, a, 1))
        return p.bk_hi[a] == WALL_PEC ? 0.0f : f;
    if (a == 0) return e_ring(sm, level, x + 1, comp)[t.tid];
    if (a == 1)
        return t.ty < TY - 1 ? e_ring(sm, level, x, comp)[t.tid + TZ] : 0.0f;
    return t.tz < TZ - 1 ? e_ring(sm, level, x, comp)[t.tid + 1] : 0.0f;
}

// Q' = A Q + B (E' + E) of pole q, component i, at cell (esum = E' + E),
// as (re, im).
__device__ __forceinline__ Rot pole_update(const KStepParams& p, int q, int i,
                                           int cell, float qr, float qi,
                                           float esum) {
    const float are = p.a_re[q], aim = p.a_im[q];
    const int qx = (q * 3 + i) * 2;
    const float im_qr = qr * aim;
    float r = qr * are + qi * (-aim);
    float m = qi * are + im_qr;
    const int kind = p.pole_kind[q * 3 + i];
    if (kind == POLE_MASK) {
        const float mes = __ldg(p.pole_b[qx] + cell) * esum;
        r = r + p.pole_b0[qx] * mes;
        m = m + p.pole_b0[qx + 1] * mes;
    } else if (kind == POLE_DENSE) {
        r = r + __ldg(p.pole_b[qx] + cell) * esum;
        m = m + __ldg(p.pole_b[qx + 1] + cell) * esum;
    }
    return {r, m};
}

// The E plane x of level L (1 or 2): E', psi_E' and the pole update, into
// the ring (level 1) or the output set (level 2, owned cells). Level 1
// reads the staged level 0 (h0p: the column's H of plane x - 1) and leaves
// the column's level-0 H of plane x in h0c; level 2 reads the rings.
template <int NP, int L, bool BL, bool BULK>
__device__ __forceinline__ void e_level(const KStepParams& p, const Col& t,
                                        float* sm, int x, const float* h0p,
                                        float* h0c, Carry<NP>& cr) {
    const float* sh = stage_h(sm, x);
    if (L == 1) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
            h0c[i] = staged<BULK>(sh, i * h_comp<BULK>() + t.sidx);
    }
    int cx = x;
    const bool plane = BULK || plane_of(p, t, x, &cx);
    if (plane && t.in_yz) {
        const int c[3] = {cx, t.cy, t.cz};
        const int cell = (cx + p.xpad) * t.stride0 + t.cy * p.n[2] + t.cz;
        const bool owner = L == K && t.own_yz && x >= t.xb && x < t.xe;
        const bool bulk =
            BULK || (t.bulk_yz && cx >= p.bulk_lo[0] && cx < p.bulk_hi[0]);
        const int step = p.t0 + L - 1;
        const int cp = BL ? t.cp : 0;
        const Rot rc = BULK ? Rot{1.0f, 0.0f} : cell_rot<BL>(p, t, x, cx);
        const float inv_x = __ldg(p.inv_e[0] + cx + p.xpad);
        float eo[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
            eo[i] = L == 1 ? staged<BULK>(stage_e(sm, x),
                                          i * e_comp<BULK>() + t.eidx)
                           : e_ring(sm, 1, x, i)[t.tid];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const int j = (i + 1) % 3;
            const int k = (i + 2) % 3;
            float hk, hj, hk_b, hj_b;
            if (L == 1) {
                // the staged stencil: x neighbour in registers, y and z
                // neighbours one row and one column back in the tile
                hk = h0c[k];
                hj = h0c[j];
                hk_b = j == 0 ? h0p[k]
                              : staged<BULK>(sh, k * h_comp<BULK>() + t.sidx -
                                                     (j == 1 ? h_row<BULK>()
                                                             : 1));
                hj_b = k == 0 ? h0p[j]
                              : staged<BULK>(sh, j * h_comp<BULK>() + t.sidx -
                                                     (k == 1 ? h_row<BULK>()
                                                             : 1));
            } else {
                hk = h_ring(sm, x, k)[t.tid];
                hj = h_ring(sm, x, j)[t.tid];
                hk_b = h_back<BULK>(p, t, sm, k, j, x, c, hk, bulk);
                hj_b = h_back<BULK>(p, t, sm, j, k, x, c, hj, bulk);
            }
            const float d1 =
                (hk - hk_b) * (j == 0 ? inv_x : t.inv_e_yz[j - 1]);
            const float d2 =
                (hj - hj_b) * (k == 0 ? inv_x : t.inv_e_yz[k - 1]);
            float rhs = d1 - d2;
            if (!BULK) {
#pragma unroll
                for (int slot = 0; slot < 2; ++slot) {
                    const int a = slot == 0 ? j : k;
                    const int idx = 2 * i + slot;
                    int side, loc;
                    if (bulk || !slab_of(p.w_e, p.n, a, c, &side, &loc))
                        continue;
                    const int wd = p.w_e[2 * a + side];
                    const int pidx = idx * 2 + side;
                    const int off = slab_offset(p, a, wd, loc, c);
                    const float prev =
                        L == 1 ? load0<BL>(p.psi_in_e[cp][pidx],
                                           p.psi_in_e[1 - cp][pidx], cp, off,
                                           rc)
                               : psi_slot(sm, x, idx)[t.tid];
                    const float v =
                        __ldg(p.pml_b_e[2 * a + side] + loc) * prev +
                        __ldg(p.pml_c_e[2 * a + side] + loc) *
                            (slot == 0 ? d1 : d2);
                    rhs = slot == 0 ? rhs + v : rhs - v;
                    if (L == 1)
                        psi_slot(sm, x, idx)[t.tid] =
                            a == 2 ? v : psi_rounded(v);
                    if (owner) st(p.psi_out_e[cp][pidx] + off, v);
                }
            }
            // this component's pole currents: Q from device memory at
            // level 1, Q1 from the carries at level 2
            float qc[NP > 0 ? 2 * NP : 1];
#pragma unroll
            for (int q = 0; q < NP; ++q) {
                const int qx = (q * 3 + i) * 2;
                if constexpr (L == 1) {
                    qc[2 * q] = ld(p.q[qx] + cell);
                    qc[2 * q + 1] = ld(p.q[qx + 1] + cell);
                } else {
                    qc[2 * q] = cr.q[qx];
                    qc[2 * q + 1] = cr.q[qx + 1];
                }
                rhs = rhs - (p.gc_re[q] * qc[2 * q] -
                             p.gc_im[q] * qc[2 * q + 1]);
            }
            const float ca = p.ca_e[i] ? __ldg(p.ca_e[i] + cell) : p.ca_s_e[i];
            const float cb = p.cb_e[i] ? __ldg(p.cb_e[i] + cell) : p.cb_s_e[i];
            float out = ca * eo[i] + cb * rhs;
            if (!BULK && !bulk &&
                ((p.pec_lo[j] && c[j] == 0) || (p.pec_lo[k] && c[k] == 0)))
                out = 0.0f;
            if (t.src[0])
                out = add_sources<BL>(p, 0, i, c, step, out, cp, rc);
            e_ring(sm, L, x, i)[t.tid] = out;
            if (owner) st(p.e_new[cp][i] + cell, out);
            if constexpr (L == 1) {
                // Q1 = A Q + B (E1 + E), after J, handed to level 2
#pragma unroll
                for (int q = 0; q < NP; ++q) {
                    const int qx = (q * 3 + i) * 2;
                    const Rot q1 = pole_update(p, q, i, cell, qc[2 * q],
                                               qc[2 * q + 1], out + eo[i]);
                    cr.q[qx] = cr.q_slot[qx];
                    cr.q[qx + 1] = cr.q_slot[qx + 1];
                    cr.q_slot[qx] = q1.c;
                    cr.q_slot[qx + 1] = q1.s;
                }
            }
            if (L == 2 && owner) {
                // Q2 = A Q1 + B (E2 + E1), after J
#pragma unroll
                for (int q = 0; q < NP; ++q) {
                    const int qx = (q * 3 + i) * 2;
                    const Rot q2 = pole_update(p, q, i, cell, qc[2 * q],
                                               qc[2 * q + 1], out + eo[i]);
                    st(p.q_out[qx] + cell, q2.c);
                    st(p.q_out[qx + 1] + cell, q2.s);
                }
            }
        }
        return;
    }
    if (plane) {
        // a column outside the domain: zeros, never read across a wall
#pragma unroll
        for (int i = 0; i < 3; ++i) e_ring(sm, L, x, i)[t.tid] = 0.0f;
    }
    if constexpr (L == 1) {
        // nothing computed: hand on the last values (outside the cone)
#pragma unroll
        for (int qx = 0; qx < 6 * NP; ++qx) cr.q[qx] = cr.q_slot[qx];
    }
}

// The H plane x of level L: H' and psi_H', into the ring (level 1) or the
// output set (level 2, owned cells). Level 1's H is the column's staged
// value of plane x (ho).
template <int NP, int L, bool BL, bool BULK>
__device__ __forceinline__ void h_level(const KStepParams& p, const Col& t,
                                        float* sm, int x, const float* ho) {
    int cx = x;
    const bool plane = BULK || plane_of(p, t, x, &cx);
    if (plane && t.in_yz) {
        const int c[3] = {cx, t.cy, t.cz};
        const int cell = (cx + p.xpad) * t.stride0 + t.cy * p.n[2] + t.cz;
        const bool owner = L == K && t.own_yz && x >= t.xb && x < t.xe;
        const bool bulk =
            BULK || (t.bulk_yz && cx >= p.bulk_lo[0] && cx < p.bulk_hi[0]);
        const int step = p.t0 + L - 1;
        const int cp = BL ? t.cp : 0;
        const Rot rc = BULK ? Rot{1.0f, 0.0f} : cell_rot<BL>(p, t, x, cx);
        const float inv_x = __ldg(p.inv_h[0] + cx + p.xpad);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const int j = (i + 1) % 3;
            const int k = (i + 2) % 3;
            const float ek = e_ring(sm, L, x, k)[t.tid];
            const float ej = e_ring(sm, L, x, j)[t.tid];
            const float d1 =
                (e_fwd<BULK>(p, t, sm, L, k, j, x, c, ek, bulk) - ek) *
                (j == 0 ? inv_x : t.inv_h_yz[j - 1]);
            const float d2 =
                (e_fwd<BULK>(p, t, sm, L, j, k, x, c, ej, bulk) - ej) *
                (k == 0 ? inv_x : t.inv_h_yz[k - 1]);
            float rhs = d1 - d2;
            if (!BULK) {
#pragma unroll
                for (int slot = 0; slot < 2; ++slot) {
                    const int a = slot == 0 ? j : k;
                    const int idx = 2 * i + slot;
                    int side, loc;
                    if (bulk || !slab_of(p.w_h, p.n, a, c, &side, &loc))
                        continue;
                    const int wd = p.w_h[2 * a + side];
                    const int pidx = idx * 2 + side;
                    const int off = slab_offset(p, a, wd, loc, c);
                    const float prev =
                        L == 1 ? load0<BL>(p.psi_in_h[cp][pidx],
                                           p.psi_in_h[1 - cp][pidx], cp, off,
                                           rc)
                               : psi_slot(sm, x, 6 + idx)[t.tid];
                    const float v =
                        __ldg(p.pml_b_h[2 * a + side] + loc) * prev +
                        __ldg(p.pml_c_h[2 * a + side] + loc) *
                            (slot == 0 ? d1 : d2);
                    rhs = slot == 0 ? rhs + v : rhs - v;
                    if (L == 1)
                        psi_slot(sm, x, 6 + idx)[t.tid] =
                            a == 2 ? v : psi_rounded(v);
                    if (owner) st(p.psi_out_h[cp][pidx] + off, v);
                }
            }
            const float hv = L == 1 ? ho[i] : h_ring(sm, x, i)[t.tid];
            const float ca = p.ca_h[i] ? __ldg(p.ca_h[i] + cell) : p.ca_s_h[i];
            const float cb = p.cb_h[i] ? __ldg(p.cb_h[i] + cell) : p.cb_s_h[i];
            float out = ca * hv - cb * rhs;
            if (t.src[1])
                out = add_sources<BL>(p, 1, i, c, step, out, cp, rc);
            if (L == 1) h_ring(sm, x, i)[t.tid] = out;
            if (owner) st(p.h_new[cp][i] + cell, out);
        }
        return;
    }
    if (L == 1 && plane) {
#pragma unroll
        for (int i = 0; i < 3; ++i) h_ring(sm, x, i)[t.tid] = 0.0f;
    }
}

// [lo, hi) of axis a after wrapping: the whole axis when a periodic range
// leaves the domain.
__device__ __forceinline__ void block_range(const KStepParams& p,
                                            const Col& t, int a, int* lo,
                                            int* hi) {
    if (t.wrap[a] && (*lo < 0 || *hi > p.n[a])) {
        *lo = 0;
        *hi = p.n[a];
    }
}

// One block's march: block id (its index in the grid of x slabs (copies
// folded in), y rows and z columns of tiles, z fastest).
template <int NP, bool BL, bool BULK>
__device__ __forceinline__ void march(const KStepParams& p, int id,
                                      float* sm) {
    Col t;
    t.ty = threadIdx.y;
    t.tz = threadIdx.x;
    t.tid = t.ty * TZ + t.tz;
    t.sidx = (t.ty + 1) * SZ + t.tz + 1;
    t.eidx = t.tid;
    const int gz = (p.n[2] + OZ - 1) / OZ;
    const int gy = (p.n[1] + OY - 1) / OY;
    const int gx = (p.n[0] + BX - 1) / BX;
    const int bz = id % gz;
    const int by = (id / gz) % gy;
    const int bs = id / (gz * gy);
    // a complex run folds the copy into the x slabs: [copy][slab]
    t.cp = BL ? bs / gx : 0;
    t.xb = (bs - t.cp * gx) * BX;
    t.xe = min(t.xb + BX, p.n[0]);
    t.stride0 = p.n[1] * p.n[2];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        t.wrap[a] = !BULK && p.bk_lo[a] == WALL_WRAP && walled(p, a, 0);
    const int ybase = by * OY - HALO_LO;
    const int zbase = bz * OZ - HALO_LO;
    const int uy = ybase + t.ty, uz = zbase + t.tz;
    t.own_yz = t.ty >= HALO_LO && t.ty < HALO_LO + OY && t.tz >= HALO_LO &&
               t.tz < HALO_LO + OZ && uy < p.n[1] && uz < p.n[2];
    // the extra staged entries: the row before the tile (threads 0..TZ-1)
    // and the column before it (the next TY threads)
    int ey = ybase - 1, ez = zbase + t.tid;
    t.x_sidx = t.tid + 1;
    if (t.tid >= TZ) {
        ey = ybase + t.tid - TZ;
        ez = zbase - 1;
        t.x_sidx = (t.tid - TZ + 1) * SZ;
    }
    if (t.tid >= TZ + TY) t.x_sidx = -1;
    if (pairs<BULK>()) {
        // rows of 17 bf16 pairs from the even z0 at or below zbase - 1 (a
        // bulk tile has zbase >= 1): thread tid < 17 * 17 stages pair tid
        // % 17 of H row tid / 17 (y = ybase - 1 + row) and, below 16 * 17,
        // of E row tid / 17 (y = ybase + row)
        const int z0 = (zbase - 1) & ~1;
        const int row = t.tid / NPAIR, pair = t.tid % NPAIR;
        t.sidx = (t.ty + 1) * RW + uz - z0;
        t.eidx = t.ty * RW + uz - z0;
        t.pair_off = row <= TY ? (ybase - 1 + row) * p.n[2] + z0 + 2 * pair
                               : -1;
        t.pair_dst = row * RW + 2 * pair;
        t.pair_e = row < TY;
    }
    if (BULK) {
        // a bulk tile lies inside the domain: no wrap, no wall, no phase
        t.in_yz = true;
        t.cy = uy;
        t.cz = uz;
        t.rot = t.x_rot = {1.0f, 0.0f};
        t.off = uy * p.n[2] + uz;
        t.x_off = ey * p.n[2] + ez;
    } else {
        t.in_yz = (t.wrap[1] || (uy >= 0 && uy < p.n[1])) &&
                  (t.wrap[2] || (uz >= 0 && uz < p.n[2]));
        t.cy = t.wrap[1] ? wrap_index(uy, p.n[1]) : uy;
        t.cz = t.wrap[2] ? wrap_index(uz, p.n[2]) : uz;
        t.off = stage_column<BL>(p, t, uy, uz, &t.rot);
        t.x_off = stage_column<BL>(p, t, ey, ez, &t.x_rot);
    }
    // a bulk column's y and z neighbours are domain cells of the same tile
    // or outside the cone of every owned cell
    t.bulk_yz = BULK || (t.in_yz && t.cy >= p.bulk_lo[1] &&
                         t.cy < p.bulk_hi[1] && t.cz >= p.bulk_lo[2] &&
                         t.cz < p.bulk_hi[2]);
    // the column's inverse steps in y and z, fixed for the whole march
    t.inv_e_yz[0] = t.in_yz ? __ldg(p.inv_e[1] + t.cy) : 0.0f;
    t.inv_e_yz[1] = t.in_yz ? __ldg(p.inv_e[2] + t.cz) : 0.0f;
    t.inv_h_yz[0] = t.in_yz ? __ldg(p.inv_h[1] + t.cy) : 0.0f;
    t.inv_h_yz[1] = t.in_yz ? __ldg(p.inv_h[2] + t.cz) : 0.0f;
    // whether any source box of each family reaches the block's region
    int lo[3] = {t.xb - K, ybase, zbase};
    int hi[3] = {t.xe + K, ybase + TY, zbase + TZ};
#pragma unroll
    for (int a = 0; a < 3; ++a) block_range(p, t, a, &lo[a], &hi[a]);
#pragma unroll
    for (int fam = 0; fam < 2; ++fam) {
        t.src[fam] = false;
        const int32_t* box = p.src_box[fam];
        for (int s = 0; s < p.num_src[fam]; ++s, box += SRC_INTS) {
            if (box[1] < hi[0] && box[4] > lo[0] && box[2] < hi[1] &&
                box[5] > lo[1] && box[3] < hi[2] && box[6] > lo[2])
                t.src[fam] = true;
        }
    }
    // the rings start as zeros: planes before the march are outside the
    // cone of every owned cell, and zeros keep them finite
    for (int i = t.tid; i < RING_FLOATS; i += TILE) sm[i] = 0.0f;

    // level 1's E plane m needs level 0 of planes m - 1 and m; the march
    // runs m over the cone, [xb - 1, xe + 1] (the first owned H plane of
    // level 2, xb, needs level 1 from xb - 1 on, the last, xe - 1, level
    // 2's E plane xe)
    const int m0 = t.xb - HALO_LO, m1 = t.xe + HALO_HI - 1;
    float h0p[3], h0c[3];
    Carry<NP> cr;
#pragma unroll
    for (int qx = 0; qx < Carry<NP>::QN; ++qx) cr.q[qx] = cr.q_slot[qx] = 0.0f;
    stage<BL, BULK>(p, t, sm, m0 - 1, false);
    cp_async_commit();
    stage<BL, BULK>(p, t, sm, m0, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 3; ++i)
        h0p[i] = staged<BULK>(stage_h(sm, m0 - 1), i * h_comp<BULK>() + t.sidx);
    __syncthreads();
    stage<BL, BULK>(p, t, sm, m0 + 1, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // the cone narrows by one cell per level on each side: the owned H of
    // level 2 needs E_1 on rows [0, TY - 1] and planes [xb - 1, xe + 1], H_1
    // on rows [0, TY - 2] and planes [xb - 1, xe], E_2 on rows [1, TY - 2]
    // and planes [xb, xe], H_2 on rows [1, TY - 3] and planes [xb, xe - 1].
    // Rows (warps) and planes outside skip the level; the ranges nest, so
    // what a level skips no higher level reads.
    for (int m = m0; m <= m1; ++m) {
        e_level<NP, 1, BL, BULK>(p, t, sm, m, h0p, h0c, cr);
        __syncthreads();
        // plane m's buffers are free: stage plane m + 2 into them
        if (m + 2 <= m1) stage<BL, BULK>(p, t, sm, m + 2, true);
        cp_async_commit();
        if (t.ty <= TY - 2 && m >= t.xb)
            h_level<NP, 1, BL, BULK>(p, t, sm, m - 1, h0p);
        __syncthreads();
        if (t.ty >= 1 && t.ty <= TY - 2 && m >= t.xb + 1)
            e_level<NP, 2, BL, BULK>(p, t, sm, m - 1, h0p, h0c, cr);
        // plane m + 1 has landed (only m + 2 may be in flight)
        cp_async_wait<1>();
        __syncthreads();
        if (t.ty >= 1 && t.ty <= TY - 3 && m >= t.xb + 2)
            h_level<NP, 2, BL, BULK>(p, t, sm, m - 2, nullptr);
#pragma unroll
        for (int i = 0; i < 3; ++i) h0p[i] = h0c[i];
    }
    cp_async_wait<0>();
}

// done: null in a group's first launch; in its second, the stream's word
// that counts the launch's finished blocks (zero at the start).
template <int NP, bool BL, bool BULK>
__global__ void __launch_bounds__(TILE, min_blocks(NP))
kstep_kernel(const KStepParams p, const int32_t* __restrict__ ids,
             unsigned* done) {
    extern __shared__ float sm[];
    // the group's second launch may start once every block of this one has
    // started (a no-op for a launch that has no dependent)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    march<NP, BL, BULK>(p, ids[blockIdx.x], sm);
    if (done) {
        // the second launch ends after the first: its last block to finish
        // waits for the first launch's grid (the two write disjoint cells
        // and read only the input set, so nothing else waits), and zeroes
        // the word for the stream's next group, which starts after this
        // launch has ended
        __syncthreads();
        if (threadIdx.x == 0 && threadIdx.y == 0 &&
            atomicAdd(done, 1u) == gridDim.x - 1) {
            *done = 0;
            asm volatile("griddepcontrol.wait;\n" ::: "memory");
        }
    }
}

using KernelFn = void (*)(const KStepParams, const int32_t*, unsigned*);

template <int NP>
static KernelFn kernel_poles(int np, bool bulk) {
    if (np == NP)
        return bulk ? kstep_kernel<NP, false, true>
                    : kstep_kernel<NP, false, false>;
    if constexpr (NP < MAX_POLES) return kernel_poles<NP + 1>(np, bulk);
    return nullptr;
}

// The instantiation for np pole slots (real runs) or the two-copy one
// (bloch, np = 0), bulk or shell; null if there is none.
static KernelFn kernel_for(int np, bool bloch, bool bulk) {
    if (bloch)
        return np != 0 ? nullptr
                       : bulk ? kstep_kernel<0, true, true>
                              : kstep_kernel<0, true, false>;
    return kernel_poles<0>(np, bulk);
}

static size_t smem_bytes(bool bulk) {
    return (size_t)(bulk ? SMEM_BULK : SMEM_SHELL) * sizeof(float);
}

static cudaError_t prepare(KernelFn fn, bool bulk) {
    return cudaFuncSetAttribute((const void*)fn,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_bytes(bulk));
}

extern "C" int t3d_kstep_params_size() { return (int)sizeof(KStepParams); }

// The bytes of the field, psi and pole-current values this library stores.
extern "C" void t3d_kstep_storage(int32_t* out) {
    out[0] = (int32_t)sizeof(field_t);
    out[1] = (int32_t)sizeof(psi_t);
    out[2] = (int32_t)sizeof(q_t);
}

// The geometry the host's block lists count in: the tile (TY, TZ), the
// owned box (BX, OY, OZ) and the cone's halo (HALO_LO, HALO_HI).
extern "C" void t3d_kstep_tile(int32_t* out) {
    const int32_t v[7] = {TY, TZ, BX, OY, OZ, HALO_LO, HALO_HI};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// Blocks of one instantiation that fit on an SM (0 if none; negative: a
// CUDA error).
extern "C" int t3d_kstep_occupancy(int np, int bloch, int bulk) {
    const KernelFn fn = kernel_for(np, bloch != 0, bulk != 0);
    if (!fn) return -(int)cudaErrorInvalidValue;
    cudaError_t err = prepare(fn, bulk != 0);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, (const void*)fn, TILE, smem_bytes(bulk != 0));
    return err == cudaSuccess ? blocks : -(int)err;
}

// One group: the bulk blocks (n_bulk ids) and the shell blocks (n_shell
// ids) as two launches on stream (one where a list is empty). Every block
// of the grid is in exactly one list (the caller's classification). done:
// a zeroed word of device memory that the stream's groups share (they run
// one after another; a group on another stream needs its own word).
extern "C" int t3d_kstep_group(const KStepParams* p, const int32_t* bulk_ids,
                               int n_bulk, const int32_t* shell_ids,
                               int n_shell, unsigned* done, void* stream) {
    if (p->n[0] <= 0 || p->n[1] <= 0 || p->n[2] <= 0) return 0;
    if (p->k != K || p->num_poles < 0 || p->num_poles > MAX_POLES ||
        p->num_src[0] < 0 || p->num_src[1] < 0 || p->t0 < 0 ||
        p->t0 + K > p->wf_len || p->ncopy < 1 || p->ncopy > 2 ||
        (p->ncopy == 2 && p->num_poles != 0) ||
        (p->xpad != 0 && (p->xpad != K || p->ncopy != 1)) ||
        ((p->x_halo[0] || p->x_halo[1]) && p->xpad == 0) ||
        (int64_t)(p->n[0] + 2 * p->xpad) * p->n[1] * p->n[2] > 0x7fffffffLL ||
        n_bulk < 0 || n_shell < 0 || (n_bulk > 0 && n_shell > 0 && !done))
        return (int)cudaErrorInvalidValue;
    const bool bloch = p->ncopy == 2;
    const dim3 block(TZ, TY);
    // The second launch is a programmatic dependent launch: its blocks
    // fill the SMs that the first launch's last wave leaves idle. The shell
    // launch goes first where two blocks fit on an SM, the bulk one where
    // one fits (the other order measured slower there, PERF.md).
    const bool bulk_first = min_blocks(p->num_poles) == 1;
    for (int part = 0; part < 2; ++part) {
        const bool bulk = (part == 0) == bulk_first;
        const int count = bulk ? n_bulk : n_shell;
        if (count == 0) continue;
        const KernelFn fn = kernel_for(p->num_poles, bloch, bulk);
        if (!fn) return (int)cudaErrorInvalidValue;
        cudaError_t err = prepare(fn, bulk);
        if (err != cudaSuccess) return (int)err;
        const bool second = part == 1 && (bulk ? n_shell : n_bulk) > 0;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(count);
        cfg.blockDim = block;
        cfg.dynamicSmemBytes = smem_bytes(bulk);
        cfg.stream = (cudaStream_t)stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[0].val.programmaticStreamSerializationAllowed = 1;
        cfg.attrs = attr;
        cfg.numAttrs = second ? 1 : 0;
        err = cudaLaunchKernelEx(&cfg, fn, *p, bulk ? bulk_ids : shell_ids,
                                 second ? done : (unsigned*)nullptr);
        if (err != cudaSuccess) return (int)err;
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
