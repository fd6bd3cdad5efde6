// K leapfrog steps of the FDTD update in one launch (temporal blocking), for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel PallasKStepper.step_group
// (tidy3d_tpu/solver/kernels/pallas_kstep.py:1425, _region_call at :1468,
// pallas_call at :1785) for float32 runs: real ones with up to MAX_POLES
// pole slots, and pole-free Bloch (complex) ones with their two copies (the
// Bloch part below). One launch computes K substeps; substep j (0-based), as
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
// Design. A block owns a (BX, OY, OZ) box of cells and computes a
// (TY, TZ) tile in y and z that extends it by K - 1 cells on the lo side
// and K on the hi side (OY = TY - 2K + 1, OZ = TZ - 2K + 1): E at level j
// of a cell needs H at level j - 1 one cell lower on each axis, H at level
// j needs E at level j one cell higher, so after K levels exactly the owned
// core is exact (the dependency cone). One thread holds one (y, z) column
// of the tile and the block marches over x. At march position m, level j
// computes its E plane at x = m - j + 1, the pole update of that plane,
// then its H plane at x = m - j: each level runs one plane behind the one
// below it. A level's E and H planes
// sit in shared memory, two planes per level (the plane being written and
// the one its readers still need), so 2K - 1 barriers per march position
// separate every write from the reads of other threads. Level 0 is read
// from device memory with the wall rules of fused.cu; level K's H goes
// straight to device memory. The per-cell recursions (psi and Q) pass from
// level to level inside the thread: level j + 1 computes, at march
// position m, the plane that level j computed at m - 1. psi, which only
// the PML slabs hold, goes through per-thread shared-memory slots, two
// planes per level. Q, which every cell holds, stays in registers: each
// level keeps its last value in a slot and hands the previous one on. The
// kernel is instantiated per NP, the number of pole slots, so that
// every index into these carries is a compile-time constant; a run-time
// pole count put them in local memory and cost 4x (PERF.md). Each level
// skips the rows (warps) and planes outside its cone, which narrows by one
// cell per level. Cells whose updates meet no psi slab and no wall (the
// bulk) skip those branches.
//
// Only the owner of a cell writes its E, H, psi or Q (every other block
// that computes the cell does so in its halo and discards it), so no value
// has two writers. Walls: a periodic axis wraps the tile's coordinates (a
// halo row past the wall is the cell on the other side); at a PEC or PMC
// wall the stencil takes the wall rule at every level, halo cells too.
//
// What bounds it. Per group a cell's E, H and Q are read once from device
// memory (times the recompute factor TY * TZ * (BX + 2K - 1) / (OY * OZ *
// BX), 1.49) and written once: with one pole, ((24 + 24 + 24 + 4) * 1.49 +
// 48) / 2 = 81 B per cell-step against the fused tier's 96 plus 72 B of
// the separate pole pass. The recompute multiplies the arithmetic by the
// same factor, and the pole carries hold many registers, so the kernel is
// bound by instructions and by how many warps fit on an SM (Cfg), not by
// device memory or by its 2K - 1 barriers per march position (removing
// them all changed nothing). Load instructions count: holding the column's
// y and z inverse steps in registers, not loading them per cell, took 6 %
// off the pole-free group. K is 2: a build at K = 4 (3.12 recompute with
// 14 rows, to fit its shared memory) was slower on every case measured
// (PERF.md).
//
// Bloch (complex) runs. A run with a Bloch phase e^{i phi_a} on a periodic
// axis a steps two real copies of the fields, re (copy 0) and im (copy 1),
// as the XLA step does (FDTDRunner._wrap_col, fdtd.py:861-893); it replaces
// the dual-copy machinery of PallasKStepper (pallas_kstep.py:135-151,
// :1042-1100, :1931-1976). The kernel (BL = true, pole-free only) gives
// each copy its own blocks: the copy is folded into blockIdx.z, so a block
// keeps the registers of one copy (64, two blocks per SM). Away
// from the wrap the update of both copies is the same, and no axis with a
// Bloch phase has a PML, so every coefficient is periodic along it. A
// halo cell whose unwrapped coordinate lies m_a periods past the domain
// along each axis is therefore a virtual cell, e^{i sum_a m_a phi_a} times
// the real cell it wraps to, and its evolution over the K levels is the
// rotation of the real cell's. So only two things change: every level-0
// value a block loads for a virtual cell (E, H, and psi of the other axes)
// is rotated, which needs the other copy's value there and nowhere else;
// and the source terms of virtual cells are rotated (the "virtual profile"
// of pallas_kstep.py:1081-1100). Each source term is complex, (term + i
// term_im) (w[key] + i w[key_im]), and copy c adds its real (c = 0) or
// imaginary (c = 1) part. Only owners write, and an owned cell is never
// virtual. On the H100 the two copies take 1.19-1.25x the time of two real
// launches on the same grid: the test for a virtual cell and the rotation
// code sit on every level-0 load of an instruction-bound kernel (PERF.md).
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

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_POLES = 8;     // MAX_POLES in solver/kernels/step.py
constexpr int NQ = 6 * MAX_POLES;
constexpr int SRC_INTS = 12;     // SRC_INTS in solver/kernels/kstep.py
constexpr int K = 2;             // substeps per launch: KS in kstep.py

constexpr int TZ = 32;           // tile width in z: one warp per row
constexpr int BX = 32;           // owned x planes per block

// Tile rows in y and the blocks per SM that the registers are budgeted for,
// per pole count NP. More warps per SM win as long as the registers fit
// without heavy spills: two blocks (64 registers) with at most one pole,
// one block (up to 128) with more (PERF.md).
template <int NP>
struct Cfg {
    static constexpr int TY = 16;
    static constexpr int MIN_BLOCKS = NP <= 1 ? 2 : 1;
    static constexpr int TILE = TY * TZ;
};

enum { WALL_PEC = 0, WALL_PMC = 1, WALL_WRAP = 2 };
enum { POLE_ZERO = 0, POLE_MASK = 1, POLE_DENSE = 2 };

// Mirrored by KStepParams in tidy3d_tpu_torch/solver/kernels/kstep.py.
struct KStepParams {
    const float* e_old[2][3];  // input set, [copy][comp]: copy 1 (the
    const float* h_old[2][3];  // imaginary part) only in a complex run
    float* e_new[2][3];        // output set
    float* h_new[2][3];
    const float* ca_e[3];      // per-cell coefficient, or null for the scalar
    const float* cb_e[3];
    const float* ca_h[3];
    const float* cb_h[3];
    const float* inv_e[3];     // E stencil inverse steps (kappa folded in)
    const float* inv_h[3];     // H stencil inverse steps
    const float* psi_in_e[2][12];  // [copy][(2 * comp + slot) * 2 + side]:
    float* psi_out_e[2][12];       // slot 0 is axis comp+1, slot 1 axis
    const float* psi_in_h[2][12];  // comp+2
    float* psi_out_h[2][12];
    const float* pml_b_e[6];   // [2 * axis + side]
    const float* pml_c_e[6];
    const float* pml_b_h[6];
    const float* pml_c_h[6];
    const float* q[NQ];        // [(pole * 3 + comp) * 2 + (0 qr, 1 qi)]
    float* q_out[NQ];
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
};

static_assert(sizeof(KStepParams) <= 4096,
              "kernel parameters must fit the 4 KB launch limit");

// A phase e^{i theta} as (cos theta, sin theta).
struct Rot {
    float c, s;
};

// Per-thread constants of a block.
struct Col {
    int ty, tz;
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

// The level-0 value of copy cp at idx (f: copy cp's array, g: the other
// copy's), seen from a cell whose phase is r: for a virtual cell (r != 1)
// copy cp of r (F0 + i F1), which reads the other copy there.
template <bool BL>
__device__ __forceinline__ float load0(const float* f, const float* g,
                                       int cp, int64_t idx, Rot r) {
    const float v = __ldg(f + idx);
    if (!BL || (r.c == 1.0f && r.s == 0.0f)) return v;
    const float w = __ldg(g + idx);
    return cp == 0 ? r.c * v - r.s * w : r.c * v + r.s * w;
}

// The pole currents handed from level to level (see the header), for NP
// pole slots. Every index into them is known at compile time, so they stay
// in registers (a run-time pole count would put them in local memory).
template <int NP>
struct Carry {
    static constexpr int QN = NP > 0 ? 6 * NP : 1;
    float q_slot[K - 1][QN];
    float q[QN];
};

__device__ __forceinline__ int wrap_index(int v, int n) {
    v %= n;
    return v < 0 ? v + n : v;
}

template <int NP>
__device__ __forceinline__ float* e_ring(float* sm, int level, int x,
                                         int comp) {
    return sm + (((level - 1) * 2 + (x & 1)) * 3 + comp) * Cfg<NP>::TILE;
}

template <int NP>
__host__ __device__ constexpr int ring_floats() {
    return (6 * K + 6 * (K - 1)) * Cfg<NP>::TILE;
}

// psi of level 1..K-1 at plane x, E (idx 0-5) and H (6-11), per thread,
// double-buffered by plane parity: level L writes plane x at one march
// position and level L + 1 reads it at the next, while level L writes x+1.
template <int NP>
__device__ __forceinline__ float* psi_slot(float* sm, int level, int x,
                                           int idx) {
    return sm + ring_floats<NP>() +
           (((level - 1) * 2 + (x & 1)) * 12 + idx) * Cfg<NP>::TILE;
}

template <int NP>
__device__ __forceinline__ float* h_ring(float* sm, int level, int x,
                                         int comp) {
    return sm + (6 * K + ((level - 1) * 2 + (x & 1)) * 3 + comp) *
                    Cfg<NP>::TILE;
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

// The inverse step of axis a at cell c: along x from device memory, along
// y and z the column's own (yz), loaded once per block.
__device__ __forceinline__ float inv_step(const KStepParams& p,
                                          const float* const* inv,
                                          const float* yz, int a,
                                          const int* c) {
    return a == 0 ? __ldg(inv[0] + c[0] + p.xpad) : yz[a - 1];
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

// H of level L - 1 at c - e_a (f: its value at c), for the E stencil:
// level 0 from the input set, the others from the rings. bulk: c lies in
// the bulk, so c - e_a is a domain cell and no wall rule applies. rc: the
// phase of c (complex runs); the wrap to c - e_a crosses one more period.
template <int NP, int L, bool BL>
__device__ __forceinline__ float h_back(const KStepParams& p, const Col& t,
                                        float* sm, int comp, int a, int x,
                                        const int* c, int cell, float f,
                                        bool bulk, Rot rc) {
    if constexpr (L == 1) {
        const int cp = BL ? t.cp : 0;
        const float* F = p.h_old[cp][comp];
        const float* G = BL ? p.h_old[1 - cp][comp] : nullptr;
        const int st = a == 0 ? t.stride0 : (a == 1 ? p.n[2] : 1);
        if (bulk || c[a] > 0 || !walled(p, a, 0))
            return load0<BL>(F, G, cp, cell - st, rc);
        if (p.bk_lo[a] == WALL_PEC) return 0.0f;
        if (p.bk_lo[a] == WALL_PMC) return f;
        return load0<BL>(F, G, cp, cell + (p.n[a] - 1) * st,
                         BL ? rot_mul(rc, rot_axis(p, a, -1)) : rc);
    }
    if (!bulk && c[a] == 0 && !t.wrap[a] && walled(p, a, 0))
        return p.bk_lo[a] == WALL_PEC ? 0.0f : f;
    const int tid = t.ty * TZ + t.tz;
    if (a == 0) return h_ring<NP>(sm, L - 1, x - 1, comp)[tid];
    if (a == 1)
        return t.ty > 0 ? h_ring<NP>(sm, L - 1, x, comp)[tid - TZ] : 0.0f;
    return t.tz > 0 ? h_ring<NP>(sm, L - 1, x, comp)[tid - 1] : 0.0f;
}

// E of level L at c + e_a (f: its value at c), for the H stencil.
template <int NP>
__device__ __forceinline__ float e_fwd(const KStepParams& p, const Col& t,
                                       float* sm, int level, int comp, int a,
                                       int x, const int* c, float f,
                                       bool bulk) {
    if (!bulk && c[a] == p.n[a] - 1 && !t.wrap[a] && walled(p, a, 1))
        return p.bk_hi[a] == WALL_PEC ? 0.0f : f;
    const int tid = t.ty * TZ + t.tz;
    if (a == 0) return e_ring<NP>(sm, level, x + 1, comp)[tid];
    if (a == 1)
        return t.ty < Cfg<NP>::TY - 1
                   ? e_ring<NP>(sm, level, x, comp)[tid + TZ]
                   : 0.0f;
    return t.tz < TZ - 1 ? e_ring<NP>(sm, level, x, comp)[tid + 1] : 0.0f;
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

// Level L's E plane x: E', psi_E', the pole update, into the ring (levels
// below K) or the output set (level K, owned cells).
template <int NP, int L, bool BL>
__device__ __forceinline__ void e_level(const KStepParams& p, const Col& t,
                                        float* sm, int x,
                                        Carry<NP>& cr) {
    int cx;
    const bool plane = plane_of(p, t, x, &cx);
    const int tid = t.ty * TZ + t.tz;
    if (plane && t.in_yz) {
        const int c[3] = {cx, t.cy, t.cz};
        const int cell = (cx + p.xpad) * t.stride0 + t.cy * p.n[2] + t.cz;
        const bool owner = L == K && t.own_yz && x >= t.xb && x < t.xe;
        const bool bulk =
            t.bulk_yz && cx >= p.bulk_lo[0] && cx < p.bulk_hi[0];
        const int step = p.t0 + L - 1;
        const int cp = BL ? t.cp : 0;
        const Rot rc = cell_rot<BL>(p, t, x, cx);
        float eo[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
            eo[i] = L == 1 ? load0<BL>(p.e_old[cp][i], p.e_old[1 - cp][i],
                                       cp, cell, rc)
                           : e_ring<NP>(sm, L - 1, x, i)[tid];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const int j = (i + 1) % 3;
            const int k = (i + 2) % 3;
            const float hk =
                L == 1 ? load0<BL>(p.h_old[cp][k], p.h_old[1 - cp][k], cp,
                                   cell, rc)
                       : h_ring<NP>(sm, L - 1, x, k)[tid];
            const float hj =
                L == 1 ? load0<BL>(p.h_old[cp][j], p.h_old[1 - cp][j], cp,
                                   cell, rc)
                       : h_ring<NP>(sm, L - 1, x, j)[tid];
            const float hk_b =
                h_back<NP, L, BL>(p, t, sm, k, j, x, c, cell, hk, bulk, rc);
            const float hj_b =
                h_back<NP, L, BL>(p, t, sm, j, k, x, c, cell, hj, bulk, rc);
            const float d1 = (hk - hk_b) * inv_step(p, p.inv_e, t.inv_e_yz, j, c);
            const float d2 = (hj - hj_b) * inv_step(p, p.inv_e, t.inv_e_yz, k, c);
            float rhs = d1 - d2;
#pragma unroll
            for (int slot = 0; slot < 2; ++slot) {
                const int a = slot == 0 ? j : k;
                const int idx = 2 * i + slot;
                int side, loc;
                if (bulk || !slab_of(p.w_e, p.n, a, c, &side, &loc)) continue;
                const int wd = p.w_e[2 * a + side];
                const int pidx = idx * 2 + side;
                const int off = slab_offset(p, a, wd, loc, c);
                const float prev =
                    L == 1 ? load0<BL>(p.psi_in_e[cp][pidx],
                                       p.psi_in_e[1 - cp][pidx], cp, off, rc)
                           : psi_slot<NP>(sm, L - 1, x, idx)[tid];
                const float v =
                    __ldg(p.pml_b_e[2 * a + side] + loc) * prev +
                    __ldg(p.pml_c_e[2 * a + side] + loc) *
                        (slot == 0 ? d1 : d2);
                rhs = slot == 0 ? rhs + v : rhs - v;
                if (L < K) psi_slot<NP>(sm, L, x, idx)[tid] = v;
                if (owner) p.psi_out_e[cp][pidx][off] = v;
            }
            // this component's pole currents: live for this iteration only
            float q_in[NP > 0 ? 2 * NP : 1];
#pragma unroll
            for (int q = 0; q < NP; ++q) {
                const int qx = (q * 3 + i) * 2;
                q_in[2 * q] = L == 1 ? __ldg(p.q[qx] + cell) : cr.q[qx];
                q_in[2 * q + 1] =
                    L == 1 ? __ldg(p.q[qx + 1] + cell) : cr.q[qx + 1];
                rhs = rhs - (p.gc_re[q] * q_in[2 * q] -
                             p.gc_im[q] * q_in[2 * q + 1]);
            }
            const float ca = p.ca_e[i] ? __ldg(p.ca_e[i] + cell) : p.ca_s_e[i];
            const float cb = p.cb_e[i] ? __ldg(p.cb_e[i] + cell) : p.cb_s_e[i];
            float out = ca * eo[i] + cb * rhs;
            if (!bulk && ((p.pec_lo[j] && c[j] == 0) ||
                          (p.pec_lo[k] && c[k] == 0)))
                out = 0.0f;
            if (t.src[0])
                out = add_sources<BL>(p, 0, i, c, step, out, cp, rc);
            e_ring<NP>(sm, L, x, i)[tid] = out;
            if (owner) p.e_new[cp][i][cell] = out;
            // the pole update on E' (after J) and E of the level below
#pragma unroll
            for (int q = 0; q < NP; ++q) {
                const float are = p.a_re[q], aim = p.a_im[q];
                const int qx = (q * 3 + i) * 2;
                const float qr = q_in[2 * q];
                const float qi = q_in[2 * q + 1];
                const float im_qr = qr * aim;
                float nqr = qr * are + qi * (-aim);
                float nqi = qi * are + im_qr;
                const int kind = p.pole_kind[q * 3 + i];
                if (kind != POLE_ZERO) {
                    const float esum = out + eo[i];
                    if (kind == POLE_MASK) {
                        const float mes = __ldg(p.pole_b[qx] + cell) * esum;
                        nqr = nqr + p.pole_b0[qx] * mes;
                        nqi = nqi + p.pole_b0[qx + 1] * mes;
                    } else {
                        nqr = nqr + __ldg(p.pole_b[qx] + cell) * esum;
                        nqi = nqi + __ldg(p.pole_b[qx + 1] + cell) * esum;
                    }
                }
                if constexpr (L < K) {
                    cr.q[qx] = cr.q_slot[L - 1][qx];
                    cr.q[qx + 1] = cr.q_slot[L - 1][qx + 1];
                    cr.q_slot[L - 1][qx] = nqr;
                    cr.q_slot[L - 1][qx + 1] = nqi;
                } else if (owner) {
                    p.q_out[qx][cell] = nqr;
                    p.q_out[qx + 1][cell] = nqi;
                }
            }
        }
        return;
    }
    if (plane) {
        // a column outside the domain: zeros, never read across a wall
#pragma unroll
        for (int i = 0; i < 3; ++i) e_ring<NP>(sm, L, x, i)[tid] = 0.0f;
    }
    if constexpr (L < K) {
        // nothing computed: hand on the last values (outside the cone)
#pragma unroll
        for (int qx = 0; qx < 6 * NP; ++qx) cr.q[qx] = cr.q_slot[L - 1][qx];
    }
}

// Level L's H plane x: H' and psi_H', into the ring (levels below K) or
// the output set (level K, owned cells).
template <int NP, int L, bool BL>
__device__ __forceinline__ void h_level(const KStepParams& p, const Col& t,
                                        float* sm, int x) {
    int cx;
    const bool plane = plane_of(p, t, x, &cx);
    const int tid = t.ty * TZ + t.tz;
    if (plane && t.in_yz) {
        const int c[3] = {cx, t.cy, t.cz};
        const int cell = (cx + p.xpad) * t.stride0 + t.cy * p.n[2] + t.cz;
        const bool owner = L == K && t.own_yz && x >= t.xb && x < t.xe;
        const bool bulk =
            t.bulk_yz && cx >= p.bulk_lo[0] && cx < p.bulk_hi[0];
        const int step = p.t0 + L - 1;
        const int cp = BL ? t.cp : 0;
        const Rot rc = cell_rot<BL>(p, t, x, cx);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const int j = (i + 1) % 3;
            const int k = (i + 2) % 3;
            const float ek = e_ring<NP>(sm, L, x, k)[tid];
            const float ej = e_ring<NP>(sm, L, x, j)[tid];
            const float d1 =
                (e_fwd<NP>(p, t, sm, L, k, j, x, c, ek, bulk) - ek) *
                inv_step(p, p.inv_h, t.inv_h_yz, j, c);
            const float d2 =
                (e_fwd<NP>(p, t, sm, L, j, k, x, c, ej, bulk) - ej) *
                inv_step(p, p.inv_h, t.inv_h_yz, k, c);
            float rhs = d1 - d2;
#pragma unroll
            for (int slot = 0; slot < 2; ++slot) {
                const int a = slot == 0 ? j : k;
                const int idx = 2 * i + slot;
                int side, loc;
                if (bulk || !slab_of(p.w_h, p.n, a, c, &side, &loc)) continue;
                const int wd = p.w_h[2 * a + side];
                const int pidx = idx * 2 + side;
                const int off = slab_offset(p, a, wd, loc, c);
                const float prev =
                    L == 1 ? load0<BL>(p.psi_in_h[cp][pidx],
                                       p.psi_in_h[1 - cp][pidx], cp, off, rc)
                           : psi_slot<NP>(sm, L - 1, x, 6 + idx)[tid];
                const float v =
                    __ldg(p.pml_b_h[2 * a + side] + loc) * prev +
                    __ldg(p.pml_c_h[2 * a + side] + loc) *
                        (slot == 0 ? d1 : d2);
                rhs = slot == 0 ? rhs + v : rhs - v;
                if (L < K) psi_slot<NP>(sm, L, x, 6 + idx)[tid] = v;
                if (owner) p.psi_out_h[cp][pidx][off] = v;
            }
            const float ho =
                L == 1 ? load0<BL>(p.h_old[cp][i], p.h_old[1 - cp][i], cp,
                                   cell, rc)
                       : h_ring<NP>(sm, L - 1, x, i)[tid];
            const float ca = p.ca_h[i] ? __ldg(p.ca_h[i] + cell) : p.ca_s_h[i];
            const float cb = p.cb_h[i] ? __ldg(p.cb_h[i] + cell) : p.cb_s_h[i];
            float out = ca * ho - cb * rhs;
            if (t.src[1])
                out = add_sources<BL>(p, 1, i, c, step, out, cp, rc);
            if (L < K) h_ring<NP>(sm, L, x, i)[tid] = out;
            if (owner) p.h_new[cp][i][cell] = out;
        }
        return;
    }
    if constexpr (L < K) {
        if (plane) {
#pragma unroll
            for (int i = 0; i < 3; ++i) h_ring<NP>(sm, L, x, i)[tid] = 0.0f;
        }
    }
}

// Levels L..K at march position m. The cone narrows by one cell per level
// on each side: the owned H of level K needs E_L on rows [L - 1, TY - L] and
// planes [xb - (K - L), xe + K - L], and H_L on rows [L - 1, TY - L - 1] and
// planes [xb - (K - L), xe + K - L - 1]. Rows (warps) and planes outside
// skip the level; the ranges nest, so what a level skips no higher level
// reads, its carries included.
template <int NP, int L, bool BL>
__device__ __forceinline__ void levels(const KStepParams& p, const Col& t,
                                       float* sm, int m, Carry<NP>& cr) {
    constexpr int TY = Cfg<NP>::TY;
    const int xe = m - L + 1;
    const bool rows = t.ty >= L - 1 && t.ty <= TY - L;
    if (rows && xe >= t.xb - (K - L) && xe <= t.xe + K - L)
        e_level<NP, L, BL>(p, t, sm, xe, cr);
    __syncthreads();
    if (rows && t.ty < TY - L && xe - 1 >= t.xb - (K - L) &&
        xe - 1 < t.xe + K - L)
        h_level<NP, L, BL>(p, t, sm, xe - 1);
    // level K's H writes no ring, and the next position's level 1 E
    // writes none that it reads (K > 1), so only the lower levels need a
    // barrier here
    if constexpr (L < K) {
        __syncthreads();
        levels<NP, L + 1, BL>(p, t, sm, m, cr);
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

template <int NP, bool BL>
__global__ void __launch_bounds__(TZ * (Cfg<NP>::TY),
                                  (Cfg<NP>::MIN_BLOCKS))
kstep_kernel(const KStepParams p) {
    extern __shared__ float sm[];
    constexpr int TY = Cfg<NP>::TY;
    constexpr int TILE = Cfg<NP>::TILE;
    constexpr int OY = TY - 2 * K + 1;   // owned rows and columns
    constexpr int OZ = TZ - 2 * K + 1;
    Col t;
    t.ty = threadIdx.y;
    t.tz = threadIdx.x;
    const int y0 = blockIdx.y * OY;
    const int z0 = blockIdx.x * OZ;
    // a complex run folds the copy into the x blocks: [copy][x block]
    const int gx = (p.n[0] + BX - 1) / BX;
    t.cp = BL ? (int)blockIdx.z / gx : 0;
    t.xb = ((int)blockIdx.z - t.cp * gx) * BX;
    t.xe = min(t.xb + BX, p.n[0]);
    t.stride0 = p.n[1] * p.n[2];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        t.wrap[a] = p.bk_lo[a] == WALL_WRAP && walled(p, a, 0);
    const int ybase = y0 - (K - 1);
    const int zbase = z0 - (K - 1);
    t.cy = ybase + t.ty;
    t.cz = zbase + t.tz;
    t.own_yz = t.ty >= K - 1 && t.ty < K - 1 + OY && t.tz >= K - 1 &&
               t.tz < K - 1 + OZ && t.cy < p.n[1] && t.cz < p.n[2];
    t.in_yz = true;
    t.rot = {1.0f, 0.0f};
    if (t.cy < 0 || t.cy >= p.n[1]) {
        if (t.wrap[1]) {
            const int uy = t.cy;
            t.cy = wrap_index(uy, p.n[1]);
            if (BL) t.rot = rot_axis(p, 1, (uy - t.cy) / p.n[1]);
        } else {
            t.in_yz = false;
        }
    }
    if (t.cz < 0 || t.cz >= p.n[2]) {
        if (t.wrap[2]) {
            const int uz = t.cz;
            t.cz = wrap_index(uz, p.n[2]);
            if (BL)
                t.rot = rot_mul(t.rot, rot_axis(p, 2, (uz - t.cz) / p.n[2]));
        } else {
            t.in_yz = false;
        }
    }
    // a bulk column's y and z neighbours are domain cells of the same tile
    // or outside the cone of every owned cell
    t.bulk_yz = t.in_yz && t.cy >= p.bulk_lo[1] && t.cy < p.bulk_hi[1] &&
                t.cz >= p.bulk_lo[2] && t.cz < p.bulk_hi[2];
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
    for (int i = t.ty * TZ + t.tz; i < ring_floats<NP>(); i += TILE)
        sm[i] = 0.0f;
    Carry<NP> cr;
#pragma unroll
    for (int l = 0; l < K - 1; ++l) {
#pragma unroll
        for (int qx = 0; qx < Carry<NP>::QN; ++qx) cr.q_slot[l][qx] = 0.0f;
    }
#pragma unroll
    for (int qx = 0; qx < Carry<NP>::QN; ++qx) cr.q[qx] = 0.0f;
    __syncthreads();
    // level j's E plane at m - j + 1: the first owned H plane of level K
    // (xb) needs level 1 from xb - K + 1 on, the last (xe - 1) needs level
    // K's E plane xe
    for (int m = t.xb - K + 1; m <= t.xe + K - 1; ++m)
        levels<NP, 1, BL>(p, t, sm, m, cr);
}

template <int NP, bool BL>
static int launch(const KStepParams* p, cudaStream_t stream) {
    constexpr int TY = Cfg<NP>::TY;
    constexpr int TILE = Cfg<NP>::TILE;
    constexpr int OY = TY - 2 * K + 1;
    constexpr int OZ = TZ - 2 * K + 1;
    const int64_t gz = (p->n[2] + OZ - 1) / OZ;
    const int64_t gy = (p->n[1] + OY - 1) / OY;
    const int64_t gx = (p->n[0] + BX - 1) / BX * (BL ? 2 : 1);
    if (gy > 65535 || gx > 65535) return (int)cudaErrorInvalidConfiguration;
    const size_t smem =
        (size_t)(ring_floats<NP>() + (K - 1) * 2 * 12 * TILE) *
        sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kstep_kernel<NP, BL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)gz, (unsigned)gy, (unsigned)gx);
    const dim3 block(TZ, TY);
    kstep_kernel<NP, BL><<<grid, block, smem, stream>>>(*p);
    return (int)cudaGetLastError();
}

// The kernel for NP = p->num_poles pole slots.
template <int NP>
static int launch_poles(const KStepParams* p, cudaStream_t stream) {
    if (p->num_poles == NP) return launch<NP, false>(p, stream);
    if constexpr (NP < MAX_POLES) return launch_poles<NP + 1>(p, stream);
    return (int)cudaErrorInvalidValue;
}

extern "C" int t3d_kstep_params_size() { return (int)sizeof(KStepParams); }

extern "C" int t3d_kstep_group(const KStepParams* p, void* stream) {
    if (p->n[0] <= 0 || p->n[1] <= 0 || p->n[2] <= 0) return 0;
    if (p->k != K || p->num_poles < 0 || p->num_poles > MAX_POLES ||
        p->num_src[0] < 0 || p->num_src[1] < 0 || p->t0 < 0 ||
        p->t0 + K > p->wf_len || p->ncopy < 1 || p->ncopy > 2 ||
        (p->ncopy == 2 && p->num_poles != 0) ||
        (p->xpad != 0 && (p->xpad != K || p->ncopy != 1)) ||
        ((p->x_halo[0] || p->x_halo[1]) && p->xpad == 0) ||
        (int64_t)(p->n[0] + 2 * p->xpad) * p->n[1] * p->n[2] > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    // a complex run: the two-copy instantiation, pole-free only
    if (p->ncopy == 2) return launch<0, true>(p, (cudaStream_t)stream);
    return launch_poles<0>(p, (cudaStream_t)stream);
}
