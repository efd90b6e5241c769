// The field kernels' plan (ensemble.cu): their tiles, the shared memory of
// a block, the layout of K3's scratch and rest row, and the grids of a
// launch. The one statement of them: the library's launchers size their
// grids from it and vmap_field_plan gives the wrapper (kernels/ensemble.py
// field_plan) its grids and buffer sizes. It compiles on a host compiler
// alone too (tests/test_torch_field_design.py builds it with g++ and holds
// the plans and grids at the H100's 132 SMs).

#pragma once

#include "common.cuh"

namespace {

constexpr int WP = STAGED_PIECES;   // staged planes of the weights' pieces
constexpr int NB = 2;          // pieces of the gradients' product operands
constexpr int EROWS = 96;      // the embedding region's rows (up16(87))
constexpr int EBROWS = 48;     // emb_b's rows in it (up16(h + 42) - h)

// ---- the tiles. NT threads, MINB blocks an SM, P points a tile (a
// multiple of 8 FWN and of 8 DWN), NF the forward's pieces (K2 two, three
// passes; K3 three, six passes: its ReLU masks must fall where the f32
// plain version's do, or a gradient moves by a whole element's share), RES:
// the weights resident in shared memory, else KF columns a forward slab and
// KB rows an input-gradient slab; (FWM, FWN, FMU) the forward's warp tile
// (16-row x 8-point mma tiles) and the most units a warp holds, (DWM, DWN,
// DMU) the input gradients'.
template <int H, bool BWD>
struct FTile;
template <>
struct FTile<32, false> {   // two blocks an SM: one hides the other's barriers
  static constexpr bool RES = true;
  static constexpr int NF = 2, NT = 256, MINB = 2, P = 64, KF = 0, KB = 0;
  static constexpr int FWM = 1, FWN = 2, FMU = 1, DWM = 1, DWN = 2, DMU = 1;
};
template <>
struct FTile<128, false> {
  static constexpr bool RES = false;
  static constexpr int NF = 2, NT = 256, MINB = 1, P = 128, KF = 64, KB = 0;
  static constexpr int FWM = 2, FWN = 4, FMU = 2, DWM = 1, DWN = 2, DMU = 1;
};
template <>
struct FTile<256, false> {
  static constexpr bool RES = false;
  static constexpr int NF = 2, NT = 256, MINB = 1, P = 96, KF = 32, KB = 0;
  static constexpr int FWM = 2, FWN = 4, FMU = 3, DWM = 1, DWN = 2, DMU = 1;
};
template <>
struct FTile<32, true> {
  static constexpr bool RES = true;
  static constexpr int NF = 3, NT = 512, MINB = 1, P = 128, KF = 0, KB = 0;
  static constexpr int FWM = 1, FWN = 2, FMU = 1, DWM = 2, DWN = 2, DMU = 2;
};
template <>
struct FTile<128, true> {
  static constexpr bool RES = false;
  static constexpr int NF = 3, NT = 512, MINB = 1, P = 64, KF = 32, KB = 16;
  static constexpr int FWM = 2, FWN = 2, FMU = 1, DWM = 2, DWN = 2, DMU = 2;
};
template <>
struct FTile<256, true> {
  static constexpr bool RES = false;
  static constexpr int NF = 3, NT = 512, MINB = 1, P = 48, KF = 16, KB = 16;
  static constexpr int FWM = 2, FWN = 2, FMU = 2, DWM = 2, DWN = 2, DMU = 3;
};

__host__ __device__ constexpr int mat_rows(int H, int m) {
  return up16(mat_out(H, m));
}
__host__ __device__ constexpr int mat_cols(int H, int m) {
  return up16(mat_in(H, m));
}
// the resident weights (RES): matrix m's NP pieces [NP][rows][cols + 8] at
// res_off(H, m, NP), elements
__host__ __device__ constexpr int res_off(int H, int m, int NP) {
  int s = 0;
  for (int i = 0; i < m; ++i) s += NP * mat_rows(H, i) * (mat_cols(H, i) + 8);
  return s;
}
__host__ __device__ constexpr size_t a16(size_t b) {
  return (b + 15) / 16 * 16;
}

// K3's bias and dirs gradients, a block's rest row (the order of
// kernels/ensemble.py W_NAMES, the product weights left out): dirs
// [21][3], b_in, b_mid1, b_cat, b_mid2 [H], b_alpha, b_col [H], b_out [3]
__host__ __device__ constexpr int rest_floats(int H) {
  return (3 * NDIR + 5 * H + 4 + 3) / 4 * 4;   // 63 + 5 H + 4, to 4
}
enum { R_DIRS = 0 };
__host__ __device__ constexpr int r_b_in(int H) { return 3 * NDIR; }
__host__ __device__ constexpr int r_b_mid1(int H) { return 3 * NDIR + H; }
__host__ __device__ constexpr int r_b_cat(int H) { return 3 * NDIR + 2 * H; }
__host__ __device__ constexpr int r_b_mid2(int H) { return 3 * NDIR + 3 * H; }
__host__ __device__ constexpr int r_b_alpha(int H) { return 3 * NDIR + 4 * H; }
__host__ __device__ constexpr int r_b_col(int H) {
  return 3 * NDIR + 4 * H + 1;
}
__host__ __device__ constexpr int r_b_out(int H) {
  return 3 * NDIR + 5 * H + 1;
}

// K3's scratch, per object [NB][scratch_rows][Mp] bf16 pieces: the
// activations x (the weight gradients' columns) then the pre-activation
// gradients d (their rows), each row the object's Mp points
__host__ __device__ constexpr int xr_ea(int) { return 0; }            // 96
__host__ __device__ constexpr int xr_eb(int) { return EROWS; }        // 48
__host__ __device__ constexpr int xr_h(int H, int l) {                // h1..h4
  return EROWS + EBROWS + (l - 1) * H;
}
__host__ __device__ constexpr int xr_c(int H) { return EROWS + EBROWS + 4 * H; }
__host__ __device__ constexpr int dr_out(int H) { return xr_c(H) + H; }   // 16
__host__ __device__ constexpr int dr_alpha(int H) { return dr_out(H) + 16; }
__host__ __device__ constexpr int dr_c(int H) { return dr_out(H) + 32; }
__host__ __device__ constexpr int dr_h(int H, int l) {   // dh4..dh1
  return dr_c(H) + (5 - l) * H;
}
__host__ __device__ constexpr int scratch_rows(int H) { return dr_h(H, 1) + H; }

// the scratch row of staged matrix m's gradient row i, and of its column k
__host__ __device__ constexpr int d_row(int H, int m, int i) {
  return (m == M_IN      ? dr_h(H, 1)
          : m == M_MID1  ? dr_h(H, 2)
          : m == M_CAT   ? dr_h(H, 3)
          : m == M_MID2  ? dr_h(H, 4)
          : m == M_ALPHA ? dr_alpha(H)
          : m == M_COL   ? dr_c(H)
                         : dr_out(H)) + i;
}
__host__ __device__ constexpr int x_row(int H, int m, int k) {
  return m == M_IN      ? xr_ea(H) + k
         : m == M_MID1  ? xr_h(H, 1) + k
         : m == M_CAT   ? (k < H ? xr_h(H, 2) + k : xr_ea(H) + k - H)
         : m == M_MID2  ? xr_h(H, 3) + k
         : m == M_ALPHA ? xr_h(H, 4) + k
         : m == M_COL   ? (k < H ? xr_h(H, 4) + k : xr_eb(H) + k - H)
                        : xr_c(H) + k;
}

// ---- the shared-memory plan of a tile (bytes from the dynamic base):
// the weights (RES: all seven matrices' NF pieces; else two slabs, the
// larger of a forward slab [NF][H][KF + 8] and an input-gradient slab
// [NB][KB][up16(H + 87) + 8]), the embedding region [NF][96][P + 8] and
// the activation buffer [NF][H][P + 8] (bf16), then f32 rows of P: K2 xs
// [3], the heads' outputs [4]; K3 xs [3], proj, dproj [21], the heads [4],
// the rest row, and h1..h4's ReLU masks as bits [4][H][ceil(P / 64)][2]
// (u32: the even points' bits, then the odd ones')
template <int H, bool BWD>
struct Plan {
  using T = FTile<H, BWD>;
  static constexpr int P = T::P, LDB = P + 8, NF = T::NF;
  static constexpr size_t slab =
      (size_t)2 *
      (T::RES ? 0
              : ((size_t)NF * H * (T::KF + 8) >
                         (size_t)NB * T::KB * (up16(H + EMB1) + 8)
                     ? (size_t)NF * H * (T::KF + 8)
                     : (size_t)NB * T::KB * (up16(H + EMB1) + 8)));
  static constexpr size_t w = T::RES ? a16(2 * (size_t)res_off(H, NMAT, NF))
                                     : 2 * slab;
  static constexpr size_t emb = w;
  static constexpr size_t act = emb + a16((size_t)NF * EROWS * LDB * 2);
  static constexpr size_t f32 = act + a16((size_t)NF * H * LDB * 2);
  static constexpr int F32_ROWS = BWD ? 3 + 2 * NDIR + 4 : 7;
  static constexpr size_t rest = f32 + a16((size_t)4 * F32_ROWS * P);
  static constexpr int NSEG = (P + 63) / 64;
  static constexpr size_t mask =
      rest + (BWD ? a16((size_t)4 * rest_floats(H)) : 0);
  static constexpr size_t bytes =
      mask + (BWD ? (size_t)4 * 4 * H * NSEG * 2 : 0);
};

// f32 band-gradient rows in K3's embedding region: [84][LDF]
template <int P>
__host__ __device__ constexpr int band_ld() { return P + 4; }

// ---- K3's weight-gradient kernel: 256 threads, output tiles of TI rows
// (32 at h=32, else 128) x 128 columns, 32 points a step, 4 stages; its
// launch bound and ring allow wg_minb blocks an SM
constexpr int WG_NT = 256, WG_TK = 128, WG_KP = 32, WG_ST = 4,
              WG_LD = WG_KP + 8;
__host__ __device__ constexpr int wg_ti(int H) { return H == 32 ? 32 : 128; }
__host__ __device__ constexpr int wg_tiles(int H, int m) {
  return (mat_rows(H, m) + wg_ti(H) - 1) / wg_ti(H) *
         ((mat_cols(H, m) + WG_TK - 1) / WG_TK);
}
__host__ __device__ constexpr int wg_tiles(int H) {
  int s = 0;
  for (int m = 0; m < NMAT; ++m) s += wg_tiles(H, m);
  return s;
}
// the ring [WG_ST][NB][TI + TK][WG_LD] bf16, then the panels' row
// pointers [TI + TK]
__host__ __device__ constexpr size_t wg_smem(int H) {
  return (size_t)WG_ST * NB * (wg_ti(H) + WG_TK) * WG_LD * 2 +
         (size_t)8 * (wg_ti(H) + WG_TK);
}
__host__ __device__ constexpr int wg_minb(int H) { return H == 32 ? 2 : 1; }

// Every plan within a block's shared memory, the blocks an SM each launch
// bound asks for within the SM's, the tiles whole 16-point mma steps, and
// K3's band gradients (84 f32 rows of band_ld) within its embedding region
template <int H>
constexpr bool plans_fit() {
  using F = FTile<H, false>;
  using B = FTile<H, true>;
  return Plan<H, false>::bytes <= SMEM_MAX && Plan<H, true>::bytes <= SMEM_MAX &&
         wg_smem(H) <= SMEM_MAX &&
         F::MINB * (Plan<H, false>::bytes + BLOCK_RESERVED) <= SM_SMEM &&
         B::MINB * (Plan<H, true>::bytes + BLOCK_RESERVED) <= SM_SMEM &&
         wg_minb(H) * (wg_smem(H) + BLOCK_RESERVED) <= SM_SMEM &&
         F::P % 16 == 0 && B::P % 16 == 0 &&
         4 * 4 * NDIR * band_ld<B::P>() <= 2 * B::NF * EROWS * (B::P + 8);
}
static_assert(plans_fit<32>() && plans_fit<128>() && plans_fit<256>(),
              "a field kernel's plan exceeds the shared memory it counts on");

// ---- the grids of a launch on O objects x M points on an SM count `sms`
constexpr int PLAN_INVALID = 1;   // cudaErrorInvalidValue

inline bool plan_args_ok(int sms, int O, int M, int tile_m) {
  return sms >= 1 && O >= 1 && O <= 65535 && M >= 1 && M <= (1 << 30) &&
         tile_m >= WG_KP && tile_m % WG_KP == 0;
}

// K2: one wave of sms x MINB blocks (fewer where there are fewer tiles),
// block b taking a contiguous run of the O ceil(M / P) (object, tile) pairs
template <int H>
int fwd_blocks(int sms, int O, int M) {
  using T = FTile<H, false>;
  const long long items = (long long)O * ((M + T::P - 1) / T::P);
  const long long cap = (long long)sms * T::MINB;
  return (int)(items < cap ? items : cap);
}

constexpr int gcd_(int a, int b) { return b ? gcd_(b, a % b) : a; }

// K3: Mp, M to a multiple of field_bwd's tile and of 128 points (each
// scratch row 256-byte aligned); field_bwd's blocks an object, min(Mp / P,
// max(1, sms / O)) (one an SM, one wave); field_wgrad's unit, tile_m
// halved (to multiples of WG_KP) while ceil(Mp / unit) units a weight tile
// would not fill sms x wg_minb blocks, and its splits, the most that fit
// that wave, at least 1 and at most the units
struct BwdGrid {
  int Mp, per_obj, unit, splits;
};
template <int H>
BwdGrid bwd_grid(int sms, int O, int M, int tile_m) {
  constexpr int P = FTile<H, true>::P, STEP = P / gcd_(P, 128) * 128;
  BwdGrid g;
  g.Mp = (M + STEP - 1) / STEP * STEP;
  const int per = sms / O > 1 ? sms / O : 1;
  g.per_obj = g.Mp / P < per ? g.Mp / P : per;
  const long long tiles = (long long)wg_tiles(H) * O;
  const long long target = (long long)sms * wg_minb(H);
  g.unit = tile_m;
  while ((g.Mp + g.unit - 1) / g.unit * tiles < target &&
         g.unit / 2 >= WG_KP && g.unit / 2 % WG_KP == 0)
    g.unit /= 2;
  const long long units = (g.Mp + g.unit - 1) / g.unit;
  const long long fit = target / tiles;
  g.splits = (int)(units < fit ? units : fit);
  if (g.splits < 1) g.splits = 1;
  return g;
}

// vmap_field_plan's output, in this order (kernels/ensemble.py PLAN names
// it): each kernel's points a tile, threads, dynamic shared memory, blocks
// an SM and blocks (field_bwd's an object); Mp, the weight-gradient tiles
// an object, the unit and the splits; K3's scratch's pieces and rows and
// its rest row's floats
enum PlanField : int {
  PL_FWD_POINTS, PL_FWD_THREADS, PL_FWD_SMEM, PL_FWD_MINB, PL_FWD_BLOCKS,
  PL_BWD_POINTS, PL_BWD_THREADS, PL_BWD_SMEM, PL_BWD_MINB,
  PL_BWD_BLOCKS_PER_OBJECT, PL_MP, PL_WG_TILES, PL_WG_THREADS, PL_WG_SMEM,
  PL_WG_MINB, PL_UNIT, PL_SPLITS, PL_SCRATCH_PIECES, PL_SCRATCH_ROWS,
  PL_REST_FLOATS, PL_N
};

template <int H>
void plan_at(int sms, int O, int M, int tile_m, int* out) {
  using F = FTile<H, false>;
  using B = FTile<H, true>;
  const BwdGrid g = bwd_grid<H>(sms, O, M, tile_m);
  out[PL_FWD_POINTS] = F::P;
  out[PL_FWD_THREADS] = F::NT;
  out[PL_FWD_SMEM] = (int)Plan<H, false>::bytes;
  out[PL_FWD_MINB] = F::MINB;
  out[PL_FWD_BLOCKS] = fwd_blocks<H>(sms, O, M);
  out[PL_BWD_POINTS] = B::P;
  out[PL_BWD_THREADS] = B::NT;
  out[PL_BWD_SMEM] = (int)Plan<H, true>::bytes;
  out[PL_BWD_MINB] = B::MINB;
  out[PL_BWD_BLOCKS_PER_OBJECT] = g.per_obj;
  out[PL_MP] = g.Mp;
  out[PL_WG_TILES] = wg_tiles(H);
  out[PL_WG_THREADS] = WG_NT;
  out[PL_WG_SMEM] = (int)wg_smem(H);
  out[PL_WG_MINB] = wg_minb(H);
  out[PL_UNIT] = g.unit;
  out[PL_SPLITS] = g.splits;
  out[PL_SCRATCH_PIECES] = NB;
  out[PL_SCRATCH_ROWS] = scratch_rows(H);
  out[PL_REST_FLOATS] = rest_floats(H);
}

// The plan of a launch at width H into out[PL_N]; PLAN_INVALID for a width
// without kernels or arguments the kernels refuse
inline int field_plan(int H, int sms, int O, int M, int tile_m, int* out) {
  if (!plan_args_ok(sms, O, M, tile_m)) return PLAN_INVALID;
  if (H == 32)
    plan_at<32>(sms, O, M, tile_m, out);
  else if (H == 128)
    plan_at<128>(sms, O, M, tile_m, out);
  else if (H == 256)
    plan_at<256>(sms, O, M, tile_m, out);
  else
    return PLAN_INVALID;
  return 0;
}

}  // namespace
