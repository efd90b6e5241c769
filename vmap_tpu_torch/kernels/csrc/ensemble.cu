// Hand-written CUDA field kernels: the forward field query of a bank of
// occupancy MLPs at arbitrary points (meshing, vertex colours, the field
// training path) and its hand-derived backward (sm_90a, plain C interface,
// loaded with ctypes).
//
// Replaces the TPU kernels of vmap_tpu/kernels/ensemble.py:
//   field_fwd_kernel  <- _make_fwd_kernel, launched by _run_fwd      (K2)
//   field_bwd_kernel  <- _make_bwd_kernel, launched by _fused_train_bwd (K3)
//
// Both read one object's prepared parameters (prepare_params: the 87 / 42
// embedding columns padded to 128, the concat layers split) from a packed
// row [n_params] per object, at the offsets the wrapper passes; the padded
// columns never enter a sum. Per point (feature-major in shared memory,
// points fastest):
//   xs = pts / scale, proj = dirs xs, emb = [xs; sin(pi 2^b proj), b < 6]
//   h1 = relu(W_in emb_a + b), h2 = relu(W_mid1 h1 + b),
//   h3 = relu(W_cat_h h2 + W_cat_x emb_a + b), h4 = relu(W_mid2 h3 + b),
//   alpha = 10 (W_alpha h4 + b), c = relu(W_col_h h4 + W_col_x emb_b + b),
//   colour = sigmoid(W_out c + b).
//
// field_fwd_kernel: grid (point tile, object). Meshing is large in points
// and small in objects (one background object, or the iMAP scene field,
// carries 256^3 points), so the grid spreads over point tiles. Each thread
// computes an RI x PJ register tile of a layer's outputs; the 32 lanes of
// a warp share their output rows, so every weight load is one broadcast from L1 / L2 (the
// h=128 weights, ~450 KB, do not fit in shared memory and are not copied
// there; neither are the h=256 ones, 1.3 MB), and read consecutive points
// of the activation block. Built for h = 32, 128 and 256.
//
// field_bwd_kernel: grid (chunk of tile_m points, object). A block
// recomputes the forward of each TP-point sub-tile of its chunk, runs the
// backward, and adds the sub-tile's weight gradients into its own partial
// row grad_part[object, chunk, :] in a fixed order. The host sums the
// partials over chunks in a fixed order: no atomics, deterministic.
// Points past M and their cotangents are zero, so they add nothing. Built
// for h = 32, 128 and 256. At h=256 a 32-point sub-tile's activations and
// their gradients take 203 KB, one block per SM; as in field_fwd, the
// weights (1.3 MB) stay in L2 and are read as L1 broadcasts, never copied
// to shared memory, so only the sub-tile has to fit.
//
// What bounds them on the card: FP32 FMA issue and the load instructions
// that feed it (one broadcast weight load per RI FMAs per point group), no
// tensor cores, so the f32 policy stays IEEE. sinpif / cospif keep the
// band-5 argument 32 pi |proj| exact; the build does not use fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;           // threads per block
constexpr int EMB_PAD = 128;      // row stride of w_in / w_cat_x / w_col_x
constexpr int N_PREP = 17;        // prepared tensors per object

// Offsets of the prepared tensors inside one object's packed row, in the
// order of kernels/ensemble.py W_NAMES.
struct Prep {
  int dirs, w_in, b_in, w_mid1, b_mid1, w_cat_h, w_cat_x, b_cat, w_mid2,
      b_mid2, w_alpha, b_alpha, w_col_h, b_col, w_out, b_out, w_col_x;
};

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_MASK = 2 };

// One operand of a product: A(r, k) = a[r * rs + k * cs], contracted with
// rows x[k][.] (k < n) of an activation block in shared memory.
struct Operand {
  const float* a;
  int rs, cs;
  const float* x;
  int n;
};

template <int LDP, int RI, int PJ, int PG>
__device__ __forceinline__ void accumulate(float (&acc)[RI][PJ],
                                           const Operand& o, int r0, int pg) {
  const float* __restrict__ a = o.a + (size_t)r0 * o.rs;
  for (int k = 0; k < o.n; ++k) {
    float x[PJ];
#pragma unroll
    for (int j = 0; j < PJ; ++j) x[j] = o.x[k * LDP + pg + j * PG];
#pragma unroll
    for (int t = 0; t < RI; ++t) {
      const float w = __ldg(a + t * o.rs + k * o.cs);
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[t][j] = fmaf(w, x[j], acc[t][j]);
    }
  }
}

// out[r][p] = act(bias[r] + sum_k A1(r,k) x1[k][p] + sum_k A2(r,k) x2[k][p])
// for r < n_out (n_out % RI == 0), p < TP. ACT_MASK keeps the sum where
// out[r][p] > 0 and writes 0 elsewhere (the ReLU backward, in place over
// the activation). Thread item: rows r0..r0+RI, points pg + j*PG.
template <int TP, int LDP, int RI, int PJ>
__device__ void product(int n_out, const float* __restrict__ bias,
                        const Operand o1, const Operand o2, float* out,
                        int act) {
  constexpr int PG = TP / PJ;
  static_assert(PG % 32 == 0, "a warp must share its output rows");
  const int n_items = (n_out / RI) * PG;
  for (int idx = threadIdx.x; idx < n_items; idx += NT) {
    const int pg = idx % PG, r0 = (idx / PG) * RI;
    float acc[RI][PJ];
#pragma unroll
    for (int t = 0; t < RI; ++t) {
      const float b = bias ? __ldg(bias + r0 + t) : 0.f;
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[t][j] = b;
    }
    accumulate<LDP, RI, PJ, PG>(acc, o1, r0, pg);
    if (o2.n) accumulate<LDP, RI, PJ, PG>(acc, o2, r0, pg);
#pragma unroll
    for (int t = 0; t < RI; ++t) {
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        float* q = out + (r0 + t) * LDP + pg + j * PG;
        const float v = acc[t][j];
        *q = act == ACT_RELU ? fmaxf(v, 0.f)
                             : (act == ACT_MASK ? (*q > 0.f ? v : 0.f) : v);
      }
    }
  }
}

// emb rows 0..2 = xs = pts / scale (0 past M), rows 3 + 21 b + j =
// sin(pi 2^b proj_j); proj (if given) keeps the projection.
template <int TP, int LDP>
__device__ void load_embed(const float* __restrict__ pts, float sc,
                           const float* __restrict__ W, const Prep& off,
                           int M, int p0, float* emb, float* proj) {
  for (int p = threadIdx.x; p < TP; p += NT) {
    const int gp = p0 + p;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (gp < M) {
      const float* q = pts + (size_t)gp * 3;
      x0 = q[0] / sc;
      x1 = q[1] / sc;
      x2 = q[2] / sc;
    }
    emb[p] = x0;
    emb[LDP + p] = x1;
    emb[2 * LDP + p] = x2;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NDIR * TP; idx += NT) {
    const int j = idx / TP, p = idx % TP;
    const float* d = W + off.dirs + j * 3;
    const float pr = emb[p] * __ldg(d) + emb[LDP + p] * __ldg(d + 1) +
                     emb[2 * LDP + p] * __ldg(d + 2);
    if (proj) proj[j * LDP + p] = pr;
#pragma unroll
    for (int b = 0; b < NBAND; ++b)
      emb[(3 + b * NDIR + j) * LDP + p] = sinpif(pr * (float)(1 << b));
  }
  __syncthreads();
}

// The MLP chain. out4 row 0 = the alpha layer's raw output, rows 1..3 the
// colour logits. Buffers may alias as long as no layer reads the buffer it
// writes (the forward kernel ping-pongs two).
template <int H, int TP, int LDP, int RI, int PJ>
__device__ void field_forward(const float* __restrict__ W, const Prep& off,
                              const float* emb, float* h1, float* h2,
                              float* h3, float* h4, float* c, float* out4) {
  product<TP, LDP, RI, PJ>(H, W + off.b_in,
                           Operand{W + off.w_in, EMB_PAD, 1, emb, EMB1},
                           Operand{}, h1, ACT_RELU);
  __syncthreads();
  product<TP, LDP, RI, PJ>(H, W + off.b_mid1,
                           Operand{W + off.w_mid1, H, 1, h1, H}, Operand{},
                           h2, ACT_RELU);
  __syncthreads();
  product<TP, LDP, RI, PJ>(H, W + off.b_cat,
                           Operand{W + off.w_cat_h, H, 1, h2, H},
                           Operand{W + off.w_cat_x, EMB_PAD, 1, emb, EMB1},
                           h3, ACT_RELU);
  __syncthreads();
  product<TP, LDP, RI, PJ>(H, W + off.b_mid2,
                           Operand{W + off.w_mid2, H, 1, h3, H}, Operand{},
                           h4, ACT_RELU);
  __syncthreads();
  product<TP, LDP, RI, PJ>(
      H, W + off.b_col, Operand{W + off.w_col_h, H, 1, h4, H},
      Operand{W + off.w_col_x, EMB_PAD, 1, emb + EMB1 * LDP, EMB2}, c,
      ACT_RELU);
  product<TP, LDP, 1, PJ>(1, W + off.b_alpha,
                          Operand{W + off.w_alpha, H, 1, h4, H}, Operand{},
                          out4, ACT_NONE);
  __syncthreads();
  product<TP, LDP, 1, PJ>(3, W + off.b_out, Operand{W + off.w_out, H, 1, c, H},
                          Operand{}, out4 + LDP, ACT_NONE);
  __syncthreads();
}

template <int H, int TP, int RI, int PJ>
__global__ void __launch_bounds__(NT)
field_fwd_kernel(const float* __restrict__ params, int n_params, Prep off,
                 const float* __restrict__ scale,   // [O]
                 const float* __restrict__ pts,     // [O, M, 3]
                 int M,
                 float* __restrict__ alpha,         // [O, M]
                 float* __restrict__ color) {       // [O, M, 3]
  constexpr int LDP = TP;
  const int o = blockIdx.y;
  const int p0 = blockIdx.x * TP;
  extern __shared__ float sm[];
  float* emb = sm;                // [EMB][LDP]
  float* A = emb + EMB * LDP;     // [H][LDP]  h1, h3, c
  float* B = A + H * LDP;         // [H][LDP]  h2, h4
  float* out4 = B + H * LDP;      // [4][LDP]
  const float* W = params + (size_t)o * n_params;
  load_embed<TP, LDP>(pts + (size_t)o * M * 3, scale[o], W, off, M, p0, emb,
                      nullptr);
  field_forward<H, TP, LDP, RI, PJ>(W, off, emb, A, B, A, B, A, out4);
  for (int idx = threadIdx.x; idx < 4 * TP; idx += NT) {
    const int r = idx / TP, p = idx % TP, gp = p0 + p;
    if (gp >= M) continue;
    const float v = out4[r * LDP + p];
    const size_t q = (size_t)o * M + gp;
    if (r == 0)
      alpha[q] = v * 10.f;
    else
      color[q * 3 + (r - 1)] = sigmoidf_(v);
  }
}

// G[r * ldg + k] += sum_{p < TP} d[r][p] x[k][p]  (r < n_out, n_out % RI
// == 0, k < NIN). The lanes of a warp take 32 consecutive k (row stride
// LDP is odd: conflict-free) and share their rows r (broadcast reads).
template <int TP, int LDP, int RI, int NIN>
__device__ void wgrad(float* __restrict__ G, int ldg, const float* d,
                      int n_out, const float* x) {
  constexpr int KJ = (NIN + 31) / 32;
  const int n_items = (n_out / RI) * 32;
  for (int idx = threadIdx.x; idx < n_items; idx += NT) {
    const int kg = idx % 32, r0 = (idx / 32) * RI;
    if (kg >= NIN) continue;
    float acc[RI][KJ] = {};
    const float* xr[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int k = kg + 32 * j;
      xr[j] = x + (k < NIN ? k : kg) * LDP;
    }
#pragma unroll 4
    for (int p = 0; p < TP; ++p) {
      float xv[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) xv[j] = xr[j][p];
#pragma unroll
      for (int t = 0; t < RI; ++t) {
        const float dv = d[(r0 + t) * LDP + p];
#pragma unroll
        for (int j = 0; j < KJ; ++j) acc[t][j] = fmaf(dv, xv[j], acc[t][j]);
      }
    }
#pragma unroll
    for (int t = 0; t < RI; ++t)
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        if (kg + 32 * j < NIN)
          G[(size_t)(r0 + t) * ldg + kg + 32 * j] += acc[t][j];
  }
}

// G[r] += sum_p d[r][p]   (bias gradients)
template <int TP, int LDP>
__device__ void bgrad(float* __restrict__ G, const float* d, int n_out) {
  for (int r = threadIdx.x; r < n_out; r += NT) {
    float acc = 0.f;
    for (int p = 0; p < TP; ++p) acc += d[r * LDP + p];
    G[r] += acc;
  }
}

// dproj[j][p] (= 0 if init) += sum_{b < nb} pi 2^(b0+b)
//     cos(pi 2^(b0+b) proj[j][p]) tmp[b * 21 + j][p]
template <int TP, int LDP>
__device__ void fold_bands(float* dproj, const float* proj, const float* tmp,
                           int b0, int nb, bool init) {
  for (int idx = threadIdx.x; idx < NDIR * TP; idx += NT) {
    const int j = idx / TP, p = idx % TP;
    const float pr = proj[j * LDP + p];
    float acc = init ? 0.f : dproj[j * LDP + p];
    for (int b = 0; b < nb; ++b) {
      const float f = (float)(1 << (b0 + b));
      acc += (PI_F * f) * cospif(pr * f) * tmp[(b * NDIR + j) * LDP + p];
    }
    dproj[j * LDP + p] = acc;
  }
}

template <int H, int TP, int RI, int PJ>
__global__ void __launch_bounds__(NT)
field_bwd_kernel(const float* __restrict__ params, int n_params, Prep off,
                 const float* __restrict__ scale,     // [O]
                 const float* __restrict__ pts,       // [O, M, 3]
                 const float* __restrict__ g_alpha,   // [O, M]
                 const float* __restrict__ g_color,   // [O, M, 3]
                 int M, int tile_m,
                 float* __restrict__ grad_part) {     // [O, n_chunks, NP]
  constexpr int LDP = TP + 1;   // odd: conflict-free column reads in wgrad
  const int chunk = blockIdx.x, n_chunks = gridDim.x, o = blockIdx.y;
  extern __shared__ float sm[];
  float* emb = sm;                   // [EMB][LDP]
  float* proj = emb + EMB * LDP;     // [NDIR][LDP]
  float* dproj = proj + NDIR * LDP;  // [NDIR][LDP]
  float* h1 = dproj + NDIR * LDP;    // [H][LDP] each; overwritten by their
  float* h2 = h1 + H * LDP;          // pre-activation gradients on the way
  float* h3 = h2 + H * LDP;          // back
  float* h4 = h3 + H * LDP;
  float* c = h4 + H * LDP;
  float* lg = c + H * LDP;           // [4][LDP] alpha / logits, then grads
  float* tmp = lg + 4 * LDP;         // [4 NDIR][LDP] embedding-band grads

  const float* W = params + (size_t)o * n_params;
  float* G = grad_part + ((size_t)o * n_chunks + chunk) * n_params;
  for (int i = threadIdx.x; i < n_params; i += NT) G[i] = 0.f;
  const float sc = scale[o];
  const float* P = pts + (size_t)o * M * 3;
  const int p_end = min(M, (chunk + 1) * tile_m);

  for (int p0 = chunk * tile_m; p0 < p_end; p0 += TP) {
    load_embed<TP, LDP>(P, sc, W, off, M, p0, emb, proj);
    field_forward<H, TP, LDP, RI, PJ>(W, off, emb, h1, h2, h3, h4, c, lg);

    // cotangents: d alpha-layer = 10 g_alpha, d logits = g_c s (1 - s)
    for (int p = threadIdx.x; p < TP; p += NT) {
      const int gp = p0 + p;
      const bool ok = gp < M;
      const size_t q = (size_t)o * M + gp;
      lg[p] = ok ? g_alpha[q] * 10.f : 0.f;
      for (int k = 0; k < 3; ++k) {
        const float s = sigmoidf_(lg[(1 + k) * LDP + p]);
        const float g = ok ? g_color[q * 3 + k] : 0.f;
        lg[(1 + k) * LDP + p] = g * s * (1.f - s);
      }
    }
    __syncthreads();
    wgrad<TP, LDP, 1, H>(G + off.w_out, H, lg + LDP, 3, c);
    bgrad<TP, LDP>(G + off.b_out, lg + LDP, 3);
    wgrad<TP, LDP, 1, H>(G + off.w_alpha, H, lg, 1, h4);
    bgrad<TP, LDP>(G + off.b_alpha, lg, 1);
    __syncthreads();
    // dc = relu'(c) W_out^T dlogits
    product<TP, LDP, RI, PJ>(H, nullptr, Operand{W + off.w_out, 1, H, lg + LDP, 3},
                             Operand{}, c, ACT_MASK);
    __syncthreads();
    wgrad<TP, LDP, 4, H>(G + off.w_col_h, H, c, H, h4);
    wgrad<TP, LDP, 4, EMB2>(G + off.w_col_x, EMB_PAD, c, H, emb + EMB1 * LDP);
    bgrad<TP, LDP>(G + off.b_col, c, H);
    __syncthreads();
    // dh4 = relu'(h4) (W_col_h^T dc + W_alpha^T dalpha); bands 4, 5 of
    // d emb_b = W_col_x^T dc
    product<TP, LDP, RI, PJ>(H, nullptr, Operand{W + off.w_col_h, 1, H, c, H},
                             Operand{W + off.w_alpha, 1, H, lg, 1}, h4,
                             ACT_MASK);
    product<TP, LDP, 2, PJ>(2 * NDIR, nullptr,
                            Operand{W + off.w_col_x, 1, EMB_PAD, c, H},
                            Operand{}, tmp, ACT_NONE);
    __syncthreads();
    fold_bands<TP, LDP>(dproj, proj, tmp, 4, 2, true);
    wgrad<TP, LDP, 4, H>(G + off.w_mid2, H, h4, H, h3);
    bgrad<TP, LDP>(G + off.b_mid2, h4, H);
    __syncthreads();
    // dh3 = relu'(h3) W_mid2^T dh4
    product<TP, LDP, RI, PJ>(H, nullptr, Operand{W + off.w_mid2, 1, H, h4, H},
                             Operand{}, h3, ACT_MASK);
    __syncthreads();
    wgrad<TP, LDP, 4, H>(G + off.w_cat_h, H, h3, H, h2);
    wgrad<TP, LDP, 4, EMB1>(G + off.w_cat_x, EMB_PAD, h3, H, emb);
    bgrad<TP, LDP>(G + off.b_cat, h3, H);
    __syncthreads();
    // dh2 = relu'(h2) W_cat_h^T dh3; bands 0..3 of W_cat_x^T dh3 (the
    // columns of emb_a past xs)
    product<TP, LDP, RI, PJ>(H, nullptr, Operand{W + off.w_cat_h, 1, H, h3, H},
                             Operand{}, h2, ACT_MASK);
    product<TP, LDP, 4, PJ>(4 * NDIR, nullptr,
                            Operand{W + off.w_cat_x + 3, 1, EMB_PAD, h3, H},
                            Operand{}, tmp, ACT_NONE);
    __syncthreads();
    fold_bands<TP, LDP>(dproj, proj, tmp, 0, 4, false);
    wgrad<TP, LDP, 4, H>(G + off.w_mid1, H, h2, H, h1);
    bgrad<TP, LDP>(G + off.b_mid1, h2, H);
    __syncthreads();
    // dh1 = relu'(h1) W_mid1^T dh2
    product<TP, LDP, RI, PJ>(H, nullptr, Operand{W + off.w_mid1, 1, H, h2, H},
                             Operand{}, h1, ACT_MASK);
    __syncthreads();
    wgrad<TP, LDP, 4, EMB1>(G + off.w_in, EMB_PAD, h1, H, emb);
    bgrad<TP, LDP>(G + off.b_in, h1, H);
    product<TP, LDP, 4, PJ>(4 * NDIR, nullptr,
                            Operand{W + off.w_in + 3, 1, EMB_PAD, h1, H},
                            Operand{}, tmp, ACT_NONE);
    __syncthreads();
    fold_bands<TP, LDP>(dproj, proj, tmp, 0, 4, false);
    __syncthreads();
    // d dirs[j][k] = sum_p dproj[j][p] xs[k][p]
    for (int idx = threadIdx.x; idx < NDIR * 3; idx += NT) {
      const int j = idx / 3, k = idx % 3;
      float acc = 0.f;
      for (int p = 0; p < TP; ++p)
        acc = fmaf(dproj[j * LDP + p], emb[k * LDP + p], acc);
      G[off.dirs + idx] += acc;
    }
    __syncthreads();   // the next sub-tile overwrites every buffer
  }
}

Prep make_prep(const int* v) {
  return Prep{v[0], v[1], v[2],  v[3],  v[4],  v[5],  v[6],  v[7], v[8],
              v[9], v[10], v[11], v[12], v[13], v[14], v[15], v[16]};
}

bool bad_shape(int hidden, const int* offsets, int n_params, int O, int M) {
  return O < 1 || O > 65535 || M < 1 || n_params < 1 ||
         offsets[N_PREP - 1] + hidden * EMB_PAD > n_params;
}

template <int H, int TP, int RI, int PJ>
int launch_fwd(const float* params, int n_params, const Prep& off,
               const float* scale, const float* pts, int O, int M,
               float* alpha, float* color, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)TP * (EMB + 2 * H + 4);
  cudaError_t err = cudaFuncSetAttribute(
      field_fwd_kernel<H, TP, RI, PJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + TP - 1) / TP, O);
  field_fwd_kernel<H, TP, RI, PJ><<<grid, NT, smem, stream>>>(
      params, n_params, off, scale, pts, M, alpha, color);
  return (int)cudaGetLastError();
}

// Points per sub-tile of one field_bwd block at each width (0: no kernel);
// a chunk of tile_m points holds whole sub-tiles.
constexpr int bwd_subtile(int hidden) {
  return hidden == 32 ? 64 : hidden == 128 || hidden == 256 ? 32 : 0;
}

template <int H, int TP, int RI, int PJ>
int launch_bwd(const float* params, int n_params, const Prep& off,
               const float* scale, const float* pts, const float* g_alpha,
               const float* g_color, int O, int M, int tile_m,
               float* grad_part, cudaStream_t stream) {
  if (tile_m < TP || tile_m % TP) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(TP + 1) *
                      (EMB + 2 * NDIR + 5 * H + 4 + 4 * NDIR);
  cudaError_t err = cudaFuncSetAttribute(
      field_bwd_kernel<H, TP, RI, PJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + tile_m - 1) / tile_m, O);
  field_bwd_kernel<H, TP, RI, PJ><<<grid, NT, smem, stream>>>(
      params, n_params, off, scale, pts, g_alpha, g_color, M, tile_m,
      grad_part);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: alpha [O, M] (x10 applied) and colour [O, M, 3] (sigmoid applied) of
// every object's field at its points pts [O, M, 3]. params [O, n_params]
// packed prepared rows, offsets[17] into a row, scale [O]. Returns a
// cudaError_t code (0 on success).
int vmap_field_fwd(int hidden, const float* params, const int* offsets,
                   int n_params, const float* scale, const float* pts, int O,
                   int M, float* alpha, float* color, void* stream) {
  if (bad_shape(hidden, offsets, n_params, O, M))
    return (int)cudaErrorInvalidValue;
  const Prep off = make_prep(offsets);
  cudaStream_t st = (cudaStream_t)stream;
  if (hidden == 32)
    return launch_fwd<32, 128, 4, 4>(params, n_params, off, scale, pts, O, M,
                                     alpha, color, st);
  if (hidden == 128)
    return launch_fwd<128, 64, 8, 2>(params, n_params, off, scale, pts, O, M,
                                     alpha, color, st);
  // h=256: 64 points (165 KB of activations, one block per SM), 16 x 2
  // register tile: twice the independent FMAs per weight load of h=128,
  // to cover the load latency with 8 warps per SM
  if (hidden == 256)
    return launch_fwd<256, 64, 16, 2>(params, n_params, off, scale, pts, O,
                                      M, alpha, color, st);
  return (int)cudaErrorInvalidValue;
}

// K3: per-chunk partial weight gradients grad_part [O, ceil(M / tile_m),
// n_params] of sum(g_alpha * alpha) + sum(g_color * colour), in the packed
// prepared layout (padded columns stay 0); built for h = 32, 128 and 256.
// tile_m must be a multiple of vmap_field_bwd_subtile(hidden).
int vmap_field_bwd(int hidden, const float* params, const int* offsets,
                   int n_params, const float* scale, const float* pts,
                   const float* g_alpha, const float* g_color, int O, int M,
                   int tile_m, float* grad_part, void* stream) {
  if (bad_shape(hidden, offsets, n_params, O, M))
    return (int)cudaErrorInvalidValue;
  const Prep off = make_prep(offsets);
  cudaStream_t st = (cudaStream_t)stream;
  if (hidden == 32)
    return launch_bwd<32, bwd_subtile(32), 4, 2>(
        params, n_params, off, scale, pts, g_alpha, g_color, O, M, tile_m,
        grad_part, st);
  if (hidden == 128)
    return launch_bwd<128, bwd_subtile(128), 8, 1>(
        params, n_params, off, scale, pts, g_alpha, g_color, O, M, tile_m,
        grad_part, st);
  if (hidden == 256)
    return launch_bwd<256, bwd_subtile(256), 8, 1>(
        params, n_params, off, scale, pts, g_alpha, g_color, O, M, tile_m,
        grad_part, st);
  return (int)cudaErrorInvalidValue;
}

// Points per sub-tile of field_bwd at this width (0: no kernel).
int vmap_field_bwd_subtile(int hidden) { return bwd_subtile(hidden); }

}  // extern "C"
