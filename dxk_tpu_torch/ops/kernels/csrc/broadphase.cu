// Broadphase kernels for NVIDIA Hopper (sm_90a): the all-pairs AABB overlap
// matrix, the per-row K-select over the C x C pair space, and the
// sort-and-sweep window select. Each takes the env batch as an explicit
// leading dimension.
//
// Replaces the JAX package's TPU kernels
//   dxk_tpu/ops/pallas/broadphase_kernel.py::aabb_overlap_matrix_pallas
//     (body _overlap_kernel)
//   dxk_tpu/ops/pallas/kselect_broadphase.py::kselect_broadphase
//     (body _kselect_kernel)
//   dxk_tpu/ops/pallas/sap_broadphase.py::sap_broadphase (body _sap_kernel)
// Their plain PyTorch versions sit beside the wrappers in
// ops/kernels/broadphase_kernel.py, kselect_broadphase.py and
// sap_broadphase.py. The outputs are integers and equal the plain versions
// exactly. The pruning, placement and class rules are those of the TPU
// kernels, operation for operation.
//
// overlap_matrix_kernel: bounded by bytes (B * C * C int8 written, six float
// compares per byte). A block takes one env, a tile of OV_ROWS rows and a
// range of columns: the whole row when the env is narrow enough
// (OV_CONTIG_MAX) and the batch fills the card, else column chunks of
// `cw`, halved until the grid has two blocks an SM. It
//   1. stages the columns' AABBs in shared memory as six SoA float arrays;
//   2. gives each warp OV_ROWS_PER_WARP rows, whose AABBs stay in
//      registers, and walks the columns a lane each (conflict-free loads,
//      each column tested against all the warp's rows), writing the bytes
//      into a shared tile laid out so that a byte's shared address equals
//      its global address modulo 16;
//   3. copies the tile out in 16-byte chunks aligned in global memory: one
//      uint4 load and one uint4 store a lane, a warp writing 512
//      contiguous bytes. Row starts (b * C + i) * C are not 16-byte aligned
//      when C % 16 != 0; a tile of whole rows is one contiguous range, so
//      only its first and last chunk are ragged, and those are written
//      byte by byte (a chunked tile has a ragged head and tail per row).
//
// kselect_kernel: bounded by operations (the pair tests). A block takes one
// env and 32 rows, one thread a row in each of its KS_SPLIT warps; the row's
// AABB, body and shape type stay in registers. It walks only the columns the
// placement rule admits, in ascending order: the env's static columns below
// the tile (found with a ballot over `owner`), then every column from the
// tile's first row on. That list is cut into KS_SPLIT consecutive slices,
// one a warp, so a row's walk is a quarter as long. Each warp streams its
// slice through shared memory in chunks of KS_CHUNK columns as two float4s:
// (min corner, admit key) and (max corner, pair body), where the admit key
// is the column's index for a rigid body, INT_MAX for a static and INT_MIN
// otherwise, and the pair body is the body of a rigid column and INT_MIN
// otherwise; so "key > i" is the placement rule and "pair body != body_i"
// the same-body rule, two integer compares. All lanes read the same column
// at the same step (broadcasts). A thread tests KS_GROUP columns at once
// without a branch (overlap_flag: the six compares combined bitwise), then
// takes the group's hits in order: warp 0 writes its first K straight into
// the outputs and counts every hit, the other warps keep their first K in
// shared memory, and warp 0 appends them in slice order, so the K lowest
// partners come out ascending. A row that is not a rigid body writes -1 / 0
// padding and a count of 0 at once; a block with no rigid row walks
// nothing. For K > KS_SPLIT_MAX_K one warp walks the whole list.
//
// sap_kernel (unchanged; the next to be redesigned): bounded by operations.
// One warp owns one sorted row and walks its window 32 columns at a time:
// __ballot_sync marks the hits and __popc of the lower lanes gives each hit
// its output slot (warp_select), so the first K hits land in ascending
// partner order in one pass and all hits are counted.
//
// Deliberately not done: TMA or cp.async staging (plain loads stage a chunk,
// several in flight a thread), a bit-packed matrix (one bit a pair would
// change the function the wrapper returns), exploiting the matrix's symmetry
// (each byte is written once either way), and fewer than six compares a pair
// (a min/max form differs from the plain version on inverted boxes and NaN).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;          // the sweep's row tile (as on the TPU)
constexpr int ROWS_PER_BLOCK = 8;  // warps per block in the sweep
constexpr float BIG = 3.0e38f;     // padding column x-min of the sweep

constexpr int OV_WARPS = 8;                       // warps of a matrix block
constexpr int OV_ROWS_PER_WARP = 4;               // rows in a warp's registers
constexpr int OV_ROWS = OV_WARPS * OV_ROWS_PER_WARP;  // rows of a block's tile
constexpr int OV_CONTIG_MAX = 1536;  // widest env whose rows are staged whole
constexpr int OV_CHUNK = 1024;       // column chunk past that width
constexpr int OV_MIN_CHUNK = 256;    // narrowest chunk when filling the card

constexpr int KS_SPLIT = 4;        // warps a K-select block: slices a row
constexpr int KS_SPLIT_MAX_K = 16; // largest K whose hits the slices buffer
constexpr int KS_CHUNK = 128;      // columns a K-select warp stages at once
constexpr int KS_GROUP = 8;        // columns a K-select thread tests at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int floor_mod(int x, int n) {
  int r = x % n;
  return r < 0 ? r + n : r;
}

// 1 + ((bucket * num_phases + phase) * 2 + swap); bucket is the upper-triangle
// index over sorted shape types (kselect_broadphase.py::class_of)
__device__ __forceinline__ int class_of(int ta, int tb, int phase, int swap,
                                        int nph) {
  int lo = min(ta, tb), hi = max(ta, tb);
  int bucket = lo * 5 - lo * (lo - 1) / 2 + (hi - lo);
  return 1 + (bucket * nph + phase) * 2 + swap;
}

__device__ __forceinline__ bool aabb_overlap(const float* amn, const float* amx,
                                             const float* bmn, const float* bmx) {
  bool ov = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) ov = ov && !((amn[a] > bmx[a]) || (bmn[a] > amx[a]));
  return ov;
}

// 1 if the boxes overlap, else 0: aabb_overlap's six compares, combined
// bitwise so that the compiler emits no branch (a short-circuit chain costs
// a branch and the loads' full latency per pair)
__device__ __forceinline__ unsigned overlap_flag(const float* amn,
                                                 const float* amx,
                                                 const float* bmn,
                                                 const float* bmx) {
  unsigned f = 1u;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    f &= (unsigned)!(amn[a] > bmx[a]) & (unsigned)!(bmn[a] > amx[a]);
  return f;
}

// out[b, i, j] = 1 if AABB i overlaps AABB j in env b, else 0. Block: env
// blockIdx.x, rows [OV_ROWS * blockIdx.y, + OV_ROWS), columns
// [cw * blockIdx.z, + cw). Dynamic shared memory: six SoA arrays of cwp
// floats (the columns' min x, y, z and max x, y, z), then the byte tile.
__global__ void __launch_bounds__(32 * OV_WARPS)
overlap_matrix_kernel(int C, int cw, const float* __restrict__ mn,
                      const float* __restrict__ mx, int8_t* __restrict__ out) {
  extern __shared__ float4 ov_smem[];
  const int b = blockIdx.x;
  const int i0 = blockIdx.y * OV_ROWS;
  const int c0 = blockIdx.z * cw;
  const int nrows = min(OV_ROWS, C - i0);
  const int ncols = min(cw, C - c0);
  const int cwp = (cw + 3) & ~3;
  float* col = reinterpret_cast<float*>(ov_smem);
  uint8_t* tile = reinterpret_cast<uint8_t*>(col + 6 * cwp);
  // whole rows: the tile is one contiguous byte range of `out`
  const bool whole = ncols == C;
  uint8_t* g0 = reinterpret_cast<uint8_t*>(out) + ((size_t)b * C + i0) * C + c0;
  const int tstride = whole ? C : ((cw + 15) & ~15) + 16;
  // shared offset of row r's first byte: congruent to its global address
  // modulo 16
  auto tile_row = [&](int r) -> int {
    const uint8_t* g = g0 + (whole ? 0 : (size_t)r * C);
    return r * tstride + (int)((uintptr_t)g & 15);
  };

  const float* mnc = mn + ((size_t)b * C + c0) * 3;
  const float* mxc = mx + ((size_t)b * C + c0) * 3;
  // four loads of each array in flight a thread
  for (int k0 = threadIdx.x; k0 < 3 * ncols; k0 += 4 * blockDim.x) {
    float vmn[4], vmx[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = min(k0 + u * (int)blockDim.x, 3 * ncols - 1);
      vmn[u] = mnc[k];
      vmx[u] = mxc[k];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * (int)blockDim.x;
      if (k < 3 * ncols) {
        const int j = k / 3, a = k - 3 * j;
        col[a * cwp + j] = vmn[u];
        col[(3 + a) * cwp + j] = vmx[u];
      }
    }
  }

  // rows past the tile repeat the tile's last row, whose bytes they write
  // again with the same values: the loop below has no branch
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * OV_ROWS_PER_WARP;
  float rmn[OV_ROWS_PER_WARP][3], rmx[OV_ROWS_PER_WARP][3];
  int roff[OV_ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < OV_ROWS_PER_WARP; ++k) {
    const int r = min(r0 + k, nrows - 1);
    const float* pmn = mn + ((size_t)b * C + i0 + r) * 3;
    const float* pmx = mx + ((size_t)b * C + i0 + r) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      rmn[k][a] = pmn[a];
      rmx[k][a] = pmx[a];
    }
    roff[k] = tile_row(r);
  }
  __syncthreads();

  for (int j = lane; j < ncols; j += 32) {
    const float cmn[3] = {col[j], col[cwp + j], col[2 * cwp + j]};
    const float cmx[3] = {col[3 * cwp + j], col[4 * cwp + j], col[5 * cwp + j]};
#pragma unroll
    for (int k = 0; k < OV_ROWS_PER_WARP; ++k)
      tile[roff[k] + j] = (uint8_t)overlap_flag(rmn[k], rmx[k], cmn, cmx);
  }
  __syncthreads();

  // copy out: segment s (the whole tile, or row s of a chunked tile) in
  // 16-byte chunks aligned in global memory
  const int nseg = whole ? 1 : nrows;
  const long long len = whole ? (long long)nrows * C : ncols;
  const int nq = (int)((len + 30) / 16);
  for (int t = threadIdx.x; t < nseg * nq; t += blockDim.x) {
    const int s = whole ? 0 : t / nq;
    const int q = t - s * nq;
    uint8_t* gs = g0 + (size_t)s * C;
    const uint8_t* ss = tile + tile_row(s);
    const int ph = (int)((uintptr_t)gs & 15);
    const long long lo = 16LL * q - ph, hi = lo + 16;
    if (lo >= 0 && hi <= len) {
      *reinterpret_cast<uint4*>(gs + lo) =
          *reinterpret_cast<const uint4*>(ss + lo);
    } else {
      for (long long x = lo < 0 ? 0 : lo; x < hi && x < len; ++x) gs[x] = ss[x];
    }
  }
}

// One warp's walk over columns [j_begin, j_end) of its row: the first K hits
// (class > 0) in ascending column order go to idx_row / cls_row, the rest are
// padded with -1 / 0; returns the number of hits.
template <typename ClassFn>
__device__ __forceinline__ int warp_select(int j_begin, int j_end, int K,
                                           int* idx_row, int* cls_row,
                                           ClassFn cls_of_col) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int j0 = j_begin; j0 < j_end; j0 += 32) {
    const int j = j0 + lane;
    const int cls = (j < j_end) ? cls_of_col(j) : 0;
    const unsigned hits = __ballot_sync(0xffffffffu, cls > 0);
    if (cls > 0) {
      const int slot = base + __popc(hits & ((1u << lane) - 1u));
      if (slot < K) {
        idx_row[slot] = j;
        cls_row[slot] = cls;
      }
    }
    base += __popc(hits);
  }
  for (int s = base + lane; s < K; s += 32) {
    idx_row[s] = -1;
    cls_row[s] = 0;
  }
  return base;
}

// K-select over the admitted columns (kselect_broadphase.py:_kselect_kernel).
// Placement: dynamic-dynamic pairs in the lower-indexed row, static-dynamic
// pairs in the dynamic row; so a rigid row's partners are the statics below
// it and the statics and rigid columns of other bodies above it, and a row
// that is not a rigid body has none. Block: `split` warps (blockDim.x = 32 *
// split) on one env (blockIdx.x) and the same 32 rows [32 * blockIdx.y, +
// 32), one thread a row in each warp. The block's admitted list, the statics
// below the tile then every column from the tile's first row on, is cut into
// `split` consecutive slices, warp w walking slice w; warp 0 writes its
// first K hits straight into the outputs, the other warps into shared memory
// (dynamic: (split - 1) * K * 32 ints twice), and warp 0 appends those in
// slice order, so the K lowest partners come out ascending.
__global__ void __launch_bounds__(32 * KS_SPLIT)
kselect_kernel(int C, int K, int nph, int split, const float* __restrict__ mn,
               const float* __restrict__ mx, const int* __restrict__ body,
               const int* __restrict__ owner, const int* __restrict__ ctype,
               int* __restrict__ idx_out, int* __restrict__ cls_out,
               int* __restrict__ cnt_out) {
  // a warp's chunk of its slice, ascending, padded by a group of KS_GROUP
  __shared__ float4 s_lo[KS_SPLIT][KS_CHUNK + KS_GROUP];  // min, admit key
  __shared__ float4 s_hi[KS_SPLIT][KS_CHUNK + KS_GROUP];  // max, pair body
  __shared__ int s_col[KS_SPLIT][KS_CHUNK + KS_GROUP];    // column index
  __shared__ int s_ct[KS_SPLIT][KS_CHUNK];                // shape type
  __shared__ int s_cnt[KS_SPLIT][32];                     // hits a slice
  extern __shared__ int ks_hits[];  // warps 1..: [w - 1][idx, cls][k][lane]
  const int b = blockIdx.x;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.y * 32;
  const int i = t0 + lane;
  const float* mnb = mn + (size_t)b * C * 3;
  const float* mxb = mx + (size_t)b * C * 3;
  const bool in = i < C;
  const bool rb_i = in && owner[i] == 0;
  const size_t row = (size_t)b * C + i;
  int* idx_row = idx_out + row * K;
  int* cls_row = cls_out + row * K;
  if (w == 0 && in && !rb_i) {
    for (int s = 0; s < K; ++s) {
      idx_row[s] = -1;
      cls_row[s] = 0;
    }
    cnt_out[row] = 0;
  }
  // uniform across the block: every warp holds the same rows
  if (!__any_sync(FULL, rb_i)) return;

  float rmn[3] = {0.f, 0.f, 0.f}, rmx[3] = {0.f, 0.f, 0.f};
  int body_i = 0, ctype_i = 0;
  if (rb_i) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      rmn[a] = mnb[3 * i + a];
      rmx[a] = mxb[3 * i + a];
    }
    body_i = body[i];
    ctype_i = ctype[i];
  }
  // a row that is not a rigid body tests nothing: its key bound admits no
  // column
  const int i_key = rb_i ? i : INT_MAX;
  // where this warp's hits go: the outputs (warp 0) or its shared buffer
  int* hit_idx = w == 0 ? idx_row : ks_hits + (size_t)(w - 1) * 2 * K * 32 + lane;
  int* hit_cls = w == 0 ? cls_row : hit_idx + K * 32;
  const int hit_stride = w == 0 ? 1 : 32;
  int cnt = 0;

  // the statics below the tile: their number, then the warp's slice
  int n_static = 0;
  for (int w0 = 0; w0 < t0; w0 += 256) {
    int st[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = w0 + 32 * u + lane;
      st[u] = c < t0 ? owner[c] == 1 : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) n_static += __popc(__ballot_sync(FULL, st[u]));
  }
  const long long len = (long long)n_static + (C - t0);
  const int p_end = (int)(len * (w + 1) / split);

  float4* lo_w = s_lo[w];
  float4* hi_w = s_hi[w];
  int* col_w = s_col[w];
  int* ct_w = s_ct[w];
  for (int q0 = (int)(len * w / split); q0 < p_end; q0 += KS_CHUNK) {
    const int n = min(KS_CHUNK, p_end - q0);
    // list positions [q0, q0 + n): the statics of rank q0.. (a ballot scan
    // over owner), then columns t0 + (p - n_static)
    int m = 0;
    if (q0 < n_static) {
      const int r_end = min(n_static, q0 + n);
      int rank = 0;
      for (int w0 = 0; w0 < t0 && rank < r_end; w0 += 32) {
        const int c = w0 + lane;
        const bool st = c < t0 && owner[c] == 1;
        const unsigned msk = __ballot_sync(FULL, st);
        const int r = rank + __popc(msk & ((1u << lane) - 1u));
        if (st && r >= q0 && r < r_end) col_w[r - q0] = c;
        rank += __popc(msk);
      }
      m = r_end - q0;
    }
    for (int e = m + lane; e < n; e += 32) col_w[e] = t0 + (q0 + e - n_static);
    __syncwarp();

    // stage the chunk. A column's admit key is its index for a rigid body,
    // INT_MAX for a static and INT_MIN otherwise, so "key > i" is the
    // placement rule; its pair body is its body for a rigid body and
    // INT_MIN otherwise, so "pair body != body_i" is the same-body rule
    // (rigid bodies' indices are never INT_MIN).
#pragma unroll
    for (int u = 0; u < KS_CHUNK / 32; ++u) {
      const int e = 32 * u + lane;
      if (e < n) {
        const int j = col_w[e];
        const int o = owner[j];
        const int key = o == 0 ? j : (o == 1 ? INT_MAX : INT_MIN);
        const int pb = o == 0 ? body[j] : INT_MIN;
        ct_w[e] = ctype[j];
        lo_w[e] = make_float4(mnb[3 * j], mnb[3 * j + 1], mnb[3 * j + 2],
                              __int_as_float(key));
        hi_w[e] = make_float4(mxb[3 * j], mxb[3 * j + 1], mxb[3 * j + 2],
                              __int_as_float(pb));
      }
    }
    __syncwarp();

    for (int e0 = 0; e0 < n; e0 += KS_GROUP) {
      // the group's hits as a bit mask, without a branch: its columns'
      // loads first, then the tests
      float4 lo[KS_GROUP], hi[KS_GROUP];
#pragma unroll
      for (int u = 0; u < KS_GROUP; ++u) {
        lo[u] = lo_w[e0 + u];
        hi[u] = hi_w[e0 + u];
      }
      unsigned hits = 0;
#pragma unroll
      for (int u = 0; u < KS_GROUP; ++u) {
        const float cmn[3] = {lo[u].x, lo[u].y, lo[u].z};
        const float cmx[3] = {hi[u].x, hi[u].y, hi[u].z};
        const unsigned admitted =
            (unsigned)(__float_as_int(lo[u].w) > i_key)
            & (unsigned)(__float_as_int(hi[u].w) != body_i);
        hits |= (admitted & overlap_flag(rmn, rmx, cmn, cmx)) << u;
      }
      if (n - e0 < KS_GROUP) hits &= (1u << (n - e0)) - 1u;
      while (hits) {
        const int e = e0 + __ffs(hits) - 1;
        hits &= hits - 1;
        if (cnt < K) {
          const int pb = __float_as_int(hi_w[e].w);
          const bool dd = pb != INT_MIN;
          const int dyn_min = dd ? min(body_i, pb) : body_i;
          const int phase = floor_mod(dyn_min + (dd ? 0 : 2), nph);
          const int ctype_j = ct_w[e];
          hit_idx[cnt * hit_stride] = col_w[e];
          hit_cls[cnt * hit_stride] = class_of(ctype_i, ctype_j, phase,
                                               ctype_i > ctype_j ? 1 : 0, nph);
        }
        ++cnt;
      }
    }
    __syncwarp();
  }

  // warp 0 appends the other slices' hits in slice order
  s_cnt[w][lane] = cnt;
  __syncthreads();
  if (w == 0 && rb_i) {
    for (int v = 1; v < split; ++v) {
      const int* v_idx = ks_hits + (size_t)(v - 1) * 2 * K * 32 + lane;
      const int* v_cls = v_idx + K * 32;
      const int nv = s_cnt[v][lane];
      for (int k = 0; k < nv && cnt + k < K; ++k) {
        idx_row[cnt + k] = v_idx[32 * k];
        cls_row[cnt + k] = v_cls[32 * k];
      }
      cnt += nv;
    }
    for (int s = cnt; s < K; ++s) {
      idx_row[s] = -1;
      cls_row[s] = 0;
    }
    cnt_out[row] = cnt;
  }
}

// Sweep over the sorted window (sap_broadphase.py:_sap_kernel). Rows and
// columns are in sorted order; row ii of row tile i0 = (ii / 128) * 128 visits
// columns [i0, i0 + window * 128). A pair lives in the earlier sorted row
// (jj > ii); one side dynamic, the other dynamic or static. ovf flags rows
// whose x-interval reaches the min-x of the window's last column (padding
// columns past C carry min-x +BIG).
__global__ void sap_kernel(int C, int K, int nph, int window,
                           const float* __restrict__ mn_s,
                           const float* __restrict__ mx_s,
                           const int* __restrict__ body_s,
                           const int* __restrict__ owner_s,
                           const int* __restrict__ ctype_s,
                           int* __restrict__ idx_out,
                           int* __restrict__ cls_out,
                           int* __restrict__ cnt_out,
                           int* __restrict__ ovf_out) {
  const int b = blockIdx.x;
  const int ii = blockIdx.y * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (ii >= C) return;  // uniform across the warp
  const float* mnb = mn_s + (size_t)b * C * 3;
  const float* mxb = mx_s + (size_t)b * C * 3;
  const int* bodyb = body_s + (size_t)b * C;
  const int* ownerb = owner_s + (size_t)b * C;
  const int* ctypeb = ctype_s + (size_t)b * C;
  const float rmn[3] = {mnb[3 * ii], mnb[3 * ii + 1], mnb[3 * ii + 2]};
  const float rmx[3] = {mxb[3 * ii], mxb[3 * ii + 1], mxb[3 * ii + 2]};
  const int body_i = bodyb[ii], ctype_i = ctypeb[ii];
  const bool rb_i = ownerb[ii] == 0, st_i = ownerb[ii] == 1;
  const int i0 = (ii / TILE) * TILE;
  const long long w_end = (long long)i0 + (long long)window * TILE;

  auto cls_of_col = [&](int jj) -> int {
    const int owner_j = ownerb[jj], body_j = bodyb[jj];
    const bool rb_j = owner_j == 0, st_j = owner_j == 1;
    const bool dd = rb_i && rb_j;
    const bool allowed = (jj > ii) && ((rb_i && (rb_j || st_j)) || (st_i && rb_j))
                         && !(dd && (body_i == body_j));
    if (!allowed || !aabb_overlap(rmn, rmx, mnb + 3 * jj, mxb + 3 * jj)) return 0;
    const int dyn_min = dd ? min(body_i, body_j) : (rb_i ? body_i : body_j);
    const int phase = floor_mod(dyn_min + 2 * (dd ? 0 : 1), nph);
    const int ctype_j = ctypeb[jj];
    return class_of(ctype_i, ctype_j, phase, ctype_i > ctype_j ? 1 : 0, nph);
  };

  const size_t row = (size_t)b * C + ii;
  const int j_end = (int)(w_end < (long long)C ? w_end : (long long)C);
  const int n = warp_select(i0, j_end, K, idx_out + row * K,
                            cls_out + row * K, cls_of_col);
  if ((threadIdx.x & 31) == 0) {
    const long long last = w_end - 1;
    const float end_minx = last < (long long)C ? mnb[3 * last] : BIG;
    cnt_out[row] = n;
    ovf_out[row] = (rmx[0] >= end_minx) ? 1 : 0;
  }
}

unsigned row_blocks(int C) { return (unsigned)((C + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK); }

// column chunk of the overlap matrix for (B, C) on a card of `sms` SMs: the
// whole row where it fits and the batch fills the card, else chunks halved
// until there are two blocks an SM
int overlap_chunk(int B, int C, int sms) {
  const long long tiles = (C + OV_ROWS - 1) / OV_ROWS;
  if (C <= OV_CONTIG_MAX && (long long)B * tiles >= 2LL * sms) return C;
  int cw = OV_CHUNK;
  while (cw > OV_MIN_CHUNK
         && (long long)B * tiles * ((C + cw - 1) / cw) < 2LL * sms)
    cw /= 2;
  return cw < C ? cw : C;
}

}  // namespace

extern "C" int dxk_overlap_matrix_launch(int B, int C, const void* mn,
                                         const void* mx, void* out, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int cw = overlap_chunk(B, C, sms);
  const int cwp = (cw + 3) & ~3;
  const long long tile_bytes =
      cw == C ? (((long long)OV_ROWS * C + 15 + 15) & ~15LL)
              : (long long)OV_ROWS * (((cw + 15) & ~15) + 16);
  const int smem = (int)(24LL * cwp + tile_bytes);
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(overlap_matrix_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid((unsigned)B, (unsigned)((C + OV_ROWS - 1) / OV_ROWS),
            (unsigned)((C + cw - 1) / cw));
  dim3 block(32 * OV_WARPS);
  overlap_matrix_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      C, cw, (const float*)mn, (const float*)mx, (int8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int dxk_kselect_launch(int B, int C, int K, int nph, const void* mn,
                                  const void* mx, const void* body,
                                  const void* owner, const void* ctype,
                                  void* idx, void* cls, void* cnt, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  // a row's columns in KS_SPLIT slices, unless K is too large to buffer
  const int split = K <= KS_SPLIT_MAX_K ? KS_SPLIT : 1;
  const int smem = (split - 1) * 2 * K * 32 * (int)sizeof(int);
  dim3 grid((unsigned)B, (unsigned)((C + 31) / 32));
  dim3 block(32 * split);
  kselect_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      C, K, nph, split, (const float*)mn, (const float*)mx, (const int*)body,
      (const int*)owner, (const int*)ctype, (int*)idx, (int*)cls, (int*)cnt);
  return (int)cudaGetLastError();
}

extern "C" int dxk_sap_launch(int B, int C, int K, int nph, int window,
                              const void* mn_s, const void* mx_s,
                              const void* body_s, const void* owner_s,
                              const void* ctype_s, void* idx, void* cls,
                              void* cnt, void* ovf, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  dim3 grid((unsigned)B, row_blocks(C));
  sap_kernel<<<grid, 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      C, K, nph, window, (const float*)mn_s, (const float*)mx_s,
      (const int*)body_s, (const int*)owner_s, (const int*)ctype_s, (int*)idx,
      (int*)cls, (int*)cnt, (int*)ovf);
  return (int)cudaGetLastError();
}
