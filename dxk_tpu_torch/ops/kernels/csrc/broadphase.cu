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
// sap_kernel: bounded by bytes at the box stack's sizes (K + 2 integers a
// row out); its pair tests are few once a row's walk ends where its
// x-interval does. A block takes one env and 32 rows of one 128-row tile,
// which share the tile's window, one thread a row in each of its SAP_SPLIT
// warps. Exact early stop: passes over the window's column x-mins, from its
// end back to the block's first row, give their suffix minima (NaN read as
// -inf) in shared memory, and a row stops at the first column past it whose
// suffix minimum exceeds the row's max-x; no later column can then pass the
// x test, whatever the order of the input. The block walks the columns from
// its first row on to the largest stop, cut into SAP_SPLIT consecutive
// slices a warp each and staged as the K-select's float4 pairs (min corner,
// kind) and (max corner, body), where kind is rigid, static or neither. The
// tests and the in-order merge of the slices' hits are the K-select's; the
// placement rule (two masks on the kind) and the same-body rule run only on
// the columns that overlap, and the hits gather in a shared tile of the
// block's rows, copied out as one contiguous range. The overflow flag reads
// the window's last column, as before, however early a row stopped. Past
// SAP_MAX_K partners a row the tile would not fit a block: one warp walks
// the block's columns and each thread writes its row's hits, in ascending
// order, straight into the outputs, then pads the row's remaining slots.
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
constexpr int SAP_ROWS = 32;       // rows a sweep block (a thread each)
constexpr int SAP_SPLIT = 4;       // warps a sweep block: slices of a row
constexpr int SAP_SPLIT_MAX_K = 16;  // largest K whose hits the slices buffer
constexpr int SAP_MAX_K = 256;     // largest K the sweep's shared tile holds;
                                   // past it rows are written directly
constexpr int SAP_CHUNK = 64;      // columns a sweep warp stages at once
constexpr int SAP_GROUP = 8;       // columns a sweep thread tests at once
constexpr int SAP_EPT = 4;         // x-mins a sweep thread scans a pass
constexpr int KIND_RIGID = 1;      // a sweep column's kind: rigid body,
constexpr int KIND_STATIC = 2;     // static, or 0 (neither)
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
// columns are in sorted order; row ii of row tile i0 = (ii / 128) * 128 pairs
// with the columns jj of [i0, i0 + window * 128) past it (jj > ii): a rigid
// row with the rigid columns of other bodies and the statics, a static row
// with the rigid columns. ovf flags rows whose x-interval reaches the min-x
// of the window's last column (padding columns past C carry min-x +BIG).
// Block: `split` warps (blockDim.x = 32 * split) on one env (blockIdx.x) and
// the same 32 rows [32 * blockIdx.y, + 32) of one tile, one thread a row in
// each warp.
//   1. Exact stop. Passes over the window's x-mins from its end back to the
//      block's first row + 1 give their suffix minima (NaN read as -inf) in
//      shared memory; warp 0 finds where row ii stops: the first column
//      j > ii whose suffix minimum exceeds its max-x (a binary search: the
//      minima ascend). Every later column then has min-x > max-x and fails
//      the x test, sorted input or not; a NaN max-x never stops.
//   2. The block's columns run from its first row that pairs with anything,
//      plus one, to the largest stop; they are cut into `split` consecutive
//      slices, warp w streaming slice w through shared memory in chunks of
//      SAP_CHUNK columns as (min corner, kind) and (max corner, body) float4s,
//      read as broadcasts. A thread tests SAP_GROUP columns at once without a
//      branch (overlap_flag) and takes the group's overlaps in order, each
//      a hit if the placement rule (two masks on the kind) and the
//      same-body rule admit it: overlaps are far fewer than the columns
//      walked, so the rules cost a few operations an overlap, not a pair.
//   3. Warp 0 keeps its first K hits a row in a shared tile of the block's
//      rows (padded with -1 / 0 from the start), the other warps theirs in
//      buffers of their own, and warp 0 appends those in slice order, so the
//      K lowest partners come out ascending; then the block copies the tile
//      out, the 32 rows' slots being one contiguous range.
// Dynamic shared memory: the tile, 2 * 32 * (K + 1) ints (idx, then cls;
// rows padded to K + 1 against bank conflicts), then (split - 1) * K * 32
// ints twice for warps 1.. ([w - 1][idx, cls][k][lane]). For K > SAP_MAX_K
// (one warp, no dynamic shared memory) a thread writes its row's hits
// straight into idx_out / cls_out as step 2 finds them, in ascending order,
// and pads the rest of the row in step 3; there is no tile and no copy-out.
// DIRECT (K > SAP_MAX_K) is a template parameter so that the tile's
// instance keeps its slots as shared-memory pointers.
template <bool DIRECT>
__global__ void __launch_bounds__(32 * SAP_SPLIT)
sap_kernel(int C, int K, int nph, int window, const float* __restrict__ mn_s,
           const float* __restrict__ mx_s, const int* __restrict__ body_s,
           const int* __restrict__ owner_s, const int* __restrict__ ctype_s,
           int* __restrict__ idx_out, int* __restrict__ cls_out,
           int* __restrict__ cnt_out, int* __restrict__ ovf_out) {
  __shared__ float s_sm[SAP_EPT * 32 * SAP_SPLIT];  // a pass's suffix minima
  __shared__ float s_wmin[SAP_SPLIT];               // a pass's warp minima
  __shared__ int s_span[2];                         // the block's columns
  // a warp's chunk of its slice, padded by a group of SAP_GROUP
  __shared__ float4 s_lo[SAP_SPLIT][SAP_CHUNK + SAP_GROUP];  // min, kind
  __shared__ float4 s_hi[SAP_SPLIT][SAP_CHUNK + SAP_GROUP];  // max, body
  __shared__ int s_ct[SAP_SPLIT][SAP_CHUNK];                 // shape type
  __shared__ int s_cnt[SAP_SPLIT][32];                       // hits a slice
  extern __shared__ int sap_smem[];
  const int b = blockIdx.x;
  const int split = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * SAP_ROWS;
  const int ii = r0 + lane;
  const int i0 = (r0 / TILE) * TILE;
  const long long w_end = (long long)i0 + (long long)window * TILE;
  const int j_end = (int)(w_end < (long long)C ? w_end : (long long)C);
  const float* mnb = mn_s + (size_t)b * C * 3;
  const float* mxb = mx_s + (size_t)b * C * 3;
  const int* bodyb = body_s + (size_t)b * C;
  const int* ownerb = owner_s + (size_t)b * C;
  const int* ctypeb = ctype_s + (size_t)b * C;
  const bool in = ii < C;
  const int owner_i = in ? ownerb[ii] : -1;
  const float rmx_x = in ? mxb[3 * ii] : 0.f;
  const bool rb_i = owner_i == 0, st_i = owner_i == 1;
  const bool act = rb_i || st_i;
  const int kp = K + 1;
  int* t_idx = sap_smem;  // the block's rows' first K partners
  int* t_cls = sap_smem + 32 * kp;
  const size_t row = (size_t)b * C + ii;
  // this row's slots: in the tile, or (DIRECT) in the outputs; a thread past
  // C never writes through them
  int* o_idx;
  int* o_cls;
  if constexpr (DIRECT) {
    o_idx = idx_out + row * K;
    o_cls = cls_out + row * K;
  } else {
    o_idx = t_idx + lane * kp;
    o_cls = t_cls + lane * kp;
  }
  if (w == 0) {
    if constexpr (!DIRECT)
      for (int s = 0; s < K; ++s) {
        o_idx[s] = -1;
        o_cls[s] = 0;
      }
    if (in) {
      const long long last = w_end - 1;
      const float end_minx = last < (long long)C ? mnb[3 * last] : BIG;
      ovf_out[row] = rmx_x >= end_minx ? 1 : 0;
    }
  }

  // 1. each row's stop, from the suffix minima of passes of P x-mins taken
  // from the window's end back to the block's first row + 1; `carry` is
  // the minimum past the pass
  const int P = SAP_EPT * (int)blockDim.x;
  const int e_t = SAP_EPT * (int)threadIdx.x;
  int stop = j_end;
  bool done = !act || ii + 1 >= j_end;
  float carry = INFINITY;
  for (int c1 = j_end; c1 > r0 + 1;) {
    const int c0 = max(r0 + 1, c1 - P);
    float v[SAP_EPT];
#pragma unroll
    for (int u = 0; u < SAP_EPT; ++u) {
      const int j = c0 + e_t + u;
      const float x = j < c1 ? mnb[3 * j] : INFINITY;
      v[u] = x == x ? x : -INFINITY;
    }
#pragma unroll
    for (int u = SAP_EPT - 2; u >= 0; --u) v[u] = fminf(v[u], v[u + 1]);
    // the thread's minimum over itself and the later lanes, then over the
    // later lanes only, the later warps and the later passes
    float incl = v[0];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      incl = fminf(incl, __shfl_down_sync(FULL, incl, d));
    float after = __shfl_down_sync(FULL, incl, 1);
    if (lane == 31) after = INFINITY;
    if (lane == 0) s_wmin[w] = incl;
    __syncthreads();
#pragma unroll
    for (int x = 1; x < SAP_SPLIT; ++x)
      if (w + x < split) after = fminf(after, s_wmin[w + x]);
    after = fminf(after, carry);
#pragma unroll
    for (int u = 0; u < SAP_EPT; ++u)
      if (e_t + u < c1 - c0) s_sm[e_t + u] = fminf(v[u], after);
    __syncthreads();
    if (w == 0 && !done) {
      const int s = max(c0, ii + 1);
      if (s_sm[s - c0] > rmx_x) {
        stop = s;  // and maybe earlier, in an earlier pass
        done = s == ii + 1;
      } else {
        int a = s + 1, z = c1;  // the first j of [a, z) past max-x, else z
        while (a < z) {
          const int m = (a + z) >> 1;
          if (s_sm[m - c0] > rmx_x) z = m;
          else a = m + 1;
        }
        stop = a;
        done = true;
      }
    }
    carry = s_sm[0];
    c1 = c0;
  }
  // the block's columns [lo, hi): from the first row that pairs with
  // anything on to the largest stop (none when no row pairs)
  if (w == 0) {
    const int lo = min(j_end, __reduce_min_sync(FULL, act ? ii + 1 : INT_MAX));
    const int hi = max(lo, __reduce_max_sync(FULL, act ? stop : 0));
    if (lane == 0) {
      s_span[0] = lo;
      s_span[1] = hi;
    }
  }
  // the rest of the row, in flight with the first chunk's loads
  float rmn[3] = {0.f, 0.f, 0.f}, rmx[3] = {rmx_x, 0.f, 0.f};
  int body_i = 0, ctype_i = 0;
  if (act) {
#pragma unroll
    for (int a = 0; a < 3; ++a) rmn[a] = mnb[3 * ii + a];
    rmx[1] = mxb[3 * ii + 1];
    rmx[2] = mxb[3 * ii + 2];
    body_i = bodyb[ii];
    ctype_i = ctypeb[ii];
  }
  __syncthreads();
  const int lo = s_span[0], len = s_span[1] - lo;

  // 2. the walk over this warp's slice of [lo, hi)
  // the kinds the row pairs with, and those it pairs with whatever their
  // body (the same-body rule holds between two rigid bodies only)
  const int pairs_with =
      rb_i ? (KIND_RIGID | KIND_STATIC) : (st_i ? KIND_RIGID : 0);
  const int any_body = rb_i ? KIND_STATIC : (KIND_RIGID | KIND_STATIC);
  // where this warp's hits go: warp 0's place or the warp's own buffer
  int* bufs = sap_smem + 2 * 32 * kp;
  int* hit_idx = w == 0 ? o_idx : bufs + (w - 1) * 2 * K * 32 + lane;
  int* hit_cls = w == 0 ? o_cls : hit_idx + K * 32;
  const int hit_stride = w == 0 ? 1 : 32;
  int cnt = 0;

  const int q_end = lo + len * (w + 1) / split;
  float4* lo_w = s_lo[w];
  float4* hi_w = s_hi[w];
  int* ct_w = s_ct[w];
  for (int q0 = lo + len * w / split; q0 < q_end; q0 += SAP_CHUNK) {
    const int n = min(SAP_CHUNK, q_end - q0);
#pragma unroll
    for (int u = 0; u < SAP_CHUNK / 32; ++u) {
      const int e = 32 * u + lane;
      if (e < n) {
        const int j = q0 + e;
        const int o = ownerb[j];
        const int kind = o == 0 ? KIND_RIGID : (o == 1 ? KIND_STATIC : 0);
        ct_w[e] = ctypeb[j];
        lo_w[e] = make_float4(mnb[3 * j], mnb[3 * j + 1], mnb[3 * j + 2],
                              __int_as_float(kind));
        hi_w[e] = make_float4(mxb[3 * j], mxb[3 * j + 1], mxb[3 * j + 2],
                              __int_as_float(bodyb[j]));
      }
    }
    __syncwarp();

    for (int e0 = 0; e0 < n; e0 += SAP_GROUP) {
      // the group's overlaps as a bit mask, without a branch
      float4 lo4[SAP_GROUP], hi4[SAP_GROUP];
#pragma unroll
      for (int u = 0; u < SAP_GROUP; ++u) {
        lo4[u] = lo_w[e0 + u];
        hi4[u] = hi_w[e0 + u];
      }
      unsigned hits = 0;
#pragma unroll
      for (int u = 0; u < SAP_GROUP; ++u) {
        const float cmn[3] = {lo4[u].x, lo4[u].y, lo4[u].z};
        const float cmx[3] = {hi4[u].x, hi4[u].y, hi4[u].z};
        hits |= overlap_flag(rmn, rmx, cmn, cmx) << u;
      }
      // only the chunk's columns, only those past the row, and none for a
      // row that pairs with nothing
      if (n - e0 < SAP_GROUP) hits &= (1u << (n - e0)) - 1u;
      hits &= ~0u << min(max(ii + 1 - (q0 + e0), 0), SAP_GROUP);
      if (!pairs_with) hits = 0;
      while (hits) {
        const int e = e0 + __ffs(hits) - 1;
        hits &= hits - 1;
        const int kind = __float_as_int(lo_w[e].w);
        const int body_j = __float_as_int(hi_w[e].w);
        if (!(kind & pairs_with) || (body_j == body_i && !(kind & any_body)))
          continue;
        const bool dd = rb_i && kind == KIND_RIGID;
        const int dyn_min =
            dd ? min(body_i, body_j) : (rb_i ? body_i : body_j);
        const int phase = floor_mod(dyn_min + (dd ? 0 : 2), nph);
        const int ctype_j = ct_w[e];
        const int cls = class_of(ctype_i, ctype_j, phase,
                                 ctype_i > ctype_j ? 1 : 0, nph);
        if (cls > 0) {
          if (cnt < K) {
            hit_idx[cnt * hit_stride] = q0 + e;
            hit_cls[cnt * hit_stride] = cls;
          }
          ++cnt;
        }
      }
    }
    __syncwarp();
  }

  // 3. warp 0 appends the other slices' hits in slice order, then the block
  // copies the tile out
  s_cnt[w][lane] = cnt;
  __syncthreads();
  if (w == 0 && in) {
    for (int v = 1; v < split; ++v) {
      const int* v_idx = bufs + (v - 1) * 2 * K * 32 + lane;
      const int* v_cls = v_idx + K * 32;
      const int nv = s_cnt[v][lane];
      for (int k = 0; k < nv && cnt + k < K; ++k) {
        o_idx[cnt + k] = v_idx[32 * k];
        o_cls[cnt + k] = v_cls[32 * k];
      }
      cnt += nv;
    }
    cnt_out[row] = cnt;
    if constexpr (DIRECT)
      for (int s = min(cnt, K); s < K; ++s) {
        o_idx[s] = -1;
        o_cls[s] = 0;
      }
  }
  if constexpr (DIRECT) return;
  __syncthreads();
  const int n_out = min(SAP_ROWS, C - r0) * K;
  int* idx_blk = idx_out + ((size_t)b * C + r0) * K;
  int* cls_blk = cls_out + ((size_t)b * C + r0) * K;
  const int dr = (int)blockDim.x / K, dk = (int)blockDim.x - dr * K;
  int r = (int)threadIdx.x / K, k = (int)threadIdx.x - r * K;
  for (int f = threadIdx.x; f < n_out; f += blockDim.x) {
    idx_blk[f] = t_idx[r * kp + k];
    cls_blk[f] = t_cls[r * kp + k];
    r += dr;
    k += dk;
    if (k >= K) {
      k -= K;
      ++r;
    }
  }
}

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
  // a block's columns in SAP_SPLIT slices, unless K is too large to buffer;
  // past SAP_MAX_K no tile either: rows are written directly
  const int split = K <= SAP_SPLIT_MAX_K ? SAP_SPLIT : 1;
  const bool direct = K > SAP_MAX_K;
  const int smem = direct ? 0
                   : (2 * 32 * (K + 1) + (split - 1) * 2 * K * 32)
                         * (int)sizeof(int);
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        sap_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid((unsigned)B, (unsigned)((C + SAP_ROWS - 1) / SAP_ROWS));
  dim3 block(32 * split);
  auto sweep = direct ? sap_kernel<true> : sap_kernel<false>;
  sweep<<<grid, block, smem, (cudaStream_t)stream>>>(
      C, K, nph, window, (const float*)mn_s, (const float*)mx_s,
      (const int*)body_s, (const int*)owner_s, (const int*)ctype_s, (int*)idx,
      (int*)cls, (int*)cnt, (int*)ovf);
  return (int)cudaGetLastError();
}
