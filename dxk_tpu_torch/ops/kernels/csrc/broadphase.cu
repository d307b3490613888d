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
// exactly.
//
// What bounds them on an H100:
//   * overlap matrix: bytes. Six float compares per (i, j) against one byte
//     written per (i, j); one thread per entry, rows of a block share
//     neighbouring columns, so writes are coalesced.
//   * K-select and sweep: operations. Every pair of the C x C space (or of
//     the sorted window) is tested and classified, but only K partners and a
//     count leave the chip per row. One warp owns one row and walks its
//     columns in ascending order 32 at a time: __ballot_sync marks the hits
//     and __popc of the lower lanes gives each hit its output slot, so the
//     first K hits land in ascending partner order in one pass (the TPU
//     kernel's K masked lane-min reductions) and all hits are counted.
// The pruning, placement and class rules are those of the TPU kernels,
// operation for operation.
//
// Deliberately not done yet: no shared-memory staging of column tiles, no
// early exit for rows whose window holds no candidates, no tuning of the
// rows per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;          // the sweep's row tile (as on the TPU)
constexpr int ROWS_PER_BLOCK = 8;  // warps per block in the row kernels
constexpr float BIG = 3.0e38f;     // padding column x-min of the sweep

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

// out[b, i, j] = 1 if AABB i overlaps AABB j in env b, else 0
__global__ void overlap_matrix_kernel(int C, const float* __restrict__ mn,
                                      const float* __restrict__ mx,
                                      int8_t* __restrict__ out) {
  const int b = blockIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.z * blockDim.x + threadIdx.x;
  if (i >= C || j >= C) return;
  const float* mnb = mn + (size_t)b * C * 3;
  const float* mxb = mx + (size_t)b * C * 3;
  bool ov = aabb_overlap(mnb + 3 * i, mxb + 3 * i, mnb + 3 * j, mxb + 3 * j);
  out[((size_t)b * C + i) * C + j] = ov ? 1 : 0;
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

// K-select over all columns (kselect_broadphase.py:_kselect_kernel).
// Placement: dynamic-dynamic pairs in the lower-indexed row, static-dynamic
// pairs in the dynamic row.
__global__ void kselect_kernel(int C, int K, int nph,
                               const float* __restrict__ mn,
                               const float* __restrict__ mx,
                               const int* __restrict__ body,
                               const int* __restrict__ owner,
                               const int* __restrict__ ctype,
                               int* __restrict__ idx_out,
                               int* __restrict__ cls_out,
                               int* __restrict__ cnt_out) {
  const int b = blockIdx.x;
  const int i = blockIdx.y * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (i >= C) return;  // uniform across the warp
  const float* mnb = mn + (size_t)b * C * 3;
  const float* mxb = mx + (size_t)b * C * 3;
  const float rmn[3] = {mnb[3 * i], mnb[3 * i + 1], mnb[3 * i + 2]};
  const float rmx[3] = {mxb[3 * i], mxb[3 * i + 1], mxb[3 * i + 2]};
  const int body_i = body[i], ctype_i = ctype[i];
  const bool rb_i = owner[i] == 0;

  auto cls_of_col = [&](int j) -> int {
    const int owner_j = owner[j], body_j = body[j];
    const bool rb_j = owner_j == 0, st_j = owner_j == 1;
    const bool dd = rb_i && rb_j;
    const bool placed = (dd && (j > i)) || (rb_i && st_j);
    const bool allowed = placed && !(dd && (body_i == body_j));
    if (!allowed || !aabb_overlap(rmn, rmx, mnb + 3 * j, mxb + 3 * j)) return 0;
    const int dyn_min = dd ? min(body_i, body_j) : (rb_i ? body_i : body_j);
    const int phase = floor_mod(dyn_min + 2 * (dd ? 0 : 1), nph);
    const int ctype_j = ctype[j];
    return class_of(ctype_i, ctype_j, phase, ctype_i > ctype_j ? 1 : 0, nph);
  };

  const size_t row = (size_t)b * C + i;
  const int n = warp_select(0, C, K, idx_out + row * K, cls_out + row * K,
                            cls_of_col);
  if ((threadIdx.x & 31) == 0) cnt_out[row] = n;
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

}  // namespace

extern "C" int dxk_overlap_matrix_launch(int B, int C, const void* mn,
                                         const void* mx, void* out, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  dim3 block(32, 8);
  dim3 grid((unsigned)B, (unsigned)((C + 7) / 8), (unsigned)((C + 31) / 32));
  overlap_matrix_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      C, (const float*)mn, (const float*)mx, (int8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int dxk_kselect_launch(int B, int C, int K, int nph, const void* mn,
                                  const void* mx, const void* body,
                                  const void* owner, const void* ctype,
                                  void* idx, void* cls, void* cnt, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  dim3 grid((unsigned)B, row_blocks(C));
  kselect_kernel<<<grid, 32 * ROWS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      C, K, nph, (const float*)mn, (const float*)mx, (const int*)body,
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
