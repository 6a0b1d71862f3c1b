// Positions of the first m set entries of a bool[n] flag array.
//
// Replaces pointcloudhookup_tpu/ops/pallas/compactidx.py::compact_indices
// (pallas_call at :134).  out[j] is the position of the (j+1)-th set flag,
// ascending; slots past the number of set flags hold n - 1 (the clipped
// searchsorted convention of the fused front-end's dense-cell table pack).
// Unlike the TPU kernel there is no rule that n be a multiple of 32768.
//
// Bound: device-memory bandwidth.  The function must read n flag bytes
// and write 4m bytes; the kernel reads the flags twice (count pass and
// emit pass) and scans each 4096-row tile in a block.  The TPU kernel
// emitted one position at a time into scalar memory because a vector unit
// cannot scatter; here every thread writes its own set rows' positions:
//   1. count_kernel    set flags per 4096-row tile       (compact_scan.cuh)
//   2. offsets_kernel  exclusive scan of the tile counts (compact_scan.cuh)
//   3. emit_kernel     block scan of the flags; rows whose slot < m write
//                      their position; tiles whose offset >= m exit at once
//   4. fill_kernel     slots [min(count, m), m) <- n - 1
#include "compact_scan.cuh"

namespace {

__global__ void emit_kernel(const unsigned char* __restrict__ flag,
                            long long n, const int* __restrict__ tile_offsets,
                            int m, int* __restrict__ out) {
  __shared__ int warp_sums[kThreads / 32];
  const int offset = tile_offsets[blockIdx.x];
  if (offset >= m) return;  // uniform across the block
  const long long base =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kItems;
  bool f[kItems];
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    f[j] = i < n && flag[i] != 0;
    c += f[j];
  }
  int total;
  int pos = offset + block_exclusive_sum<kThreads>(c, warp_sums, &total);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (!f[j]) continue;
    if (pos < m) out[pos] = static_cast<int>(base + j);
    ++pos;
  }
}

__global__ void fill_kernel(const int* __restrict__ count, int m, int fill,
                            int* __restrict__ out) {
  const int first = *count < m ? *count : m;
  for (int i = first + blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += gridDim.x * blockDim.x) {
    out[i] = fill;
  }
}

}  // namespace

// int32 words of scratch pch_compact_indices needs for n rows.
PCH_API long long pch_compact_indices_scratch(long long n) {
  return pch::blocks_for(n, kTile) + 1;
}

// flag: uint8[n] (a torch.bool tensor), 1 <= n < 2**31; out: int32[m];
// scratch: int32[pch_compact_indices_scratch(n)], whose last word receives
// the number of set flags.
PCH_API int pch_compact_indices(const unsigned char* flag, long long n, int m,
                                int* out, int* scratch, void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = pch::blocks_for(n, kTile);
  int* tile = scratch;
  int* count = scratch + nb;
  count_kernel<<<nb, kThreads, 0, s>>>(flag, n, tile);
  offsets_kernel<<<1, kScanThreads, 0, s>>>(tile, nb, count);
  if (m > 0) {
    emit_kernel<<<nb, kThreads, 0, s>>>(flag, n, tile, m, out);
    int grid = pch::blocks_for(m, 256);
    if (grid > 1024) grid = 1024;
    fill_kernel<<<grid, 256, 0, s>>>(count, m, static_cast<int>(n - 1), out);
  }
  return static_cast<int>(cudaGetLastError());
}
