// Windowed first-occurrence flags for the fused front-end's cell sort.
//
// Replaces pointcloudhookup_tpu/ops/pallas/dupwin.py::first_occurrence_flags
// (pallas_call at :99).  After the single-key sort by cell key k1 the rows
// of a cell are contiguous but not ordered by their within-cell code w, so
// duplicates of a voxel need not be adjacent:
//   flag[i] = 1 unless some j in [max(0, i - depth), i) has
//             k1[j] == k1[i] and w[j] == w[i].
// Both words are compared exactly, so a real voxel is never flagged as a
// duplicate.  Unlike the TPU kernel there is no rule that n be a multiple
// of 32768 and no depth < 128 cap: any n and any depth >= 1.
//
// Bound: device-memory bandwidth.  The function reads the u32 key k1 and
// w (4 bytes each) once and writes one flag byte per row, 9 bytes; this
// kernel reads k1 as the port holds it, in int64, so it moves 13.  The
// TPU kernel reached each row's predecessors with lane
// rolls of a second, shifted input view; here a block stages its 1024-row
// tile plus a depth-row halo in shared memory, so every row is read from
// device memory about (1 + depth / 1024) times, and each thread compares
// its row with its depth predecessors out of shared memory.  A depth whose
// halo does not fit in shared memory takes a second kernel that reads the
// predecessors from device memory (through L2).
#include "common.cuh"

namespace {

constexpr int kTile = 1024;  // rows per block
constexpr int kThreads = 256;
constexpr size_t kMaxShared = 227 * 1024;

__global__ void dupwin_shared_kernel(const long long* __restrict__ k1,
                                     const int* __restrict__ w, long long n,
                                     int depth,
                                     unsigned char* __restrict__ out) {
  extern __shared__ long long smem[];
  long long* sk = smem;                                 // [depth + kTile]
  int* sw = reinterpret_cast<int*>(smem + depth + kTile);  // [depth + kTile]
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long first = base - depth;  // row of shared slot 0
  for (int s = threadIdx.x; s < depth + kTile; s += blockDim.x) {
    const long long g = first + s;
    if (g >= 0 && g < n) {
      sk[s] = k1[g];
      sw[s] = w[g];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
    const long long i = base + r;
    if (i >= n) break;
    const int s = depth + r;
    const long long key = sk[s];
    const int wv = sw[s];
    const int dmax = i < depth ? static_cast<int>(i) : depth;
    bool dup = false;
    for (int d = 1; d <= dmax; ++d) {
      dup |= (sk[s - d] == key) & (sw[s - d] == wv);
    }
    out[i] = dup ? 0 : 1;
  }
}

__global__ void dupwin_global_kernel(const long long* __restrict__ k1,
                                     const int* __restrict__ w, long long n,
                                     int depth,
                                     unsigned char* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long key = k1[i];
    const int wv = w[i];
    const long long dmax = i < depth ? i : depth;
    bool dup = false;
    for (long long d = 1; d <= dmax && !dup; ++d) {
      dup = k1[i - d] == key && w[i - d] == wv;
    }
    out[i] = dup ? 0 : 1;
  }
}

}  // namespace

// k1: int64[n] (u32 keys), w: int32[n], out: uint8[n] (a torch.bool
// tensor); 0 <= n, depth >= 1.
PCH_API int pch_dupwin(const long long* k1, const int* w, long long n,
                       int depth, unsigned char* out, void* stream) {
  if (n < 0 || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      static_cast<size_t>(depth + kTile) * (sizeof(long long) + sizeof(int));
  if (smem <= kMaxShared) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          dupwin_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    dupwin_shared_kernel<<<pch::blocks_for(n, kTile), kThreads, smem, s>>>(
        k1, w, n, depth, out);
  } else {
    long long grid = pch::blocks_for(n, kThreads);
    if (grid > 65535) grid = 65535;
    dupwin_global_kernel<<<static_cast<int>(grid), kThreads, 0, s>>>(
        k1, w, n, depth, out);
  }
  return static_cast<int>(cudaGetLastError());
}
