// Other forms of the nodal assembly kernels of
// dynearthsol_tpu_torch/csrc/band2d.cu, float32, kept to be measured beside
// the shipped ones by tools/band2d_forms.py.  Same layouts and the same
// fixed-order sums (each node's slots in row order, from +0.0).
//
//   field   -- one thread per (node, field), the row walked one slot after
//              the other (a chain slots[p] -> cols[..]): the assembly
//              kernel band2d.cu had before the per-node one
//   staged  -- blocks of BN nodes: the block's CSR span of slot ids read
//              coalesced, every (slot, field) value loaded into a
//              shared-memory tile with independent loads, then each
//              (node, field) adds its row of the tile
//   coop    -- asm_gather as one cooperative launch: persistent blocks run
//              `staged` over the node blocks, one grid sync, then walk the
//              corner slots gathering the first kg sums
//   owner   -- asm_gather as one launch: one thread per node sums its row
//              (as band2d.cu's asm_pack_kernel) and writes its first kg
//              sums to its own corner slots
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int T = 256;   // threads of a block
constexpr int BN = 64;   // nodes of a staged block
constexpr int UNROLL = 12;

template <int K>
__global__ void field(const float* __restrict__ cols,
                      const int* __restrict__ rp,
                      const int* __restrict__ slots, int nn, int ns,
                      float* __restrict__ out) {
  const int i = blockIdx.x * T + threadIdx.x;
  if (i >= nn * K) return;
  const int n = i / K, j = i - n * K;
  float acc = 0.f;
  for (int p = rp[n]; p < rp[n + 1]; ++p) acc = acc + cols[j * ns + slots[p]];
  out[i] = acc;
}

template <int K>
__device__ void staged_block(const float* __restrict__ cols,
                             const int* __restrict__ rp,
                             const int* __restrict__ slots, int nn, int ns,
                             int vb, float* tile, int* off,
                             float* __restrict__ out) {
  constexpr int KS = K | 1;  // odd row stride: no bank conflicts
  const int n0 = vb * BN, nb = min(BN, nn - n0);
  const int span0 = rp[n0], len = rp[n0 + nb] - span0;
  for (int i = threadIdx.x; i <= nb; i += T) off[i] = rp[n0 + i] - span0;
  for (int t = threadIdx.x; t < len; t += T) {
    const int s = slots[span0 + t];
    float v[K];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = cols[j * ns + s];
#pragma unroll
    for (int j = 0; j < K; ++j) tile[t * KS + j] = v[j];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nb * K; q += T) {
    const int i = q / K, j = q - i * K;
    float acc = 0.f;
    for (int p = off[i]; p < off[i + 1]; ++p) acc = acc + tile[p * KS + j];
    out[n0 * K + q] = acc;
  }
}

// maxdeg: the tables' largest row, so that BN rows fit the tile
template <int K>
__global__ void staged(const float* __restrict__ cols,
                       const int* __restrict__ rp,
                       const int* __restrict__ slots, int nn, int ns,
                       int maxdeg, float* __restrict__ out) {
  extern __shared__ float sm[];
  staged_block<K>(cols, rp, slots, nn, ns, blockIdx.x, sm,
                  reinterpret_cast<int*>(sm + BN * maxdeg * (K | 1)), out);
}

template <int K>
__global__ void coop(const float* __restrict__ cols,
                     const int* __restrict__ rp,
                     const int* __restrict__ slots,
                     const int* __restrict__ conn, int nn, int ns,
                     int maxdeg, int kg, float* __restrict__ sums,
                     float* __restrict__ gath) {
  extern __shared__ float sm[];
  int* off = reinterpret_cast<int*>(sm + BN * maxdeg * (K | 1));
  for (int vb = blockIdx.x; vb < (nn + BN - 1) / BN; vb += gridDim.x) {
    staged_block<K>(cols, rp, slots, nn, ns, vb, sm, off, sums);
    __syncthreads();
  }
  cg::this_grid().sync();
  for (int s = blockIdx.x * T + threadIdx.x; s < ns; s += gridDim.x * T)
    for (int j = 0; j < kg; ++j)
      gath[j * ns + s] = __ldcg(sums + conn[s] * K + j);
}

template <int K>
__global__ void owner(const float* __restrict__ cols,
                      const int* __restrict__ rp,
                      const int* __restrict__ slots, int nn, int ns, int kg,
                      float* __restrict__ sums, float* __restrict__ gath) {
  const int n = blockIdx.x * T + threadIdx.x;
  if (n >= nn) return;
  const int b = rp[n], e = rp[n + 1];
  int sid[UNROLL];
#pragma unroll
  for (int d = 0; d < UNROLL; ++d) sid[d] = b + d < e ? slots[b + d] : 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float* col = cols + j * ns;
    float v[UNROLL];
#pragma unroll
    for (int d = 0; d < UNROLL; ++d) v[d] = b + d < e ? col[sid[d]] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < UNROLL; ++d)
      if (b + d < e) acc = acc + v[d];
    for (int p = b + UNROLL; p < e; ++p) acc = acc + col[slots[p]];
    sums[n * K + j] = acc;
    if (j >= kg) continue;
#pragma unroll
    for (int d = 0; d < UNROLL; ++d)
      if (b + d < e) gath[j * ns + sid[d]] = acc;
    for (int p = b + UNROLL; p < e; ++p) gath[j * ns + slots[p]] = acc;
  }
}

template <int K>
int run(int form, const float* cols, const int* rp, const int* slots,
        const int* conn, int nn, int ns, int maxdeg, int kg, float* sums,
        float* gath, cudaStream_t st) {
  const size_t smem = size_t(BN) * maxdeg * (K | 1) * 4 + (BN + 1) * 4;
  const int nvb = (nn + BN - 1) / BN;
  if (smem > 48 * 1024) return int(cudaErrorInvalidValue);
  if (form == 0) field<K><<<(nn * K + T - 1) / T, T, 0, st>>>(
      cols, rp, slots, nn, ns, sums);
  if (form == 1) staged<K><<<nvb, T, smem, st>>>(cols, rp, slots, nn, ns,
                                                 maxdeg, sums);
  if (form == 2) {
    int dev, sms, bps;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, coop<K>, T, smem);
    const int grid = nvb < bps * sms ? nvb : bps * sms;
    void* args[] = {&cols, &rp, &slots, &conn, &nn, &ns,
                    &maxdeg, &kg, &sums, &gath};
    cudaError_t e = cudaLaunchCooperativeKernel((const void*)coop<K>,
                                                dim3(grid), dim3(T), args,
                                                smem, st);
    if (e != cudaSuccess) return int(e);
  }
  if (form == 3) owner<K><<<(nn + T - 1) / T, T, 0, st>>>(
      cols, rp, slots, nn, ns, kg, sums, gath);
  return int(cudaGetLastError());
}

}  // namespace

// form 0 field, 1 staged (sums only), 2 coop, 3 owner; k 1, 2 or 5
extern "C" int band2d_form(int form, int k, const float* cols, const int* rp,
                           const int* slots, const int* conn, int nn, int ns,
                           int maxdeg, int kg, float* sums, float* gath,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 1) return run<1>(form, cols, rp, slots, conn, nn, ns, maxdeg, kg,
                            sums, gath, st);
  if (k == 2) return run<2>(form, cols, rp, slots, conn, nn, ns, maxdeg, kg,
                            sums, gath, st);
  if (k == 5) return run<5>(form, cols, rp, slots, conn, nn, ns, maxdeg, kg,
                            sums, gath, st);
  return int(cudaErrorInvalidValue);
}
