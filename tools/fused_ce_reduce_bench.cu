// Rate of the three ways a CTA can add an fp32 tile into a plane in device
// memory on Hopper (sm_90a), for tools/torch_fused_ce_ab.py --reduce.
//
// Each CTA adds ROWS rows of `row_floats` fp32 values into a plane of row
// stride `stride_floats`, at a tile offset that walks the whole plane,
// `iters` times. The modes:
//   0  red.global.add.v4.f32 from registers (16 bytes a thread and op)
//   1  cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32, one op
//      per tile row, from a tile staged in shared memory (the TMA unit does
//      the read-modify-write); the staging buffer is waited for (.read)
//      before the next iteration rewrites it, as a kernel's would be
//   2  red.global.add.v2.f32 from registers (8 bytes a thread and op; the
//      form of the first fused-CE backward kernels' float2 atomicAdd)
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libreduce_bench.so fused_ce_reduce_bench.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ void red_v4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}

__device__ __forceinline__ void red_v2(float* p, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a), "f"(b) : "memory");
}

__global__ void __launch_bounds__(THREADS) reduce_kernel(float* plane, long long plane_rows,
                                                         int stride_floats, int row_floats,
                                                         int mode, int iters) {
  extern __shared__ __align__(128) float stage[];
  const int tile_floats = ROWS * row_floats;
  for (int i = threadIdx.x; i < tile_floats; i += THREADS) stage[i] = 1e-30f * (i & 7);
  __syncthreads();
  const int col_tiles = stride_floats / row_floats;
  const long long tiles = plane_rows / ROWS * col_tiles;
  for (int it = 0; it < iters; ++it) {
    const long long tile = ((long long)blockIdx.x * iters + it) % tiles;
    float* base = plane + tile / col_tiles * ROWS * (long long)stride_floats +
                  tile % col_tiles * row_floats;
    if (mode == 0) {
      const int per_row = row_floats / 4;
      for (int i = threadIdx.x; i < ROWS * per_row; i += THREADS) {
        const int r = i / per_row, c = (i % per_row) * 4;
        red_v4(base + (long long)r * stride_floats + c, 1e-30f, 2e-30f, 3e-30f, 4e-30f);
      }
    } else if (mode == 1) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x < ROWS) {
        const int r = threadIdx.x;
        const uint32_t src = (uint32_t)__cvta_generic_to_shared(stage + r * row_floats);
        asm volatile(
            "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;" ::"l"(
                base + (long long)r * stride_floats),
            "r"(src), "r"(row_floats * 4)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      __syncthreads();
    } else {
      const int per_row = row_floats / 2;
      for (int i = threadIdx.x; i < ROWS * per_row; i += THREADS) {
        const int r = i / per_row, c = (i % per_row) * 2;
        red_v2(base + (long long)r * stride_floats + c, 1e-30f, 2e-30f);
      }
    }
  }
  if (mode == 1 && threadIdx.x < ROWS) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// plane [plane_rows, stride_floats] fp32; row_floats a multiple of 4 (16 bytes)
extern "C" int reduce_bench(void* plane, long long plane_rows, int stride_floats, int row_floats,
                            int mode, int ctas, int iters, void* stream) {
  const size_t smem = sizeof(float) * ROWS * row_floats;
  cudaError_t e = cudaFuncSetAttribute(reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e) return (int)e;
  reduce_kernel<<<ctas, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(plane), plane_rows, stride_floats, row_floats, mode, iters);
  return (int)cudaGetLastError();
}
