// Throughput probes for the exact kernels' pair mix (studies/exact_micro.py):
// MUFU.RSQ alone, FFMA alone, and 12 FFMA + 1 MUFU.RSQ a step, each over 8
// independent chains a thread.  run() times one launch with CUDA events; the
// per-block clock64 spans it also returns are not used.
#include <cuda_runtime.h>
__device__ __forceinline__ float rs(float x) { float r; asm volatile("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x)); return r; }

extern "C" __global__ void mufu_k(float* out, long long* clk, int iters) {
    float a[8];
    for (int k = 0; k < 8; ++k) a[k] = 1.0f + threadIdx.x * 1e-4f + k;
    long long t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = rs(a[k]);
    }
    long long t1 = clock64();
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += a[k];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
    if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

extern "C" __global__ void ffma_k(float* out, long long* clk, int iters) {
    float a[8];
    for (int k = 0; k < 8; ++k) a[k] = 1.0f + threadIdx.x * 1e-4f + k;
    const float b = 0.999f, c = 1e-3f;
    long long t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = fmaf(a[k], b, c);
    }
    long long t1 = clock64();
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += a[k];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
    if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

// 12 FFMA and 1 MUFU a step (the exact loop's ratio), 8 independent chains.
extern "C" __global__ void mix_k(float* out, long long* clk, int iters) {
    float a[8];
    for (int k = 0; k < 8; ++k) a[k] = 1.0f + threadIdx.x * 1e-4f + k;
    const float b = 0.999f, c = 1e-3f;
    long long t0 = clock64();
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            float x = a[k];
#pragma unroll
            for (int q = 0; q < 12; ++q) x = fmaf(x, b, c);
            a[k] = rs(x);
        }
    }
    long long t1 = clock64();
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += a[k];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
    if (threadIdx.x == 0) clk[blockIdx.x] = t1 - t0;
}

extern "C" int run(int which, int blocks, int threads, int iters, float* ms, double* cycles) {
    float* out; long long* clk;
    cudaMalloc(&out, sizeof(float) * blocks * threads);
    cudaMalloc(&clk, sizeof(long long) * blocks);
    auto k = which == 0 ? mufu_k : (which == 1 ? ffma_k : mix_k);
    k<<<blocks, threads>>>(out, clk, 16);
    cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
    cudaEventRecord(a);
    k<<<blocks, threads>>>(out, clk, iters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(ms, a, b);
    long long* h = new long long[blocks];
    cudaMemcpy(h, clk, sizeof(long long) * blocks, cudaMemcpyDeviceToHost);
    double s = 0; for (int i = 0; i < blocks; ++i) s += h[i];
    *cycles = s / blocks;
    delete[] h; cudaFree(out); cudaFree(clk);
    return (int)cudaGetLastError();
}
