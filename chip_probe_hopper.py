"""Measures two properties of the card that the wide kernels' designs rest
on, with two small CUDA programs built here by nvcc.

    python3 chip_probe_hopper.py

- DMMA: each f64 mma.sync shape (m8n8k4, m16n8k4, m16n8k8, m16n8k16) is
  checked against a host product in the fragment layout
  csrc/householder.cu uses (g = lane / 4, t = lane % 4: A(g + 8 (j % 2), t
  + 4 (j / 2)) as a[j], B(t + 4 j, g) as b[j], D(g + 8 (j / 2), 2 t + j %
  2) as d[j]), then timed at 132 x 4 blocks of 8 warps, eight independent
  accumulators a warp: TFLOP/s and instructions a clock an SM.
- Clusters: the clocks of a cluster barrier (barrier.cluster arrive and
  wait) against a CTA's __syncthreads, and of a dependent load from
  distributed shared memory (ld.shared::cluster) of the CTA's own and of a
  peer's shared memory, against an ld.shared chain, at clusters of 2, 4
  and 8.

Prints the card and the two programs' lines. Exits non-zero without a CUDA
device or nvcc.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

DMMA_SRC = r"""
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cuda_runtime.h>
// g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma884(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void mma1684(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void mma1688(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void mma16816(double* d, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                 "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}
// layout guess: A (M x K): elem i at row g + 8*(i%2), col t + 4*(i/2); B (K x 8): elem i at row t + 4*i, col g;
// C (M x 8): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
template <int M, int K>
__global__ void layout_test(const double* A, const double* B, double* C) {
  int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  double a[8], b[4], d[4] = {0, 0, 0, 0};
  constexpr int NA = M * K / 32, NB = K * 8 / 32;
  for (int i = 0; i < NA; ++i) { int r = M == 8 ? g : g + 8 * (i % 2); int c = M == 8 ? t : t + 4 * (i / 2); a[i] = A[r * K + c]; }
  for (int i = 0; i < NB; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  if (M == 8) mma884(d, a, b);
  else if (K == 4) mma1684(d, a, b);
  else if (K == 8) mma1688(d, a, b);
  else mma16816(d, a, b);
  int nd = M * 8 / 32;
  for (int i = 0; i < nd; ++i) { int r = g + 8 * (i / 2); int c = 2 * t + (i % 2); C[r * 8 + c] = d[i]; }
}
template <int S>
__global__ void rate(int n, double* out) {
  double a[8], b[4], d[8][4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (i + 1);
  for (int u = 0; u < 8; ++u) for (int i = 0; i < 4; ++i) d[u][i] = 0;
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (S == 0) mma884(d[u], a, b); else if (S == 1) mma1684(d[u], a, b); else if (S == 2) mma1688(d[u], a, b); else mma16816(d[u], a, b);
    }
  }
  double s = 0; for (int u = 0; u < 8; ++u) for (int i = 0; i < 4; ++i) s += d[u][i];
  if (s == 12345.0) out[0] = s;
}
template <int M, int K> int check() {
  double hA[16 * 16], hB[16 * 8], hC[16 * 8], *A, *B, *C;
  for (int i = 0; i < M * K; ++i) hA[i] = rand() / double(RAND_MAX) - 0.5;
  for (int i = 0; i < K * 8; ++i) hB[i] = rand() / double(RAND_MAX) - 0.5;
  cudaMalloc(&A, sizeof hA); cudaMalloc(&B, sizeof hB); cudaMalloc(&C, sizeof hC);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice); cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  layout_test<M, K><<<1, 32>>>(A, B, C); cudaMemcpy(hC, C, sizeof hC, cudaMemcpyDeviceToHost);
  double err = 0; for (int r = 0; r < M; ++r) for (int c = 0; c < 8; ++c) { double s = 0; for (int k = 0; k < K; ++k) s += hA[r * K + k] * hB[k * 8 + c]; err = fmax(err, fabs(s - hC[r * 8 + c])); }
  printf("layout m%dn8k%d: max err %g (%s)\n", M, K, err, cudaGetErrorString(cudaGetLastError()));
  return 0;
}
int main() {
  check<8, 4>(); check<16, 4>(); check<16, 8>(); check<16, 16>();
  double* o; cudaMalloc(&o, 8); cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  const char* names[] = {"m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16"}; const double flop[] = {512, 1024, 2048, 4096};
  for (int s = 0; s < 4; ++s) {
    for (int rep = 0; rep < 2; ++rep) {
      int n = 2000; cudaEventRecord(e0);
      if (s == 0) rate<0><<<132 * 4, 256>>>(n, o); else if (s == 1) rate<1><<<132 * 4, 256>>>(n, o); else if (s == 2) rate<2><<<132 * 4, 256>>>(n, o); else rate<3><<<132 * 4, 256>>>(n, o);
      cudaEventRecord(e1); cudaEventSynchronize(e1); float ms; cudaEventElapsedTime(&ms, e0, e1);
      double inst = 132.0 * 4 * 8 * n * 8; 
      if (rep) printf("%s: %.3f ms, %.1f TFLOP/s, %.2f instr/clk/SM at 1.755 GHz\n", names[s], ms, inst * flop[s] / ms / 1e9, inst / 132 / (ms * 1e-3 * 1.755e9));
    }
  }
  return 0;
}
"""

CLUSTER_SRC = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t peer(uint32_t addr, unsigned rank) {
  uint32_t r; asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank)); return r;
}
__device__ __forceinline__ double ld_cluster(uint32_t a) { double v; asm volatile("ld.shared::cluster.f64 %0, [%1];\n" : "=d"(v) : "r"(a) : "memory"); return v; }
__global__ void k_sync(int n, long long* out) {
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) cluster_sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = (clock64() - t0) / n;
}
__global__ void k_cta_sync(int n, long long* out) {
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[1] = (clock64() - t0) / n;
}
__global__ void k_dsmem(int n, int remote, long long* out) {
  __shared__ double buf[64];
  unsigned rank; asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  for (int i = threadIdx.x; i < 64; i += blockDim.x) buf[i] = (i + 1) % 64;
  cluster_sync();
  uint32_t base = peer(static_cast<uint32_t>(__cvta_generic_to_shared(buf)), remote ? (rank + 1) % 2 : rank);
  double x = 0;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) x = ld_cluster(base + 8u * static_cast<int>(x));
  long long t = (clock64() - t0) / n;
  if (threadIdx.x == 0 && blockIdx.x == 0) out[2 + remote] = t;
  if (x < 0) out[5] = 1;
  cluster_sync();
}
__global__ void k_lds(int n, long long* out) {
  __shared__ double buf[64];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) buf[i] = (i + 1) % 64;
  __syncthreads();
  double x = 0;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) x = buf[static_cast<int>(x)];
  if (threadIdx.x == 0) out[4] = (clock64() - t0) / n;
  if (x < 0) out[5] = 1;
}
int main() {
  long long* d; cudaMalloc(&d, 8 * 8); cudaMemset(d, 0, 64);
  for (int cl : {2, 4, 8}) {
    cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(cl); cfg.blockDim = dim3(128);
    cudaLaunchAttribute a[1]; a[0].id = cudaLaunchAttributeClusterDimension; a[0].val.clusterDim.x = cl; a[0].val.clusterDim.y = 1; a[0].val.clusterDim.z = 1;
    cfg.attrs = a; cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, k_sync, 10000, d);
    cudaLaunchKernelEx(&cfg, k_dsmem, 10000, 0, d);
    cudaLaunchKernelEx(&cfg, k_dsmem, 10000, 1, d);
    k_cta_sync<<<1, 128>>>(10000, d);
    k_lds<<<1, 32>>>(10000, d);
    long long h[8]; cudaMemcpy(h, d, 64, cudaMemcpyDeviceToHost);
    printf("cluster %d: cluster_sync %lld clk, cta sync %lld clk, dsmem self %lld, dsmem remote %lld, lds %lld (err %s)\n", cl, h[0], h[1], h[2], h[3], h[4], cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
"""


def main() -> int:
    import torch

    from polars_ols_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("chip_probe_hopper: torch sees no CUDA device", file=sys.stderr)
        return 1
    nvcc = kernels._nvcc()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in (("dmma", DMMA_SRC), ("cluster", CLUSTER_SRC)):
            cu, exe = Path(tmp) / f"{name}.cu", Path(tmp) / name
            cu.write_text(src)
            subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe), str(cu)],
                           check=True)
            print(subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
