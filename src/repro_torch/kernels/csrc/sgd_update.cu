// Fused momentum / weight-decay SGD update for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sgd_update.py:43
// (sgd_update_pallas -> _sgd_kernel, pallas_call at :57):
//   g += wd*p;  m' = mu*m + g;  step = m' (Nesterov: g + mu*m');  p' = p - lr*step
//
// Bound: memory. Three fp32 reads and two fp32 writes per element (20 B)
// against ~4 flops, far below the card's 67 TFLOP/s fp32 / 3.35 TB/s ratio.
// On the main path one launch sweeps the whole node-stacked flat buffer
// (8 nodes x 184.6M coordinates for transformer-wmt: ~29.5 GB, ~8.8 ms at
// 3.35 TB/s).
//
// Design: a grid-stride loop over float4 (16-byte) loads, neighbouring
// threads on neighbouring addresses, a few blocks per SM. `lr` is read from
// device memory through a pointer (the TPU kernel's SMEM scalar), so a
// schedule or a captured CUDA graph never bakes it in; mu, wd and nesterov
// are launch arguments. Every multiply and add is an explicit _rn intrinsic
// (and the library is built with --fmad=false), so nothing is contracted
// into an FMA and the result is bitwise the plain PyTorch version's.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void sgd_one(float p, float g, float m, float lr,
                                        float mu, float wd, int nesterov,
                                        float &p_out, float &m_out) {
  if (wd != 0.0f) g = __fadd_rn(g, __fmul_rn(wd, p));
  const float m_new = __fadd_rn(__fmul_rn(mu, m), g);
  const float step = nesterov ? __fadd_rn(g, __fmul_rn(mu, m_new)) : m_new;
  p_out = __fsub_rn(p, __fmul_rn(lr, step));
  m_out = m_new;
}

// p_out may be p and m_out may be m (the in-place update of the packed
// optimizer buffers): every element is read, then written, by one thread,
// so those four pointers carry no __restrict__.
__global__ void sgd_update_kernel(const float4 *p,
                                  const float4 *__restrict__ g,
                                  const float4 *m, float4 *p_out,
                                  float4 *m_out,
                                  const float *__restrict__ lr_ptr,
                                  long long n4, float mu, float wd,
                                  int nesterov) {
  const float lr = *lr_ptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 pv = p[i], gv = g[i], mv = m[i];
    float4 po, mo;
    sgd_one(pv.x, gv.x, mv.x, lr, mu, wd, nesterov, po.x, mo.x);
    sgd_one(pv.y, gv.y, mv.y, lr, mu, wd, nesterov, po.y, mo.y);
    sgd_one(pv.z, gv.z, mv.z, lr, mu, wd, nesterov, po.z, mo.z);
    sgd_one(pv.w, gv.w, mv.w, lr, mu, wd, nesterov, po.w, mo.w);
    p_out[i] = po;
    m_out[i] = mo;
  }
}

}  // namespace

// n: element count, a multiple of 4; every pointer 16-byte aligned (checked
// by the Python wrapper); p_out == p and m_out == m update in place. Returns cudaGetLastError() after the launch.
extern "C" int sgd_update_f32(const void *p, const void *g, const void *m,
                              void *p_out, void *m_out, const void *lr,
                              long long n, float mu, float wd, int nesterov,
                              void *stream) {
  if (n % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  if (n4 == 0) return (int)cudaSuccess;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  long long blocks = (n4 + threads - 1) / threads;
  const long long cap = (long long)sms * 8;
  if (blocks > cap) blocks = cap;
  sgd_update_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4 *)p, (const float4 *)g, (const float4 *)m, (float4 *)p_out,
      (float4 *)m_out, (const float *)lr, n4, mu, wd, nesterov);
  return (int)cudaGetLastError();
}
