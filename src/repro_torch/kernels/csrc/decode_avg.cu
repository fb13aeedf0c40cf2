// Fused modular decode + gossip average (+ matched-row mask) for Hopper
// (sm_90a) -- the receiver half of every quantized gossip interaction.
//
// Replaces the TPU kernel src/repro/kernels/decode_avg.py:66
// (decode_avg_pallas -> _decode_avg_kernel :38, _decode :29, pallas_call at
// :97). Per coordinate of a 256-wide row with scale s:
//   qy = round(y/s);  d = (q - qy) mod L wrapped to [-L/2, L/2);
//   x^ = (qy + d) * s;  out = (y + x^) * 0.5   (x^ when average == 0)
// and a row whose matched byte is 0 returns y unchanged.
//
// Bound: memory. It reads q (1 B at q8), y (4 B) and per row one scale and
// one mask byte, and writes out (4 B): ~9 B per coordinate, ~13.3 GB per
// launch on the main path (8 x 184.6M coordinates), ~4.0 ms at 3.35 TB/s.
//
// Design: a grid-stride loop in which one thread owns 4 consecutive
// columns of a row (64 threads per row): one float4 (or 8-byte bf16) load
// of y, one 4- or 8-byte load of codes, and the row's scale and mask read
// once. Unmatched rows skip the arithmetic and copy y. The nibble unpack
// of pack4 is fused: the thread of columns [c, c+4) with c >= 128 reads the
// high nibbles of bytes [c-128, c-124). round is rintf (half-to-even, as
// torch.round and jnp.round), the division is __fdiv_rn, the floor-mod is
// fmodf plus a sign fix, and every multiply/add is an _rn intrinsic (the
// library is built with --fmad=false), so the output is bitwise the plain
// PyTorch version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ void load4(const float *p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4 *>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16 *p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2 *>(p);
  const __nv_bfloat16 *h = reinterpret_cast<const __nv_bfloat16 *>(&t);
  for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(h[k]);
}
__device__ __forceinline__ void store4(float *p, const float v[4]) {
  *reinterpret_cast<float4 *>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16 *p, const float v[4]) {
  uint2 t;
  __nv_bfloat16 *h = reinterpret_cast<__nv_bfloat16 *>(&t);
  for (int k = 0; k < 4; ++k) h[k] = __float2bfloat16_rn(v[k]);
  *reinterpret_cast<uint2 *>(p) = t;
}
// A bf16 row that passes through unmatched is copied bit for bit.
__device__ __forceinline__ void copy4(const float *src, float *dst) {
  *reinterpret_cast<float4 *>(dst) = *reinterpret_cast<const float4 *>(src);
}
__device__ __forceinline__ void copy4(const __nv_bfloat16 *src,
                                      __nv_bfloat16 *dst) {
  *reinterpret_cast<uint2 *>(dst) = *reinterpret_cast<const uint2 *>(src);
}

// QKIND: 0 = uint8 codes [R, 256], 1 = uint16 codes [R, 256],
//        2 = nibble-packed uint8 [R, 128].
template <int QKIND>
__device__ __forceinline__ void load_codes(const void *q, long long row,
                                           int c0, float v[4]) {
  if (QKIND == 0) {
    const uchar4 t = *reinterpret_cast<const uchar4 *>(
        static_cast<const unsigned char *>(q) + row * kBlock + c0);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if (QKIND == 1) {
    const ushort4 t = *reinterpret_cast<const ushort4 *>(
        static_cast<const unsigned short *>(q) + row * kBlock + c0);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const int hi = c0 >= kBlock / 2;
    const uchar4 t = *reinterpret_cast<const uchar4 *>(
        static_cast<const unsigned char *>(q) + row * (kBlock / 2) +
        (c0 - hi * (kBlock / 2)));
    const int sh = hi ? 4 : 0;
    v[0] = (t.x >> sh) & 0x0F; v[1] = (t.y >> sh) & 0x0F;
    v[2] = (t.z >> sh) & 0x0F; v[3] = (t.w >> sh) & 0x0F;
  }
}

__device__ __forceinline__ float decode_one(float qv, float y, float s,
                                            float levels, float half,
                                            int average) {
  const float qy = rintf(__fdiv_rn(y, s));
  float d = fmodf(__fsub_rn(qv, qy), levels);
  if (d < 0.0f) d = __fadd_rn(d, levels);
  const float w = (d >= half) ? __fsub_rn(d, levels) : d;
  const float xh = __fmul_rn(__fadd_rn(qy, w), s);
  return average ? __fmul_rn(__fadd_rn(y, xh), 0.5f) : xh;
}

template <typename T, int QKIND>
__global__ void decode_avg_kernel(const void *__restrict__ q,
                                  const float *__restrict__ s,
                                  const T *__restrict__ y,
                                  const unsigned char *__restrict__ matched,
                                  T *__restrict__ out, long long n_rows,
                                  float levels, float half, int average) {
  const long long n_groups = n_rows * (kBlock / 4);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       gi < n_groups; gi += stride) {
    const long long row = gi / (kBlock / 4);
    const int c0 = (int)(gi % (kBlock / 4)) * 4;
    const long long off = row * kBlock + c0;
    if (matched != nullptr && matched[row] == 0) {
      copy4(y + off, out + off);
      continue;
    }
    const float sc = s[row];
    float yv[4], qv[4], o[4];
    load4(y + off, yv);
    load_codes<QKIND>(q, row, c0, qv);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = decode_one(qv[k], yv[k], sc, levels, half, average);
    store4(out + off, o);
  }
}

template <typename T>
int launch(const void *q, const float *s, const T *y,
           const unsigned char *matched, T *out, long long n_rows, int bits,
           int pack4, int average, cudaStream_t st) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  const long long n_groups = n_rows * (kBlock / 4);
  long long blocks = (n_groups + threads - 1) / threads;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  const float levels = (float)(1 << bits);
  const float half = (float)(1 << (bits - 1));
  if (pack4)
    decode_avg_kernel<T, 2><<<(unsigned)blocks, threads, 0, st>>>(
        q, s, y, matched, out, n_rows, levels, half, average);
  else if (bits <= 8)
    decode_avg_kernel<T, 0><<<(unsigned)blocks, threads, 0, st>>>(
        q, s, y, matched, out, n_rows, levels, half, average);
  else
    decode_avg_kernel<T, 1><<<(unsigned)blocks, threads, 0, st>>>(
        q, s, y, matched, out, n_rows, levels, half, average);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [n_rows, 256] uint8/uint16 or [n_rows, 128] uint8 (pack4); s: [n_rows]
// fp32; y, out: [n_rows, 256] fp32 (y_bf16 == 0) or bf16; matched: [n_rows]
// uint8 or null. Contiguous, aligned (checked by the Python wrapper).
// Returns cudaGetLastError().
extern "C" int decode_avg_launch(const void *q, const void *s, const void *y,
                                 const void *matched, void *out,
                                 long long n_rows, int bits, int pack4,
                                 int average, int y_bf16, void *stream) {
  if (bits < 1 || bits > 16 || (pack4 && bits > 4))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const unsigned char *mk = (const unsigned char *)matched;
  cudaStream_t st = (cudaStream_t)stream;
  if (y_bf16)
    return launch<__nv_bfloat16>(q, (const float *)s,
                                 (const __nv_bfloat16 *)y, mk,
                                 (__nv_bfloat16 *)out, n_rows, bits, pack4,
                                 average, st);
  return launch<float>(q, (const float *)s, (const float *)y, mk,
                       (float *)out, n_rows, bits, pack4, average, st);
}
