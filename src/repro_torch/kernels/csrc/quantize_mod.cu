// Modular (lattice) encode for Hopper (sm_90a) -- the sender half of every
// quantized gossip interaction.
//
// Replaces the TPU kernel src/repro/kernels/quantize_mod.py:48
// (quantize_mod_pallas -> _encode_kernel :27, pallas_call at :69). Per
// 256-wide row of the flat buffer:
//   s = max(max_c |x - ref| * safety/(L/2), min_scale),  L = 2^bits
//   q = floor(x/s + u) mod L      (uint8 for bits <= 8, uint16 for 9..16,
//                                  or two 4-bit codes per byte with pack4)
//
// Bound: memory. It reads x, ref and u (12 B per coordinate) and writes q
// (1 B at q8) plus one fp32 scale per row: ~13 B per coordinate, ~19.2 GB
// per launch on the main path (8 x 184.6M coordinates), ~5.7 ms at 3.35 TB/s.
//
// Design: one warp per row. Lane l holds columns [4l, 4l+4) and
// [128+4l, 128+4l+4) as two float4 loads of each input, so a warp reads
// each 1 KB input row in two fully coalesced 512-byte sweeps. The row max is
// a __shfl_xor_sync butterfly; max is exact in any order, so the scale is
// bitwise the plain version's. The division is __fdiv_rn (correctly
// rounded; never the fast approximate divide, which would shift codes),
// the floor-mod is fmodf plus a sign fix (floor semantics), and the store is
// one uchar4 / ushort4 per half. The pack4 half-split layout puts column c
// in the low nibble and column c+128 in the high nibble of byte c, which are
// exactly the two halves a lane already holds: the pack costs no exchange.
// `u` is an input drawn by the wrapper from a torch.Generator, as the JAX
// package draws it from jax.random outside its kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float absdiff_max(float d, float4 a, float4 b) {
  d = fmaxf(d, fabsf(__fsub_rn(a.x, b.x)));
  d = fmaxf(d, fabsf(__fsub_rn(a.y, b.y)));
  d = fmaxf(d, fabsf(__fsub_rn(a.z, b.z)));
  d = fmaxf(d, fabsf(__fsub_rn(a.w, b.w)));
  return d;
}

__device__ __forceinline__ unsigned int code(float x, float s, float u,
                                             float levels) {
  const float c = floorf(__fadd_rn(__fdiv_rn(x, s), u));
  float r = fmodf(c, levels);
  if (r < 0.0f) r = __fadd_rn(r, levels);
  return (unsigned int)r;
}

// KIND: 0 = uint8 codes, 1 = uint16 codes, 2 = uint8 nibble-packed.
template <int KIND>
__global__ void quantize_mod_kernel(const float *__restrict__ x,
                                    const float *__restrict__ ref,
                                    const float *__restrict__ u,
                                    void *__restrict__ q,
                                    float *__restrict__ s, long long n_rows,
                                    float scale_mul, float min_scale,
                                    float levels) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long row = warp; row < n_rows; row += n_warps) {
    const long long base = row * kBlock;
    const float4 *x4 = reinterpret_cast<const float4 *>(x + base);
    const float4 *r4 = reinterpret_cast<const float4 *>(ref + base);
    const float4 *u4 = reinterpret_cast<const float4 *>(u + base);
    const float4 xa = x4[lane], xb = x4[32 + lane];
    const float4 ra = r4[lane], rb = r4[32 + lane];
    const float4 ua = u4[lane], ub = u4[32 + lane];

    float d = absdiff_max(absdiff_max(0.0f, xa, ra), xb, rb);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d = fmaxf(d, __shfl_xor_sync(0xffffffffu, d, off));
    const float sc = fmaxf(__fmul_rn(d, scale_mul), min_scale);

    const unsigned int a0 = code(xa.x, sc, ua.x, levels);
    const unsigned int a1 = code(xa.y, sc, ua.y, levels);
    const unsigned int a2 = code(xa.z, sc, ua.z, levels);
    const unsigned int a3 = code(xa.w, sc, ua.w, levels);
    const unsigned int b0 = code(xb.x, sc, ub.x, levels);
    const unsigned int b1 = code(xb.y, sc, ub.y, levels);
    const unsigned int b2 = code(xb.z, sc, ub.z, levels);
    const unsigned int b3 = code(xb.w, sc, ub.w, levels);

    if (KIND == 0) {
      uchar4 *q4 = reinterpret_cast<uchar4 *>(
          static_cast<unsigned char *>(q) + base);
      q4[lane] = make_uchar4(a0, a1, a2, a3);
      q4[32 + lane] = make_uchar4(b0, b1, b2, b3);
    } else if (KIND == 1) {
      ushort4 *q4 = reinterpret_cast<ushort4 *>(
          static_cast<unsigned short *>(q) + base);
      q4[lane] = make_ushort4(a0, a1, a2, a3);
      q4[32 + lane] = make_ushort4(b0, b1, b2, b3);
    } else {
      uchar4 *q4 = reinterpret_cast<uchar4 *>(
          static_cast<unsigned char *>(q) + row * (kBlock / 2));
      q4[lane] = make_uchar4(a0 | (b0 << 4), a1 | (b1 << 4), a2 | (b2 << 4),
                             a3 | (b3 << 4));
    }
    if (lane == 0) s[row] = sc;
  }
}

}  // namespace

// x, ref, u: [n_rows, 256] fp32; q: [n_rows, 256] uint8/uint16 or
// [n_rows, 128] uint8 (pack4); s: [n_rows] fp32. Contiguous, 16-byte
// aligned (checked by the Python wrapper). Returns cudaGetLastError().
extern "C" int quantize_mod_launch(const void *x, const void *ref,
                                   const void *u, void *q, void *s,
                                   long long n_rows, float scale_mul,
                                   float min_scale, int bits, int pack4,
                                   void *stream) {
  if (bits < 1 || bits > 16 || (pack4 && bits > 4))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;  // 8 rows per block
  long long blocks = (n_rows + 7) / 8;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  const float levels = (float)(1 << bits);
  cudaStream_t st = (cudaStream_t)stream;
  const float *xf = (const float *)x, *rf = (const float *)ref,
              *uf = (const float *)u;
  float *sf = (float *)s;
  if (pack4)
    quantize_mod_kernel<2><<<(unsigned)blocks, threads, 0, st>>>(
        xf, rf, uf, q, sf, n_rows, scale_mul, min_scale, levels);
  else if (bits <= 8)
    quantize_mod_kernel<0><<<(unsigned)blocks, threads, 0, st>>>(
        xf, rf, uf, q, sf, n_rows, scale_mul, min_scale, levels);
  else
    quantize_mod_kernel<1><<<(unsigned)blocks, threads, 0, st>>>(
        xf, rf, uf, q, sf, n_rows, scale_mul, min_scale, levels);
  return (int)cudaGetLastError();
}
