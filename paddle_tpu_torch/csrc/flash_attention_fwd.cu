// Flash-attention forward for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/flash_attention.py
// _fwd_kernel (launched by _fwd through pl.pallas_call).  It computes the
// same function: for each (batch*head, query row)
//     O = softmax(q * sm_scale . k^T  [causal: q_offset + q_pos >= k_pos]) . v
// with the scale applied to q in q's dtype before the dot, masked scores
// set to the finite -1e30 (not -inf), f32 accumulation, and the row max m
// (of the scaled scores) and row sum l written beside O.  A row whose l is
// 0 outputs 0.  For bf16 inputs p is rounded to bf16 before p . v, as the
// TPU kernel casts p to v's dtype.
//
// What bounds it on this card.  At the served shape (B*H = 128 heads,
// T = 512, D = 64, f32, causal) one launch needs 2*D*BH*T*(T+1) = 4.3
// GFLOP and moves 68 MB (q, k, v, o once, plus m and l).  In f32 outside
// the tensor cores (67 TFLOP/s) that is 64 us of arithmetic against 20 us
// of memory traffic at 3.35 TB/s: the kernel is bound by operations, and
// the score matrix must never reach device memory.
//
// What this design does about it.  One thread block per (b*h, 64-row
// query tile), one thread per query row: the row's scaled q and its f32
// accumulator live in registers, K/V stream through shared memory in
// 64-key tiles that all 64 threads read by broadcast (float4 loads, four
// FMAs per load), and the online softmax runs over 16-key chunks so the
// rescale costs one exp per chunk.  Key tiles entirely above the causal
// diagonal of the query tile are skipped, which halves the causal work;
// the ragged tail (T not a multiple of 64) is masked in place instead of
// the TPU kernel's block halving.  It uses no tensor cores: the redesign
// with wgmma, TMA and warp specialisation is later work.  A head dim is
// padded with zeros up to 16, 32, 64 or 128 (the template width DP); at
// DP = 128 the two 128-float register arrays spill.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block, one per thread
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax update
constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask value

template <typename T> struct Cvt;

template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  // round to T's precision and back
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <typename T, int DP>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int tq, int tk, int d, float sm_scale, int causal,
                 int q_offset) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBlockK][DP]
  float* vs = ks + kBlockK * DP;                // [kBlockK][DP]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int row = q0 + threadIdx.x;
  const bool active = row < tq;
  const size_t q_base = (size_t)bh * tq * d;
  const size_t k_base = (size_t)bh * tk * d;

  // q * sm_scale in q's dtype: the scale is rounded to T, the product too
  const float scale_t = Cvt<T>::round(sm_scale);
  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    float x = 0.f;
    if (active && c < d) {
      x = Cvt<T>::round(Cvt<T>::to_f(q[q_base + (size_t)row * d + c]) *
                        scale_t);
    }
    qr[c] = x;
    acc[c] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;
  const int q_pos = q_offset + row;

  // Keys past the last row of this tile are masked for every row.  Once
  // every row has seen an unmasked key (key 0, when q_offset + q0 >= 0) a
  // masked key adds exp(-1e30 - m) = 0 exactly, so those tiles are skipped.
  int k_end = tk;
  if (causal && q_offset + q0 >= 0) {
    k_end = min(tk, q_offset + q0 + kBlockQ);
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    const int nk = min(kBlockK, tk - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < kBlockK * DP; i += kBlockQ) {
      const int j = i / DP;
      const int c = i - j * DP;
      float kx = 0.f, vx = 0.f;
      if (j < nk && c < d) {
        const size_t off = k_base + (size_t)(k0 + j) * d + c;
        kx = Cvt<T>::to_f(k[off]);
        vx = Cvt<T>::to_f(v[off]);
      }
      ks[i] = kx;
      vs[i] = vx;
    }
    __syncthreads();
    if (!active) continue;

    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) s[jj] = 0.f;
#pragma unroll
      for (int c = 0; c < DP; c += 4) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          // rows past nk hold zeros in shared memory; their score is
          // replaced below
          const float4 kk = *reinterpret_cast<const float4*>(
              &ks[(j0 + jj) * DP + c]);
          s[jj] = fmaf(qr[c], kk.x, s[jj]);
          s[jj] = fmaf(qr[c + 1], kk.y, s[jj]);
          s[jj] = fmaf(qr[c + 2], kk.z, s[jj]);
          s[jj] = fmaf(qr[c + 3], kk.w, s[jj]);
        }
      }
      float cmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int kpos = k0 + j0 + jj;
        if (causal && q_pos < kpos) s[jj] = kNegInf;
        if (j0 + jj < nk) cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
      float pv[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = (j0 + jj < nk) ? expf(s[jj] - m_new) : 0.f;
        psum += p;
        pv[jj] = Cvt<T>::round(p);  // p.astype(v.dtype) before p . v
      }
      l = l * alpha + psum;
#pragma unroll
      for (int c = 0; c < DP; c += 4) {
        float a0 = acc[c] * alpha, a1 = acc[c + 1] * alpha;
        float a2 = acc[c + 2] * alpha, a3 = acc[c + 3] * alpha;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &vs[(j0 + jj) * DP + c]);
          a0 = fmaf(pv[jj], vv.x, a0);
          a1 = fmaf(pv[jj], vv.y, a1);
          a2 = fmaf(pv[jj], vv.z, a2);
          a3 = fmaf(pv[jj], vv.w, a3);
        }
        acc[c] = a0;
        acc[c + 1] = a1;
        acc[c + 2] = a2;
        acc[c + 3] = a3;
      }
      m = m_new;
    }
  }

  if (!active) return;
  const float safe_l = l > 0.f ? l : 1.f;
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    if (c < d) {
      o[q_base + (size_t)row * d + c] = Cvt<T>::from_f(acc[c] / safe_l);
    }
  }
  m_out[(size_t)bh * tq + row] = m;
  l_out[(size_t)bh * tq + row] = l;
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* m, float* l, int bh, int tq, int tk, int d,
                   float sm_scale, int causal, int q_offset,
                   cudaStream_t stream) {
  const int smem = 2 * kBlockK * DP * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, DP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kBlockQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, l, tq, tk, d,
      sm_scale, causal, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* m, float* l, int bh, int tq, int tk, int d,
                     float sm_scale, int causal, int q_offset,
                     cudaStream_t stream) {
  if (d <= 16)
    return launch<T, 16>(q, k, v, o, m, l, bh, tq, tk, d, sm_scale, causal,
                         q_offset, stream);
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, m, l, bh, tq, tk, d, sm_scale, causal,
                         q_offset, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, m, l, bh, tq, tk, d, sm_scale, causal,
                         q_offset, stream);
  return launch<T, 128>(q, k, v, o, m, l, bh, tq, tk, d, sm_scale, causal,
                        q_offset, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  q [bh, tq, d], k and v
// [bh, tk, d], o [bh, tq, d], all contiguous and of one dtype (0: float32,
// 1: bfloat16); m and l [bh, tq] float32.  Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); allocates nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* m, void* l,
                                   int bh, int tq, int tk, int d,
                                   float sm_scale, int causal, int q_offset,
                                   int dtype, void* stream) {
  if (bh <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 128 ||
      (dtype != 0 && dtype != 1) || (tq + kBlockQ - 1) / kBlockQ > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, o, mf, lf, bh, tq, tk, d, sm_scale,
                            causal, q_offset, s)
          : dispatch<__nv_bfloat16>(q, k, v, o, mf, lf, bh, tq, tk, d,
                                    sm_scale, causal, q_offset, s);
  return (int)err;
}
