// Flash-attention forward for Hopper (sm_90a): wgmma tensor cores, TMA
// loads into a shared-memory ring, warp specialisation.  f32, bf16 and
// f16, head dims 1..256.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/flash_attention.py
// _fwd_kernel (launched by _fwd through pl.pallas_call).  It computes the
// same function: for each (batch, head, query row)
//     O = softmax(q * sm_scale . k^T  [causal: q_offset + q_pos >= k_pos]) . v
// with the scale rounded to q's dtype and applied to q in that dtype,
// masked scores set to the finite -1e30 (not -inf), f32 accumulation, and
// the row max m (of the scaled scores) and row sum l written beside O.  A
// row whose l is 0 outputs 0.  For bf16 inputs p is rounded to bf16
// before p . v while l sums the unrounded p, as the TPU kernel casts p to
// v's dtype; f16 is the bf16 route with the other 16-bit type.  Fully masked rows (a negative q_offset) see -1e30 for every
// key: they output the mean of v with l = Tk.
//
// What bounds it on this card.  At the served shape (B*H = 128 heads,
// T = 512, D = 64, f32, causal) one launch needs 2*D*BH*T*(T+1) = 4.3
// GFLOP and moves 68 MB.  The f32 path computes each product as split
// TF32 ("3xTF32": x = big + small, a.b ~ big_a.big_b + big_a.small_b +
// small_a.big_b, summed in f32), three TF32 tensor-core products per f32
// product: 12.9 GFLOP at 495 TFLOP/s is 26 us, against 20 us of memory
// traffic at 3.35 TB/s, so it is bound by operations.  bf16 runs one bf16
// product per product and is bound by bytes.  The score matrix never
// reaches device memory.
//
// The design.  A block of 384 threads owns 128 query rows of one head:
// two consumer warpgroups of 64 rows each and one producer warpgroup, of
// which one thread issues TMA loads (setmaxnreg moves registers from the
// producer to the consumers).  The producer loads each consumer's q tile
// once and streams K/V tiles of kBK keys into a ring of kStages stages,
// each completed on an mbarrier ("full") and released by the consumers
// on another ("empty").  The loads walk [B, T, H, D] views with any
// batch, row and head strides (the split views of the fc output), with
// 128-byte swizzle; rows past T and columns past D land as zeros.
//   S = q.k^T: wgmma from shared memory (K-major q and K tiles), S stays
//     in registers.  f32: before the first use the consumers split their
//     q tile, and together each K tile, into a TF32 "big" part written in
//     place and a "small" part in a second buffer, and run three wgmma
//     per k-step.
//   Online softmax on the S fragment: each row lives in the 4 threads of
//     a quad, so the row max and sum take two shuffles.  Keys past Tk are
//     -inf (p = 0), keys above the causal diagonal the finite -1e30.
//   O += p.v: bf16 runs wgmma with p from registers as the A operand and
//     the V tile as an MN-major B operand (transpose flag).  TF32 wgmma
//     takes only K-major operands, and V [key, D] is not K-major for p.v,
//     so at head dims up to 64 the consumers also write each V tile
//     transposed, split into big and small, beside it, and run three
//     wgmma per k-step with p's fragments from registers.  The keys of
//     each 8-key chunk are permuted (A column t is key 2t, t + 4 is key
//     2t + 1) so that the S accumulator already is the A fragment.  At
//     head dim 128 the transposed tiles do not fit shared memory, and p.v
//     runs on mma.sync m16n8k8 TF32 from registers, with the same key
//     order: the B fragments come straight from the swizzled V tile
//     without bank conflicts, split into big and small as they load.  At
//     the served shape the wgmma route is the faster (PERF.md).
// Causal scheduling: blocks take the heaviest query tiles first, and key
// tiles above a block's diagonal are skipped (exact once every row has
// seen key 0, so not when q_offset leaves a row fully masked).  The head
// dim is padded with zeros to a 128-byte row: 32, 64, 128 or 256 for f32
// (at 128 the key tile is 32 keys to fit shared memory), 64, 128 or 256
// for bf16 and f16.
// Head dims 129..256 run at DP = 256.  bf16/f16 keep two consumer
// warpgroups with 64-key tiles in a 2-stage ring (q 64 KB + K/V 2 x 64 KB)
// and p.v as one m64n256 wgmma.  f32 split TF32 cannot hold two 64-row q
// tiles in big and small parts (256 KB), so it runs one consumer
// warpgroup of 64 rows (q big + small 128 KB) over 16-key K/V tiles in a
// 2-stage ring (2 x 48 KB), scores on m64n16 wgmma and p.v on mma.sync, as
// at head dim 128; that block sets no register split (setmaxnreg).
// The consumers arrive on a stage's "empty" barrier once per warp, not
// once per thread: 256 arrives on one barrier word serialize.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kRowsWG = 64;                       // query rows per consumer warpgroup
constexpr float kNegInf = -1e30f;                 // the TPU kernel's finite mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;                // dynamic shared memory a block can use

// f32 p.v runs on wgmma from a transposed V tile at DP <= 64, where the
// transposed tiles fit shared memory, else on mma.sync
template <typename T, int DP>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kF16 = std::is_same<T, __half>::value;
  // f32 at DP 256: one consumer warpgroup, 16-key tiles (see the head note)
  static constexpr int kConsumers = (kF32 && DP == 256) ? 1 : 2;
  static constexpr int kBlockQ = kRowsWG * kConsumers;         // query rows per block
  static constexpr int kThreads = 128 * (kConsumers + 1);      // + the producer warpgroup
  static constexpr int kBK =                                   // keys per K/V tile
      !kF32 ? 64 : DP == 256 ? 16 : DP == 128 ? 32 : 64;
  static constexpr int kSwz = 128 / (int)sizeof(T);            // elements per 128-byte row
  static constexpr int kNCB = DP / kSwz;                       // 128-byte column blocks
  static constexpr int kParts = kF32 ? 2 : 1;                  // big (+ small) parts of q and K
  // f32 p.v on wgmma needs V transposed (big and small) beside each stage
  static constexpr bool kPvWgmma = kF32 && DP <= 64;
  static constexpr int kVtParts = kPvWgmma ? 2 : 0;
  static constexpr int kQBytes = kRowsWG * DP * (int)sizeof(T);   // one part of one q tile
  static constexpr int kKVBytes = kBK * DP * (int)sizeof(T);      // one part of a K or V tile
  static constexpr int kQTotal = kQBytes * kParts * kConsumers;
  static constexpr int kStageBytes = kKVBytes * (kParts + 1 + kVtParts);
  static constexpr int kFit = (kSmemLimit - 1024 - 256 - kQTotal) / kStageBytes;
  static constexpr int kStages = kFit > 4 ? 4 : kFit;
  static constexpr int kSmem = 1024 + kQTotal + kStages * kStageBytes + 256;
  static_assert(kStages >= 2, "the K/V ring needs two stages");
  static_assert(kSmem <= kSmemLimit, "shared memory");
  static_assert(DP % kSwz == 0, "head dim padding");
  static_assert(kF32 || kF16 || std::is_same<T, __nv_bfloat16>::value,
                "f32, bf16 or f16");
};

struct Params {
  void* o;
  float* m;
  float* l;
  long long o_sb, o_sr, o_sh;  // o strides in elements: batch, row, head
  int b, h, tq, tk, d;
  float scale;
  int causal, q_offset, n_qt;
  int slot_q[3], slot_k[3], slot_v[3];  // tensor-map coordinate of (row, head, batch)
};

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 4-D TMA tile load: column c0, then the three outer coordinates
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// a (row, head, batch) coordinate in the tensor map's own dimension order
__device__ __forceinline__ void tma_load_rhb(const CUtensorMap* map,
                                             uint32_t dst, uint32_t bar,
                                             int col, int row, int head,
                                             int batch, const int* slot) {
  int c[3];
  c[slot[0] - 1] = row;
  c[slot[1] - 1] = head;
  c[slot[2] - 1] = batch;
  tma_load(map, dst, bar, col, c[0], c[1], c[2]);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptors, 128-byte swizzle, 8-row groups 1024 B
// apart.  K-major: rows of the tile are the M or N index.  MN-major: rows
// are the K index, and `lbo` is the distance between 128-byte column blocks.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to the 16-bit type T and packed, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// x rounded to T and back (the scale rounded to q's dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half2float(__float2half_rn(x));
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], uint64_t a,
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t a,
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t a,
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_rs_n64(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_rs_n128(float (&d)[64],
                                        const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_rs_n256(float (&d)[128],
                                        const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_f16_n64(float (&d)[32], uint64_t a,
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_f16_rs_n64(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_f16_rs_n128(float (&d)[64],
                                        const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_f16_rs_n256(float (&d)[128],
                                        const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8], uint64_t a,
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                        const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- the two products ------------------------------------------------------

// S = q . K^T over the padded head dim; q and K tiles K-major in shared
// memory, 128-byte column blocks of kSwz elements.  f32: three TF32
// products per k-step (big.big + big.small + small.big).
template <typename T, int DP>
__device__ __forceinline__ void scores(float (&s)[Cfg<T, DP>::kBK / 2],
                                       uint32_t q_big, uint32_t q_small,
                                       uint32_t k_big, uint32_t k_small) {
  using C = Cfg<T, DP>;
  constexpr int kStep = C::kF32 ? 8 : 16;         // K of one wgmma
  constexpr int kPerBlock = C::kSwz / kStep;      // k-steps per column block
#pragma unroll
  for (int i = 0; i < C::kBK / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / kStep; ++ks) {
    const uint32_t off = (ks % kPerBlock) * 32;
    const uint32_t qo = (ks / kPerBlock) * (kRowsWG * 128) + off;
    const uint32_t ko = (ks / kPerBlock) * (C::kBK * 128) + off;
    if constexpr (C::kF32) {
      const uint64_t qb = desc_k(q_big + qo), qs = desc_k(q_small + qo);
      const uint64_t kb = desc_k(k_big + ko), kk = desc_k(k_small + ko);
      if constexpr (C::kBK == 64) {
        wgmma_tf32_n64(s, qb, kb, ks > 0);
        wgmma_tf32_n64(s, qb, kk, 1);
        wgmma_tf32_n64(s, qs, kb, 1);
      } else if constexpr (C::kBK == 32) {
        wgmma_tf32_n32(s, qb, kb, ks > 0);
        wgmma_tf32_n32(s, qb, kk, 1);
        wgmma_tf32_n32(s, qs, kb, 1);
      } else {
        wgmma_tf32_n16(s, qb, kb, ks > 0);
        wgmma_tf32_n16(s, qb, kk, 1);
        wgmma_tf32_n16(s, qs, kb, 1);
      }
    } else if constexpr (C::kF16) {
      wgmma_f16_n64(s, desc_k(q_big + qo), desc_k(k_big + ko), ks > 0);
    } else {
      wgmma_bf16_n64(s, desc_k(q_big + qo), desc_k(k_big + ko), ks > 0);
    }
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s);
}

// O += p . V for the warpgroup's 64 rows; p is the S fragment after the
// softmax (f32, unrounded), V the tile [kBK keys][DP] as TMA left it.
template <typename T, int DP>
__device__ __forceinline__ void accumulate_pv(float (&o)[DP / 2],
                                              float (&p)[Cfg<T, DP>::kBK / 2],
                                              const unsigned char* v_tile,
                                              uint32_t v_addr, int lane) {
  using C = Cfg<T, DP>;
  if constexpr (C::kPvWgmma) {
    // A fragments of p (keys permuted as in the transposed V), big and
    // small; B: V^T big and small, K-major, beside the V tile
    uint32_t ab[C::kBK / 8][4], as[C::kBK / 8][4];
#pragma unroll
    for (int c = 0; c < C::kBK / 8; ++c) {
      split_tf32(p[4 * c + 0], ab[c][0], as[c][0]);
      split_tf32(p[4 * c + 2], ab[c][1], as[c][1]);
      split_tf32(p[4 * c + 1], ab[c][2], as[c][2]);
      split_tf32(p[4 * c + 3], ab[c][3], as[c][3]);
    }
    const uint32_t vt_big = v_addr + C::kKVBytes;
    const uint32_t vt_small = vt_big + C::kKVBytes;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::kBK / 8; ++c) {
      const uint32_t off = (c / 4) * (DP * 128) + (c % 4) * 32;
      const uint64_t db = desc_k(vt_big + off), ds = desc_k(vt_small + off);
      if constexpr (DP == 64) {
        wgmma_tf32_rs_n64(o, ab[c], db);
        wgmma_tf32_rs_n64(o, ab[c], ds);
        wgmma_tf32_rs_n64(o, as[c], db);
      } else {
        wgmma_tf32_rs_n32(o, ab[c], db);
        wgmma_tf32_rs_n32(o, ab[c], ds);
        wgmma_tf32_rs_n32(o, as[c], db);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  } else if constexpr (C::kF32) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < C::kBK / 8; ++c) {
      // A fragment of keys 8c..8c+7, column t <- key 2t, t + 4 <- 2t + 1
      uint32_t ab[4], as[4];
      split_tf32(p[4 * c + 0], ab[0], as[0]);
      split_tf32(p[4 * c + 2], ab[1], as[1]);
      split_tf32(p[4 * c + 1], ab[2], as[2]);
      split_tf32(p[4 * c + 3], ab[3], as[3]);
      const int key = 8 * c + 2 * t;
#pragma unroll
      for (int nb = 0; nb < DP / 8; ++nb) {
        const int n = 8 * nb + g;
        const int col = (n / 32) * (C::kBK * 128) + ((n & 31) & 3) * 4;
        const int chunk = (n & 31) >> 2;
        const float v0 = *reinterpret_cast<const float*>(
            v_tile + col + key * 128 + ((chunk ^ (key & 7)) << 4));
        const float v1 = *reinterpret_cast<const float*>(
            v_tile + col + (key + 1) * 128 + ((chunk ^ ((key + 1) & 7)) << 4));
        uint32_t b0, b0s, b1, b1s;
        split_tf32(v0, b0, b0s);
        split_tf32(v1, b1, b1s);
        float* acc = &o[4 * nb];
        mma_tf32(acc, ab, b0, b1);
        mma_tf32(acc, ab, b0s, b1s);
        mma_tf32(acc, as, b0, b1);
      }
    }
  } else {
    // A fragments: p rounded to T, as the TPU kernel casts p to v's dtype
    uint32_t a[C::kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[kk][r] = pack2<T>(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kBK / 16; ++kk) {
      const uint64_t b = desc_mn(v_addr + kk * 16 * 128, C::kBK * 128);
      if constexpr (C::kF16) {
        if constexpr (DP == 64) {
          wgmma_f16_rs_n64(o, a[kk], b);
        } else if constexpr (DP == 128) {
          wgmma_f16_rs_n128(o, a[kk], b);
        } else {
          wgmma_f16_rs_n256(o, a[kk], b);
        }
      } else {
        if constexpr (DP == 64) {
          wgmma_bf16_rs_n64(o, a[kk], b);
        } else if constexpr (DP == 128) {
          wgmma_bf16_rs_n128(o, a[kk], b);
        } else {
          wgmma_bf16_rs_n256(o, a[kk], b);
        }
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  }
}

// ---- the kernel -------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const Params p) {
  using C = Cfg<T, DP>;
  constexpr int BK = C::kBK;
  constexpr int kConsumers = C::kConsumers;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms sit on 1 KB
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t stage0 = C::kQTotal;
  const uint32_t bars = base + C::kQTotal + C::kStages * C::kStageBytes;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (C::kStages + s); };
  auto q_bar = [&](int w) { return bars + 8 * (2 * C::kStages + w); };
  // q tile of consumer w, part 0 (big) or 1 (small)
  auto q_off = [&](int w, int part) {
    return (uint32_t)((w * C::kParts + part) * C::kQBytes);
  };

  // heaviest query tiles first: the last tile of every head, then the one
  // before, ...
  const int bh_count = p.b * p.h;
  const int qt = p.n_qt - 1 - (int)(blockIdx.x / bh_count);
  const int bh = blockIdx.x % bh_count;
  const int bi = bh / p.h, hi = bh % p.h;
  const int q0 = qt * C::kBlockQ;

  // keys each consumer needs: past the diagonal of its last row every
  // score is -1e30 and adds exp(-1e30 - m) = 0 once its rows have seen
  // key 0, which holds when its first row's position is >= 0
  int wg_end[kConsumers];
  bool wg_on[kConsumers];
  int k_end = 0;
#pragma unroll
  for (int w = 0; w < kConsumers; ++w) {
    const int row0 = q0 + w * kRowsWG;
    wg_on[w] = row0 < p.tq;
    int e = p.tk;
    if (p.causal && p.q_offset + row0 >= 0)
      e = min(p.tk, p.q_offset + row0 + kRowsWG);
    wg_end[w] = e;
    if (wg_on[w]) k_end = max(k_end, e);
  }
  const int n_kt = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), 4 * kConsumers);  // one arrive per consumer warp
    }
    for (int w = 0; w < kConsumers; ++w) mbar_init(q_bar(w), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the TMA loads in flight
    if constexpr (kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      for (int w = 0; w < kConsumers; ++w) {
        if (!wg_on[w]) continue;
        mbar_expect_tx(q_bar(w), C::kQBytes);
        for (int cb = 0; cb < C::kNCB; ++cb)
          tma_load_rhb(&q_map, base + q_off(w, 0) + cb * (kRowsWG * 128),
                       q_bar(w), cb * C::kSwz, q0 + w * kRowsWG, hi, bi,
                       p.slot_q);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % C::kStages;
        mbar_wait(empty_bar(s), ((j / C::kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar(s), 2 * C::kKVBytes);
        const uint32_t k_dst = base + stage0 + s * C::kStageBytes;
        const uint32_t v_dst = k_dst + C::kParts * C::kKVBytes;
        for (int cb = 0; cb < C::kNCB; ++cb) {
          tma_load_rhb(&k_map, k_dst + cb * (BK * 128), full_bar(s),
                       cb * C::kSwz, j * BK, hi, bi, p.slot_k);
          tma_load_rhb(&v_map, v_dst + cb * (BK * 128), full_bar(s),
                       cb * C::kSwz, j * BK, hi, bi, p.slot_v);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    if constexpr (kConsumers == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + wg * kRowsWG;
    const bool on = wg_on[wg];

    if (on) {
      // q * sm_scale in q's dtype; f32 splits it into TF32 big + small
      mbar_wait(q_bar(wg), 0);
      if constexpr (C::kF32) {
        float4* qb = reinterpret_cast<float4*>(smem + q_off(wg, 0));
        float4* qs = reinterpret_cast<float4*>(smem + q_off(wg, 1));
        for (int i = tid; i < C::kQBytes / 16; i += 128) {
          float4 x = qb[i], big, small;
          uint32_t b, s;
          split_tf32(x.x * p.scale, b, s);
          big.x = __uint_as_float(b); small.x = __uint_as_float(s);
          split_tf32(x.y * p.scale, b, s);
          big.y = __uint_as_float(b); small.y = __uint_as_float(s);
          split_tf32(x.z * p.scale, b, s);
          big.z = __uint_as_float(b); small.z = __uint_as_float(s);
          split_tf32(x.w * p.scale, b, s);
          big.w = __uint_as_float(b); small.w = __uint_as_float(s);
          qb[i] = big;
          qs[i] = small;
        }
      } else if constexpr (C::kF16) {
        const float scale_t = round_to<T>(p.scale);
        __half2* q2 = reinterpret_cast<__half2*>(smem + q_off(wg, 0));
        for (int i = tid; i < C::kQBytes / 4; i += 128) {
          const float2 x = __half22float2(q2[i]);
          q2[i] = __floats2half2_rn(x.x * scale_t, x.y * scale_t);
        }
      } else {
        const float scale_t = round_to<T>(p.scale);
        __nv_bfloat162* q2 =
            reinterpret_cast<__nv_bfloat162*>(smem + q_off(wg, 0));
        for (int i = tid; i < C::kQBytes / 4; i += 128) {
          const float2 x = __bfloat1622float2(q2[i]);
          q2[i] = __floats2bfloat162_rn(x.x * scale_t, x.y * scale_t);
        }
      }
      fence_proxy_async();
    }
    named_bar_sync(1 + wg, 128);

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m_r[2] = {kNegInf, kNegInf};
    float l_r[2] = {0.f, 0.f};
    int qpos[2];
    qpos[0] = p.q_offset + row0 + warp * 16 + g;
    qpos[1] = qpos[0] + 8;
    const uint32_t q_big = base + q_off(wg, 0);
    const uint32_t q_small = base + q_off(wg, C::kParts - 1);

    for (int j = 0; j < n_kt; ++j) {
      const int s = j % C::kStages;
      const uint32_t k_off = stage0 + s * C::kStageBytes;
      const uint32_t v_off = k_off + C::kParts * C::kKVBytes;
      mbar_wait(full_bar(s), (j / C::kStages) & 1);
      if constexpr (C::kF32) {
        // both consumers split the K tile: big in place, small beside it
        float4* kb = reinterpret_cast<float4*>(smem + k_off);
        float4* ks = reinterpret_cast<float4*>(smem + k_off + C::kKVBytes);
        for (int i = threadIdx.x; i < C::kKVBytes / 16; i += 128 * kConsumers) {
          float4 x = kb[i], big, small;
          uint32_t b, sm;
          split_tf32(x.x, b, sm);
          big.x = __uint_as_float(b); small.x = __uint_as_float(sm);
          split_tf32(x.y, b, sm);
          big.y = __uint_as_float(b); small.y = __uint_as_float(sm);
          split_tf32(x.z, b, sm);
          big.z = __uint_as_float(b); small.z = __uint_as_float(sm);
          split_tf32(x.w, b, sm);
          big.w = __uint_as_float(b); small.w = __uint_as_float(sm);
          kb[i] = big;
          ks[i] = small;
        }
        if constexpr (C::kPvWgmma) {
          // V^T [DP][kBK] big and small, K-major with 128-byte swizzle; in
          // each 8-key chunk column t is key 2t and t + 4 is key 2t + 1,
          // the order of p's A fragment
          const unsigned char* vt = smem + v_off;
          unsigned char* vb = smem + v_off + C::kKVBytes;
          unsigned char* vs = vb + C::kKVBytes;
          for (int i = threadIdx.x; i < C::kKVBytes / 16;
               i += 128 * kConsumers) {
            const int key = i % BK, n0 = (i / BK) * 4;
            const float4 x = *reinterpret_cast<const float4*>(
                vt + (n0 / 32) * (BK * 128) + key * 128 +
                ((((n0 & 31) >> 2) ^ (key & 7)) << 4));
            const int w = key & 7;
            const int kk = (key & ~7) + ((w & 1) ? 4 + (w >> 1) : (w >> 1));
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int n = n0 + e;
              const int at = (kk / 32) * (DP * 128) + n * 128 +
                             ((((kk & 31) >> 2) ^ (n & 7)) << 4) + (kk & 3) * 4;
              uint32_t b, sm;
              split_tf32(xs[e], b, sm);
              *reinterpret_cast<uint32_t*>(vb + at) = b;
              *reinterpret_cast<uint32_t*>(vs + at) = sm;
            }
          }
        }
        fence_proxy_async();
        named_bar_sync(1 + kConsumers, 128 * kConsumers);
      }
      const int k0 = j * BK;
      if (on && k0 < wg_end[wg]) {
        float sc[BK / 2];
        scores<T, DP>(sc, q_big, q_small, base + k_off,
                      base + k_off + C::kKVBytes);
        // mask, then the online softmax on the fragment: register i holds
        // row (i & 2 ? g + 8 : g), key 8 * (i / 4) + 2t + (i & 1)
        // only a tile that reaches past Tk or above the diagonal of the
        // warpgroup's first row has scores to mask
        if (k0 + BK > p.tk || (p.causal && k0 + BK - 1 > p.q_offset + row0)) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int kpos = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            if (kpos >= p.tk) {
              sc[i] = -INFINITY;
            } else if (p.causal && qpos[(i >> 1) & 1] < kpos) {
              sc[i] = kNegInf;
            }
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r]);
          alpha[r] = exp2f((m_r[r] - m_new) * kLog2e);
          m_r[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i >> 1) & 1;
          const float e = exp2f((sc[i] - m_r[r]) * kLog2e);
          sc[i] = e;
          psum[r] += e;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + psum[r];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        accumulate_pv<T, DP>(o, sc, smem + v_off, base + v_off, lane);
      }
      // the warp is done with the stage: one arrive for its 32 threads
      // (256 arrives on one barrier word would serialize)
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(s));
    }

    if (on) {
      // l is summed over the quad that shares a row; O = acc / l
      T* out = static_cast<T*>(p.o);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_r[r];
        l += __shfl_xor_sync(0xffffffff, l, 1);
        l += __shfl_xor_sync(0xffffffff, l, 2);
        const float safe_l = l > 0.f ? l : 1.f;
        const int row = row0 + warp * 16 + g + 8 * r;
        if (row < p.tq) {
          T* orow = out + bi * p.o_sb + (long long)row * p.o_sr + hi * p.o_sh;
#pragma unroll
          for (int nb = 0; nb < DP / 8; ++nb) {
            const int col = 8 * nb + 2 * t;
            const float x0 = o[4 * nb + 2 * r] / safe_l;
            const float x1 = o[4 * nb + 2 * r + 1] / safe_l;
            if (col + 1 < p.d) {
              if constexpr (C::kF32) {
                *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
              } else {
                *reinterpret_cast<uint32_t*>(orow + col) = pack2<T>(x0, x1);
              }
            } else if (col < p.d) {
              if constexpr (C::kF32) {
                orow[col] = x0;
              } else if constexpr (C::kF16) {
                orow[col] = __float2half_rn(x0);
              } else {
                orow[col] = __float2bfloat16_rn(x0);
              }
            }
          }
          if (t == 0) {
            const long long mi = (long long)bh * p.tq + row;
            p.m[mi] = m_r[r];
            p.l[mi] = l;
          }
        }
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links without -lcuda
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess) {
      ptr = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }();
  return fn;
}

// A [B, T, H, D] view with element strides (batch, row, head); the three
// outer dimensions enter the map in ascending order of stride, and
// `slot` records where (row, head, batch) went.
struct MapKey {
  const void* ptr;
  long long size[3];    // row, head, batch
  long long stride[3];  // row, head, batch, in elements
  int d, dtype, box_cols, box_rows;
};

struct MapEntry {
  MapKey key;
  CUtensorMap map;
  int slot[3];
  unsigned long long used;
};

constexpr int kCacheSize = 64;
std::mutex cache_mu;
MapEntry cache[kCacheSize];
int cache_n = 0;
unsigned long long cache_tick = 0;

// the tensor map for key (built once and cached: a forward launches the
// kernel 6 times on the same few buffers); 0 or the CUresult that failed
int tensor_map(const MapKey& key, CUtensorMap* map, int* slot) {
  std::lock_guard<std::mutex> lock(cache_mu);
  for (int i = 0; i < cache_n; ++i) {
    if (std::memcmp(&cache[i].key, &key, sizeof(MapKey)) == 0) {
      cache[i].used = ++cache_tick;
      *map = cache[i].map;
      std::memcpy(slot, cache[i].slot, sizeof(cache[i].slot));
      return 0;
    }
  }
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  int order[3] = {0, 1, 2};
  for (int a = 0; a < 3; ++a)
    for (int b = a + 1; b < 3; ++b)
      if (key.stride[order[b]] < key.stride[order[a]]) {
        const int x = order[a];
        order[a] = order[b];
        order[b] = x;
      }
  const int es = key.dtype == 0 ? 4 : 2;
  cuuint64_t dims[4] = {(cuuint64_t)key.d, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)key.box_cols, 1, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  int new_slot[3];
  for (int i = 0; i < 3; ++i) {
    const int which = order[i];
    dims[i + 1] = (cuuint64_t)key.size[which];
    strides[i] = (cuuint64_t)(key.stride[which] * es);
    if (which == 0) box[i + 1] = (cuuint32_t)key.box_rows;
    new_slot[which] = i + 1;
  }
  CUtensorMap made;
  CUresult res = encode(
      &made,
      key.dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : key.dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(key.ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return (int)res;
  int at = cache_n;
  if (cache_n < kCacheSize) {
    ++cache_n;
  } else {
    at = 0;
    for (int i = 1; i < kCacheSize; ++i)
      if (cache[i].used < cache[at].used) at = i;
  }
  cache[at].key = key;
  cache[at].map = made;
  std::memcpy(cache[at].slot, new_slot, sizeof(new_slot));
  cache[at].used = ++cache_tick;
  *map = made;
  std::memcpy(slot, new_slot, sizeof(new_slot));
  return 0;
}

MapKey map_key(const void* ptr, const long long* st, int rows, int b, int h,
               int d, int dtype, int box_cols, int box_rows) {
  MapKey key;
  std::memset(&key, 0, sizeof(key));  // padding takes part in the compare
  key.ptr = ptr;
  key.size[0] = rows;
  key.size[1] = h;
  key.size[2] = b;
  key.stride[0] = st[1];  // st: batch, row, head
  key.stride[1] = st[2];
  key.stride[2] = st[0];
  key.d = d;
  key.dtype = dtype;
  key.box_cols = box_cols;
  key.box_rows = box_rows;
  return key;
}

constexpr int kEncodeError = 10000;  // + the CUresult of a failed encode

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, Params& p,
           const long long* st, int dtype, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  p.n_qt = (p.tq + C::kBlockQ - 1) / C::kBlockQ;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  int* slots[3] = {p.slot_q, p.slot_k, p.slot_v};
  for (int i = 0; i < 3; ++i) {
    const MapKey key = map_key(ptrs[i], st + 3 * i, i == 0 ? p.tq : p.tk,
                               p.b, p.h, p.d, dtype, C::kSwz,
                               i == 0 ? kRowsWG : C::kBK);
    const int err = tensor_map(key, &maps[i], slots[i]);
    if (err != 0) return kEncodeError + err;
  }
  auto kernel = flash_fwd_kernel<T, DP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)p.n_qt * p.b * p.h;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, C::kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  q [b, tq, h, d], k and v
// [b, tk, h, d], o [b, tq, h, d], d in 1..256: views of one dtype
// (0: float32, 1: bfloat16, 2: float16) with unit stride in d,
// 16-byte-aligned base pointers, and
// `strides` holding 12 element strides, (batch, row, head) of q, k, v and
// o in turn, each a multiple of 16 bytes; m and l [b, h, tq] float32,
// contiguous.  Launches on `stream` and returns 0 on success, the
// cudaError_t of the launch, or 10000 + the CUresult of a tensor-map
// encode that failed; allocates nothing.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* m, void* l,
                                   int b, int h, int tq, int tk, int d,
                                   const long long* strides, float sm_scale,
                                   int causal, int q_offset, int dtype,
                                   void* stream) {
  if (b <= 0 || h <= 0 || tq <= 0 || tk <= 0 || d <= 0 || d > 256 ||
      dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int es = dtype == 0 ? 4 : 2;
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) {
      return (int)cudaErrorInvalidValue;
    }
  }
  for (int i = 0; i < 12; ++i) {
    if ((strides[i] * es) % 16) return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.o = o;
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.o_sb = strides[9];
  p.o_sr = strides[10];
  p.o_sh = strides[11];
  p.b = b;
  p.h = h;
  p.tq = tq;
  p.tk = tk;
  p.d = d;
  p.scale = sm_scale;
  p.causal = causal;
  p.q_offset = q_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (d <= 32) return launch<float, 32>(q, k, v, p, strides, dtype, s);
    if (d <= 64) return launch<float, 64>(q, k, v, p, strides, dtype, s);
    if (d <= 128) return launch<float, 128>(q, k, v, p, strides, dtype, s);
    return launch<float, 256>(q, k, v, p, strides, dtype, s);
  }
  if (dtype == 1) {
    if (d <= 64) return launch<__nv_bfloat16, 64>(q, k, v, p, strides, dtype, s);
    if (d <= 128) return launch<__nv_bfloat16, 128>(q, k, v, p, strides, dtype, s);
    return launch<__nv_bfloat16, 256>(q, k, v, p, strides, dtype, s);
  }
  if (d <= 64) return launch<__half, 64>(q, k, v, p, strides, dtype, s);
  if (d <= 128) return launch<__half, 128>(q, k, v, p, strides, dtype, s);
  return launch<__half, 256>(q, k, v, p, strides, dtype, s);
}
