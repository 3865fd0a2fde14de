// K4, tensor-core route: flash attention forward for bfloat16 q, k, v with
// head dim 64, 128 or 256, on Hopper's wgmma and TMA (sm_90a).
//
// Replaces, with flash_attention.cu (the SIMT route, which keeps float32
// and the other head dims), the TPU kernel `_flash_kernel` (launched by
// `flash_attention`) of src/repro/kernels/flash_attention.py. It computes
// the same function as flash_attention.cu, for q (B, Sq, Hq, D) and k, v
// (B, Skv, Hkv, D) in the model's layout, q-head h reading kv-head
// h / (Hq / Hkv):
//   s = (q . k) * scale;  s = softcap ? tanh(s / softcap) * softcap : s
//   valid = kpos < Skv && (!causal || qpos >= kpos)
//           && (window < 0 || qpos - kpos < window),  qpos = q_offset + row
//   o = sum_k softmax(s)[k] v[k]   (running f32 m, l, acc; l >= 1e-30, so a
//                                   row with no valid key gives 0)
// The route is chosen in src/repro_torch/kernels/flash_attention.py
// (`tc_route`); the plain version there is the reference for both routes.
//
// Bound on this card: operations. 4*D flops per reachable (query, key)
// pair and q-head; at B=1, S=2048, 24 heads, D=128, causal, 25.8 GFLOP at
// 989 TFLOP/s of bf16 tensor cores against 34 MB of q, k, v and o; at
// recurrentgemma's local layers (10 q-heads over one kv-head, D=256),
// 21.5 GFLOP against 23 MB. The kernel does 1.5x those flops (below), so
// its own ceiling is 1.5x the bound.
//
// Why P is split: the plain version keeps the probabilities p in f32 for
// the PV product, and the bf16 output is held to one bf16 step of it.
// Rounding p once to bf16 before a bf16 PV product leaves 95 of 6.3
// million outputs beyond that bound at the full-width shape (a CPU
// emulation, scripts/k4_bf16_p_emulation.py); p = hi + lo with
// hi = bf16(p), lo = bf16(p - hi) and two products (hi V + lo V) carries p
// to about 2^-17, and none is beyond it. QK^T needs no split: a bf16 x
// bf16 product is exact in f32.
//
// Design: one CTA of three warpgroups per (128-query block, q-head, batch
// row), the q-blocks with the most causal work launched first.
// - Warpgroup 0 is the producer (setmaxnreg 24): one thread issues TMA
//   loads (cp.async.bulk.tensor, 4-d maps over (B, S, H, D), 128-byte
//   swizzle, zero fill past S) of the Q tile once and of BK-key K and V
//   tiles into a 2-stage ring, with a full / empty mbarrier per stage. Only
//   the k tiles some query of the block can reach are loaded (the Pallas
//   kernel's `pl.when(live)` guard).
// - Warpgroups 1 and 2 (setmaxnreg 240) each own 64 query rows. Per tile:
//   S = Q K^T by wgmma m64nBKk16 (both operands K-major in shared memory)
//   into f32 registers; scale, softcap and the masks (only on tiles that
//   need them) in registers; the running m / l and the rescale of the
//   output accumulator; P packed to bf16 hi / lo in the register layout of
//   wgmma's A operand (the m64nNk16 accumulator fragment maps onto it, so P
//   never goes to shared memory); O += P_hi V + P_lo V by wgmma m64nDk16
//   with A from registers and V MN-major (transpose bit). A warp's lane 0
//   then releases the stage. The output is stored from registers with row
//   masks.
//
// Split over the keys (flash decoding for K4's general function): where
// the grid above holds fewer CTAs than the card has SMs (Whisper's
// cross-attention: one query row against 1,500 keys, 16 heads, 16 CTAs on
// 132 SMs, each walking 12 key tiles in series), the wrapper's
// `split_plan` cuts the keys into n_split <= 8 contiguous ranges of
// `split_keys` keys, a multiple of 128 so that both tile sizes nest in a
// range, and the grid gains the split on z (b * n_split + split). Each CTA
// runs the loop above over the live tiles of its range and stores its
// unnormalised f32 acc with its m (log2 units) and l, for query rows < Sq
// only, to f32 scratch the wrapper allocates; a range with no live tile
// stores m = MASK_VALUE, l = 0, acc = 0. A combine kernel merges the
// ranges of each (batch row, query row, q-head) in split order, so the
// result is the same bits on every run:
//   m = max m_s,  o = sum 2^(m_s - m) acc_s / max(sum 2^(m_s - m) l_s, 1e-30)
// It is launched with programmatic dependent launch: the split kernel
// lets it launch at its start, and it waits at `griddepcontrol.wait` for
// the split kernel's stores. Where every query row of a split CTA lies in
// its first 64 (a decode step's one query, the teacher-forced pass's 16),
// the second warpgroup would only compute rows that are never stored:
// both warpgroups then take those 64 rows, on alternate tiles of the
// range, each with its own m, l and acc, and merge through shared memory
// (the drained K/V ring) before the store, so the CTA's chain is half its
// tiles; warps whose 16 rows all lie past Sq skip their softmax. The
// unsplit instance (SPLIT = false) keeps none of this: the grids that fill
// the card run the loop above and its epilogue alone.
//
// Where the merge runs, measured at Whisper's cross-attention with
// scripts/k4_turns.py (H100 80GB HBM3, 700 W; CUDA events around each
// call, the L2 evicted before it, each in its own call as the design grew;
// the unsplit kernel 36.0-36.2 us): this combine kernel, loading every
// range at once, 14.2-14.3 us (SDPA 14.1); the same kernel loading one
// range at a time, 15.9 us; the last CTA of each tile merging in place
// after a fence and an atomic counter, 16.1-16.5 us with one range at a
// time and 15.0-15.3 with all at once; the ranges of a tile as one
// thread-block cluster merging over distributed shared memory, 17.2 us
// (clusters of 6 CTAs of one SM each do not all fit in one wave). The
// merge costs ~2.5 us of the kernel's ~10 us wherever it runs: stores, a
// fence or the grid's end, L2 reads.
//
// The key tile BK is per instance (`Smem<HD>::BK`), so that a consumer
// thread holds at most 192 accumulator and P registers (o_acc HD/2, s_acc
// BK/2, P hi + lo BK/2) under its 240:
//   D=64:  BK=128, 32 + 64 + 64;  Q 16 KB, K and V 2 x 2 x 16 KB:  81 KB
//   D=128: BK=128, 64 + 64 + 64;  Q 32 KB, K and V 2 x 2 x 32 KB: 161 KB
//   D=256: BK=64, 128 + 32 + 32;  Q 64 KB, K and V 2 x 2 x 32 KB: 193 KB
// of shared memory (with the barriers and the 1 KB alignment), under the
// 227 KB a block may have: one CTA per SM at D=128 and 256. At D=256 a
// third stage would need 257 KB, and BK=128 256 registers before any
// addressing. The work per tile and per barrier is the D=128 instance's:
// QK^T 64 x BK x D and PV twice 64 x D x BK per warpgroup.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;           // query rows per CTA (2 consumer warpgroups)
constexpr int STAGES = 2;         // K/V tiles in flight
constexpr int NT = 384;           // producer + 2 consumer warpgroups
constexpr int SPLIT_KEYS = 128;   // a split's key range is a multiple of it
constexpr int MAX_SPLIT = 8;      // ranges at most (the wrapper's plan)
constexpr int COMBINE_THREADS = 256;
constexpr float MASK_VALUE = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// PTX: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// barrier 1 over the `n` threads of the consumer warpgroups still running
// (the producer has left)
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a_desc,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a_desc,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major in
// shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A in registers, B MN-major in
// shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
template <int HD>
struct Smem {                      // byte offsets from a 1024-aligned base
  static constexpr int BK = HD == 256 ? 64 : 128;     // keys per tile
  static constexpr int CHUNKS = HD / 64;              // 128-byte column chunks
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;        // one K or V tile
  static constexpr int K = Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BARS = V + STAGES * KV_BYTES;  // q_full, full[], empty[]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// SPLIT only: `part` is f32 scratch of the n_split ranges, acc
// (n_split, B, Sq, Hq, HD), then m and l (n_split, B, Sq, Hq) each
template <int HD, bool SPLIT>
__global__ void __launch_bounds__(NT, 1) flash_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ part, int Sq, int Skv, int Hq, int Hkv, int q_offset,
    int causal, int window, float softcap, float scale, int n_split,
    int split_keys) {
  using L = Smem<HD>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K, sV = base + L::V;
  const uint32_t q_full = base + L::BARS;
  const uint32_t full0 = q_full + 8, empty0 = q_full + 8 * (1 + STAGES);

  // heaviest causal q-blocks first: q-blocks run in reverse on grid y
  const int h = blockIdx.x;
  const int b = SPLIT ? blockIdx.z / n_split : blockIdx.z;
  const int split = SPLIT ? blockIdx.z % n_split : 0;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int hk = h / (Hq / Hkv);
  const int q_abs = q_offset + q_start;
  // k tiles of this CTA's key range some query of the block can reach (the
  // Pallas live guard)
  int kb_end = (Skv + BK - 1) / BK;
  int kb_begin = 0;
  if constexpr (SPLIT) {
    // the combine kernel may launch now; it waits for this grid's stores
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    kb_begin = split * (split_keys / BK);
    kb_end = min(kb_end, kb_begin + split_keys / BK);
  }
  if (causal) kb_end = min(kb_end, (q_abs + BQ - 1) / BK + 1);
  if (window >= 0) {
    // live tiles: k_start + BK - 1 >= q_abs - window + 1
    const int lo = q_abs - window + 2 - BK;
    if (SPLIT && lo > 0) kb_begin = max(kb_begin, (lo + BK - 1) / BK);
    else if (lo > 0) kb_begin = (lo + BK - 1) / BK;
  }
  const int n_tiles = max(kb_end - kb_begin, 0);

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0 && (!SPLIT || n_tiles > 0)) {
      if constexpr (SPLIT) {   // the descriptors, before their first use
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&tm_q)) : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&tm_k)) : "memory");
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                         reinterpret_cast<uint64_t>(&tm_v)) : "memory");
      }
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < L::CHUNKS; ++c)
        tma_load_4d(sQ + c * BQ * 128, &tm_q, q_full, 64 * c, h, q_start, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int k_start = (kb_begin + it) * BK;
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * L::KV_BYTES);
        for (int c = 0; c < L::CHUNKS; ++c) {
          const uint32_t off = s * L::KV_BYTES + c * BK * 128;
          tma_load_4d(sK + off, &tm_k, full, 64 * c, hk, k_start, b);
          tma_load_4d(sV + off, &tm_v, full, 64 * c, hk, k_start, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g owns query rows 64 g .. 64 g + 63; in pair
  // mode both own rows 0 .. 63, warpgroup g the tiles it with it % 2 == g
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int g = wg - 1;
  const bool pair = SPLIT && Sq - q_start <= 64;
  const int g_rows = pair ? 0 : g;
  const int lane = tid & 31, warp = (tid >> 5) & 3, tq = lane & 3;
  // this thread's rows of the block: row0 and row0 + 8 (the wgmma fragment)
  const int row0 = 64 * g_rows + 16 * warp + (lane >> 2);
  const int q_min = q_abs + 64 * g_rows, q_max = q_min + 63;
  // SPLIT: a warp whose 16 rows all lie at or past Sq has nothing to store;
  // it skips its softmax (P = 0), which leaves the SM's exp2 and bf16
  // conversions to the live warps (one a warpgroup at Sq <= 16)
  const bool warp_dead = SPLIT && q_start + 64 * g_rows + 16 * warp >= Sq;

  float s_acc[BK / 2], o_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};
  // Q rows of this warpgroup: K-major, 128-byte swizzle, 8-row groups 1 KB
  // apart
  const uint64_t q_desc = sw128_desc(sQ + 64 * g_rows * 128, 16, 1024);

  if (!SPLIT || n_tiles > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k_start = (kb_begin + it) * BK;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const bool live = (!pair || (it & 1) == g) &&
                      !(causal && k_start > q_max) &&
                      !(window >= 0 && k_start + BK - 1 <= q_min - window);
    if (live) {
      const uint32_t k_tile = sK + s * L::KV_BYTES;
      const uint32_t v_tile = sV + s * L::KV_BYTES;
      // S = Q K^T: D/16 k-steps, 32 bytes apart inside a 128-byte chunk
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t q_off = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const uint32_t k_off = (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_ss(s_acc, q_desc + (q_off >> 4),
                 sw128_desc(k_tile + k_off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s_acc);

      // P as the A operand of BK/16 k-steps: register j of step kk holds
      // s_acc[8 kk + 2 j], s_acc[8 kk + 2 j + 1] (row j & 1)
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
      if (!warp_dead) {
        // scores in log2 units; masks only where the tile needs them.
        // s_acc[4 i + e]: row row0 + 8 (e >> 1),
        //                 key k_start + 8 i + 2 tq + (e & 1)
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float x = s_acc[i] * scale;
          if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
          s_acc[i] = x * LOG2E;
        }
        const bool full_tile = k_start + BK <= Skv &&
                               (!causal || k_start + BK - 1 <= q_min) &&
                               (window < 0 || q_max - k_start < window);
        if (!full_tile) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int kpos = k_start + 8 * (i >> 2) + 2 * tq + (i & 1);
            const int qpos = q_abs + row0 + 8 * ((i >> 1) & 1);
            const bool ok = kpos < Skv && (!causal || qpos >= kpos) &&
                            (window < 0 || qpos - kpos < window);
            if (!ok) s_acc[i] = MASK_VALUE;
          }
        }
        float m_new[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], s_acc[i]);
        float alpha[2], m_use[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {      // a row's BK keys sit on 4 lanes
          m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
          m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
          alpha[r] = exp2f(m[r] - m_new[r]);
          // no valid key yet: every score is MASK_VALUE and p must be 0
          m_use[r] = m_new[r] == MASK_VALUE ? 0.f : m_new[r];
          m[r] = m_new[r];
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = j & 1;
            const float p0 = exp2f(s_acc[8 * kk + 2 * j] - m_use[r]);
            const float p1 = exp2f(s_acc[8 * kk + 2 * j + 1] - m_use[r]);
            row_sum[r] += p0 + p1;
            const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
            const float2 hf = __bfloat1622float2(hi);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
            p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
            p_lo[kk][j] = *reinterpret_cast<const uint32_t*>(&lo);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + row_sum[r];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];
      } else {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) p_hi[kk][j] = p_lo[kk][j] = 0u;
      }

      // O += P_hi V + P_lo V; V MN-major: 8-key groups 1 KB apart, 64-column
      // chunks one tile of BK rows apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t v_desc =
            sw128_desc(v_tile + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs(o_acc, p_hi[kk], v_desc);
        wgmma_rs(o_acc, p_lo[kk], v_desc);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_acc);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // this warp is done with it
  }

  if (pair) {
    // warpgroup 1 hands its m, l (this lane's part) and acc to the thread
    // of warpgroup 0 that holds the same fragment, through the K/V ring,
    // which every tile's wait has drained
    float* xch = reinterpret_cast<float*>(smem_raw + (sK - smem_u32(smem_raw)));
    const int t = tid & 127;
    consumers_sync(256);
    if (g == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) xch[i * 128 + t] = o_acc[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xch[(HD / 2 + r) * 128 + t] = m[r];
        xch[(HD / 2 + 2 + r) * 128 + t] = l[r];
      }
    }
    consumers_sync(256);
    float f_own[2], f_other[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_other = xch[(HD / 2 + r) * 128 + t];
      const float m_new = fmaxf(m[r], m_other);
      f_own[r] = exp2f(m[r] - m_new);
      f_other[r] = exp2f(m_other - m_new);
      l[r] = l[r] * f_own[r] + xch[(HD / 2 + 2 + r) * 128 + t] * f_other[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i)
      o_acc[i] = o_acc[i] * f_own[(i >> 1) & 1] +
                 xch[i * 128 + t] * f_other[(i >> 1) & 1];
  }

  // o_acc[4 i + e]: row row0 + 8 (e >> 1), column 8 i + 2 tq + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (SPLIT) {
    // this range's m, l and unnormalised acc, for the combine kernel (in
    // pair mode warpgroup 0 holds them)
    const long long rows = (long long)(gridDim.z / n_split) * Sq * Hq;
    float* part_m = part + n_split * rows * HD;
    float* part_l = part_m + n_split * rows;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sq = q_start + row0 + 8 * r;
      if (sq >= Sq || (pair && g == 1)) continue;
      const long long row = split * rows + ((long long)b * Sq + sq) * Hq + h;
      float* arow = part + row * HD + 2 * tq;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<float2*>(arow + 8 * i) =
            make_float2(o_acc[4 * i + 2 * r], o_acc[4 * i + 2 * r + 1]);
      if (tq == 0) {
        part_m[row] = m[r];
        part_l[row] = l[r];
      }
    }
  } else {
    // o = acc / l
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaxf(l[r], 1e-30f);
    const long long q_stride = (long long)Hq * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sq = q_start + row0 + 8 * r;
      if (sq >= Sq) continue;
      __nv_bfloat16* orow = o + ((long long)b * Sq + sq) * q_stride +
                            (long long)h * HD + 2 * tq;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
            __floats2bfloat162_rn(o_acc[4 * i + 2 * r] / l[r],
                                  o_acc[4 * i + 2 * r + 1] / l[r]);
    }
  }
}

// merges the n_split ranges of `rows` (batch row, query row, q-head) rows in
// split order; a thread takes 4 columns of one row and loads the partials
// of every range at once (n_split <= MAX_SPLIT: one round trip). Launched
// with programmatic dependent launch behind the split kernel: it waits
// here for that grid's stores.
template <int HD>
__global__ void __launch_bounds__(COMBINE_THREADS) flash_tc_combine_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ o,
    long long rows, int n_split) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long e = (long long)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (e >= rows * (HD / 4)) return;
  const long long row = e / (HD / 4);
  const int col = (int)(e % (HD / 4)) * 4;
  const float* part_m = part + n_split * rows * HD;
  const float* part_l = part_m + n_split * rows;
  float mb[MAX_SPLIT], lb[MAX_SPLIT];
  float4 xb[MAX_SPLIT];
#pragma unroll
  for (int sp = 0; sp < MAX_SPLIT; ++sp) {
    const long long at = sp * rows + row;
    const bool in = sp < n_split;
    mb[sp] = in ? part_m[at] : MASK_VALUE;
    lb[sp] = in ? part_l[at] : 0.f;
    xb[sp] = in ? *reinterpret_cast<const float4*>(part + at * HD + col)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float mx = MASK_VALUE, l_sum = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int sp = 0; sp < MAX_SPLIT; ++sp) mx = fmaxf(mx, mb[sp]);
#pragma unroll
  for (int sp = 0; sp < MAX_SPLIT; ++sp) {
    if (sp >= n_split) break;
    const float f = exp2f(mb[sp] - mx);
    l_sum += lb[sp] * f;
    a[0] += xb[sp].x * f;
    a[1] += xb[sp].y * f;
    a[2] += xb[sp].z * f;
    a[3] += xb[sp].w * f;
  }
  l_sum = fmaxf(l_sum, 1e-30f);
  __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(o + row * HD + col);
  orow[0] = __floats2bfloat162_rn(a[0] / l_sum, a[1] / l_sum);
  orow[1] = __floats2bfloat162_rn(a[2] / l_sum, a[3] / l_sum);
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if __CUDACC_VER_MAJOR__ > 12
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 (B, S, H, D) tensor as a 4-d map with boxes of 64 columns x `rows`
// rows of one head, 128-byte swizzle; rows past S read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
              int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool SPLIT>
int launch_instance(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                    const CUtensorMap& tm_v, void* o, float* part, int B,
                    int Sq, int Skv, int Hq, int Hkv, int q_offset, int causal,
                    int window, float softcap, float scale, int n_split,
                    int split_keys, cudaStream_t stream) {
  const int smem = Smem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hq, (Sq + BQ - 1) / BQ, B * n_split);
  flash_tc_kernel<HD, SPLIT><<<grid, NT, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), part, Sq, Skv, Hq,
      Hkv, q_offset, causal, window, softcap, scale, n_split, split_keys);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* part,
           int B, int Sq, int Skv, int Hq, int Hkv, int q_offset, int causal,
           int window, float softcap, float scale, int n_split,
           int split_keys, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, B, Sq, Hq, HD, BQ) ||
      !make_map(&tm_k, k, B, Skv, Hkv, HD, Smem<HD>::BK) ||
      !make_map(&tm_v, v, B, Skv, Hkv, HD, Smem<HD>::BK))
    return (int)cudaErrorInvalidValue;
  if (n_split == 1)
    return launch_instance<HD, false>(tm_q, tm_k, tm_v, o, nullptr, B, Sq,
                                      Skv, Hq, Hkv, q_offset, causal, window,
                                      softcap, scale, 1, 0, stream);
  const int status = launch_instance<HD, true>(
      tm_q, tm_k, tm_v, o, part, B, Sq, Skv, Hq, Hkv, q_offset, causal,
      window, softcap, scale, n_split, split_keys, stream);
  if (status != (int)cudaSuccess) return status;
  // the combine, allowed to launch while the split kernel runs
  const long long rows = (long long)B * Sq * Hq;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows * (HD / 4) + COMBINE_THREADS - 1) /
                                COMBINE_THREADS));
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, flash_tc_combine_kernel<HD>,
                                 static_cast<const float*>(part),
                                 static_cast<__nv_bfloat16*>(o), rows,
                                 n_split);
}

}  // namespace

// bf16 q, k, v with head dim 64, 128 or 256, Skv > 0, 16-byte aligned
// pointers. With n_split > 1 (at most MAX_SPLIT), the keys are cut into
// ranges of `split_keys` (a positive multiple of 128), none of them empty,
// and `part` is f32 scratch of n_split * B * Sq * Hq * (D + 2) floats.
extern "C" int repro_flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, void* part, int B,
    int Sq, int Skv, int Hq, int Hkv, int D, int q_offset, int causal,
    int window, float softcap, float scale, int n_split, int split_keys,
    void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0 ||
      (Sq + BQ - 1) / BQ > 65535 || n_split < 1 || n_split > MAX_SPLIT ||
      (long long)B * n_split > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 &&
      (part == nullptr || split_keys <= 0 || split_keys % SPLIT_KEYS != 0 ||
       (long long)(n_split - 1) * split_keys >= Skv ||
       (long long)n_split * split_keys < Skv))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (D == 256)
    return launch<256>(q, k, v, o, p, B, Sq, Skv, Hq, Hkv, q_offset, causal,
                       window, softcap, scale, n_split, split_keys, s);
  if (D == 128)
    return launch<128>(q, k, v, o, p, B, Sq, Skv, Hq, Hkv, q_offset, causal,
                       window, softcap, scale, n_split, split_keys, s);
  if (D == 64)
    return launch<64>(q, k, v, o, p, B, Sq, Skv, Hq, Hkv, q_offset, causal,
                      window, softcap, scale, n_split, split_keys, s);
  return (int)cudaErrorInvalidValue;
}
