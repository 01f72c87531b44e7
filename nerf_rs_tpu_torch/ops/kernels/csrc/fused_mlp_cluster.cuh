// Thread-block cluster pieces of K1's wide bf16 kernel
// (fused_mlp_wide_tc.cu): a weight ring whose chunks a group of CTAs of
// one cluster shares, each chunk copied once from L2 for the whole group
// by cp.async.bulk's multicast, and the barrier that joins the CTAs of a
// cluster.
//
// The shared ring (ClusterProducer, ClusterPipe). A group of G CTAs of a
// cluster (its members named by a 16-bit mask of cluster ranks) consumes
// the same chunk sequence into the same stages. For every chunk each
// member's producer thread expects the whole chunk's bytes on its own
// full[s] barrier and copies its share of the chunk's runs into stage s
// of every member (multicast copies, each of which signals each member's
// full[s] with the bytes it lands there). A member's stage is written by all G producers, so it
// may be refilled only once every member's consumers have released it:
// each consumer warp arrives, after its wgmmas on the chunk have retired,
// on empty[s] of every member (remote arrives through mapa), and empty[s]
// expects 8 G arrivals (8 consumer warps a CTA).
//
// Every member walks the same number of chunks: a CTA whose tiles run out
// before its group's keeps walking on a tile of zeros whose stores are
// masked (the callers' tile loops), so no producer copies into a CTA that
// has left, and cluster_sync() before any thread exits keeps every CTA's
// barriers alive while its peers may still arrive on them.

#pragma once

#include "fused_mlp_tc.cuh"

namespace nerf {
namespace cluster {

using namespace tc;

__device__ __forceinline__ uint32_t ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The shared::cluster address of shared::cta address `addr` in the CTA of
// cluster rank `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Lane 0 of the warp arrives on the mbarrier at shared::cluster address
// `bar` (any CTA of the cluster), with the default semantics (release at
// CTA scope), as a ring's consumer releases a stage: what it orders is
// this warp's wgmma reads of the stage, retired before, against the
// producers' copies after. (At cluster scope each arrive waits for the
// thread's writes to be visible cluster-wide: a chunk's arrives so made
// the bf16 kernel 2.5x slower.) Every lane executes it, predicated: a
// branch on the lane between wgmmas made ptxas serialize them (C7520).
__device__ __forceinline__ void warp_arrive_remote(uint32_t bar) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cluster.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(threadIdx.x & 31)
      : "memory");
}

// Copies `bytes` from global memory to shared address `dst` in every CTA of
// `mask` (cluster ranks), completing transactions on the mbarrier at the
// same offset `bar` in each.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// Every thread of the cluster that has not exited (none may exit before
// it): arrive and wait, releasing and acquiring at cluster scope. Not
// .aligned: the threads of a warp may reach it apart.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

constexpr int kConsumerWarps = kConsumers / 32;

// The members of a group of G: `mask` of cluster ranks, this CTA the
// `index`-th (in rank order).
struct Group {
  uint16_t mask;
  int index;
};

// One producer thread's walk through a ring of S stages of kBytes that a
// group of G CTAs shares.
template <int S, int kBytes, int G>
struct ClusterProducer {
  uint32_t ring, bars;   // full[s] at bars + 8 s, empty[s] at bars + 8 (S + s)
  Group grp;
  int stage;
  uint32_t phase;

  // Copies the next chunk, `runs` runs of run_bytes (a multiple of 16)
  // from src, `stride` bytes apart in global memory, laid end to end in
  // the stage, once every member has released its stage: the member of
  // index i copies runs i, i + G, ... into every member.
  __device__ __forceinline__ void put(const void* src, uint32_t run_bytes, int runs,
                                      long long stride) {
    mbar_wait(bars + 8 * (S + stage), phase ^ 1);
    mbar_expect_tx(bars + 8 * stage, run_bytes * runs);
    for (int r = grp.index; r < runs; r += G) {
      bulk_copy_multicast(ring + stage * kBytes + r * run_bytes,
                          static_cast<const uint8_t*>(src) + r * stride, run_bytes,
                          bars + 8 * stage, grp.mask);
    }
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The barriers' initial state: full[s] takes one arrival (the local
// producer's expect_tx), empty[s] one a consumer warp of each of G members.
template <int S, int G>
__device__ __forceinline__ void init_ring(uint32_t bars) {
  for (int s = 0; s < S; ++s) {
    mbar_init(bars + 8 * s, 1);
    mbar_init(bars + 8 * (S + s), kConsumerWarps * G);
  }
}

// The consumers' walk through a ring of S stages of kBytes that the G CTAs
// of a cluster share: tc::Pipe's interface (acquire, advance, release),
// each release an arrival of this warp on the stage's empty barrier in
// every CTA. advance() retires the chunk's wgmmas and releases it at once;
// tc::Pipe releases it one chunk behind, which measured no faster
// (tools/torch_wide_k1_profile.py) and holds a stage longer.
template <int S, int kBytes, int G>
struct ClusterPipe {
  uint32_t ring, bars;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(bars + 8 * stage, phase);
    __syncwarp();   // the spin may exit lane by lane; wgmma wants the warp converged
    wgmma_fence();
    return ring + stage * kBytes;
  }

  // This warp is done with stage s in every CTA.
  __device__ __forceinline__ void free_stage(int s) {
    const uint32_t bar = bars + 8 * (S + s);
#pragma unroll
    for (int r = 0; r < G; ++r) warp_arrive_remote(mapa(bar, r));
  }

  __device__ __forceinline__ void next() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }

  // After the wgmmas on the acquired chunk are committed: they retire, the
  // chunk is released, and the walk moves on.
  __device__ __forceinline__ void advance() {
    wgmma_wait<0>();
    free_stage(stage);
    next();
  }

  // tc::Pipe's release of the last chunk: none is held.
  __device__ __forceinline__ void release() {}
};

}  // namespace cluster
}  // namespace nerf
