// Pieces shared by the recurrence kernels (rwkv6.cu, mamba2.cu): widening
// loads and narrowing stores, cp.async staging of one time step's row of a
// strided stream, and the reduction of many per-lane sums over the lanes
// of a group at once, in one fixed order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scan {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// The widest copy, 16, 8, 4 or 2 bytes, that every row of a stream takes:
// the base address, the row stride and the row's length all multiples of
// it (x, b and c may be column slices of a fused projection).
__host__ __device__ inline int copy_width(const void* base,
                                          long long stride_bytes,
                                          int row_bytes) {
  const unsigned long long bits =
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(base)) |
      static_cast<unsigned long long>(stride_bytes) |
      static_cast<unsigned long long>(row_bytes);
  for (int w = 16; w > 2; w /= 2) {
    if (bits % w == 0) return w;
  }
  return 2;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int width) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (width == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else if (width == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// All threads of the block copy `rows` rows of `row_bytes` bytes, row r
// from src + r * src_stride to dst + r * dst_stride (shared memory),
// `width` bytes a copy (copy_width): cp.async from 4 bytes up, which the
// caller commits and waits for; a 2-byte stream by plain loads and stores,
// visible after the caller's next barrier.
__device__ __forceinline__ void stage(void* dst, int dst_stride,
                                      const void* src, long long src_stride,
                                      int row_bytes, int rows, int width) {
  const int per = row_bytes / width, total = rows * per;
  int r = threadIdx.x / per, c = threadIdx.x - r * per;   // copy e's place
  const int dr = blockDim.x / per, dc = blockDim.x - dr * per;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    char* d = static_cast<char*>(dst) + r * dst_stride + c * width;
    const char* s =
        static_cast<const char*>(src) + r * src_stride + c * width;
    if (width >= 4) {
      cp_async(d, s, width);
    } else {
      *reinterpret_cast<unsigned short*>(d) =
          *reinterpret_cast<const unsigned short*>(s);
    }
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// All threads of the block widen n bf16 values (src 16-byte aligned) to
// fp32 (dst 16-byte aligned), 8 a thread at a time.
__device__ __forceinline__ void widen_rows(float* dst,
                                          const __nv_bfloat16* src, int n) {
  const int full = n & ~7;
  for (int e = 8 * threadIdx.x; e < full; e += 8 * blockDim.x) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + e);
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
    *reinterpret_cast<float4*>(dst + e) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(dst + e + 4) =
        make_float4(f[4], f[5], f[6], f[7]);
  }
  for (int e = full + threadIdx.x; e < n; e += blockDim.x) {
    dst[e] = __bfloat162float(src[e]);
  }
}

// Sums each of the K slots of v over the GROUP lanes whose lane ids differ
// only in the bits STRIDE * (1, 2, ..., GROUP / 2): one butterfly level a
// bit, the highest bit first when HIGH_FIRST, else the lowest.  While a lane
// holds more than one slot, a level halves them (the lane keeps the half its
// bit selects, sends the other, and adds what its partner sent: K / 2
// shuffles a level instead of K); once it holds one, a level adds the
// partner's copy.  Every slot is summed by the same tree whatever K is, so
// a kernel's y bits do not depend on how many sums it reduces at once.
// Returns the first slot left in v[0 .. max(1, K / GROUP) - 1]; `owner` is
// false on the lanes that hold a copy of a slot another lane also holds.
template <int K, int GROUP, int STRIDE, bool HIGH_FIRST>
__device__ __forceinline__ int reduce_slots(float (&v)[K], int lane,
                                           bool& owner) {
  constexpr int LEVELS = log2i(GROUP);
  int base = 0;
  owner = true;
#pragma unroll
  for (int li = 0; li < LEVELS; ++li) {
    const int off = STRIDE << (HIGH_FIRST ? LEVELS - 1 - li : li);
    const bool upper = (lane & off) != 0;
    const int held = K >> li;
    if (held > 1) {
      const int half = held / 2;
#pragma unroll
      for (int i = 0; i < K / 2; ++i) {
        if (i < half) {
          const float send = upper ? v[i] : v[i + half];
          const float keep = upper ? v[i + half] : v[i];
          v[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, off));
        }
      }
      if (upper) base += half;
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(FULL, v[0], off));
      if (upper) owner = false;
    }
  }
  return base;
}

}  // namespace scan
