"""Emulated CUDA for running the port's kernel sources on the CPU.

g++ compiles a ``.cu`` file of ``clip_lite_torch/ops/csrc`` against the
headers below instead of the CUDA toolkit's.  One ``std::thread``-like
pthread runs each CUDA thread; the blocks of one thread block cluster run
at once (a cluster of one block where the launch names none), one cluster
after another.  ``__syncthreads`` and ``__syncwarp`` are barriers, the
shuffles warp collectives; each block has its own shared memory, which
``cooperative_groups``' ``map_shared_rank`` maps across the cluster, and
``cluster.sync()`` is a barrier over the cluster's threads.  The host
API that an entry point calls (pinned and device allocations, copies,
events) works on host memory at once.  The
``__*_rn`` intrinsics are the host's IEEE operations, which g++ does not
contract at ``-std=c++20`` on x86-64 (``__fmaf_rn`` is ``std::fma``, one
rounding).

A test rewrites a source in three ways before it compiles it:

- each ``kernel<<<grid, block, smem, stream>>>(args)`` becomes
  ``emu_launch(kernel, grid, block, smem, stream, args)``
  (:func:`rewrite_launches`); ``cudaLaunchKernelEx`` is emulated as it is;
- each shared-memory declaration becomes a reference into the block's
  emulated shared memory (the caller's own substitutions);
- inline PTX helpers become emulated collectives (the caller's), and the
  cp.async copies queued copies done at the thread's wait
  (:func:`emulate_cp_async`).

This says nothing of the PTX's syntax, the card's memory model or speed.
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "clip_lite_torch" / "ops" / "csrc"

CUDA_RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <math.h>
#include <memory>
#include <pthread.h>
#include <stdint.h>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __align__(n)
#define __launch_bounds__(...)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}

// Round to nearest even, one operation each, as on the card.
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __frcp_rn(float a) { return 1.f / a; }
// The card's __expf is ex2.approx of x log2(e), within a few ulp of exp;
// the host's exp stands in for it.
inline float __expf(float x) { return std::exp(x); }
// Round toward minus infinity: the nearest sum, one step down where the
// exact sum (its error by Knuth's two-sum) lies below it.
inline float __fadd_rd(float a, float b) {
  volatile float s = a + b;
  const float bb = s - a, err = (a - (s - bb)) + (b - bb);
  return err < 0.f ? std::nextafter((float)s, -INFINITY) : (float)s;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// Bytes of the 8 bytes (y:x) picked by the selector's nibbles (0-7).
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long xy = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)((xy >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return (unsigned)((((unsigned long long)hi << 32) | lo) >> (shift & 31));
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
typedef void* cudaEvent_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9, cudaErrorMisalignedAddress = 716 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
                         cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
enum { cudaSharedmemCarveoutMaxShared = 100 };
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }

// The host's memory stands in for pinned and device memory, the running
// thread for a stream: copies happen at once, events are always reached.
enum { cudaHostAllocDefault = 0, cudaEventDisableTiming = 2 };
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1 };
inline cudaError_t cudaMalloc(void** p, size_t n) {
  *p = std::malloc(n);
  return *p ? 0 : 2;
}
inline cudaError_t cudaHostAlloc(void** p, size_t n, unsigned) {
  return cudaMalloc(p, n);
}
inline cudaError_t cudaFree(void* p) { std::free(p); return 0; }
inline cudaError_t cudaFreeHost(void* p) { std::free(p); return 0; }
inline cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n,
                                   cudaMemcpyKind, cudaStream_t) {
  std::memcpy(d, s, n);
  return 0;
}
inline cudaError_t cudaEventCreateWithFlags(cudaEvent_t* e, unsigned) {
  *e = (void*)1;
  return 0;
}
inline cudaError_t cudaEventRecord(cudaEvent_t, cudaStream_t) { return 0; }
inline cudaError_t cudaEventSynchronize(cudaEvent_t) { return 0; }
inline cudaError_t cudaEventDestroy(cudaEvent_t) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// Two SMs with room for one block each: a grid sized to the card runs
// few blocks, each over several items.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return 0;
}
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaSetDevice(int d) { return d == 0 ? 0 : 1; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "emulated error" : "no error";
}

constexpr size_t kEmuSmemBytes = 256 * 1024;

// One warp's exchange slots for the collectives.
struct Warp {
  std::barrier<>* bar;
  const void* ptr[32];
  unsigned char val[32][8];
  uint32_t a[32][4];
  uint32_t b[32][2];
};
struct alignas(16) EmuSmem { unsigned char bytes[kEmuSmemBytes]; };
// One block's barrier, warps and shared memory.
struct EmuBlock {
  std::barrier<>* bar;
  Warp* warps;
  unsigned char* smem;
};
// The running cluster: its barrier and each block's shared memory.
struct EmuCluster {
  std::barrier<>* bar;
  std::vector<unsigned char*> smem;
};

inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 gridDim, blockDim;
inline thread_local EmuBlock* emu_block;
inline thread_local EmuCluster* emu_cluster;
inline thread_local unsigned emu_cluster_rank;

inline unsigned char* emu_block_smem() { return emu_block->smem; }
inline Warp& my_warp() { return emu_block->warps[threadIdx.x / 32]; }
inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { my_warp().bar->arrive_and_wait(); }

template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int o) {
  static_assert(sizeof(T) <= 8, "one slot a lane");
  Warp& w = my_warp();
  const int lane = threadIdx.x % 32;
  std::memcpy(w.val[lane], &v, sizeof(T));
  w.bar->arrive_and_wait();
  T r;
  std::memcpy(&r, w.val[lane ^ o], sizeof(T));
  w.bar->arrive_and_wait();
  return r;
}

inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }

// cp.async: a copy the thread queues in its open group, done at a wait
// that the group's commit falls under, so that shared memory read before
// the wait holds what it held before.
struct EmuCopy {
  void* dst;
  const void* src;
  size_t n;
  unsigned group;
};
inline thread_local std::vector<EmuCopy> emu_copies;
inline thread_local unsigned emu_groups = 0;  // groups committed
inline void emu_cp_async(void* dst, const void* src, size_t n) {
  emu_copies.push_back({dst, src, n, emu_groups});
}
inline void emu_cp_async_commit() { ++emu_groups; }
// Every committed group but the newest `pending` done.
inline void emu_cp_async_wait(unsigned pending) {
  std::vector<EmuCopy> rest;
  for (const EmuCopy& c : emu_copies) {
    if (c.group + pending < emu_groups) std::memcpy(c.dst, c.src, c.n);
    else rest.push_back(c);
  }
  emu_copies.swap(rest);
}

// Runs fn() on a pthread with a small stack (thousands run at once).
struct EmuThread {
  pthread_t id;
  template <typename F>
  explicit EmuThread(F fn) {
    auto* heap = new F(std::move(fn));
    pthread_attr_t attr;
    pthread_attr_init(&attr);
    pthread_attr_setstacksize(&attr, 256 * 1024);
    pthread_create(&id, &attr, [](void* p) -> void* {
      std::unique_ptr<F> f(static_cast<F*>(p));
      (*f)();
      return nullptr;
    }, heap);
    pthread_attr_destroy(&attr);
  }
  void join() { pthread_join(id, nullptr); }
};

// Every block of the grid, cluster_x consecutive blocks in x at a time.
template <typename... KArgs, typename... Args>
void emu_run(void (*kernel)(KArgs...), dim3 grid, dim3 block,
             unsigned cluster_x, Args... args) {
  gridDim = grid;
  blockDim = block;
  const int n = block.x;
  const int nw = (n + 31) / 32;
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx0 = 0; bx0 < grid.x; bx0 += cluster_x) {
      std::barrier<> cluster_bar(n * cluster_x);
      EmuCluster cluster{&cluster_bar, {}};
      std::vector<std::unique_ptr<EmuSmem>> smem;
      std::vector<std::unique_ptr<std::barrier<>>> bars;
      std::vector<std::vector<Warp>> warps(cluster_x, std::vector<Warp>(nw));
      std::vector<EmuBlock> blocks(cluster_x);
      for (unsigned r = 0; r < cluster_x; ++r) {
        smem.emplace_back(new EmuSmem());
        bars.emplace_back(new std::barrier<>(n));
        for (int w = 0; w < nw; ++w) {
          bars.emplace_back(new std::barrier<>(std::min(32, n - 32 * w)));
          warps[r][w].bar = bars.back().get();
        }
        blocks[r] = {bars[r * (nw + 1)].get(), warps[r].data(),
                     smem.back()->bytes};
        cluster.smem.push_back(smem.back()->bytes);
      }
      std::vector<EmuThread> threads;
      for (unsigned r = 0; r < cluster_x; ++r) {
        for (int t = 0; t < n; ++t) {
          EmuBlock* blk = &blocks[r];
          EmuCluster* cl = &cluster;
          const unsigned bx = bx0 + r;
          threads.emplace_back([=]() {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by);
            emu_block = blk;
            emu_cluster = cl;
            emu_cluster_rank = r;
            kernel(args...);
          });
        }
      }
      for (auto& th : threads) th.join();
    }
  }
}

template <typename... KArgs, typename... Args>
void emu_launch(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t, void*,
                Args... args) {
  emu_run(kernel, grid, block, 1, KArgs(args)...);
}

enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
union cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim;
  dim3 blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <typename... KArgs, typename... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config,
                               void (*kernel)(KArgs...), Args... args) {
  unsigned cluster_x = 1;
  for (unsigned i = 0; i < config->numAttrs; ++i) {
    if (config->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      cluster_x = config->attrs[i].val.clusterDim.x;
    }
  }
  if (cluster_x < 1 || config->gridDim.x % cluster_x) return cudaErrorInvalidValue;
  emu_run(kernel, config->gridDim, config->blockDim, cluster_x, KArgs(args)...);
  return cudaSuccess;
}
"""

COOPERATIVE_GROUPS_H = r"""
#pragma once
#include "cuda_runtime.h"

namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_cluster->bar->arrive_and_wait(); }
  unsigned block_rank() const { return emu_cluster_rank; }
  unsigned num_blocks() const { return (unsigned)emu_cluster->smem.size(); }
  // The same shared variable in block ``rank`` of the cluster.
  template <typename T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const size_t offset = (const unsigned char*)p - emu_block->smem;
    return (T*)(emu_cluster->smem[rank] + offset);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };

// Round to nearest even, as the card's __float2bfloat16_rn.
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.x << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
"""


# The bodies of the inline-PTX copy helpers (mma.cuh's and
# crop_resize.cuh's), emulated: a copy queued in the thread's open group, a
# commit, and waits that do the copies of the groups they cover; the
# barrier after a wait is the source's.
CP_ASYNC_BODIES = {
    "cp_async16": "{ emu_cp_async(smem, gmem, 16); }",
    "cp_async4": "{ emu_cp_async(smem, gmem, 4); }",
    "cp_async_commit": "{ emu_cp_async_commit(); }",
    "cp_async_wait": "{ emu_cp_async_wait(N); }",  # template <int N>
    "cp_async_wait_all": "{ emu_cp_async_commit(); emu_cp_async_wait(0); }",
}


def emulate_cp_async(src: str) -> str:
    """``src`` with the body of each copy helper of CP_ASYNC_BODIES that it
    defines emulated; it must define ``cp_async16``."""
    assert "void cp_async16(" in src, "no cp_async16 in the source"
    for name, body in CP_ASYNC_BODIES.items():
        if f"void {name}(" in src:
            src = replace_body(src, name, body)
    return src


def replace_body(src: str, name: str, body: str) -> str:
    """``src`` with the body of the function ``name`` (``void name(``)
    replaced by ``body``."""
    m = re.search(r"void " + name + r"\(", src)
    assert m, f"{name} not found in the source"
    start = src.index("{", m.end())
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[:start] + body + src[i + 1:]
    raise AssertionError(f"unbalanced braces after {name}")


def rewrite_launches(src: str, name: str) -> str:
    """``kernel<<<grid, block, smem, stream>>>(`` -> ``emu_launch(kernel,
    grid, block, smem, stream, ``; at least one launch must be found."""
    src, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ",
                     src, flags=re.S)
    assert n >= 1, f"no launch found in {name}"
    return src


def substitute(src: str, old: str, new: str) -> str:
    """``src`` with ``old`` replaced by ``new``; ``old`` must occur."""
    assert old in src, f"not found in the source: {old}"
    return src.replace(old, new)


def write_headers(out: Path) -> None:
    (out / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (out / "cuda_bf16.h").write_text(CUDA_BF16_H)
    (out / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS_H)


def gxx(out: Path, src: Path, target: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        ["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-w",
         "-I", str(out), "-x", "c++", str(src), "-o", str(target)],
        capture_output=True, text=True)


def emulation_dir(tmp_path_factory) -> Path:
    """A directory holding the emulated headers; skips the calling test
    where g++ with C++20's ``<barrier>`` is missing."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_emu")
    probe = out / "probe.cc"
    probe.write_text("#include <barrier>\nstd::barrier<> b(1);\n")
    if gxx(out, probe, out / "libprobe.so").returncode:
        pytest.skip("needs g++ with C++20's <barrier>")
    write_headers(out)
    return out
