#!/usr/bin/env python3
"""The rate of mma.sync.m16n8k8 TF32 (K3/K4's big body's products) on one GPU.

    python3 tools/mma_rate.py [--iters N]

Builds a small CUDA kernel with nvcc (the flags ops/_build.py builds
with) in a temporary directory: each warp issues N rounds of 8
independent mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on
register operands (no memory traffic), and for comparison N rounds of 8
independent float32 FFMA chains.  It runs 1, 2, 4 and 8 warps per SM
sub-partition (blocks of 4 warps, one block per SM up to 16 warps,
then two) on every SM, times each launch with CUDA events, and prints
per warp count the tensor rate in TFLOP/s (2 x 16 x 8 x 8 FLOP an
instruction), the SM cycles (clock64 in the kernel) one sub-partition
takes per mma, and the FFMA rate.  The H100
SXM data sheet's peaks are 495 TFLOP/s TF32 (dense, for warpgroup
mma) and 67 TFLOP/s FP32.  Needs a CUDA device and nvcc; exits nonzero
without them.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void mma_loop(float* out, int iters) {
  const long long t0 = clock64();
  float d[8][4] = {};
  uint32_t a[4], b0, b1;
  for (int q = 0; q < 4; ++q)
    a[q] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + q);
  b0 = __float_as_uint(0.5f), b1 = __float_as_uint(0.25f);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
  for (int k = 0; k < 8; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  if (s == 12345.0f) out[threadIdx.x] = s;
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(clock64() - t0);
}

__global__ void ffma_loop(float* out, int iters) {
  const long long t0 = clock64();
  float d[8];
  for (int k = 0; k < 8; ++k) d[k] = threadIdx.x * 1e-3f + k;
  const float x = 0.999f, y = 1e-3f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) d[k] = fmaf(d[k], x, y);
  }
  float s = 0.0f;
  for (int k = 0; k < 8; ++k) s += d[k];
  if (s == 12345.0f) out[threadIdx.x] = s;
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(clock64() - t0);
}

extern "C" int launch(int which, float* out, int blocks, int threads,
                      int iters, cudaStream_t stream) {
  if (which == 0)
    mma_loop<<<blocks, threads, 0, stream>>>(out, iters);
  else
    ffma_loop<<<blocks, threads, 0, stream>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def build(tmp: str) -> ctypes.CDLL:
    from phyml_tpu_torch.ops import _build

    src = os.path.join(tmp, "mma_rate.cu")
    so = os.path.join(tmp, "libmma_rate.so")
    with open(src, "w") as fh:
        fh.write(SRC)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-shared", "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.launch.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("mma_rate: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(4096, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        print(f". card: {smi}, {sms} SMs; {args.iters} rounds of 8 "
              "independent instructions a warp")
        for warps in (1, 2, 4, 8):   # a sub-partition's warps
            threads = 32 * 4 * min(warps, 4)
            blocks = sms * max(1, warps // 4)
            rates = []
            for which in (0, 1):
                lib.launch(which, ctypes.c_void_p(out.data_ptr()), blocks,
                           threads, 10, ctypes.c_void_p(stream))
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                rc = lib.launch(which, ctypes.c_void_p(out.data_ptr()),
                                blocks, threads, args.iters,
                                ctypes.c_void_p(stream))
                b.record()
                torch.cuda.synchronize()
                if rc:
                    sys.exit(f"mma_rate: launch failed ({rc})")
                ms = a.elapsed_time(b)
                n = blocks * threads // 32 * args.iters * 8
                flop = n * (2 * 16 * 8 * 8 if which == 0 else 2 * 32)
                rates.append((ms, flop / ms / 1e9))
            # the mma launch's cycles (clock64 of each block), a block's
            # warps on its sub-partitions
            lib.launch(0, ctypes.c_void_p(out.data_ptr()), blocks, threads,
                       args.iters, ctypes.c_void_p(stream))
            torch.cuda.synchronize()
            cycles = float(out[:blocks].mean())
            cyc = cycles / (warps * args.iters * 8)
            print(f". {warps} warp(s) a sub-partition: mma.sync TF32 "
                  f"{rates[0][1]:.1f} TFLOP/s ({rates[0][0]:.3f} ms, "
                  f"{cyc:.2f} cycles an mma a sub-partition); FFMA "
                  f"{rates[1][1]:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
