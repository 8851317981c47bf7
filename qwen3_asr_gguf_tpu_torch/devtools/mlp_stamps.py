"""Where kernel 7's time goes: a copy of csrc/fused_mlp.cu gets `%globaltimer`
stamps (ns, one clock for every SM) at its phase boundaries, placed by text
anchors (an anchor that no longer matches stops the run), is built beside
the real library and launched once on weights cold in L2 at both MLP shapes.
One line per shape: the per-call time in a CUDA graph, and for each stamp the
minimum, median and maximum over the blocks, in ns after the first block's
start.

    python3 -m qwen3_asr_gguf_tpu_torch.devtools.mlp_stamps [NAME=VALUE ...] [rowfence]

NAME=VALUE sets a constant of the source (RING, PREFETCH_WD, WARPS, ...);
`rowfence` adds a release add per phase-1 row (the act store made visible
row by row, as a per-tile arrival counter would need), whose output is unused.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

from ._common import REPO, setup

PRE = r'''
__device__ unsigned long long stamps[1024][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) do { if (threadIdx.x == 0) stamps[blockIdx.x][i] = gtime(); } while (0)
#define STAMPW(i) do { if ((threadIdx.x & 31) == 0) atomicMax(&stamps[blockIdx.x][i], gtime()); } while (0)
'''
POST = r'''
extern "C" int stamps_read(unsigned long long* host) {
  cudaDeviceSynchronize();
  return (int)cudaMemcpyFromSymbol(host, stamps, sizeof(stamps));
}
extern "C" int stamps_reset() {
  static unsigned long long zero[1024][8];
  return (int)cudaMemcpyToSymbol(stamps, zero, sizeof(zero));
}
'''
# (stamp name, anchor, stamp, before the anchor?)
ANCHORS = [
    ("start", "  const int8_t* wd_slab = wd + static_cast<size_t>(r0) * m;\n", "STAMP(0);", False),
    ("x_quantized", "  int4 xr[MAX_C];\n", "STAMP(1);", True),
    ("phase1_done", "  __syncthreads();  // the block's acts are stored\n", "STAMPW(2);", True),
    ("grid_barrier_passed", "  if (tid == 0) ticket = atomicAdd(ctr + TICKETS, 1u);\n", "STAMP(3);",
     False),
    ("acts_quantized", "  if (PREFETCH_WD == 2) copy_slab();\n", "STAMPW(4);", True),
    ("slab_landed", "  __syncthreads();            // and every thread's\n", "STAMP(5);", False),
    ("dots_done", "  __syncthreads();\n  if (tid < rows) {  // the tiles in order", "STAMPW(6);", True),
    ("end", "      reinterpret_cast<float*>(out)[r0 + tid] = o;\n  }\n", "STAMPW(7);", False),
]
ROWFENCE = ("        act[row] = __fmul_rn(__fmul_rn(g, sig), u);\n",
            "        asm volatile(\"red.release.gpu.global.add.u32 [%0], 1;\" ::"
            "\"l\"(ctr + 2 + row / tile_m) : \"memory\");\n")


def instrumented(args: list[str]) -> str:
    text = (REPO / "qwen3_asr_gguf_tpu_torch" / "csrc" / "fused_mlp.cu").read_text()
    text = text.replace("namespace {\n", PRE + "namespace {\n", 1)
    for name, anchor, stamp, before in ANCHORS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"fused_mlp.cu: the anchor of {name} matched {text.count(anchor)} times")
        text = text.replace(anchor, f"  {stamp}\n{anchor}" if before else f"{anchor}  {stamp}\n")
    for arg in args:
        if arg == "rowfence":
            if text.count(ROWFENCE[0]) != 1:
                raise RuntimeError("fused_mlp.cu: the anchor of the act store moved")
            text = text.replace(ROWFENCE[0], ROWFENCE[0] + ROWFENCE[1])
            continue
        name, value = arg.split("=")
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {int(value)};",
                          text)
        if n != 1:
            raise RuntimeError(f"fused_mlp.cu: the constant {name} matched {n} times")
    return text + POST


def main() -> None:
    args = sys.argv[1:]
    torch, cs, dev, g, _ = setup()
    import numpy as np

    from qwen3_asr_gguf_tpu_torch.ops import _build, mlp

    out_dir = REPO / ".bench_cache" / "mlp_stamps"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "fused_mlp_stamps.cu", out_dir / "libfused_mlp_stamps.so"
    src.write_text(instrumented(args))
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                    "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.fused_mlp_launch.argtypes = _build._SIGNATURES["fused_mlp_launch"]
    lib.stamps_read.argtypes = [ctypes.c_void_p]
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    ctr = torch.zeros(64, dtype=torch.int32, device=dev)  # the rowfence adds land past the two
    for d, m in ((2048, 6144), (1024, 3072)):
        sets = [tuple(t for shape in ((m, d), (m, d), (d, m)) for t in (
            torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8),
            torch.rand(shape[0], generator=g, device=dev) * 4e-4 + 1e-4))
            for _ in range(max(2, -(-(128 << 20) // (3 * d * m))))]
        x = torch.randn((1, d), generator=g, device=dev).to(torch.bfloat16)
        plan = mlp.fused_mlp_plan(m, d, mlp.TILE_M, blocks)
        act, out = torch.empty(m, device=dev), torch.empty_like(x)

        def call(a):
            rc = lib.fused_mlp_launch(
                x.data_ptr(), 1, *(t.data_ptr() for t in a), act.data_ptr(), ctr.data_ptr(),
                out.data_ptr(), m, d, mlp.TILE_M, plan.blocks, plan.slab_rows, plan.smem_bytes,
                torch.cuda.current_stream().cuda_stream)
            _build.check(rc, "fused_mlp_stamps")

        call(sets[0])
        err = (out.float() - mlp.fused_mlp_matvec_ref(x, *sets[0]).float()).abs().max().item()
        graph_us = cs.time_ms(call, sets, torch) * 1e3
        for a in sets[1:]:  # sets[0] cold again
            call(a)
        torch.cuda.synchronize()
        lib.stamps_reset()
        call(sets[0])
        host = (ctypes.c_ulonglong * (1024 * 8))()
        lib.stamps_read(host)
        st = np.array(host, dtype=np.uint64).reshape(1024, 8)[:blocks].astype(np.int64)
        t0 = st[:, 0].min()
        row = {"phase": "mlp_stamps", "variant": args, "hidden": d, "m": m,
               "max_abs_err_vs_plain": err, "graph_us": graph_us}
        for i, (name, *_) in enumerate(ANCHORS):
            col = st[:, i][st[:, i] > 0] - t0
            row[name] = [int(col.min()), int(np.median(col)), int(col.max())] if len(col) else None
        print(json.dumps(row), flush=True)
        del sets


if __name__ == "__main__":
    main()
