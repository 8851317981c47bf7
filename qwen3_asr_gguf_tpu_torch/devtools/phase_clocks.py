"""Where a block of kernels 3 and 6 spends its cycles: copies of the two
sources get a `clock64()` stamp of one block's thread 0 at each phase boundary
(start, copies started, first chunk landed, ..., final sums, cluster barriers),
are built beside the real library and launched on cold weights; one line per
shape with the cycles between the stamps. The stamps are placed by text
anchors in the sources: an anchor that no longer matches stops the run."""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

from ._common import q4_weights, setup

PRE = '''
__device__ unsigned long long phase_t[16];
#define PHASE(i) do { if (blockIdx.x == 0 && blockIdx.y == PHASE_BLOCK && threadIdx.x == 0) \\
  phase_t[i] = clock64(); } while (0)
'''
POST = '''
extern "C" int phase_read(unsigned long long* host) {
  cudaDeviceSynchronize();
  return (int)cudaMemcpyFromSymbol(host, phase_t, sizeof(unsigned long long) * 16);
}
'''
SYNC = "    __syncthreads();                 // for every thread; the slot refilled below is free\n"
LOOP = "  for (int chunk = 0; chunk < n_chunks; ++chunk) {\n"
SUMS = "  // add the K slices in order through shared memory: red[warp][row][16 channels]\n"
SHARE = "  // each block adds, in rank order, its share of the outputs\n"
LAST = "  cluster.sync();  // no block's shared memory goes away while another reads it\n"
# phases: 0 start, 2 copies started, 3 chunk 0 landed, 4 chunk 1 landed (rows: its
# compute starts at 5; qmm: chunk 0's x sums done), 6 chunks done, 8 block sums
# done and first barrier passed, 9 outputs stored, 10 last barrier passed
ANCHORS = {
    "q4_matmul": [
        ("  auto load_chunk = [&](int local) {\n", "  PHASE(0);\n", False),
        (LOOP, "  PHASE(2);\n", False),
        (SYNC, "    if (chunk == 0) PHASE(3);\n", True),
        ("    const float* s_s = reinterpret_cast<const float*>(st + L.s);\n",
         "    if (chunk == 0) PHASE(4);\n", False),
        (SUMS, "  PHASE(6);\n", False), (SHARE, "  PHASE(8);\n", False),
        ("    return;\n  }\n  for (int idx = tid; idx < T8 << cs; idx += THREADS) part[idx]",
         "    PHASE(8); PHASE(9); PHASE(10);\n", False),
        (LAST, "  PHASE(9);\n", False),
    ],
    "q4k_matmul_rows": [
        ("  auto load_chunk = [&](int local) {\n", "  PHASE(0);\n", False),
        (LOOP, "  PHASE(2);\n", False),
        (SYNC, "    if (chunk == 0) PHASE(3);\n    if (chunk == 1) PHASE(4);\n", True),
        ("    const unsigned char* st = smem + (chunk % stages) * L.bytes;\n",
         "    if (chunk == 1) PHASE(5);\n", False),
        (SUMS, "  PHASE(6);\n", False), (SHARE, "  PHASE(8);\n", False),
        ("    return;\n  }\n  for (int idx = tid; idx < T << chs; idx += THREADS) part[idx]",
         "    PHASE(8); PHASE(9); PHASE(10);\n", False),
        (LAST, "  PHASE(9);\n", False),
    ],
}
P, I = ctypes.c_void_p, ctypes.c_int


def instrumented(csrc: Path, name: str) -> str:
    text = (csrc / f"{name}.cu").read_text()
    text = text.replace("namespace {\n", PRE + "namespace {\n", 1) + POST
    for anchor, code, after in ANCHORS[name]:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor {anchor!r} matches {text.count(anchor)} times")
        text = text.replace(anchor, anchor + code if after else code + anchor)
    return text.replace(LAST, LAST + "  PHASE(10);\n")


def build(_build, workdir: Path, name: str, block: int) -> ctypes.CDLL:
    src, lib = workdir / f"{name}_{block}.cu", workdir / f"{name}_{block}.so"
    src.write_text(instrumented(_build.CSRC, name))
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, f"-DPHASE_BLOCK={block}", "-I",
                    str(_build.CSRC), "-shared", "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def read(lib) -> dict:
    buf = (ctypes.c_ulonglong * 16)()
    lib.phase_read.argtypes = [P]
    if lib.phase_read(ctypes.cast(buf, P)) != 0:
        raise RuntimeError("phase_read failed")
    v = list(buf)
    seen = [i for i in range(11) if v[i]]
    out = {f"{a}->{b}": v[b] - v[a] for a, b in zip(seen, seen[1:])}
    return out | {"total": v[10] - v[0]}


def main() -> None:
    torch, cs, dev, g, _ = setup()
    from qwen3_asr_gguf_tpu_torch.ops import _build, q4k, qmm

    with tempfile.TemporaryDirectory() as tmp:
        for block in (0, 7):  # both are in the first wave
            lib6 = build(_build, Path(tmp), "q4_matmul", block)
            lib6.q4_matmul_launch.argtypes = [P, I, P, P, P, P, P, I, I, I, I, I, I, P]
            for t, n, k in ((1, 2048, 2048), (1, 152064, 2048), (26, 1024, 1024),
                            (64, 152064, 2048)):
                weights = q4_weights(torch, dev, g, n, k, copies=3 if n > 100000 else 40)
                x = torch.randn((t, k), generator=g, device=dev).to(torch.bfloat16)
                out = torch.empty(t, n, dtype=torch.bfloat16, device=dev)
                pw, gcm, ks = qmm.tiling(t, n, k)
                for w in weights:  # the last, cold call's clocks are read
                    rc = lib6.q4_matmul_launch(
                        x.data_ptr(), 1, None, w.packed.data_ptr(), w.scale.data_ptr(),
                        w.minv.data_ptr(), out.data_ptr(), t, n, k, pw, gcm, ks, None)
                    if rc != 0:
                        raise RuntimeError(f"q4_matmul_launch: {rc}")
                print("q4_matmul", f"block={block}", (t, n, k), (pw, gcm, ks), read(lib6),
                      flush=True)
                del weights
            lib3 = build(_build, Path(tmp), "q4k_matmul_rows", block)
            lib3.q4k_matmul_rows_launch.argtypes = [P, I, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
            for t, n, k in ((8, 2048, 2048), (64, 2048, 2048), (8, 152576, 2048),
                            (64, 152576, 2048)):
                _, weights = cs.cold_weights(torch, dev, g, n, k)
                x = torch.randn((t, k), generator=g, device=dev).to(torch.bfloat16)
                xq = torch.empty(t * k, dtype=torch.int8, device=dev)
                sxs = torch.empty(k // 32 * t * 2, device=dev)
                out = torch.empty(t, n, dtype=torch.bfloat16, device=dev)
                ct, ks = q4k.rows_tiling(n, k)
                for w in weights[:40]:
                    rc = lib3.q4k_matmul_rows_launch(
                        x.data_ptr(), 1, xq.data_ptr(), sxs.data_ptr(), w.packed.data_ptr(),
                        w.sub_t.data_ptr(), w.min_t.data_ptr(), w.dd_t.data_ptr(), out.data_ptr(),
                        1, t, n, k, ct, ks, None)
                    if rc != 0:
                        raise RuntimeError(f"q4k_matmul_rows_launch: {rc}")
                print("q4k_matmul_rows", f"block={block}", (t, n, k), (ct, ks), read(lib3),
                      flush=True)
                del weights


if __name__ == "__main__":
    main()
