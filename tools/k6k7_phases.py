#!/usr/bin/env python3
"""Where K6 and K7 (the fused-solve EPDiff step and its backward) spend
their time on the card, phase by phase.

    python3 tools/k6k7_phases.py

Builds a copy of ``cardiax_torch/csrc/epdiff_step.cu`` with ``clock64()``
probes after each phase of K6/K7 (the four products of each solve, the
cluster barriers, phase B) and around each product's staging and compute,
into ``cardiax_torch/_build/`` (git-ignored), runs it at (190, 2, 64, 64)
and (190, 2, 128, 128), dt 0.2, R=2, and prints for each kernel its device
time, the mean cycles a block spends in each phase (thread 0 of each block),
the mean block lifetime and the mean number of blocks resident on an SM.
The probes are inserted by matching source text: the script fails, naming
the text, when the kernel source has moved on. Needs one CUDA device and
``nvcc``; measures the probed build, whose times are close to but not the
same as the kernel's own.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SLOTS = 24          # probe slots a block
PROBES = r'''__device__ long long g_probe[1 << 20];
__device__ __forceinline__ long long probe_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE(id) do { if (threadIdx.x == 0) \
  g_probe[(size_t)blockIdx.x * 24 + (id)] = clock64(); } while (0)
#define PROBE_START() do { if (threadIdx.x == 0) { \
  long long* d = g_probe + (size_t)blockIdx.x * 24; \
  d[20] = clock64(); d[21] = probe_ns(); \
  for (int z : {9, 16, 17, 18, 19}) d[z] = 0; } } while (0)
#define PROBE_END() do { if (threadIdx.x == 0) { \
  g_probe[(size_t)blockIdx.x * 24 + 15] = clock64(); \
  g_probe[(size_t)blockIdx.x * 24 + 22] = probe_ns(); } } while (0)
'''
READER = r'''
extern "C" int probe_read(long long* out, long long n) {
  return (int)cudaMemcpyFromSymbol(out, g_probe,
                                   (size_t)n * sizeof(long long));
}
'''
# (slot, label) of the phases in the order they run
K6_PHASES = [(1, "P1"), (2, "P2"), (3, "sync"), (4, "P3"), (5, "P4"),
             (6, "sync+halo"), (7, "phase B"), (15, "end")]
K7_PHASES = [(1, "P1"), (2, "P2"), (3, "sync"), (4, "P3"), (5, "P4"),
             (6, "sync"), (7, "phase B"), (8, "sync"), (10, "C.P1"),
             (11, "C.P2"), (12, "sync"), (13, "C.P3"), (14, "C.P4"),
             (15, "end")]
SPLIT = [(16, "staging issue"), (17, "staging wait"), (18, "barrier"),
         (19, "mma"), (9, "barrier")]


def insert(src: str, anchor: str, text: str, before: bool = False) -> str:
    """``text`` after (or before) the one occurrence of ``anchor``."""
    if src.count(anchor) != 1:
        raise RuntimeError(f"k6k7_phases: the kernel source no longer holds "
                           f"exactly one {anchor!r}")
    return src.replace(anchor, text + anchor if before else anchor + text)


def probed_source(src: str) -> str:
    s = insert(src, "namespace {\n", PROBES)
    a = "(kLast ? 10 : 1)"
    s = insert(s, "  __syncthreads();\n  band_mm<false, kCols>",
               f"  PROBE({a} + 0);\n", before=True)
    s = insert(s, "  cg::this_cluster().sync();          // every band of P2 "
               "is in place\n", f"  PROBE({a} + 1);\n", before=True)
    s = insert(s, "  cg::this_cluster().sync();          // every band of P2 "
               "is in place\n", f"  PROBE({a} + 2);\n")
    s = insert(s, "  if (kLast) cg::this_cluster().sync();",
               f"  PROBE({a} + 3);\n", before=True)
    s = insert(s, "sm.chunk, sm.nb, sm.abuf, store);\n",
               f"  PROBE({a} + 4);\n")
    s = s.replace("  const Band bd = band_of(h);\n",
                  "  const Band bd = band_of(h);\n  PROBE_START();\n")
    s = insert(s, "  cluster.sync();                     // no block reads "
               "another's v now\n", "  PROBE(6);\n")
    s = insert(s, "(int64_t)i * w + j, i, j, h, w, dt, r);\n    }\n  }\n",
               "  PROBE(7);\n  PROBE_END();\n")
    s = insert(s, "  cg::this_cluster().sync();          // every band of v "
               "is in place\n\n", "  PROBE(6);\n")
    s = insert(s, "  cg::this_cluster().sync();          // every band of "
               "g_v is in place\n", "  PROBE(7);\n", before=True)
    s = insert(s, "  cg::this_cluster().sync();          // every band of "
               "g_v is in place\n", "  PROBE(8);\n")
    s = insert(s, "sgm[(c * kBand + i) * pitch + j] + val;\n"
               "                   });\n", "  PROBE_END();\n")
    s = insert(s, "    stage_rows<kCB, L>(b, chunk, c0, k, n, nb);\n",
               "    const long long q0 = clock64();\n", before=True)
    s = insert(s, "    stage_rows<kCB, L>(b, chunk, c0, k, n, nb);\n",
               "    const long long q1 = clock64();\n")
    s = insert(s, "    cp_async_wait();\n    __syncthreads();\n",
               "    const long long q3 = clock64();\n")
    s = insert(s, "    cp_async_wait();\n",
               "    const long long q2 = clock64();\n")
    s = insert(s, "    __syncthreads();                         // before the "
               "next staging\n", "    const long long q4 = clock64();\n",
               before=True)
    s = insert(s, "    __syncthreads();                         // before the "
               "next staging\n",
               "    if (threadIdx.x == 0) {\n"
               "      long long* d = g_probe + (size_t)blockIdx.x * 24;\n"
               "      d[16] += q1 - q0; d[17] += q2 - q1; d[18] += q3 - q2;\n"
               "      d[19] += q4 - q3; d[9] += clock64() - q4;\n    }\n")
    return s + READER


def main() -> int:
    if not torch.cuda.is_available():
        print("k6k7_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from cardiax_torch.device import set_numerics
    from cardiax_torch.kernels import build
    from cardiax_torch.ops import epdiff_kernels as ek
    set_numerics()
    src = (build.CSRC / "epdiff_step.cu").read_text()
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "epdiff_step_probed.cu").write_text(probed_source(src))
    lib_path = out / "libepdiff_step_probed.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(lib_path), str(out / "epdiff_step_probed.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"k6k7_phases: nvcc failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    build.load_library("epdiff_step")
    build._loaded["epdiff_step"] = lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dt, r = 0.2, 2
    for side in (64, 128):
        (m, u, gm, gu, _), ops, _ = cs.solve_fields(70, 190, side, side, dt,
                                                    r, "cuda")
        runs = {"K6": (lambda: ek._epdiff_step_solve_cuda(m, u, *ops, dt, r),
                       K6_PHASES),
                "K7": (lambda: ek._epdiff_step_solve_bwd_cuda(
                    m, u, *ops, gm, gu, dt, r), K7_PHASES)}
        for kind, (fn, phases) in runs.items():
            ms = cs.device_ms(fn, ["epdiff_step_solve"])
            fn()
            torch.cuda.synchronize()
            blocks = 190 * ((side + 15) // 16)
            buf = np.zeros(blocks * SLOTS, dtype=np.int64)
            err = lib.probe_read(buf.ctypes.data_as(ctypes.c_void_p),
                                 ctypes.c_longlong(buf.size))
            if err != 0:
                raise RuntimeError(f"k6k7_phases: cudaError {err}")
            d = buf.reshape(blocks, SLOTS).astype(np.float64)
            prev, parts = 20, []
            for slot, label in phases:
                parts.append(f"{label} {np.mean(d[:, slot] - d[:, prev]):.0f}")
                prev = slot
            life = d[:, 22] - d[:, 21]
            span = d[:, 22].max() - d[:, 21].min()
            split = ", ".join(f"{label} {np.mean(d[:, slot]):.0f}"
                              for slot, label in SPLIT)
            print(f"{kind} (190,2,{side},{side}) R=2 probed build: "
                  f"{cs.fmt_ms(ms)} device time; {blocks} blocks, lifetime "
                  f"{np.mean(life) / 1e3:.2f} us, "
                  f"{life.sum() / span / sms:.2f} blocks an SM at once; "
                  f"cycles a block: {', '.join(parts)}; of which in the "
                  f"products: {split}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
