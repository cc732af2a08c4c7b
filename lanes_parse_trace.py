#!/usr/bin/env python3
"""Where the time of kernel A (``csrc/lanes_parse.cu``) goes, on one card.

Run from the repository root:  python3 lanes_parse_trace.py

Builds a copy of ``csrc/lanes_parse.cu`` with ``%globaltimer`` reads
patched in (the kernel itself is unchanged), runs it on the shard decode
main path's input (32 waves of zlib level-1 shards of chip_smoke's
corpus), checks that its output equals the real kernel's, and prints, for
the slowest block and for the mean block: the block's duration and steps,
its chunk starts (block headers, table builds, ring reloads), its ring
checks, the steps in which at least one lane decodes a Huffman symbol
against those in which every active lane copies stored bytes, the
dynamic headers and code lengths (the lane that takes longest) and the
warp's table builds.  The timer reads cost time themselves, so the
traced launch runs a little longer than the real one, whose time is
printed beside it.  Exits non-zero without a CUDA device.
"""

import ctypes
import os
import subprocess
import sys
import tempfile
import zlib

import numpy as np
import torch

import chip_smoke as cs

SLOTS = 16   # int64 a block in the trace


def _patch(src, old, new):
    if src.count(old) != 1:
        raise RuntimeError(f"lanes_parse.cu changed: {old!r} found {src.count(old)} times")
    return src.replace(old, new)


def traced_source(src):
    """The kernel with timers: slot k of block b at lp_trace[b * SLOTS + k]."""
    src = _patch(src, "#include <cuda_runtime.h>\n", """#include <cuda_runtime.h>
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
""")
    src = _patch(src, "constexpr int NT = 32;", f"""constexpr int NT = 32;
__device__ unsigned long long lp_trace[1 << 20];
constexpr int SLOTS = {SLOTS};""")
    src = _patch(src, "  bool dyn;\n", "  bool dyn;\n  unsigned long long t_hdr = 0;\n")
    src = _patch(src, "    uint32_t lo = peek(bp);\n    const int nlit",
                 "    const unsigned long long g0 = gtime();\n    uint32_t lo = peek(bp);\n    const int nlit")
    src = _patch(src, "    // the warp builds the tables from here (build_tables)\n",
                 "    t_hdr += gtime() - g0;\n    // the warp builds the tables from here (build_tables)\n")
    src = _patch(src, "  __shared__ Shared sh;\n", """  __shared__ Shared sh;
  const unsigned long long t_begin = gtime();
  unsigned long long t_starts = 0, t_checks = 0, t_huff = 0, t_stored = 0, t_tables = 0;
  int n_steps = 0, n_huff = 0;
""")
    src = _patch(src, "    if (s.tables) s.dyn = true;\n",
                 "    if (s.tables) s.dyn = true;\n    const unsigned long long tt0 = gtime();\n")
    src = _patch(src, "    if (starts) {\n      s.lt =", "    t_tables += gtime() - tt0;\n    if (starts) {\n      s.lt =")
    src = _patch(src, "    // no copy into a ring may land after the reload below\n    copies_wait_all();",
                 "    const unsigned long long ts0 = gtime();\n    copies_wait_all();")
    src = _patch(src, "    int32_t* row = rows + (size_t)t * 128 * NSTR + lane;",
                 "    t_starts += gtime() - ts0;\n    int32_t* row = rows + (size_t)t * 128 * NSTR + lane;")
    src = _patch(src, "      if (j % CHECK == 0) {\n",
                 "      if (j % CHECK == 0) {\n        const unsigned long long tc0 = gtime();\n")
    src = _patch(src, "        copies_wait_older();\n        __syncwarp();\n",
                 "        copies_wait_older();\n        __syncwarp();\n        t_checks += gtime() - tc0;\n")
    src = _patch(src, "      *row = active ? s.step() : 0;", """      const bool huff = __ballot_sync(FULL, active && s.blkmode == 1) != 0;
      const unsigned long long tp0 = gtime();
      *row = active ? s.step() : 0;
      __syncwarp();
      const unsigned long long tp = gtime() - tp0;
      ++n_steps;
      n_huff += huff;
      t_huff += huff ? tp : 0;
      t_stored += huff ? 0 : tp;""")
    src = _patch(src, "  copies_wait_all();\n  if (s.status == ST_ACTIVE", """  const unsigned hdr = __reduce_max_sync(FULL, (unsigned)s.t_hdr);
  if (lane == 0) {
    unsigned long long* d = lp_trace + (size_t)blockIdx.x * SLOTS;
    d[0] = t_begin; d[1] = gtime(); d[2] = n_steps; d[3] = n_huff; d[4] = t_starts;
    d[5] = t_checks; d[6] = t_huff; d[7] = t_stored; d[8] = hdr; d[9] = t_tables;
  }
  copies_wait_all();
  if (s.status == ST_ACTIVE""")
    return src + """
extern "C" int lp_trace_get(void* host, long long n) {
  return (int)cudaMemcpyFromSymbol(host, lp_trace, n * sizeof(unsigned long long));
}
"""


def main():
    if not torch.cuda.is_available():
        print("lanes_parse_trace: no CUDA device", file=sys.stderr)
        return 1
    from moonbit_flate_tpu_torch.kernels import build
    from moonbit_flate_tpu_torch.ops import lanes_inflate as LI

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.build_all(("lanes_parse",))
    with open(os.path.join(build.CSRC, "lanes_parse.cu")) as f:
        src = traced_source(f.read())
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "lanes_parse_trace.cu"), os.path.join(tmp, "lanes_parse_trace.so")
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu], check=True)
        lib = ctypes.CDLL(so)
    lib.lp_trace_get.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    launch = lib.lanes_parse_launch
    launch.argtypes = LI._ARGTYPES
    launch.restype = ctypes.c_int

    dev = torch.device("cuda")
    waves = cs.DEC_WAVES
    n = waves * LI.NSTR
    corpus = cs.make_corpus(total=n * LI.SEGB, seed=0)
    streams = [zlib.compress(corpus[i * LI.SEGB:(i + 1) * LI.SEGB], 1)[2:-4] for i in range(n)]
    nb, inw = LI.stage_streams_lanes(streams, waves)
    tok, misc = LI.parse_waves(nb, inw, waves)
    real_ms = cs.cuda_ms(lambda: LI.parse_waves(nb, inw, waves), 3)
    bufs = LI._buffers(waves, dev)
    stream = torch.cuda.current_stream().cuda_stream
    traced_ms = cs.cuda_ms(lambda: build.check(launch(
        nb.data_ptr(), inw.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
        bufs[2].data_ptr(), n, stream), "lanes_parse (traced)"), 3)
    if not (torch.equal(bufs[0], tok) and torch.equal(bufs[1], misc)):
        raise AssertionError("the traced kernel's output differs from the kernel's")
    blocks = n // 32
    d = np.zeros(blocks * SLOTS, np.uint64)
    lib.lp_trace_get(d.ctypes.data_as(ctypes.c_void_p), d.size)
    d = d.reshape(blocks, SLOTS).astype(np.int64)
    dur = d[:, 1] - d[:, 0]
    us = 1e-3

    def part(row):
        steps, huff = row[2], row[3]
        return (f"{(row[1] - row[0]) * us:.1f} us, {steps} steps: chunk starts "
                f"{row[4] * us:.1f} us, ring checks {row[5] * us:.1f} us, {huff} steps with a "
                f"Huffman lane {row[6] * us:.1f} us ({row[6] / max(huff, 1):.1f} ns a step), "
                f"{steps - huff} stored-only steps {row[7] * us:.1f} us "
                f"({row[7] / max(steps - huff, 1):.1f} ns a step); dynamic headers and code "
                f"lengths (the slowest lane) {row[8] * us:.1f} us, the warp's table builds "
                f"{row[9] * us:.1f} us")

    slow = int(np.argmax(dur))
    print(f"lanes_parse {real_ms:.4f} ms, traced {traced_ms:.4f} ms (equal output), "
          f"{waves} waves, {blocks} blocks; span of the traced launch "
          f"{(d[:, 1].max() - d[:, 0].min()) * us:.1f} us", flush=True)
    print(f"slowest block #{slow}: {part(d[slow])}", flush=True)
    print(f"mean block: {part(d.mean(0).astype(np.int64))}; Huffman steps over all blocks "
          f"{d[:, 6].sum() / max(d[:, 3].sum(), 1):.1f} ns a step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
