#!/usr/bin/env python3
"""Where the time of the lane kernels A (``csrc/lanes_parse.cu``) and BC
(``csrc/lanes_resolve.cu``) goes, on one card.

Run from the repository root:

    python3 lanes_parse_trace.py

Each section builds a copy of a kernel's source with ``%globaltimer``
reads patched in (the kernel itself is unchanged), runs it on the shard
decode main path's input (32 waves of zlib level-1 shards of
chip_smoke's corpus), checks that its output equals the real kernel's,
and prints the slowest block and the mean block in parts.

Kernel A: the block's duration and steps, its chunk starts (block
headers, table builds, ring reloads), its ring checks, the steps in
which at least one lane decodes a Huffman symbol against those in which
every active lane copies stored bytes, the dynamic headers and code
lengths (the lane that takes longest) and the warp's table builds.

Kernel BC: the block's duration and, for its busiest warp, the time in
token loads (waiting for them), in offsets and literal placement, in
match copies (with their count and rounds, and the part copied by one
lane and by the whole warp), at the block's barrier
after a tile and in output stores (until the last one is sent).

The timer reads cost time themselves, so a traced launch runs a little
longer than the real one, whose time is printed beside it.  Exits
non-zero without a CUDA device.
"""

import argparse
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
        raise RuntimeError(f"kernel source changed: {old!r} found {src.count(old)} times")
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


RESOLVE_SLOTS = 13   # int64 a warp in kernel BC's trace


def _gtime_source(src, array, slots):
    return _patch(src, "#include <cuda_runtime.h>\n", f"""#include <cuda_runtime.h>
__device__ __forceinline__ unsigned long long gtime() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
__device__ unsigned long long {array}[1 << 20];
constexpr int SLOTS = {slots};
""") + f"""
extern "C" int {array}_get(void* host, long long n) {{
  return (int)cudaMemcpyFromSymbol(host, {array}, n * sizeof(unsigned long long));
}}
"""


def resolve_traced_source(src):
    """Kernel BC with timers: slot k of warp (stream) s at lr_trace[s *
    SLOTS + k]: 0 begin, 1 end, 2 token loads, 3 offsets and literals, 4
    match copies, 5 output stores, 6 matches, 7 batches of rows, 8 the
    barrier after a tile, 9 rounds of copies, 11 copies by one lane, 12
    copies by the warp (both inside 4)."""
    src = _gtime_source(src, "lr_trace", RESOLVE_SLOTS)
    end = """  __syncwarp();
  if (lane == 0) {
    unsigned long long* d = lr_trace + (size_t)sid * SLOTS;
    d[0] = g_begin; d[1] = gtime(); d[5] = d[1] - g3;
    d[2] = tr[2]; d[3] = tr[3]; d[4] = tr[4]; d[6] = tr[6]; d[7] = tr[7]; d[8] = tr[8];
    d[9] = tr[9]; d[11] = tr[11]; d[12] = tr[12];
  }
}

}  // namespace"""
    # the block loads tiles of 128 rows, a warp places its stream's
    # literals and queues its matches, and drains the queue
    src = _patch(src, "__device__ __forceinline__ void drain(Queue& q, uint8_t* hb, int lane) {\n",
                 "__device__ __forceinline__ void drain(Queue& q, uint8_t* hb, int lane,\n"
                 "                                      unsigned long long* tr) {\n"
                 "  const unsigned long long d0 = gtime();\n  tr[6] += q.n;\n")
    src = _patch(src, "    if (!__ballot_sync(FULL, has)) break;\n",
                 "    if (!__ballot_sync(FULL, has)) break;\n    ++tr[9];\n")
    src = _patch(src, "    if (ready && m <= SHORT) short_copy(hb, ms, m, dist);\n",
                 "    __syncwarp();\n    const unsigned long long s0 = gtime();\n"
                 "    if (ready && m <= SHORT) short_copy(hb, ms, m, dist);\n"
                 "    __syncwarp();\n    const unsigned long long s1 = gtime();\n"
                 "    tr[11] += s1 - s0;\n")
    src = _patch(src, "    if (ready) i += 32;\n", "    tr[12] += gtime() - s1;\n    if (ready) i += 32;\n")
    src = _patch(src, "  q.n = 0;\n}\n", "  q.n = 0;\n  tr[4] += gtime() - d0;\n}\n")
    src = _patch(src, "__device__ __forceinline__ int expand_tile(const uint32_t* trow, uint8_t* hb, "
                 "Queue& q, int p,\n                                           int n, int lane) {\n",
                 "__device__ __forceinline__ int expand_tile(const uint32_t* trow, uint8_t* hb, "
                 "Queue& q, int p,\n                                           int n, int lane, "
                 "unsigned long long* tr) {\n"
                 "  const unsigned long long e0 = gtime(), c0 = tr[4];\n")
    src = _patch(src, "    return p + TILE;\n",
                 "    __syncwarp();\n    tr[3] += gtime() - e0;\n    return p + TILE;\n")
    src = _patch(src, "  if (q.n + (total >> 16) > QCAP) drain(q, hb, lane);\n",
                 "  if (q.n + (total >> 16) > QCAP) drain(q, hb, lane, tr);\n")
    src = _patch(src, "  q.n += total >> 16;\n",
                 "  q.n += total >> 16;\n  __syncwarp();\n  tr[3] += gtime() - e0 - (tr[4] - c0);\n")
    src = _patch(src, "  __shared__ Shared sh;\n",
                 "  __shared__ Shared sh;\n"
                 "  const unsigned long long g_begin = gtime();\n"
                 "  unsigned long long tr[13] = {0};\n")
    src = _patch(src, "        store_tile(sh.tile, ring[d]);\n        __syncthreads();\n",
                 "        const unsigned long long g0 = gtime();\n"
                 "        store_tile(sh.tile, ring[d]);\n        __syncthreads();\n"
                 "        tr[2] += gtime() - g0;\n        ++tr[7];\n")
    src = _patch(src, "expand_tile(sh.tile[warp], hb, q, p, n, lane)",
                 "expand_tile(sh.tile[warp], hb, q, p, n, lane, tr)")
    src = _patch(src, "        more = __syncthreads_or(p < n && kt + TILE < TOK_ROWS);\n",
                 "        const unsigned long long g1 = gtime();\n"
                 "        more = __syncthreads_or(p < n && kt + TILE < TOK_ROWS);\n"
                 "        tr[8] += gtime() - g1;\n")
    src = _patch(src, "  drain(q, hb, lane);\n\n",
                 "  drain(q, hb, lane, tr);\n  const unsigned long long g3 = gtime();\n\n")
    return _patch(src, "        reinterpret_cast<const uint4*>(hw)[g * 32 + lane];\n}\n\n}  // namespace",
                  "        reinterpret_cast<const uint4*>(hw)[g * 32 + lane];\n" + end)


def _build(src, name):
    """Compile a kernel source with nvcc into a temporary library."""
    from moonbit_flate_tpu_torch.kernels import build
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, name + ".cu"), os.path.join(tmp, name + ".so")
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu], check=True)
        return ctypes.CDLL(so)


def _inputs():
    """The shard decode main path's input: staged streams, kernel A's
    tokens and misc."""
    from moonbit_flate_tpu_torch.ops import lanes_inflate as LI
    waves = cs.DEC_WAVES
    n = waves * LI.NSTR
    corpus = cs.make_corpus(total=n * LI.SEGB, seed=0)
    streams = [zlib.compress(corpus[i * LI.SEGB:(i + 1) * LI.SEGB], 1)[2:-4] for i in range(n)]
    nb, inw = LI.stage_streams_lanes(streams, waves)
    tok, misc = LI.parse_waves(nb, inw, waves)
    return waves, nb, inw, tok, misc


def resolve_section(inputs):
    """The package's kernel BC traced, on kernel A's tokens."""
    from moonbit_flate_tpu_torch.kernels import build
    from moonbit_flate_tpu_torch.ops import lanes_resolve as LR

    waves, _, _, tok, misc = inputs
    with open(os.path.join(build.CSRC, "lanes_resolve.cu")) as f:
        lib = _build(resolve_traced_source(f.read()), "lanes_resolve_trace")
    outlen = misc[:, 1].contiguous()
    want = LR.resolve_steps(outlen, tok, waves)
    real_ms = cs.cuda_ms(lambda: LR.resolve_steps(outlen, tok, waves), 5)
    out = torch.empty_like(want)
    out.fill_(0x5A5A5A5A)
    launch = lib.lanes_resolve_launch
    launch.argtypes = LR._ARGTYPES
    launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    traced_ms = cs.cuda_ms(lambda: build.check(launch(
        outlen.data_ptr(), tok.data_ptr(), out.data_ptr(), waves, stream),
        "lanes_resolve (traced)"), 5)
    if not torch.equal(out, want):
        raise AssertionError("the traced kernel BC's output differs from the kernel's")
    lib.lr_trace_get.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    n = waves * LR.NSTR
    d = np.zeros(n * RESOLVE_SLOTS, np.uint64)
    lib.lr_trace_get(d.ctypes.data_as(ctypes.c_void_p), d.size)
    d = d.reshape(n // 8, 8, RESOLVE_SLOTS).astype(np.int64)
    # a block: its span, the parts of its busiest warp (the most time in
    # loads, literals and copies), its matches
    span = d[:, :, 1].max(1) - d[:, :, 0].min(1)
    busiest = np.argmax(d[:, :, 2:5].sum(2), 1)
    parts = d[np.arange(n // 8), busiest]
    matches = d[:, :, 6].sum(1)
    us = 1e-3

    def part(i=None):
        row = parts.mean(0) if i is None else parts[i]
        dur = span.mean() if i is None else span[i]
        nm = matches.mean() if i is None else matches[i]
        return (f"{dur * us:.1f} us; its busiest warp: {row[7]:.0f} batches of rows, token "
                f"loads (waiting) {row[2] * us:.1f} us, offsets and literal placement "
                f"{row[3] * us:.1f} us, match copies {row[4] * us:.1f} us ({row[6]:.0f} "
                f"matches in {row[9]:.0f} rounds; {nm:.0f} in the block; by one lane "
                f"{row[11] * us:.1f} us, by the warp {row[12] * us:.1f} us), barrier after "
                f"a tile {row[8] * us:.1f} us, "
                f"output stores {row[5] * us:.1f} us")

    slow = int(np.argmax(span))
    print(f"lanes_resolve {real_ms:.4f} ms, traced {traced_ms:.4f} ms (equal output), "
          f"{waves} waves, {n // 8} blocks; span of the traced launch "
          f"{(d[:, :, 1].max() - d[:, :, 0].min()) * us:.1f} us", flush=True)
    print(f"lanes_resolve slowest block #{slow}: {part(slow)}", flush=True)
    print(f"lanes_resolve mean block: {part()}", flush=True)


def parse_section(inputs):
    from moonbit_flate_tpu_torch.kernels import build
    from moonbit_flate_tpu_torch.ops import lanes_inflate as LI

    with open(os.path.join(build.CSRC, "lanes_parse.cu")) as f:
        lib = _build(traced_source(f.read()), "lanes_parse_trace")
    lib.lp_trace_get.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    launch = lib.lanes_parse_launch
    launch.argtypes = LI._ARGTYPES
    launch.restype = ctypes.c_int

    dev = torch.device("cuda")
    waves, nb, inw, tok, misc = inputs
    n = waves * LI.NSTR
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


def main():
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("lanes_parse_trace: no CUDA device", file=sys.stderr)
        return 1
    from moonbit_flate_tpu_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.build_all(("lanes_parse", "lanes_resolve"))
    inputs = _inputs()
    parse_section(inputs)
    resolve_section(inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
