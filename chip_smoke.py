#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel from csrc/ (one nvcc per source, in parallel);
3. encode: holds the walk and pack kernels against their plain PyTorch
   twins on the same CUDA tensors at the main path's shapes (exact
   equality: the codec is integer-only), the walk also on rows with a
   context deep in the segment and data that ends early, and on batches
   of 2- and 1-block segments; times the walk's four kernels one by one
   and the pack as called and its two kernels alone;
   drives the encode main path,
   ``CUDACompressor(blocks_per_segment=16)`` over a 16 MiB mixed corpus,
   checks it round-trips through zlib and that both kernels were
   launched there; then a preset-dictionary case, a halo case, and the
   card against the plain route on a small input; times it all;
4. decode: runs kernel A (``lanes_parse``) and kernel BC
   (``lanes_resolve``, through both entries: kernel A's step-major
   tokens and the lane-major rows) at the main path's 32 waves, the
   last wave holding corrupt, truncated and overflowing streams, and
   holds the first and last waves against their twins, then kernel BC
   on the hand-made token rows of ``utils/lane_cases.token_cases``;
   drives the decode main path, ``decompress_shards`` over 32 x 1024
   zlib level-1 shards of 4096 bytes (128 MiB decoded), checks the
   bytes against the corpus and that each kernel was launched once
   there; times it all, the parse kernel also alone, kernel BC, the
   relayout of kernel A's tokens that the main path no longer makes,
   and one decode in parts, the staging also as it was made
   before (every stream's padded words through a zeroed pinned buffer)
   and through pageable memory, the readback also through pageable
   memory;
5. scalar decode: one launch of the parse kernel over 64 zlib level-1
   streams of 1,048,560-byte segments with the case streams of
   ``utils/stream_cases.py`` appended (every block type and error rule,
   mutants included), held against its twin on the case rows and against
   the host scanner's tokens on the 64 full-size rows; the resolve kernel
   on every stream that parsed to the end, against its twin at full
   size, on the token cases and on two rows of long matches that cross
   its windows; times the resolver in parts (rounds, each stream alone,
   the zero fill); drives the scalar main path, ``decompress_segments`` over the
   64 streams (64 MiB decoded), checks the bytes against the corpus and
   that both kernels were launched there; times the parser on each
   stream alone and on one segment coded three ways; then the port's own
   encoder output, ``decompress`` with the host and the device parser, a preset
   dictionary, and the exceptions of a truncated and a corrupt stream;
   times it all;
6. manifest: holds the batched pack kernels against their twin and,
   row by row, against the one-row call (``pack_units_dense``), on the units of 16
   real segments and on random units with an all-zero row and a row
   clipped at n_words, and times their two passes; drives the manifest main path,
   ``compress_with_manifest`` over the 64-shard corpus (4 waves of 16
   through ``encode_segments_batched`` and ``compact_streams``) and
   ``decompress_with_manifest`` back, checks the bytes, that stock zlib
   reads the stream, that the stream equals ``CUDACompressor``'s, and
   the launch counts of every kernel on that path; a one-shard case on
   the lane route; the card against the plain route; times both encode
   paths and the decode;
7. sharded: the sharded layer on the one card.  Drives its two main
   paths over the 16 MiB corpus at nb = 16 (one wave a segment), each with
   the walk and pack counts from 0: ``ShardedCompressor()`` from this
   process with no process group (the local mesh of ``make_mesh()``,
   every visible card), and ``ShardedCompressor`` in an NCCL world of 1;
   checks that zlib reads each, that each equals ``CUDACompressor``'s
   stream and that both kernels were launched there; a local mesh of four
   shards a wave on the card (``make_mesh(["cuda:0"] * 4)``) must give the
   same bytes; times and profiles both paths beside ``CUDACompressor``;
   then the card against the plain route at nb = 2,
   halo with a preset dictionary, the retry of a wave past a tight
   ``word_cap``, and ``compress_with_manifest`` through the mesh against
   the one-card batched form; spawns a gloo world of 2 ranks that share
   the card (not a multi-GPU run) and holds both ranks' streams against
   the world of 1; and round-trips the one-shot ``compress`` /
   ``decompress`` of the 'cuda', 'native', 'python' and default ('auto')
   backends, the default's bytes equal to 'native''s;
8. bench: the port's bench (``moonbit_flate_tpu_torch/bench.py``) in this
   process; prints its JSON line and the launch counts of its run, and
   fails unless the line holds no error, a positive value and the
   chip-independent fields of the JAX bench's line (``BENCH_r05.json``),
   and kernels a-f launched there, the batched pack never;
9. encode stages: ``encode_segment_ctx`` on one segment cut after each of
   its stages (the "encode stages" line), last, so that no timed path
   runs after it;
10. prints a JSON line of all kernels and, last, the device line.

``python3 chip_smoke.py --cards N`` needs N cards and runs only what
exists across cards: a local mesh over the N cards from this process
(one shard after another, launch counts from 0, timed) and an NCCL world
of N ranks, one card each (rank r on ``cuda:r`` through ``LOCAL_RANK``,
timed), whose streams must all equal ``CUDACompressor``'s on card 0;
and, in the main process, every kernel on the last card while card 0
stays current (the manifest encode and both decode routes).  It prints
no kernel line; its last line is the device line.

Every phase raises on failure.  Without a CUDA device it exits non-zero
before printing any result.  Imports nothing of JAX.
"""

import functools
import json
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from moonbit_flate_tpu_torch.utils.corpus import make_corpus

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
CORE_OPS_PER_S = 67e12      # H100 SXM non-tensor rate (data sheet, fp32)
DEC_WAVES = 32              # decode main path: 32 x 1024 shards of 4096 bytes
SEG_BYTES = 1048560         # the encoder's 16-block segment
N_SEGS = 64                 # scalar decode main path: 64 segment streams


# the bench corpus (moonbit_flate_tpu_torch/utils/corpus.py), made once
# for each (total, seed): the phases share the 16 MiB and 64 MiB corpora
make_corpus = functools.lru_cache(maxsize=None)(make_corpus)


def cuda_ms(fn, reps, warm=True):
    """Mean ms per call between CUDA events, after one warm-up call
    unless warm is False."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want):
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def profile_main_path(label, fn, warm=None):
    """Where the time of one main-path call goes: wall time, summed
    device time of its kernels and copies, the device's idle share, and
    the kernels and operators that take most device and host time.
    ``warm`` is a cheaper call of the same path to warm the tracer up
    with (by default fn itself)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile, record_function

    # one trace, two calls: the first warms the tracer up
    # (without it the events of the first part of a call can go missing),
    # the second runs inside a named range and only what starts in that
    # range is read.  Now and then the tracer hands back no device event
    # at all for the range: then the trace is taken again, three times at
    # the most.
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            (warm or fn)()
            torch.cuda.synchronize()
            with record_function("measured_call"):
                t0 = time.time()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.time() - t0) * 1e3
        events = prof.events()
        span = next(e.time_range for e in events
                    if e.key == "measured_call" and e.device_type == cpu)
        on_device, on_host = defaultdict(lambda: [0.0, 0]), defaultdict(lambda: [0.0, 0])
        for e in events:
            if e.key == "measured_call" or not span.start <= e.time_range.start <= span.end:
                continue
            if e.device_type == cuda:
                on_device[e.key][0] += e.self_device_time_total
                on_device[e.key][1] += 1
            else:
                on_host[e.key][0] += e.self_cpu_time_total
                on_host[e.key][1] += 1
        busy_ms = sum(t for t, _ in on_device.values()) / 1e3
        if busy_ms > 0:
            break
    else:
        print(f"profile {label}: wall {wall_ms:.1f} ms, device time not measured")
        return
    host_calls = {k: sum(c for name, (_, c) in on_host.items() if k in name)
                  for k in ("cudaLaunchKernel", "Synchronize")}
    n_device = sum(c for _, c in on_device.values())
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {n_device} device kernels and copies, "
          f"{host_calls['cudaLaunchKernel']} cudaLaunchKernel calls, "
          f"{host_calls['Synchronize']} synchronizing calls")
    for name, (t, c) in sorted(on_device.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  kernel {t / 1e3:9.3f} ms x{c:<5d} {name[:90]}")
    for name, (t, c) in sorted(on_host.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"  host   {t / 1e3:9.3f} ms x{c:<5d} {name[:90]}")


def bound(nbytes, ops):
    """Least time (ms) for the work, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_entry(name, src, replaces, launches, err, ms, plain_ms, nbytes, ops):
    bound_ms, bound_by = bound(nbytes, ops)
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


# tools/ablate_stages.py's names of the encoder's stage cuts
STAGE_LABELS = {1: "match find (sorts + lag tables)", 2: "greedy walk (walk.cu)",
                3: "token attrs + blkify", 4: "histograms", 5: "huffman build_codes",
                6: "codegen + dyn sizes", 7: "policy + unit assembly",
                None: "FULL (incl. pack)"}


def encode_stages_phase(dev, nb=16, reps=5):
    """``encode_segment_ctx`` on the corpus's first segment, cut after each
    stage and uncut: each call timed on the host up to a sync, the median
    of ``reps`` after a warm call, and the deltas between successive cuts.
    A cut's checksum must repeat on every call.  The last phase: no timed
    path runs after these calls."""
    from moonbit_flate_tpu_torch.api.cuda import stage_segment
    from moonbit_flate_tpu_torch.ops import pipeline

    buf, n, ctx = stage_segment(b"", make_corpus()[:nb * pipeline.BLOCK], nb)
    data = torch.from_numpy(buf).to(dev)
    med = {}
    for cut in STAGE_LABELS:
        times, sums = [], set()
        for r in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipeline.encode_segment_ctx(data, n, ctx, nb, stage_cut=cut)
            torch.cuda.synchronize()
            if r:
                times.append((time.perf_counter() - t0) * 1e3)
            sums.add(int(out[0]) if cut else out[0].cpu().numpy().tobytes())
        if len(sums) != 1:
            raise AssertionError(f"stage cut {cut} gives {len(sums)} different results")
        med[cut] = float(np.median(times))
    parts, prev = [], 0.0
    for cut, label in STAGE_LABELS.items():
        parts.append(f"cut {cut or 'none'} {label} {med[cut]:.2f} ({med[cut] - prev:+.2f})")
        prev = med[cut]
    print(f"encode stages (ms, median of {reps}; nb = {nb}, one segment of {n - ctx} "
          f"bytes; the delta to the cut before in brackets): " + "; ".join(parts),
          flush=True)
    return []


def encode_phase(dev):
    from moonbit_flate_tpu_torch.api.cuda import CUDACompressor, stage_segment
    from moonbit_flate_tpu_torch.ops import pack, pipeline, walk

    nb = 16
    S = nb * pipeline.BLOCK
    corpus = make_corpus()
    n_full = len(corpus) // S

    # ---- kernel phase: each kernel against its twin on the card ----------
    t0 = time.time()
    staged = [stage_segment(b"", corpus[i * S:(i + 1) * S], nb)
              for i in range(n_full)]
    staged.append(stage_segment(corpus[:32768], corpus[32768:S], nb))
    data = torch.from_numpy(np.stack([s[0] for s in staged])).to(dev)
    ns = [s[1] for s in staged]
    ctxs = [s[2] for s in staged]
    clipped = [pipeline._find_clip(data[b], ns[b], ctxs[b], nb)
               for b in range(len(staged))]
    mlen = torch.stack([m for m, _ in clipped])
    dist = torch.stack([d for _, d in clipped])
    walk_args = (data, mlen, dist, ns, ctxs, nb)
    got = walk.commit_walk(*walk_args)
    want = walk.commit_walk_ref(*walk_args)
    walk_err = max_abs_err(got, want)
    if walk_err:
        raise AssertionError(f"walk kernel differs from its twin: {walk_err}")
    committed, is_match, mlen2, dist2 = got
    matches = int(is_match.sum())
    matched_bytes = int(mlen2.long().sum())
    print(f"walk: {len(staged)} segments equal to the twin "
          f"({matches} matches, {matched_bytes} matched bytes)", flush=True)

    # more walks against the twin: a context that ends in a later tile with
    # data that ends inside one, a short segment, a context of one whole
    # block, an empty row; then batches of 2- and 1-block segments (a
    # ragged last tile, rows that start at odd addresses)
    extra = [(nb, [(corpus[:100_000], corpus[100_000:600_000]),
                   (b"", corpus[5 * S: 5 * S + 12_345]),
                   (corpus[S: S + 65_535], corpus[S + 65_535: 2 * S - 7]),
                   (b"", b"")]),
             (2, [(b"", corpus[2 * S: 2 * S + 131_070]),
                  (corpus[3 * S: 3 * S + 32_768], corpus[3 * S + 32_768: 3 * S + 90_001]),
                  (b"", b"z" * 131_000)]),
             (1, [(b"", corpus[4 * S: 4 * S + 65_535]),
                  (corpus[:1000], corpus[1000:40_000])])]
    for xnb, rows in extra:
        xs = [stage_segment(c, pl, xnb) for c, pl in rows]
        xdata = torch.from_numpy(np.stack([x[0] for x in xs])).to(dev)
        xn, xctx = [x[1] for x in xs], [x[2] for x in xs]
        xclip = [pipeline._find_clip(xdata[b], xn[b], xctx[b], xnb) for b in range(len(xs))]
        xargs = (xdata, torch.stack([m for m, _ in xclip]),
                 torch.stack([d for _, d in xclip]), xn, xctx, xnb)
        xgot = walk.commit_walk(*xargs)
        err = max_abs_err(xgot, walk.commit_walk_ref(*xargs))
        if err:
            raise AssertionError(f"walk kernel differs from its twin at nb = {xnb}, "
                                 f"n = {xn}, ctx = {xctx}: {err}")
        walk_err = max(walk_err, err)
        print(f"walk: nb = {xnb}, n = {xn}, ctx = {xctx} equal to the twin "
              f"({int(xgot[1].sum())} matches)", flush=True)
    del xdata, xclip, xargs, xgot

    vals, wids = (t[0] for t in pipeline._tokens_to_units(
        data[:1], ns[:1], ctxs[:1], committed[:1], is_match[:1], mlen2[:1],
        dist2[:1], nb))
    n_words = pipeline.n_words_for(nb)
    rng = np.random.default_rng(1)
    rw = rng.integers(0, 29, vals.numel()).astype(np.int32)
    rw[rng.random(vals.numel()) < 0.7] = 0
    rv = rng.integers(0, 1 << 28, vals.numel()).astype(np.int32)
    pack_cases = [(vals, wids),
                  (torch.from_numpy(rv).to(dev), torch.from_numpy(rw).to(dev))]
    pack_err = 0
    for v, w in pack_cases:
        pack_err = max(pack_err, max_abs_err(
            pack.pack_units_dense(v, w, n_words),
            pack.pack_units_ref(v, w, n_words)))
    if pack_err:
        raise AssertionError(f"pack kernel differs from its twin: {pack_err}")
    print(f"pack: {len(pack_cases)} unit sets of {vals.numel()} equal to the twin; "
          f"kernel phase {time.time() - t0:.1f} s", flush=True)

    # ---- main path: counts from 0, one compress, counts read after ---------
    walk.launches = 0
    pack.launches = 0
    comp = CUDACompressor(blocks_per_segment=nb)
    torch.cuda.synchronize()
    t0 = time.time()
    out = comp.compress(corpus)
    first_s = time.time() - t0
    launches = {"walk": walk.launches, "pack": pack.launches}
    if zlib.decompress(out, wbits=-15) != corpus:
        raise AssertionError("main path output does not round-trip")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"main path never launched the {name} kernel")
    print(f"main path: {len(corpus)} -> {len(out)} bytes (ratio "
          f"{len(out) / len(corpus):.4f}) in {first_s:.2f} s, launches {launches}",
          flush=True)

    small = corpus[:3 * S // 8]
    dct = corpus[5 * S: 5 * S + 32768]
    c_dict = comp.compress(small, dictionary=dct)
    dec = zlib.decompressobj(-15, zdict=dct)
    if dec.decompress(c_dict) + dec.flush() != small:
        raise AssertionError("dictionary case does not round-trip")
    halo_comp = CUDACompressor(blocks_per_segment=1, halo=True)
    c_halo = halo_comp.compress(small)
    if zlib.decompress(c_halo, wbits=-15) != small:
        raise AssertionError("halo case does not round-trip")
    tiny = corpus[7 * S: 7 * S + 200_000]
    for kw in ({}, {"halo": True}):
        on_card = CUDACompressor(4, device="cuda", **kw).compress(tiny)
        plain = CUDACompressor(4, device="cpu", **kw).compress(tiny)
        if on_card != plain:
            raise AssertionError(f"card and plain route differ ({kw})")
    print("dictionary, halo and card-vs-plain checks passed", flush=True)

    # ---- timing -------------------------------------------------------------
    t0 = time.time()
    out2 = comp.compress(corpus)
    enc_s = time.time() - t0
    if out2 != out:
        raise AssertionError("second encode differs from the first")
    mbps = len(corpus) / enc_s / 1e6
    print(f"encode: {enc_s:.3f} s for {len(corpus)} bytes = {mbps:.2f} MB/s",
          flush=True)

    profile_main_path("encode", lambda: comp.compress(corpus))

    B = data.shape[0]
    walk_ms = cuda_ms(lambda: walk.commit_walk(*walk_args), 5)
    walk_plain_ms = cuda_ms(lambda: walk.commit_walk_ref(*walk_args), 1)
    # the four kernels of one call, each alone on the arrays a whole call
    # has filled
    as_t = functools.partial(torch.tensor, dtype=torch.int32, device=dev)
    n_t, ctx_t = as_t(ns), as_t(ctxs)
    scratch, outs = walk._scratch(B, S, dev), walk._outputs(B, S, dev)
    parts = [cuda_ms(lambda: walk._launch(data, mlen, dist, ctx_t, n_t, scratch, outs,
                                          phase), 5) for phase in (walk.ALL_PHASES, 1, 2, 4, 8)]
    if max_abs_err(outs, got):
        raise AssertionError("walk kernels run one by one differ from one call")
    print("walk parts ({} segments): all four {:.4f} ms; extend {:.4f} ms, tile exits "
          "{:.4f} ms, stitch {:.4f} ms, mark {:.4f} ms".format(B, *parts), flush=True)
    del scratch, outs
    # bytes: what the function takes and returns, each once: the staged
    # data, mlen and dist in; committed, match_start, the final lengths
    # and distances out (19 B a position).  Operations: up to 13 doubling
    # rounds a position in each of two passes, 40 a committed match, two a
    # byte compared in extension (integer work on the CUDA cores)
    walk_bytes = B * (S + 320) + B * S * (4 + 4) + B * S * (1 + 1 + 4 + 4)
    walk_ops = 2 * 13 * 3 * B * S + 40 * matches + 2 * matched_bytes
    pv, pw = pack_cases[0]
    pack_ms = cuda_ms(lambda: pack.pack_units_dense(pv, pw, n_words), 20)
    # the C entry's two kernels alone, one row, on the wrapper's buffers
    bufs = pack._batch_buffers(1, pv.numel(), n_words, dev)
    pack_alone_ms = cuda_ms(lambda: pack._launch_batch(pv[None], pw[None], n_words, bufs), 20)
    if max_abs_err((bufs[0][0], bufs[1][0]), pack.pack_units_dense(pv, pw, n_words)):
        raise AssertionError("pack kernels called alone differ from the wrapper")
    pack_plain_ms = cuda_ms(lambda: pack.pack_units_ref(pv, pw, n_words), 5)
    pack_bytes = pv.numel() * 8 + n_words * 4
    pack_ops = 12 * pv.numel()
    print(f"pack {pack_ms:.4f} ms as the wrapper is called, the kernels alone "
          f"{pack_alone_ms:.4f} ms, twin {pack_plain_ms:.4f} ms ({pv.numel()} units, "
          f"one row); bound bytes {pack_bytes}", flush=True)

    return [
        kernel_entry("walk", "moonbit_flate_tpu_torch/csrc/walk.cu",
                     "moonbit_flate_tpu/ops/walk_pallas.py:320", launches["walk"],
                     walk_err, walk_ms, walk_plain_ms, walk_bytes, walk_ops),
        kernel_entry("pack", "moonbit_flate_tpu_torch/csrc/pack.cu",
                     "moonbit_flate_tpu/ops/pack.py:255", launches["pack"],
                     pack_err, pack_ms, pack_plain_ms, pack_bytes, pack_ops)]


def decode_phase(dev):
    from moonbit_flate_tpu_torch import decompress_shards
    from moonbit_flate_tpu_torch.ops import lanes_inflate as LI
    from moonbit_flate_tpu_torch.ops import lanes_resolve as LR
    from moonbit_flate_tpu_torch.utils.lane_cases import (lane_cases, rule_cases,
                                                           token_cases, token_wave)

    t0 = time.time()
    waves = DEC_WAVES
    n_sh = waves * LI.NSTR
    corpus = make_corpus(total=n_sh * LI.SEGB, seed=0)
    shards = [corpus[i * LI.SEGB:(i + 1) * LI.SEGB] for i in range(n_sh)]
    zstreams = [zlib.compress(s, 1)[2:-4] for s in shards]
    print(f"decode corpus: {n_sh} shards, {len(corpus)} bytes -> "
          f"{sum(map(len, zstreams))} compressed, made in {time.time() - t0:.1f} s",
          flush=True)

    def stage_pinned_loop(streams):
        """The staging as it was made before, for the breakdown: a zeroed
        pinned buffer of every stream's IN_W words, filled in a Python
        loop, all of it copied to the card and laid out there."""
        stride = LI.IN_W * 4
        host = torch.zeros(n_sh * stride, dtype=torch.uint8, pin_memory=True)
        buf = memoryview(host.numpy())
        nbits = np.zeros(n_sh, np.int32)
        for i, z in enumerate(streams):
            buf[i * stride: i * stride + len(z)] = z
            nbits[i] = len(z) * 8
        words = host.view(torch.int32).reshape(waves, LI.NSTR, LI.IN_CHUNKS, LI.LANE)
        return (torch.from_numpy(nbits.reshape(waves, LI.SUB, LI.LANE)).to(dev),
                words.to(dev, non_blocking=True).permute(0, 2, 1, 3).contiguous())

    # ---- kernels against their twins at the main path's shape -----------
    # 32 waves of corpus shards, except that the last wave opens with the
    # lane-test cases and the error-rule streams.  Each kernel runs once
    # on all 32 waves, kernel BC through both entries (kernel A's
    # step-major tokens, and the same rows relaid lane-major); the twins
    # run on the first wave and the last (one two-wave call, as the twins
    # cost per step, not per stream), and tok, misc rows 0-2 and out must
    # agree exactly.  Then kernel BC alone on one wave of hand-made token
    # rows (``utils/lane_cases.token_cases``), both entries.
    t0 = time.time()
    cases = lane_cases() + rule_cases()
    last = n_sh - LI.NSTR
    check = zstreams[:last] + cases + zstreams[last + len(cases):]
    nbc, inwc = LI.stage_streams_lanes(check, waves)
    tok, misc = LI.parse_waves(nbc, inwc, waves)
    sel = [0, waves - 1]
    tok_r, misc_r = LI.parse_waves_ref(nbc[sel].contiguous(), inwc[sel].contiguous(), 2)
    parse_err = max_abs_err((tok[sel], misc[sel, :3]), (tok_r, misc_r[:, :3]))
    if parse_err:
        raise AssertionError(f"lanes_parse kernel differs from its twin: {parse_err}")
    st = misc[waves - 1, 0].reshape(-1).cpu().numpy()
    kinds = {int(k): int(c) for k, c in zip(*np.unique(st, return_counts=True))}
    for want in (LI.ST_DONE, LI.ST_CORRUPT, LI.ST_TRUNC, LI.ST_OVERFLOW):
        if want not in kinds:
            raise AssertionError(f"check wave never reached status {want}: {kinds}")
    tok_lmc = LR.lane_major(tok)
    outlenc = misc[:, 1].contiguous()
    outc = LR.resolve_steps(outlenc, tok, waves)
    out_lm = LR.resolve_waves(outlenc, tok_lmc, waves)
    want = LR.resolve_waves_ref(outlenc[sel], tok_lmc[sel], 2)
    resolve_err = max(max_abs_err((outc[sel],), (want,)), max_abs_err((out_lm[sel],), (want,)))
    if resolve_err or not torch.equal(out_lm, outc):
        raise AssertionError(f"lanes_resolve kernel differs from its twin: {resolve_err}")
    cases = token_cases()
    outlen_t, tok_t = (torch.from_numpy(a).to(dev) for a in token_wave(cases))
    want = LR.resolve_waves_ref(outlen_t, LR.lane_major(tok_t), 1)
    cases_err = max(max_abs_err((LR.resolve_steps(outlen_t, tok_t, 1),), (want,)),
                    max_abs_err((LR.resolve_waves(outlen_t, LR.lane_major(tok_t), 1),), (want,)))
    if cases_err:
        raise AssertionError(f"lanes_resolve kernel differs from its twin on the token "
                             f"cases: {cases_err}")
    print(f"lanes_parse, lanes_resolve: {waves} waves in one launch each; waves "
          f"{sel} equal to the twins (statuses of the last wave {kinds}), lanes_resolve "
          f"through both entries; {len(cases)} token cases equal to the twin through both "
          f"entries; in {time.time() - t0:.1f} s", flush=True)
    del check, nbc, inwc, tok, misc, tok_r, misc_r, tok_lmc, outlenc, outc, out_lm

    # ---- main path: counts from 0, one decode, counts read after ------------
    sizes = [LI.SEGB] * n_sh
    LI.launches = 0
    LR.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    dec = decompress_shards(zstreams, sizes)
    first_s = time.time() - t0
    launches = {"lanes_parse": LI.launches, "lanes_resolve": LR.launches}
    if b"".join(dec) != corpus:
        raise AssertionError("decode main path does not give the corpus back")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"decode main path never launched the {name} kernel")
    if launches != {"lanes_parse": 1, "lanes_resolve": 1}:
        raise AssertionError(f"decode main path launched {launches}, not one of each")
    print(f"decode main path: {n_sh} shards -> {len(corpus)} bytes, all DONE, in "
          f"{first_s:.3f} s, launches {launches}", flush=True)

    # ---- timing -------------------------------------------------------------
    t0 = time.time()
    dec2 = decompress_shards(zstreams, sizes)
    dec_s = time.time() - t0
    if dec2 != dec:
        raise AssertionError("second decode differs from the first")
    print(f"decode: {dec_s:.3f} s for {len(corpus)} bytes = "
          f"{len(corpus) / dec_s / 1e6:.2f} MB/s", flush=True)
    profile_main_path("decode", lambda: decompress_shards(zstreams, sizes))

    # one decode in parts: staging (the streams' bytes to the card, the
    # words cut out there), both kernels, the status readback, the kept
    # bytes (gather, copy to the host through a pinned buffer) and their
    # split into bytes objects; then, on the same streams, the staging as
    # it was made before (every stream's padded words through a zeroed
    # pinned buffer) and the staging and the copy through pageable host
    # memory
    del dec2
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.time())

    mark()
    nb, inw = LI.stage_streams_lanes(zstreams, waves)
    mark()
    out, misc = LR.inflate_waves(nb, inw, waves)
    mark()
    n = misc[:, 1].reshape(-1).cpu().numpy().astype(np.int64)
    mark()
    flat = LR._kept_bytes(out, n)
    mark()
    if LR._split(flat, n) != dec:
        raise AssertionError("decode in parts differs from decompress_shards")
    mark()
    nb_loop, inw_loop = stage_pinned_loop(zstreams)
    mark()
    buf = bytearray(waves * LI.NSTR * LI.IN_W * 4)
    for i, z in enumerate(zstreams):
        buf[i * LI.IN_W * 4: i * LI.IN_W * 4 + len(z)] = z
    inw_pageable = torch.frombuffer(buf, dtype=torch.int32).reshape(
        waves, LI.NSTR, LI.IN_CHUNKS, LI.LANE).to(dev).permute(0, 2, 1, 3).contiguous()
    mark()
    rows = out.permute(0, 2, 1, 3).reshape(waves * LI.NSTR, -1).contiguous().view(torch.uint8)
    keep = torch.arange(LI.SEGB, device=dev)[None, :] < torch.from_numpy(n).to(dev)[:, None]
    torch.cuda.synchronize()
    t0 = time.time()
    flat_pageable = rows[keep].cpu().numpy()
    marks.append(time.time())
    if not (torch.equal(inw_pageable, inw) and torch.equal(inw_loop, inw)
            and torch.equal(nb_loop, nb)) or flat_pageable.tobytes() != flat.tobytes():
        raise AssertionError("the three stagings or the two readbacks differ")
    parts = np.diff(marks) * 1e3
    parts[-1] = (marks[-1] - t0) * 1e3
    print("decode breakdown: staging {:.1f} ms, inflate_waves {:.1f} ms, status "
          "readback {:.1f} ms, kept bytes to the host (pinned) {:.1f} ms, split into "
          "bytes {:.1f} ms; total {:.1f} ms; staging as before (padded words through "
          "pinned memory) {:.1f} ms, equal inw; through pageable memory: staging {:.1f} "
          "ms, kept bytes to the host {:.1f} ms".format(
              *parts[:5], parts[:5].sum(), *parts[5:]), flush=True)
    del buf, inw_pageable, rows, keep, flat, flat_pageable, nb_loop, inw_loop

    tok, misc = LI.parse_waves(nb, inw, waves)
    if not bool((misc[:, 0] == LI.ST_DONE).all()):
        raise AssertionError("decode statuses are not all DONE")
    outlen = misc[:, 1].contiguous()
    out = LR.resolve_steps(outlen, tok, waves)
    parse_ms = cuda_ms(lambda: LI.parse_waves(nb, inw, waves), 3)
    bufs = LI._buffers(waves, dev)
    parse_alone_ms = cuda_ms(lambda: LI._launch(nb, inw, waves, bufs), 3)
    if max_abs_err(bufs[:2], (tok, misc)):
        raise AssertionError("lanes_parse called alone differs from the wrapper")
    del bufs
    resolve_ms = cuda_ms(lambda: LR.resolve_steps(outlen, tok, waves), 5)
    # what the main path no longer does: kernel A's tokens relaid
    # lane-major (the JAX kernel's input)
    relayout_ms = cuda_ms(lambda: LR.lane_major(tok), 5)
    tok_lm = LR.lane_major(tok)
    parse_plain_ms = cuda_ms(lambda: LI.parse_waves_ref(nb[:1], inw[:1], 1), 1, warm=False)
    resolve_plain_ms = cuda_ms(
        lambda: LR.resolve_waves_ref(outlen[:1], tok_lm[:1], 1), 1, warm=False)
    # bytes this run's data needs, each read or written once.  Kernel A
    # reads nbits and each stream's words up to its last bit, and writes
    # every token row and misc.  Kernel BC reads outlen and each stream's
    # token rows, 32 at a time, up to the one that completes its output,
    # and writes every output word.  Operations: kernel A up to 64 a
    # symbol (a length count of up to 15 rounds where the root misses), a
    # symbol per literal and two per match; BC 4 a byte and 8 a record.
    n_lit = int((tok > 0).sum())
    n_match = int((tok < 0).sum())
    in_words = int(((nb.long() + 31) // 32).sum())
    row1 = torch.arange(1, LI.TOK_ROWS + 1, dtype=torch.int32, device=tok.device)
    last_row = ((tok.reshape(waves, LI.TOK_ROWS, LI.NSTR) != 0)
                * row1[None, :, None]).amax(1).long()
    rows_read = int(torch.where(outlen.reshape(waves, LI.NSTR) > 0,
                                (last_row + 31) // 32 * 32, 0).sum())
    parse_bytes = 4 * (nb.numel() + in_words + tok.numel() + misc.numel())
    parse_ops = 64 * (n_lit + 2 * n_match)
    resolve_bytes = 4 * (outlen.numel() + rows_read + out.numel())
    resolve_ops = 4 * len(corpus) + 8 * (n_lit + n_match)
    print(f"lanes_parse {parse_ms:.4f} ms ({waves} waves) as the wrapper is called, the "
          f"kernel alone {parse_alone_ms:.4f} ms, twin {parse_plain_ms:.1f} ms "
          f"(1 wave); lanes_resolve {resolve_ms:.4f} ms on kernel A's step-major tokens, "
          f"twin {resolve_plain_ms:.1f} ms; "
          f"the relayout to lane-major alone {relayout_ms:.4f} ms "
          f"({2 * tok.numel() * 4} bytes read and written); "
          f"{n_lit} literals, {n_match} matches; bound bytes: lanes_parse "
          f"{parse_bytes} ({in_words} input words), lanes_resolve {resolve_bytes} "
          f"({rows_read} token rows)", flush=True)
    return [
        kernel_entry("lanes_parse", "moonbit_flate_tpu_torch/csrc/lanes_parse.cu",
                     "moonbit_flate_tpu/ops/lanes_inflate.py:869",
                     launches["lanes_parse"], parse_err, parse_ms, parse_plain_ms,
                     parse_bytes, parse_ops),
        kernel_entry("lanes_resolve", "moonbit_flate_tpu_torch/csrc/lanes_resolve.cu",
                     "moonbit_flate_tpu/ops/lanes_resolve.py:292",
                     launches["lanes_resolve"], resolve_err, resolve_ms,
                     resolve_plain_ms, resolve_bytes, resolve_ops)]


def scalar_decode_phase(dev):
    from moonbit_flate_tpu_torch import compress, decompress_segments
    from moonbit_flate_tpu_torch.inflate import cuda_inflate as CI
    from moonbit_flate_tpu_torch.inflate.cuda_inflate import decompress
    from moonbit_flate_tpu_torch.ops import parse as P
    from moonbit_flate_tpu_torch.ops import resolve as R
    from moonbit_flate_tpu_torch.utils import stream_cases as SC
    from moonbit_flate_tpu_torch.utils.errors import (CorruptInputError,
                                                      UnexpectedEOFError)
    from moonbit_flate_tpu_torch.utils.lane_cases import lane_cases, rule_cases

    t0 = time.time()
    corpus = make_corpus(total=N_SEGS * SEG_BYTES, seed=0)
    segs = [corpus[i * SEG_BYTES:(i + 1) * SEG_BYTES] for i in range(N_SEGS)]
    zstreams = [zlib.compress(s, 1)[2:-4] for s in segs]
    sizes = [SEG_BYTES] * N_SEGS
    print(f"scalar corpus: {N_SEGS} segments, {len(corpus)} bytes -> "
          f"{sum(map(len, zstreams))} compressed, made in {time.time() - t0:.1f} s",
          flush=True)

    # the geometry decompress_segments derives from the sizes
    n_chunks = -(-(SEG_BYTES + 1) // P.OUT_CHUNK)
    no_pad = nt_pad = n_chunks * P.OUT_CHUNK

    # ---- parse kernel against its twin and the host scanner ------------------
    # One launch at the main path's shape: the 64 streams, then the case
    # streams.  The twin is a step loop, so it runs on the case rows only
    # (same n_chunks); the 64 full-size rows are held against the host
    # scanner's tokens.  No stream exhausts 129 chunks, so status 0 comes
    # from a second launch of the case rows at their own small capacity.
    t0 = time.time()
    cases = [c[1] for c in SC.stream_cases()] + lane_cases() + rule_cases() \
        + SC.fuzz_cases()
    n_cases = len(cases)
    nbc, wc = P.stage_streams(zstreams + cases)
    toks, cnt = P.parse_batch(nbc, wc, n_chunks)
    torch.cuda.synchronize()
    rows = slice(N_SEGS, None)
    nb_c, w_c = nbc[rows], wc[rows].contiguous()
    t1 = time.time()
    toks_r, cnt_r = P.parse_batch_ref(nb_c, w_c, n_chunks)
    torch.cuda.synchronize()
    parse_plain_ms = (time.time() - t1) * 1e3
    parse_err = max_abs_err((toks[rows], cnt[rows]), (toks_r, cnt_r))
    toks_s, cnt_s = P.parse_batch(nb_c, w_c, SC.CASE_CHUNKS, SC.CASE_CHUNK)
    parse_err = max(parse_err, max_abs_err(
        (toks_s, cnt_s), P.parse_batch_ref(nb_c, w_c, SC.CASE_CHUNKS, SC.CASE_CHUNK)))
    if parse_err:
        raise AssertionError(f"parse kernel differs from its twin: {parse_err}")
    cnt_h = cnt.cpu().numpy()
    st = np.concatenate([cnt_h[:, 1], cnt_s[:, 1].cpu().numpy()])
    kinds = {int(k): int(c) for k, c in zip(*np.unique(st, return_counts=True))}
    for want in (P.ST_DONE, P.ST_MORE, P.ST_CORRUPT, P.ST_TRUNC):
        if want not in kinds:
            raise AssertionError(f"parse check never reached status {want}: {kinds}")
    if not (cnt_h[:N_SEGS, 1] == P.ST_DONE).all() \
            or not (cnt_h[:N_SEGS, 2] == SEG_BYTES).all():
        raise AssertionError("a full-size stream did not parse to the end")
    for i, s in enumerate(zstreams):
        if not np.array_equal(toks[i, :cnt_h[i, 0]].cpu().numpy(), CI.scan_tokens(s)):
            raise AssertionError(f"parse kernel differs from the host scanner, stream {i}")
    print(f"parse: {N_SEGS} full-size streams equal to the host scanner, "
          f"{n_cases} case streams equal to the twin at {n_chunks} x {P.OUT_CHUNK} "
          f"and {SC.CASE_CHUNKS} x {SC.CASE_CHUNK} tokens (statuses {kinds}) in "
          f"{time.time() - t0:.1f} s", flush=True)
    del toks_r, cnt_r, toks_s, cnt_s, nb_c, w_c

    # ---- resolve kernel against its twin, every DONE row, full size --------
    t0 = time.time()
    done = torch.from_numpy(np.nonzero(cnt_h[:, 1] == P.ST_DONE)[0]).to(dev)
    tk, nk = toks[done].contiguous(), cnt[done, 0].contiguous()
    out = R.resolve_batch(tk, nk, nt_pad, no_pad)
    resolve_err = 0
    for lo in range(0, len(done), 32):         # the twin keeps ~20 int64 arrays
        ref = R.resolve_batch_ref(tk[lo:lo + 32], nk[lo:lo + 32], nt_pad, no_pad)
        resolve_err = max(resolve_err, max_abs_err((out[lo:lo + 32],), (ref,)))
        del ref
    tcases = SC.token_cases()
    tt = np.zeros((len(tcases), 1024), np.int32)
    tn = np.zeros(len(tcases), np.int32)
    for i, (_, t) in enumerate(tcases):
        tt[i, :len(t)] = t
        tn[i] = len(t)
    tt[:, 900:] = 77                           # what lies past ntok is ignored
    tt, tn = torch.from_numpy(tt).to(dev), torch.from_numpy(tn).to(dev)
    resolve_err = max(resolve_err, max_abs_err(
        (R.resolve_batch(tt, tn, 1024, R.OUT_BYTES),),
        (R.resolve_batch_ref(tt, tn, 1024, R.OUT_BYTES),)))
    # rows of long matches, whose rounds nearly all end in a match that
    # runs past the window, one of them cut at no_pad
    wrows = [SC.window_tokens(200_000, seed=s) for s in range(2)]
    wt = np.zeros((2, -(-max(map(len, wrows)) // 1024) * 1024), np.int32)
    for i, t in enumerate(wrows):
        wt[i, :len(t)] = t
    wt = torch.from_numpy(wt).to(dev)
    wn = torch.tensor([len(t) for t in wrows], dtype=torch.int32, device=dev)
    crossing = sum(e > R.WINDOW for t in wrows
                   for _, _, _, e in R.round_bounds(torch.from_numpy(t), 204_800)[:-1])
    for w_pad in (204_800, 196_608):
        resolve_err = max(resolve_err, max_abs_err(
            (R.resolve_batch(wt, wn, wt.shape[1], w_pad),),
            (R.resolve_batch_ref(wt, wn, wt.shape[1], w_pad),)))
    if resolve_err:
        raise AssertionError(f"resolve kernel differs from its twin: {resolve_err}")
    got = out[:N_SEGS].cpu().numpy().view(np.uint8)[:, :SEG_BYTES]
    if got.tobytes() != corpus:
        raise AssertionError("resolve kernel output is not the corpus")
    print(f"resolve: {len(done)} streams of {no_pad} bytes, {len(tcases)} token cases "
          f"and 2 rows of long matches ({crossing} rounds end in a match across the "
          f"window) equal to the twin in {time.time() - t0:.1f} s", flush=True)
    del cases, nbc, wc, toks, cnt, tk, nk, out, got, tt, tn, wt, wn

    # ---- main path: counts from 0, one decode, counts read after ------------
    P.launches = 0
    R.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    dec = decompress_segments(zstreams, sizes)
    first_s = time.time() - t0
    launches = {"parse": P.launches, "resolve": R.launches}
    if b"".join(dec) != corpus:
        raise AssertionError("scalar main path does not give the corpus back")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"scalar main path never launched the {name} kernel")
    print(f"scalar main path: {N_SEGS} streams -> {len(corpus)} bytes in "
          f"{first_s:.3f} s, launches {launches}", flush=True)

    t0 = time.time()
    own = [compress(s, backend="cuda") for s in segs[:8]]
    if decompress_segments(own, sizes[:8]) != segs[:8]:
        raise AssertionError("the port's own streams do not decode to their segments")
    for kw in ({}, {"parse_on_device": True}):
        if decompress(own[0], **kw) != segs[0]:
            raise AssertionError(f"decompress({kw}) differs from the segment")
    zdict = corpus[5 * SEG_BYTES: 5 * SEG_BYTES + 32768]
    payload = corpus[5 * SEG_BYTES + 20000: 5 * SEG_BYTES + 120000]
    co = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=zdict)
    with_dict = co.compress(payload) + co.flush()
    if decompress(with_dict, dictionary=zdict) != payload:
        raise AssertionError("dictionary stream does not decode to its payload")
    for bad, exc in ((zstreams[1][: len(zstreams[1]) // 2], UnexpectedEOFError),
                     (bytes([0x06]) + zstreams[1][1:], CorruptInputError)):
        try:
            decompress_segments([zstreams[0], bad], sizes[:2])
        except exc:
            continue
        raise AssertionError(f"decompress_segments did not raise {exc.__name__}")
    print(f"own streams ({sum(map(len, own))} bytes for 8 segments), decompress with "
          f"both parsers, dictionary and the two exceptions passed in "
          f"{time.time() - t0:.1f} s", flush=True)

    # ---- timing -------------------------------------------------------------
    t0 = time.time()
    dec2 = decompress_segments(zstreams, sizes)
    dec_s = time.time() - t0
    if dec2 != dec:
        raise AssertionError("second scalar decode differs from the first")
    print(f"scalar decode: {dec_s:.3f} s for {len(corpus)} bytes = "
          f"{len(corpus) / dec_s / 1e6:.2f} MB/s", flush=True)
    del dec2
    profile_main_path("scalar decode", lambda: decompress_segments(zstreams, sizes))

    # one decode in parts: staging (host, then the copy to the card), the
    # two kernels, the status readback, and the bytes (copy to the host,
    # split into bytes objects)
    marks = []

    def mark():
        torch.cuda.synchronize()
        marks.append(time.time())

    mark()
    nb, w = P.stage_streams(zstreams)
    mark()
    out, cnt = CI._parse_resolve(nb, w, n_chunks)
    mark()
    n_out = cnt.cpu().numpy()[:, 2].tolist()
    mark()
    out_h = CI._output_to_host(out)
    mark()
    if [out_h[i, :n].tobytes() for i, n in enumerate(n_out)] != dec:
        raise AssertionError("scalar decode in parts differs from decompress_segments")
    mark()
    parts = np.diff(marks) * 1e3
    print("scalar decode breakdown: staging {:.1f} ms, parse + resolve {:.1f} ms, "
          "status readback {:.1f} ms, copy to pinned host memory {:.1f} ms, split into "
          "bytes {:.1f} ms; total {:.1f} ms".format(*parts, parts.sum()), flush=True)

    toks, cnt = P.parse_batch(nb, w, n_chunks)
    ntok = cnt[:, 0].contiguous()
    parse_ms = cuda_ms(lambda: P.parse_batch(nb, w, n_chunks), 5)
    # the same launch on empty streams: what zeroing the token rows costs
    nb_empty = torch.zeros_like(nb)
    parse_fill_ms = cuda_ms(lambda: P.parse_batch(nb_empty, w, n_chunks), 5)
    resolve_ms = cuda_ms(lambda: R.resolve_batch(toks, ntok, nt_pad, no_pad), 5)
    # the resolver in parts: rounds a stream (one window each), each
    # stream alone (a launch is as slow as its slowest stream), and the
    # launch on empty streams, the zero fill alone
    rounds = [len(R.round_bounds(toks[i, :n].cpu(), no_pad))
              for i, n in enumerate(ntok.tolist())]
    r_alone = sorted(((cuda_ms(lambda: R.resolve_batch(toks[i:i + 1], ntok[i:i + 1], nt_pad,
                                                       no_pad), 3), i) for i in range(N_SEGS)),
                     reverse=True)
    no_tokens = torch.zeros_like(ntok)
    r_fill_ms = cuda_ms(lambda: R.resolve_batch(toks, no_tokens, nt_pad, no_pad), 5)
    slow_ms, slow = r_alone[0]
    print(f"resolve parts: all {N_SEGS} streams {resolve_ms:.4f} ms; {min(rounds)}-"
          f"{max(rounds)} rounds of a {R.WINDOW}-byte window a stream; slowest stream alone "
          f"#{slow} {slow_ms:.4f} ms ({rounds[slow]} rounds, "
          f"{slow_ms * 1e3 / rounds[slow]:.2f} us a round), second #{r_alone[1][1]} "
          f"{r_alone[1][0]:.4f} ms, fastest #{r_alone[-1][1]} {r_alone[-1][0]:.4f} ms; "
          f"zero tail alone (empty streams) {r_fill_ms:.4f} ms", flush=True)
    resolve_plain_ms = cuda_ms(
        lambda: [R.resolve_batch_ref(toks[lo:lo + 32], ntok[lo:lo + 32], nt_pad, no_pad)
                 for lo in range(0, N_SEGS, 32)], 1)
    # where the parser's time goes: a launch is as slow as its slowest
    # stream, so each stream alone, and one segment coded three ways (zlib
    # level 6; literals only; stored, which the warp expands together)
    alone = sorted(((cuda_ms(lambda: P.parse_batch(nb[i:i + 1], w[i:i + 1], n_chunks), 2),
                     i) for i in range(N_SEGS)), reverse=True)
    row_tokens, row_matches = ntok.tolist(), (toks < 0).sum(1).tolist()
    print("parse alone, slowest streams: " + ", ".join(
        f"#{i} {ms:.3f} ms ({row_tokens[i]} tokens, {row_matches[i]} matches)"
        for ms, i in alone[:4]) + f"; fastest #{alone[-1][1]} {alone[-1][0]:.3f} ms",
        flush=True)
    huff = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_HUFFMAN_ONLY)
    kinds = (("zlib level 6", zlib.compress(segs[0], 6)[2:-4]),
             ("Huffman only", huff.compress(segs[0]) + huff.flush()),
             ("stored", zlib.compress(segs[0], 0)[2:-4]))
    for kind, stream in kinds:
        nb1, w1 = P.stage_streams([stream])
        n1, st1, _ = P.parse_batch(nb1, w1, n_chunks)[1][0].tolist()
        if st1 != P.ST_DONE:
            raise AssertionError(f"the {kind} stream did not parse to its end")
        ms = cuda_ms(lambda: P.parse_batch(nb1, w1, n_chunks), 3)
        print(f"parse of segment 0 as {kind}: {len(stream)} bytes, {n1} tokens, "
              f"{ms:.4f} ms = {ms * 1e6 / n1:.1f} ns a token", flush=True)
    # bytes this run's data needs, each read or written once.  The parser
    # reads nbits and each stream's words up to its last bit, and writes
    # the whole token array and cnt.  The resolver reads ntok and each
    # stream's ntok tokens and writes no_pad bytes a stream.  Operations:
    # the parser some 24 a decoded symbol (one a literal, two a match),
    # the resolver 4 a byte and 8 a record.
    n_tok = int(ntok.sum())
    n_match = int((toks < 0).sum())
    in_words = int(((nb.long() + 31) // 32).sum())
    parse_bytes = 4 * (nb.numel() + in_words + toks.numel() + cnt.numel())
    parse_ops = 24 * (n_tok + n_match)
    resolve_bytes = 4 * (ntok.numel() + n_tok) + N_SEGS * no_pad
    resolve_ops = 4 * len(corpus) + 8 * n_tok
    print(f"parse {parse_ms:.4f} ms ({N_SEGS} streams, {n_chunks} chunks; "
          f"{parse_fill_ms:.4f} ms on empty streams, the zero fill alone), twin "
          f"{parse_plain_ms:.1f} ms (the {n_cases} case rows only); resolve {resolve_ms:.4f} ms, twin {resolve_plain_ms:.1f} ms "
          f"({N_SEGS} streams, two calls of 32); {n_tok} tokens, {n_match} matches; "
          f"bound bytes: parse {parse_bytes} ({in_words} input words), resolve "
          f"{resolve_bytes}", flush=True)
    return [
        kernel_entry("parse", "moonbit_flate_tpu_torch/csrc/parse.cu",
                     "moonbit_flate_tpu/ops/parse_pallas.py:593", launches["parse"],
                     parse_err, parse_ms, parse_plain_ms, parse_bytes, parse_ops),
        kernel_entry("resolve", "moonbit_flate_tpu_torch/csrc/resolve.cu",
                     "moonbit_flate_tpu/ops/resolve_pallas.py:236", launches["resolve"],
                     resolve_err, resolve_ms, resolve_plain_ms, resolve_bytes,
                     resolve_ops)]


def manifest_phase(dev):
    from moonbit_flate_tpu_torch import (CUDACompressor, compress_with_manifest,
                                         decompress_with_manifest)
    from moonbit_flate_tpu_torch.api.cuda import stage_segment
    from moonbit_flate_tpu_torch.ops import lanes_inflate as LI
    from moonbit_flate_tpu_torch.ops import lanes_resolve as LR
    from moonbit_flate_tpu_torch.ops import pack, pipeline, walk
    from moonbit_flate_tpu_torch.ops import parse as P
    from moonbit_flate_tpu_torch.ops import resolve as R
    from moonbit_flate_tpu_torch.parallel.sharded import WAVE

    nb = SEG_BYTES // pipeline.BLOCK
    S = SEG_BYTES
    B = WAVE
    corpus = make_corpus(total=N_SEGS * SEG_BYTES, seed=0)
    n_words = pipeline.n_words_for(nb)

    # ---- the batched pack against its twin and against kernel b --------------
    # the units of one wave of real shards, as encode_segments_batched
    # makes them, and random units (70% of the widths zero) with a row of
    # all-zero widths and a row whose bits run past n_words
    t0 = time.time()
    staged = [stage_segment(b"", corpus[i * S:(i + 1) * S], nb) for i in range(B)]
    data = torch.from_numpy(np.stack([s[0] for s in staged])).to(dev)
    ns = [s[1] for s in staged]
    ctxs = [0] * B
    as_t = functools.partial(torch.tensor, dtype=torch.int32, device=dev)
    mlen, dist = pipeline._find_clip_batch(data, as_t(ns), as_t(ctxs), nb)
    committed, is_match, mlen, dist = walk.commit_walk(data, mlen, dist, ns, ctxs, nb)
    vals, wids = pipeline._tokens_to_units(data, ns, ctxs, committed, is_match,
                                           mlen, dist, nb)
    del data, mlen, dist, committed, is_match
    NU = vals.shape[1]
    rng = np.random.default_rng(2)
    rw = rng.integers(0, 29, (B, NU)).astype(np.int32)
    rw[rng.random((B, NU)) < 0.7] = 0
    rw[3] = 0
    rw[5] = rng.integers(20, 29, NU)
    if int(rw[5].sum()) <= 32 * n_words:
        raise AssertionError("the clipped row does not run past n_words")
    rv = rng.integers(0, 1 << 28, (B, NU)).astype(np.int32)
    cases = [(vals, wids), (torch.from_numpy(rv).to(dev), torch.from_numpy(rw).to(dev))]
    err = 0
    for v, w in cases:
        got = pack.pack_units_dense_batch(v, w, n_words)
        err = max(err, max_abs_err(got, pack.pack_units_batch_ref(v, w, n_words)))
        rows = [pack.pack_units_dense(v[b], w[b], n_words) for b in range(B)]
        err = max(err, max_abs_err(got, (torch.stack([r[0] for r in rows]),
                                         torch.stack([r[1] for r in rows]))))
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"pack_batch kernel differs from its twin or from "
                             f"the one-segment kernel: {err}")
    print(f"pack_batch: {len(cases)} sets of {B} x {NU} units equal to the twin and, "
          f"row by row, to the pack kernel, in {time.time() - t0:.1f} s", flush=True)
    del cases, rows, got

    # ---- main path: counts from 0, compress and decompress, counts read after
    mods = {"walk": walk, "pack": pack, "lanes_parse": LI, "lanes_resolve": LR,
            "parse": P, "resolve": R}

    def reset():
        for m in mods.values():
            m.launches = 0
        pack.launches_batch = 0

    def counts():
        return dict({k: m.launches for k, m in mods.items()},
                    pack_batch=pack.launches_batch)

    reset()
    torch.cuda.synchronize()
    t0 = time.time()
    stream, manifest = compress_with_manifest(corpus, blocks_per_segment=nb)
    enc_first_s = time.time() - t0
    back = decompress_with_manifest(stream, manifest)
    launches = counts()
    waves = -(-N_SEGS // WAVE)
    want = {"walk": waves, "pack_batch": waves, "pack": 0, "lanes_parse": 0,
            "lanes_resolve": 0}
    if any(launches[k] != v for k, v in want.items()) \
            or launches["parse"] < 1 or launches["resolve"] < 1:
        raise AssertionError(f"manifest main path launches {launches}, "
                             f"expected {want} and parse, resolve >= 1")
    if back != corpus:
        raise AssertionError("manifest main path does not give the corpus back")
    if zlib.decompress(stream, wbits=-15) != corpus:
        raise AssertionError("stock zlib does not read the manifest stream")
    if manifest.payload_sizes != [S] * N_SEGS \
            or sum(manifest.comp_sizes) + 5 != len(stream):
        raise AssertionError("manifest sizes do not describe the stream")
    comp = CUDACompressor(blocks_per_segment=nb)
    if comp.compress(corpus) != stream:
        raise AssertionError("manifest stream differs from CUDACompressor's")
    print(f"manifest main path: {len(corpus)} -> {len(stream)} bytes in "
          f"{N_SEGS} shards, {waves} waves (first call {enc_first_s:.2f} s), "
          f"decoded back, zlib reads it, equal to CUDACompressor's stream; "
          f"launches {launches}", flush=True)

    # one shard of at most 4096 bytes takes the lane route
    reset()
    small = corpus[70000:74000]
    s_stream, s_man = compress_with_manifest(small, blocks_per_segment=nb)
    if decompress_with_manifest(s_stream, s_man) != small:
        raise AssertionError("one-shard manifest case does not round-trip")
    lane = counts()
    if lane["lanes_parse"] < 1 or lane["lanes_resolve"] < 1 or lane["parse"] \
            or lane["resolve"] or lane["pack_batch"] != 1:
        raise AssertionError(f"one-shard manifest case launches {lane}")
    # the card against the plain route: three shards, the last one short
    tiny = corpus[3 * S: 3 * S + 2 * 2 * pipeline.BLOCK + 12345]
    on_card = compress_with_manifest(tiny, blocks_per_segment=2, device="cuda")
    plain = compress_with_manifest(tiny, blocks_per_segment=2, device="cpu")
    if on_card[0] != plain[0] or on_card[1].to_dict() != plain[1].to_dict() \
            or len(plain[1].comp_sizes) != 3:
        raise AssertionError("manifest: card and plain route differ")
    print(f"one-shard lane case (launches {lane}) and card-vs-plain check passed",
          flush=True)

    # ---- timing -------------------------------------------------------------
    def wall_s(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        return time.time() - t0, out

    mb = len(corpus) / 1e6
    man_s, out = wall_s(lambda: compress_with_manifest(corpus, blocks_per_segment=nb))
    if out[0] != stream:
        raise AssertionError("second manifest encode differs from the first")
    loop_s, _ = wall_s(lambda: comp.compress(corpus))
    dec_s, out = wall_s(lambda: decompress_with_manifest(stream, manifest))
    if out != corpus:
        raise AssertionError("second manifest decode differs from the corpus")
    del out
    print(f"manifest encode: {man_s:.3f} s = {mb / man_s:.2f} MB/s "
          f"(compress_with_manifest, batched); {loop_s:.3f} s = {mb / loop_s:.2f} "
          f"MB/s (CUDACompressor, per-segment loop); manifest decode: {dec_s:.3f} s "
          f"= {mb / dec_s:.2f} MB/s, all for {len(corpus)} bytes", flush=True)
    profile_main_path("manifest encode (batched)",
                      lambda: compress_with_manifest(corpus, blocks_per_segment=nb))
    profile_main_path("encode loop, same corpus", lambda: comp.compress(corpus),
                      warm=lambda: comp.compress(corpus[:2 * S]))

    batch_ms = cuda_ms(lambda: pack.pack_units_dense_batch(vals, wids, n_words), 20)
    rows_ms = cuda_ms(lambda: [pack.pack_units_dense(vals[b], wids[b], n_words)
                               for b in range(B)], 20)
    plain_ms = cuda_ms(lambda: pack.pack_units_batch_ref(vals, wids, n_words), 5)
    # the C entry's two kernels one by one, on the wrapper's buffers, and
    # a memset of the same words beside the zeroing that pass 1 does
    bufs = pack._batch_buffers(B, NU, n_words, dev)
    parts = [cuda_ms(lambda: pack._launch_batch(vals, wids, n_words, bufs, passes), 20)
             for passes in (pack.ALL_PASSES, 1, 2)]
    if max_abs_err(bufs[:2], pack.pack_units_dense_batch(vals, wids, n_words)):
        raise AssertionError("pack_batch kernels run one by one differ from one call")
    zero_ms = cuda_ms(lambda: bufs[0].zero_(), 20)
    # bytes: values and widths in, words and the totals out, each once;
    # the tile sums are made and read inside the function and are not
    # counted (8 B a tile), nor the zeroed words written twice
    nbytes = B * (NU * 8 + n_words * 4 + 4)
    print(f"pack_batch {batch_ms:.4f} ms for {B} x {NU} units in one call; "
          f"{B} launches of pack on the same rows {rows_ms:.4f} ms; twin "
          f"{plain_ms:.4f} ms; pack_batch parts: both kernels {parts[0]:.4f} ms, tile "
          f"sums and zeroing the words {parts[1]:.4f} ms, scan and place {parts[2]:.4f} "
          f"ms; a memset of the same words {zero_ms:.4f} ms; bound bytes {nbytes}",
          flush=True)
    return [kernel_entry("pack_batch", "moonbit_flate_tpu_torch/csrc/pack.cu",
                         "moonbit_flate_tpu/ops/pack.py:199",
                         launches["pack_batch"], err, batch_ms, plain_ms, nbytes,
                         12 * B * NU)]


GLOO_WORLD = 2              # ranks of the gloo world that share the one card
WORLD_TIMEOUT_S = 300


def _world_rank(backend, rank, world, store, out_path):
    """One rank of a spawned world: the sharded compress of the 16 MiB
    corpus, its stream written to out_path (an error's traceback in its
    place), then a second call after a barrier, its seconds written to
    out_path + ".s".  Gloo ranks share the current card; an NCCL rank
    takes card ``rank`` through ``LOCAL_RANK``, as a launcher would set
    it, and checks that make_mesh made that card current."""
    import datetime
    import os
    import traceback

    import torch.distributed as dist

    from moonbit_flate_tpu_torch import ShardedCompressor, make_mesh

    try:
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
        try:
            mesh = make_mesh(device="cuda" if backend == "gloo" else None)
            if backend == "nccl" and (mesh.device.index, torch.cuda.current_device()) \
                    != (rank, rank):
                raise AssertionError(f"rank {rank} runs on {mesh.device}, current "
                                     f"card {torch.cuda.current_device()}")
            sc = ShardedCompressor(mesh, blocks_per_segment=16)
            out = sc.compress(make_corpus())
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.time()
            if sc.compress(make_corpus()) != out:
                raise AssertionError("a second compress differs from the first")
            torch.cuda.synchronize()
            with open(out_path + ".s", "w") as f:
                f.write(repr(time.time() - t0))
        finally:
            dist.destroy_process_group()
    except Exception:
        out = ("error: " + traceback.format_exc()).encode()
    with open(out_path, "wb") as f:
        f.write(out)


def spawn_world(tmp, backend, world):
    """Spawn a world of ``world`` ranks over ``backend``; every rank's
    stream and the slowest rank's seconds for its timed call.  Every rank
    is stopped, at the latest after WORLD_TIMEOUT_S."""
    import multiprocessing
    import os

    ctx = multiprocessing.get_context("spawn")
    paths = [os.path.join(tmp, f"{backend}_rank{r}.bin") for r in range(world)]
    procs = [ctx.Process(target=_world_rank,
                         args=(backend, r, world,
                               os.path.join(tmp, f"{backend}_store"), paths[r]))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.time() + WORLD_TIMEOUT_S + 60
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
        if any(p.is_alive() for p in procs):
            raise AssertionError(f"the {backend} world timed out")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    outs = []
    for p, path in zip(procs, paths):
        if not os.path.exists(path):
            raise AssertionError(f"a {backend} rank exited with code {p.exitcode} "
                                 f"and no result")
        with open(path, "rb") as f:
            outs.append(f.read())
        if outs[-1].startswith(b"error: "):
            raise AssertionError(f"a {backend} rank failed:\n{outs[-1].decode()}")
    secs = []
    for path in paths:
        with open(path + ".s") as f:
            secs.append(float(f.read()))
    return outs, max(secs)


def sharded_phase(dev):
    import datetime
    import tempfile

    import torch.distributed as dist

    from moonbit_flate_tpu_torch import (CUDACompressor, ShardedCompressor, compress,
                                         compress_with_manifest, decompress,
                                         make_mesh)
    from moonbit_flate_tpu_torch.ops import pack, pipeline, walk

    nb = 16
    corpus = make_corpus()
    segs = -(-len(corpus) // (nb * pipeline.BLOCK))
    mb = len(corpus) / 1e6
    one = CUDACompressor(blocks_per_segment=nb).compress(corpus)
    if zlib.decompress(one, wbits=-15) != corpus:
        raise AssertionError("stock zlib does not read CUDACompressor's stream")

    def sharded_main_path(label, sc):
        """One compress of the corpus with the walk and pack counts from 0,
        checked, then one timed call; (stream, launches, first s, timed s)."""
        walk.launches = 0
        pack.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        out = sc.compress(corpus)
        first_s = time.time() - t0
        launches = {"walk": walk.launches, "pack": pack.launches}
        if not all(launches.values()):
            raise AssertionError(f"{label}: launches {launches}")
        if zlib.decompress(out, wbits=-15) != corpus:
            raise AssertionError(f"{label}: stock zlib does not read the stream")
        if out != one:
            raise AssertionError(f"{label}: the stream differs from CUDACompressor's")
        torch.cuda.synchronize()
        t0 = time.time()
        again = sc.compress(corpus)
        torch.cuda.synchronize()
        timed_s = time.time() - t0
        if again != out:
            raise AssertionError(f"{label}: a second compress differs from the first")
        return out, launches, first_s, timed_s

    def time_loop():
        t0 = time.time()
        CUDACompressor(blocks_per_segment=nb).compress(corpus)
        torch.cuda.synchronize()
        return time.time() - t0

    # ---- main path 1: ShardedCompressor() from one process, no group ------
    if dist.is_initialized():
        raise AssertionError("a process group is already initialised")
    sc = ShardedCompressor(blocks_per_segment=nb)
    out, launches, first_s, local_s = sharded_main_path("local mesh", sc)
    four = ShardedCompressor(make_mesh(["cuda:0"] * 4), blocks_per_segment=nb)
    t0 = time.time()
    if four.compress(corpus) != out:
        raise AssertionError("the local mesh of 4 shards a wave on one card differs")
    torch.cuda.synchronize()
    four_s = time.time() - t0
    loop_s = time_loop()
    print(f"sharded main path, local mesh ShardedCompressor() (no process group, "
          f"{len(sc.mesh.devices)} card(s), {sc.mesh.device}): {len(corpus)} -> "
          f"{len(out)} bytes in {segs} waves, zlib reads it, equal to CUDACompressor's; "
          f"launches {launches} (walk {launches['walk'] / segs:.1f} and pack "
          f"{launches['pack'] / segs:.1f} a wave); first call {first_s:.3f} s; "
          f"{local_s:.3f} s = {mb / local_s:.2f} MB/s; 4 shards a wave on cuda:0 "
          f"(make_mesh(['cuda:0'] * 4), {-(-segs // 4)} waves) the same bytes in "
          f"{four_s:.3f} s = {mb / four_s:.2f} MB/s; CUDACompressor {loop_s:.3f} s = "
          f"{mb / loop_s:.2f} MB/s, same corpus", flush=True)
    profile_main_path("sharded encode (local mesh)", lambda: sc.compress(corpus),
                      warm=lambda: sc.compress(corpus[:2 * nb * pipeline.BLOCK]))

    with tempfile.TemporaryDirectory() as tmp:
        # ---- main path 2: an NCCL world of 1 -----------------------------------
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
        try:
            mesh = make_mesh()
            sc = ShardedCompressor(mesh, blocks_per_segment=nb)
            out, launches, first_s, sharded_s = sharded_main_path("NCCL world", sc)
            loop_s = time_loop()
            print(f"sharded main path ({mesh.backend} world of {mesh.size}, {mesh.device}): "
                  f"{len(corpus)} -> {len(out)} bytes in {segs} waves, zlib reads it, "
                  f"equal to CUDACompressor's; launches {launches} "
                  f"(walk {launches['walk'] / segs:.1f} and pack "
                  f"{launches['pack'] / segs:.1f} a wave); first call {first_s:.3f} s; "
                  f"{sharded_s:.3f} s = {mb / sharded_s:.2f} MB/s (world 1), "
                  f"CUDACompressor {loop_s:.3f} s = {mb / loop_s:.2f} MB/s, same corpus",
                  flush=True)
            profile_main_path("sharded encode (world 1)", lambda: sc.compress(corpus),
                              warm=lambda: sc.compress(corpus[:2 * nb * pipeline.BLOCK]))

            # the card against the plain route, nb = 2: three shards, one short
            tiny = corpus[3 << 20: (3 << 20) + 2 * 2 * pipeline.BLOCK + 12345]
            if ShardedCompressor(mesh, blocks_per_segment=2).compress(tiny) != \
                    CUDACompressor(blocks_per_segment=2, device="cpu").compress(tiny):
                raise AssertionError("sharded: card and plain route differ at nb = 2")
            # halo and a preset dictionary
            zdict = corpus[:32768]
            part = corpus[5 << 20: (5 << 20) + 3 * nb * pipeline.BLOCK]
            got = ShardedCompressor(mesh, nb, halo=True).compress(part, dictionary=zdict)
            dec = zlib.decompressobj(wbits=-15, zdict=zdict)
            if dec.decompress(got) + dec.flush() != part or got != CUDACompressor(
                    nb, halo=True).compress(part, dictionary=zdict):
                raise AssertionError("sharded halo + dictionary case fails")
            # word_cap: a tight cap on incompressible bytes takes the retry
            noise = np.random.default_rng(3).integers(
                0, 256, 2 * nb * pipeline.BLOCK, np.uint8).tobytes()
            capped = ShardedCompressor(mesh, nb, word_cap=4096)
            full_step, retries = capped._step_full, []
            capped._step_full = lambda *a: retries.append(1) or full_step(*a)
            got = capped.compress(noise)
            if not retries or got != ShardedCompressor(mesh, nb).compress(noise):
                raise AssertionError(f"word_cap retry: {len(retries)} retries, "
                                     f"bytes differ from the full cap's")
            # the manifest through the mesh against the one-card batched form
            m_stream, m_man = compress_with_manifest(corpus, mesh, nb)
            b_stream, b_man = compress_with_manifest(corpus, blocks_per_segment=nb)
            if (m_stream, m_man.to_dict()) != (b_stream, b_man.to_dict()) \
                    or m_stream != out:
                raise AssertionError("manifest with a mesh differs from mesh=None")
            print(f"sharded: card vs plain at nb = 2, halo + dictionary, word_cap "
                  f"retry ({len(retries)} waves), manifest with a mesh passed",
                  flush=True)
        finally:
            dist.destroy_process_group()

        # ---- a gloo world of 2 ranks sharing the card: not a multi-GPU run --
        t0 = time.time()
        outs, world_s = spawn_world(tmp, "gloo", GLOO_WORLD)
        if any(o != out for o in outs):
            raise AssertionError("the gloo world's streams differ from the world of 1")
        print(f"gloo world of {GLOO_WORLD} ranks on one card: every rank's stream "
              f"equals the world of 1 ({time.time() - t0:.1f} s with start-up; "
              f"a timed call {world_s:.3f} s = {mb / world_s:.2f} MB/s)", flush=True)

    # ---- the one-shot backends ---------------------------------------------
    small = corpus[(7 << 20): (7 << 20) + (256 << 10)]
    sizes, streams = {}, {}
    for backend in ("cuda", "native", "python", "auto"):
        c = compress(small, backend=backend)
        if decompress(c, backend=backend) != small or zlib.decompress(c, -15) != small:
            raise AssertionError(f"one-shot backend {backend!r} does not round-trip")
        sizes[backend], streams[backend] = len(c), c
    if streams["auto"] != streams["native"] or compress(small) != streams["native"]:
        raise AssertionError("the default one-shot backend differs from 'native'")
    print(f"one-shot compress / decompress round-trip for {len(small)} bytes: "
          f"{sizes}; the default ('auto') equals 'native'", flush=True)
    return []


# the chip-independent fields of the JAX bench's line on the full corpus,
# held against BENCH_r05.json; the port's bytes equal the JAX package's
BENCH_EXACT = ("compression_ratio", "corpus_mb", "tokens", "blocks", "decode_shards")


def bench_phase(dev):
    """The port's bench (``python3 -m moonbit_flate_tpu_torch.bench``) in
    this process, with every kernel's launch count from 0: its JSON line
    must hold no error, a positive value and BENCH_r05.json's values of
    BENCH_EXACT, and kernels a-f must have launched, g (the batched
    pack) never."""
    import contextlib
    import io
    import os

    from moonbit_flate_tpu_torch import bench
    from moonbit_flate_tpu_torch.ops import lanes_inflate as LI
    from moonbit_flate_tpu_torch.ops import lanes_resolve as LR
    from moonbit_flate_tpu_torch.ops import pack, walk
    from moonbit_flate_tpu_torch.ops import parse as P
    from moonbit_flate_tpu_torch.ops import resolve as R

    mods = {"walk": walk, "pack": pack, "lanes_parse": LI, "lanes_resolve": LR,
            "parse": P, "resolve": R}
    os.environ.pop("MF_BENCH_SMOKE", None)
    for m in mods.values():
        m.launches = 0
    pack.launches_batch = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main()
    launches = dict({k: m.launches for k, m in mods.items()},
                    pack_batch=pack.launches_batch)
    text = out.getvalue()
    print(text, end="", flush=True)
    line = json.loads(text.strip().splitlines()[-1])
    extra = line.get("extra", {})
    print(f"bench launches {launches}", flush=True)
    if rc != 0 or not line["value"] > 0 \
            or any("error" in k for k in list(line) + list(extra)):
        raise AssertionError(f"the bench failed (exit {rc})")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BENCH_r05.json")) as f:
        ref = json.load(f)["parsed"]["extra"]
    for k in BENCH_EXACT:
        if extra.get(k) != ref[k]:
            raise AssertionError(f"bench {k} is {extra.get(k)}, BENCH_r05.json's {ref[k]}")
    if launches["pack_batch"] or not all(v for k, v in launches.items()
                                         if k != "pack_batch"):
        raise AssertionError(f"bench launches {launches}: kernels a-f must launch, "
                             f"g never")
    return []


def multi_card_phase(cards):
    """A local mesh over ``cards`` cards from this process, then an NCCL
    world of ``cards`` ranks, a card each, both against
    ``CUDACompressor`` on card 0; then every kernel on the last card
    while card 0 stays current."""
    import tempfile

    from moonbit_flate_tpu_torch import (CUDACompressor, ShardedCompressor,
                                         compress_with_manifest, decompress_shards,
                                         decompress_with_manifest, make_mesh)
    from moonbit_flate_tpu_torch.ops import lanes_inflate as LI
    from moonbit_flate_tpu_torch.ops import lanes_resolve as LR
    from moonbit_flate_tpu_torch.ops import pack, walk
    from moonbit_flate_tpu_torch.ops import parse as P
    from moonbit_flate_tpu_torch.ops import resolve as R

    if torch.cuda.device_count() < cards:
        raise AssertionError(f"{cards} cards asked for, "
                             f"{torch.cuda.device_count()} present")
    corpus = make_corpus()
    ref = CUDACompressor(blocks_per_segment=16).compress(corpus)
    if zlib.decompress(ref, wbits=-15) != corpus:
        raise AssertionError("stock zlib does not read CUDACompressor's stream")
    t0 = time.time()
    CUDACompressor(blocks_per_segment=16).compress(corpus)
    torch.cuda.synchronize()
    loop_s = time.time() - t0

    # a local mesh over the cards: one process, one shard after another
    sc = ShardedCompressor(make_mesh([f"cuda:{i}" for i in range(cards)]), 16)
    walk.launches = 0
    pack.launches = 0
    if sc.compress(corpus) != ref:
        raise AssertionError("the local mesh's stream differs from CUDACompressor's")
    launches = {"walk": walk.launches, "pack": pack.launches}
    if not all(launches.values()):
        raise AssertionError(f"local mesh over {cards} cards: launches {launches}")
    torch.cuda.synchronize()
    t0 = time.time()
    sc.compress(corpus)
    for i in range(cards):
        torch.cuda.synchronize(i)
    local_s = time.time() - t0
    mb = len(corpus) / 1e6
    print(f"local mesh over {cards} cards from one process: equal to "
          f"CUDACompressor's on card 0, launches {launches}; {local_s:.3f} s = "
          f"{mb / local_s:.2f} MB/s beside CUDACompressor on card 0 {loop_s:.3f} s "
          f"= {mb / loop_s:.2f} MB/s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        outs, world_s = spawn_world(tmp, "nccl", cards)
        if any(o != ref for o in outs):
            raise AssertionError("an NCCL rank's stream differs from CUDACompressor's")
    print(f"nccl world of {cards} ranks, a card each: every rank's stream equals "
          f"CUDACompressor's on card 0 ({time.time() - t0:.1f} s with start-up; "
          f"a timed call {world_s:.3f} s = {mb / world_s:.2f} MB/s)", flush=True)

    # every kernel on a card that is not the current one
    dev = torch.device("cuda", cards - 1)
    mods = {"walk": walk, "pack": pack, "pack_batch": pack, "lanes_parse": LI,
            "lanes_resolve": LR, "parse": P, "resolve": R}
    for m in mods.values():
        m.launches = 0
    pack.launches_batch = 0
    part = corpus[: 4 * SEG_BYTES]
    stream, man = compress_with_manifest(part, blocks_per_segment=16, device=dev)
    one = CUDACompressor(blocks_per_segment=16, device=dev).compress(part)
    if stream != one or decompress_with_manifest(stream, man, device=dev) != part:
        raise AssertionError(f"the manifest pair on {dev} fails")
    shards = [corpus[i * LI.SEGB:(i + 1) * LI.SEGB] for i in range(LI.NSTR)]
    zstreams = [zlib.compress(s, 1)[2:-4] for s in shards]
    if decompress_shards(zstreams, [len(s) for s in shards], device=dev) != shards:
        raise AssertionError(f"the shard decode on {dev} fails")
    counts = {name: (pack.launches_batch if name == "pack_batch" else m.launches)
              for name, m in mods.items()}
    if not all(counts.values()) or torch.cuda.current_device() != 0:
        raise AssertionError(f"on {dev}: launches {counts}, current card "
                             f"{torch.cuda.current_device()}")
    print(f"every kernel on {dev} with cuda:0 current: launches {counts}", flush=True)


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=0,
                    help="run only the checks across N cards (needs N cards)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from moonbit_flate_tpu_torch.kernels import build

    dev = torch.device("cuda")
    t0 = time.time()
    build.build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)

    if args.cards:
        t0 = time.time()
        multi_card_phase(args.cards)
        print(f"multi_card_phase: {time.time() - t0:.1f} s", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    kernels = []
    for phase in (encode_phase, decode_phase, scalar_decode_phase, manifest_phase,
                  sharded_phase, bench_phase, encode_stages_phase):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        kernels += phase(dev)
        print(f"{phase.__name__}: {time.time() - t0:.1f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
