"""Port parity: match finding, Huffman construction and codegen RLE of
moonbit_flate_tpu_torch against the JAX package (exact, integer-only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonbit_flate_tpu.ops import header as JH
from moonbit_flate_tpu.ops import huffman_jax as JHF
from moonbit_flate_tpu.ops import matcher as JM
from moonbit_flate_tpu_torch.ops import header as TH
from moonbit_flate_tpu_torch.ops import huffman_torch as THF
from moonbit_flate_tpu_torch.ops import matcher as TM

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's spinning CPU threads would contend with each other
torch.set_num_threads(1)

BLOCK = 65535
PAD = 320


def _payload(name, size):
    rng = np.random.default_rng(3)
    if name == "ramp":
        return (bytes(range(128)) * (size // 128 + 1))[:size]
    if name == "text":
        unit = b"compression window huffman block stream symbol match "
        return (unit * (size // len(unit) + 1))[:size]
    if name == "rle":
        return (b"aaaaabbbbb" * (size // 10 + 1))[:size]
    # mixed: random bytes with long- and short-range repeats
    mixed = bytearray(rng.integers(0, 256, size, np.uint8).tobytes())
    half = size // 2
    mixed[half:half + 20000] = mixed[half - 30000:half - 10000]
    mixed[1000:1600] = mixed[400:1000]
    return bytes(mixed)


def _staged(name, nb):
    payload = _payload(name, nb * BLOCK - 1000)
    buf = np.zeros(nb * BLOCK + PAD, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    return buf, len(payload)


@pytest.mark.parametrize("nb", [2, 4])   # flat sort at 2, windowed at 4
@pytest.mark.parametrize("name", ["ramp", "text", "rle", "mixed"])
def test_find_matches_matches_jax(name, nb):
    buf, n = _staged(name, nb)
    jm, jd = JM.find_matches(jnp.asarray(buf), jnp.int32(n))
    tm, td = TM.find_matches(torch.from_numpy(buf), n)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("ctx", [0, 1000])
def test_extend_commit_and_match_info_match_jax(ctx):
    nb = 2
    S = nb * BLOCK
    buf, n = _staged("mixed", nb)
    jm, jd = JM.find_matches(jnp.asarray(buf), jnp.int32(n))
    cap = np.minimum(BLOCK * (np.arange(S) // BLOCK + 1) - np.arange(S), 258)
    cap = cap.astype(np.int32)
    j_ext = np.asarray(JM.extend_matches_xla(jnp.asarray(buf), jm, jd,
                                             jnp.int32(n), jnp.asarray(cap)))
    t_ext = TM.extend_matches_xla(torch.from_numpy(buf), torch.from_numpy(np.array(jm)),
                                  torch.from_numpy(np.array(jd)), n,
                                  torch.from_numpy(cap)).numpy()
    assert np.array_equal(t_ext, j_ext)
    j_com = np.asarray(JM.greedy_commit_xla(jnp.asarray(j_ext), jnp.int32(n), ctx))
    j_ext = np.array(j_ext)
    t_com = TM.greedy_commit_xla(torch.from_numpy(j_ext), n, ctx).numpy()
    assert np.array_equal(t_com, j_com)
    S_pad = -(-S // 8192) * 8192
    j_mi, j_grp = JM.pack_match_info(jnp.asarray(j_ext), jd, jnp.int32(ctx), S_pad)
    t_mi, t_grp = TM.pack_match_info(torch.from_numpy(j_ext)[None],
                                     torch.from_numpy(np.array(jd))[None],
                                     torch.tensor([ctx], dtype=torch.int32), S_pad)
    assert np.array_equal(t_mi[0].numpy(), np.asarray(j_mi))
    assert np.array_equal(t_grp[0].numpy(), np.asarray(j_grp))


def _freq_cases():
    rng = np.random.default_rng(11)
    cases = []
    for A, scale in ((286, 65535), (286, 40), (30, 5000), (19, 300)):
        f = rng.integers(0, scale, (6, A)).astype(np.int32)
        f[rng.random((6, A)) < 0.4] = 0
        cases.append(f)
    # skewed (deep trees hit the length limit) and equal-weight ties
    f = (2 ** rng.integers(0, 16, (6, 286))).astype(np.int32)
    f = np.minimum(f, 60000 // 286)
    f[:, ::3] = 1
    cases.append(f)
    cases.append(np.full((6, 286), 7, np.int32))
    # degenerate: 0, 1 and 2 live symbols
    deg = np.zeros((6, 286), np.int32)
    deg[1, 17] = 5
    deg[2, 0] = 1
    deg[3, 3], deg[3, 200] = 9, 1
    deg[4, 256], deg[4, 285] = 1, 1
    deg[5, 5], deg[5, 6], deg[5, 7] = 1, 1, 1
    cases.append(deg)
    return cases


_jax_build_codes = jax.jit(JHF.build_codes, static_argnums=1)


@pytest.mark.parametrize("idx", range(7))
@pytest.mark.parametrize("max_bits", [15, 7])
def test_build_codes_matches_jax(idx, max_bits):
    freqs = _freq_cases()[idx]
    jc, jl = _jax_build_codes(jnp.asarray(freqs), max_bits)
    tc, tl = THF.build_codes(torch.from_numpy(freqs), max_bits)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tc.numpy(), np.asarray(jc))


def test_codegen_emissions_matches_jax():
    rng = np.random.default_rng(5)
    B = 12
    seq = rng.integers(0, 16, (B, TH.SEQ_LEN)).astype(np.int32)
    # long runs of zeros and of repeated lengths (16/17/18 chunks)
    seq[0, :200] = 0
    seq[1, 10:150] = 8
    seq[2, :] = 0
    seq[3, 5:16] = 0
    seq[4, 40:47] = 3
    for b in range(5, B):
        for _ in range(6):
            s = rng.integers(0, 280)
            seq[b, s:s + rng.integers(1, 160)] = rng.integers(0, 16)
    valid = np.array([316, 300, 0, 30, 257, 1, 2, 316, 286, 290, 310, 258], np.int32)
    want = jax.jit(jax.vmap(JH.codegen_emissions))(jnp.asarray(seq), jnp.asarray(valid))
    got = TH.codegen_emissions(torch.from_numpy(seq), torch.from_numpy(valid))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
