"""Port keys, extraction and counting against the JAX package (exact).

Inputs come from numpy with a fixed seed and go to both packages; keys
compare as (N, W) uint32 words after the port's keys_to_words.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from platanus_b_tpu.io.reads import ReadBatch
from platanus_b_tpu.ops import count as jcnt
from platanus_b_tpu.ops import kmer as jkmer
from platanus_b_tpu.ops import multiword as jmw
from platanus_b_tpu.ops.search import contains as jcontains
from platanus_b_tpu.ops.search import lookup as jlookup
from platanus_b_tpu.ops.search import lookup_range_jit as jlookup_range
from platanus_b_tpu_torch.models.assemble_core import stage_reads
from platanus_b_tpu_torch.ops import count as tcnt
from platanus_b_tpu_torch.ops import keys as tkeys
from platanus_b_tpu_torch.ops import kmer as tkmer
from platanus_b_tpu_torch.ops.search import contains as tcontains
from platanus_b_tpu_torch.ops.search import lookup as tlookup
from platanus_b_tpu_torch.ops.search import lookup_range as tlookup_range

KS = [17, 25, 31, 32, 33, 48, 63, 64, 65, 96]


def _reads(seed, R=24, L=130, n_rate=0.01):
    """Codes (R, L) with ragged lengths (padding 4) and scattered Ns."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    lens = rng.integers(L // 2, L + 1, size=R).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    with_n = codes.copy()
    with_n[rng.random((R, L)) < n_rate] = 4
    return codes, with_n, lens


def _words(lanes, k):
    return tkeys.keys_to_words(lanes.reshape(-1, lanes.shape[-1]), k)


def _jwords(keys):
    keys = np.asarray(keys)
    return keys.reshape(-1, keys.shape[-1])


@pytest.mark.parametrize("k", KS)
def test_keys_roundtrip_and_order(k):
    rng = np.random.default_rng(k)
    W = jmw.num_words(k)
    words = rng.integers(0, 1 << 32, size=(300, W), dtype=np.uint64)
    words = words.astype(np.uint32)
    words[:, 0] &= np.uint32(jmw.top_word_mask(k))
    words[::7, 0] = np.uint32(jmw.top_word_mask(k))    # top bit set
    words[5] = 0xFFFFFFFF                              # SENTINEL
    words[11] = words[12]                              # a duplicate
    lanes = tkeys.keys_from_words(words)
    assert lanes.shape == (300, tkeys.num_lanes(k))
    assert (tkeys.keys_to_words(lanes, k) == words).all()
    assert (lanes[5] == tkeys.SENTINEL_LANE).all()
    order = np.lexsort(words.T[::-1])
    got = tkeys.lexsort(lanes).numpy()
    assert (words[got] == words[order]).all()
    assert (tkeys.keys_to_words(lanes[got], k)[-1] == 0xFFFFFFFF).all()
    # revcomp / canonical on words agree with the JAX helpers
    live = words[words[:, 0] != 0xFFFFFFFF]
    rc = tkeys.revcomp(tkeys.keys_from_words(live), k)
    assert (tkeys.keys_to_words(rc, k) == np.asarray(jmw.revcomp(jnp.asarray(live), k))).all()
    tc, tfw = tkeys.canonical(tkeys.keys_from_words(live), k)
    jc, jfw = jmw.canonical(jnp.asarray(live), k)
    assert (tkeys.keys_to_words(tc, k) == np.asarray(jc)).all()
    assert (tfw.numpy() == np.asarray(jfw)).all()
    # host packers
    codes = rng.integers(0, 4, size=k).astype(np.uint8)
    assert (tkeys.pack_kmer_np(codes, k) == jmw.pack_kmer_np(codes, k)).all()
    assert (tkeys.unpack_kmer_np(tkeys.pack_kmer_np(codes, k), k) == codes).all()


@pytest.mark.parametrize("k", KS)
def test_extract_matches_jax(k):
    codes, with_n, lens = _reads(k)
    jk, jv = jkmer.extract_canonical_kmers(jnp.asarray(with_n), k)
    tk, tv = tkmer.extract_canonical_kmers(torch.from_numpy(with_n), k)
    assert (_words(tk, k) == _jwords(jk)).all()
    assert (tv.numpy() == np.asarray(jv)).all()
    jf, _ = jkmer.extract_forward_kmers(jnp.asarray(with_n), k)
    tf, _ = tkmer.extract_forward_kmers(torch.from_numpy(with_n), k)
    assert (_words(tf, k) == _jwords(jf)).all()
    # the kernel wrapper's packed inputs (plain path on the CPU): N mask ...
    R, L = with_n.shape
    L32 = -(-L // 32) * 32
    pad = np.full((R, L32), 4, np.uint8)
    pad[:, :L] = with_n
    words, nmask = tkmer.pack_codes(torch.from_numpy(pad))
    jw, jn = ReadBatch(with_n, lens).packed()
    assert (words.numpy().view(np.uint32) == jw[:R]).all()
    assert (nmask.numpy().view(np.uint32) == jn[:R]).all()
    pk, pn = tkmer.extract_kmers_packed(words, k, nmask=nmask, max_len=L)
    assert (_words(pk, k) == _jwords(jk)).all()
    assert int(pn) == int(np.asarray(jv).sum())
    # ... and read lengths (N-free reads)
    pad[:, :L] = codes
    words, _ = tkmer.pack_codes(torch.from_numpy(pad))
    lk, ln = tkmer.extract_kmers_packed(words, k, lengths=torch.from_numpy(lens),
                                        max_len=L)
    jk2, jv2 = jkmer.extract_canonical_kmers(jnp.asarray(codes), k)
    assert (_words(lk, k) == _jwords(jk2)).all()
    assert int(ln) == int(np.asarray(jv2).sum())
    # kmer_to_codes inverts extraction
    first = tk[0, 0][None]
    assert (tkmer.kmer_to_codes(first, k).numpy()
            == np.asarray(jkmer.kmer_to_codes(jnp.asarray(_jwords(jk)[:1]), k))).all()


@pytest.mark.parametrize("k", KS)
def test_count_matches_jax(k):
    _codes, with_n, _lens = _reads(100 + k, R=40)
    # few distinct sequences so that counts exceed 1
    with_n[20:] = with_n[:20]
    jk, jc, jn = jcnt.count_batch(jnp.asarray(with_n), k)
    jk, jc = jcnt.compact_host(jk, jc, jn)
    tk, tc, tn = tcnt.count_codes(torch.from_numpy(with_n), k)
    assert tn == int(jn)
    assert (tkeys.keys_to_words(tk, k) == jk).all()
    assert (tc.numpy() == jc).all()
    jh = np.asarray(jcnt.occurrence_histogram(jnp.asarray(jc)))
    th = tcnt.histogram_host(tcnt.occurrence_histogram(tc))
    assert th.dtype == jh.dtype and (th == jh).all()
    # lookup of every table key plus absent queries
    q = np.concatenate([jk[::3], jk[1::5] ^ np.uint32(1)])
    jl = np.asarray(jlookup(jnp.asarray(jk), jnp.asarray(q), len(jk)))
    tl = tlookup(tk, tkeys.keys_from_words(q)).numpy()
    assert (tl == jl).all()
    assert (tcontains(tk, tkeys.keys_from_words(q)).numpy()
            == np.asarray(jcontains(jnp.asarray(jk), jnp.asarray(q), len(jk)))).all()
    # [lo, hi) runs of a table with duplicate rows, searched as the JAX
    # package searches a table of its own length (no padding row), table
    # end included; the queries hold the last row, keys past it and the
    # all-ones SENTINEL key
    dup = np.repeat(jk, 1 + np.arange(len(jk)) % 3, axis=0)   # still sorted
    q = np.concatenate([q, dup[-1:], np.full((1, q.shape[1]), 0xFFFFFFFF,
                                             np.uint32)])
    tlo, thi = tlookup_range(tkeys.keys_from_words(dup), tkeys.keys_from_words(q))
    jlo, jhi = jlookup_range(jnp.asarray(dup), jnp.asarray(q), jnp.int32(len(dup)))
    assert (tlo.numpy() == np.asarray(jlo)).all()
    assert (thi.numpy() == np.asarray(jhi)).all()
    assert (thi.numpy() == len(dup) + 1).any()        # the end case occurs
    # the same table padded with SENTINEL rows to a power of two
    cap = 1 << len(dup).bit_length()
    pad = np.full((cap, dup.shape[1]), 0xFFFFFFFF, np.uint32)
    pad[: len(dup)] = dup
    tlo, thi = tlookup_range(tkeys.keys_from_words(pad), tkeys.keys_from_words(q),
                             len(dup))
    jlo, jhi = jlookup_range(jnp.asarray(pad), jnp.asarray(q), jnp.int32(len(dup)))
    assert (tlo.numpy() == np.asarray(jlo)).all()
    assert (thi.numpy() == np.asarray(jhi)).all()


def test_count_saturates_at_max_occurrence():
    k = 17
    reads = np.zeros((700, 117), np.uint8)           # 70,000 poly-A windows
    reads[0, :40] = np.random.default_rng(5).integers(0, 4, 40)
    jk, _jv = jkmer.extract_canonical_kmers(jnp.asarray(reads), k)
    lanes = tuple(_jwords(jk)[:, w] for w in range(jk.shape[-1]))
    ju, jc, jn = jcnt.count_lanes_fused(tuple(jnp.asarray(x) for x in lanes))
    jn = int(jn)
    tu, tc, tn = tcnt.count_codes(torch.from_numpy(reads), k)
    assert tn == jn
    assert int(tc.max()) == jcnt.MAX_OCCURRENCE == tcnt.MAX_OCCURRENCE
    assert (tc.numpy() == np.asarray(jc)[:jn]).all()
    ju = np.stack([np.asarray(x)[:jn] for x in ju], axis=-1)
    assert (tkeys.keys_to_words(tu, k) == ju).all()


# rows of the saturated case's last run past MAX_OCCURRENCE
_PAST_MAX = 1_000


def _count_table(case, W, rng):
    """(N, W) uint32 keys of one run-length case, SENTINEL rows included."""
    base = np.unique(rng.integers(1, 1 << 31, size=(40, W)).astype(np.uint32),
                     axis=0)
    sent = np.full((1, W), 0xFFFFFFFF, np.uint32)
    largest = np.full((1, W), 0xFFFFFFFE, np.uint32)   # sorts before SENTINEL
    if case == "one_row":
        return base[:1]
    if case == "prefix_then_sentinel":
        keys = base[rng.integers(0, len(base), size=300)]
        return np.concatenate([keys, np.repeat(sent, 37, axis=0)])
    if case == "single_row_runs_at_ends":
        keys = np.concatenate([np.zeros((1, W), np.uint32),
                               np.repeat(base[:6], 3, axis=0), largest])
        return keys[rng.permutation(len(keys))]
    # saturated_last_run: the last run of the valid prefix passes
    # MAX_OCCURRENCE
    keys = np.concatenate([base, base[:5],
                           np.repeat(largest, tcnt.MAX_OCCURRENCE + _PAST_MAX,
                                     axis=0),
                           np.repeat(sent, 9, axis=0)])
    return keys[rng.permutation(len(keys))]


@pytest.mark.parametrize("n_valid_given", [False, True])
@pytest.mark.parametrize("case", ["prefix_then_sentinel",
                                  "single_row_runs_at_ends", "one_row",
                                  "saturated_last_run"])
@pytest.mark.parametrize("k", [32, 48])
def test_count_lanes_fused_run_lengths_match_jax(k, case, n_valid_given):
    """Run lengths from the run ends' positions, at one int64 lane (k 32)
    and two (k 48), with n_valid given or taken from the SENTINEL rows,
    equal the JAX package's count, saturation included."""
    W = jmw.num_words(k)
    keys = _count_table(case, W, np.random.default_rng(k))
    ju, jc, jn = jcnt.count_lanes_fused(
        tuple(jnp.asarray(keys[:, w]) for w in range(W)))
    jn = int(jn)
    live = (keys != 0xFFFFFFFF).any(axis=1)
    valid = int(live.sum())
    n_valid = torch.tensor([valid]) if n_valid_given else None
    lanes = tkeys.keys_from_words(keys)
    assert lanes.shape[1] == (1 if k == 32 else 2)
    tu, tc, tn = tcnt.count_lanes_fused(lanes, n_valid)
    assert tn == jn == len(np.unique(keys[live], axis=0))
    assert tc.dtype == torch.int64
    assert (tkeys.keys_to_words(tu, k)
            == np.stack([np.asarray(x)[:jn] for x in ju], axis=-1)).all()
    assert (tc.numpy() == np.asarray(jc)[:jn]).all()
    saturated = case == "saturated_last_run"
    assert int(tc.sum()) == valid - (_PAST_MAX if saturated else 0)
    if saturated:
        assert int(tc[-1]) == tcnt.MAX_OCCURRENCE
    if case in ("single_row_runs_at_ends", "one_row"):
        assert int(tc[0]) == 1 and int(tc[-1]) == 1


@pytest.mark.parametrize("k", [25, 48])
def test_dedup_max_matches_jax(k):
    rng = np.random.default_rng(k)
    W = jmw.num_words(k)
    base = rng.integers(0, 1 << 30, size=(60, W)).astype(np.uint32)
    keys = base[rng.integers(0, 60, size=400)]
    keys[::9] = 0xFFFFFFFF
    vals = rng.integers(0, 50, size=400).astype(np.uint32)
    sk, sv = jcnt.sort_by_key(jnp.asarray(keys), jnp.asarray(vals))
    jk, jv, jn = jcnt.dedup_max(sk, sv)
    jn = int(jn)
    tk, tv, tn = tcnt.dedup_max(tkeys.keys_from_words(keys),
                                torch.from_numpy(vals.astype(np.int64)))
    assert tn == jn
    assert (tkeys.keys_to_words(tk, k) == np.asarray(jk)[:jn]).all()
    assert (tv.numpy() == np.asarray(jv)[:jn]).all()
    # dedup_sum on the same rows
    jk, jc, jn = jcnt.dedup_sum(sk, sv)
    tk, tc, tn = tcnt.sort_dedup_sum(tkeys.keys_from_words(keys),
                                     torch.from_numpy(vals.astype(np.int64)))
    assert tn == int(jn)
    assert (tc.numpy() == np.asarray(jc)[:tn]).all()


@pytest.mark.parametrize("k,n_parts", [(25, 4), (32, 2), (40, 8)])
def test_count_reads_partitioned_matches_jax(k, n_parts):
    codes, with_n, lens = _reads(7 * k, R=30)
    batch = ReadBatch(with_n, lens)
    jk, jc = jcnt.count_reads_partitioned([batch], k, n_parts)
    staged = stage_reads([batch], "cpu")
    assert staged.has_n
    tk, tc = tcnt.count_reads_partitioned(staged, k, n_parts)
    assert (tkeys.keys_to_words(tk, k) == jk).all()
    assert (tc.numpy() == jc).all()
    # the single-pass count gives the same table
    fk, fc, _fn = tcnt.count_lanes_fused(staged.kmers(k)[0].reshape(-1, tk.shape[1]))
    assert torch.equal(fk, tk) and torch.equal(fc, tc)
