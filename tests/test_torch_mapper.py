"""The port's mapper, pair library and library loading against the JAX
package (exact).

Each case builds both ContigIndexes from the same numpy contigs and maps
the same numpy reads; every output array is compared whole, unmapped rows
included. Reads come from tests/simdata.py genomes of a few kbp.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import simdata
from platanus_b_tpu.commands import libparse as jlibparse
from platanus_b_tpu.io.fasta import seq_to_codes
from platanus_b_tpu.io.reads import pack_reads
from platanus_b_tpu.models import mapper as jm
from platanus_b_tpu.models import seqlib as jseqlib
from platanus_b_tpu_torch import interop
from platanus_b_tpu_torch.commands import libparse as tlibparse
from platanus_b_tpu_torch.models import mapper as tm
from platanus_b_tpu_torch.models import seqlib as tseqlib
from platanus_b_tpu_torch.ops.keys import keys_to_words
from platanus_b_tpu_torch.ops.search import lookup_range
from platanus_b_tpu_torch.simulate import ungap_edge_inputs


def _mutate(rng, read, n):
    r = list(read)
    for p in rng.integers(0, len(r), size=n):
        r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4] if r[p] != "N" else "A"
    return "".join(r)


def _case(name):
    """(contig strings, read strings) of one mapping case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "exact_two_contigs":        # test_mapper.py:17
        g = simdata.random_genome(rng, 4000)
        contigs = [g[:2500], g[2500:]]
        reads = []
        for _ in range(60):
            c = contigs[int(rng.integers(0, 2))]
            s = int(rng.integers(0, len(c) - 100))
            r = c[s:s + 100]
            reads.append(r if rng.random() < 0.5 else simdata.rc(r))
        return contigs, reads
    if name == "repeat":                   # test_mapper.py:44
        unit = simdata.random_genome(rng, 200)
        g = unit + simdata.random_genome(rng, 500) + unit
        return [g], [unit[50:150], g[300:396], unit[:100]]
    if name == "mismatch":                 # test_mapper.py:56
        g = simdata.random_genome(rng, 3000)
        r = list(g[1000:1096])
        r[40] = "A" if r[40] != "A" else "C"
        return [g], ["".join(r), _mutate(rng, g[700:800], 2),
                     _mutate(rng, g[700:800], 8)]
    # reads with errors and Ns across several contigs, contig ends, short
    # reads, a contig with Ns, and a contig repeated (ambiguous hits)
    g = simdata.random_genome(rng, 7000)
    contigs = [g[:1800], g[1800:1950], g[1950:3500] + "N" * 20 + g[3520:5000],
               g[5000:], g[2000:2600]]
    reads = simdata.shotgun_reads(rng, g, 100, 6.0, error_rate=0.01)
    reads += [r[: int(rng.integers(10, 100))] for r in reads[:20]]
    reads += [_mutate(rng, r, 6) for r in reads[:20]]
    reads += [r[:30] + "N" + r[31:] for r in reads[20:30]]
    reads += [g[1750:1850], simdata.rc(g[1900:2000]), "T" * 100, "A" * 100]
    return contigs, reads


CASES = ["exact_two_contigs", "repeat", "mismatch", "multi_contig_errors"]


def _indexes(contigs, key_length=32):
    codes = [seq_to_codes(c) for c in contigs]
    return (jm.ContigIndex(codes, key_length=key_length),
            tm.ContigIndex(codes, key_length=key_length))


def _assert_index_equal(ji, ti):
    assert ti.table_len == ji.table_len
    assert ti.key_table.shape[0] == ji.key_table.shape[0]
    assert (keys_to_words(ti.key_table, ti.key_length) == ji.key_table).all()
    assert (ti.key_pos.numpy() == ji.key_pos).all()
    assert ti.pool.shape == ji.pool.shape and (ti.pool == ji.pool).all()
    assert (ti.starts == ji.starts).all() and (ti.lengths == ji.lengths).all()


def _jax_ungap(ji, batch, min_identity, seed_length=32, H=jm.MAX_CANDIDATES):
    L = batch.codes.shape[1]
    S = max(-(-L // seed_length) + 1, 1)
    out = jm._map_ungap_kernel(*ji.device_arrays(), jnp.asarray(batch.codes),
                               jnp.asarray(batch.lengths),
                               jnp.float32(min_identity), ji.key_length,
                               seed_length, S, H)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("key_length", [32, 25])
@pytest.mark.parametrize("name", ["exact_two_contigs", "multi_contig_errors"])
def test_contig_index_matches_jax(name, key_length):
    contigs, _reads = _case(name)
    ji, ti = _indexes(contigs, key_length)
    _assert_index_equal(ji, ti)


@pytest.mark.parametrize("name", CASES)
def test_map_reads_matches_jax(name):
    contigs, reads = _case(name)
    ji, ti = _indexes(contigs)
    b = pack_reads(reads)
    for seeds in ((32,), (32, 24)):
        jid, joff = jm.map_reads(ji, b.codes, b.lengths, seeds)
        tid, toff = tm.map_reads(ti, b.codes, b.lengths, seeds)
        assert (tid == jid).all() and (toff == joff).all()
    if name == "exact_two_contigs":
        assert (tid != 0).all()
    if name == "repeat":
        assert tid[0] == 0


@pytest.mark.parametrize("name", CASES)
def test_map_reads_ungap_matches_jax(name):
    contigs, reads = _case(name)
    ji, ti = _indexes(contigs)
    b = pack_reads(reads)
    for min_identity in (0.0, 0.97):
        want = _jax_ungap(ji, b, min_identity)
        got = tm.map_reads_ungap_full(ti, b.codes, b.lengths, min_identity)
        for w, g in zip(want, got):
            assert g.numpy().dtype == w.dtype
            assert (g.numpy() == w).all()
        # the numpy front end returns the first three
        ids, offs, ident = tm.map_reads_ungap(ti, b.codes, b.lengths,
                                              min_identity)
        jids, joffs, jident = jm.map_reads_ungap(ji, b.codes, b.lengths,
                                                 min_identity)
        assert (ids == jids).all() and (offs == joffs).all()
        assert (ident == jident).all()


@pytest.mark.parametrize("end_case", ["unpadded_table", "poly_t_query"])
def test_table_end_cases(end_case):
    """The JAX search's two end cases reach the mapper: a table of exactly
    a power of two of rows (no SENTINEL padding) queried at its last row,
    and the poly-T 32-mer, whose forward key is the all-ones SENTINEL."""
    rng = np.random.default_rng(5)
    if end_case == "unpadded_table":
        g = simdata.random_genome(rng, 95)             # 64 windows at k 32
        contigs = [g]
        reads = [g[i: i + 40] for i in range(0, 55)]
        reads += [simdata.rc(r) for r in reads]
    else:
        g = simdata.random_genome(rng, 300)
        contigs = [g[:100] + "T" * 40 + g[100:], g[150:]]
        reads = ["T" * 40, "T" * 100, "A" * 60, g[60:160],
                 simdata.rc(g[80:180]) + "TTTT"]
    ji, ti = _indexes(contigs)
    _assert_index_equal(ji, ti)
    if end_case == "unpadded_table":
        assert ti.table_len == ti.key_table.shape[0] == 64
    # the end case occurs: some bound is table_len + 1
    b = pack_reads(reads)
    codes = torch.from_numpy(b.codes)
    keys, _valid = tm._forward_kmers(codes, 32, codes.shape[1])
    q = keys.reshape(-1, keys.shape[-1])
    lo, hi = lookup_range(ti.key_table, q, ti.table_len)
    assert int(hi.max()) == ti.table_len + 1
    for min_identity in (0.0, 0.9):
        want = _jax_ungap(ji, b, min_identity)
        got = tm.map_reads_ungap_full(ti, b.codes, b.lengths, min_identity)
        for w, g_ in zip(want, got):
            assert (g_.numpy() == w).all()
    jid, joff = jm.map_reads(ji, b.codes, b.lengths)
    tid, toff = tm.map_reads(ti, b.codes, b.lengths)
    assert (tid == jid).all() and (toff == joff).all()


@pytest.mark.parametrize("seed,width,min_identity",
                         [(1, 100, 0.0), (3, 150, 0.9), (5, 600, 0.97)])
def test_ungap_plain_chunks_equal_one_pass(seed, width, min_identity):
    arrs = ungap_edge_inputs(seed, n_reads=200, width=width,
                             min_identity=min_identity)
    args = [torch.from_numpy(a) for a in arrs[:-1]] + [arrs[-1]]
    one = tm.ungap_align_plain(*args, chunk=len(arrs[0]))
    for chunk in (1, 7, 64):
        parts = tm.ungap_align_plain(*args, chunk=chunk)
        for a, b in zip(one, parts):
            assert torch.equal(a, b)
    # the wrapper takes the plain version on CPU tensors
    for a, b in zip(one, tm.ungap_align(*args)):
        assert torch.equal(a, b)
    mapped = one[0] != 0
    assert 0 < int(mapped.sum()) < len(mapped)


def test_ungap_align_checks_its_inputs():
    arrs = ungap_edge_inputs(2, n_reads=8)
    args = [torch.from_numpy(a) for a in arrs[:-1]] + [arrs[-1]]
    bad = list(args)
    bad[6] = args[6].to(torch.int64)                 # cid
    with pytest.raises(ValueError):
        tm.ungap_align(*bad)
    bad = list(args)
    bad[4] = args[4][:, :, :3]                       # ok of another shape
    with pytest.raises(ValueError):
        tm.ungap_align(*bad)


def test_contig_index_from_jax_arrays():
    contigs, reads = _case("multi_contig_errors")
    ji, _ti = _indexes(contigs)
    ti = interop.contig_index_from_arrays(
        ji.key_length, ji.key_table, ji.key_pos, ji.pool, ji.starts,
        ji.lengths, ji.table_len)
    _assert_index_equal(ji, ti)
    b = pack_reads(reads)
    want = _jax_ungap(ji, b, 0.0)
    got = tm.map_reads_ungap_full(ti, b.codes, b.lengths, 0.0)
    for w, g in zip(want, got):
        assert (g.numpy() == w).all()


@pytest.mark.parametrize("split", [False, True])
def test_map_pairs_and_insert_sizes(split, tmp_path):
    rng = np.random.default_rng(11)
    g = simdata.random_genome(rng, 8000)
    contigs = [g[:3000], g[3000:]] if split else [g]
    fwd, rev = simdata.paired_reads(rng, g, 100, 400, 30, 20.0,
                                    error_rate=0.005)
    fb, rb = pack_reads(fwd), pack_reads(rev)
    ji, ti = _indexes(contigs)
    jlib = jseqlib.PairLibrary(fb.codes, fb.lengths, rb.codes, rb.lengths)
    tlib = tseqlib.PairLibrary(fb.codes, fb.lengths, rb.codes, rb.lengths)
    jmp = jseqlib.map_pairs(ji, jlib)
    tmp = tseqlib.map_pairs(ti, tlib)
    for field in ("fwd_id", "fwd_off", "rev_id", "rev_off", "insert_lengths",
                  "link_fwd_id", "link_fwd_off", "link_rev_id", "link_rev_off"):
        a, b = getattr(jmp, field), getattr(tmp, field)
        assert a.dtype == b.dtype and (a == b).all(), field
    assert tlib.average_coverage == jlib.average_coverage
    assert tlib.average_length == jlib.average_length
    if split:
        assert len(tmp.link_fwd_id) > 0
    dist = tseqlib.insert_distribution(tmp.insert_lengths)
    assert (dist == jseqlib.insert_distribution(jmp.insert_lengths)).all()
    assert tseqlib.estimate_ins_size(dist) == jseqlib.estimate_ins_size(dist)
    assert (tseqlib.estimate_ins_size_normalized(dist, ti.lengths)
            == jseqlib.estimate_ins_size_normalized(dist, ji.lengths))
    t_sd = tseqlib.truncate_distribution_by_sd(dist)
    j_sd = jseqlib.truncate_distribution_by_sd(dist)
    assert (t_sd[0] == j_sd[0]).all() and t_sd[1:] == j_sd[1:]
    tseqlib.write_insert_freq_tsv(tmp_path / "t.tsv", tmp.insert_lengths)
    jseqlib.write_insert_freq_tsv(tmp_path / "j.tsv", jmp.insert_lengths)
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()


def test_libparse_matches_jax(tmp_path):
    rng = np.random.default_rng(13)
    g = simdata.random_genome(rng, 3000)
    fwd, rev = simdata.paired_reads(rng, g, 100, 400, 30, 5.0)
    fwd[3] = fwd[3][:70]
    simdata.write_fasta(tmp_path / "a1.fa", fwd)
    simdata.write_fasta(tmp_path / "a2.fa", rev)
    simdata.write_fasta(tmp_path / "il.fa",
                        [r for pair in zip(fwd, rev) for r in pair])
    d = str(tmp_path)
    argv = ["polish", "-c", "x.fa", "-IP1", f"{d}/a1.fa", f"{d}/a2.fa",
            "-ip1", f"{d}/il.fa", "-OP2", f"{d}/a1.fa", f"{d}/a2.fa",
            "-op3", f"{d}/il.fa", "-o", "out"]
    jrest, jspecs = jlibparse.extract_library_args(argv)
    trest, tspecs = tlibparse.extract_library_args(argv)
    assert trest == jrest == ["polish", "-c", "x.fa", "-o", "out"]
    assert [(s.lib_id, s.entries) for s in tspecs] == \
        [(s.lib_id, s.entries) for s in jspecs]
    for jlib, tlib in zip(jlibparse.load_libraries(jspecs),
                          tlibparse.load_libraries(tspecs)):
        for field in ("fwd_codes", "fwd_lengths", "rev_codes", "rev_lengths"):
            assert (getattr(jlib, field) == getattr(tlib, field)).all(), field
    for bad in (["-IP1", f"{d}/a1.fa"], ["-ip4"]):
        with pytest.raises(Exception) as te:
            tlibparse.extract_library_args(bad)
        with pytest.raises(Exception) as je:
            jlibparse.extract_library_args(bad)
        # the port raises its own copy of the reference's error classes
        assert ((type(te.value).__name__, te.value.exit_id, str(te.value))
                == (type(je.value).__name__, je.value.exit_id,
                    str(je.value)))
