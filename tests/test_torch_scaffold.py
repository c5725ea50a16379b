"""The port's copies of the JAX package's scaffold-family host modules and
of the commands that drive them, pinned to the reference's text, and the
pieces of this slice that touch the port's own
data: `save_overlap` over the port's ContigIndex, `map_reads_multi`, and
the tag counts of a tagged library — each equal to the JAX package's on
the same inputs, whole.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import pathlib
import re
import textwrap

import numpy as np
import pytest
import torch

import simdata
from platanus_b_tpu.io.fasta import seq_to_codes
from platanus_b_tpu.io.reads import pack_reads
from platanus_b_tpu.models import mapper as jmapper
from platanus_b_tpu.models import scaffold as jscaffold
from platanus_b_tpu.models import seqlib as jseqlib
from platanus_b_tpu_torch.models import mapper as tmapper
from platanus_b_tpu_torch.models import scaffold as tscaffold
from platanus_b_tpu_torch.models import seqlib as tseqlib

REPO = pathlib.Path(__file__).resolve().parents[1]

# The copies of the JAX package's host modules. For each: the functions
# whose whole body may differ (a device kernel rewritten in torch ops), and
# the hunks allowed elsewhere, each as (reference lines, port lines) after
# dedent; a (first, last) pair names the reference's lines from `first`
# through `last`. Every other line, imports and blank lines aside, is the
# reference's, and every hunk listed must occur.
_DEVICE_INDEX = ("index = ContigIndex(seqs, key_length=32)",
                 'device = select_device()\nLOG.info(f"device: {device}")\n'
                 "index = ContigIndex(seqs, key_length=32, device=device)")
PINS = {
    "models/scaffold.py": (set(), [
        ("kt, kp = index.key_table, index.key_pos",
         "kt = keys_to_words(index.key_table, index.key_length)\n"
         "kp = index.key_pos.cpu().numpy()")]),
    "models/hetero.py": (set(), []),
    "models/divide.py": (set(), []),
    "models/bubble.py": (set(), []),
    "models/gap_close.py": (set(), []),
    "models/phasing.py": (set(), []),
    "models/longread.py": ({"_chain_kernel"}, [
        ("", "self.device = select_device()"),
        ("sk = sketch(mat, lens, p.k, p.w)",
         "sk = sketch(mat, lens, p.k, p.w, self.device)"),
        ("sks = sketch(mat, lens, p.k, p.w)",
         "sks = sketch(mat, lens, p.k, p.w, self.device)"),
        ("f_all, prev_all = kern(jnp.asarray(qs), jnp.asarray(ts),\n"
         "                       jnp.asarray(ns))\n"
         "f_all = np.asarray(f_all)\nprev_all = np.asarray(prev_all)",
         "f_all, prev_all = kern(torch.from_numpy(qs).to(self.device),\n"
         "                       torch.from_numpy(ts).to(self.device),\n"
         "                       torch.from_numpy(ns).to(self.device))\n"
         "f_all = f_all.cpu().numpy()\nprev_all = prev_all.cpu().numpy()"),
        ('if jax.default_backend() == "cpu":',
         'device = select_device()\nif device.type == "cpu":'),
        ("eds = banded_edit_distance(qs, ts, band=SEG_BAND).astype(np.int64)",
         "eds = banded_edit_distance(qs, ts, band=SEG_BAND,\n"
         "                           device=device).astype(np.int64)")]),
    "commands/solve_dbg_cmd.py": (set(), [_DEVICE_INDEX]),
    "commands/scaffold_cmd.py": (set(), [_DEVICE_INDEX]),
    "commands/divide_impl.py": (set(), [
        ("def divide_scaffolds(scaffolds, libs, seed_lengths=(32,), "
         "min_len: int = 100):",
         "def divide_scaffolds(scaffolds, libs, seed_lengths=(32,), "
         'min_len: int = 100,\n                     device="cpu"):'),
        ("index = ContigIndex(scaffolds, key_length=32)",
         "index = ContigIndex(scaffolds, key_length=32, device=device)"),
        ("", 'device = select_device()\nLOG.info(f"device: {device}")'),
        ("min_len=max_k)", "min_len=max_k, device=device)")]),
    "commands/orchestrators.py": (set(), []),
    "commands/iterate_cmd.py": (set(), [
        ("rc = cli_main(argv)",
         'with LOG.stage(f"iterate: {stage}"):\n    rc = cli_main(argv)')]),
    "commands/combine_impl.py": (set(), []),
    "commands/combine_cmd.py": (set(), []),
    "models/combinatorial.py": (set(), []),
    # the host-only modules the port keeps its own copies of
    "io/fasta.py": (set(), [
        ("Fast path: the native C++ decoder (platanus_b_tpu.native) over the",
         "Fast path: the native C++ decoder (the port's native module) over "
         "the")]),
    "io/reads.py": (set(), [("jax.sharding, not via per-thread files.",
                             "the caller, not via per-thread files.")]),
    "utils/errors.py": (set(), []),
    "utils/constants.py": (set(), []),
    "native/__init__.py": (set(), [
        # the line before, "import (cached ...", reads as an import line
        ("implementations when no compiler is available.",
         "the pure-Python implementations when no compiler is available."),
        ('_LIB = os.path.join(_HERE, f"_io_native_'
         '{sys.implementation.cache_tag}.so")',
         'BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")\n'
         "_LIB = os.path.join(BUILD_DIR,\n"
         '                    f"_io_native_{sys.implementation.cache_tag}'
         '.so")'),
        # a temporary file per process: ranks building at once on a fresh
        # checkout (test_torch_multihost.py::test_native_build_is_process_safe)
        ("", "os.makedirs(BUILD_DIR, exist_ok=True)\n"
             'tmp = f"{_LIB}.{os.getpid()}.tmp"'),
        ('"-o", _LIB + ".tmp", _SRC],', '"-o", tmp, _SRC],'),
        ('os.replace(_LIB + ".tmp", _LIB)', "os.replace(tmp, _LIB)")]),
}

_IMPORT = re.compile(r"^\s*(from\s+\S+\s+import\b|import\s)")


def _lines(path: pathlib.Path) -> list[str]:
    """Source lines without the port's docstring paragraph, import lines
    and blank lines."""
    text = path.read_text()
    text = re.sub(r"\n\nPort copy of platanus_b_tpu/.*?(?=\n\"\"\"\n)", "",
                  text, count=1, flags=re.S)
    return [ln for ln in text.splitlines()
            if ln.strip() and not _IMPORT.match(ln)]


def _owner(lines: list[str], i: int) -> str:
    """Name of the top-level function, or the method, holding line i."""
    for j in range(min(i, len(lines) - 1), -1, -1):
        m = re.match(r"^(def|class) (\w+)", lines[j])
        if m:
            if m.group(1) == "def":
                return m.group(2)
            for k in range(min(i, len(lines) - 1), j, -1):
                mm = re.match(r"^    def (\w+)", lines[k])
                if mm:
                    return mm.group(1)
            return m.group(2)
    return "<module>"


def _span_text(ref: list[str], first: str, last: str) -> str:
    """The reference's lines from the one that reads `first` through the
    next that reads `last`, dedented."""
    s = [ln.strip() for ln in ref]
    i = s.index(first)
    return textwrap.dedent("\n".join(ref[i: s.index(last, i) + 1]))


@pytest.mark.parametrize("rel", sorted(PINS))
def test_copy_matches_reference(rel):
    import difflib

    ref = _lines(REPO / "platanus_b_tpu" / rel)
    port_path = REPO / "platanus_b_tpu_torch" / rel
    assert f"Port copy of platanus_b_tpu/{rel}" in port_path.read_text()
    port = _lines(port_path)
    whole, hunks = PINS[rel]
    allowed = [(_span_text(ref, *r) if isinstance(r, tuple) else r, p)
               for r, p in hunks]
    seen = []
    sm = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        owners = {_owner(port, j1 if j2 > j1 else max(j1 - 1, 0)),
                  _owner(ref, i1 if i2 > i1 else max(i1 - 1, 0))}
        if owners <= whole:
            continue
        seen.append((textwrap.dedent("\n".join(ref[i1:i2])),
                     textwrap.dedent("\n".join(port[j1:j2]))))
    assert seen == allowed


def _contigs(rng):
    """tests/test_scaffold.py-sized contigs with 50 bp and 20 bp end
    overlaps, a repeated 1 kbp block (equal keys with several postings)
    and a reverse-complemented piece."""
    g = simdata.random_genome(rng, 4000)
    rep = simdata.random_genome(rng, 1000)
    seqs = [g[:1050], g[1000:2020], g[2000:3000] + rep, rep + g[3000:],
            simdata.rc(g[1500:2600]), rep[100:900]]
    return [seq_to_codes(s) for s in seqs]


@pytest.mark.parametrize("min_overlap,hash_overlap,cutoff",
                         [(31, 49, 50), (15, 31, 50), (31, 49, 1000)])
def test_save_overlap_table_equal(min_overlap, hash_overlap, cutoff):
    codes = _contigs(np.random.default_rng(42))
    covs = np.full(len(codes), 40.0)
    jg = jscaffold.ScaffoldGraph(codes, covs, min_overlap=min_overlap,
                                 hash_overlap=hash_overlap)
    jg.save_overlap(jmapper.ContigIndex(codes, key_length=32),
                    cutoff_length=cutoff)
    tg = tscaffold.ScaffoldGraph(codes, covs, min_overlap=min_overlap,
                                 hash_overlap=hash_overlap)
    tg.save_overlap(tmapper.ContigIndex(codes, key_length=32),
                    cutoff_length=cutoff)
    assert list(tg.overlap_table.items()) == list(jg.overlap_table.items())
    if cutoff == 50:
        assert tg.overlap_table


def test_map_reads_multi_equal():
    rng = np.random.default_rng(42)
    codes = _contigs(rng)
    genome = "".join("ACGT"[b] for b in np.concatenate(codes))
    reads = simdata.shotgun_reads(rng, genome, 100, 8.0, error_rate=0.01)
    reads += [r[:40] for r in reads[:50]] + ["N" * 20 + r[20:] for r in
                                              reads[50:80]]
    batch = pack_reads([seq_to_codes(r) for r in reads])
    want = jmapper.map_reads_multi(jmapper.ContigIndex(codes, key_length=32),
                                   batch.codes, batch.lengths, (32, 16))
    got = tmapper.map_reads_multi(tmapper.ContigIndex(codes, key_length=32),
                                  torch.from_numpy(batch.codes),
                                  torch.from_numpy(batch.lengths), (32, 16))
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # reads in the repeat report more than one position
    assert len(want[0]) > len(np.unique(want[0]))


def test_count_mapped_tag_for_each_contig_equal():
    """tests/test_tags.py:33's library, plus pairs of barcode 3 that span
    both contigs."""
    rng = np.random.default_rng(42)
    g1 = simdata.random_genome(rng, 3000)
    g2 = simdata.random_genome(rng, 3000)
    contigs = [seq_to_codes(g1), seq_to_codes(g2)]
    fwd, rev, tags = [], [], []
    for g, tag, n in ((g1, 1, 6), (g2, 2, 4)):
        for i in range(n):
            fwd.append(seq_to_codes(g[i * 300: i * 300 + 100]))
            rev.append(seq_to_codes(simdata.rc(g[i * 300 + 150:
                                                 i * 300 + 250])))
            tags.append(tag)
    for i in range(3):
        fwd.append(seq_to_codes(g1[i * 500: i * 500 + 100]))
        rev.append(seq_to_codes(simdata.rc(g2[i * 500: i * 500 + 100])))
        tags.append(3)
    fb, rb = pack_reads(fwd), pack_reads(rev)
    args = (fb.codes, fb.lengths, rb.codes, rb.lengths, np.array(tags))
    want = jseqlib.count_mapped_tag_for_each_contig(
        jmapper.ContigIndex(contigs, key_length=32),
        jseqlib.TagLibrary(*args, num_tags=3))
    got = tseqlib.count_mapped_tag_for_each_contig(
        tmapper.ContigIndex(contigs, key_length=32),
        tseqlib.TagLibrary(*args, num_tags=3))
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    pairs = {(int(t), int(c)): int(n) for t, c, n in zip(*got)}
    assert pairs[(1, 0)] == 12 and pairs[(2, 1)] == 8
    assert pairs[(3, 0)] == 3 and pairs[(3, 1)] == 3
