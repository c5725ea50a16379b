"""The port's CUDA kernels on the card: each against its plain version, and
the CLI on the card against the CLI on the CPU (byte for byte).

Every case skips without a CUDA card. The file imports no jax, so on the
machine with the card (which has no jax) it runs without the session
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import simdata
from platanus_b_tpu_torch import kernels
from platanus_b_tpu_torch.commands.main import main as port_main
from platanus_b_tpu_torch.models import mapper as tmapper
from platanus_b_tpu_torch.ops import align as talign
from platanus_b_tpu_torch.ops import kmer as tkmer
from platanus_b_tpu_torch.simulate import ungap_edge_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mutate(rng, s, n_sub, n_ins, n_del):
    s = list(s)
    for _ in range(n_sub):
        i = rng.integers(0, len(s))
        s[i] = (s[i] + rng.integers(1, 4)) % 4
    for _ in range(n_ins):
        s.insert(rng.integers(0, len(s) + 1), rng.integers(0, 4))
    for _ in range(n_del):
        if s:
            del s[rng.integers(0, len(s))]
    return np.array(s, np.uint8)


def test_kernels_build(dev):
    kernels.library()
    assert len(kernels.BUILD_INFO["paths"]) == 3
    assert all(p.endswith(".so") for p in kernels.BUILD_INFO["paths"])


@pytest.mark.parametrize("k", [25, 32, 48, 95])
def test_kmer_extract_kernel_matches_plain(dev, k):
    rng = np.random.default_rng(k)
    R, L = 300, 160
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    lens = rng.integers(L // 2, L + 1, size=R).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    codes[rng.random((R, L)) < 0.01] = 4
    words, nmask = tkmer.pack_codes(torch.from_numpy(codes).to(dev))
    for fwd in (False, True):
        got = tkmer.extract_kmers_packed(words, k, nmask=nmask, max_len=L,
                                         forward_only=fwd)
        want = tkmer.extract_kmers_packed_plain(words, k, nmask=nmask,
                                                max_len=L, forward_only=fwd)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kmer_extract_all_ones_key_odd_words(dev):
    """A valid all-ones forward key (poly-T at k = 16, 48) has INT64_MAX
    lanes, like the plain version's words_to_lanes."""
    codes = np.full((2, 64), 3, np.uint8)
    codes[1, 20] = 4
    words, nmask = tkmer.pack_codes(torch.from_numpy(codes).to(dev))
    for k in (16, 48):
        got = tkmer.extract_kmers_packed(words, k, nmask=nmask, max_len=64,
                                         forward_only=True)
        want = tkmer.extract_kmers_packed_plain(words, k, nmask=nmask,
                                                max_len=64, forward_only=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _kmer_equal(words, k, **kw):
    got = tkmer.extract_kmers_packed(words, k, **kw)
    want = tkmer.extract_kmers_packed_plain(words, k, **kw)
    assert torch.equal(got[0], want[0]), "keys"
    assert torch.equal(got[1], want[1]), (got[1], want[1])


@pytest.mark.parametrize("mode", ["nmask", "lengths"])
@pytest.mark.parametrize("k", [16, 32, 33, 48, 64, 65, 96, 256])
def test_kmer_extract_tiles_and_edges(dev, k, mode):
    """Whole-read tiles: a read count that is no multiple of a tile's rows,
    Ns in the first and the last window, P no multiple of the threads per
    read, both validity modes and both strands."""
    rng = np.random.default_rng(1000 + k)
    R, L = 1001, 300
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    lens = rng.integers(k, L + 1, size=R).astype(np.int32)
    lens[:3] = L
    if mode == "nmask":
        codes[rng.random((R, L)) < 0.004] = 4
        codes[::7, 0] = 4                       # N in the first window
        codes[np.arange(3, R, 11), lens[3::11] - 1] = 4   # ... and the last
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    Lp = -(-L // 32) * 32
    padded = np.full((R, Lp), 4, np.uint8)
    padded[:, :L] = codes
    words, nmask = tkmer.pack_codes(torch.from_numpy(padded).to(dev))
    kw = ({"nmask": nmask} if mode == "nmask"
          else {"lengths": torch.from_numpy(lens).to(dev)})
    for fwd in (False, True):
        _kmer_equal(words, k, max_len=L, forward_only=fwd, **kw)


@pytest.mark.parametrize("k", [32, 65])
def test_kmer_extract_long_rows(dev, k):
    """Rows longer than a whole-row tile take window ranges of one row,
    across the range boundaries, as a concatenated contig set does."""
    rng = np.random.default_rng(k)
    R, L = 3, 20000
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    codes[rng.random((R, L)) < 0.001] = 4
    codes[1, 4090:4100] = 4
    words, nmask = tkmer.pack_codes(torch.from_numpy(codes).to(dev))
    _kmer_equal(words, k, nmask=nmask, max_len=L - 7)
    lens = torch.tensor([L, L - 9, 5000], dtype=torch.int32, device=dev)
    _kmer_equal(words, k, lengths=lens, max_len=L)


def test_kmer_extract_n_valid_at_main_path_shape(dev):
    """The 1 Mbp main path's shape: 320,000 reads of 125 bases at k = 32,
    with Ns; keys and the valid-window count are exact."""
    rng = np.random.default_rng(125)
    R, L = 320_000, 125
    codes = np.full((R, 128), 4, np.uint8)
    codes[:, :L] = rng.integers(0, 4, size=(R, L))
    codes[:, :L][rng.random((R, L)) < 0.001] = 4
    words, nmask = tkmer.pack_codes(torch.from_numpy(codes).to(dev))
    _kmer_equal(words, 32, nmask=nmask, max_len=L)


@pytest.mark.parametrize("seed,width,min_identity,S,H",
                         [(7, 100, 0.0, 5, 16), (8, 100, 0.97, 3, 7),
                          (9, 600, 0.9, 5, 16), (10, 150, 0.97, 5, 16),
                          (11, 600, 0.0, 3, 7)])
def test_ungap_align_slot_patterns(dev, seed, width, min_identity, S, H):
    """Dedup before scoring: every slot equal, a not-ok slot ahead of its
    ok twin, S*H no multiple of 32 (21), the global-memory read path (600)
    and min_identity 0 and 0.97."""
    arrs = ungap_edge_inputs(seed, width=width, min_identity=min_identity,
                             S=S, H=H, twins=True)
    args = [torch.from_numpy(a).to(dev) for a in arrs[:-1]] + [arrs[-1]]
    got = tmapper.ungap_align(*args)
    want = tmapper.ungap_align_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < int((got[0] != 0).sum()) < len(got[0])


@pytest.mark.parametrize("seed,width,min_identity",
                         [(1, 100, 0.0), (2, 100, 0.97), (3, 150, 0.9),
                          (4, 300, 0.5), (5, 600, 0.9)])
def test_ungap_align_kernel_matches_plain(dev, seed, width, min_identity):
    """Edge sets: short reads, Ns, contig ends both ways, duplicate slots,
    tied maxima; widths for each register layout and the global one."""
    arrs = ungap_edge_inputs(seed, width=width, min_identity=min_identity)
    args = [torch.from_numpy(a).to(dev) for a in arrs[:-1]] + [arrs[-1]]
    before = kernels.LAUNCHES["ungap_align"]
    got = tmapper.ungap_align(*args)
    assert kernels.LAUNCHES["ungap_align"] == before + 1
    want = tmapper.ungap_align_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert 0 < int((got[0] != 0).sum()) < len(got[0])


def _random_pairs(rng, n, lo, hi, edits=(3, 2, 1)):
    qs = [rng.integers(0, 4, size=int(rng.integers(lo, hi)), dtype=np.uint8)
          for _ in range(n)]
    return qs, [_mutate(rng, x, *edits) for x in qs]


def _edit_distance_case(shape, rng):
    """(queries, targets) that reach one tier of csrc/edit_distance.cu (the
    tier follows each pair's width min(bw, qlen)), or one of its edges."""
    if shape == "random":                 # pairs under 300 bases
        qs, ts = _random_pairs(rng, 37, 1, 300)
        qs[5] = np.zeros(0, np.uint8)
    elif shape == "bubble":               # crush_bubble: one-base SNP middles
        qs, ts = _random_pairs(rng, 60, 1, 2, (1, 0, 0))
        q2, t2 = _random_pairs(rng, 6, 2, 134, (4, 3, 3))
        qs, ts = qs + q2, ts + t2
        qs[0] = rng.integers(0, 4, size=133, dtype=np.uint8)
        ts[0] = _mutate(rng, qs[0], 4, 3, 3)
    elif shape == "segment":              # long-read segments, band 128
        qs, ts = _random_pairs(rng, 40, 1000, 2100, (20, 8, 8))
    elif shape == "register_tiers":       # one pair per register tier
        qs, ts = [], []
        for n in (20, 50, 100, 180, 250, 380, 470):
            q2, t2 = _random_pairs(rng, 2, n, n + 12, (6, 3, 3))
            qs, ts = qs + q2, ts + t2
    elif shape == "shared_band":          # wider than the register tiers
        qs, ts = _random_pairs(rng, 9, 520, 1500, (12, 6, 6))
        q2, t2 = _random_pairs(rng, 3, 10, 400)
        qs, ts = qs + q2, ts + t2
    elif shape == "global_band":          # buffers in scratch, rows unstaged
        qs, ts = _random_pairs(rng, 2, 19600, 20000, (40, 10, 10))
        q2, t2 = _random_pairs(rng, 3, 1, 900)
        qs, ts = qs + q2, ts + t2
    elif shape == "unstaged":             # rows too long to stage, band 128
        qs, ts = _random_pairs(rng, 2, 17000, 17400, (30, 10, 10))
    elif shape == "map_ont_segment":      # map-ont read segments with indels
        qs, ts = _random_pairs(rng, 64, 900, 1100, (11, 5, 5))
        q2, t2 = _random_pairs(rng, 8, 1, 400, (4, 2, 2))
        qs, ts = qs + q2, ts + t2
    else:                                 # edges at band 128
        x = rng.integers(0, 4, size=400, dtype=np.uint8)
        shifted = np.concatenate([rng.integers(0, 4, size=300,
                                               dtype=np.uint8), x])
        n_codes = x[:200].copy()
        n_codes[::5] = 4
        e = np.zeros(0, np.uint8)
        qs = [x, x, x[:30], n_codes, np.full(40, 4, np.uint8), e, x[:3], e]
        ts = [shifted, x[:30], x, _mutate(rng, x[:200], 3, 1, 1),
              np.full(40, 4, np.uint8), x[:5], e, e]
    return qs, ts


@pytest.mark.parametrize("band,shape", [
    pytest.param(128, "random", id="128"),
    pytest.param(640, "random", id="640"),
    pytest.param(20000, "random", id="20000"),
    pytest.param(384, "bubble", id="bubble_384"),
    pytest.param(128, "segment", id="segment_128"),
    pytest.param(512, "register_tiers", id="register_tiers_512"),
    pytest.param(2048, "shared_band", id="shared_band_2048"),
    pytest.param(20096, "global_band", id="global_band_20096"),
    pytest.param(128, "unstaged", id="unstaged_128"),
    pytest.param(128, "map_ont_segment", id="map_ont_segment_128"),
    pytest.param(128, "edges", id="edges_128"),
    pytest.param(384, "edges", id="edges_384")])
def test_edit_distance_kernel_matches_plain(dev, band, shape):
    """Every tier: registers (one to 16 cells a lane), the band in shared
    memory, the band in global scratch with rows read from global memory;
    qlen >> tlen and tlen >> qlen, a band too narrow for the optimal path,
    codes >= 4 and empty sides."""
    qs, ts = _edit_distance_case(shape, np.random.default_rng(band))
    before = kernels.LAUNCHES["edit_distance"]
    got = talign.banded_edit_distance(qs, ts, band=band, device=dev)
    assert kernels.LAUNCHES["edit_distance"] == before + 1
    q, ql = talign._pad_rows(qs, dev)
    t, tl = talign._pad_rows(ts, dev)
    want = talign.edit_distance_plain(q, t, ql, tl, talign.band_width(band))
    assert got.tolist() == want.cpu().tolist()
    if shape == "edges":   # the optimal path leaves band 128, not 384
        true = talign.edit_distance_np(qs[0], ts[0])
        assert (got[0] > true) if band == 128 else (got[0] == true)
        assert got.tolist()[-3:] == [5, 3, 0]


@pytest.mark.parametrize("max_gap,kk", [(5000, 15), (10000, 19)],
                         ids=["map-ont", "asm10"])
def test_chain_kernel_on_card_matches_cpu(dev, max_gap, kk):
    """The chaining DP (models/longread.py:_chain_kernel) on the card
    against the same call on the CPU, f and prev bit for bit, on anchor
    groups whose candidate links have gap sizes g from 1 to max_gap; and
    the gap-cost table gathered on the card equals the CPU's."""
    from platanus_b_tpu_torch.models.longread import _chain_kernel
    from platanus_b_tpu_torch.ops.gapcost import chain_gap_cost
    table = chain_gap_cost(max_gap)
    g = torch.arange(max_gap + 1, device=dev)
    on_card = torch.from_numpy(table.copy()).to(dev)[g].cpu().numpy()
    assert np.array_equal(on_card.view(np.uint32), table.view(np.uint32))
    rng = np.random.default_rng(max_gap)
    B, cap = 96, 128
    qs = np.zeros((B, cap), np.int32)
    ts = np.zeros((B, cap), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(cap // 2, cap + 1))
        dq = rng.integers(1, max_gap // 40 + 2, size=n)
        dt = dq + rng.integers(-6, 7, size=n)
        jump = rng.random(n) < 0.1
        dt[jump] += rng.integers(-max_gap, max_gap + 1, size=int(jump.sum()))
        q = np.cumsum(dq)
        t = np.cumsum(np.maximum(dt, 1))
        order = np.lexsort((q, t))
        qs[b, :n], ts[b, :n], ns[b] = q[order], t[order], n
    # the gaps of the candidate links the DP scores (0 < dq, dt <= max_gap
    # within the lookback of 25)
    gaps = set()
    for b in range(B):
        q, t = qs[b, :ns[b]].astype(np.int64), ts[b, :ns[b]].astype(np.int64)
        for h in range(1, 26):
            dq, dt = q[h:] - q[:-h], t[h:] - t[:-h]
            ok = (dq > 0) & (dt > 0) & (dq <= max_gap) & (dt <= max_gap)
            gaps.update(np.abs(dq - dt)[ok].tolist())
    assert min(gaps - {0}) == 1 and max(gaps) > 0.9 * max_gap
    kern = _chain_kernel(cap, 25, max_gap, kk)
    args = [torch.from_numpy(x) for x in (qs, ts, ns)]
    cf, cp = kern(*args)
    gf, gp = kern(*[x.to(dev) for x in args])
    assert np.array_equal(gf.cpu().numpy().view(np.uint32),
                          cf.numpy().view(np.uint32))
    assert torch.equal(gp.cpu(), cp)
    assert (cp >= 0).sum() > B


def test_card_writes_the_cpu_bytes(dev, tmp_path, monkeypatch):
    """`assemble -u 0.1` on two haplotypes: the card's files equal the CPU
    run's, and on the card no plain version runs."""
    rng = np.random.default_rng(7)
    g = simdata.random_genome(rng, 2500)
    g2 = simdata.mutate(rng, g, 0.01)
    reads = tmp_path / "reads.fa"
    simdata.write_fasta(reads, simdata.shotgun_reads(rng, g, 100, 25.0, 0.003)
                        + simdata.shotgun_reads(rng, g2, 100, 25.0, 0.003))
    flags = ["-k", "25", "-u", "0.1"]
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    assert port_main(["assemble", "-f", str(reads), "-o",
                      str(tmp_path / "cpu")] + flags) == 0

    def no_plain(*_a, **_k):
        raise AssertionError("plain version called on the card")

    monkeypatch.setattr(talign, "edit_distance_plain", no_plain)
    monkeypatch.setattr(tkmer, "extract_kmers_packed_plain", no_plain)
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cuda")
    before = dict(kernels.LAUNCHES)
    assert port_main(["assemble", "-f", str(reads), "-o",
                      str(tmp_path / "gpu")] + flags) == 0
    for name in ("edit_distance", "kmer_extract"):
        assert kernels.LAUNCHES[name] > before[name], name
    for name in ("contig.fa", "contigBubble.fa", "25merFrq.tsv"):
        assert ((tmp_path / f"gpu_{name}").read_bytes()
                == (tmp_path / f"cpu_{name}").read_bytes()), name


def test_polish_on_card_writes_the_cpu_bytes(dev, tmp_path, monkeypatch):
    """`polish` on the card equals the CPU run, with the plain scoring and
    extraction patched to raise."""
    rng = np.random.default_rng(11)
    genome = simdata.random_genome(rng, 5000)
    fwd, rev = simdata.paired_reads(rng, genome, 100, 400, 30, 30.0,
                                    error_rate=0.01)
    simdata.write_fasta(tmp_path / "r1.fa", fwd)
    simdata.write_fasta(tmp_path / "r2.fa", rev)
    contig = genome[:2400] + simdata.random_genome(rng, 300) + genome[2400:]
    (tmp_path / "c.fa").write_text(
        f">seq1_len{len(contig)}_cov30_read100_maxK50\n{contig}\n")
    monkeypatch.chdir(tmp_path)
    argv = ["polish", "-c", "c.fa", "-IP1", "r1.fa", "r2.fa", "-o"]
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    assert port_main(argv + ["cpu"]) == 0

    def no_plain(*_a, **_k):
        raise AssertionError("plain version called on the card")

    monkeypatch.setattr(tmapper, "ungap_align_plain", no_plain)
    monkeypatch.setattr(tkmer, "extract_kmers_packed_plain", no_plain)
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cuda")
    before = dict(kernels.LAUNCHES)
    assert port_main(argv + ["gpu"]) == 0
    for name in ("kmer_extract", "ungap_align"):
        assert kernels.LAUNCHES[name] > before[name]
    assert ((tmp_path / "gpu_polished_c.fa").read_bytes()
            == (tmp_path / "cpu_polished_c.fa").read_bytes())


def _run_cpu_then_card(monkeypatch, argv, patch_plain):
    """argv through the port's CLI on the CPU (-o cpu) and on the card
    (-o gpu), the plain versions in `patch_plain` raising on the card;
    returns the kernel launches of the card run."""
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    assert port_main(argv + ["-o", "cpu"]) == 0

    def no_plain(*_a, **_k):
        raise AssertionError("plain version called on the card")

    for mod, name in patch_plain:
        monkeypatch.setattr(mod, name, no_plain)
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cuda")
    before = dict(kernels.LAUNCHES)
    assert port_main(argv + ["-o", "gpu"]) == 0
    return {k: kernels.LAUNCHES[k] - before[k] for k in before}


def test_solve_dbg_on_card_writes_the_cpu_bytes(dev, tmp_path, monkeypatch):
    """`solve_dbg -unphase` (tests/test_scaffold_cmd.py's data) on the card
    equals the CPU run."""
    rng = np.random.default_rng(42)
    genome = simdata.random_genome(rng, 8000)
    with open(tmp_path / "c.fa", "w") as f:
        for i, c in enumerate([genome[:3900], genome[4100:]]):
            f.write(f">seq{i+1}_len{len(c)}_cov40_read100_maxK50\n{c}\n")
    fwd, rev = simdata.paired_reads(rng, genome, 100, 500, 50, 30.0)
    simdata.write_fasta(tmp_path / "1.fa", fwd)
    simdata.write_fasta(tmp_path / "2.fa", rev)
    monkeypatch.chdir(tmp_path)
    launched = _run_cpu_then_card(
        monkeypatch, ["solve_dbg", "-unphase", "-c", "c.fa", "-IP1", "1.fa",
                      "2.fa"], [(tkmer, "extract_kmers_packed_plain")])
    assert launched["kmer_extract"] > 0
    for name in ("consensusScaffold.fa", "consensusScaffoldComponent.bed",
                 "lib1_insFreq.tsv"):
        assert ((tmp_path / f"gpu_{name}").read_bytes()
                == (tmp_path / f"cpu_{name}").read_bytes()), name


def test_phasing_flow_on_card_writes_the_cpu_bytes(dev, tmp_path,
                                                   monkeypatch):
    """The default solve_dbg flow on tests/test_phase.py:50's data: its
    haplotig pairing runs the asm10 long-read aligner, whose segment
    verification uses the edit_distance kernel on the card (band 128)
    where the CPU uses hetero.align_scaffold (band 64); both measure these
    0.3%-divergent segments exactly, so the files agree."""
    rng = np.random.default_rng(42)
    homo = simdata.random_genome(rng, 25000)
    hap1 = simdata.random_genome(rng, 12000)
    hap2 = simdata.mutate(rng, hap1, 0.003)
    with open(tmp_path / "c.fa", "w") as f:
        f.write(f">seq1_len{len(homo)}_cov40_read100_maxK50\n{homo}\n")
        f.write(f">seq2_len{len(hap1)}_cov21_read100_maxK50\n{hap1}\n")
        f.write(f">seq3_len{len(hap2)}_cov19_read100_maxK50\n{hap2}\n")
    monkeypatch.chdir(tmp_path)
    launched = _run_cpu_then_card(
        monkeypatch, ["solve_dbg", "-c", "c.fa"],
        [(tkmer, "extract_kmers_packed_plain"),
         (talign, "edit_distance_plain")])
    assert launched["edit_distance"] > 0 and launched["kmer_extract"] > 0
    for name in ("primaryBubble.fa", "secondaryBubble.fa",
                 "nonBubbleHetero.fa", "nonBubbleOther.fa",
                 "bubbleRelation.tsv", "phasedScaffoldComponent.bed"):
        assert ((tmp_path / f"gpu_{name}").read_bytes()
                == (tmp_path / f"cpu_{name}").read_bytes()), name


@pytest.fixture
def nccl_world1(dev):
    """A one-rank NCCL process group on the card, destroyed afterwards."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _staged_reads(dev):
    from platanus_b_tpu_torch.io.reads import pack_reads
    from platanus_b_tpu_torch.models.assemble_core import stage_reads
    rng = np.random.default_rng(3)
    genome = simdata.random_genome(rng, 20000)
    reads = simdata.shotgun_reads(rng, genome, 100, 20.0, error_rate=0.003)
    return stage_reads([pack_reads(reads)], dev)


@pytest.mark.parametrize("k", [21, 32, 48])
def test_sharded_count_over_nccl_world1(dev, nccl_world1, k):
    """sharded_count at world 1 over NCCL: kmer_extract, the all_to_all
    with exact splits, the count and the histogram's all_reduce give
    count_reads_device's table."""
    from platanus_b_tpu_torch.models.assemble_core import count_reads_device
    from platanus_b_tpu_torch.parallel.sharding import sharded_count
    reads = _staged_reads(dev)
    before = kernels.LAUNCHES["kmer_extract"]
    keys, counts, hist = sharded_count(reads, k, nccl_world1)
    assert kernels.LAUNCHES["kmer_extract"] > before
    want_k, want_c, n, want_h = count_reads_device(reads, k)
    assert keys.is_cuda and n > 0
    assert torch.equal(keys, want_k) and torch.equal(counts, want_c)
    assert np.array_equal(hist.cpu().numpy(), want_h)


def test_sharded_adjacency_over_nccl_world1(dev, nccl_world1):
    """The halo exchange at world 1 over NCCL gives the DBG's adjacency."""
    from platanus_b_tpu_torch.models.dbg import DBG
    from platanus_b_tpu_torch.parallel.sharding import (sharded_adjacency,
                                                        sharded_count)
    keys, counts, _h = sharded_count(_staged_reads(dev), 21, nccl_world1)
    out, junc, n_junc, n_edge = sharded_adjacency(keys, counts, 21,
                                                  nccl_world1)
    _si, _so, want_out, outdeg, want_junc = DBG(21, keys, counts).topo
    assert torch.equal(out.to(torch.int64), want_out.T.to(torch.int64))
    assert torch.equal(junc, want_junc)
    assert n_junc == int(want_junc.sum()) > 0
    assert n_edge == int(outdeg.sum())
