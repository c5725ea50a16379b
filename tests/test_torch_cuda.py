"""The port's CUDA kernels on the card: each against its plain version, and
the CLI on the card against the CLI on the CPU (byte for byte).

Every case skips without a CUDA card. The file imports no jax, so on the
machine with the card (which has no jax) it runs without the session
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest
import torch

import simdata
import torch_families
from platanus_b_tpu_torch import kernels
from platanus_b_tpu_torch.commands.main import main as port_main
from platanus_b_tpu_torch.models import mapper as tmapper
from platanus_b_tpu_torch.models import longread as tlongread
from platanus_b_tpu_torch.ops import align as talign
from platanus_b_tpu_torch.ops import chain as tchain
from platanus_b_tpu_torch.ops import keys as tkeys
from platanus_b_tpu_torch.ops import kmer as tkmer
from platanus_b_tpu_torch.ops import rank as trank
from platanus_b_tpu_torch.ops import search as tsearch
from platanus_b_tpu_torch.simulate import (chain_dp_inputs, coverage_counts,
                                           interleaved_unitigs, label_links,
                                           search_inputs, ungap_edge_inputs)

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
    assert len(kernels.BUILD_INFO["paths"]) == 7
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
    """The chaining DP (models/longread.py:_chain_kernel) on the card, K4,
    against the same call on the CPU, its plain version, f and prev bit for
    bit, on anchor groups whose candidate links have gap sizes g from 1 to
    max_gap; and the gap-cost table gathered on the card equals the
    CPU's."""
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


@pytest.mark.parametrize("cap,B,H,max_gap,kk", [
    pytest.param(16, 157, 25, 5000, 15, id="cap16_H25"),
    pytest.param(128, 23, 40, 5000, 15, id="cap128_H40"),
    pytest.param(512, 57, 25, 5000, 15, id="cap512_H25"),
    pytest.param(1024, 87, 40, 5000, 15, id="cap1024_H40"),
    pytest.param(2048, 79, 25, 5000, 15, id="cap2048_H25"),
    pytest.param(4096, 24, 40, 5000, 15, id="cap4096_H40"),
    pytest.param(4096, 6, 25, 10000, 19, id="cap4096_H25_asm10"),
    pytest.param(512, 12, 160, 10000, 19, id="cap512_H160_memory_window"),
    pytest.param(512, 12, 25, 60000, 19, id="cap512_H25_table_past_smem"),
    pytest.param(1 << 16, 6, 25, 10000, 19, id="one_group_cap65536")])
def test_chain_dp_kernel_matches_plain(dev, cap, B, H, max_gap, kk):
    """K4 (csrc/chain_dp.cu) against chain_dp_plain on the card, f and prev
    bit for bit, on simulate.chain_dp_inputs' tie-heavy groups (rows of 0,
    1 and cap anchors, duplicates, unit diagonals, no ok link; with B >= 6
    the duplicate and unit-diagonal rows run at long n), one launch a
    bucket; H 40 and 160 take the kernel's window from memory, and so
    does H 25 where the gap cost table (max_gap 60000) passes a block's
    shared memory."""
    qs, ts, ns = chain_dp_inputs(cap + H, B, cap, max_gap)
    args = [torch.from_numpy(x).to(dev) for x in (qs, ts, ns)]
    before = kernels.LAUNCHES["chain_dp"]
    f, prev = tchain.chain_dp(*args, H, max_gap, kk)
    assert kernels.LAUNCHES["chain_dp"] == before + 1
    wf, wp = tchain.chain_dp_plain(*args, H, max_gap, kk,
                                   tchain.gap_cost_table(max_gap, dev))
    assert np.array_equal(f.cpu().numpy().view(np.uint32),
                          wf.cpu().numpy().view(np.uint32))
    assert torch.equal(prev.cpu(), wp.cpu())
    assert (wp >= 0).sum() > cap // 2


def _residue_chains(x, step, n, cap):
    """One group of n anchors in x interleaved diagonal chains: anchor i
    lies on chain i mod x, `step` bases past the chain's previous anchor,
    and the chains lie 200,000 bases apart, so only links from i - h with
    h a multiple of x are ok, and those only while (h / x) * step <=
    max_gap. With step 1 every such h within kk ties, so the pick is
    h = x."""
    i = np.arange(n)
    pos = 100 + (i // x) * step + (i % x) * 200_000
    q = np.zeros(cap, np.int32)
    q[:n] = pos
    return q, q.copy()


# the kernel's split pick (csrc/chain_dp.cu): the kD = 2 nearest candidates
# on the serial chain, the first maximum over h > kD reduced ahead; the
# cases put the pick at h = 1 .. 3 and at H, on ties and alone, so that a
# near h must win a tie with the far maximum and the far maximum must
# take its smallest h
SPLIT_CASES = {
    "h1_ties_far_max": (1, 1), "h2_ties_farther": (2, 1),
    "h3_ties_farther": (3, 1), "only_h1": (1, 3333), "only_h2": (2, 3333),
    "only_h3": (3, 3333), "only_hH": (25, 3333)}


@pytest.mark.parametrize("case", [*SPLIT_CASES, "n_small", "tile_edges"])
def test_chain_dp_kernel_split_cases(dev, case):
    """K4 against chain_dp_plain, f and prev bit for bit, on groups built
    for the split pick and the kernel's 32-step tiles: the pick alone or
    tied at h = 1, 2, 3 and H = 25 (_residue_chains); groups of 0 to 4
    anchors; groups ending on either side of the first four tile edges
    (the q/t ring holds four tiles), with anchors past n left in place."""
    H, max_gap, kk, cap = 25, 5000, 15, 512
    if case in SPLIT_CASES:
        x, step = SPLIT_CASES[case]
        ns = np.array([cap, cap - 7, 300, 40], np.int32)
        rows = [_residue_chains(x, step, int(n), cap) for n in ns]
        qs = np.stack([r[0] for r in rows])
        ts = np.stack([r[1] for r in rows])
    else:
        qs, ts, ns = chain_dp_inputs(31, 24, cap, max_gap, edges=False)
        ns = np.array([0, 1, 2, 3, 4, 0, 1, 2] * 3 if case == "n_small" else
                      [31, 32, 33, 63, 64, 65, 95, 96, 97, 127, 128, 129,
                       159, 160, 161, 255, 256, 257, 30, 34, 62, 66, 511,
                       512], np.int32)
        # rows of every pattern take each length (chain_dp_inputs cycles
        # through four patterns by row)
        qs, ts = np.roll(qs, 1, axis=0), np.roll(ts, 1, axis=0)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (qs, ts, ns)]
    f, prev = tchain.chain_dp(*args, H, max_gap, kk)
    wf, wp = tchain.chain_dp_plain(*args, H, max_gap, kk,
                                   tchain.gap_cost_table(max_gap, dev))
    assert np.array_equal(f.cpu().numpy().view(np.uint32),
                          wf.cpu().numpy().view(np.uint32))
    assert torch.equal(prev.cpu(), wp.cpu())
    if case in SPLIT_CASES:   # the groups are as intended
        x = SPLIT_CASES[case][0]
        for b, n in enumerate(ns.tolist()):
            i = np.arange(x, n)
            assert (wp[b, x:n].cpu().numpy() == i - x).all()
    elif case == "tile_edges":
        assert (wp >= 0).sum() > 1000


def test_chain_kernel_on_card_launches_k4(dev, monkeypatch):
    """_chain_kernel on CUDA tensors makes one chain_dp launch and never
    runs the plain version."""
    def no_plain(*_a, **_k):
        raise AssertionError("plain version called on the card")

    monkeypatch.setattr(tchain, "chain_dp_plain", no_plain)
    qs, ts, ns = chain_dp_inputs(5, 40, 256, 5000)
    before = kernels.LAUNCHES["chain_dp"]
    f, prev = tlongread._chain_kernel(256, 25, 5000, 15)(
        *(torch.from_numpy(x).to(dev) for x in (qs, ts, ns)))
    assert kernels.LAUNCHES["chain_dp"] == before + 1
    assert f.is_cuda and prev.is_cuda and tuple(f.shape) == (40, 256)


def _prv(nxt: np.ndarray, dev):
    """The predecessor links of links nxt, as models/dbg.py:_rank_pass
    makes them, on `dev`."""
    nt = nxt[np.arange(len(nxt)) ^ 1]
    return torch.from_numpy(np.where(nt >= 0, nt ^ 1, -1)).to(dev)


def _tree_ptr(m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m)
    parent = np.where(rng.random(m) < 0.9,
                      rng.integers(0, np.maximum(np.arange(m), 1)), -1)
    parent[0] = -1
    ptr = np.full(m, -1, np.int64)
    ptr[perm] = np.where(parent >= 0, perm[np.maximum(parent, 0)], -1)
    return ptr


# (nodes, cycle share, mean chain, iters or None for the labeling's cap);
# 1 << 22 nodes: two buffers of 8.4 M records (134 MB) pass the 50 MB L2
RANK_CASES = {
    "chains": (700, 0.0, 40, None),
    "chains_capped": (700, 0.0, 200, 3),
    "cycles": (600, 0.3, 40, None),
    "one_long_cycle": (512, 1.0, 40, None),
    "cap_even": (600, 0.3, 40, 4),
    "all_dead": (128, 0.0, 1, None),
    "single_node": (1, 0.0, 40, None),
    "empty": (0, 0.0, 40, None),
    "main_path_size": (1 << 21, 0.0, 300, None),
    "main_path_half_cycle": (1 << 21, 0.5, 300, None),
    "beyond_l2": (1 << 22, 0.3, 300, None),
    "beyond_l2_capped": (1 << 22, 0.0, 5000, 5),
    "beyond_l2_all_dead": (1 << 22, 0.0, 1, None),
}


def _labeling_iters(m: int) -> int:
    import math

    from platanus_b_tpu_torch.models.dbg import _next_pow2
    return max(1, math.ceil(math.log2(max(_next_pow2(m // 2), 2))) + 1)


@pytest.mark.parametrize("case", [*RANK_CASES, "trees", "trees_capped"])
def test_list_rank_kernel_matches_plain(dev, case):
    """K5's pointer doubling from the links alone: ptr, rank and anchor
    bit for bit, with the steps that did work and the live flag, cycles,
    binding caps and buffers beyond L2 included."""
    if case.startswith("trees"):
        prv = torch.from_numpy(_tree_ptr(900, 15)).to(dev)
        iters = 2 if case == "trees_capped" else _labeling_iters(900)
    else:
        nodes, share, mean, iters = RANK_CASES[case]
        nxt = label_links(len(case), nodes, share, mean)
        if case.endswith("all_dead"):
            nxt[:] = -1
        prv = _prv(nxt, dev)
        iters = iters or _labeling_iters(2 * nodes)
    before = kernels.LAUNCHES["list_rank"]
    got = trank.rank_from_prev(prv, iters)
    assert kernels.LAUNCHES["list_rank"] == before + 1
    want = trank.rank_from_prev_plain(prv, iters)
    for g, w in zip(got[:3], want[:3]):
        assert g.is_cuda and torch.equal(g, w)
    live = int((want[0] >= 0).any())
    assert got[3].tolist() == [want[3], live]
    if "cycle" in case or case.endswith("capped"):
        assert live == 1 and want[3] == iters
    if case.endswith("all_dead"):
        assert got[3].tolist() == [0, 0]


@pytest.mark.parametrize("iters", [1, 2, 5, 22])
@pytest.mark.parametrize("nodes", [600, 1 << 21, 1 << 22])
def test_min_pair_kernel_matches_plain(dev, nodes, iters):
    """K5's min-pair loop over the cycle cut's inputs, both parities of
    iters, buffers within and beyond L2: the pairs bit for bit."""
    nxt = label_links(nodes + iters, nodes, 0.5, 300)
    prv = _prv(nxt, dev)
    ptr_rem = trank.rank_from_prev_plain(prv, 3)[0]
    m = 2 * nodes
    arange = torch.arange(m, device=dev)
    t_nxt = torch.from_numpy(nxt).to(dev)
    ea = torch.where(t_nxt >= 0, torch.minimum(arange, t_nxt ^ 1), m)
    eb = torch.where(t_nxt >= 0, torch.maximum(arange, t_nxt ^ 1), m)
    ptr = torch.where(ptr_rem >= 0, prv, -1)
    before = kernels.LAUNCHES["list_rank"]
    a, b = trank.cycle_min_pair(ptr, ea, eb, iters)
    assert kernels.LAUNCHES["list_rank"] == before + 1
    wa, wb = trank.cycle_min_pair_plain(ptr, ea, eb, iters)
    assert torch.equal(a, wa) and torch.equal(b, wb)
    assert not torch.equal(a, ea)       # the pairs moved


def test_min_pair_kernel_all_dead(dev):
    """No live pointer: every pair stays, at both parities of iters."""
    m = 1 << 23
    ptr = torch.full((m,), -1, dtype=torch.int64, device=dev)
    a = torch.randint(0, m, (m,), device=dev)
    b = torch.randint(0, m, (m,), device=dev)
    for iters in (1, 4, 7):
        got = trank.cycle_min_pair(ptr, a, b, iters)
        assert torch.equal(got[0], a) and torch.equal(got[1], b)


def test_list_rank_guards_raise(dev):
    """The card's 32-bit records: 2^30 ids or more than 30 steps raise
    before any launch, and the C entry points refuse them too."""
    big = torch.zeros(1, dtype=torch.int64, device=dev).expand(1 << 30)
    small = torch.full((8,), -1, dtype=torch.int64, device=dev)
    before = kernels.LAUNCHES["list_rank"]
    for args in ((big, 4), (small, 31)):
        with pytest.raises(ValueError):
            trank.rank_from_prev(*args)
        with pytest.raises(ValueError):
            trank.cycle_min_pair(args[0], args[0], args[0], args[1])
    assert kernels.LAUNCHES["list_rank"] == before
    out = [torch.empty_like(small) for _ in range(3)]
    with pytest.raises(kernels.KernelError):
        kernels.list_rank(small, 31, *out, torch.empty(2, dtype=torch.int64,
                                                       device=dev))
    with pytest.raises(kernels.KernelError):
        kernels.min_pair(small, small, small, 31, out[0], out[1])


def _search_tensors(seed, W, case, dev, cap=64, n_random=40):
    table, n, queries = search_inputs(seed, W, case, cap, n_random)
    return (tkeys.keys_from_words(table).to(dev),
            tkeys.keys_from_words(queries).to(dev), n)


@pytest.mark.parametrize("case", ["n0", "padded", "full", "dups"])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 6, 8, 10])
def test_lex_search_kernel_matches_plain(dev, W, case):
    """K6 in both modes against the plain versions on the same data: the
    padded table's rules (bounds of table_len + 1, SENTINEL queries,
    queries above the last row), no live row, duplicate runs; 1-5 lanes
    (5 compares from memory); every search inside the shared-memory
    tree (n below its size)."""
    tk, tq, n = _search_tensors(7 * W + len(case), W, case, dev)
    before = kernels.LAUNCHES["lex_search"]
    lo, hi = tsearch.lookup_range(tk, tq, n)
    assert kernels.LAUNCHES["lex_search"] == before + 1
    wlo, whi = tsearch.lookup_range_plain(tk, tq, n)
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)
    if case == "dups" or n == 0:
        return
    want = tsearch.lookup_plain(tk, tq, n)
    before = kernels.LAUNCHES["lex_search"]
    assert torch.equal(tsearch.lookup(tk, tq, n), want)
    assert kernels.LAUNCHES["lex_search"] == before + 1
    if case == "full":
        assert int(hi[-2]) == n + 1
        # a table view whose rows start off 16 bytes (one lane) is copied
        assert torch.equal(tsearch.lookup(tk[1:], tq, n - 1),
                           tsearch.lookup_plain(tk[1:], tq, n - 1))


@pytest.mark.parametrize("cap", [2047, 2049, 4095, 4097, 9000])
@pytest.mark.parametrize("case", ["padded", "full", "dups"])
@pytest.mark.parametrize("W", [1, 2, 4, 8, 10])
def test_lex_search_kernel_tree_edges(dev, W, case, cap):
    """Tables just below and above the shared-memory tree's rows (4095 at
    one lane, 2047 at two, 1023 at four, 511 at five): searches that end
    in the tree and searches that leave it, in both modes."""
    tk, tq, n = _search_tensors(W * cap + len(case), W, case, dev, cap=cap,
                                n_random=3000)
    lo, hi = tsearch.lookup_range(tk, tq, n)
    wlo, whi = tsearch.lookup_range_plain(tk, tq, n)
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)
    if case != "dups":
        for rows in (n, n - 1, (n + 1) // 2):
            want = tsearch.lookup_plain(tk, tq, rows)
            assert torch.equal(tsearch.lookup(tk, tq, rows), want)


def test_lex_search_one_lane_lookup_launches_k6(dev, monkeypatch):
    """On the card a one-lane lookup (k <= 32: the adjacency, the
    k-extension filters, kmer_divide, the sharded layer) launches K6 and
    never the plain searchsorted route."""
    tk, tq, n = _search_tensors(77, 2, "padded", dev, cap=1 << 16,
                                n_random=5000)
    assert tk.shape[1] == 1
    want = tsearch.lookup_plain(tk, tq, n)

    def no_plain(*_a, **_k):
        raise AssertionError("lookup_plain called on the card")

    monkeypatch.setattr(tsearch, "lookup_plain", no_plain)
    before = kernels.LAUNCHES["lex_search"]
    got = tsearch.lookup(tk, tq, n)
    hit = tsearch.contains(tk, tq, n)
    assert kernels.LAUNCHES["lex_search"] == before + 2
    assert torch.equal(got, want) and torch.equal(hit, want >= 0)


@pytest.mark.parametrize("W", [2, 3, 4, 6, 8, 10])
def test_lex_search_kernel_main_path_size(dev, W):
    """A graph's node table of 2^21 rows and as many queries (half of them
    present), and a padded index of the same capacity, at 1-5 lanes (one
    lane from two words: one word has too few distinct keys)."""
    tk, tq, n = _search_tensors(W, W, "full", dev, cap=1 << 21,
                                n_random=1 << 20)
    want = tsearch.lookup_plain(tk, tq, n)
    assert torch.equal(tsearch.lookup(tk, tq, n), want)
    tk, tq, n = _search_tensors(W + 1, W, "padded", dev, cap=1 << 21,
                                n_random=1 << 20)
    lo, hi = tsearch.lookup_range(tk, tq, n)
    wlo, whi = tsearch.lookup_range_plain(tk, tq, n)
    assert torch.equal(lo, wlo) and torch.equal(hi, whi)


def test_failed_launches_raise(dev):
    """A launch the C entry point refuses raises KernelError, never falls
    back."""
    x = torch.zeros(8, dtype=torch.int64, device=dev)
    out = [torch.empty_like(x) for _ in range(3)]
    with pytest.raises(kernels.KernelError):
        kernels.list_rank(x, 0, *out, torch.empty(2, dtype=torch.int64,
                                                  device=dev))
    with pytest.raises(kernels.KernelError):
        kernels.min_pair(x, x, x, 0, out[0], out[1])
    with pytest.raises(kernels.KernelError):
        kernels.unitig_sum(x, x, -1, torch.empty(1, device=dev))
    t = torch.zeros((4, 2), dtype=torch.int64, device=dev)
    with pytest.raises(kernels.KernelError):
        kernels.lex_search(t, t, 4, 0, kernels.LEX_LOOKUP,
                           torch.empty(4, dtype=torch.int64, device=dev))


def _circular_dbg(dev, k=33):
    """The port's DBG on the card from error-free reads of a circular
    genome and a linear one: junction-free cycles beside chains."""
    from platanus_b_tpu_torch.io.reads import pack_reads
    from platanus_b_tpu_torch.models.assemble_core import (count_reads_device,
                                                           stage_reads)
    from platanus_b_tpu_torch.models.dbg import DBG
    rng = np.random.default_rng(33)
    circle = simdata.random_genome(rng, 3000)
    line = simdata.random_genome(rng, 2000)
    src = circle + circle[:99]
    reads = [src[i:i + 100] for i in range(len(src) - 99)]
    reads += [line[i:i + 100] for i in range(0, len(line) - 99, 3)]
    keys, counts, _n, _h = count_reads_device(stage_reads([pack_reads(reads)],
                                                          dev), k)
    return DBG(k, keys, counts)


def test_labeling_on_card_launches_k5_k6_and_syncs_twice(dev, monkeypatch):
    """A labeling of a graph with cycles on the card: the adjacency's
    lookups launch lex_search, the doubling passes and the min-pair loop
    launch list_rank (3 launches), the count sums unitig_sum (1), and no
    plain version runs; the labeling reads the card exactly twice (the
    cycle flag and num_u), and equals the CPU labeling of the same
    graph."""
    import warnings

    from platanus_b_tpu_torch.models import dbg as tdbg

    g = _circular_dbg(dev)
    cpu = tdbg.DBG(g.k, g.keys.cpu(), g.counts.cpu())
    want = cpu.label_unitigs_device()

    def no_plain(*_a, **_k):
        raise AssertionError("plain version called on the card")

    before = dict(kernels.LAUNCHES)
    topo = g.topo
    assert kernels.LAUNCHES["lex_search"] == before["lex_search"] + 8
    monkeypatch.setattr(trank, "doubling_rank_plain", no_plain)
    monkeypatch.setattr(trank, "rank_from_prev_plain", no_plain)
    monkeypatch.setattr(trank, "cycle_min_pair_plain", no_plain)
    monkeypatch.setattr(tdbg, "unitig_count_sums_plain", no_plain)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            lab = tdbg._label_core(topo[0], topo[1], topo[3], topo[4],
                                   g.alive, g.counts, 12)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 2, [str(w.message) for w in syncs]
    assert kernels.LAUNCHES["list_rank"] == before["list_rank"] + 3
    assert kernels.LAUNCHES["unitig_sum"] == before["unitig_sum"] + 1
    got = g.label_unitigs_device()
    for f in ("uid", "upos", "uorient", "ulen", "ucov", "uhead", "utail"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert lab.num_u == want.num_u == got.num_u


def test_search_wrappers_do_not_sync(dev):
    """lookup (one lane and several), lookup_range and unitig_count_sums
    on the card issue no host sync."""
    from platanus_b_tpu_torch.models import dbg as tdbg
    tk, tq, n = _search_tensors(5, 4, "padded", dev)
    t1, q1, n1 = _search_tensors(5, 1, "padded", dev)
    uid = torch.randint(-1, 50, (5000,), device=dev)
    counts = torch.randint(0, 65_535, (5000,), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx = tsearch.lookup(tk, tq, n)
        idx1 = tsearch.lookup(t1, q1, n1)
        lo, hi = tsearch.lookup_range(tk, tq, n)
        hit = tsearch.contains(tk, tq, n)
        csum = tdbg.unitig_count_sums(uid, counts, 50)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(x.is_cuda for x in (idx, idx1, lo, hi, hit, csum))


# synchronizing calls of one save_contig_next_k on a labeled graph: the
# unitig sequences' length, the layout's length, the valid windows'
# compaction and dedup_max's run heads
SAVE_CONTIG_SYNCS = 4


def test_save_contig_next_k_on_card_is_the_cpu_table(dev):
    """The next-k contig table of a 60 kbp graph with junctions, laid out
    on the card, equals the CPU's; on an already-labeled graph it makes
    SAVE_CONTIG_SYNCS synchronizing calls, whatever the genome's size."""
    import warnings

    from platanus_b_tpu_torch.io.reads import pack_reads
    from platanus_b_tpu_torch.models import assemble_core as tcore
    rng = np.random.default_rng(60)
    genome = simdata.random_genome(rng, 60_000)
    reads = simdata.shotgun_reads(rng, genome, 100, 30.0, error_rate=0.005)
    table, _h = tcore.count_reads(tcore.stage_reads([pack_reads(reads)], dev),
                                  32)
    g = tcore.build_dbg_from_table(table, 2)
    cpu = tcore.build_dbg_from_table(
        tcore.KmerTable(32, table.keys.cpu(), table.counts.cpu()), 2)
    assert g.topo[4].any()
    want = tcore.save_contig_next_k(cpu, 42, 0.917)
    g.label_unitigs_device()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = tcore.save_contig_next_k(g, 42, 0.917)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == SAVE_CONTIG_SYNCS, syncs
    assert got.keys.is_cuda and len(want) > 50_000
    assert torch.equal(got.keys.cpu(), want.keys)
    assert torch.equal(got.counts.cpu(), want.counts)


# synchronizing calls of the cleaning replay on a labeled graph: the pull
# reads the junction list; a cut-branch round reads its ranking's cycle
# flag and its kill count; a delete iteration reads its two rankings'
# flags and the sum of its two rounds' kills; apply reads nothing
PULL_SYNCS, CUT_ROUND_SYNCS, DELETE_ITERATION_SYNCS, APPLY_SYNCS = 1, 2, 3, 0


@pytest.mark.parametrize("graph", ["families", "errors_60k"])
def test_cleaning_replay_on_card_is_the_cpu_replay(dev, monkeypatch, graph):
    """cut_branch_iterative, then delete_erroneous_iterative, on the card:
    the totals, the alive mask and the labeling afterwards equal the CPU
    run of the same graph (torch_families' genome, or 60 kbp at 0.5 %
    errors); the rankings launch list_rank and no plain version; each
    call's synchronizing calls are the pinned constants above, as its
    `  host replay` record's `reads` counts them."""
    import warnings

    from platanus_b_tpu_torch.io.reads import pack_reads
    from platanus_b_tpu_torch.models import assemble_core as tcore
    from platanus_b_tpu_torch.models import clean as tclean
    from platanus_b_tpu_torch.utils.log import LOG
    if graph == "families":
        reads = torch_families.families_reads()
    else:
        rng = np.random.default_rng(60)
        genome = simdata.random_genome(rng, 60_000)
        reads = simdata.shotgun_reads(rng, genome, 100, 30.0,
                                      error_rate=0.005)
    table, _h = tcore.count_reads(tcore.stage_reads([pack_reads(reads)], dev),
                                  32)
    g = tcore.build_dbg_from_table(table, 2)
    cpu = tcore.build_dbg_from_table(
        tcore.KmerTable(32, table.keys.cpu(), table.counts.cpu()), 2)
    monkeypatch.setattr(LOG, "spans", [])
    want = [tclean.cut_branch_iterative(cpu, 0.5)]
    args = (64, 0.5 * tclean.average_coverage_excluding_bubble(cpu) + 0.5,
            0.5)
    want.append(tclean.delete_erroneous_iterative(cpu, *args))
    assert want[0] > 0
    ref = cpu.label_unitigs_device()

    def no_plain(*_a, **_k):
        raise AssertionError("plain version called on the card")

    for name in ("doubling_rank_plain", "rank_from_prev_plain",
                 "cycle_min_pair_plain"):
        monkeypatch.setattr(trank, name, no_plain)
    caught, phases = {"warnings": []}, []

    def syncs():
        return sum("called a synchronizing CUDA operation" in str(w.message)
                   for w in caught["warnings"])

    def phase(name, fn):
        def run(*a, **k):
            before = syncs()
            out = fn(*a, **k)
            phases.append((name, syncs() - before))
            return out
        return run

    monkeypatch.setattr(tclean._ChainSim, "__init__",
                        phase("pull", tclean._ChainSim.__init__))
    monkeypatch.setattr(tclean._ChainSim, "apply",
                        phase("apply", tclean._ChainSim.apply))
    before = kernels.LAUNCHES["list_rank"]
    got = []
    for call, per_round, a in (
            (tclean.cut_branch_iterative, CUT_ROUND_SYNCS, (0.5,)),
            (tclean.delete_erroneous_iterative, DELETE_ITERATION_SYNCS,
             args)):
        g.label_unitigs_device()
        LOG.spans.clear()
        phases.clear()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught["warnings"]:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got.append(call(g, *a))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        replay, = [s.counters for s in LOG.spans if s.name == "  host replay"]
        total = PULL_SYNCS + per_round * replay["rounds"]
        assert phases[0] == ("pull", PULL_SYNCS)
        assert phases[1:] == ([("apply", APPLY_SYNCS)] if got[-1] else [])
        assert syncs() == replay["reads"] == total, [
            str(w.message) for w in caught["warnings"]]
    assert got == want
    assert kernels.LAUNCHES["list_rank"] > before
    assert torch.equal(g.alive.cpu(), cpu.alive)
    have = g.label_unitigs_device()
    for f in ("uid", "upos", "uorient", "ulen", "ucov", "uhead", "utail"):
        assert torch.equal(getattr(have, f).cpu(), getattr(ref, f)), f


# synchronizing calls on a labeled graph: average_coverage_excluding_bubble
# pulls its five sums at once; a crush_bubble round that aligns and crushes
# pulls the per-unitig labeling, the junction-pair groups and the flat
# sequences (their length, then the bases), moves the pairs' four rows and
# lengths to the card and their distances back, and moves the absorbed
# coverage and the kill mask, one entry a unitig, to the card
AVERAGE_COVERAGE_SYNCS, CRUSH_ROUND_SYNCS = 1, 1 + 1 + 2 + 5 + 2


def test_bubble_reads_on_card_are_per_unitig(dev):
    """average_coverage_excluding_bubble and one crush_bubble round on the
    families_het graph (torch_families at 0.5 % heterozygosity, its tips
    cut) on the card equal the CPU run of the same graph; each makes the
    pinned synchronizing calls above, none of which moves an array with
    one entry a node."""
    import warnings

    from platanus_b_tpu_torch.io.reads import pack_reads
    from platanus_b_tpu_torch.models import assemble_core as tcore
    from platanus_b_tpu_torch.models import clean as tclean
    reads = torch_families.families_reads(het=0.005)
    table, _h = tcore.count_reads(tcore.stage_reads([pack_reads(reads)], dev),
                                  32)
    g = tcore.build_dbg_from_table(table, 2)
    cpu = tcore.build_dbg_from_table(
        tcore.KmerTable(32, table.keys.cpu(), table.counts.cpu()), 2)
    for graph in (cpu, g):
        tclean.cut_branch_iterative(graph, 0.5)
    want_cov = tclean.average_coverage_excluding_bubble(cpu)
    want = []
    want_n = tclean.crush_bubble(cpu, want_cov, 0.1, want)
    assert want_n > 0

    def synced(fn, *a):
        g.label_unitigs_device()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn(*a)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [str(w.message) for w in caught
                     if "called a synchronizing CUDA operation"
                     in str(w.message)]

    cov, syncs = synced(tclean.average_coverage_excluding_bubble, g)
    assert len(syncs) == AVERAGE_COVERAGE_SYNCS, syncs
    assert cov == want_cov
    got = []
    n, syncs = synced(tclean.crush_bubble, g, cov, 0.1, got)
    assert len(syncs) == CRUSH_ROUND_SYNCS, syncs
    assert n == want_n
    assert [b.coverage for b in got] == [b.coverage for b in want]
    assert all(np.array_equal(x.seq, y.seq) for x, y in zip(got, want))
    assert torch.equal(g.counts.cpu(), cpu.counts)
    assert torch.equal(g.alive.cpu(), cpu.alive)


# K7: (uid, counts, num_u) of each case; "long_300k" is one unitig of
# 300,000 nodes with counts 60-99 summing to 23,849,980 (exact mean
# 79.49993, the float32 sum's mean 79.5002: ucov 80, the exact 79)
def _unitig_sum_case(case: str, dev):
    rng = np.random.default_rng(len(case))
    if case == "one_unitig_400":
        counts = coverage_counts(39, 400, 50_000, 65_534, 23_040_995)
        uid, num_u = np.zeros(400, np.int64), 1
    elif case == "long_300k":
        counts = coverage_counts(0, 300_000, 60, 99, 23_849_980)
        uid, num_u = np.zeros(300_000, np.int64), 1
    elif case == "interleaved_long":
        n, num_u = 1 << 20, 6000
        uid = rng.integers(-1, num_u, size=n)
        many = rng.random(n) < 0.5            # unitigs 0-2: long
        uid[many] = rng.integers(0, 3, size=int(many.sum()))
        uid[rng.random(n) < 0.1] = 7
        counts = rng.integers(0, 65_535, size=n)
    elif case == "main_path_short":
        n, num_u = 1 << 21, 60_000
        uid = rng.integers(-1, num_u, size=n)
        counts = rng.integers(0, 300, size=n)
    elif case == "odd_counts":
        n, num_u = 5000, 4
        uid = rng.integers(-1, num_u, size=n)
        counts = rng.integers(-5, 1 << 26, size=n)
    elif case == "no_nodes":
        uid, counts, num_u = np.zeros(0, np.int64), np.zeros(0, np.int64), 3
    elif case == "many_long_interleaved":
        num_u = 20_000
        uid, counts = interleaved_unitigs(7, 1 << 22, num_u, 12, 250_000,
                                          300_000, 60, 99)
    elif case == "binade_walk":
        # one unitig of 60,000 nodes, counts log-uniform up to 2^20: its
        # sum passes 2^24 and then 2^25 ... 2^31, ulps 2 to 256
        n, num_u = 60_000, 3
        uid = np.zeros(n, np.int64)
        uid[rng.random(n) < 0.02] = 1
        counts = (2.0 ** rng.uniform(0, 20, size=n)).astype(np.int64)
    elif case == "ties":
        # 2^24 - 1, then odd counts: inside [2^24, 2^25), where the ulp is
        # 2, every add is a tie
        n, num_u = 40_000, 2
        uid = np.zeros(n, np.int64)
        counts = 2 * rng.integers(0, 50, size=n) + 1
        counts[0] = (1 << 24) - 1
        uid[rng.random(n) < 0.1] = 1
        uid[0] = 0
    elif case == "negative_in_long":
        n, num_u = 300_000, 5
        uid = rng.integers(0, num_u, size=n)
        uid[rng.random(n) < 0.8] = 0
        counts = rng.integers(60, 100, size=n)
        counts[rng.choice(np.flatnonzero(uid == 0), 6, replace=False)] = \
            [-1000, -1, -77, -(1 << 20), -3, -50_000]
    elif case == "count_past_2p24":
        # more than 2^24 nodes: one unitig of 2^24 + 10 nodes, whose node
        # count a float32 count would round to 2^24
        n, num_u = (1 << 24) + 4096, 3
        uid = np.ones(n, np.int64)
        uid[:(1 << 24) + 10] = 0
        uid[-7:] = [-1, 2, 2, -1, 2, 2, 2]
        counts = np.zeros(n, np.int64)
        counts[rng.choice(n, 100, replace=False)] = rng.integers(1, 100, 100)
    else:
        raise KeyError(case)
    return (torch.from_numpy(uid.astype(np.int64)).to(dev),
            torch.from_numpy(counts.astype(np.int64)).to(dev), num_u)


@pytest.mark.parametrize("case", ["one_unitig_400", "long_300k",
                                  "interleaved_long", "main_path_short",
                                  "odd_counts", "no_nodes",
                                  "many_long_interleaved", "binade_walk",
                                  "ties", "negative_in_long",
                                  "count_past_2p24"])
def test_unitig_sum_kernel_matches_plain(dev, case):
    """K7 against the sequential float32 sum of the plain version, bit for
    bit, and its ulen against the exact node counts: unitigs above 2^24
    (one long one alone, several interleaved with thousands of short ones),
    sums carried across several binades, every add a tie, negative counts
    in a long unitig, counts outside [0, 2^24], no node, a unitig of more
    than 2^24 nodes."""
    from platanus_b_tpu_torch.models import dbg as tdbg
    uid, counts, num_u = _unitig_sum_case(case, dev)
    before = kernels.LAUNCHES["unitig_sum"]
    got = tdbg.unitig_count_sums(uid, counts, num_u)
    assert kernels.LAUNCHES["unitig_sum"] == before + 1
    got2, ulen = tdbg.unitig_count_sums(uid, counts, num_u, True)
    want = tdbg.unitig_count_sums_plain(uid.cpu(), counts.cpu(), num_u)
    assert got.is_cuda and got.dtype == torch.float32
    assert torch.equal(got.cpu(), want) and torch.equal(got2.cpu(), want)
    assert ulen.dtype == torch.int64
    assert torch.equal(ulen, tdbg._per_unitig_sum(uid, torch.ones_like(uid),
                                                   num_u))
    exact = tdbg._per_unitig_sum(uid, counts, num_u).cpu()
    if case in ("many_long_interleaved", "binade_walk", "ties",
                "negative_in_long"):
        assert (exact.double() != want.double()).any()    # rounding shows
    if case in ("one_unitig_400", "long_300k"):
        ulen = uid.shape[0]
        ucov = int(torch.floor(got / ulen + 0.5)[0])
        exact = int(torch.floor(counts.sum().to(torch.float32) / ulen + 0.5))
        assert (ucov, exact) == ((57603, 57602) if ulen == 400 else (80, 79))


def test_labeling_sums_are_one_device_op(dev):
    """The count sums of a labeling with no unitig above 2^24, ulen
    included, run as at most two device operations (one cooperative launch;
    a scratch's first zeroing), counted by torch.profiler."""
    from platanus_b_tpu_torch.models import dbg as tdbg
    g = _circular_dbg(dev)
    calls = []
    orig = tdbg.unitig_count_sums

    def keep(*args):
        calls.append(args)
        return orig(*args)

    tdbg.unitig_count_sums = keep
    try:
        g.label_unitigs()
    finally:
        tdbg.unitig_count_sums = orig
    (uid, counts, num_u, with_ulen), = calls
    assert with_ulen and num_u > 0
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for warm in (False, True):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            csum, ulen = tdbg.unitig_count_sums(uid, counts, num_u, True)
            torch.cuda.synchronize()
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        assert 1 <= len(ops) <= (1 if warm else 2), [e.name for e in ops]
    assert torch.equal(csum.cpu(), tdbg.unitig_count_sums_plain(
        uid.cpu(), counts.cpu(), num_u))


def test_unitig_sums_on_card_match_cpu(dev):
    """The 400-node unitig of a random 430 bp genome at k 31, counts
    summing to 23,040,995: the card's labeling and _chain_pull give the
    CPU's ucov (57603) and sums."""
    from platanus_b_tpu_torch.io.reads import pack_reads
    from platanus_b_tpu_torch.models import clean as tclean
    from platanus_b_tpu_torch.models.assemble_core import (count_reads_device,
                                                           stage_reads)
    from platanus_b_tpu_torch.models.dbg import DBG
    g = simdata.random_genome(np.random.default_rng(11), 430)
    reads = [g[i:i + 100] for i in range(len(g) - 99)]
    keys, _c, n, _h = count_reads_device(stage_reads([pack_reads(reads)],
                                                     dev), 31)
    assert int(n) == 400
    counts = torch.from_numpy(coverage_counts(39, 400, 50_000, 65_534,
                                              23_040_995))
    card = DBG(31, keys, counts.to(dev))
    cpu = DBG(31, keys.cpu(), counts)
    got, want = card.label_unitigs(), cpu.label_unitigs()
    assert got.num_unitigs == want.num_unitigs == 1
    assert got.ucov.tolist() == want.ucov.tolist() == [57603]
    assert torch.equal(tclean._chain_pull(card)[0].cpu(),
                       tclean._chain_pull(cpu)[0])


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


@pytest.mark.parametrize("het", [0.0, 0.005], ids=["families", "families_het"])
def test_families_on_card_write_the_cpu_bytes(dev, tmp_path, monkeypatch, het):
    """`assemble -k 32` on the 60 kbp genome with repeat families
    (torch_families.FAMILIES) on the card equals the CPU run; with a second
    haplotype at -u 0.1 the bubbles are crushed and aligned by K1."""
    simdata.write_fasta(tmp_path / "reads.fa",
                        torch_families.families_reads(het=het))
    monkeypatch.chdir(tmp_path)
    argv = ["assemble", "-f", "reads.fa", "-k", "32"]
    plain = [(tkmer, "extract_kmers_packed_plain")]
    outputs = ["contig.fa", "32merFrq.tsv"]
    if het:
        argv += ["-u", "0.1"]
        plain.append((talign, "edit_distance_plain"))
        outputs.append("contigBubble.fa")
    launched = _run_cpu_then_card(monkeypatch, argv, plain)
    assert launched["kmer_extract"] > 0
    assert (launched["edit_distance"] > 0) == bool(het)
    for name in outputs:
        want = (tmp_path / f"cpu_{name}").read_bytes()
        assert len(want) > 0
        assert (tmp_path / f"gpu_{name}").read_bytes() == want, name


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
