"""The port's edit distance (plain version of the edit_distance kernel)
against the JAX package: the Pallas banded kernel in interpret mode, as
tests/test_pallas_align.py runs it, and edit_distance_batch. Exact.

Also the two facts the kernel's design rests on: its division-free band
start equals the division formula, and computing only the first
min(bw, qlen) cells of a pair changes nothing; and, for the phasing flow,
that the host DP at band 64 (the CPU path) and the band-128 edit distance
(the card path) measure its segments alike."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from platanus_b_tpu.ops.align import edit_distance_batch as j_batch
from platanus_b_tpu.ops.align import edit_distance_np
from platanus_b_tpu.ops.pallas_align import banded_edit_distance as j_banded
from platanus_b_tpu.models.hetero import align_scaffold as j_align_scaffold
from platanus_b_tpu_torch.models import hetero as thetero
from platanus_b_tpu_torch.models.longread import SEG_BAND, LongReadAligner
from platanus_b_tpu_torch.ops import align as talign
from platanus_b_tpu_torch.simulate import simulate_phase_contigs


def _mutate(rng, s, n_sub, n_ins, n_del):
    s = list(s)
    for _ in range(n_sub):
        i = rng.integers(0, len(s))
        s[i] = (s[i] + rng.integers(1, 4)) % 4
    for _ in range(n_ins):
        s.insert(rng.integers(0, len(s) + 1), rng.integers(0, 4))
    for _ in range(n_del):
        del s[rng.integers(0, len(s))]
    return np.array(s, np.uint8)


def _seven_cases():
    """The inputs, bands and expectations of tests/test_pallas_align.py."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, size=200, dtype=np.uint8)
    b = a.copy()
    b[50] = (b[50] + 1) % 4
    yield "simple_edits", [a, a, a], [a, b, np.delete(a, 100)], 64, \
        lambda g, qs, ts: g == [0, 1, 1]
    rng = np.random.default_rng(1)
    qs, ts = [], []
    for _ in range(13):
        n = int(rng.integers(20, 150))
        x = rng.integers(0, 4, size=n, dtype=np.uint8)
        qs.append(x)
        ts.append(_mutate(rng, x, int(rng.integers(0, 6)),
                          int(rng.integers(0, 3)), int(rng.integers(0, 3))))
    yield "oracle", qs, ts, 64, lambda g, qs, ts: g == [
        edit_distance_np(x, y) for x, y in zip(qs, ts)]
    rng = np.random.default_rng(2)
    x = rng.integers(0, 4, size=60, dtype=np.uint8)
    y = rng.integers(0, 4, size=60, dtype=np.uint8)
    yield "unrelated", [x], [y], 128, \
        lambda g, qs, ts: g == [edit_distance_np(qs[0], ts[0])]
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, size=300, dtype=np.uint8)
    yield "length_skew", [x], [x[40:260]], 192, lambda g, qs, ts: g == [80]
    yield "n_codes", [np.full(30, 4, np.uint8)], [np.zeros(30, np.uint8)], 64, \
        lambda g, qs, ts: g == [30]
    e = np.zeros(0, np.uint8)
    f = np.arange(4, dtype=np.uint8) % 4
    yield "empty", [e, f, e], [f, e, e], 64, lambda g, qs, ts: g == [4, 4, 0]
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, size=400, dtype=np.uint8)
    y = np.concatenate([rng.integers(0, 4, size=100, dtype=np.uint8), x])
    yield "too_narrow", [x], [y], 128, \
        lambda g, qs, ts: g[0] >= edit_distance_np(qs[0], ts[0])


CASES = {c[0]: c[1:] for c in _seven_cases()}


@pytest.mark.parametrize("name", list(CASES))
def test_pallas_cases_match_jax(name):
    qs, ts, band, expect = CASES[name]
    got = talign.banded_edit_distance(qs, ts, band=band, device="cpu")
    want = j_banded(qs, ts, band=band)
    assert got.dtype == np.int32
    assert got.tolist() == np.asarray(want).tolist()
    assert expect(got.tolist(), qs, ts)


@pytest.mark.parametrize("band", [64, 128, 192])
def test_random_pairs_match_jax(band):
    """Includes pairs whose optimal path leaves the band: the upper bounds
    must be equal too."""
    rng = np.random.default_rng(band)
    qs, ts = [], []
    for i in range(11):
        n = int(rng.integers(30, 200))
        x = rng.integers(0, 4, size=n, dtype=np.uint8)
        if i % 3 == 0:   # a shifted copy: far off the diagonal
            y = np.concatenate([rng.integers(0, 4, size=int(rng.integers(60, 160)),
                                             dtype=np.uint8), x])
        else:
            y = _mutate(rng, x, int(rng.integers(0, 8)), int(rng.integers(0, 5)),
                        int(rng.integers(0, 5)))
        if i == 4:
            x = x.copy()
            x[::7] = 4
        qs.append(x)
        ts.append(y)
    got = talign.banded_edit_distance(qs, ts, band=band, device="cpu")
    want = np.asarray(j_banded(qs, ts, band=band))
    assert got.tolist() == want.tolist()
    exact = [edit_distance_np(x, y) for x, y in zip(qs, ts)]
    assert all(g >= e for g, e in zip(got.tolist(), exact))


def test_edit_distance_batch_matches_jax():
    """Bubble-shaped batches: branch middles of similar length, padded."""
    rng = np.random.default_rng(9)
    P = 21
    a_rows, b_rows = [], []
    for _ in range(P):
        n = int(rng.integers(1, 90))
        x = rng.integers(0, 4, size=n, dtype=np.uint8)
        y = _mutate(rng, x, int(rng.integers(0, 4)), int(rng.integers(0, 3)),
                    int(rng.integers(0, min(3, n))))
        a_rows.append(x)
        b_rows.append(y)
    a_rows[3] = np.zeros(0, np.uint8)
    la = np.array([len(x) for x in a_rows], np.int32)
    lb = np.array([len(y) for y in b_rows], np.int32)
    A = np.zeros((P, 128), np.uint8)
    B = np.zeros((P, 128), np.uint8)
    for r in range(P):
        A[r, : la[r]] = a_rows[r]
        B[r, : lb[r]] = b_rows[r]
    want = np.asarray(j_batch(jnp.asarray(A), jnp.asarray(la),
                              jnp.asarray(B), jnp.asarray(lb)))
    got = talign.edit_distance_batch(torch.from_numpy(A), torch.from_numpy(la),
                                     torch.from_numpy(B), torch.from_numpy(lb))
    assert got.numpy().tolist() == want.tolist()
    assert want.tolist() == [edit_distance_np(x, y) for x, y in zip(a_rows, b_rows)]


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        talign.edit_distance(q.to(torch.int32), q, lens, lens, 128)
    with pytest.raises(ValueError):
        talign.edit_distance(q, q, lens.to(torch.int64), lens, 128)
    with pytest.raises(ValueError):
        talign.edit_distance(q, q[:1], lens, lens, 128)


def _band_starts_by_division(qlen, tlen, bw):
    denom = max(qlen + tlen - 1, 1)
    return [max(d * qlen // denom - bw // 2, 0)
            for d in range(qlen + tlen - 1)]


def _band_starts_by_remainder(qlen, tlen, bw):
    """csrc/edit_distance.cu's recurrence: ic(d) = d*qlen // denom carried
    with a remainder, no division."""
    denom = qlen + tlen - 1
    ic = rem = 0
    starts = []
    for _d in range(qlen + tlen - 1):
        starts.append(max(ic - bw // 2, 0))
        rem += qlen
        if rem >= denom:
            rem -= denom
            ic += 1
    return starts


@pytest.mark.parametrize("qlen,tlen", [(1, 1), (1, 9), (9, 1), (1, 700),
                                       (700, 1), (2, 3), (37, 41),
                                       (300, 20), (1000, 1048), (133, 1)])
@pytest.mark.parametrize("bw", [1, 7, 128, 384])
def test_band_start_recurrence_matches_division(qlen, tlen, bw):
    got = _band_starts_by_remainder(qlen, tlen, bw)
    assert got == _band_starts_by_division(qlen, tlen, bw)
    steps = np.diff([0, *got])
    assert set(steps.tolist()) <= {0, 1}


def _skewed_pairs(rng, n_pairs):
    """Random pairs: mutated copies, qlen >> tlen and tlen >> qlen, N codes,
    one-base pairs and empty sides."""
    qs, ts = [], []
    for i in range(n_pairs):
        n = int(rng.integers(1, 260))
        x = rng.integers(0, 4, size=n, dtype=np.uint8)
        kind = i % 6
        if kind == 0:
            y = _mutate(rng, x, 4, 2, min(2, n - 1))
        elif kind == 1:      # tlen >> qlen
            y = np.concatenate([rng.integers(0, 4, size=int(rng.integers(
                50, 300)), dtype=np.uint8), x])
        elif kind == 2:      # qlen >> tlen
            y = x[: max(1, n // 9)].copy()
        elif kind == 3:
            x = x[:1].copy()
            y = rng.integers(0, 4, size=int(rng.integers(1, 3)),
                             dtype=np.uint8)
        elif kind == 4:
            y = _mutate(rng, x, 2, 1, 0)
            x = x.copy()
            x[::6] = 4
        else:
            y = rng.integers(0, 4, size=int(rng.integers(1, 260)),
                             dtype=np.uint8)
        qs.append(x)
        ts.append(y)
    qs[3] = np.zeros(0, np.uint8)
    ts[4] = np.zeros(0, np.uint8)
    return qs, ts


@pytest.mark.parametrize("bw", [3, 33, 128, 256, 384])
def test_width_limited_plain_matches_full_and_jax(bw):
    """Only the first min(bw, qlen) cells of each pair computed: the same
    distances as the whole band, and as the Pallas kernel where bw is one
    of its widths."""
    rng = np.random.default_rng(bw)
    qs, ts = _skewed_pairs(rng, 30)
    q, ql = talign._pad_rows(qs, "cpu")
    t, tl = talign._pad_rows(ts, "cpu")
    full = talign.edit_distance_plain(q, t, ql, tl, bw)
    limited = talign.edit_distance_plain(q, t, ql, tl, bw, width_limited=True)
    assert limited.tolist() == full.tolist()
    if talign.band_width(bw) == bw:
        assert full.tolist() == np.asarray(j_banded(qs, ts, band=bw)).tolist()


def test_phase_segments_host_band64_equals_plain_band128(monkeypatch,
                                                         tmp_path):
    """The phasing flow's segment verification at small size: each segment
    the CPU path measures with the host DP at band SEG_BAND // 2 (the JAX
    package's and the port's hetero.align_scaffold) gets the same distance
    from the band-SEG_BAND edit distance the card runs."""
    path = tmp_path / "contigs.fa"
    simulate_phase_contigs(str(path), 20_000, 12_000, 0.003, 5)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    seqs = [lut[np.frombuffer(line.strip().encode(), np.uint8)]
            for line in path.read_text().splitlines()[1::2]]
    seen = []
    host = thetero.align_scaffold

    def recording(q, t, threshold):
        if threshold == SEG_BAND // 2:
            seen.append((q, t))
        return host(q, t, threshold)

    monkeypatch.setattr(thetero, "align_scaffold", recording)
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    aligner = LongReadAligner(seqs, ["0", "1", "2"], "asm10")
    aligner.align_batch(seqs[1:], ["1", "2"])
    assert len(seen) > 20
    qs, ts = [s[0] for s in seen], [s[1] for s in seen]
    want = [min(j_align_scaffold(q, t, SEG_BAND // 2), max(len(q), len(t)))
            for q, t in seen]
    got = talign.banded_edit_distance(qs, ts, band=SEG_BAND, device="cpu")
    assert got.tolist() == want
    assert max(want) > 0
