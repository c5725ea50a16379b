"""The bytes functions against the bounds PERF.md records for K2 and
K5-K7 at the shapes of their main-path calls (NVIDIA H100, 3.35 TB/s)."""

import pytest
import torch

from portbench import bounds


def meta(*shape, dtype=torch.int64):
    return torch.empty(shape, dtype=dtype, device="meta")


def ms(n_bytes):
    return 1e3 * n_bytes / bounds.HBM_BYTES_S


def test_k2_one_mbp():
    # 320,000 reads of 125 bp padded to 128 columns: 8 words a read, 94
    # windows of k 32 (one lane) each: 30.08 M windows
    R, P = 320_000, 94
    b = bounds.kmer_extract(meta(R, 8, dtype=torch.int32), None,
                            meta(R, dtype=torch.int32), 32, P, False,
                            meta(R, P, 1), meta(1))
    assert R * P == 30_080_000
    assert round(b / 1e6, 1) == 252.2
    assert round(ms(b), 4) == 0.0753


@pytest.mark.parametrize("m,mb,bound_ms", [(2_472_328, 79.1, 0.0236),
                                            (11_508_998, 368.3, 0.1099)])
def test_k5_doubling(m, mb, bound_ms):
    b = bounds.list_rank(meta(m), 22, meta(m), meta(m), meta(m), meta(2))
    assert round(b / 1e6, 1) == mb
    assert round(ms(b), 4) == bound_ms


def test_k5_min_pair():
    m = 2_472_328
    b = bounds.min_pair(meta(m), meta(m), meta(m), 22, meta(m), meta(m))
    assert round(ms(b), 4) == 0.0295


@pytest.mark.parametrize("rows,lanes,queries,cap,out1,bound_ms", [
    (1_236_164, 2, 1_236_164, 1_236_164, False, 0.0148),   # k-63 adjacency
    (1_035_342, 1, 1_035_342, 1_035_342, False, 0.0074),   # one lane, k 32
    (1_020_169, 1, 2_402_400, 1 << 20, True, 0.0196)])     # polish, range
def test_k6(rows, lanes, queries, cap, out1, bound_ms):
    q = meta(queries, lanes)
    b = bounds.lex_search(meta(cap, lanes), q, rows, 21, int(out1),
                          meta(queries), meta(queries) if out1 else None)
    assert round(ms(b), 4) == bound_ms


@pytest.mark.parametrize("nodes,unitigs,bound_ms", [
    (1_236_164, 13_185, 0.00595), (5_754_499, 64_267, 0.0277)])
def test_k7(nodes, unitigs, bound_ms):
    b = bounds.unitig_sum(meta(nodes), meta(nodes), unitigs,
                          meta(unitigs, dtype=torch.float32), meta(unitigs))
    assert round(ms(b), 5 if bound_ms < 0.01 else 4) == bound_ms


def _fake_trace(names_us, mark_host, mark_end):
    """A DeviceTrace whose profiler returns CUDA events (name, start us,
    end us), with the host clock read at the two markers' launches."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from portbench.devtrace import DeviceTrace
    t = DeviceTrace.__new__(DeviceTrace)
    events = [SimpleNamespace(name=n, device_type=DeviceType.CUDA,
                              time_range=SimpleNamespace(start=a, end=b))
              for n, a, b in names_us]
    t._prof = SimpleNamespace(events=lambda: events)
    t._mark_host, t._mark_end, t.ops = mark_host, mark_end, []
    return t


@pytest.mark.parametrize("marks,want_start", [
    ("both", 100.0 + 10e-6), ("end_only", 200.0 - 1e6 * 1e-6 + 10e-6),
    ("start_only", 100.0 + 10e-6)])
def test_device_trace_placed_by_either_marker(marks, want_start):
    # the opening marker at 0 us (host 100.0 s), a kernel at 10-20 us,
    # the closing marker at 1e6 us (host 101.0 s where both came back,
    # 200.0 s where only it did, so that the two placements differ)
    ev = [("kernel_a", 10.0, 20.0)]
    if marks in ("both", "start_only"):
        ev.insert(0, ("spin_kernel", 0.0, 1.0))
    if marks in ("both", "end_only"):
        ev.append(("spin_kernel", 1e6, 1e6 + 1))
    mark_end = 100.0 + 1.0 if marks == "both" else 200.0
    t = _fake_trace(ev, 100.0, mark_end)
    t._read()
    assert [o[0] for o in t.ops] == ["kernel_a"]
    assert t.ops[0][1] == pytest.approx(want_start, abs=1e-9)


def test_device_trace_without_markers_raises():
    t = _fake_trace([("kernel_a", 10.0, 20.0)], 100.0, 200.0)
    with pytest.raises(RuntimeError):
        t._read()
