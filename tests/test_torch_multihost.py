"""The port's parallel/multihost.py at one process, against the JAX
package's: the cases of tests/test_multihost.py, each on both packages
with the same inputs and the same answers. Also: the native IO library
builds safely when several processes start at once.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from platanus_b_tpu.parallel import multihost as jmh
from platanus_b_tpu_torch.parallel import multihost as tmh

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jmh, "torch": tmh}


def _both(fn):
    """fn(module) on both packages; the answers must be equal."""
    got = {name: fn(mh) for name, mh in PACKAGES.items()}
    want, port = got["jax"], got["torch"]
    if isinstance(want, tuple):
        for w, p in zip(want, port, strict=True):
            np.testing.assert_array_equal(p, w)
            assert np.asarray(p).dtype == np.asarray(w).dtype
    else:
        assert port == want
    return port


def test_host_shard_partition():
    items = [f"f{i}" for i in range(10)]
    parts = [_both(lambda mh: mh.host_shard(items, index=i, count=3))
             for i in range(3)]
    assert sorted(x for p in parts for x in p) == sorted(items)
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1


def test_host_shard_single_process_identity():
    items = list(range(5))
    assert _both(lambda mh: mh.host_shard(items)) == items


def test_host_read_plan_small_files_round_robin(tmp_path):
    paths = []
    for i in range(4):
        p = tmp_path / f"r{i}.fa"
        p.write_text(">a\nACGT\n")
        paths.append(str(p))
    plans = [_both(lambda mh: mh.host_read_plan(paths, index=i, count=2))
             for i in range(2)]
    assert sorted(p for plan in plans for (p, s, e) in plan) == sorted(paths)
    assert all(s == 0 and e == -1 for plan in plans for (_, s, e) in plan)


def test_host_read_plan_splits_large_file(tmp_path):
    p = tmp_path / "big.fa"
    p.write_bytes(b"x" * 1000)
    plans = [_both(lambda mh: mh.host_read_plan([str(p)], min_chunk=100,
                                                index=i, count=4))
             for i in range(4)]
    ranges = sorted((s, e) for plan in plans for (_, s, e) in plan)
    assert ranges[0][0] == 0 and ranges[-1][1] == 1000
    for (_s0, e0), (s1, _e1) in zip(ranges, ranges[1:]):
        assert e0 == s1


def test_global_count_merge_sums_duplicates():
    keys = np.array([[1, 0], [2, 0], [2, 0], [3, 0], [1, 0]], np.uint32)
    counts = np.array([5, 7, 2, 1, 4], np.uint32)
    mk, mc = _both(lambda mh: mh.global_count_merge(keys, counts))
    assert mk.tolist() == [[1, 0], [2, 0], [3, 0]]
    assert mc.tolist() == [9, 9, 1] and mc.dtype == np.uint32


def test_global_count_merge_saturates():
    keys = np.array([[9, 9], [9, 9]], np.uint32)
    counts = np.array([0xFFFF - 2, 0xFFFF - 2], np.uint32)
    _mk, mc = _both(lambda mh: mh.global_count_merge(keys, counts))
    assert mc.tolist() == [0xFFFF - 1]


def test_global_count_merge_empty():
    keys = np.zeros((0, 2), np.uint32)
    counts = np.zeros((0,), np.uint32)
    mk, mc = _both(lambda mh: mh.global_count_merge(keys, counts))
    assert len(mk) == 0 and len(mc) == 0


@pytest.mark.parametrize("k", [8, 15, 16, 32, 48])
def test_shard_range_of(k):
    """Contiguous ranges of word 0 (left-aligned for k < 16), the same on
    both packages; at one process every row belongs to rank 0."""
    rng = np.random.default_rng(k)
    W = -(-k // 16)
    keys = rng.integers(0, 1 << 32, size=(500, W), dtype=np.uint64)
    keys[:, 0] &= (1 << min(2 * k, 32)) - 1
    keys = keys.astype(np.uint32)
    keys = keys[np.lexsort(tuple(keys[:, w] for w in range(W - 1, -1, -1)))]
    for n in (2, 3, 4):
        (dest,) = _both(lambda mh: (mh.shard_range_of(keys, n, k),))
        assert (np.diff(dest) >= 0).all() and set(dest) == set(range(n))
    (dest,) = _both(lambda mh: (mh.shard_range_of(keys, k=k),))
    assert not dest.any()


def test_global_count_merge_sharded_single_process():
    keys = np.array([[3, 1], [1, 0], [3, 1], [2, 5]], np.uint32)
    counts = np.array([0xFFFF - 2, 4, 6, 1], np.uint32)
    mk, mc = _both(lambda mh: mh.global_count_merge_sharded(keys, counts,
                                                            k=32))
    assert mk.tolist() == [[1, 0], [2, 5], [3, 1]]
    assert mc.tolist() == [4, 1, 0xFFFF - 1]


def test_single_process_collectives_identity():
    x = np.arange(6).reshape(2, 3)
    for name in ("host0_gather", "all_hosts_concat", "broadcast_from_host0",
                 "psum_histogram"):
        (got,) = _both(lambda mh: (getattr(mh, name)(x),))
        np.testing.assert_array_equal(got, x)
    assert _both(lambda mh: mh.process_count()) == 1
    assert _both(lambda mh: mh.process_index()) == 0
    assert _both(lambda mh: mh.initialize()) is False


def test_count_reads_sharded_runs_on_the_card_unless_asked(monkeypatch):
    """The device layer's host wrapper takes the rank's device from
    select_device: with no card and the CPU not asked for, it stops with
    the CLI's typed device error before any collective."""
    from platanus_b_tpu_torch import device
    from platanus_b_tpu_torch.parallel import sharding

    monkeypatch.delenv(device.ENV_VAR, raising=False)
    monkeypatch.setattr(device.torch.cuda, "is_available", lambda: False)
    with pytest.raises(device.DeviceError):
        sharding.count_reads_sharded(np.zeros((2, 40), np.uint8), 15)


def test_native_build_is_process_safe(tmp_path):
    """Four processes build the native IO library at once on a fresh
    checkout; each compiles into a temporary file of its own, so every one
    loads a whole library (one shared temporary name let a process rename
    another's half-written file into place, or fall back to Python)."""
    pkg = tmp_path / "native"
    pkg.mkdir()
    src = REPO / "platanus_b_tpu_torch" / "native"
    for name in ("__init__.py", "io_native.cpp"):
        shutil.copy(src / name, pkg / name)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import native; "
            "assert native.available(), 'no native library'; "
            "print(native.decode_reads(b'>a\\nACGTN\\n', 'fasta')[0])")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err
        assert out.strip() == "[0 1 2 3 4]"
    assert sorted(os.listdir(tmp_path / "build")) == [
        f"_io_native_{sys.implementation.cache_tag}.so"]
