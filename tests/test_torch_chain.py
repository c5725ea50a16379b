"""The chaining DP of the long-read aligner (ops/chain.py, the port of
platanus_b_tpu/models/longread.py:_chain_kernel) against the JAX package,
f and prev bit for bit, on anchor groups that are hard for the chain_dp
kernel's warp reduction (simulate.chain_dp_inputs): exact ties between
lookback offsets, where the nearest predecessor must win; duplicate
anchors; groups of 0, 1 and cap anchors; groups where every link fails
max_gap; a lookback above 32 (the kernel's strided lanes) and above 128
(its window read from memory). The kernel itself runs only on the card
(tests/test_torch_cuda.py); here the CPU path must never build it.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platanus_b_tpu.models import longread as jlongread
from platanus_b_tpu_torch import kernels
from platanus_b_tpu_torch.models import longread as tlongread
from platanus_b_tpu_torch.ops import chain as tchain
from platanus_b_tpu_torch.ops.gapcost import chain_gap_cost
from platanus_b_tpu_torch.simulate import chain_dp_inputs

CPU = torch.device("cpu")


def _tied_steps(qs, ts, ns, f, prev, H, max_gap, kk):
    """Steps whose winning score is reached by more than one offset h,
    each scored as the reference scores it (numpy float32); asserts that
    the nearest of them won."""
    table = chain_gap_cost(max_gap)
    tied = 0
    for b in range(len(ns)):
        q, t = qs[b].astype(np.int64), ts[b].astype(np.int64)
        for i in range(1, int(ns[b])):
            if prev[b, i] < 0:
                continue
            j = i - np.arange(1, min(i, H) + 1)
            dq, dt = q[i] - q[j], t[i] - t[j]
            ok = (dq > 0) & (dt > 0) & (dq <= max_gap) & (dt <= max_gap)
            gain = np.minimum(np.minimum(dq, dt), kk).astype(np.float32)
            cost = table[np.minimum(np.abs(dq - dt), max_gap)]
            cand = np.where(ok, (f[b, j] + gain) - cost, -np.inf)
            best = np.flatnonzero(cand == cand.max())
            assert prev[b, i] == j[best[0]]
            tied += len(best) > 1
    return tied


@pytest.mark.parametrize("cap,H,max_gap,kk", [
    pytest.param(16, 25, 5000, 15, id="cap16_H25"),
    pytest.param(64, 25, 5000, 15, id="cap64_H25"),
    pytest.param(256, 25, 5000, 15, id="cap256_H25_map-ont"),
    pytest.param(256, 40, 5000, 15, id="cap256_H40"),
    pytest.param(128, 40, 10000, 19, id="cap128_H40_asm10"),
    pytest.param(256, 160, 10000, 19, id="cap256_H160")])
def test_chain_dp_plain_matches_reference(cap, H, max_gap, kk):
    qs, ts, ns = chain_dp_inputs(cap + H, 16, cap, max_gap)
    jf, jp = jlongread._chain_kernel(cap, H, max_gap, kk)(
        jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns))
    tf, tp = tchain.chain_dp_plain(
        *(torch.from_numpy(x) for x in (qs, ts, ns)), H, max_gap, kk,
        tchain.gap_cost_table(max_gap, CPU))
    jf, jp, tf, tp = np.asarray(jf), np.asarray(jp), tf.numpy(), tp.numpy()
    assert np.array_equal(tf.view(np.uint32), jf.view(np.uint32))
    assert np.array_equal(tp, jp)
    # the groups are as hard as intended
    assert list(ns[:3]) == [0, 1, cap]
    assert (tp[:2] == -1).all() and (tf[:2] == np.float32(kk)).all()
    assert (tp[3::4] == -1).all()                  # no link within max_gap
    assert (tp >= 0).sum() > 4 * cap
    assert _tied_steps(qs, ts, ns, tf, tp, H, max_gap, kk) > cap


def test_chain_kernel_on_cpu_never_builds_the_kernels(monkeypatch):
    def no_build():
        raise AssertionError("kernels.library() called for CPU tensors")

    monkeypatch.setattr(kernels, "library", no_build)
    qs, ts, ns = chain_dp_inputs(3, 8, 32, 5000)
    before = kernels.LAUNCHES["chain_dp"]
    f, prev = tlongread._chain_kernel(32, 25, 5000, 15)(
        *(torch.from_numpy(x) for x in (qs, ts, ns)))
    assert kernels.LAUNCHES["chain_dp"] == before
    assert f.dtype == torch.float32 and prev.dtype == torch.int32
    assert f.shape == prev.shape == (8, 32)


def test_gap_cost_table_is_kept_per_device():
    table = tchain.gap_cost_table(5000, CPU)
    assert table is tchain.gap_cost_table(5000, CPU)
    assert np.array_equal(table.numpy().view(np.uint32),
                          chain_gap_cost(5000).view(np.uint32))


@pytest.mark.parametrize("bad", ["int64", "shape", "n", "lookback"])
def test_chain_dp_refuses_bad_inputs(bad):
    q = torch.zeros((2, 16), dtype=torch.int32)
    t, n, H = q.clone(), torch.zeros(2, dtype=torch.int32), 25
    if bad == "int64":
        q = q.long()
    elif bad == "shape":
        t = t[:, :8].contiguous()
    elif bad == "n":
        n = n[:1]
    else:
        H = 0
    with pytest.raises(ValueError):
        tchain.chain_dp(q, t, n, H, 5000, 15)


def _split_pick_dp(qs, ts, ns, H, max_gap, kk, D, raised):
    """The chaining DP in numpy with chain_dp.cu's split pick: at step i the
    first maximum of [cand(1), .., cand(D), M], M the first maximum over
    h > D, so that a near h wins a tie with M. With `raised`, every h > D
    candidate is first raised to kk, as the kernel raises them before its
    warp reduction, and M's h is the smallest h holding the raised
    maximum; f[i] is then max(the pick, kk)."""
    B, cap = qs.shape
    table = chain_gap_cost(max_gap)
    f = np.full((B, cap), np.float32(kk), np.float32)
    prev = np.full((B, cap), -1, np.int32)
    h = np.arange(1, H + 1)
    q, t = qs.astype(np.int64), ts.astype(np.int64)
    for i in range(1, cap):
        j = np.maximum(i - h, 0)
        dq, dt = q[:, i, None] - q[:, j], t[:, i, None] - t[:, j]
        ok = ((i - h >= 0)[None, :] & (i < ns)[:, None] & (dq > 0)
              & (dt > 0) & (dq <= max_gap) & (dt <= max_gap))
        gain = np.minimum(np.minimum(dq, dt), kk).astype(np.float32)
        cost = table[np.minimum(np.abs(dq - dt), max_gap)]
        cand = np.where(ok, (f[:, j] + gain) - cost, np.float32(-np.inf))
        far = cand[:, D:]
        if raised:
            far = np.maximum(far, np.float32(kk))
        if far.shape[1]:
            far_h = D + np.argmax(far, axis=1)
            far_v = far[np.arange(B), far_h - D]
        else:
            far_h = np.zeros(B, np.int64)
            far_v = np.full(B, -np.inf, np.float32)
        picks = np.concatenate([cand[:, :D], far_v[:, None]], axis=1)
        first = np.argmax(picks, axis=1)
        best = picks[np.arange(B), first]
        hb = np.where(first < D, first, far_h)
        better = best > f[:, i]
        f[:, i] = np.where(better, best, f[:, i])
        prev[:, i] = np.where(better, i - 1 - hb, prev[:, i])
    return f, prev


@pytest.mark.parametrize("raised", [False, True], ids=["split", "raised"])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("cap,H,max_gap,kk", [
    pytest.param(64, 25, 5000, 15, id="cap64_map-ont"),
    pytest.param(128, 25, 10000, 19, id="cap128_asm10"),
    pytest.param(48, 2, 5000, 15, id="cap48_H2")])
def test_split_pick_matches_argmax(cap, H, max_gap, kk, D, raised):
    """The algebra chain_dp.cu's register kernel rests on, where there is no
    card: the first maximum of the D nearest candidates and the first
    maximum over h > D (raised to kk or not) picks what argmax over all h
    picks, f and prev bit for bit against chain_dp_plain and the JAX
    package's _chain_kernel, on simulate.chain_dp_inputs' tie-heavy
    groups."""
    qs, ts, ns = chain_dp_inputs(cap + 7 * D + H, 16, cap, max_gap)
    sf, sp = _split_pick_dp(qs, ts, ns, H, max_gap, kk, D, raised)
    jf, jp = jlongread._chain_kernel(cap, H, max_gap, kk)(
        jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns))
    tf, tp = tchain.chain_dp_plain(
        *(torch.from_numpy(x) for x in (qs, ts, ns)), H, max_gap, kk,
        tchain.gap_cost_table(max_gap, CPU))
    for f, p in ((np.asarray(jf), np.asarray(jp)), (tf.numpy(), tp.numpy())):
        assert np.array_equal(sf.view(np.uint32), f.view(np.uint32))
        assert np.array_equal(sp, p)
    # ties the split must settle: the nearest of tied offsets, h <= D
    # against h > D among them
    assert _tied_steps(qs, ts, ns, sf, sp, H, max_gap, kk) > cap // 2
