"""The port's Wide&Deep CTR model and trainer (``rec/wide_deep.py``)
against the JAX package's: the JAX model drawn from ``paddle.seed``, its
state carried into the port's by ``load_jax_wide_deep``, the same seeded
batches through both trainers.  Tolerances are JAX's own between its
cached and pull/push modes (``tests/test_device_cache.py``): per-step
losses rtol 2e-4 / atol 1e-5, flushed table rows rtol 2e-3 / atol 2e-5,
and the dense parameters after the run rtol 2e-3 / atol 2e-5.  Port
against port (cache against pull/push, eviction, device dedup) is bit for
bit on the CPU."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.rec import wide_deep as jwd
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.framework.enforce import (InvalidArgumentError,
                                                UnimplementedError)
from paddle_tpu_torch.rec import wide_deep as pwd

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

SMALL = dict(hidden=(32,), emb_dim=4)
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)
ROW_TOL = dict(rtol=2e-3, atol=2e-5)


def _pair(seed, **kw):
    """A JAX WideDeep from ``seed`` and the port's on the CPU carrying its
    dense weights and tables."""
    paddle.seed(seed)
    jm = jwd.WideDeep(**kw)
    pm = pwd.WideDeep(device="cpu", **kw)
    pwd.load_jax_wide_deep(pm, jm)
    return jm, pm


def _batches(n=6, batch=128, vocab=50_000):
    return [jwd.synthetic_ctr_batch(batch, vocab=vocab, seed=s)
            for s in range(n)]


def _dense(model):
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _jax_dense(model):
    return {n: np.asarray(p.numpy()) for n, p in model.named_parameters()}


def test_forward_with_carried_state_matches_jax():
    """After load_jax_wide_deep both models compute the same logits (rtol
    1e-5, atol 1e-6) in eval and training forwards, on rows pulled lazily
    from both tables; a training forward's row gradients land in the
    tables through flush_sparse_grads."""
    jm, pm = _pair(3, **SMALL)
    ids, dense, _ = jwd.synthetic_ctr_batch(32, vocab=5_000, seed=1)
    jo = jm(paddle.to_tensor(ids), paddle.to_tensor(dense)).numpy()
    po = pm(torch.from_numpy(ids), dense)
    np.testing.assert_allclose(po.detach().numpy(), jo, rtol=1e-5, atol=1e-6)
    po.sum().backward()
    jm(paddle.to_tensor(ids), paddle.to_tensor(dense)).sum().backward()
    pm.flush_sparse_grads()
    jm.flush_sparse_grads()
    uniq = np.unique(ids)
    for t in (0, 1):
        np.testing.assert_allclose(pm.client.pull_sparse(t, uniq),
                                   jm.client.pull_sparse(t, uniq), **ROW_TOL)


@pytest.mark.parametrize("mode", ["cache", "pullpush", "async"])
def test_trainer_matches_jax(mode):
    """Six steps of each mode against JAX's WideDeepTrainer in the same
    mode: per-step losses, the dense parameters after the run and the
    flushed deep and wide table rows.  In async mode each trainer's
    pushes drain on its own thread and the next pull may read a row
    before or after its update ("one step stale"), so each package's
    losses would follow its thread's timing: a drain 50 ms late moves
    them by 11% of their value.  Both trainers are flushed after every
    step there, so both read the same rows; the pushes still go through
    the drain threads."""
    kw = {"cache": dict(device_cache=True),
          "pullpush": dict(device_cache=False),
          "async": dict(async_push=True)}[mode]
    jm, pm = _pair(17, **SMALL)
    jt = jwd.WideDeepTrainer(jm, feature_wire_dtype="float32", **kw)
    pt = pwd.WideDeepTrainer(pm, feature_wire_dtype="float32", device="cpu",
                             **kw)
    assert pt._use_cache == jt._use_cache == (mode == "cache")
    jl, pl = [], []
    for ids, dense, label in _batches():
        jl.append(jt.step(ids, dense, label))
        pl.append(pt.step(ids, dense, label))
        if mode == "async":
            jt.flush()
            pt.flush()
    jt.flush()
    pt.flush()
    pt.close()
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)
    jd, pd = _jax_dense(jm), _dense(pm)
    for n in jd:
        want = jd[n].T if jd[n].ndim == 2 else jd[n]
        np.testing.assert_allclose(pd[n], want, err_msg=n, **ROW_TOL)
    uniq = np.unique(np.concatenate([b[0].ravel() for b in _batches()]))
    for t in (0, 1):
        np.testing.assert_allclose(pm.client.pull_sparse(t, uniq),
                                   jm.client.pull_sparse(t, uniq), **ROW_TOL)


def _run(cap=1 << 18, steps=6, dedup=False, cached=True, vocab=200_000,
         seed=42, batch=128):
    snap = flags.flags_snapshot()
    try:
        flags.set_flags({"FLAGS_wide_deep_device_dedup": dedup})
        torch.manual_seed(seed)
        m = pwd.WideDeep(device="cpu", **SMALL)
        t = pwd.WideDeepTrainer(m, device_cache=cached, cache_capacity=cap,
                                device="cpu")
        losses = [t.step(*b) for b in _batches(steps, batch, vocab)]
        t.flush()
    finally:
        flags.flags_restore(snap)
    uniq = np.unique(np.concatenate([b[0].ravel()
                                     for b in _batches(steps, batch, vocab)]))
    return losses, m.client.pull_sparse(1, uniq), _dense(m), t


def test_cache_mode_equals_pullpush_eviction_and_dedup_bit_for_bit():
    """On the CPU the cached step is the pull/push step bit for bit (the
    device rule is the host rule's operations), a 2048-row cache that
    evicts ends where a 2^18-row one does, and the device dedup flag
    changes no bit; the tier counts attribute every unique id once."""
    base = _run()
    for other in (_run(cached=False), _run(cap=2048), _run(dedup=True)):
        assert other[0] == base[0]
        np.testing.assert_array_equal(other[1], base[1])
        for n in base[2]:
            np.testing.assert_array_equal(other[2][n], base[2][n])
    assert _run(cap=2048)[3]._d_cache.evictions > 0
    t = base[3]
    assert t._d_cache.evictions == 0
    assert sum(t.tier_hits.values()) == t._slot_dir.hits + t._slot_dir.misses
    assert t.tier_hits["host_ps"] == t._slot_dir.misses > 0


def test_eval_reads_through_cache_and_training_forward_refuses():
    """Eager eval reads the TRAINED rows through the cache before flush()
    and equals the forward over the flushed host tables; a training
    forward while the cache is bound raises."""
    torch.manual_seed(7)
    m = pwd.WideDeep(device="cpu", **SMALL)
    t = pwd.WideDeepTrainer(m, device="cpu")
    ids, dense, label = jwd.synthetic_ctr_batch(64, vocab=5_000, seed=0)
    for _ in range(4):
        t.step(ids, dense, label)
    with pytest.raises(RuntimeError, match="device cache"):
        m(ids, dense)
    m.eval()
    with torch.no_grad():
        cached = m(ids, dense).numpy()
        t.flush()
        for emb in (m.wide_emb, m.deep_emb):
            emb._cache_read = None
        host = m(ids, dense).numpy()
    np.testing.assert_array_equal(cached, host)


def test_failed_fill_rolls_back_the_step(monkeypatch):
    """export_rows failing mid-step (the deep table's fill) leaves the
    cache retryable: the retry re-misses, re-pulls and trains on real
    rows."""
    torch.manual_seed(3)
    m = pwd.WideDeep(device="cpu", hidden=(16,), emb_dim=4)
    t = pwd.WideDeepTrainer(m, device="cpu")
    t.step(*jwd.synthetic_ctr_batch(64, vocab=5_000, seed=0))
    ids2, dense2, label2 = jwd.synthetic_ctr_batch(64, vocab=5_000, seed=1)
    real = m.client.export_rows
    calls = {"n": 0}

    def flaky(table_id, ids_):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("transient pserver failure")
        return real(table_id, ids_)

    monkeypatch.setattr(m.client, "export_rows", flaky)
    misses = t._slot_dir.misses
    with pytest.raises(RuntimeError, match="transient"):
        t.step(ids2, dense2, label2)
    monkeypatch.setattr(m.client, "export_rows", real)
    assert np.isfinite(t.step(ids2, dense2, label2))
    new = len(np.setdiff1d(np.unique(ids2), np.unique(
        jwd.synthetic_ctr_batch(64, vocab=5_000, seed=0)[0])))
    assert t._slot_dir.misses == misses + 2 * new
    t.flush()
    assert np.isfinite(m.client.pull_sparse(1, np.unique(ids2))).all()


def test_trainer_mode_errors_and_refusals(monkeypatch):
    """The constructor's mode errors (as JAX's), the refused sharded table
    and mesh (ROADMAP A12), a trainer on another device than its model,
    and the in-graph probe on the CPU or outside cache mode."""
    m = pwd.WideDeep(device="cpu", **SMALL)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pwd.WideDeepTrainer(m, async_push=True, device_cache=True,
                            device="cpu")
    t = pwd.WideDeepTrainer(m, async_push=True, device="cpu")
    assert not t._use_cache
    t.close()
    ftrl = pwd.WideDeep(device="cpu", sparse_optimizer="adam", **SMALL)
    with pytest.raises(ValueError, match="device_cache"):
        pwd.WideDeepTrainer(ftrl, device_cache=True, device="cpu")
    assert not pwd.WideDeepTrainer(ftrl, device="cpu")._use_cache
    with pytest.raises(UnimplementedError, match="ROADMAP A12"):
        pwd.WideDeepTrainer(m, sharded_embedding=True, device="cpu")
    with pytest.raises(UnimplementedError, match="ROADMAP A12"):
        pwd.WideDeepTrainer(m, mesh=object(), device="cpu")
    snap = flags.flags_snapshot()
    try:
        flags.set_flags({"FLAGS_sharded_embedding": True})
        with pytest.raises(UnimplementedError, match="ROADMAP A12"):
            pwd.WideDeepTrainer(m, device="cpu")
    finally:
        flags.flags_restore(snap)
    with monkeypatch.context() as mp:
        mp.setattr(pwd, "resolve_device", lambda d=None: torch.device("meta"))
        with pytest.raises(InvalidArgumentError, match="its model on cpu"):
            pwd.WideDeepTrainer(m)
    t = pwd.WideDeepTrainer(m, device="cpu")
    ids, dense, label = jwd.synthetic_ctr_batch(16, vocab=1_000, seed=0)
    with pytest.raises(Exception, match="card"):
        t.in_graph_step_s(ids, dense, label)
    with pytest.raises(RuntimeError, match="device-cache mode"):
        pwd.WideDeepTrainer(m, device_cache=False,
                            device="cpu").in_graph_step_s(ids, dense, label)


def test_ctr_data_path_matches_jax(tmp_path):
    """write_ctr_files → ctr_dataset → load_into_memory → local_shuffle →
    batch_from_feed gives the JAX package's (ids, dense, label) bit for
    bit, and the port's files are the JAX package's byte for byte."""
    out = {}
    for name, mod in (("port", pwd), ("jax", jwd)):
        files = mod.write_ctr_files(str(tmp_path / name), 96, n_files=3,
                                    seed=4)
        ds = mod.ctr_dataset(files, batch_size=40)
        ds.load_into_memory()
        ds.set_shuffle_seed(9)
        ds.local_shuffle()
        out[name] = ([mod.batch_from_feed(f) for f in ds],
                     [open(f).read() for f in files])
    assert out["port"][1] == out["jax"][1]
    assert len(out["port"][0]) == 3
    for a, b in zip(out["port"][0], out["jax"][0]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
