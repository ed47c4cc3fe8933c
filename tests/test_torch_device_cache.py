"""The port's device hot-row cache (``distributed/ps/device_cache.py``) and
the device dedup against the JAX package's: the device rules on the same
rows, state and gradients, the slot directory over the same id sequence,
the eviction round trip, and the static-cap sort-unique.  The directory is
numpy in both packages and compares exactly; the rules compare at
rtol 1e-6 against JAX's (torch against XLA, f32 on the CPU) and exactly
against the port's host table."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.distributed.ps import device_cache as jdc
from paddle_tpu.rec import wide_deep as jwd
from paddle_tpu_torch.distributed.ps import LocalPsEndpoint, SparseTable
from paddle_tpu_torch.distributed.ps import device_cache as pdc
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.rec import wide_deep as pwd

torch.set_num_threads(1)

HYPER = dict(lr=0.1, eps=1e-8, l1=0.5, l2=0.02, lr_power=-0.5)


@pytest.mark.parametrize("rule", pdc.DEVICE_RULES)
def test_apply_rule_device_matches_jax(rule):
    """Three chained updates of each device rule (FTRL with exact zeros
    under l1) agree with JAX's to rtol 1e-6, and with the port's host
    table bit for bit: rows move between cache and table."""
    rng = np.random.RandomState(0)
    rows = rng.standard_normal((16, 4)).astype(np.float32) * 0.1
    names = pdc._STATE_SPEC[rule]
    pst = {k: torch.zeros(16, 4) for k in names}
    jst = {k: jnp.zeros((16, 4), jnp.float32) for k in names}
    prow, jrow = torch.from_numpy(rows), jnp.asarray(rows)
    host = SparseTable(dim=4, optimizer=rule, initializer="zeros", **HYPER)
    ids = np.arange(16)
    host.import_rows(ids, rows)
    for _ in range(3):
        g = rng.standard_normal((16, 4)).astype(np.float32)
        prow, pst = pdc.apply_rule_device(rule, prow, pst, torch.from_numpy(g),
                                          **HYPER)
        jrow, jst = jdc.apply_rule_device(rule, jrow, jst, jnp.asarray(g),
                                          **HYPER)
        host.push(ids, g)
    np.testing.assert_allclose(prow.numpy(), np.asarray(jrow), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(prow.numpy(), host.pull(ids))
    for k in names:
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-6, atol=1e-7)
    if rule == "ftrl":
        assert (prow.numpy() == 0).any()
    with pytest.raises(ValueError, match="cannot run rule"):
        pdc.apply_rule_device("adam", prow, pst, prow, lr=0.1)


def _directory_trace(mod):
    """Resolve, evict, roll back and re-resolve over one id sequence;
    returns every Resolution field, the directory's counters and items."""
    d = mod.SlotDirectory(capacity=24)
    rng = np.random.RandomState(4)
    out = []
    for step in range(12):
        uniq = np.unique(rng.randint(0, 60, 14))
        r = d.resolve(uniq)
        out.append([np.asarray(x) for x in r])
        if step % 4 == 3:
            d.rollback(r)
    ids, slots = d.items()
    return out, (d.hits, d.misses, d.evictions, d._n_used), ids, slots


def test_slot_directory_matches_jax():
    """The same resolve/rollback sequence (with sampled evictions) gives
    the JAX directory's slots, misses, victims, counters and contents; the
    batch's own ids are never victims; an oversized batch raises."""
    p, j = _directory_trace(pdc), _directory_trace(jdc)
    for a, b in zip(p[0], j[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert p[1] == j[1] and p[1][2] > 0
    np.testing.assert_array_equal(p[2], j[2])
    np.testing.assert_array_equal(p[3], j[3])
    d = pdc.SlotDirectory(capacity=4)
    d.resolve(np.array([1, 2, 3, 4]))
    r = d.resolve(np.array([1, 5]))
    assert 1 not in r.victim_ids and len(r.victim_ids) == 1
    used = d._n_used
    d.rollback(r)
    assert d.resolve(np.array([int(r.victim_ids[0])])).miss_idx.size == 0
    assert d._n_used == used
    with pytest.raises(RuntimeError, match="capacity"):
        d.resolve(np.array([10, 11, 12, 13, 14]))


def _drive_cache(cap, steps=6, opt="adagrad"):
    """A port cache over a local table: prepare, scatter, the device rule
    and its scatter, as the trainer's step does; then writeback_all."""
    client = LocalPsEndpoint()
    cache = pdc.DeviceEmbeddingCache(client, table_id=0, dim=4, capacity=cap,
                                     optimizer=opt, lr=0.1, device="cpu")
    ar = cache.init_arenas()
    rng = np.random.RandomState(0)
    for _ in range(steps):
        uniq = np.unique(rng.choice(200, size=30, replace=False))
        slots, ms, mr, mst = cache.prepare(uniq, ar)
        if ms is not None:
            cache.scatter(ar, ms, mr, mst)
        sl = torch.from_numpy(slots.astype(np.int64))
        st = {k: ar["state"][k][sl] for k in ar["state"]}
        g = torch.from_numpy(rng.standard_normal((len(uniq), 4))
                             .astype(np.float32))
        new_rows, new_st = pdc.apply_rule_device(opt, ar["rows"][sl], st, g,
                                                 **cache.hyper)
        ar["rows"][sl] = new_rows
        for k in new_st:
            ar["state"][k][sl] = new_st[k]
    cache.writeback_all(ar)
    return client.pull_sparse(0, np.arange(200)), cache


def test_cache_eviction_roundtrip_is_exact():
    """A 48-row cache (evicting every step) and a 4096-row one end with the
    same host table bit for bit: writeback and re-pull lose nothing; the
    device FTRL rule written back equals the host table's FTRL (rtol
    1e-5, JAX's tolerance); read_rows reads the live arena."""
    a, ca = _drive_cache(48)
    b, cb = _drive_cache(4096)
    assert ca.evictions > 0 and cb.evictions == 0
    np.testing.assert_array_equal(a, b)
    f, _ = _drive_cache(4096, opt="ftrl")
    t = SparseTable(dim=4, optimizer="ftrl", lr=0.1, seed=0)
    rng = np.random.RandomState(0)
    for _ in range(6):
        uniq = np.unique(rng.choice(200, size=30, replace=False))
        t.pull(uniq)
        t.push(uniq, rng.standard_normal((len(uniq), 4)).astype(np.float32))
    np.testing.assert_allclose(f, t.pull(np.arange(200)), rtol=1e-5,
                               atol=1e-6)
    client = LocalPsEndpoint()
    cache = pdc.DeviceEmbeddingCache(client, 0, 2, capacity=8, device="cpu")
    ar = cache.init_arenas()
    slots, ms, mr, mst = cache.prepare(np.array([3, 4]), ar)
    cache.scatter(ar, ms, mr, mst)
    ar["rows"][torch.from_numpy(slots.astype(np.int64))] += 1.0
    got = cache.read_rows(np.array([4, 3, 9]), ar)
    np.testing.assert_array_equal(got[:2], client.pull_sparse(0, [4, 3]) + 1)
    np.testing.assert_array_equal(got[2], client.pull_sparse(0, [9])[0])


def test_pad_helpers_match_jax():
    for n in (1, 3, 8, 9, 100, 1000, 4097, 37253, 70000):
        assert pdc.pad_adaptive(n) == jdc.pad_adaptive(n)
        assert pdc._pad_to_bucket(n) == jdc._pad_to_bucket(n)
    assert pdc.pad_adaptive(37253) == 40960


def test_sort_unique_static_matches_np_unique_and_jax():
    """The static-cap sort-unique gives np.unique's sorted ids and
    inverse map exactly, the occupancy counts of np.bincount, and JAX's
    sort_unique_static's outputs."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, size=(96,)).astype(np.int64)
    u_np, inv_np = np.unique(ids, return_inverse=True)
    u, inv, cnt, counts = pwd.sort_unique_static(torch.from_numpy(ids), 96)
    ju, jinv, jcnt, jcounts = jwd.sort_unique_static(jnp.asarray(ids), 96)
    cnt = int(cnt)
    assert cnt == len(u_np) == int(jcnt)
    np.testing.assert_array_equal(u[:cnt].numpy(), u_np)
    np.testing.assert_array_equal(inv.numpy(), inv_np)
    np.testing.assert_array_equal(counts[:cnt].numpy(), np.bincount(inv_np))
    np.testing.assert_array_equal(u[:cnt].numpy(), np.asarray(ju[:cnt]))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


def test_device_dedup_cap_grows_on_overflow():
    """A batch with far more uniques than the seeded octave re-runs one
    octave up instead of truncating (a truncation would gather wrong
    rows)."""
    snap = flags.flags_snapshot()
    try:
        flags.set_flags({"FLAGS_wide_deep_device_dedup": True})
        m = pwd.WideDeep(emb_dim=4, num_slots=4, dense_dim=3, hidden=(8,),
                         device="cpu")
        t = pwd.WideDeepTrainer(m, device="cpu")
        t.step(np.zeros((16, 4), np.int64), np.zeros((16, 3), np.float32),
               np.zeros((16, 1), np.float32))
        small = t._dedup_cap
        ids2 = np.arange(64, dtype=np.int64).reshape(16, 4)
        uniq, inv = t._dedup_device(ids2)
        assert t._dedup_cap > small
        u_np, inv_np = np.unique(ids2, return_inverse=True)
        np.testing.assert_array_equal(uniq, u_np)
        np.testing.assert_array_equal(inv.numpy(), inv_np.reshape(-1))
    finally:
        flags.flags_restore(snap)
