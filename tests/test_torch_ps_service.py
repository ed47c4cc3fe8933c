"""The port's PS service, sharded client, communicators, distributed
embedding and file datasets against the JAX package's: the same tables
behind an in-process endpoint and behind sockets (servers on ``port=0``,
stopped in ``finally``), the same MultiSlot files and seeds.  Tables and
datasets are numpy in both packages, so rows and feeds compare bit for
bit; the embedding's forward compares at 1e-6 (torch against XLA)."""
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import dataset as jdataset
from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.distributed import dataset as pdataset
from paddle_tpu_torch.distributed import ps as pps

torch.set_num_threads(1)

TABLE = dict(dim=4, optimizer="adagrad", lr=0.1, seed=5)


def _train(client, steps=4, table=0):
    rng = np.random.RandomState(2)
    for _ in range(steps):
        ids = rng.randint(0, 50, 20)
        client.pull_sparse(table, ids)
        client.push_sparse(table, ids,
                           rng.standard_normal((20, 4)).astype(np.float32))
    return client.pull_sparse(table, np.arange(50))


def test_local_endpoint_matches_jax():
    """LocalPsEndpoint: pull, push, export/import and the dense table, the
    port's endpoint against the JAX package's, bit for bit."""
    p, j = pps.LocalPsEndpoint(), jps.LocalPsEndpoint()
    for c in (p, j):
        c.create_table(0, "sparse", **TABLE)
        c.create_table(7, "dense", shape=(2, 3), lr=0.5)
        c.push_dense(7, np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(_train(p), _train(j))
    np.testing.assert_array_equal(p.pull_dense(7), j.pull_dense(7))
    pr, pst = p.export_rows(0, np.arange(5))
    jr, jst = j.export_rows(0, np.arange(5))
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pst["acc"], jst["acc"])
    assert p.table_size(0) == j.table_size(0) == 50


def test_ps_server_client_pull_push_and_compressed_wire():
    """A port PsServer on port 0 serves a port PsClient and a JAX PsClient
    (the same wire): rows trained through the socket equal the local
    endpoint's; bf16-compressed pushes land within bf16 rounding;
    export/import stay full precision; an empty push is a no-op; a
    heartbeat-silent worker is evicted from a barrier."""
    srv = pps.PsServer(port=0, heartbeat_timeout=0.5).start()
    try:
        c = pps.PsClient(srv.endpoint)
        c.create_table(0, "sparse", **TABLE)
        local = pps.LocalPsEndpoint()
        local.create_table(0, "sparse", **TABLE)
        np.testing.assert_array_equal(_train(c), _train(local))
        jc = jps.PsClient(srv.endpoint)
        np.testing.assert_array_equal(jc.pull_sparse(0, np.arange(50)),
                                      local.pull_sparse(0, np.arange(50)))
        z = pps.PsClient(srv.endpoint, compress="bf16")
        z.create_table(1, "sparse", dim=4, optimizer="sgd", lr=1.0,
                       initializer="zeros")
        ids = np.arange(10)
        z.pull_sparse(1, ids)
        z.push_sparse(1, ids, np.full((10, 4), 0.5, np.float32))
        np.testing.assert_allclose(z.pull_sparse(1, ids), -0.5, rtol=1e-2)
        rows, state = z.export_rows(1, ids)
        z.import_rows(1, ids, rows * 2.0, state)
        np.testing.assert_array_equal(z.export_rows(1, ids)[0], rows * 2.0)
        z.push_sparse(1, np.array([], np.int64), np.zeros((0, 4), np.float32))
        assert z.table_size(1) == 10
        c.start_heartbeat(0, interval=0.1)
        z._call_fresh(op="heartbeat", worker_id=1)    # beats once, then dies
        time.sleep(1.0)
        assert c.barrier(0, expected=2, timeout=5.0) == [0]
        c.stop_heartbeat()
        with pytest.raises(ValueError, match="compress"):
            pps.PsClient(srv.endpoint, compress="fp8")
        for cl in (c, jc, z):
            cl.close()
    finally:
        srv.stop()


def test_sharded_client_matches_one_table():
    """ShardedPsClient over two port servers: rows split by id % 2, the
    trained rows equal one local table's at id // 2 of each shard, 2-D
    pulls keep their shape, export/import route by shard."""
    s0, s1 = pps.PsServer(port=0).start(), pps.PsServer(port=0).start()
    try:
        c = pps.ShardedPsClient([s0.endpoint, s1.endpoint])
        c.create_table(0, "sparse", dim=4, optimizer="sgd", lr=1.0,
                       initializer="zeros")
        ids = np.arange(10, dtype=np.int64)
        assert np.allclose(c.pull_sparse(0, ids), 0.0)
        assert len(s0._tables[0]) == len(s1._tables[0]) == 5
        c.push_sparse(0, ids, np.arange(40, dtype=np.float32).reshape(10, 4))
        rows = c.pull_sparse(0, ids)
        np.testing.assert_array_equal(
            rows, -np.arange(40, dtype=np.float32).reshape(10, 4))
        np.testing.assert_array_equal(c.pull_sparse(0, ids.reshape(2, 5)),
                                      rows.reshape(2, 5, 4))
        r, st = c.export_rows(0, ids[::-1])
        np.testing.assert_array_equal(r, rows[::-1])
        c.import_rows(0, ids, rows + 1.0, st)
        np.testing.assert_array_equal(c.pull_sparse(0, ids), rows + 1.0)
        assert c.table_size(0) == 10
        c.close()
    finally:
        s0.stop()
        s1.stop()


def test_communicators_match_jax():
    """Communicator (sync, async, half_async) and GeoCommunicator over
    local endpoints: the port's rows equal the JAX package's after the
    same pushes."""
    out = {}
    for name, ps in (("port", pps), ("jax", jps)):
        rows = []
        for mode in ("sync", "async", "half_async"):
            ep = ps.LocalPsEndpoint()
            ep.create_table(0, "sparse", dim=2, optimizer="sgd", lr=1.0,
                            initializer="zeros")
            ep.pull_sparse(0, np.array([1, 2, 3]))
            comm = ps.Communicator(ep, mode=mode, max_merge_var_num=8)
            for k in range(4):
                comm.push_sparse(0, np.array([1, 2, 1 + k % 3]),
                                 np.full((3, 2), 0.25 * (k + 1), np.float32))
            comm.flush()
            rows.append(ep.pull_sparse(0, np.array([1, 2, 3])))
        ep = ps.LocalPsEndpoint()
        ep.create_table(0, "sparse", dim=2, optimizer="sum",
                        initializer="zeros")
        geo = ps.GeoCommunicator(ep, table_id=0, dim=2, k_steps=2)
        ids = np.array([5, 9])
        geo.pull(ids)
        for _ in range(3):
            geo.apply_local(ids, np.ones((2, 2), np.float32), lr=0.5)
        rows += [ep.pull_sparse(0, ids), geo.pull(ids)]
        out[name] = rows
    for p, j in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(p, j)
    np.testing.assert_allclose(out["port"][3], -1.0)    # two local steps
    with pytest.raises(ValueError, match="geo"):
        pps.Communicator(pps.LocalPsEndpoint(), mode="geo")


def test_distributed_embedding_matches_jax():
    """DistributedEmbedding: the forward gathers the pulled rows (at
    1e-6 of the JAX layer's), the row block is a leaf whose gradient
    flush_grads pushes, and the tables after the push agree bit for bit
    (duplicate ids sum their gradients)."""
    ids = np.array([[7, 7, 3], [2, 3, 9]], np.int64)
    w = np.random.RandomState(1).standard_normal((2, 3, 4)).astype(np.float32)
    pc, jc = pps.LocalPsEndpoint(), jps.LocalPsEndpoint()
    pe = pps.DistributedEmbedding(pc, 0, 4, optimizer="sgd", lr=1.0,
                                  device="cpu")
    je = jps.DistributedEmbedding(jc, 0, 4, optimizer="sgd", lr=1.0)
    po = pe(torch.from_numpy(ids))
    jo = je(paddle.to_tensor(ids))
    np.testing.assert_allclose(po.detach().numpy(), jo.numpy(), rtol=1e-6,
                               atol=1e-6)
    (po * torch.from_numpy(w)).sum().backward()
    (jo * paddle.to_tensor(w)).sum().backward()
    pe.flush_grads()
    je.flush_grads()
    np.testing.assert_array_equal(pc.pull_sparse(0, np.arange(10)),
                                  jc.pull_sparse(0, np.arange(10)))
    assert pe.table_size() == je.table_size() == 10
    pe.eval()
    pe(torch.from_numpy(ids))
    assert pe._pending == []            # eval pulls push nothing


def _write_multislot(path, n, seed, dense_dim=3):
    """MultiSlot lines: one 1-id slot, one ragged slot, one dense slot,
    one label."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            k = rng.randint(1, 4)
            ids = " ".join(str(rng.randint(0, 50)) for _ in range(k))
            dense = " ".join(f"{v:.4f}" for v in rng.randn(dense_dim))
            f.write(f"1 {rng.randint(0, 100)} {k} {ids} {dense_dim} {dense} "
                    f"1 {rng.randint(0, 2)}\n")


SLOTS = [
    {"name": "slot_a", "type": "uint64"},
    {"name": "slot_b", "type": "uint64"},
    {"name": "dense", "type": "float", "is_dense": True, "shape": (3,)},
    {"name": "label", "type": "uint64"},
]


def _feeds(mod, files, kind, seed=None, batch=4, threads=2):
    ds = getattr(mod, kind)()
    ds.init(batch_size=batch, thread_num=threads)
    ds.set_slots(SLOTS)
    ds.set_filelist(files)
    if kind == "InMemoryDataset":
        ds.load_into_memory()
        if seed is not None:
            ds.set_shuffle_seed(seed)
            ds.local_shuffle()
    return list(ds)


def test_datasets_match_jax(tmp_path):
    """InMemoryDataset (threaded parse, seeded local_shuffle, ragged slot
    padding with ``.lens``) and QueueDataset give the JAX package's feed
    dicts for the same files and seed, key for key and bit for bit."""
    files = []
    for i in range(3):
        files.append(str(tmp_path / f"part{i}.txt"))
        _write_multislot(files[-1], 11 + i, seed=i)
    for kind, seed in (("InMemoryDataset", 7), ("InMemoryDataset", None),
                       ("QueueDataset", None)):
        p = _feeds(pdataset, files, kind, seed)
        j = _feeds(jdataset, files, kind, seed)
        assert len(p) == len(j) == 9
        for a, b in zip(p, j):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(NotImplementedError):
        pdataset.QueueDataset().local_shuffle()
    with pytest.raises(RuntimeError, match="load_into_memory"):
        iter(pdataset.InMemoryDataset())


def test_global_shuffle_exchange_speaks_the_jax_wire():
    """The global shuffle's peer exchange: a JAX sender's bucket reaches
    the port's exchange server under the round key (and the reverse); a
    delivery with a wrong key is refused before it is unpickled; a
    discarded round turns stragglers away.  Without a fleet the shuffle
    is the seeded local one."""
    key = b"k" * 16
    psrv = pdataset._shuffle_exchange()
    jsrv = jdataset._shuffle_exchange()
    recs = [(np.array([1], np.int64), np.array([0.5], np.float32))]
    psrv.expect("r1", 1, key)
    jdataset._ship_bucket(psrv.endpoint, "r1", 1, recs, key)
    got = psrv.collect("r1", timeout=10)
    assert len(got) == 1 and got[0][0][0] == 1
    jsrv.expect("r2", 1, key)
    pdataset._ship_bucket(jsrv.endpoint, "r2", 0, recs * 2, key)
    assert len(jsrv.collect("r2", timeout=10)) == 2
    psrv.expect("r3", 1, key)
    with pytest.raises(RuntimeError, match="bad mac"):
        pdataset._ship_bucket(psrv.endpoint, "r3", 1, recs, b"x" * 16)
    psrv.discard("r3")
    pdataset._ship_bucket(psrv.endpoint, "r3", 1, recs, key)   # stale: ok
    assert "r3" not in psrv._inbox
