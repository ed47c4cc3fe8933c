"""The port's parameter-server tables and wire codecs against the JAX
package's (``paddle_tpu.distributed.ps``): the same ids, gradients and
seeds through both, every rule of ``_STATE_SPEC``.  Both are numpy, so
every comparison is bit for bit."""
import numpy as np
import pytest

from paddle_tpu.distributed.ps import codec as jcodec
from paddle_tpu.distributed.ps import table as jtable
from paddle_tpu_torch.distributed.ps import codec as pcodec
from paddle_tpu_torch.distributed.ps import table as ptable

RULES = ("sum", "sgd", "adagrad", "adam", "ftrl", "proximal_gd",
         "proximal_adagrad", "decayed_adagrad", "dpsgd")
# hyper-parameters that make every branch of each rule run: l1 > 0 (the
# shrink and FTRL's exact zeros), a general lr_power, dpsgd's clip and
# noise
HYPER = dict(lr=0.1, l1=0.01, l2=0.02, lr_power=-0.5, decay=0.9, clip=1.0,
             sigma=0.5, batch_size=8.0)


def _drive(mod, rule, steps=5, **over):
    """Pulls and pushes (duplicate ids inside a push, ids that first
    appear mid-run) through one table; returns its state_dict, the final
    rows and one export."""
    kw = dict(HYPER, **over)
    t = mod.SparseTable(dim=4, optimizer=rule, seed=3, init_scale=0.5, **kw)
    rng = np.random.RandomState(11)
    for s in range(steps):
        ids = rng.randint(0, 40 + 10 * s, 24)
        t.pull(ids)
        g = rng.standard_normal((24, 4)).astype(np.float32)
        t.push(ids, g)
    ids = np.arange(60)
    return t.state_dict(), t.pull(ids), t.export_rows(ids)


@pytest.mark.parametrize("rule", RULES)
def test_sparse_table_rule_matches_jax(rule):
    """Each of the nine rules: the port's table and the JAX package's, the
    same seed, ids and gradients, agree bit for bit in rows, optimizer
    state and step count (dpsgd's noise is the same RandomState's draws)."""
    over = {"lr_power": -0.3} if rule == "ftrl" else {}
    ps, prow, (pr, pst) = _drive(ptable, rule, **over)
    js, jrow, (jr, jst) = _drive(jtable, rule, **over)
    np.testing.assert_array_equal(prow, jrow)
    np.testing.assert_array_equal(pr, jr)
    assert sorted(pst) == sorted(jst) == sorted(ptable._STATE_SPEC[rule])
    for k in pst:
        np.testing.assert_array_equal(pst[k], jst[k])
    assert ps["step"] == js["step"] and ps["rows"].keys() == js["rows"].keys()


def test_table_checkpoint_and_raw_rows_match_jax():
    """A JAX table's state_dict loads into the port's (and back) with the
    rows, state and step intact; import_rows stores values raw; the dense
    table draws the same init and applies the same push."""
    js, _, _ = _drive(jtable, "adagrad")
    t = ptable.SparseTable(dim=4, optimizer="adagrad", **HYPER)
    t.load_state_dict(js)
    back = jtable.SparseTable(dim=4, optimizer="adagrad", **HYPER)
    back.load_state_dict(t.state_dict())
    ids = np.arange(60)
    np.testing.assert_array_equal(t.export_rows(ids)[0],
                                  back.export_rows(ids)[0])
    g = np.ones((60, 4), np.float32)
    t.push(ids, g)
    back.push(ids, g)
    np.testing.assert_array_equal(t.pull(ids), back.pull(ids))
    rows, state = t.export_rows(ids[:5])
    t.import_rows(ids[:5], rows * 2, {"acc": state["acc"] + 1})
    r2, s2 = t.export_rows(ids[:5])
    np.testing.assert_array_equal(r2, rows * 2)
    np.testing.assert_array_equal(s2["acc"], state["acc"] + 1)
    pd, jd = ptable.DenseTable((3, 5), lr=0.5, seed=2), \
        jtable.DenseTable((3, 5), lr=0.5, seed=2)
    for d in (pd, jd):
        d.push(np.full((3, 5), 0.25, np.float32))
    np.testing.assert_array_equal(pd.pull(), jd.pull())
    with pytest.raises(ValueError, match="unknown sparse optimizer"):
        ptable.SparseTable(dim=2, optimizer="lamb")
    assert ptable.SparseTable(dim=2, optimizer="decayed_adagrad").eps == 1e-6


def test_codec_roundtrips_match_jax():
    """bf16 and int8 encodings are the JAX package's bytes (NaN, ±Inf,
    ±0, denormals, a negative NaN whose carry would wrap), and decode
    within their precision: bf16 to 2^-7 relative, int8 to half a step of
    the row's scale."""
    neg_nan = np.frombuffer(np.uint32(0xFFFFFFFF).tobytes(), np.float32)[0]
    x = np.array([[1.5, -2.25, np.nan, np.inf, -np.inf, 0.0, -0.0,
                   1e-40, -1e30, neg_nan]], np.float32)
    r = np.random.RandomState(0).standard_normal((300, 8)).astype(np.float32)
    for arr in (x, r):
        for mode in ("bf16", "int8", "none"):
            p, j = pcodec.encode_rows(arr, mode), jcodec.encode_rows(arr, mode)
            if mode == "none":
                np.testing.assert_array_equal(p, j)
                continue
            assert p["shape"] == j["shape"]
            np.testing.assert_array_equal(p["data"], j["data"])
            if mode == "int8":
                np.testing.assert_array_equal(p["scale"], j["scale"])
            np.testing.assert_array_equal(pcodec.decode_rows(j),
                                          jcodec.decode_rows(p))
    d = pcodec.decode_rows(pcodec.encode_rows(x, "bf16"))
    assert np.isnan(d[0, 2]) and np.isnan(d[0, 9])
    assert d[0, 3] == np.inf and d[0, 4] == -np.inf and d[0, 0] == 1.5
    rt = pcodec.decode_rows(pcodec.encode_rows(r, "bf16"))
    assert (np.abs(rt - r) / np.maximum(np.abs(r), 1e-9)).max() < 1 / 128
    rt = pcodec.decode_rows(pcodec.encode_rows(r, "int8"))
    assert (np.abs(rt - r)
            <= np.abs(r).max(axis=1, keepdims=True) / 254 + 1e-8).all()
    with pytest.raises(ValueError, match="unknown row codec"):
        pcodec.encode_rows(r, "fp8")
