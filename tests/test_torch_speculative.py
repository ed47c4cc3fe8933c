"""The port's speculative decoding (text/speculative.py) on the CPU.

Tokens and ``last_stats`` equal the JAX package's SpeculativeGenerator
on the same bridged weights (f32, dropout off) for gamma 1 and 3; the
output equals the port's own greedy decode at the same cache length, bit
for bit; a self-draft accepts every proposal in JAX's number of steps;
eos freezing, validation, beam rejection and ``generate(draft_model=)``
memoization; the verify block's attention (one window per query)
against one-query calls and against the masked block forward; the flags;
and the decode server under FLAGS_spec_decode, run to completion and in
slot mode, against the JAX server.  The tiny configurations follow
``tests/test_speculative.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.framework.flags import flags_restore as jflags_restore
from paddle_tpu.framework.flags import flags_snapshot as jflags_snapshot
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.text.generation import Generator as JaxGenerator
from paddle_tpu.text.speculative import \
    SpeculativeGenerator as JaxSpeculativeGenerator
from torch_port_util import gpt_pair
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework import flags as _flags
from paddle_tpu_torch.framework.enforce import InvalidArgumentError
from paddle_tpu_torch.framework.flags import (flags_restore, flags_snapshot,
                                              set_flags)
from paddle_tpu_torch.nn.functional.attention import cached_attention
from paddle_tpu_torch.ops.kernels import flash_decode as fd
from paddle_tpu_torch.serving.decode import DecodeModelSpec, _DecodeRuntime
from paddle_tpu_torch.text.generation import Generator, generate
from paddle_tpu_torch.text.speculative import SpeculativeGenerator

V = 64
TARGET = dict(vocab_size=V, hidden_size=32, layers=2, heads=2, seq=64)
DRAFT = dict(vocab_size=V, hidden_size=16, layers=1, heads=2, seq=64)
BUCKETS = dict(seq_buckets=(8, 16, 32), max_len=64)


@pytest.fixture(scope="module")
def target():
    return gpt_pair(7, **TARGET)


@pytest.fixture(scope="module")
def draft():
    return gpt_pair(101, **DRAFT)


def _ids(seed, b, length):
    return np.random.RandomState(seed).randint(2, V, (b, length)) \
        .astype(np.int64)


def _plain_at(pm, spec, ids, lens, steps, eos=None):
    """The port's plain greedy decode at the speculative generator's
    cache length (its bucket leaves gamma + 1 columns of slack)."""
    plain = Generator(pm, device="cpu", **BUCKETS)
    P = plain.prefill_bucket(int(lens.max()))
    C = spec.cache_bucket(P, steps)
    pids, start = plain.pack_prompts(
        [ids[b, :lens[b]] for b in range(ids.shape[0])], P)
    cache, logits0 = plain.prefill(pids, start, C)
    return plain.decode(cache, logits0, start, P, steps,
                        eos_token_id=eos).numpy()


@pytest.mark.parametrize("gamma", [1, 3])
def test_tokens_and_stats_match_jax_and_greedy(target, draft, gamma):
    (jm, pm), (jd, pd) = target, draft
    ids = _ids(0, 3, 5)
    lens = np.array([5, 3, 4])
    spec = SpeculativeGenerator(pm, pd, device="cpu", gamma=gamma,
                                **BUCKETS)
    out = spec.generate(ids, lengths=lens, max_new_tokens=8).numpy()
    jspec = JaxSpeculativeGenerator(jm, jd, gamma=gamma, **BUCKETS)
    want = np.asarray(jspec.generate(ids, lengths=lens,
                                     max_new_tokens=8).numpy())
    np.testing.assert_array_equal(out, want)
    assert spec.last_stats == jspec.last_stats
    assert spec.last_stats["proposed"] \
        == spec.last_stats["spec_steps"] * gamma
    # port against port: the greedy tokens at the same cache length
    np.testing.assert_array_equal(out, _plain_at(pm, spec, ids, lens, 8))
    assert spec.totals["spec_steps"] == spec.last_stats["spec_steps"]


def test_self_draft_accepts_everything(target):
    jm, pm = target
    ids = _ids(1, 2, 5)
    spec = SpeculativeGenerator(pm, pm, device="cpu", gamma=3, **BUCKETS)
    out = spec.generate(ids, max_new_tokens=8).numpy()
    jspec = JaxSpeculativeGenerator(jm, jm, gamma=3, **BUCKETS)
    jout = np.asarray(jspec.generate(ids, max_new_tokens=8).numpy())
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(
        out, _plain_at(pm, spec, ids, np.array([5, 5]), 8))
    st = spec.last_stats
    assert st["acceptance_rate"] == 1.0
    # 8 tokens at 4 a step: 2 speculative steps, as in JAX
    assert st["spec_steps"] == jspec.last_stats["spec_steps"] == 2


def test_eos_freezing_matches_greedy_and_jax(target, draft):
    (jm, pm), (jd, pd) = target, draft
    ids = _ids(3, 4, 4)
    lens = np.full((4,), 4)
    spec = SpeculativeGenerator(pm, pd, device="cpu", gamma=2, **BUCKETS)
    free = _plain_at(pm, spec, ids, lens, 8)
    eos = int(free[0, 2])                  # an early hit on row 0
    out = spec.generate(ids, max_new_tokens=8, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(
        out, _plain_at(pm, spec, ids, lens, 8, eos=eos))
    jspec = JaxSpeculativeGenerator(jm, jd, gamma=2, **BUCKETS)
    np.testing.assert_array_equal(
        out, np.asarray(jspec.generate(ids, max_new_tokens=8,
                                       eos_token_id=eos).numpy()))
    for b in range(4):
        hits = np.where(out[b] == eos)[0]
        if len(hits):
            assert (out[b, hits[0]:] == eos).all()


def test_validation_and_beam_rejection(target, draft):
    (_, pm), (_, pd) = target, draft
    spec = SpeculativeGenerator(pm, pd, device="cpu", gamma=2, **BUCKETS)
    assert spec.gamma == 2
    with pytest.raises(InvalidArgumentError, match="greedy-only"):
        spec.generate(_ids(6, 1, 4), max_new_tokens=4, beam_size=2)
    with pytest.raises(InvalidArgumentError, match="contract"):
        SpeculativeGenerator(pm, torch.nn.Linear(4, 4), device="cpu")
    _, other = gpt_pair(0, vocab_size=32, hidden_size=16, layers=1,
                        heads=2, seq=64)
    with pytest.raises(InvalidArgumentError, match="vocab"):
        SpeculativeGenerator(pm, other, device="cpu")
    with pytest.raises(InvalidArgumentError, match="gamma"):
        SpeculativeGenerator(pm, pd, device="cpu", gamma=0)
    # the cache bucket leaves gamma + 1 columns of slack
    assert spec.cache_bucket(8, 4) == 16 and spec.cache_bucket(8, 5) == 16
    assert spec.cache_bucket(8, 6) == 32


def test_generate_draft_model_memoization(target, draft):
    (_, pm), (_, pd) = target, draft
    ids = _ids(4, 2, 4)
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_decode_buckets": "8,16,32",
                   "FLAGS_decode_max_len": 64})
        a = generate(pm, ids, draft_model=pd, max_new_tokens=4)
        gen = pm._paddle_tpu_torch_spec_generator
        assert gen._draft is pd and gen._layer is pm
        b = pm.generate(ids, max_new_tokens=4, draft_model=pd)
        assert pm._paddle_tpu_torch_spec_generator is gen    # memoized
        plain = pm.generate(ids, max_new_tokens=4)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), plain.numpy())
        # another draft builds another generator
        generate(pm, ids, draft_model=pm, max_new_tokens=4)
        assert pm._paddle_tpu_torch_spec_generator is not gen
    finally:
        flags_restore(snap)


def test_block_reference_equals_single_query_calls():
    """The block form's plain version (one end per query) against T
    one-query calls (f32: the same arithmetic up to the einsum's blocking,
    1e-6), and ``cached_attention``'s verify route against the masked
    path (the CPU's verify, bit for bit), plain and int8."""
    from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
    rng = np.random.RandomState(5)
    B, N, T, S, H = 3, 2, 5, 24, 64
    q, k, v = (torch.as_tensor(rng.randn(*s), dtype=torch.float32)
               for s in ((B, N, T, H), (B, N, S, H), (B, N, S, H)))
    start = torch.as_tensor([0, 4, 9], dtype=torch.int32)
    pos = 14
    end = (pos + 1 + torch.arange(T, dtype=torch.int32))[None].expand(B, T)
    block = fd.flash_decode_block(q, k, v, start, end)
    k8, ks = quantize_kv_rows(k)
    v8, vs = quantize_kv_rows(v)
    qblock = fd.flash_decode_quant_block(q, k8, v8, ks, vs, start, end)
    for t in range(T):
        one = fd.flash_decode(q[:, :, t:t + 1], k, v, start, end[:, t])
        np.testing.assert_allclose(block[:, :, t:t + 1], one, atol=1e-6,
                                   rtol=0)
        oneq = fd.flash_decode_quant(q[:, :, t:t + 1], k8, v8, ks, vs,
                                     start, end[:, t])
        np.testing.assert_allclose(qblock[:, :, t:t + 1], oneq, atol=1e-6,
                                   rtol=0)
    col = torch.arange(S, dtype=torch.int32)
    row = pos + torch.arange(T, dtype=torch.int32)
    valid = (col[None, None, None] <= row[None, None, :, None]) \
        & (col[None, None, None] >= start[:, None, None, None])
    mask = torch.zeros(valid.shape).masked_fill_(~valid, -1e30)
    assert torch.equal(cached_attention(q, k, v, window=(start, end)),
                       cached_attention(q, k, v, attn_mask=mask))
    assert torch.equal(
        cached_attention(q, k8, v8, window=(start, end), k_scale=ks,
                         v_scale=vs),
        cached_attention(q, k8, v8, attn_mask=mask, k_scale=ks, v_scale=vs))


def test_verify_forward_equals_masked_block(target):
    """``forward_cached(verify=True)`` gives the masked block forward's
    logits and planes bit for bit on the CPU, int and tensor positions,
    bf16 and int8 KV, a block that wraps the 16-column ring included."""
    _, pm = target
    snap = flags_snapshot()
    try:
        for kv in ("bf16", "int8"):
            set_flags({"FLAGS_kv_cache_dtype": kv})
            for pos in (3, 13):
                rng = np.random.RandomState(pos)
                B, C, T = 3, 16, 4
                ids = torch.as_tensor(rng.randint(1, V, (B, T)),
                                      dtype=torch.int32)
                start = torch.as_tensor([0, 1, 2], dtype=torch.int32)
                with torch.inference_mode():
                    base = pm.init_cache(B, C)
                    for c in base:
                        for p in c:
                            p.copy_(torch.as_tensor(rng.randint(
                                -3, 4, tuple(p.shape))).to(p.dtype))
                    outs = []
                    for cp, verify in ((pos, False), (pos, True),
                                       (torch.tensor(pos, dtype=torch.int32),
                                        True)):
                        cache = [type(c)(*(p.clone() for p in c))
                                 for c in base]
                        outs.append(pm.forward_cached(ids, cache, cp, start,
                                                      verify=verify))
                (l0, c0) = outs[0]
                for lg, cc in outs[1:]:
                    assert torch.equal(lg, l0), (kv, pos)
                    for a, b in zip(cc, c0):
                        for x, y in zip(a, b):
                            assert torch.equal(x, y), (kv, pos)
    finally:
        flags_restore(snap)


def test_spec_flags_defaults_validation_and_restore():
    jsnap = jflags_snapshot()
    for name in ("spec_decode", "spec_gamma"):
        assert _flags._REGISTRY[name].default == jsnap[name], name
    assert _flags.flag("spec_gamma") == 4
    snap = flags_snapshot()
    try:
        set_flags({"FLAGS_spec_decode": True, "FLAGS_spec_gamma": 16})
        assert _flags.flag("spec_decode") is True
        for bad in (0, 17):
            with pytest.raises(ValueError):
                set_flags({"FLAGS_spec_gamma": bad})
        assert _flags.flag("spec_gamma") == 16
    finally:
        flags_restore(snap)
    assert _flags.flag("spec_decode") is False
    assert _flags.flag("spec_gamma") == 4


def _serve(server_mod, cfg, m, d, rows, flags_, setf, snapf, restoref,
           **kw):
    snap = snapf()
    try:
        setf(flags_)
        srv = server_mod.Server(cfg, **kw)
        srv.register_decode("gpt", m, draft_layer=d, batch_buckets=(1, 2),
                            seq_buckets=(8, 16), max_new_tokens=4,
                            max_len=32)
        srv.start()
        try:
            futs = [srv.submit_decode("gpt", [p], max_new_tokens=4)
                    for p in rows]
            served = [f.result(timeout=120)[0][0] for f in futs]
            stats = srv.stats("gpt")
            gen = srv._models["gpt"].gen
        finally:
            srv.stop()
    finally:
        restoref(snap)
    return np.stack(served), stats, gen


def test_server_spec_matches_jax_server_and_greedy(target, draft):
    """FLAGS_spec_decode with a draft_layer, run to completion and in slot
    mode: served tokens equal the JAX server's and batch-1 greedy decode,
    and stats() carries the acceptance counters."""
    (jm, pm), (jd, pd) = target, draft
    rows = [np.random.RandomState(3).randint(1, V, int(n))
            for n in (3, 7, 12, 1, 9)]
    oracle = Generator(pm, device="cpu", seq_buckets=(8, 16), max_len=32)
    want = np.stack([oracle.generate(p[None, :], max_new_tokens=4)
                     .numpy()[0] for p in rows])
    for extra in ({}, {"FLAGS_decode_slots": 2, "FLAGS_prefill_chunk": 8}):
        fl = {"FLAGS_spec_decode": True, "FLAGS_spec_gamma": 2, **extra}
        served, st, gen = _serve(
            serving, serving.ServingConfig(workers=2), pm, pd, rows, fl,
            set_flags, flags_snapshot, flags_restore, device="cpu")
        jserved, _, _ = _serve(
            jserving, jserving.ServingConfig(workers=1), jm, jd, rows, fl,
            jset_flags, jflags_snapshot, jflags_restore)
        assert isinstance(gen, SpeculativeGenerator) and gen.gamma == 2
        np.testing.assert_array_equal(served, jserved)
        np.testing.assert_array_equal(served, want)
        assert st["completed"] == 5 and st["spec_proposed"] > 0
        assert 0 <= st["spec_accepted"] <= st["spec_proposed"]
        assert st["spec_acceptance_rate"] == round(
            st["spec_accepted"] / st["spec_proposed"], 4)
        if extra:
            sl = st["slot_loop"]
            assert sl["spec_proposed"] == st["spec_proposed"]


def test_flag_off_ignores_draft(target, draft):
    (_, pm), (_, pd) = target, draft
    assert _flags.flag("spec_decode") is False
    rt = _DecodeRuntime(DecodeModelSpec(
        name="g", layer=pm, draft_layer=pd, batch_buckets=(1,),
        seq_buckets=(8,), max_new_tokens=4, max_len=16),
        torch.device("cpu"))
    rt.load()
    assert type(rt.gen) is Generator and rt.spec_stats() is None
