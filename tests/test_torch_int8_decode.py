"""bench_decode's int8 variant on the port, against the JAX package on the
CPU: a GPT PTQ-calibrated (abs_max) over 4 batches of one RandomState(0)
prompt and frozen, as ``bench.py``'s ``_bench_decode_one`` does, at its
CPU configuration (vocab 128, hidden 32, 2 layers, prompt 16, buckets
16/32/64), decoding through ``forward_cached``, ``generate()``, the decode
server and the slot loop.  Both packages calibrate and freeze their own
model; the JAX one's frozen state is then carried into the port's by
``load_jax_state``.  bench's bf16 variant, ``amp.decorate(level="O2")``
of the same GPT, is held against JAX's decorated one through
``generate()``.

Tolerances: the codes, scales and integer products are the JAX
package's; the float layers between the sites (the f32 epilogues,
LayerNorm, GELU, attention) round an ulp apart from XLA's, and an input
that then lies within an ulp of a half step is coded one step apart at
the next site.  Logits are held to SERVED_RTOL of max(1, max |ref|), as
``tests/test_torch_int8_serving.py`` holds its served results; greedy
tokens and served rows must be equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import quantization as jq
from paddle_tpu.framework import flags as jflags
from paddle_tpu.quantization.freeze import freeze as jfreeze
from paddle_tpu.quantization.freeze import quant_signature as jsignature
from paddle_tpu.text.generation import Generator as JaxGenerator
from paddle_tpu.text.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.text.models.gpt import GPTModel as JaxGPTModel
from torch_port_util import jax_params, prompts
from paddle_tpu_torch import amp
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.nn.functional import common
from paddle_tpu_torch.ops import int8 as I8
from paddle_tpu_torch.quantization.freeze import (FrozenQuantizedLinear,
                                                  freeze, quant_signature)
from paddle_tpu_torch.text.generation import Generator
from paddle_tpu_torch.text.models import GPTConfig, GPTModel

# bench.py's CPU configuration of bench_decode (bench.py:1105-1110)
TINY = dict(vocab_size=128, hidden_size=32, layers=2, heads=2, seq=128)
V = TINY["vocab_size"]
PROMPT, NEW = 16, 16
BUCKETS = dict(seq_buckets=(16, 32, 64), max_len=64)
SERVED_RTOL = 2.0 ** -10
BF16_RTOL = 2.0 ** -6     # one bf16 step of a logit of magnitude 2
SITES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
         "self_attn.out_proj", "linear1", "linear2")


def _models(seed):
    jpaddle.seed(seed)
    jm = JaxGPTModel(JaxGPTConfig.tiny(**TINY))
    jm.eval()
    pm = GPTModel(GPTConfig.tiny(**TINY), device="cpu").eval()
    return jm, pm


def _frozen_pair(seed, dynamic=False):
    """The JAX GPT and the port's, each quantized and frozen, the port's
    then carrying the JAX one's frozen state.  PTQ as bench.py: 4 batches
    of one RandomState(0) prompt; ``dynamic``: QAT wrappers with abs_max
    activations, frozen uncalibrated (a per-batch abs-max site)."""
    jm, pm = _models(seed)
    if dynamic:
        jq.ImperativeQuantAware(activation_quantize_type="abs_max") \
            .quantize(jm)
        pq.ImperativeQuantAware(activation_quantize_type="abs_max") \
            .quantize(pm)
    else:
        cal = np.random.RandomState(0).randint(1, V, (1, PROMPT)) \
            .astype(np.int64)
        jq.PostTrainingQuantization(
            model=jm, data_loader=((jpaddle.to_tensor(cal),)
                                   for _ in range(4)),
            batch_nums=4).quantize()
        pq.PostTrainingQuantization(
            model=pm, data_loader=((torch.from_numpy(cal),)
                                   for _ in range(4)),
            batch_nums=4).quantize()
    jfreeze(jm)
    freeze(pm)
    load_jax_state(pm, jax_params(jm))
    return jm, pm.eval()


@pytest.fixture(scope="module")
def pair():
    return _frozen_pair(3)


def _flags(kv):
    jsnap, tsnap = jflags.flags_snapshot(), tflags.flags_snapshot()
    jflags.set_flags({"FLAGS_kv_cache_dtype": kv})
    tflags.set_flags({"FLAGS_kv_cache_dtype": kv})
    return jsnap, tsnap


def _restore(snaps):
    jflags.flags_restore(snaps[0])
    tflags.flags_restore(snaps[1])


def _close(got, want):
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert np.isfinite(got).all() and err <= SERVED_RTOL, err


def _cached_logits(jm, pm, rows, steps=3, feed=None):
    """Prefill left-padded rows, then ``steps`` one-token steps fed
    ``feed`` [steps, rows, 1] (default: seeded tokens); [(port logits,
    JAX logits)] of every call."""
    gen = Generator(pm, device="cpu", **BUCKETS)
    P = gen.prefill_bucket(max(len(r) for r in rows))
    C = gen.cache_bucket(P, steps)
    ids, start = gen.pack_prompts(rows, P)
    if feed is None:
        feed = np.random.RandomState(2).randint(0, V, (steps, len(rows), 1))
    tcache, jcache = pm.init_cache(len(rows), C), jm.init_cache(len(rows), C)
    out = []
    with torch.inference_mode():
        for x, pos in [(ids, 0)] + [(feed[i].astype(np.int32), P + i)
                                    for i in range(steps)]:
            tl, tcache = pm.forward_cached(torch.from_numpy(x), tcache, pos,
                                           torch.from_numpy(start))
            jl, jcache = jm.forward_cached(jpaddle.to_tensor(x), jcache, pos,
                                           jpaddle.to_tensor(start))
            out.append((tl.float().numpy(),
                        np.asarray(jl.numpy(), np.float32)))
    return out


def test_frozen_sites_codes_and_scales_match_jax(pair):
    """Every q/k/v/out_proj, linear1 and linear2 is a frozen site in both
    packages, in JAX's named_sublayers() order, the tied LM head (wte)
    stays float and shared; the bridged codes are JAX's transposed and
    the digest over names, flags and scales is JAX's."""
    jm, pm = pair
    names = [n for n, m in pm.named_modules()
             if isinstance(m, FrozenQuantizedLinear)]
    jnames = [n for n, m in jm.named_sublayers()
              if type(m).__name__ == "FrozenQuantizedLinear"]
    want = [f"encoder.layers.{i}.{s}" for i in range(TINY["layers"])
            for s in SITES]
    assert names == jnames == want
    assert isinstance(pm.wte, torch.nn.Embedding)
    assert pm._lm_head.data_ptr() == pm.wte.weight.data_ptr()
    params = jax_params(jm)
    for n in names:
        site = pm.get_submodule(n)
        assert not site._dynamic
        np.testing.assert_array_equal(site.weight_int8.numpy(),
                                      params[f"{n}.weight_int8"].T)
        for b in ("weight_scale", "input_scale", "out_scale"):
            np.testing.assert_array_equal(
                getattr(site, b).numpy().reshape(-1),
                params[f"{n}.{b}"].reshape(-1))
    assert quant_signature(pm) == jsignature(jm)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_forward_cached_logits_match_jax(pair, kv):
    """Prefill and 3 steps of the frozen model against JAX's; ``bf16`` is
    the model's own dtype, here an f32 cache."""
    jm, pm = pair
    snaps = _flags(kv)
    try:
        results = _cached_logits(jm, pm, prompts(4, (16, 5, 11, 1), V))
        cache = pm.init_cache(1, 16)[0]
    finally:
        _restore(snaps)
    assert cache.k.dtype == (torch.int8 if kv == "int8" else torch.float32)
    for got, want in results:
        _close(got, want)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_greedy_generate_tokens_match_jax(pair, kv):
    """bench's batch-4 generate(): the Generator at bench's buckets, 16
    new tokens of 16-token prompts."""
    jm, pm = pair
    ids = np.random.RandomState(1).randint(1, V, (4, PROMPT)) \
        .astype(np.int64)
    snaps = _flags(kv)
    try:
        got = Generator(pm, device="cpu", **BUCKETS).generate(
            ids, max_new_tokens=NEW)
        want = JaxGenerator(jm, **BUCKETS).generate(ids,
                                                    max_new_tokens=NEW)
    finally:
        _restore(snaps)
    assert got.dtype == torch.int32 and got.shape == (4, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_frozen_sites_run_int8_products_only(pair):
    """The former fault: the cached path read ``.weight`` of a frozen
    site (AttributeError).  Each step now runs one int8 product a site
    and no float product but the LM head's."""
    _, pm = pair
    products, floats = [], []
    real_mm, real_linear = I8.int8_mm, torch.nn.functional.linear

    def mm(a, w):
        products.append(tuple(a.shape))
        return real_mm(a, w)

    def linear(x, w, b=None):
        floats.append(tuple(w.shape))
        return real_linear(x, w, b)

    gen = Generator(pm, device="cpu", **BUCKETS)
    ids, start = gen.pack_prompts(prompts(5, (9, 16), V), PROMPT)
    I8.int8_mm, torch.nn.functional.linear = mm, linear
    try:
        cache, logits = gen.prefill(ids, start, 32)
        n_prefill = len(products)
        toks = gen.decode(cache, logits, start, PROMPT, 2)
    finally:
        I8.int8_mm, torch.nn.functional.linear = real_mm, real_linear
    sites = len(SITES) * TINY["layers"]
    assert toks.shape == (2, 2)
    assert n_prefill == sites and len(products) == 3 * sites
    # real rows only: 2 x 16 at the prefill, 2 at a step
    assert set(products[:n_prefill]) <= {(2 * PROMPT, 32), (2 * PROMPT, 128)}
    assert {m for m, _ in products[n_prefill:]} == {2}
    assert floats == [tuple(pm._lm_head.shape)] * 3


def test_dynamic_site_takes_real_rows_only(monkeypatch):
    """A dynamic site quantizes at the abs-max of the layer's real input,
    as JAX's does: rows that pad_rows adds (left unwritten, here
    poisoned) never reach it.  A batch of 3 is padded to 128 rows."""
    jm, pm = _frozen_pair(5, dynamic=True)
    assert all(m._dynamic for m in pm.modules()
               if isinstance(m, FrozenQuantizedLinear))
    real = common.pad_rows

    def poisoned(x, *a):
        xp, n = real(x, *a)
        xp[n:] = 1e6
        return xp, n

    monkeypatch.setattr(common, "pad_rows", poisoned)
    for got, want in _cached_logits(jm, pm, prompts(6, (7, 16, 3), V)):
        _close(got, want)


def _serve(pm, rows, slots, kv):
    snap = tflags.flags_snapshot()
    try:
        tflags.set_flags({"FLAGS_kv_cache_dtype": kv,
                          "FLAGS_decode_slots": slots,
                          "FLAGS_prefill_chunk": 8})
        srv = serving.Server(serving.ServingConfig(workers=2), device="cpu")
        srv.register_decode("gpt", pm, batch_buckets=(1, 4),
                            max_new_tokens=NEW, **BUCKETS)
        srv.start()
        try:
            futs = [srv.submit_decode("gpt", [p], max_new_tokens=NEW)
                    for p in rows]
            served = [f.result(timeout=120)[0][0] for f in futs]
            st = srv.stats("gpt")
        finally:
            srv.stop()
        oracle = Generator(pm, device="cpu", **BUCKETS)
        want = [oracle.generate(p[None, :].astype(np.int64),
                                max_new_tokens=NEW).numpy()[0]
                for p in rows]
    finally:
        tflags.flags_restore(snap)
    return served, want, st


@pytest.mark.parametrize("slots", [0, 4], ids=["batched", "slot_loop"])
def test_served_rows_equal_batch1_generate(pair, slots):
    """The decode server with the frozen model, run to completion (batch
    buckets 1 and 4) and through the slot loop (4 slots, chunk 8), f32
    and int8 caches: every served row equals its batch-1 generate()."""
    _, pm = pair
    rows = prompts(7, (3, 16, 9, 1, 12, 6), V)
    for kv in ("bf16", "int8"):
        served, want, st = _serve(pm, rows, slots, kv)
        assert st["completed"] == len(rows) and st["errors"] == 0
        assert ("slot_loop" in st) == bool(slots)
        for got, w in zip(served, want):
            np.testing.assert_array_equal(got, w)


def test_decorated_gpt_generates_as_jax():
    """bench's bf16 variant: amp.decorate(level="O2") of a GPT, then
    generate().  The former fault: decorate gave the embedding storage
    of its own, cut off the padded tied head that shared it, and
    generate() then refused the model.  The embedding stays the same
    Parameter, now a bf16 view of a bf16 head whose pad rows are zero
    (vocab 100, padded to 128 rows), its values JAX's bf16 weights; the
    greedy tokens of a batch-4 generate() are JAX's up to a near tie.
    bf16 logits of magnitude ~2 are 2^-6 apart, so the two packages tie
    and break ties apart: JAX's model, fed the port's tokens, gives
    logits within BF16_RTOL of max |ref| of the port's, and each port
    token's JAX logit lies within that of JAX's largest."""
    cfg = dict(TINY, vocab_size=100)
    jpaddle.seed(3)
    jm = JaxGPTModel(JaxGPTConfig.tiny(**cfg))
    jm.eval()
    pm = GPTModel(GPTConfig.tiny(**cfg), device="cpu").eval()
    load_jax_state(pm, jax_params(jm))
    wte = pm.wte.weight
    jpaddle.amp.decorate(models=jm, level="O2", dtype="bfloat16")
    assert amp.decorate(models=pm, level="O2", dtype="bfloat16") is pm
    head = pm._lm_head
    assert pm.wte.weight is wte and wte.dtype == head.dtype == torch.bfloat16
    assert head.shape == (128, 32) and head.data_ptr() == wte.data_ptr()
    assert not head[100:].any()
    np.testing.assert_array_equal(
        wte.detach().float().numpy(),
        np.asarray(jax_params(jm)["wte.weight"], np.float32))
    rows = list(np.random.RandomState(1).randint(1, 100, (4, PROMPT)))
    got = Generator(pm, device="cpu", **BUCKETS).generate(
        np.stack(rows).astype(np.int64), max_new_tokens=NEW)
    assert got.dtype == torch.int32 and got.shape == (4, NEW)
    toks = got.numpy()
    pairs = _cached_logits(jm, pm, rows, NEW - 1,
                           feed=toks.T[:-1, :, None].astype(np.int32))
    for t, (lg, ref) in enumerate(pairs):
        tol = BF16_RTOL * np.abs(ref).max()
        assert np.isfinite(lg).all() and np.abs(lg - ref).max() <= tol
        np.testing.assert_array_equal(lg[:, -1].argmax(-1), toks[:, t])
        gap = ref[:, -1].max(-1) - ref[np.arange(4), -1, toks[:, t]]
        assert gap.max() <= tol
