"""Transformer-big's training path in the PyTorch port against the JAX
package, on the CPU in f32 at the size of bench.py's CPU branch of
``bench_transformer_big`` (vocab 128, d_model 64, 4 heads, 2 + 2 layers,
ffn 128, batch 2, seq 16): the encoder-decoder ``nn.Transformer`` with
and without masks, its square mask, incremental decoding through
``gen_cache``, a 5-step ``TrainStep`` trajectory of the Seq2SeqLM of
bench.py (``chip_smoke.seq2seq_lm``), gradient clipping, and the
functionals of label-smoothed training.  JAX runs its plain attention
(these shapes are below its Pallas gate), the port its kernels' plain
versions.

Tolerances: forward outputs atol 1e-5 (the same f32 formulas, summed in
other orders, through 2 + 2 post-norm layers); the trajectory as
``test_bert_train_step_trajectory_matches_jax``: losses atol 2e-5 a
step, parameters atol 1e-4 after step 5, key biases excepted (their
exact gradient is 0); clipped gradients and functionals rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.framework.tensor import Tensor as JaxTensor
from paddle_tpu.nn import clip as jclip
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.optimizer.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer.optimizer import Momentum as JaxMomentum
from paddle_tpu.parallel import TrainStep as JaxTrainStep
from paddle_tpu.parallel.mesh import make_mesh
from chip_smoke import seq2seq_lm
from torch_port_util import jax_params, linear_weight_names
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework.bridge import load_jax_state
from paddle_tpu_torch.framework.enforce import InvalidArgumentError
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import Adam, Momentum
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.parallel import TrainStep

# bench.py's CPU branch of bench_transformer_big
CPU = dict(vocab=128, d_model=64, nhead=4, layers=2, ffn=128, batch=2,
           seq=16)


class JaxSeq2SeqLM(jnn.Layer):
    """bench.py:272-293's Seq2SeqLM, with the masks and soft labels the
    port's composition takes (``chip_smoke.seq2seq_lm``)."""

    def __init__(self, vocab, d_model, nhead, layers, ffn, seq,
                 soft_label=False):
        super().__init__()
        self.soft_label = soft_label
        self.embed = jnn.Embedding(vocab, d_model)
        self.pos = jnn.Embedding(seq, d_model)
        self.core = jnn.Transformer(
            d_model=d_model, nhead=nhead, num_encoder_layers=layers,
            num_decoder_layers=layers, dim_feedforward=ffn, dropout=0.0)
        self.proj = jnn.Linear(d_model, vocab)
        self.loss = jnn.CrossEntropyLoss(soft_label=soft_label)

    def forward(self, src, tgt, labels, src_mask=None, tgt_mask=None,
                memory_mask=None):
        s = self.embed(src) + self.pos(paddle.arange(src.shape[1]))
        t = self.embed(tgt) + self.pos(paddle.arange(tgt.shape[1]))
        logits = self.proj(self.core(s, t, src_mask, tgt_mask, memory_mask))
        V = logits.shape[-1]
        return self.loss(logits.reshape([-1, V]),
                         labels.reshape([-1, V]) if self.soft_label
                         else labels.reshape([-1]))


def _lm_pair(seed, soft_label=False):
    paddle.seed(seed)
    args = [CPU[k] for k in ("vocab", "d_model", "nhead", "layers", "ffn",
                             "seq")]
    jm = JaxSeq2SeqLM(*args, soft_label=soft_label)
    pm = seq2seq_lm(*args, soft_label=soft_label, device="cpu")
    load_jax_state(pm, jax_params(jm))
    return jm, pm


def _transformer_pair(seed):
    paddle.seed(seed)
    kw = dict(d_model=CPU["d_model"], nhead=CPU["nhead"],
              num_encoder_layers=CPU["layers"],
              num_decoder_layers=CPU["layers"],
              dim_feedforward=CPU["ffn"], dropout=0.0)
    jm = jnn.Transformer(**kw)
    pm = tnn.Transformer(**kw, device="cpu")
    load_jax_state(pm, jax_params(jm))
    jm.eval()
    return jm, pm.eval()


def _pad_mask(rng, batch, seq):
    """A source-padding additive mask (B, 1, 1, S): 0 over each row's
    first seq/2..seq tokens, -1e4 after."""
    lens = rng.randint(seq // 2, seq + 1, batch)
    keep = np.arange(seq)[None, :] < lens[:, None]
    return np.where(keep, 0.0, -1e4).astype(np.float32)[:, None, None, :]


def _both(x):
    """(a JAX tensor, a torch tensor) of one numpy array, or Nones."""
    if x is None:
        return None, None
    return paddle.to_tensor(x), torch.from_numpy(np.array(x))


@pytest.mark.parametrize("case", ["plain", "src_padding", "square_tgt",
                                  "tgt12_src16"])
def test_transformer_forward_matches_jax(case):
    jm, pm = _transformer_pair(51)
    rng = np.random.RandomState(52)
    B, S, E = CPU["batch"], CPU["seq"], CPU["d_model"]
    T = 12 if case == "tgt12_src16" else S
    src = rng.randn(B, S, E).astype(np.float32)
    tgt = rng.randn(B, T, E).astype(np.float32)
    src_mask = _pad_mask(rng, B, S) if case == "src_padding" else None
    tgt_mask = np.asarray(jm.generate_square_subsequent_mask(T).numpy()) \
        if case == "square_tgt" else None
    masks = [_both(m) for m in (src_mask, tgt_mask, src_mask)]
    want = jm(paddle.to_tensor(src), paddle.to_tensor(tgt),
              *(m[0] for m in masks)).numpy()
    with torch.no_grad():
        got = pm(torch.from_numpy(src), torch.from_numpy(tgt),
                 *(m[1] for m in masks)).numpy()
    assert got.shape == (B, T, E)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_square_subsequent_mask_equals_jax():
    jm, pm = _transformer_pair(53)
    for n in (1, 5, 16):
        want = np.asarray(jm.generate_square_subsequent_mask(n).numpy())
        got = pm.generate_square_subsequent_mask(n)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


def test_incremental_decode_with_gen_cache_matches_full_forward_and_jax():
    """Token by token through the decoder's (Cache, StaticCache) pairs:
    each step's output equals the full forward under the square mask at
    that row, and JAX's incremental output."""
    jm, pm = _transformer_pair(54)
    rng = np.random.RandomState(55)
    B, S, T, E = CPU["batch"], CPU["seq"], 10, CPU["d_model"]
    src = rng.randn(B, S, E).astype(np.float32)
    tgt = rng.randn(B, T, E).astype(np.float32)
    pad = _pad_mask(rng, B, S)
    jsrc, tsrc = _both(src)
    jpad, tpad = _both(pad)
    with torch.no_grad():
        memory = pm.encoder(tsrc, tpad)
        full = pm.decoder(torch.from_numpy(tgt), memory,
                          pm.generate_square_subsequent_mask(T), tpad)
        cache = pm.decoder.gen_cache(memory)
        assert isinstance(cache[0][0], tnn.MultiHeadAttention.Cache)
        assert isinstance(cache[0][1], tnn.MultiHeadAttention.StaticCache)
        assert tuple(cache[0][0].k.shape) == (B, CPU["nhead"], 0,
                                              E // CPU["nhead"])
        steps = []
        for t in range(T):
            out, cache = pm.decoder(torch.from_numpy(tgt[:, t:t + 1]),
                                    memory, None, tpad, cache)
            steps.append(out.numpy())
        assert cache[0][0].k.shape[2] == T
    jmem = jm.encoder(jsrc, jpad)
    jcache = jm.decoder.gen_cache(jmem)
    for t in range(T):
        jout, jcache = jm.decoder(paddle.to_tensor(tgt[:, t:t + 1]), jmem,
                                  None, jpad, jcache)
        np.testing.assert_allclose(steps[t], jout.numpy(), atol=1e-5,
                                   rtol=0, err_msg=f"step {t} vs JAX")
        np.testing.assert_allclose(steps[t][:, 0], full[:, t].numpy(),
                                   atol=1e-5, rtol=0,
                                   err_msg=f"step {t} vs full forward")
    # do_zip regroups the pairs as (incremental caches, static caches)
    zipped = pm.decoder.gen_cache(memory, do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == CPU["layers"]


def _lm_batch(seed, soft, masks):
    rng = np.random.RandomState(seed)
    B, S, V = CPU["batch"], CPU["seq"], CPU["vocab"]
    src, tgt, lbl = (rng.randint(0, V, (B, S)).astype(np.int64)
                     for _ in range(3))
    if soft:
        lbl = np.array(JF.label_smooth(JF.one_hot(
            paddle.to_tensor(lbl), V), epsilon=0.1).numpy())
    if not masks:
        return (src, tgt, lbl)
    pad = _pad_mask(rng, B, S)
    square = np.triu(np.full((S, S), -1e30, np.float32), 1)
    return (src, tgt, lbl, pad, square, pad)


@pytest.mark.parametrize("recipe", ["adam", "clip_noam_label_smooth"])
def test_seq2seq_train_step_trajectory_matches_jax(recipe):
    """5 TrainSteps on one batch: bench.py's Adam on hard labels; and
    Adam under ClipGradByGlobalNorm and NoamDecay on label-smoothed soft
    labels with the padding and square masks."""
    wmt = recipe != "adam"
    jm, pm = _lm_pair(56, soft_label=wmt)
    if wmt:
        # Noam's rate peaks at 1e-3 by step 5 (warm-up 10, scaled 0.05)
        noam = dict(d_model=CPU["d_model"], warmup_steps=10,
                    learning_rate=0.05)
        jsched, tsched = jlr.NoamDecay(**noam), tlr.NoamDecay(**noam)
        jopt = JaxAdam(learning_rate=jsched, parameters=jm.parameters(),
                       grad_clip=jclip.ClipGradByGlobalNorm(1.0))
        topt = Adam(learning_rate=tsched,
                    grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    else:
        jopt = JaxAdam(learning_rate=1e-3, parameters=jm.parameters())
        topt = Adam(learning_rate=1e-3)
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep = JaxTrainStep(jm, jopt, mesh=mesh)
    tstep = TrainStep(pm, topt, device="cpu")
    batch = _lm_batch(57, soft=wmt, masks=wmt)
    jbatch = tuple(jnp.asarray(x) for x in batch)
    for step in range(5):
        want = float(jstep(jbatch).numpy())
        got = float(tstep(batch))
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0,
                                   err_msg=f"step {step + 1}")
        if wmt:
            jsched.step()
            tsched.step()
    jstep.sync_to_layer()
    final = jax_params(jm)
    linear = linear_weight_names(pm)
    for n, p in pm.named_parameters():
        if n.endswith("k_proj.bias"):
            continue            # exact gradient 0: Adam moves noise by lr
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if n in linear else got, final[n],
                                   atol=1e-4, rtol=0, err_msg=n)
    assert tstep.optimizer.state_dict()["@step"] == 5


def test_load_jax_state_is_strict_on_the_seq2seq_names():
    jm, pm = _lm_pair(58)
    params = jax_params(jm)
    names = set(params)
    assert {"embed.weight", "pos.weight", "proj.weight", "proj.bias",
            "core.decoder.layers.1.cross_attn.k_proj.weight",
            "core.decoder.layers.0.norm3.bias",
            "core.encoder.layers.1.linear2.weight"} <= names
    assert names == set(pm.state_dict())
    linear = linear_weight_names(pm)
    # only Linear weights are transposed: the tables copy as they are
    assert "embed.weight" not in linear and "proj.weight" in linear
    np.testing.assert_array_equal(pm.embed.weight.detach().numpy(),
                                  params["embed.weight"])
    np.testing.assert_array_equal(pm.proj.weight.detach().numpy().T,
                                  params["proj.weight"])
    missing = dict(params)
    del missing["core.decoder.layers.1.cross_attn.v_proj.bias"]
    with pytest.raises(InvalidArgumentError, match="cross_attn.v_proj.bias"):
        load_jax_state(pm, missing)
    extra = dict(params, **{"core.decoder.norm.weight": np.ones(64)})
    with pytest.raises(InvalidArgumentError, match="core.decoder.norm"):
        load_jax_state(pm, extra)


def test_grad_clips_match_jax():
    """The three clip classes on (param, grad) pairs against JAX's
    functional_clip (a need_clip=False parameter left out), an optimizer
    with a global-norm clip against JAX's eager one, and
    clip_grad_norm_."""
    rng = np.random.RandomState(59)
    shapes = {"w": (8, 6), "b": (6,), "skip": (5,)}
    grads = {n: (rng.randn(*s) * 3).astype(np.float32)
             for n, s in shapes.items()}
    jgrads = {n: jnp.asarray(g) for n, g in grads.items()}
    params = {}
    for n, g in grads.items():
        params[n] = torch.nn.Parameter(torch.zeros(g.shape))
    params["skip"].need_clip = False
    pairs = [(params[n], torch.from_numpy(g)) for n, g in grads.items()]
    for jc, tc in ((jclip.ClipGradByValue(1.5, -0.5),
                    tnn.ClipGradByValue(1.5, -0.5)),
                   (jclip.ClipGradByNorm(2.0), tnn.ClipGradByNorm(2.0)),
                   (jclip.ClipGradByGlobalNorm(2.0),
                    tnn.ClipGradByGlobalNorm(2.0))):
        want = jclip.functional_clip(jc, None, jgrads, skip={"skip"})
        got = dict(zip(grads, (g for _, g in tc(pairs))))
        for n in grads:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                       rtol=1e-6, atol=0,
                                       err_msg=f"{type(tc).__name__} {n}")
        np.testing.assert_array_equal(got["skip"].numpy(), grads["skip"])

    # Optimizer(grad_clip=): one Momentum step of a Linear on an MSE loss
    # (Momentum's step is linear in the gradient, so the clip shows)
    paddle.seed(60)
    jl = jnn.Linear(6, 3)
    jl.bias.need_clip = False
    tl = torch.nn.Linear(6, 3)
    load_jax_state(tl, jax_params(jl))
    tl.bias.need_clip = False
    x = (rng.randn(4, 6) * 4).astype(np.float32)
    jopt = JaxMomentum(learning_rate=0.1, parameters=jl.parameters(),
                       grad_clip=jclip.ClipGradByGlobalNorm(0.5))
    topt = Momentum(learning_rate=0.1,
                    parameters=list(tl.named_parameters()),
                    grad_clip=tnn.ClipGradByGlobalNorm(0.5))
    (jl(paddle.to_tensor(x)) ** 2).mean().backward()
    jopt.step()
    (tl(torch.from_numpy(x)) ** 2).mean().backward()
    topt.step()
    np.testing.assert_allclose(tl.weight.detach().numpy().T,
                               np.asarray(jl.weight.numpy()), atol=1e-6)
    np.testing.assert_allclose(tl.bias.detach().numpy(),
                               np.asarray(jl.bias.numpy()), atol=1e-6)

    # clip_grad_norm_ scales .grad in place and returns the norm before
    for norm_type in (2.0, float("inf")):
        jps, tps = [], []
        for n, g in grads.items():
            jp = paddle.to_tensor(np.zeros(g.shape, np.float32))
            jp.grad = JaxTensor(jnp.asarray(g))
            jps.append(jp)
            tp = torch.nn.Parameter(torch.zeros(g.shape))
            tp.grad = torch.from_numpy(g.copy())
            tps.append(tp)
        want = float(jclip.clip_grad_norm_(jps, 3.0, norm_type).numpy())
        got = float(tnn.clip_grad_norm_(tps, 3.0, norm_type))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.grad.numpy(),
                                       np.asarray(jp.grad._value),
                                       rtol=1e-6, atol=0)


def test_label_smoothing_functionals_match_jax():
    """one_hot (an id out of range gives zeros), label_smooth with and
    without a prior, soft-label cross entropy by reduction, linear in
    Paddle's layout and embedding with a padding id."""
    rng = np.random.RandomState(61)
    ids = np.array([[0, 3, 6], [2, 7, 5]], np.int64)
    want = np.asarray(JF.one_hot(paddle.to_tensor(ids), 6).numpy())
    got = TF.one_hot(torch.from_numpy(ids), 6)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    prior = rng.dirichlet(np.ones(6)).astype(np.float32)
    for p in (None, prior):
        jp, tp = _both(p)
        w = JF.label_smooth(paddle.to_tensor(want), prior_dist=jp,
                            epsilon=0.2).numpy()
        g = TF.label_smooth(got, prior_dist=tp, epsilon=0.2).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    logits = (rng.randn(5, 7, 11) * 3).astype(np.float32)
    soft = rng.dirichlet(np.ones(11), (5, 7)).astype(np.float32)
    for reduction in ("mean", "sum", "none"):
        w = JF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(soft),
                             soft_label=True, reduction=reduction).numpy()
        g = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                             soft_label=True, reduction=reduction).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=reduction)
    loss = tnn.CrossEntropyLoss(soft_label=True)
    np.testing.assert_allclose(
        loss(torch.from_numpy(logits), torch.from_numpy(soft)).item(),
        float(jnn.CrossEntropyLoss(soft_label=True)(
            paddle.to_tensor(logits), paddle.to_tensor(soft)).numpy()),
        rtol=1e-6)
    x = rng.randn(3, 4, 6).astype(np.float32)
    w = rng.randn(6, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    np.testing.assert_allclose(
        TF.linear(*(torch.from_numpy(a) for a in (x, w, b))).numpy(),
        JF.linear(*(paddle.to_tensor(a) for a in (x, w, b))).numpy(),
        rtol=1e-5, atol=1e-6)
    table = rng.randn(8, 4).astype(np.float32)
    look = np.array([[1, 7, 0], [7, 3, 7]], np.int64)
    for pi in (None, 7, -1):
        np.testing.assert_array_equal(
            TF.embedding(torch.from_numpy(look), torch.from_numpy(table),
                         padding_idx=pi).numpy(),
            JF.embedding(paddle.to_tensor(look), paddle.to_tensor(table),
                         padding_idx=pi).numpy())
