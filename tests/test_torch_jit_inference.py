"""The port's jit.save/load, inference Predictor, amp.decorate and the
flash-attention operator (B1 as a registered op) on the CPU, against the
JAX package on the same seeded inputs and bridged weights.

Tolerances: a tiny BERT (2 layers, hidden 32, seq 32) in f32 against the
JAX package at tests/test_torch_bert.py's tiny-width limits (atol 2e-5,
rtol 1e-4: both run f32 GEMMs and softmax, summed in other orders);
port against port bit for bit (a loaded program runs the eager module's
ops on the same weights); the operator's CPU implementation against the
plain version bit for bit (it is the plain version).
"""
import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import inference as jax_inference
from paddle_tpu import jit as jax_jit
from paddle_tpu.amp import decorate as jax_decorate
from paddle_tpu.static import InputSpec as JaxInputSpec
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.amp import decorate
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.framework.enforce import (EnforceNotMet,
                                                InvalidArgumentError,
                                                NotFoundError,
                                                UnimplementedError)
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.static import InputSpec
from torch_port_util import bert_model_pair

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=32)
SEQ = 32
TOL = dict(atol=2e-5, rtol=1e-4)


def _ids(seed, rows):
    return np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], (rows, SEQ)).astype(np.int32)


def _cpu_config(prefix):
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    return cfg


def _mlp(seed, in_dim=6):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(in_dim, 4), torch.nn.ReLU(),
                               torch.nn.Linear(4, 2)).eval()


def test_jit_save_load_bert_matches_jax_jit_load(tmp_path):
    jm, pm = bert_model_pair(0, TINY)
    jax_jit.save(jm, str(tmp_path / "jax"),
                 input_spec=[JaxInputSpec([3, SEQ], "int32")])
    jit.save(pm, str(tmp_path / "port"),
             input_spec=[InputSpec([None, SEQ], "int32")])
    assert os.path.exists(tmp_path / "port.pdmodel")
    assert os.path.exists(tmp_path / "port.pdiparams")
    tl = jit.load(str(tmp_path / "port"), device="cpu")
    assert (tl.num_inputs, tl.num_outputs) == (1, 2)
    assert tl.input_specs() == [([None, SEQ], torch.int32)]
    ids = _ids(1, 3)
    want = [np.asarray(o.numpy())
            for o in jax_jit.load(str(tmp_path / "jax"))(ids)]
    got = tl(ids)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # port against port: the loaded program is the eager module's ops on
    # the same weights, at any batch the symbolic dim allows
    for rows in (1, 3, 5):
        x = torch.from_numpy(_ids(rows, rows))
        with torch.no_grad():
            eager = pm(x)
        for a, b in zip(tl(x), eager):
            assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="inference-only"):
        tl.train()


def test_predictor_run_matches_jax_predictor_and_run_async(tmp_path):
    jm, pm = bert_model_pair(2, TINY)
    jax_jit.save(jm, str(tmp_path / "jax"),
                 input_spec=[JaxInputSpec([4, SEQ], "int32")])
    jit.save(pm, str(tmp_path / "port"),
             input_spec=[InputSpec([None, SEQ], "int32")])
    ids = _ids(3, 4)
    jp = jax_inference.create_predictor(
        jax_inference.Config(str(tmp_path / "jax")))
    p = inference.create_predictor(_cpu_config(str(tmp_path / "port")))
    assert p.get_input_names() == jp.get_input_names() == ["x0"]
    assert p.get_output_names() == jp.get_output_names() == ["out0", "out1"]
    want = jp.run([ids])
    h = p.get_input_handle("x0")
    h.copy_from_cpu(ids)
    got = p.run()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(
        p.get_output_handle("out1").copy_to_cpu(), got[1])
    asy = p.run_async([ids])
    assert all(torch.is_tensor(t) for t in asy)
    for a, b in zip(asy, got):
        np.testing.assert_array_equal(a.numpy(), b)


def test_predictor_clones_share_weights_and_agree_on_four_threads(tmp_path):
    _, pm = bert_model_pair(4, TINY)
    jit.save(pm, str(tmp_path / "m"),
             input_spec=[InputSpec([None, SEQ], "int32")])
    primary = inference.create_predictor(_cpu_config(str(tmp_path / "m")))
    rng = np.random.RandomState(7)
    batches = [rng.randint(0, TINY["vocab_size"], (rows, SEQ))
               .astype(np.int32) for rows in (4,) * 4 + (7,) * 4]
    sequential = [primary.run([b]) for b in batches]
    clones = [primary.clone() for _ in range(4)]
    ptrs = [t.data_ptr() for t in primary._translated._params]
    for c in clones:
        assert c._translated is primary._translated
        assert [t.data_ptr() for t in c._translated._params] == ptrs
    outs, errs = [None] * len(batches), []

    def serve(i):
        try:
            for j in range(i, len(batches), 4):
                outs[j] = clones[i].run([batches[j]])
        except Exception as e:     # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in threads)
    for seq, conc in zip(sequential, outs):
        for a, b in zip(seq, conc):
            np.testing.assert_array_equal(a, b)
    # per-clone IO: feeding the clones did not touch the primary's buffers
    np.testing.assert_array_equal(primary.run([batches[0]])[0],
                                  sequential[0][0])


def test_jit_save_load_mlp_dynamic_batch_matches_jax(tmp_path):
    """test_amp_jit_inference.py's save/load and dynamic-batch Predictor,
    on an MLP carrying the same weights in both packages."""
    paddle.seed(0)
    jnet = jnn.Sequential(jnn.Linear(6, 4), jnn.ReLU(), jnn.Linear(4, 2))
    net = _mlp(0)
    with torch.no_grad():
        for tl_, jl in ((net[0], jnet[0]), (net[2], jnet[2])):
            tl_.weight.copy_(torch.from_numpy(np.asarray(
                jl.weight.numpy()).T.copy()))
            tl_.bias.copy_(torch.from_numpy(np.asarray(jl.bias.numpy())))
    jax_jit.save(jnet, str(tmp_path / "jm"),
                 input_spec=[JaxInputSpec([None, 6])])
    jit.save(net, str(tmp_path / "pm"), input_spec=[InputSpec([None, 6])])
    jp = jax_inference.create_predictor(
        jax_inference.Config(str(tmp_path / "jm")))
    p = inference.create_predictor(_cpu_config(str(tmp_path / "pm")))
    for batch in (1, 3, 7):
        xd = np.random.RandomState(batch).randn(batch, 6).astype("float32")
        got = p.run([xd])[0]
        np.testing.assert_allclose(got, jp.run([xd])[0], rtol=1e-5,
                                   atol=1e-6)
        with torch.no_grad():
            np.testing.assert_array_equal(got, net(torch.from_numpy(xd))
                                          .numpy())


def test_predictor_tensor_reshape_contract(tmp_path):
    net = _mlp(1, in_dim=8)
    jit.save(net, str(tmp_path / "m"), input_spec=[InputSpec([None, 8])])
    p = inference.create_predictor(_cpu_config(str(tmp_path / "m")))
    xd = np.random.RandomState(0).randn(4, 8).astype("float32")
    h = p.get_input_handle("x0")
    h.reshape([4, 8])
    assert h.shape() == [4, 8]            # declared before any data
    with pytest.raises(InvalidArgumentError, match="declared"):
        h.copy_from_cpu(np.zeros((2, 8), "float32"))
    h.copy_from_cpu(xd)
    p.run()
    got = p.get_output_handle("out0").copy_to_cpu()
    with torch.no_grad():
        np.testing.assert_array_equal(got, net(torch.from_numpy(xd)).numpy())
    with pytest.raises(EnforceNotMet):
        h.reshape([-1, 8])
    out_h = p.get_output_handle("out0")
    with pytest.raises(EnforceNotMet):
        out_h.reshape([4, 2])
    with pytest.raises(EnforceNotMet):
        out_h.copy_from_cpu(np.zeros((4, 2), "float32"))


def test_predictor_tensor_errors_before_run(tmp_path):
    jit.save(_mlp(2), str(tmp_path / "m"), input_spec=[InputSpec([None, 6])])
    p = inference.create_predictor(_cpu_config(str(tmp_path / "m")))
    with pytest.raises(NotFoundError, match="out0.*run"):
        p.get_output_handle("out0").copy_to_cpu()
    with pytest.raises(NotFoundError, match="out0.*run"):
        p.get_output_handle("out0").shape()
    with pytest.raises(NotFoundError, match="'x0'"):
        p.get_input_handle("x0").shape()
    with pytest.raises(NotFoundError, match="'x0'"):
        p.get_input_handle("x0").copy_to_cpu()


def test_unported_branches_raise(tmp_path):
    # the static branch is ported: a __model__ that is not the port's own
    # format is refused, naming the format rule
    os.makedirs(tmp_path / "static")
    open(tmp_path / "static" / "__model__", "w").close()
    with pytest.raises(InvalidArgumentError, match="ROADMAP C"):
        inference.create_predictor(_cpu_config(str(tmp_path / "static")))
    # int8 programs are ported: an int8-only prefix loads as such (no
    # sidecar here, so no quant_info), and the flag over a float-only
    # export keeps the float program
    jit.save(_mlp(3), str(tmp_path / "m.int8"),
             input_spec=[InputSpec([None, 6])])
    p = inference.create_predictor(_cpu_config(str(tmp_path / "m")))
    assert p.quant_info() is None
    assert p.run([np.ones((2, 6), np.float32)])[0].shape == (2, 2)
    jit.save(_mlp(3), str(tmp_path / "f"), input_spec=[InputSpec([None, 6])])
    snap = tflags.flags_snapshot()
    try:
        tflags.set_flags({"FLAGS_use_int8_inference": True})
        p = inference.create_predictor(_cpu_config(str(tmp_path / "f")))
        assert p.quant_info() is None
    finally:
        tflags.flags_restore(snap)
    with pytest.raises(UnimplementedError, match="A4"):
        inference.Config(str(tmp_path / "f")).set_optim_cache_dir("x")
    with pytest.raises(ValueError, match="input_spec"):
        jit.save(_mlp(3), str(tmp_path / "g"))


def test_amp_decorate_o2_dtypes_match_jax():
    jm, pm = bert_model_pair(5, TINY)
    assert decorate(models=pm, level="O1") is pm
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    jax_decorate(models=jm, level="O2", dtype="bfloat16")
    decorate(models=[pm], level="O2", dtype="bfloat16")
    want = {n: str(p.dtype) for n, p in jm.named_parameters()}
    got = {n: str(p.dtype).split(".")[-1] for n, p in pm.named_parameters()}
    assert got == want and set(got.values()) == {"bfloat16"}
    assert pm.encoder.layers[0].norm1.weight.dtype == torch.bfloat16
    # the decorated model still serves: ids in, bf16 out
    with torch.no_grad():
        seq, pooled = pm(torch.from_numpy(_ids(0, 2)))
    assert seq.dtype == torch.bfloat16 and torch.isfinite(seq.float()).all()
    with pytest.raises(UnimplementedError, match="A5"):
        decorate(models=pm, optimizers=object(), level="O2")


def test_flash_attention_op_cpu_is_the_plain_version():
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 3, 16, 64)
                                    .astype(np.float32)) for _ in range(4))
    bias = torch.where(torch.from_numpy(rng.rand(2, 1, 1, 16)) < 0.2,
                       -1e4, 0.0).float()
    ops = torch.ops.paddle_tpu_torch
    o, lse = ops.flash_attention_fwd(q, k, v, bias, True, 0.125)
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, bias, True, 0.125)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    dd = fa.flash_dd(o, do)
    args = (q, k, v, bias, lse, do, dd, True, 0.125)
    dq = ops.flash_attention_dq(*args)
    dk, dv = ops.flash_attention_dkv(*args)
    want = fa._bwd_plain(*args)
    for got, ref in zip((dq, dk, dv), want):
        assert torch.equal(got, ref)
    # gradients through the operator are the backward operators'
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, bias=bias, causal=True,
                       scale=0.125).backward(do)
    for t, ref in zip(leaves, want):
        assert torch.equal(t.grad, ref)


def test_flash_attention_op_fake_shapes_and_strides():
    """The fake implementation gives each device's shapes, dtypes and
    strides: on CUDA o, dQ, dK and dV stored as (B, S, N, H), lse f32
    (B, N, Sq); on the CPU contiguous."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        for dev in ("cuda", "cpu"):
            q = torch.empty(2, 96, 12, 64, dtype=torch.bfloat16,
                            device=dev).transpose(1, 2)
            k = torch.empty(2, 12, 128, 64, dtype=torch.bfloat16, device=dev)
            o, lse = fa.flash_fwd(q, k, k, None, True)
            assert o.shape == (2, 12, 96, 64) and o.dtype == torch.bfloat16
            assert lse.shape == (2, 12, 96) and lse.dtype == torch.float32
            assert lse.is_contiguous()
            assert o.stride() == ((96 * 768, 64, 768, 1) if dev == "cuda"
                                  else (12 * 96 * 64, 96 * 64, 64, 1))
            dd = torch.empty(2, 12, 96, device=dev)
            dq = fa.flash_bwd_dq(q, k, k, None, lse, q, dd, True)
            dk, dv = fa.flash_bwd_dkv(q, k, k, None, lse, q, dd, True)
            assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
            if dev == "cuda":
                assert dk.stride() == (128 * 768, 64, 768, 1)
        with pytest.raises(ValueError, match="Sq <= Sk"):
            fa.flash_fwd(k, q, q, None, True)


class _Attend(torch.nn.Module):
    """A projection and the flash-attention operator: the smallest module
    whose exported program must keep the operator node."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(64, 3 * 128)

    def forward(self, x):
        B, S, _ = x.shape
        q, k, v = (t.view(B, S, 2, 64).transpose(1, 2)
                   for t in self.proj(x).chunk(3, -1))
        return fa.flash_attention(q, k, v).transpose(1, 2).reshape(B, S, 128)


def test_exported_program_keeps_the_b1_operator_after_save_and_load(
        tmp_path):
    torch.manual_seed(0)
    m = _Attend().eval()
    jit.save(m, str(tmp_path / "a"), input_spec=[InputSpec([None, 16, 64])])
    tl = jit.load(str(tmp_path / "a"), device="cpu")
    targets = [str(n.target) for n in tl.program().graph.nodes
               if n.op == "call_function"]
    assert sum("paddle_tpu_torch.flash_attention_fwd" in t
               for t in targets) == 1
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 16, 64)
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(tl(x), m(x))
