"""The port's CUDA flash-decode kernels on the card, against their plain
PyTorch versions on the same inputs.

Imports neither JAX nor the JAX package, so it runs on the machine with
the card, where JAX is not installed (its conftest is skipped there)::

    python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Here, without a card, every test skips: a CUDA kernel has no CPU mode.
Tolerances: f32 atol 1e-5 (summation order of the split merge); bf16
atol 1e-2 (the kernel rounds its output to bf16, the plain version runs
in f32 on the same bf16 inputs: half a bf16 step at |out| < 4), and 2^-6
of each (batch, head) row's largest |out| against the plain version run
on the bf16 tensors themselves, which rounds at the kernel's points
(chip_smoke.py states the reasons).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.layer.transformer import quantize_kv_rows
from paddle_tpu_torch.ops.kernels import flash_decode as fd

pytestmark = pytest.mark.gpu

# (B, N, S, H, start, end): None = the full cache
CASES = {
    "full": (2, 2, 256, 64, None, None),
    "windowed": (2, 2, 256, 64, [3, 100], [200, 256]),
    "empty_splits": (2, 2, 256, 64, [130, 0], [256, 40]),
    "single_column": (2, 2, 256, 64, [17, 0], [18, 256]),
    "h128": (1, 2, 256, 128, [5], [250]),
    "h256_s1024": (2, 3, 1024, 256, [0, 700], [1024, 701]),
    # cache lengths that are no multiple of the 64-column split: the last
    # split masks its columns past S
    "s200": (2, 2, 200, 64, [3, 0], [200, 150]),
    "s32": (3, 2, 32, 64, [0, 20, 31], [32, 25, 32]),
    "s16_h128": (2, 2, 16, 128, [0, 9], [16, 10]),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-decode kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _case(name, dev, dtype=torch.float32, seed=0):
    B, N, S, H, start, end = CASES[name]
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               .to(dev, dtype)
               for shape in ((B, N, 1, H), (B, N, S, H), (B, N, S, H)))
    lo = None if start is None else torch.tensor(start, dtype=torch.int32,
                                                 device=dev)
    hi = None if end is None else torch.tensor(end, dtype=torch.int32,
                                               device=dev)
    return q, k, v, lo, hi


def _assert_rows_close(got, want, rtol=2.0 ** -6):
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    assert bool((err <= rtol * scale).all()), (err / scale).max().item()


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_match_plain_versions(cuda, name, dtype, atol):
    q, k, v, lo, hi = _case(name, cuda, dtype)
    n0, nq0 = fd.flash_decode.launches, fd.flash_decode_quant.launches
    got = fd.flash_decode(q, k, v, lo, hi)
    want = fd.flash_decode_plain(q.float(), k.float(), v.float(), lo, hi)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)
    if dtype == torch.bfloat16:
        _assert_rows_close(got, fd.flash_decode_plain(q, k, v, lo, hi))
    k8, ks = quantize_kv_rows(k)
    v8, vs = quantize_kv_rows(v)
    got = fd.flash_decode_quant(q, k8, v8, ks, vs, lo, hi)
    want = fd.flash_decode_quant_plain(q.float(), k8, v8, ks, vs, lo, hi)
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)
    if dtype == torch.bfloat16:
        _assert_rows_close(got, fd.flash_decode_quant_plain(q, k8, v8, ks, vs,
                                                            lo, hi))
    assert (fd.flash_decode.launches - n0,
            fd.flash_decode_quant.launches - nq0) == (1, 1)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q, k, v, lo, hi = _case("windowed", cuda)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k.bfloat16(), v, lo, hi)          # mixed dtype
    with pytest.raises(ValueError):
        fd.flash_decode(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                        v, lo, hi)                           # strided
    with pytest.raises(ValueError):
        fd.flash_decode(q[..., :32], k[..., :32].contiguous(),
                        v[..., :32].contiguous(), lo, hi)     # head_dim 32
    with pytest.raises(ValueError):
        fd.flash_decode(q, k.cpu(), v, lo, hi)                # mixed device
    k8, ks = quantize_kv_rows(k)
    with pytest.raises(TypeError):
        fd.flash_decode_quant(q, k, v, ks, ks, lo, hi)        # not int8
    with pytest.raises(ValueError):
        fd.flash_decode_quant(q, k8, k8, ks[:, :, :128], ks, lo, hi)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_step_on_cuda_launches_the_kernel_at_any_cache_length(
        cuda, kv):
    """cached_attention takes the kernel for a windowed decode step on
    CUDA whatever the cache length (here 32, no multiple of 128)."""
    from paddle_tpu_torch.nn.functional.attention import cached_attention
    q, k, v, lo, hi = _case("s32", cuda)
    n0, nq0 = fd.flash_decode.launches, fd.flash_decode_quant.launches
    if kv == "int8":
        k8, ks = quantize_kv_rows(k)
        v8, vs = quantize_kv_rows(v)
        got = cached_attention(q, k8, v8, window=(lo, hi), k_scale=ks,
                               v_scale=vs)
        want = fd.flash_decode_quant_plain(q, k8, v8, ks, vs, lo, hi)
    else:
        got = cached_attention(q, k, v, window=(lo, hi))
        want = fd.flash_decode_plain(q, k, v, lo, hi)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert (fd.flash_decode.launches - n0,
            fd.flash_decode_quant.launches - nq0) \
        == ((0, 1) if kv == "int8" else (1, 0))
