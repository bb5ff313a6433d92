"""Port parity of the GroupNorm backward: the plain `torch_group_norm_backward`
(the function the CUDA kernel `csrc/group_norm_backward.cu` is held to on
the card) against autograd through `torch_group_norm` and against `jax.vjp`
of the JAX package's `xla_group_norm`, with and without SiLU and the fused
add; and the autograd Function that the UNet calls, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccdm_tpu.ops.group_norm import xla_group_norm
from ccdm_tpu_torch.ops import group_norm as gn

torch.set_num_threads(2)


def _inputs(b, c, hw, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c, *hw)) * 3 + 1).astype(np.float32)
    dy = rng.standard_normal((b, c, *hw)).astype(np.float32)
    scale = (rng.standard_normal(c) + 1).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    add = rng.standard_normal((b, c)).astype(np.float32)
    return x, dy, scale, bias, add


def _close(ours, ref, rel, what):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max(), f"{what}: {err} > {rel} x {np.abs(ref).max()}"


CASES = [(2, 64, (8, 8), 32), (2, 96, (4, 6), 32), (3, 16, (5, 4), 8), (2, 64, (16,), 16)]


@pytest.mark.parametrize("with_add", [False, True])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("b,c,hw,groups", CASES)
def test_plain_backward_matches_autograd_and_jax(b, c, hw, groups, silu, with_add):
    x, dy, scale, bias, add = _inputs(b, c, hw, seed=c + len(hw))
    add = add if with_add else None
    t = {k: torch.from_numpy(v) for k, v in
         (("x", x), ("dy", dy), ("w", scale), ("b", bias))}
    ta = None if add is None else torch.from_numpy(add)
    ours = gn.torch_group_norm_backward(t["dy"], t["x"], t["w"], t["b"], groups, silu=silu,
                                        add=ta)

    leaves = [v.clone().requires_grad_() for v in (t["x"], t["w"], t["b"])]
    la = None if ta is None else ta.clone().requires_grad_()
    gn.torch_group_norm(*leaves, groups, silu=silu, add=la).backward(t["dy"])
    auto = [v.grad for v in leaves] + [None if la is None else la.grad]

    # the JAX package's GroupNorm, NHWC, with the add in front as the
    # ResBlock's unfused `h + emb_out`
    def f(xn, s, bb, a):
        if a is not None:
            xn = xn + a[:, None, None, :] if xn.ndim == 4 else xn + a[:, None, :]
        shape = xn.shape
        x4 = xn.reshape(shape[0], -1, 1, shape[-1])
        return xla_group_norm(x4, s, bb, groups, silu=silu).reshape(shape)

    to_nhwc = lambda v: np.moveaxis(v, 1, -1)  # noqa: E731
    args = [jnp.asarray(to_nhwc(x)), jnp.asarray(scale), jnp.asarray(bias)]
    if add is None:
        _, vjp = jax.vjp(lambda xn, s, bb: f(xn, s, bb, None), *args)
        ref = list(vjp(jnp.asarray(to_nhwc(dy)))) + [None]
    else:
        _, vjp = jax.vjp(f, *args, jnp.asarray(add))
        ref = list(vjp(jnp.asarray(to_nhwc(dy))))
    ref[0] = np.moveaxis(np.asarray(ref[0]), -1, 1)

    for i, name in enumerate(("dx", "dweight", "dbias", "dadd")):
        if add is None and name == "dadd":
            assert ours[3] is None
            continue
        # fp32 sums of the same values in three orders
        _close(ours[i], auto[i], 1e-5, f"{name} vs autograd")
        _close(ours[i], ref[i], 1e-5, f"{name} vs jax.vjp")


@pytest.mark.parametrize("with_add", [False, True])
def test_group_norm_function_on_the_cpu(with_add):
    """The wrapper under autograd goes through `GroupNormFunction` (plain
    forward and backward on the CPU, the kernels on the card); without
    autograd it runs the forward alone and saves nothing."""
    x, dy, scale, bias, add = _inputs(2, 64, (8, 8), seed=5)
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, scale, bias)]
    la = torch.from_numpy(add).requires_grad_() if with_add else None
    y = gn.group_norm(*leaves, 32, silu=True, add=la)
    assert y.grad_fn.name() == "GroupNormFunctionBackward"
    y.backward(torch.from_numpy(dy))
    want = gn.torch_group_norm_backward(torch.from_numpy(dy), torch.from_numpy(x),
                                        torch.from_numpy(scale), torch.from_numpy(bias), 32,
                                        silu=True, add=None if la is None else la.detach())
    for got, ref in zip([v.grad for v in leaves] + [None if la is None else la.grad], want):
        if ref is None:
            continue
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    with torch.inference_mode():
        assert gn.group_norm(*leaves, 32, silu=True).grad_fn is None
