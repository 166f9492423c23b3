"""The port's losses, metrics, AdamW rule, frozen batch norm and kernel
backwards against the JAX package (or autograd of the plain versions), on
the CPU, on the same numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depth_estimation_tpu.models.layers import FrozenBatchNorm as JaxFrozenBatchNorm
from depth_estimation_tpu.train import losses as jl
from depth_estimation_tpu.train import metrics as jm
from depth_estimation_tpu_torch.models.layers import FrozenBatchNorm2d
from depth_estimation_tpu_torch.ops.kernels import attention as tatt
from depth_estimation_tpu_torch.ops.kernels import grouped_conv as tgc
from depth_estimation_tpu_torch.ops.kernels import resize as trsz
from depth_estimation_tpu_torch.ops.resize import interp_matrix
from depth_estimation_tpu_torch.train import losses as tl
from depth_estimation_tpu_torch.train import metrics as tm
from depth_estimation_tpu_torch.train.step import make_optimizer


def _maps(seed, b=2, h=24, w=32):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((b, h, w)).astype(np.float32)
    gt = (rng.random((b, h, w)) + 0.1).astype(np.float32)
    mask = rng.random((b, h, w)) > 0.3
    return pred, gt, mask


def _value_and_grad_torch(fn, pred, *args):
    p = torch.from_numpy(pred).requires_grad_(True)
    out = fn(p, *(torch.from_numpy(np.asarray(a)) if a is not None else None for a in args))
    out.backward()
    return out.item(), p.grad.numpy()


def _assert_close(got, want, rtol=1e-5):
    """Within rtol of each value, or of the largest where a value is near 0."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("trim", [0.0, 0.2])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_ssi_loss_matches_jax(trim, masked):
    pred, gt, mask = _maps(0)
    mask = mask if masked else None
    want, want_g = jax.value_and_grad(lambda p: jl.ssi_loss(p, gt, mask, trim=trim))(pred)
    got, got_g = _value_and_grad_torch(lambda p, g, m: tl.ssi_loss(p, g, m, trim=trim), pred, gt, mask)
    _assert_close(got, want)
    _assert_close(got_g, want_g)


def test_ssi_loss_trims_a_batch_of_more_than_2_24_values_as_jax():
    """A batch of 1026 maps of 128×128, 16.8M values, past the 2^24 that
    ``torch.quantile`` takes: three distinct images, each repeated 342
    times, so the loss is JAX's over the three and each map's gradient
    JAX's over 342 (a cut taken over the whole batch would mix them)."""
    pred, gt, _ = _maps(3, b=3, h=128, w=128)
    gt[1] *= 4.0
    reps = 342
    want, want_g = jax.value_and_grad(lambda p: jl.ssi_loss(p, gt))(pred)
    big_pred, big_gt = np.tile(pred, (reps, 1, 1)), np.tile(gt, (reps, 1, 1))
    assert big_pred.size > 2 ** 24
    got, got_g = _value_and_grad_torch(tl.ssi_loss, big_pred, big_gt)
    _assert_close(got, want)
    _assert_close(got_g.reshape(reps, 3, 128, 128), np.broadcast_to(np.asarray(want_g) / reps, (reps, 3, 128, 128)))


def test_gradient_matching_loss_matches_jax():
    pred, gt, _ = _maps(1, h=40, w=56)
    want, want_g = jax.value_and_grad(lambda p: jl.gradient_matching_loss(p, gt))(pred)
    got, got_g = _value_and_grad_torch(tl.gradient_matching_loss, pred, gt)
    _assert_close(got, want)
    _assert_close(got_g, want_g)


@pytest.mark.parametrize("align", [True, False], ids=["aligned", "raw"])
def test_depth_metrics_match_jax(align):
    pred, gt, _ = _maps(2)
    pred = np.abs(pred) + 0.05  # positive disparities, so the raw route has finite depths
    want = jm.depth_metrics(jnp.asarray(pred), jnp.asarray(gt), align=align)
    got = tm.metrics_to_host(tm.depth_metrics(torch.from_numpy(pred), torch.from_numpy(gt), align=align))
    assert set(got) == set(tm.METRIC_NAMES) == set(jm.METRIC_NAMES)
    for k in tm.METRIC_NAMES:
        _assert_close(got[k], float(want[k]))
    # the differentiable metrics' gradient with respect to the prediction
    smooth = ("abs_rel", "sq_rel", "rmse", "rmse_log", "log10")
    want_g = jax.grad(lambda p: sum(jm.depth_metrics(p, gt, align=align)[k] for k in smooth))(pred)
    _, got_g = _value_and_grad_torch(
        lambda p, g: sum(tm.depth_metrics(p, g, align=align)[k] for k in smooth), pred, gt)
    _assert_close(got_g, want_g)


def test_align_disparity_matches_jax():
    pred, gt, mask = _maps(3)
    want = jm.align_disparity(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    got = tm.align_disparity(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(mask))
    _assert_close(got.numpy(), np.asarray(want))


def test_adamw_rule_matches_optax():
    """Three updates of the same fixed gradients: the parameters and both
    moments agree with optax.adamw's defaults (lr 1e-3, weight decay 1e-2)."""
    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()} for _ in range(3)]
    tx = optax.adamw(1e-3, weight_decay=1e-2)
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    js = tx.init(jp)

    module = torch.nn.Module()
    for k, v in p0.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = make_optimizer(module, lr=1e-3, weight_decay=1e-2)
    for g in grads:
        updates, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in g.items():
            getattr(module, k).grad = torch.from_numpy(v)
        opt.step()
        for k in p0:
            param = getattr(module, k)
            np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
            np.testing.assert_allclose(opt.state[param]["exp_avg"].numpy(), np.asarray(js[0].mu[k]), atol=1e-6)
            np.testing.assert_allclose(opt.state[param]["exp_avg_sq"].numpy(), np.asarray(js[0].nu[k]), atol=1e-6)


# -- the frozen batch norm repair -------------------------------------------

def test_frozen_batch_norm_takes_gradients_like_jax_params():
    """All four tensors take the JAX FrozenBatchNorm params' gradients; F.batch_norm
    would raise for the running statistics."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
    stats = {"scale": rng.random(4) + 0.5, "bias": rng.standard_normal(4), "mean": rng.standard_normal(4),
             "var": rng.random(4) + 0.5}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    upstream = rng.standard_normal(x.shape).astype(np.float32)
    jbn = JaxFrozenBatchNorm(4, eps=1e-5)
    x_nhwc, up_nhwc = x.transpose(0, 2, 3, 1), upstream.transpose(0, 2, 3, 1)
    want = jax.grad(lambda p, xx: (jbn.apply({"params": p}, xx) * up_nhwc).sum(), argnums=(0, 1))(stats, x_nhwc)

    bn = FrozenBatchNorm2d(4, eps=1e-5)
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    for jname, tname in names.items():
        getattr(bn, tname).copy_(torch.from_numpy(stats[jname]))
        getattr(bn, tname).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (bn(xt) * torch.from_numpy(upstream)).sum().backward()
    for jname, tname in names.items():
        _assert_close(getattr(bn, tname).grad.numpy(), np.asarray(want[0][jname]))
    _assert_close(xt.grad.numpy(), np.asarray(want[1]).transpose(0, 3, 1, 2))
    closed_form = bn(xt).detach()
    with torch.no_grad():  # outside a graph: the one-launch inference form, same values
        _assert_close(bn(xt).numpy(), closed_form.numpy())
    with pytest.raises(RuntimeError, match="not differentiable"):
        torch.nn.functional.batch_norm(xt, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                                       1e-5).sum().backward()


# -- the kernels' backwards ---------------------------------------------------

def _autograd(fn, *inputs, upstream):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    (fn(*leaves) * upstream).sum().backward()
    return [t.grad for t in leaves]


def test_attention_backward_plain_matches_autograd():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 2, 33, 64), generator=g) for _ in range(3))
    do = torch.randn((2, 2, 33, 64), generator=g)
    want = _autograd(tatt.attention_plain, q, k, v, upstream=do)
    got = tatt.attention_backward_plain(q, k, v, tatt.attention_plain(q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_resize_backward_plain_is_the_transpose():
    g = torch.Generator().manual_seed(1)
    for in_hw, out_hw in [((18, 24), (30, 40)), ((30, 40), (18, 24))]:
        x = torch.randn((2, *in_hw), generator=g)
        up = torch.randn((2, *out_hw), generator=g)
        (want,) = _autograd(lambda t: trsz.resize_planes_plain(t, out_hw), x, upstream=up)
        torch.testing.assert_close(trsz.resize_planes_backward_plain(up, in_hw), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_upsample2x_backward_is_the_matrix_adjoint(align_corners):
    """The decoders' 2× bilinear upsampling: with a gradient wanted it is
    ``_Upsample2x`` (``F.interpolate``'s forward, bitwise; the backward
    Whᵀ·G·Ww, which on the card is the same every call where ATen's adds
    with atomics), equal to autograd of ``F.interpolate`` in float32 and
    float64; without one, ``F.interpolate`` itself."""
    import torch.nn.functional as F

    from depth_estimation_tpu_torch.models.midas_small import upsample2x

    g = torch.Generator().manual_seed(3)
    # ATen computes align_corners=True's source coordinates in the input's
    # type, the matrices in float64 rounded to float32: a few f32 ulps apart
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-6)):
        x = torch.randn((2, 3, 9, 12), generator=g, dtype=dtype)
        up = torch.randn((2, 3, 18, 24), generator=g, dtype=dtype)
        want_y = F.interpolate(x, size=(18, 24), mode="bilinear", align_corners=align_corners)
        (want,) = _autograd(lambda t: F.interpolate(t, size=(18, 24), mode="bilinear",
                                                    align_corners=align_corners), x, upstream=up)
        leaf = x.clone().requires_grad_()
        y = upsample2x(leaf, align_corners)
        assert type(y.grad_fn).__name__ == "_Upsample2xBackward" and torch.equal(y.detach(), want_y)
        (got,) = torch.autograd.grad(y, leaf, up)
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        with torch.no_grad():
            assert upsample2x(leaf, align_corners).grad_fn is None
            assert torch.equal(upsample2x(leaf, align_corners), want_y)


def test_grouped_conv_backward_plain_pieces():
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 16, 7, 9), generator=g)
    w = torch.randn((16, 4, 3, 3), generator=g)
    dy = torch.randn((2, 16, 7, 9), generator=g)
    want_dx, want_dw = _autograd(lambda a, b: tgc.grouped_conv3x3_plain(a, b, 4), x, w, upstream=dy)
    wt = tgc.transposed_weight(w, 4)
    assert wt.is_contiguous() and wt.shape == w.shape
    torch.testing.assert_close(tgc.grouped_conv3x3_plain(dy, wt, 4), want_dx, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(tgc.weight_grad_plain(x, dy, 4), want_dw, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["attention", "attention_backward", "grouped_conv", "grouped_conv_dw", "resize"])
def test_plain_versions_compute_float64_in_float64(case):
    """A float64 input runs the plain attention, grouped convolution,
    their backwards and the resize in float64 (``train.step.float64_gradients``
    relies on it): within 1e-12 of float64 PyTorch, where f32 lands some 1e-7 off."""
    g = torch.Generator().manual_seed(4)
    if case.startswith("attention"):
        q, k, v, do = (torch.randn((1, 2, 17, 64), generator=g, dtype=torch.float64) for _ in range(4))
        if case == "attention":
            got = [tatt.attention_plain(q, k, v)]
            want = [torch.softmax(q @ k.transpose(-1, -2) / 8, dim=-1) @ v]
        else:
            got = tatt.attention_backward_plain(q, k, v, tatt.attention_plain(q, k, v), do)
            want = _autograd(lambda a, b, c: torch.softmax(a @ b.transpose(-1, -2) / 8, dim=-1) @ c, q, k, v,
                             upstream=do)
    elif case.startswith("grouped_conv"):
        x, dy = (torch.randn((1, 16, 7, 9), generator=g, dtype=torch.float64) for _ in range(2))
        w = torch.randn((16, 4, 3, 3), generator=g, dtype=torch.float64)
        if case == "grouped_conv":
            got = [tgc.grouped_conv3x3_plain(x, w, 4)]
            want = [torch.nn.functional.conv2d(x, w, padding=1, groups=4)]
        else:
            got = [tgc.weight_grad_plain(x, dy, 4)]
            want = [torch.nn.grad.conv2d_weight(x, w.shape, dy, padding=1, groups=4)]
    else:
        x = torch.randn((2, 12, 16), generator=g, dtype=torch.float64)
        got = [trsz.resize_planes_plain(x, (20, 28))]
        wh, ww = (torch.from_numpy(interp_matrix(n, m)).double() for n, m in ((12, 20), (16, 28)))
        want = [wh @ x @ ww.T]
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("kernel", ["attention", "resize", "grouped_conv"])
def test_autograd_functions_route_gradients(monkeypatch, kernel):
    """Each kernel operator's registered autograd, on CPU tensors, where the
    operator's implementation is the plain version (the CUDA kernel cannot
    run here): the gradients of autograd of the plain version reach every
    input, and K4's dX goes through the operator again."""
    g = torch.Generator().manual_seed(3)
    if kernel == "attention":
        fn, plain, mod, name = tatt.multi_head_attention, tatt.attention_plain, tatt, "attention_plain"
        inputs = [torch.randn((1, 2, 17, 64), generator=g) for _ in range(3)]
    elif kernel == "resize":
        fn, mod, name = (lambda x: trsz.resize_planes(x, (20, 28))), trsz, "resize_planes_plain"
        plain = lambda x: trsz.resize_planes_plain(x, (20, 28))  # noqa: E731
        inputs = [torch.randn((2, 12, 16), generator=g)]
    else:
        fn, mod, name = (lambda x, w: tgc.grouped_conv3x3(x, w, 4)), tgc, "grouped_conv3x3_plain"
        plain = lambda x, w: tgc.grouped_conv3x3_plain(x, w, 4)  # noqa: E731
        inputs = [torch.randn((2, 16, 6, 5), generator=g), torch.randn((16, 4, 3, 3), generator=g)]
    out = plain(*inputs)
    up = torch.randn(out.shape, generator=g)
    want = _autograd(plain, *inputs, upstream=up)
    launches = []
    stand_in = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: launches.append(a[0].shape) or stand_in(*a))
    got = _autograd(fn, *inputs, upstream=up)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
    assert len(launches) == (2 if kernel == "grouped_conv" else 1)  # K4: forward and dX
