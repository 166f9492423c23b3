"""One train step of the port against the JAX package's, on the CPU, on the
same weights and the same u8 batches through the preprocess-fused apply
(``TrainingApply`` / ``make_training_apply``): a tiny DPT (D = 64, as on the
card) and the JAX package's tiny MiDaS v2.1, every gradient (frozen
batch-norm statistics included), then the losses of three AdamW steps; and
the trainable tensors against JAX's param leaves for every family.

The port runs with oneDNN off: its f32 convolution backward lands some 1e-3
(max-scaled) from a float64 gradient on the tiny DPT, where ATen's own
convolutions and XLA's land within 2e-4 and within 1e-6 of each other.

The head's last bias only shifts the prediction, and both losses are
shift-invariant, so its exact gradient is zero but for the pixels that the
final ReLU clamps: both packages return a sum that cancels to about 1e-3 of
the largest gradient, and its rounding differs by some 1e-3 of itself. It is
held against the model's largest gradient instead of its own."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from depth_estimation_tpu import registry as jreg
from depth_estimation_tpu.config import DPT_PREPROCESS as JAX_DPT_PREPROCESS
from depth_estimation_tpu.config import SMALL_PREPROCESS as JAX_SMALL_PREPROCESS
from depth_estimation_tpu.models.dpt import DPT as JaxDPT
from depth_estimation_tpu.models.midas_v21 import MidasV21 as JaxMidasV21
from depth_estimation_tpu.train import step as jstep
from depth_estimation_tpu.train.data import batches, make_training_apply, synthetic_pairs
from depth_estimation_tpu.utils.convert import convert_dpt, convert_midas_v21
from depth_estimation_tpu_torch import registry as treg
from depth_estimation_tpu_torch.config import DPT_PREPROCESS, SMALL_PREPROCESS
from depth_estimation_tpu_torch.models.dpt import DPT
from depth_estimation_tpu_torch.models.midas_v21 import MidasV21
from depth_estimation_tpu_torch.train.data import TrainingApply
from depth_estimation_tpu_torch.train.step import (float64_gradients, loss_fn, make_optimizer, make_train_step,
                                                  trainable_tensors)
from depth_estimation_tpu_torch.utils.convert import params_from_jax, params_from_jax_midas_v21
from tests.oracles import dpt_torch as dpt_oracle
from tests.oracles import midas_v21_torch as v21_oracle
from tests.test_torch_dpt import JAX_TINY as JAX_DPT_TINY
from tests.test_torch_dpt import TINY as DPT_TINY
from tests.test_torch_midas_v21 import JAX_TINY as JAX_V21_TINY
from tests.test_torch_midas_v21 import TINY as V21_TINY

# JAX's tiny DPT with 128 wide and 2 heads: head_dim 64, the card's
DPT128 = dataclasses.replace(DPT_TINY, embed_dim=128)
JAX_DPT128 = dataclasses.replace(JAX_DPT_TINY, embed_dim=128)
SRC_HW, NET_HW, BATCH, LR = (48, 64), (64, 96), 2, 1e-4
SHIFT_ONLY = "scratch.output_conv.4.bias"


def max_scaled_errors(got, want):
    """max |got − want| of each tensor over max |want| of that tensor (of the
    whole model for ``SHIFT_ONLY``)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(np.asarray(got[k]) - want[k]).max())
            / (top if k == SHIFT_ONLY else max(float(np.abs(want[k]).max()), 1e-30)) for k in want}


def _family(name):
    if name == "dpt":
        hub = {k: v.numpy() for k, v in dpt_oracle.make_random_state_dict(JAX_DPT128, seed=3).items()}
        jp = convert_dpt(hub, JAX_DPT128)
        return (JaxDPT(JAX_DPT128), JAX_DPT_PREPROCESS, jp, lambda p: params_from_jax(p, DPT128),
                DPT(DPT128), DPT_PREPROCESS)
    hub = {k: v.numpy() for k, v in v21_oracle.make_random_state_dict(JAX_V21_TINY, seed=7).items()}
    jp = convert_midas_v21(hub, JAX_V21_TINY)
    return (JaxMidasV21(JAX_V21_TINY), JAX_SMALL_PREPROCESS, jp,
            lambda p: params_from_jax_midas_v21(p, V21_TINY), MidasV21(V21_TINY), SMALL_PREPROCESS)


def _batch():
    (imgs, gt), = list(batches(synthetic_pairs(BATCH, *SRC_HW, seed=5), BATCH, shuffle=False))
    return imgs, gt


@pytest.mark.parametrize("name", ["dpt", "midas_v21"])
def test_train_step_matches_jax(name):
    jmodel, jcfg, jparams, to_port, model, cfg = _family(name)
    imgs, gt = _batch()
    japply = make_training_apply(jmodel, jcfg, net_hw=NET_HW)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(japply, p, imgs, gt)))({"params": jparams})

    model.load_state_dict(to_port(jparams))
    opt = make_optimizer(model, lr=LR)
    step = make_train_step(TrainingApply(model, cfg, net_hw=NET_HW), opt)
    imgs_t, gt_t = torch.from_numpy(imgs), torch.from_numpy(gt)
    with torch.backends.mkldnn.flags(enabled=False):
        losses = [float(step(imgs_t, gt_t))]
    np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-5)

    # every trainable tensor's gradient, JAX's leaves mapped to hub keys by the layout rules
    want = {k: v.numpy() for k, v in to_port(jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    got = {k: t.grad for k, t in trainable_tensors(model).items()}
    assert sorted(got) == sorted(want) and all(g is not None for g in got.values())
    if name == "midas_v21":
        assert any(k.endswith("running_var") for k in got)
    errs = max_scaled_errors({k: g.numpy() for k, g in got.items()}, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-4, (worst, errs[worst])

    # three AdamW steps in both
    tx = jstep.make_optimizer(lr=LR)
    jstep_fn = jstep.make_train_step(japply, tx, donate=False)
    state = jstep.init_state({"params": jparams}, tx)
    jlosses = []
    for _ in range(3):
        state, loss = jstep_fn(state, imgs, gt)
        jlosses.append(float(loss))
    with torch.backends.mkldnn.flags(enabled=False):
        losses += [float(step(imgs_t, gt_t)) for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


@pytest.mark.parametrize("name", ["dpt", "midas_v21"])
def test_float64_gradients_hold_both_packages(name):
    """``float64_gradients`` is every trainable tensor's gradient in
    float64, and the JAX package's f32 gradient and the port's lie within
    1e-4 (max-scaled over the model) of it; the model it copies is left as
    it was."""
    jmodel, jcfg, jparams, to_port, model, cfg = _family(name)
    imgs, gt = _batch()
    japply = make_training_apply(jmodel, jcfg, net_hw=NET_HW)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(japply, p, imgs, gt)))({"params": jparams})
    model.load_state_dict(to_port(jparams))
    make_optimizer(model)  # as a trainer holds it: the frozen batch norms' buffers require grad
    apply = TrainingApply(model, cfg, net_hw=NET_HW)
    imgs_t, gt_t = torch.from_numpy(imgs), torch.from_numpy(gt)
    loss64, ref = float64_gradients(apply, imgs_t, gt_t)
    assert sorted(ref) == sorted(trainable_tensors(model)) and all(g.dtype == torch.float64 for g in ref.values())
    assert all(t.dtype == torch.float32 and t.grad is None for t in trainable_tensors(model).values())
    with torch.backends.mkldnn.flags(enabled=False):
        loss = loss_fn(apply, imgs_t, gt_t)
        loss.backward()
    got = {k: t.grad.double() for k, t in trainable_tensors(model).items()}
    want = {k: v.double() for k, v in to_port(jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    top = max(float(g.abs().max()) for g in ref.values())
    for grads in (got, want):
        assert max(float((grads[k] - ref[k]).abs().max()) for k in ref) / top < 1e-4
    np.testing.assert_allclose([float(loss), float(jloss)], [loss64, loss64], rtol=1e-5)


def test_accumulated_step_equals_one():
    """accum_steps=2 over a batch of 4: the same loss and gradients as one
    pass (up to float association); an indivisible batch raises. (The
    updates are not compared: AdamW's first step is about lr·sign(g), which
    flips on gradients near eps.)"""
    _, _, jparams, to_port, _, _ = _family("dpt")
    (imgs, gt), = list(batches(synthetic_pairs(4, *SRC_HW, seed=6), 4, shuffle=False))
    imgs, gt = torch.from_numpy(imgs), torch.from_numpy(gt)
    runs = []
    for accum in (1, 2):
        model = DPT(DPT128)
        model.load_state_dict(to_port(jparams))
        step = make_train_step(TrainingApply(model, DPT_PREPROCESS, net_hw=NET_HW), make_optimizer(model),
                               accum_steps=accum)
        with torch.backends.mkldnn.flags(enabled=False):
            loss = step(imgs, gt)
        runs.append((float(loss), {k: t.grad.clone() for k, t in trainable_tensors(model).items()}))
    (l1, g1), (l2, g2) = runs
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    errs = max_scaled_errors({k: g.numpy() for k, g in g2.items()}, {k: g.numpy() for k, g in g1.items()})
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-4, (worst, errs[worst])
    with pytest.raises(ValueError, match="not divisible"):
        step(imgs[:3], gt[:3])


FAMILY_INIT = {"DPT_Large": (384, 384), "DPT_Hybrid": (384, 384), "MiDaS_small": (256, 256), "MiDaS": (256, 256)}


@pytest.mark.parametrize("name", sorted(FAMILY_INIT))
def test_trainable_tensors_are_jax_leaves(name):
    """For each family at full size: the port trains exactly as many tensors
    as the JAX tree has leaves (shapes only: ``jax.eval_shape`` and the meta
    device). The hub keys both packages drop (``_unread_hub_key``) are not
    in either; no key that JAX keeps is dropped by the port."""
    jtree = jax.eval_shape(jreg.get_entry(name).make_model().init, jax.random.PRNGKey(0),
                           jax.ShapeDtypeStruct((1, *FAMILY_INIT[name], 3), np.float32))["params"]
    with torch.device("meta"):
        model = treg.get_entry(name).make_model()
    names = trainable_tensors(model)
    assert len(names) == len(jax.tree_util.tree_leaves(jtree))
    assert sum(t.numel() for t in names.values()) == sum(x.size for x in jax.tree_util.tree_leaves(jtree))
    assert not any(k.startswith(("scratch.refinenet4.resConfUnit1.", "pretrained.model.norm.",
                                 "pretrained.model.head.")) or k.endswith("num_batches_tracked") for k in names)
