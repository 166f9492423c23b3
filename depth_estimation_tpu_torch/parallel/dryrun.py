"""One step of each multi-device program on a tiny DPT (``__graft_entry__.py::dryrun_multichip``).

    python -m depth_estimation_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]

``dryrun_multichip(n_devices, device="cuda")`` starts ``n_devices`` ranks
(``parallel.launch.spawn``: the ``torchrun`` NCCL world on CUDA, which
raises without a GPU; gloo ranks when the caller asks for the CPU) and runs,
on a tiny DPT with random weights:

1. a (dp, tp) train step: dp batch slices, Megatron tp of the transformer matmuls;
2. a (dp, sp, tp) train step, sp = tp = 2: the trunk sequence-parallel
   (``parallel.mesh.sequence_parallel``) and tensor-parallel, when the world
   divides by 4 (else it prints SKIP, as JAX does);
3. a (dp, pp) train step through the GPipe trunk, 2 microbatches;
4. ``predict_sharded``: one frame with the trunk tensor-parallel;
5. ``predict_spatial`` of a tiny MiDaS v2.1: one frame's rows cut over the
   world, with halo exchanges at the convolutions (``parallel/spatial.py``);
6. ``predict_batch_sharded`` over a pure dp mesh, held against ``predict_batch``.

Global rank 0's lines are printed and returned.
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import List

import numpy as np
import torch

# head_dim 64, as the CUDA attention kernel takes; 4 heads split over tp ∈ {1, 2, 4}
TINY_FIELDS = dict(embed_dim=256, depth=4, num_heads=4, hooks=(0, 1, 2, 3), reassemble_channels=(16, 32, 64, 64),
                   features=32, img_size=64)
NAME, V21_NAME = "TinyDPT_dryrun", "TinyV21_dryrun"


def _rank(rank: int, n: int, device: str) -> List[str]:
    from depth_estimation_tpu_torch import registry
    from depth_estimation_tpu_torch.config import PreprocessConfig
    from depth_estimation_tpu_torch.estimator import DepthEstimator, random_state_dict
    from depth_estimation_tpu_torch.models.dpt import DPT, DPTConfig
    from depth_estimation_tpu_torch.models.midas_v21 import MidasV21, MidasV21Config
    from depth_estimation_tpu_torch.parallel.mesh import axis_size, make_mesh, sequence_parallel
    from depth_estimation_tpu_torch.parallel.pipeline import PipelinedDPT
    from depth_estimation_tpu_torch.train.step import init_state, make_train_step, shard_batch

    cfg = DPTConfig(**TINY_FIELDS)
    lines = []
    gen = torch.Generator().manual_seed(0)

    def run_step(mesh, wrap, batch):
        with torch.device("meta"):
            meta = DPT(cfg)
        net = DPT(cfg)
        net.load_state_dict(random_state_dict(meta, 0))
        model = wrap(net.to(device))
        state = init_state(model, mesh=mesh)
        step = make_train_step(model, state.optimizer, mesh=mesh)
        x = torch.randn((batch, 3, 64, 64), generator=gen)
        gt = torch.rand((batch, 64, 64), generator=gen) + 0.5
        loss = float(step(shard_batch(x, mesh), shard_batch(gt, mesh)))
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite dryrun loss: {loss}")
        return loss

    # 1. dp × tp
    tp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n, tp=tp, device=device)
    dp = axis_size(mesh, "dp")
    loss = run_step(mesh, lambda m: m, dp)
    lines.append(f"dryrun_multichip 1/6 OK: (dp={dp}, tp={tp}) over {n} devices, 1 train step, loss={loss:.4f}")

    # 2. dp × sp × tp — the trunk's tokens over sp, its heads over tp
    if n % 4 == 0:
        mesh = make_mesh(n, tp=2, sp=2, device=device)
        loss = run_step(mesh, lambda m: sequence_parallel(m, mesh), axis_size(mesh, "dp"))
        lines.append(f"dryrun_multichip 2/6 OK: (dp={axis_size(mesh, 'dp')}, sp=2, tp=2), 1 train step, "
                     f"loss={loss:.4f}")
    else:
        lines.append(f"dryrun_multichip 2/6 SKIP: n_devices={n} not divisible by 4")

    # 3. dp × pp — GPipe trunk, differentiated through the schedule
    if n % 2 == 0:
        pp = 4 if n % 4 == 0 else 2
        mesh = make_mesh(n, pp=pp, device=device)
        micro = 2
        loss = run_step(mesh, lambda m: PipelinedDPT(m, mesh, micro), micro * axis_size(mesh, "dp"))
        lines.append(f"dryrun_multichip 3/6 OK: (dp={axis_size(mesh, 'dp')}, pp={pp}) GPipe x{micro} "
                     f"microbatches, 1 train step, loss={loss:.4f}")
    else:
        lines.append(f"dryrun_multichip 3/6 SKIP: n_devices={n} odd")

    # 4. TP inference: one frame, the trunk tensor-parallel
    pre = PreprocessConfig(target_height=64, target_width=64, keep_aspect_ratio=False, ensure_multiple_of=32)
    registry.register(registry.ModelEntry(NAME, lambda: DPT(cfg), pre))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = DepthEstimator(NAME, seed=0, verbose=False, device=device)
    tp_inf = max(t for t in (1, 2, 4) if n % t == 0)
    mesh = make_mesh(n, tp=tp_inf, device=device)
    img = np.zeros((96, 128, 3), np.uint8)
    depth = est.predict_sharded(img, mesh)
    if depth.shape != (96, 128) or not np.isfinite(depth).all():
        raise RuntimeError(f"predict_sharded gave {depth.shape}, finite {np.isfinite(depth).all()}")
    lines.append(f"dryrun_multichip 4/6 OK: tp={tp_inf} inference frame program, depth[0,0]={float(depth[0, 0]):.4f}")

    # 5. spatial inference: a tiny MiDaS v2.1 frame, its rows over tp
    tiny_v21 = MidasV21Config(depths=(1, 1, 1, 1), planes=(8, 16, 32, 64), stem_features=8, groups=4,
                              width_per_group=16, features=16, head_features=8, head_mid=8)
    registry.register(registry.ModelEntry(V21_NAME, lambda: MidasV21(tiny_v21), pre))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est_conv = DepthEstimator(V21_NAME, seed=0, verbose=False, device=device)
    img_sp = np.zeros((96 if 96 % tp_inf == 0 else tp_inf * 12, 128, 3), np.uint8)
    depth_sp = est_conv.predict_spatial(img_sp, mesh, axis="tp")
    if depth_sp.shape != img_sp.shape[:2] or not np.isfinite(depth_sp).all():
        raise RuntimeError(f"predict_spatial gave {depth_sp.shape}, finite {np.isfinite(depth_sp).all()}")
    lines.append(f"dryrun_multichip 5/6 OK: {tp_inf}-way row-sharded (spatial) conv inference, "
                 f"depth[0,0]={float(depth_sp[0, 0]):.4f}")

    # 6. dp-sharded batched stills, spot-checked against the one-rank program
    mesh_dp = make_mesh(n, device=device)
    imgs = np.random.default_rng(0).integers(0, 256, (n, 96, 128, 3), dtype=np.uint8)
    depth_dp = est.predict_batch_sharded(imgs, mesh_dp, tensor_parallel=False)
    err = float(np.max(np.abs(depth_dp - est.predict_batch(imgs))))
    if depth_dp.shape != (n, 96, 128) or not err < 1e-4:
        raise RuntimeError(f"dp-sharded batch diverges from one rank's: {depth_dp.shape}, max|Δ| {err}")
    lines.append(f"dryrun_multichip 6/6 OK: dp={n} batched-stills inference (predict_batch_sharded), "
                 f"max|Δ| vs single-device = {err:.2e}")
    return lines


def dryrun_multichip(n_devices: int, device="cuda") -> List[str]:
    from depth_estimation_tpu_torch.parallel.launch import spawn

    lines = spawn(_rank, n_devices, device, n_devices, device)[0]
    if int(os.environ.get("RANK", 0)) == 0:
        for line in lines:
            print(line, flush=True)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
