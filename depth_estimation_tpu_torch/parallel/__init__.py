"""Data, tensor and pipeline parallelism on ``torch.distributed`` (JAX ``parallel/``).

The JAX package is single-controller: one program over a ``Mesh`` of
devices, with GSPMD inserting the collectives. PyTorch is multi-controller:
one process a rank, each running the same code on its own shard, with the
collectives written out. The pieces:

* ``launch``   — ``spawn(fn, world_size, device)``: a world of CPU ranks over
  gloo (the counterpart of the JAX tests' virtual host devices), or the
  caller's NCCL world on the GPU;
* ``mesh``     — ``make_mesh`` (a ``DeviceMesh`` named ``("dp", "tp")`` or
  ``("dp", "pp", "sp", "tp")``), the tensor-parallel rules on the state-dict
  names, ``shard_params`` / ``unshard_params`` / ``gather_params``, the dp
  slice of a batch, and ``tensor_parallel``, which cuts a model's ViT blocks;
* ``ops``      — the two Megatron operators of the row- and column-parallel
  matmuls (imports no model, so ``models/vit.py`` can use it);
* ``pipeline`` — the GPipe schedule of the ViT trunk over the mesh's ``pp``
  axis, differentiable through its sends, receives and hook gather;
* ``dryrun``   — ``dryrun_multichip``, one step of each multi-device program
  on a tiny DPT.

Sequence parallelism (``sp``) and spatial partitioning wait for a later slice.
"""
