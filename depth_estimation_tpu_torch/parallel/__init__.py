"""Data, tensor, pipeline and sequence parallelism and spatial partitioning on
``torch.distributed`` (JAX ``parallel/``).

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
  slice of a batch, ``tensor_parallel``, which cuts a model's ViT blocks,
  and ``seq_sharding`` / ``sequence_parallel``, which cut a ViT's tokens
  over the mesh's ``sp`` axis;
* ``ops``      — the two Megatron operators of the row- and column-parallel
  matmuls and the three token collectives of sequence parallelism (scatter,
  K/V gather, hook gather; imports no model, so ``models/vit.py`` can use
  it);
* ``pipeline`` — the GPipe schedule of the ViT trunk over the mesh's ``pp``
  axis, differentiable through its sends, receives and hook gather;
* ``spatial``  — one frame of any of the four families with every layer's
  rows cut over a mesh axis and halo rows exchanged between neighbours, the
  DPT families' ViT blocks sequence-parallel over the same axis
  (``DepthEstimator.predict_spatial``);
* ``dryrun``   — ``dryrun_multichip``, one step of each of the six
  multi-device programs on a tiny DPT and a tiny MiDaS v2.1.
"""
