"""Console entries of the port (``python -m depth_estimation_tpu_torch.tools.<name>``)."""
