"""Training and evaluation (JAX ``train/``): losses, metrics, the train step, the fit loop and the data pipeline."""
