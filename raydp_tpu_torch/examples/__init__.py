"""Driver scripts of the port, runnable as files or through
``python -m raydp_tpu_torch.cli.submit``."""
