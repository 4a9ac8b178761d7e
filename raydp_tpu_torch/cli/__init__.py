"""Command-line entry points: ``raydp-tpu-torch-submit``."""
