"""Command-line entry points (counterpart of `jamun_tpu/cmdline/`)."""
