"""Part of the jamun_tpu_torch port (see the package docstring)."""
