"""See the package docstring of ``repro_torch``."""
