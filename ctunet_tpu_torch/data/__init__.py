from .synthetic import make_dataset, spherical_shell

__all__ = ["make_dataset", "spherical_shell"]
