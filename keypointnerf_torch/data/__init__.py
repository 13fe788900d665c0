from .synthetic import SyntheticConfig, look_at, make_sample

__all__ = ["SyntheticConfig", "look_at", "make_sample"]
