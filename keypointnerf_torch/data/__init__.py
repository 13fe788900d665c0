from .synthetic import SyntheticConfig, SyntheticDataset, look_at, make_sample

__all__ = ["SyntheticConfig", "SyntheticDataset", "look_at", "make_sample"]
