"""Forest training (counterpart of beats3d_tpu/train)."""

from .proposals import make_random_features
from .trainer import DecisionTreeTrainer
from .driver import train_forest, pct_match

__all__ = ["make_random_features", "DecisionTreeTrainer", "train_forest", "pct_match"]
