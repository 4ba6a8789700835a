from .forest import DecisionForest, PackedForest
from .layered import LayeredDecisionForest

__all__ = ["DecisionForest", "PackedForest", "LayeredDecisionForest"]
