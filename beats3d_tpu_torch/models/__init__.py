from .forest import DecisionForest, DecisionTree, PackedForest
from .layered import LayeredDecisionForest

__all__ = ["DecisionForest", "DecisionTree", "PackedForest",
           "LayeredDecisionForest"]
