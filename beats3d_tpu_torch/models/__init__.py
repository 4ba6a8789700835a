from .forest import DecisionForest, DecisionTree, PackedForest
from .layered import LayeredDecisionForest
from .flagship import FLAGSHIP, SERVING, load_flagship, load_serving_flagship

__all__ = ["DecisionForest", "DecisionTree", "PackedForest",
           "LayeredDecisionForest", "FLAGSHIP", "SERVING", "load_flagship",
           "load_serving_flagship"]
