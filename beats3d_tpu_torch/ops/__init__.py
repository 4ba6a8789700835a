from . import (  # noqa: F401
    components,
    cuda_lib,
    forest_eval,
    forest_eval_cuda,
    meanshift,
    meanshift_cuda,
    plane,
    points,
    preproc_cuda,
    train_features,
    train_features_cuda,
)
