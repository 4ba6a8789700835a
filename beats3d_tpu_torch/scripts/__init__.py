"""The flagship model's build and serving-depth drivers (counterparts of
the repository's ``scripts/flagship_v2.py``, ``scripts/truncate_fine.py``
and ``scripts/bz3d_session_v2.py``) and the routed-expert model's build
(``keskin_len``, on the flagship's recipe), each runnable as a module:

    python -m beats3d_tpu_torch.scripts.flagship_v2 [N_train] [N_test]
    python -m beats3d_tpu_torch.scripts.truncate_fine [Dt ...]
    python -m beats3d_tpu_torch.scripts.bz3d_session_v2 [frames]
    python -m beats3d_tpu_torch.scripts.keskin_len [train test per class]

They run on the card; ``B3D_TRUNC_CPU=1`` (truncate_fine) or a
``device="cpu"`` argument asks for the CPU.  Their outputs go to
``B3D_V2_OUT`` (default ``build/flagship_v2``) and the generated dataset to
``B3D_V2_DS`` (default ``build/flagship_v2_ds``), never to the committed
``models/flagship``.
"""

import torch


def resolve_device(device=None):
    """``device`` as a torch.device; None means the card, and without a
    card that raises: nothing here falls back to the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' (or set "
                           "B3D_TRUNC_CPU=1 for truncate_fine) to run on the "
                           "CPU")
    return torch.device("cuda", 0)
