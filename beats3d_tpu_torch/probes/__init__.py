"""Hopper counterparts of the scripts/ Mosaic micro-probes.

One module per script, named after it and with its ``run`` signature
(arguments as torch tensors): CPU tensors go to the plain PyTorch version,
CUDA tensors to the hand-written kernel in csrc/probe_tile.cu,
csrc/probe_gather.cu or csrc/probe_tile_list.cu.  Each module's ``main()``
prints the script's cost table measured on the card;
``python -m beats3d_tpu_torch.probes [name ...]`` prints them all.
"""

from . import (prim_bench, repro_roll24, try_axis0, try_batchmin, try_dyngrid,
               try_loopcost, try_loopcost2, try_opcost, try_reduce,
               try_vgather)

# in the order they were ported; each module has SCRIPT, CASES, KERNELS,
# inputs(device), call(args, case, k, plain) and main()
PROBES = (try_opcost, try_reduce, try_loopcost, try_loopcost2, try_batchmin,
          try_axis0, try_vgather, repro_roll24, try_dyngrid, prim_bench)
