"""The control, the reference in the precision below the configuration's,
put in the program's place, comes out not correct, for each cell, at a
small size on the CPU (``portbench/control.py`` runs it at the cells' own
sizes on the card)."""

import pytest
import torch

from portbench import control

from .conftest import SEED, small


@pytest.mark.parametrize("cell", ["flagship.live", "flagship.live_idle",
                                  "flagship.batch16",
                                  "flagship_fine_train.recipe"])
def test_control_is_not_correct(cell):
    _, _, cfg, wl = small(cell)
    checks = control.control(cfg, wl, SEED, torch.device("cpu"))
    assert not checks.correct, checks.table()
