"""Which plain reference model a frame cell's configuration runs: the one
place that resolves it.

A configuration file may name, under ``reference_model``, a module of
``portbench/reference/`` (default ``forest``, the layered chain of the
3d-beats format).  The module holds:

* ``load(config_path, device)``: the model of the configuration's
  ``model`` file, with what ``frame.RefPipeline`` reads: ``num_classes``
  (the final classes) and ``conditions_np`` (its condition rows, which
  decide whether the incoherence guard applies);
* ``run_layered(depth, model, *, labels_reduce, scale_factor, visits,
  ftype)``: the (N, H//r, W//r) int32 final labels of an (N, H, W) depth
  stack, 65535 where unlabelled; ``visits``, when a list, receives one
  list of per-level (rows, leaf sides) visits for each forest walked, in
  the form ``forest.forest_pdf_sum`` gives them, which
  ``work.counts.walk_counts`` reads.

A model that the chain composite cannot express (routed experts, say)
brings its own module as a new file; no file of the harness changes.
"""

from __future__ import annotations

import importlib
import os
import re

DEFAULT = "forest"
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def module(cfg: dict):
    """The reference model module that ``cfg`` names."""
    name = cfg.get("reference_model", DEFAULT)
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"reference_model must name a module of "
                         f"portbench/reference/: {name!r}")
    return importlib.import_module(f"{__package__}.{name}")


def load(cfg: dict, root: str, device):
    """(model, run_layered) of the configuration ``cfg``, its ``model``
    file read relative to ``root``."""
    mod = module(cfg)
    return mod.load(os.path.join(root, cfg["model"]), device), mod.run_layered
