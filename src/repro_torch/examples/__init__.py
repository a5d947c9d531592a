"""The JAX package's examples on the port (``python -m
repro_torch.examples.quickstart``, ``.serve_testbed``, ``.wizard_flow``,
``.train_100m``).

They run on the card by default with the paper's full-width zoo models;
``--device cpu --reduced`` runs reduced configs, renamed to the paper's
ids, on the CPU.  The helpers below are what the three share.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Iterable

from repro_torch.configs import ZOO


def device_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--device", default="cuda",
                   help="where every engine runs (default: the card)")
    p.add_argument("--reduced", action="store_true",
                   help="reduced configs under the paper's ids")
    return p


def zoo_cfg(name: str, reduced: bool):
    """A zoo config; reduced() shrinks the arch but keeps the paper's id,
    so chat templates and clients address it by that id."""
    cfg = ZOO[name]
    return dataclasses.replace(cfg.reduced(), name=name) if reduced else cfg


def engines_on(fleet, dev, models: Iterable[str]) -> None:
    """Every replica of `models` holds an engine on `dev`, or raise."""
    models = set(models)
    for node in fleet.nodes.values():
        for inst in node.instances.values():
            if inst.model_name in models and (
                    inst.engine is None
                    or inst.engine.device.type != dev.type):
                raise RuntimeError(f"{node.node_id}: {inst.model_name} has "
                                   f"no engine on {dev}")
