"""Which entry of the program a configuration runs, and which plain
reference judges it.

The entry is the one run_point itself takes for the configuration's
preset, as run_sweep and cli call it: an early-stop BP preset runs
run_point's wave path, run_point_waves on the fused wave engine
(portbench/waves.py, checked by portbench/wave_check.py); every other
preset runs run_point with a frame step built once (portbench/cell.py,
checked by portbench/check.py).

The reference is the module portbench/reference/<name>.py that the
configuration's optional key "reference" names (default "step"), whose
class Reference(config, device) judges it.  A configuration that needs a
new reference part brings it as a new module and names it there; the
modules refuse what they do not model.
"""
from __future__ import annotations

import importlib
import re


def _waves(config: dict) -> bool:
    from portbench.cell import early_stop, load_preset

    return early_stop(load_preset(config))


def program(config: dict, batch: int, device):
    """The entry's Program (set-up: a frame step built, not warmed)."""
    if _waves(config):
        from portbench.waves import Program
    else:
        from portbench.cell import Program
    return Program(config, batch, device)


def checker(config: dict):
    """The entry's check module: compare, control, correct, LIMITS."""
    if _waves(config):
        from portbench import wave_check
        return wave_check
    from portbench import check
    return check


def reference(config: dict, device):
    """The configuration's reference on `device`; it refuses, with a
    ValueError, a configuration it does not model."""
    name = config.get("reference", "step")
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"{config['name']}: reference {name!r} is not a module name")
    mod = importlib.import_module(f"portbench.reference.{name}")
    if not hasattr(mod, "Reference"):
        raise ValueError(f"portbench/reference/{name}.py has no Reference")
    return mod.Reference(config, device)
