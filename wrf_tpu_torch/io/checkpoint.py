"""Checkpoint / resume: state snapshots in the fixture binary format.

The reference has no checkpointing; its field serializers are the de-facto
snapshot format (SURVEY.md §5).  This module makes that explicit: a
checkpoint is a directory of big-endian field-per-file dumps of the carried
state (ww, mu, t, t_ave, u, v, and w/pp when the loop runs the vertical
substep) plus a small manifest (step counter, array
shapes), so a multi-substep integration can stop and resume exactly, and so
snapshots are directly diffable with the comparator suite and readable by
the native driver's codec.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import codec

#: the carried state of the acoustic loop, in write order (w/pp are the
#: vertical-acoustics extension state, present when the loop runs with_w)
STATE_FIELDS = ("ww", "mu", "t", "t_ave", "u", "v", "w", "pp")

_MANIFEST = "checkpoint.json"


def save_checkpoint(directory, state: dict[str, np.ndarray], *,
                    step: int = 0, extra: dict | None = None) -> Path:
    """Write a state snapshot; returns the checkpoint directory."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    shapes = {}
    for name in STATE_FIELDS:
        if name not in state:
            continue
        arr = np.asarray(state[name], dtype=np.float32)
        codec.write_field(d / f"{name}.bin", arr)
        shapes[name] = list(arr.shape)
    manifest = {"step": int(step), "shapes": shapes, "extra": extra or {}}
    (d / _MANIFEST).write_text(json.dumps(manifest, indent=1))
    return d


def load_checkpoint(directory) -> tuple[dict[str, np.ndarray], int, dict]:
    """Read a snapshot back; returns ``(state, step, extra)``."""
    d = Path(directory)
    manifest = json.loads((d / _MANIFEST).read_text())
    state = {
        name: codec.read_field(d / f"{name}.bin", tuple(shape))
        for name, shape in manifest["shapes"].items()
    }
    return state, int(manifest["step"]), manifest.get("extra", {})
