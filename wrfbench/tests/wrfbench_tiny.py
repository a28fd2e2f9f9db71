"""A checkout copy with a tiny cell, for the CPU tests of the harness.

:func:`tiny_checkout` copies ``BENCHMARK.json`` and ``wrfbench/`` into a
directory and adds, as data alone (a configuration file, limits files
and the entries naming them), the cells ``tiny.step``: ``conus12km``'s
dynamics on a 24x20x10 slice, under the ``step`` traffic mix, and
``tiny.mesh2x2``, the same under ``mesh2x2`` (four cards; a run given one
device puts every shard on it).
"""

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

GRID = {"e_we": 24, "e_sn": 20, "e_vert": 10}


def tiny_checkout(dest: Path, grid=GRID, limits=None) -> Path:
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "wrfbench", dest / "wrfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((REPO / "wrfbench/configs/conus12km.json").read_text())
    cfg.update(name="tiny", **grid)
    (dest / "wrfbench/configs/tiny.json").write_text(json.dumps(cfg))
    lim = json.loads((REPO / "wrfbench/limits/conus12km.step.json").read_text())
    for cell in ("tiny.step", "tiny.mesh2x2"):
        (dest / f"wrfbench/limits/{cell}.json").write_text(
            json.dumps(limits or lim))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "wrfbench/configs/tiny.json",
                             "reduced": ["e_we", "e_sn", "e_vert"],
                             "why": "CPU tests"})
    bench["workloads"] += [
        {"name": "tiny.step", "config": "tiny", "traffic": "step",
         "chips": 1, "why": "CPU tests"},
        {"name": "tiny.mesh2x2", "config": "tiny", "traffic": "mesh2x2",
         "chips": 4, "why": "CPU tests"}]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def cfg_of(name: str, **grid) -> dict:
    cfg = json.loads((REPO / f"wrfbench/configs/{name}.json").read_text())
    cfg.update(grid)
    return cfg


def mix_of(name: str = "step") -> dict:
    return json.loads((REPO / f"wrfbench/traffic/{name}.json").read_text())
