"""Nothing the command runs loads jax or the JAX package, and the reference
loads neither nor the program; top-level names compared whole (the
program's name, wrf_tpu_torch, begins with the JAX package's)."""

import subprocess
import sys
import textwrap

from wrfbench_tiny import REPO

from wrfbench.run import banned_modules

CHECK = textwrap.dedent("""
    import sys
    tops = sorted({m.split('.')[0] for m in list(sys.modules)})
    print(' '.join(tops))
""")


def _tops(code: str, cwd) -> set:
    out = subprocess.run([sys.executable, "-c", code + CHECK], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(out.split())


def test_harness_run_loads_no_jax(tmp_path):
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'wrfbench/tests')!r}]
        from pathlib import Path
        from wrfbench_tiny import tiny_checkout
        from wrfbench.run import run_cell
        root = tiny_checkout(Path({str(tmp_path)!r}))
        res = run_cell(root, "tiny.step", 5, 0.2, True, "cpu",
                       time.perf_counter())
        assert res["correct"] is True
    """)
    tops = _tops(code, tmp_path)
    assert "wrf_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "wrf_tpu"}


def test_reference_loads_nothing_of_jax_or_the_program(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import wrfbench.reference, wrfbench.check, wrfbench.inputs
        import wrfbench.yardstick, wrfbench.traffic
    """)
    tops = _tops(code, tmp_path)
    assert "wrfbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "wrf_tpu", "wrf_tpu_torch"}


def test_banned_names_are_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "wrf_tpu_torch_x", sys)
    assert "wrf_tpu" not in banned_modules()
    monkeypatch.setitem(sys.modules, "wrf_tpu.grid", sys)
    assert "wrf_tpu" in banned_modules()
