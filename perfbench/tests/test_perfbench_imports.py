"""Nothing the benchmark loads is the JAX stack or the JAX package, and
the reference loads nothing of the program."""

import subprocess
import sys

from perfbench import harness

PROBE = """
import sys
sys.path.insert(0, {root!r})
import glob, os
from perfbench import harness, run, readings, trace, inputs, weights, peaks
for group in ("traffic", "metrics"):
    for path in sorted(glob.glob(os.path.join({root!r}, "perfbench", group, "*.py"))):
        harness.load_file_module(harness.Path(path))
{extra}
tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(" ".join(tops))
"""


def _tops(extra: str = "") -> set[str]:
    code = PROBE.format(root=str(harness.ROOT), extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    return set(out.stdout.split())


def test_no_module_the_benchmark_loads_is_jax_or_the_jax_package():
    tops = _tops("import avtubes_torch.train.steps, avtubes_torch.train.train3d")
    assert not tops & set(harness.FORBIDDEN_MODULES), tops & set(harness.FORBIDDEN_MODULES)
    assert "avtubes_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.reference import arith, augment, flops, nets, spectrogram, "
            "training\n"
            "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    tops = set(out.stdout.split())
    assert "avtubes_torch" not in tops and not tops & set(harness.FORBIDDEN_MODULES)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "avtubes_torch_like", sys)
    assert "avtubes" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "avtubes.core", sys)
    assert "avtubes" in harness.forbidden_loaded()
