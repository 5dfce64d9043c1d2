"""What the benchmark loads, checked in fresh processes (the test
process itself has the JAX package loaded by other test files): the
harness, every driver, metric and reference load neither JAX nor the
JAX package, and the references load nothing of the port.  Names are
compared by their top-level part, whole: ``repro_torch`` is not
``repro``."""

import json
import os
import subprocess
import sys

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def loaded_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(spec.ROOT / "src"), str(spec.ROOT)]))
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport json, sys\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, env=env, timeout=120,
        cwd=spec.ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    metrics = sorted(p.stem for p in (spec.PKG / "metrics").glob("*.py"))
    drivers = sorted(p.stem for p in (spec.PKG / "drivers").glob("*.py")
                     if p.stem != "__init__")
    code = "\n".join(
        ["import portbench.run, portbench.control, portbench.check",
         "from portbench import spec",
         "from portbench.reference import dense, moe"]
        + [f"import portbench.drivers.{d}" for d in drivers]
        + [f"spec.load_module(spec.PKG / 'metrics' / '{m}.py')"
           for m in metrics])
    loaded = loaded_after(code)
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_references_load_nothing_of_the_port():
    refs = sorted(p.stem for p in (spec.PKG / "reference").glob("*.py")
                  if p.stem != "__init__")
    loaded = loaded_after("\n".join(f"import portbench.reference.{r}"
                                    for r in refs))
    assert "torch" in loaded
    assert not loaded & (FORBIDDEN | {"repro_torch"})
