"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's own name begins with the JAX package's),
and the reference loads nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from portbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "heat3d_tpu"}

WALK = r"""
import json, sys, time
from portbench import calibrate, cells, check, data, drive, roofline, run, timeline
from portbench.reference import heat
run.fix_environment(cells.ROOT)
bench = cells.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    cells.reader(m["name"])
for c in bench["configs"]:
    cells.system(cells.config(bench, c["name"]))
for w in bench["workloads"]:
    run.measure(bench, w, 3, 0.05, False, "cpu", time.perf_counter(), grid=(8, 8, 8))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = r"""
import json, sys, torch
from portbench import cells, check, data
from portbench.reference.heat import Reference
config = cells.config(cells.load_benchmark(), "heat27-fp32-2048x1024x1024")
u = data.initial_field(5, (8, 8, 8), "cpu")
Reference(config, "cpu", torch.float32, (8, 8, 8)).run(u, 3, torch.float64)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, env=env,
                         capture_output=True, text=True, timeout=600, check=True).stdout
    return set(json.loads(out.splitlines()[-1]))


def test_run_loads_no_jax():
    names = _modules(WALK)
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert "heat3d_tpu_torch" in names  # the whole-name comparison lets the port through


def test_reference_loads_nothing_of_the_program():
    names = _modules(REFERENCE)
    assert not {n for n in names if n.startswith("heat3d")}


def test_reference_sources_import_no_program():
    ref = cells.PACKAGE_DIR / "reference"
    for path in list(ref.glob("*.py")) + [cells.PACKAGE_DIR / "data.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if n.split(".")[0].startswith(("heat3d", "jax"))], path
