"""What a run loads: no JAX, no JAX package; the reference loads nothing
of the program. Each runs in a fresh interpreter, so the test process's
own imports do not count."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN = """
import json, sys
sys.path.insert(0, %r)
from benchmark.tiny import run_tiny
r = run_tiny("density-backlog", seed=4, seconds=1.0)
r2 = run_tiny("flagship-backlog", seed=4, seconds=1.0, trace=True)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

REF = """
import json, sys
sys.path.insert(0, %r)
from benchmark import reference
from benchmark.traffic import Cluster, Group
g = Group(0, 250, 1024, 0, ("zone", 1), "hostname", None)
cl = Cluster(8, ("a", "b"), 4000, 8 << 20, 20, (g,), 0)
reference.replay(cl, {"group": [0] * 4, "fill": [],
                      "waves": [{"members": [0, 1, 2, 3], "deleted": []}]})
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code % str(ROOT)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    tops = _loaded(RUN)
    assert "kubernetes_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "kubernetes_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded(REF)
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "kubernetes_tpu",
                       "kubernetes_tpu_torch"}
