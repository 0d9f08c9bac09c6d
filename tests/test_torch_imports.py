"""The port's import boundary: no module of kubernetes_tpu_torch reaches
JAX or the JAX package.

A fresh interpreter installs a `sys.meta_path` finder that refuses `jax`,
`jaxlib` and `kubernetes_tpu` (with their submodules; `kubernetes_tpu_torch`
is another name and passes), then imports every module of the port that
`pkgutil.walk_packages` finds. A module that imports a refused package, at
its top or in an `__init__` it pulls in, fails its import there, and the
test names it.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import importlib, importlib.abc, json, pkgutil, sys

REFUSED = ("jax", "jaxlib", "kubernetes_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
import kubernetes_tpu_torch

names, failed = ["kubernetes_tpu_torch"], {}
for info in pkgutil.walk_packages(kubernetes_tpu_torch.__path__,
                                  "kubernetes_tpu_torch."):
    names.append(info.name)
    try:
        importlib.import_module(info.name)
    except Exception as e:
        failed[info.name] = f"{type(e).__name__}: {e}"
reached = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(json.dumps({"names": names, "failed": failed, "reached": reached}))
"""


def _child(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_module_of_the_port_reaches_jax_or_the_jax_package():
    got = _child(CHILD)
    assert not got["failed"], got["failed"]
    assert got["reached"] == []
    # the walk saw the whole package, the cluster and CLI slice included
    for name in ("kubernetes_tpu_torch.cli.cluster",
                 "kubernetes_tpu_torch.cli.kubectl",
                 "kubernetes_tpu_torch.cli.__main__",
                 "kubernetes_tpu_torch.proxy.proxier",
                 "kubernetes_tpu_torch.proxy.healthcheck",
                 "kubernetes_tpu_torch.component.metrics_server",
                 "kubernetes_tpu_torch.sched.server",
                 "kubernetes_tpu_torch.ops.kernels"):
        assert name in got["names"], name


def test_the_finder_refuses_what_it_should():
    """The child's finder itself: `jax` and `kubernetes_tpu.*` fail to
    import under it, `kubernetes_tpu_torch.*` does not."""
    probe = CHILD.split("import kubernetes_tpu_torch\n")[0] + r"""
res = {}
for name in ("jax", "kubernetes_tpu", "kubernetes_tpu.cli",
             "kubernetes_tpu_torch.machinery.meta"):
    try:
        importlib.import_module(name)
        res[name] = "ok"
    except ImportError as e:
        res[name] = str(e)
print(json.dumps(res))
"""
    got = _child(probe)
    assert got == {"jax": "refused: jax",
                   "kubernetes_tpu": "refused: kubernetes_tpu",
                   "kubernetes_tpu.cli": "refused: kubernetes_tpu",
                   "kubernetes_tpu_torch.machinery.meta": "ok"}
