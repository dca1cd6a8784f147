"""The port stands alone: with jax, jaxlib and the JAX package made
unimportable, every module of fast_tffm_tpu_torch and chip_smoke.py
imports, and none of the blocked names reaches sys.modules. The card's
machine has no jax; a stray import would only show there."""

import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, importlib.abc, importlib.util, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "fast_tffm_tpu")


def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Refuse())
import fast_tffm_tpu_torch
names = ["fast_tffm_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(fast_tffm_tpu_torch.__path__,
                                          prefix="fast_tffm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print(json.dumps({"imported": names,
                  "has_main": hasattr(smoke, "main"),
                  "leaked": sorted(m for m in sys.modules if blocked(m))}))
'''


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert out["has_main"]
    for name in ("fast_tffm_tpu_torch.__main__", "fast_tffm_tpu_torch.config",
                 "fast_tffm_tpu_torch.ops.fm_kernel",
                 "fast_tffm_tpu_torch.ops.build",
                 "fast_tffm_tpu_torch.serve.frontend",
                 "fast_tffm_tpu_torch.models.convert"):
        assert name in out["imported"]


def test_no_jax_import_statements_in_port_sources():
    pattern = re.compile(r"^\s*(import|from) (jax|fast_tffm_tpu)(\.|\s|$)")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "fast_tffm_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    hits = []
    for path in paths:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                if pattern.match(line):
                    hits.append(f"{path}:{n}: {line.strip()}")
    assert len(paths) > 15
    assert hits == []
