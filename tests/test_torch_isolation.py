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
from fast_tffm_tpu_torch.ops.fm_kernel import FmScores
from fast_tffm_tpu_torch.train import train
print(json.dumps({"imported": names,
                  "has_main": hasattr(smoke, "main"),
                  "has_fm_scores": callable(FmScores.apply)
                  and callable(train),
                  "leaked": sorted(m for m in sys.modules if blocked(m))}))
'''


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert out["has_main"] and out["has_fm_scores"]
    for name in ("fast_tffm_tpu_torch.__main__", "fast_tffm_tpu_torch.config",
                 "fast_tffm_tpu_torch.ops.fm_kernel",
                 "fast_tffm_tpu_torch.train",
                 "fast_tffm_tpu_torch.utils.timing",
                 "fast_tffm_tpu_torch.ops.build",
                 "fast_tffm_tpu_torch.serve.frontend",
                 "fast_tffm_tpu_torch.models.convert",
                 "fast_tffm_tpu_torch.data.cparser",
                 "fast_tffm_tpu_torch.data.badlines",
                 "fast_tffm_tpu_torch.data.pipeline",
                 "fast_tffm_tpu_torch.data.stream",
                 "fast_tffm_tpu_torch.obs.quality",
                 "fast_tffm_tpu_torch.utils.fetch",
                 "fast_tffm_tpu_torch.scoring",
                 "fast_tffm_tpu_torch.predict",
                 "fast_tffm_tpu_torch.wire",
                 "fast_tffm_tpu_torch.lookup",
                 "fast_tffm_tpu_torch.ops.offload_kernel",
                 "fast_tffm_tpu_torch.utils.ignored",
                 "fast_tffm_tpu_torch.vocab",
                 "fast_tffm_tpu_torch.vocab.sketch",
                 "fast_tffm_tpu_torch.vocab.table",
                 "fast_tffm_tpu_torch.tools.fmckpt",
                 "fast_tffm_tpu_torch.serve.server",
                 "fast_tffm_tpu_torch.serve.proxy",
                 "fast_tffm_tpu_torch.serve.fleet",
                 "fast_tffm_tpu_torch.serve.replica",
                 "fast_tffm_tpu_torch.parallel",
                 "fast_tffm_tpu_torch.parallel.distributed",
                 "fast_tffm_tpu_torch.parallel.liveness",
                 "fast_tffm_tpu_torch.parallel.sharded",
                 "fast_tffm_tpu_torch.obs.sink",
                 "fast_tffm_tpu_torch.obs.telemetry",
                 "fast_tffm_tpu_torch.obs.trace",
                 "fast_tffm_tpu_torch.obs.health",
                 "fast_tffm_tpu_torch.obs.memory",
                 "fast_tffm_tpu_torch.obs.slo",
                 "fast_tffm_tpu_torch.obs.prom",
                 "fast_tffm_tpu_torch.utils.summaries",
                 "fast_tffm_tpu_torch.testing.telemetry",
                 "fast_tffm_tpu_torch.obs.attribution",
                 "fast_tffm_tpu_torch.obs.anatomy",
                 "fast_tffm_tpu_torch.tools.fmstat",
                 "fast_tffm_tpu_torch.tools.fmtrace",
                 "fast_tffm_tpu_torch.tools.streams"):
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


def test_port_thread_names_carry_their_own_prefix():
    """The reference's leak checks count live threads named ``fm-*``
    (``fm-serve``, ``fm-fleet``, ``fm-proxy``, ``fm-build``); under xdist
    a port file can share a worker with a reference file, so no port
    thread takes that prefix."""
    pattern = re.compile(r"""["'](fmt?-[^"']*)""")
    names = []
    for root, _, files in os.walk(os.path.join(REPO, "fast_tffm_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names += pattern.findall(fh.read())
    threads = set(names)
    assert {"fmt-serve-http", "fmt-serve-reload", "fmt-serve-dispatch",
            "fmt-serve-warmup", "fmt-fleet-health", "fmt-fleet-reload",
            "fmt-proxy-http", "fmt-proxy-shadow", "fmt-heartbeat",
            "fmt-part-merger", "fmt-ckpt-writer",
            "fmt-join-ticket", "fmt-watchdog"} <= threads
    assert [n for n in threads if n.startswith("fm-")] == []
