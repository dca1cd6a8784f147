"""Card checks of the run telemetry, shared by ``chip_smoke.py`` and the
``cuda`` tests: the synchronizations a train step makes with the
telemetry on and off (one process, and a rank's lockstep step), the
out-of-memory wrap on a real allocation
failure, the capacity pre-flight's refusal, and the kernels a profiler
window's trace holds.

``sync_sites`` finds the host-device synchronizations of a call with
``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing CUDA
call warns once, at its Python call site. Nothing here runs at import.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models.fm import (ModelSpec, init_accumulator,
                                           init_table)
from fast_tffm_tpu_torch.obs import memory as obs_memory
from fast_tffm_tpu_torch.obs.telemetry import RunTelemetry, activate
from fast_tffm_tpu_torch.utils.logging import get_logger
from fast_tffm_tpu_torch.wire import WireEncoder, resolve_wire

# The CUDA kernels' function names in a profiler trace.
KERNEL_NAMES = ("fm_score_kernel", "fm_score_bwd_kernel")


def sync_sites(fn: Callable[[], object]) -> Tuple[object, List[str]]:
    """``fn()``'s result and the Python call site (``file:line``) of each
    synchronizing CUDA call it made."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}" for w in rec
                 if "synchroniz" in str(w.message)]


def telemetry_steps(cfg: FmConfig, device: torch.device, batches: Sequence,
                    steps: int, rounds: int = 3,
                    workdir: str = None) -> Dict[str, object]:
    """The same ``steps`` train steps of ``cfg`` (``train._Stepper``: the
    wire, the step, the per-step bookkeeping) over ``batches`` (host
    DeviceBatches, cycled), with the run's telemetry off and on
    (``metrics_flush_steps = 4``, spans, the watchdog, the pressure
    check), in ``rounds`` rounds taken in turns (off, on; on, off; off,
    on; ...: neither arm always runs second) after one unrecorded round
    of each (a process's first steps set things up once). Per arm: each round's median step ms (CUDA events
    between steps, read after the round), their spread, and the
    synchronizations the steps made (``sync_sites``; the same in every
    round) with their call sites; then the telemetry barrier's own
    synchronizations."""
    from fast_tffm_tpu_torch.train import _Stepper
    spec = ModelSpec.from_config(cfg)
    encoder = WireEncoder(resolve_wire(cfg, train=True), pad_id=cfg.pad_id)
    logger = get_logger()
    workdir = workdir or tempfile.mkdtemp(prefix="telemetry-steps-")
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    base = init_table(cfg, device, gen)
    out = {"off": {"ms": [], "syncs": []}, "on": {"ms": [], "syncs": []}}
    for r in range(-1, rounds):
        for arm in (("on", "off") if r % 2 else ("off", "on")):
            tel = None
            if arm == "on":
                tel = RunTelemetry(
                    os.path.join(workdir, f"steps{r}.jsonl"), {},
                    flush_steps=4, trace_spans=True,
                    watchdog_stall_seconds=120.0,
                    mem_pressure_fraction=cfg.mem_pressure_fraction)
            table = base.clone()
            acc = init_accumulator(cfg, device)
            st = _Stepper(cfg, spec, encoder, device, table, acc, 0, logger,
                          tel=tel)
            with activate(tel):
                # Warm over every batch: the caching allocators (the
                # pinned host one too) meet each batch's sizes here.
                for b in batches:
                    st.step(b, 0)
                torch.cuda.synchronize(device)
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(steps + 1)]

                def run():
                    events[0].record()
                    for i in range(steps):
                        st.step(batches[i % len(batches)], 0)
                        events[i + 1].record()

                _, sites = sync_sites(run)
                torch.cuda.synchronize(device)
                ms = sorted(events[i].elapsed_time(events[i + 1])
                            for i in range(steps))
                if tel is not None:
                    _, barrier = sync_sites(
                        lambda: tel.barrier_flush(st.global_step))
                    out["barrier_syncs"] = len(barrier)
                    tel.close()
            del st, table, acc
            if r < 0:
                out[arm]["unrecorded_syncs"] = len(sites)
                continue
            out[arm]["ms"].append(ms[len(ms) // 2])
            out[arm]["syncs"].append(len(sites))
            out[arm].setdefault("sync_sites", sorted(set(sites)))
    # The steppers' wire buffers died with them.
    obs_memory.LEDGER.release("wire_buffers")
    for arm in ("off", "on"):
        ms = out[arm]["ms"]
        out[arm]["median_ms"] = sorted(ms)[len(ms) // 2]
        out[arm]["spread_ms"] = max(ms) - min(ms)
    return out


def dist_telemetry_steps(cfg: FmConfig, mesh, device: torch.device,
                         batches: Sequence, steps: int, rounds: int = 2,
                         workdir: str = None) -> Dict[str, object]:
    """A rank's lockstep train step (``train.step_flags``, the flags
    all-gather under its barrier span, then ``train._Stepper.step`` with
    the row exchange) of a ``dist_train`` job on ``mesh``, ``steps``
    steps over ``batches`` (this rank's fixed-shape host batches,
    cycled) from this rank's ``init_sharded_state`` shard, with the run's
    telemetry off and on (``metrics_flush_steps = 4``, spans, step
    anatomy and the protocol trace), in ``rounds`` rounds taken in turns
    after one unrecorded round of each. Every rank must call it alike
    (the steps are collectives). Per arm: the synchronizations each
    round's steps made (``sync_sites``) with their call sites, and each
    round's median step ms (CUDA events)."""
    from fast_tffm_tpu_torch.obs.sink import read_events
    from fast_tffm_tpu_torch.parallel.sharded import init_sharded_state
    from fast_tffm_tpu_torch.train import _Stepper, step_flags
    spec = ModelSpec.from_config(cfg, num_processes=mesh.size)
    encoder = WireEncoder(resolve_wire(cfg, multi_process=True, train=True),
                          pad_id=cfg.pad_id)
    logger = get_logger()
    workdir = workdir or tempfile.mkdtemp(prefix="dist-telemetry-steps-")
    out = {"off": {"ms": [], "syncs": []}, "on": {"ms": [], "syncs": []}}
    for r in range(-1, rounds):
        for arm in (("on", "off") if r % 2 else ("off", "on")):
            tel = None
            if arm == "on":
                tel = RunTelemetry(
                    os.path.join(workdir, f"rank{mesh.rank}-{r}.jsonl"), {},
                    flush_steps=4, trace_spans=True, protocol_trace=True,
                    anatomy=True)
            table, acc = init_sharded_state(cfg, mesh, cfg.seed, device)
            st = _Stepper(cfg, spec, encoder, device, table, acc, 0, logger,
                          mesh=mesh, tel=tel)
            with activate(tel):
                for b in batches:
                    step_flags(st, "train/step_flags", [0, 0])
                    st.step(b, 0)
                torch.cuda.synchronize(device)
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(steps + 1)]

                def run():
                    events[0].record()
                    for i in range(steps):
                        step_flags(st, "train/step_flags", [0, 0])
                        st.step(batches[i % len(batches)], 0)
                        events[i + 1].record()

                _, sites = sync_sites(run)
                torch.cuda.synchronize(device)
                ms = sorted(events[i].elapsed_time(events[i + 1])
                            for i in range(steps))
                if tel is not None:
                    tel.close()
                    out["collectives_traced"] = sum(
                        1 for e in read_events(tel.sink.path)
                        if e["event"] == "collective")
            del st, table, acc
            if r < 0:
                continue
            out[arm]["ms"].append(ms[len(ms) // 2])
            out[arm]["syncs"].append(len(sites))
            out[arm].setdefault("sync_sites", sorted(set(sites)))
    obs_memory.LEDGER.release("wire_buffers")
    for arm in ("off", "on"):
        ms = out[arm]["ms"]
        out[arm]["median_ms"] = sorted(ms)[len(ms) // 2]
    return out


def oom_wrap(device: torch.device) -> Dict[str, object]:
    """An allocation a GiB larger than the card's whole memory (the free
    bytes ``mem_get_info`` reports leave out the caching allocator's
    reserve, which an allocation may reuse), under ``oom_guard``: it must
    raise ``HbmExhaustedError`` naming the ledger's owners, and the
    caching allocator must serve a small allocation afterwards."""
    free, total = torch.cuda.mem_get_info(device)
    owners = obs_memory.LEDGER.owners()
    nbytes = total + (1 << 30)
    try:
        with obs_memory.oom_guard("smoke/oversized_alloc"):
            torch.empty(nbytes, dtype=torch.uint8, device=device)
    except obs_memory.HbmExhaustedError as e:
        msg = str(e)
        cause = type(e.__cause__).__name__
    else:
        raise AssertionError(f"an allocation of {nbytes} bytes on a card "
                             f"of {total} did not fail")
    after = torch.ones(1 << 20, device=device).sum().item()
    return {"requested_bytes": nbytes, "free_bytes": free,
            "total_bytes": total, "cause": cause,
            "names_owners": all(o in msg for o in owners),
            "owners": sorted(owners),
            "first_line": msg.splitlines()[0][:200],
            "allocator_usable": after == float(1 << 20)}


def preflight_refusal(device: torch.device,
                      vocabulary_size: int = 1 << 32,
                      factor_num: int = 16) -> Dict[str, object]:
    """``preflight_capacity`` on a config whose plan exceeds the card:
    it must refuse before any allocation."""
    obs_memory.bind_device(device)
    cfg = FmConfig(vocabulary_size=vocabulary_size, factor_num=factor_num)
    before = torch.cuda.memory_allocated(device)
    try:
        obs_memory.preflight_capacity(cfg, "train")
    except ValueError as e:
        refused, msg = True, str(e)
    else:
        refused, msg = False, ""
    plan = obs_memory.plan(cfg, "train")
    return {"refused": refused, "plan_bytes": plan["total_bytes"],
            "capacity_bytes": plan["capacity_bytes"],
            "verdict": plan["verdict"],
            "allocated_before": before,
            "allocated_after": torch.cuda.memory_allocated(device),
            "first_line": msg.splitlines()[0][:200] if msg else ""}


def trace_kernel_counts(path: str,
                        names: Sequence[str] = KERNEL_NAMES
                        ) -> Dict[str, int]:
    """Kernel events of a Chrome trace (``export_chrome_trace``) whose
    name holds each of ``names``."""
    with open(path) as fh:
        events: List[dict] = json.load(fh).get("traceEvents", [])
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {n: sum(1 for k in kernels if n in k) for n in names}
