"""Device-memory ledger and capacity planner — a copy of
``fast_tffm_tpu/obs/memory.py``.

- **Ledger** (``LEDGER``): each long-lived device allocation the port
  makes (the table, the Adagrad accumulator, the wire double-buffers,
  prefetched batches, serve's table and its reload pair) registers under
  an owner tag with host-computed bytes (``nbytes``, never a fetch).
  ``ledger_gauges()`` derives the ``mem/*`` gauges every flush carries.
  On the card the ledger's live total counts only these owners: the
  caching allocator's ``memory_allocated()`` also counts a step's
  transients, so the ledger is at most the card's peak allocation,
  never equal to it.
- **Seam** (``device_memory_stats``): the one place the card's
  allocator statistics are read: ``torch.cuda.memory_stats`` and the
  card's total memory, under the JAX package's keys (``bytes_in_use``,
  ``peak_bytes_in_use``, ``bytes_limit``). A run on the CPU reports
  None by policy; ``FM_FAKE_HBM_BYTES`` injects a capacity for tests.
- **Pressure and OOM**: ``maybe_emit_pressure`` emits ``health:
  hbm_pressure`` once per episode past ``mem_pressure_fraction``;
  ``oom_guard`` re-raises ``torch.cuda.OutOfMemoryError`` as
  ``HbmExhaustedError`` carrying the rendered ledger (it frees nothing:
  the caching allocator stays usable).
- **Planner** (``plan``, ``render_plan``, ``parse_what_if``): predicted
  resident bytes per owner from the config alone; ``preflight_capacity``
  refuses a train or serve start whose plan exceeds the card.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, Optional

# The injected-capacity seam (tests, fmchaos oom-pressure): when set,
# device_memory_stats() reports this many bytes as the capacity and
# the ledger's live total as bytes_in_use, regardless of backend —
# the only way to exercise the capacity paths in the CPU container.
FAKE_CAPACITY_ENV = "FM_FAKE_HBM_BYTES"

F32_BYTES = 4
# What-if dtype names -> bytes per element (ROADMAP item 4's f16/int8
# resident-table sizing rides these).
DTYPE_BYTES = {"f32": 4, "float32": 4, "bf16": 2, "f16": 2,
               "float16": 2, "int8": 1}


def table_bytes(cfg=None, *, rows: Optional[int] = None,
                dim: Optional[int] = None,
                dtype_bytes: int = F32_BYTES) -> int:
    """The one table/accumulator sizing formula, ``rows * row_dim *
    dtype_bytes``, that the planner and the ledger share. ``rows`` defaults to ``cfg.num_rows`` (the runtime table); pass
    ``cfg.ckpt_rows`` for the 4096-aligned checkpoint layout the
    offload backends allocate, or explicit ``rows=``/``dim=`` where no
    config is in scope (lookup backends size from their own state)."""
    if rows is None:
        rows = cfg.num_rows
    if dim is None:
        dim = cfg.row_dim
    return int(rows) * int(dim) * int(dtype_bytes)


# --- the memory_stats seam ---------------------------------------------------

# The device the running entry point placed its state on (``bind_device``);
# None: the card when there is one.
_DEVICE = None


def bind_device(device) -> None:
    """Record the entry point's device, so a ``--device cpu`` run on a
    machine with a card reports no capacity."""
    global _DEVICE
    _DEVICE = device


def device_memory_stats() -> Optional[Dict[str, Any]]:
    """The one read of the card's allocator statistics: ``bytes_in_use``
    (``allocated_bytes.all.current``), ``peak_bytes_in_use``
    (``allocated_bytes.all.peak``) and ``bytes_limit`` (the card's
    total memory), or None on the CPU. ``FM_FAKE_HBM_BYTES`` overrides
    everything (the test seam). Reads host-side counters only: no
    synchronization with the card."""
    env = os.environ.get(FAKE_CAPACITY_ENV, "")
    if env:
        return {"bytes_limit": int(env),
                "bytes_in_use": LEDGER.live_bytes()}
    try:
        import torch
        if _DEVICE is not None:
            dev = torch.device(_DEVICE)
            if dev.type != "cuda":
                return None
        elif not torch.cuda.is_available():
            return None
        else:
            dev = torch.device("cuda")
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        stats = torch.cuda.memory_stats(idx)
        limit = torch.cuda.get_device_properties(idx).total_memory
    except Exception:  # noqa: BLE001 - no usable card: unmeasured
        return None
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(limit)}


def device_capacity_bytes() -> Optional[int]:
    """Device capacity from the seam, or None when unmeasurable — a 0
    must mean a MEASURED zero, never "couldn't measure" (the same
    policy lookup.memory_report documents)."""
    stats = device_memory_stats()
    if not stats:
        return None
    limit = stats.get("bytes_limit")
    if not limit:
        return None
    return int(limit)


# --- ownership ledger ------------------------------------------------------

class MemoryLedger:
    """Per-process registry of long-lived allocations by owner tag.

    ``register`` upserts an owner's current bytes (host-computed by
    the caller — ``.nbytes`` is a plain int attribute, never a fetch);
    ``release`` drops it. ``host=True`` owners (the host-offload
    table/accumulator) are tracked and gauged but excluded from the
    DEVICE live total — pressure and OOM forensics reason about HBM,
    and the offload backends exist precisely to hold state outside it.
    Thread-safe: the serve reload thread and dispatcher update
    concurrently with the train loop's wire buffers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._owners: Dict[str, int] = {}
        self._host_owners: Dict[str, int] = {}
        self._peak = 0
        self._in_pressure = False

    def register(self, owner: str, nbytes: int,
                 host: bool = False) -> None:
        with self._lock:
            book = self._host_owners if host else self._owners
            (self._owners if host else self._host_owners).pop(owner,
                                                              None)
            book[owner] = int(nbytes)
            live = sum(self._owners.values())
            if live > self._peak:
                self._peak = live

    def release(self, owner: str) -> None:
        with self._lock:
            self._owners.pop(owner, None)
            self._host_owners.pop(owner, None)

    def live_bytes(self) -> int:
        """Device-resident live total (host owners excluded)."""
        with self._lock:
            return sum(self._owners.values())

    def peak_bytes(self) -> int:
        with self._lock:
            return self._peak

    def owners(self) -> Dict[str, int]:
        """Device owners snapshot (copy)."""
        with self._lock:
            return dict(self._owners)

    def host_owners(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._host_owners)

    def begin_pressure_episode(self) -> bool:
        """True exactly once per episode: the first crossing arms it;
        further calls inside the episode return False."""
        with self._lock:
            if self._in_pressure:
                return False
            self._in_pressure = True
            return True

    def end_pressure_episode(self) -> None:
        with self._lock:
            self._in_pressure = False

    def reset(self) -> None:
        """Test/bench seam: forget every owner, the peak, and any open
        pressure episode (the ledger is process-global state)."""
        with self._lock:
            self._owners.clear()
            self._host_owners.clear()
            self._peak = 0
            self._in_pressure = False


LEDGER = MemoryLedger()


def ledger_gauges() -> Dict[str, float]:
    """The ``mem/*`` gauge rows for one telemetry flush: per-owner
    bytes, live total, peak watermark, and capacity + utilization
    where the seam provides one. Empty dict when nothing ever
    registered (pre-ledger streams and bare-registry tests stay
    byte-identical). Host arithmetic only — zero device fetches
    (pinned by tests/test_memory.py, the ``anatomy_gauges``
    contract)."""
    owners = LEDGER.owners()
    hosts = LEDGER.host_owners()
    peak = LEDGER.peak_bytes()
    if not owners and not hosts and not peak:
        return {}
    rows: Dict[str, float] = {}
    for name, v in owners.items():
        rows[f"mem/{name}_bytes"] = float(v)
    for name, v in hosts.items():
        rows[f"mem/{name}_bytes"] = float(v)
    live = float(sum(owners.values()))
    rows["mem/live_bytes"] = live
    rows["mem/peak_bytes"] = float(peak)
    if hosts:
        rows["mem/host_live_bytes"] = float(sum(hosts.values()))
    stats = device_memory_stats()
    if stats:
        cap = stats.get("bytes_limit")
        if cap:
            rows["mem/capacity_bytes"] = float(cap)
            rows["mem/utilization_fraction"] = live / float(cap)
        in_use = stats.get("bytes_in_use")
        if in_use is not None:
            rows["mem/device_in_use_bytes"] = float(in_use)
    return rows


def maybe_emit_pressure(tel) -> None:
    """``health: hbm_pressure`` — once per episode. Crossing
    ``mem_pressure_fraction`` of device capacity emits one event
    (owner breakdown attached) and counts ``mem/pressure_events``;
    dropping back below the threshold re-arms, exactly the Watchdog's
    stall-episode model. No-op when the knob is 0 (default) or the
    backend reports no capacity."""
    frac = float(getattr(tel, "mem_pressure_fraction", 0.0) or 0.0)
    if frac <= 0:
        return
    cap = device_capacity_bytes()
    if not cap:
        return
    live = LEDGER.live_bytes()
    ratio = live / float(cap)
    if ratio < frac:
        LEDGER.end_pressure_episode()
        return
    if not LEDGER.begin_pressure_episode():
        return
    tel.count("mem/pressure_events")
    tel.sink.emit("health", {
        "status": "hbm_pressure",
        "live_bytes": int(live),
        "capacity_bytes": int(cap),
        "fraction": round(ratio, 4),
        "threshold": frac,
        "owners": {k: int(v) for k, v in LEDGER.owners().items()},
    })
    tel.sink.flush()


# --- OOM forensics ---------------------------------------------------------

class HbmExhaustedError(RuntimeError):
    """A dispatch site's out-of-memory error re-raised with the rendered
    per-owner ledger attached: the OOM names which owner grew. Chains
    from the original error."""


def is_oom(e: BaseException) -> bool:
    """Whether ``e`` is the card's out-of-memory failure:
    ``torch.cuda.OutOfMemoryError``, or the allocator's message, or the
    JAX package's status strings."""
    import torch
    oom_type = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom_type is not None and isinstance(e, oom_type):
        return True
    msg = str(e)
    return ("CUDA out of memory" in msg
            or "RESOURCE_EXHAUSTED" in msg
            or "Resource exhausted" in msg
            or isinstance(e, HbmExhaustedError))


def render_ledger() -> str:
    """The per-owner breakdown block an OOM wrap (and fmstat's MEMORY
    section) renders: owners sorted by size, live/peak, capacity where
    known."""
    owners = LEDGER.owners()
    lines = ["device-memory ledger (per-owner resident bytes):"]
    for name, v in sorted(owners.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:<24} {_mb(v)}")
    for name, v in sorted(LEDGER.host_owners().items(),
                          key=lambda kv: -kv[1]):
        lines.append(f"  {name:<24} {_mb(v)} (host)")
    if not owners and not LEDGER.host_owners():
        lines.append("  (no owners registered)")
    lines.append(f"  {'live total':<24} {_mb(LEDGER.live_bytes())}")
    lines.append(f"  {'peak watermark':<24} {_mb(LEDGER.peak_bytes())}")
    cap = device_capacity_bytes()
    if cap:
        lines.append(f"  {'device capacity':<24} {_mb(cap)}")
    return "\n".join(lines)


@contextlib.contextmanager
def oom_guard(where: str):
    """Wrap one dispatch site (train step, score_batch, serve reload):
    an out-of-memory error re-raises as HbmExhaustedError carrying the
    rendered ledger; everything else passes through untouched. Frees
    nothing: what the failed call held is the allocator's to reuse."""
    try:
        yield
    except HbmExhaustedError:
        raise  # an inner guard already attributed it
    except Exception as e:
        if not is_oom(e):
            raise
        raise HbmExhaustedError(
            f"device out of memory at {where}: {e}\n"
            f"{render_ledger()}\n"
            "size a fix before rerunning: obs.memory.plan(cfg, kind, "
            "parse_what_if('vocabulary_size=...,dtype=f16,shards=K'))"
            ) from e


# --- capacity planner ------------------------------------------------------

def _mb(n) -> str:
    n = float(n)
    if n >= 1 << 30:
        return f"{n:,.0f} B ({n / (1 << 30):.2f} GB)"
    return f"{n:,.0f} B ({n / (1 << 20):.2f} MB)"


def parse_what_if(spec: str) -> Dict[str, Any]:
    """``--what-if vocabulary_size=1000000,dtype=f16,shards=4`` ->
    override dict. Numeric values parse as ints; ``dtype`` keeps its
    name (resolved against DTYPE_BYTES at plan time)."""
    out: Dict[str, Any] = {}
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"--what-if entry {part!r} is not key=value")
        k, v = part.split("=", 1)
        k, v = k.strip(), v.strip()
        if k == "dtype":
            if v not in DTYPE_BYTES:
                raise ValueError(
                    f"--what-if dtype {v!r} unknown; one of "
                    f"{sorted(DTYPE_BYTES)}")
            out[k] = v
        else:
            out[k] = int(v)
    return out


def plan(cfg, kind: str = "train",
         overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Predicted resident device bytes per owner, from config alone —
    what ``fmstat capacity`` renders and ``preflight_capacity``
    enforces, cross-checked against the live ledger by a tier-1 test
    (within 10% for the default shapes).

    ``overrides`` (the --what-if surface): ``vocabulary_size``,
    ``factor_num``, ``field_num``, ``batch_size``,
    ``max_features_per_example`` take numeric overrides; ``dtype``
    resizes the resident table (ROADMAP item 4 — the Adagrad
    accumulator stays f32: the quantization frontier quantizes the
    serving/resident table, not the optimizer state); ``shards``
    divides the per-device table/accumulator share (ROADMAP item 1's
    row-sharded mesh).

    ``kind="train"``: table + accumulator + wire double-buffers (+
    prefetch window). With ``lookup = host`` the table/accumulator
    move to the host-owner list — they are exactly what the offload
    mode keeps OUT of device memory. ``kind="serve"``: the resident
    table plus the old+new reload transient headroom a hot reload
    needs (serve/server._load_step holds both until the swap)."""
    o = dict(overrides or {})
    vocab = int(o.get("vocabulary_size", cfg.vocabulary_size))
    k = int(o.get("factor_num", cfg.factor_num))
    field = int(o.get("field_num", getattr(cfg, "field_num", 0)))
    dim = (k * field + 1
           if getattr(cfg, "model_type", "fm") == "ffm" else k + 1)
    dtype = o.get("dtype", "f32")
    shards = max(1, int(o.get("shards", 1)))
    batch = int(o.get("batch_size", cfg.batch_size))
    feats = int(o.get("max_features_per_example",
                      cfg.max_features_per_example))
    rows = vocab + 1  # num_rows: + the shared padding row
    tbl = table_bytes(rows=rows, dim=dim,
                      dtype_bytes=DTYPE_BYTES[dtype])
    acc = table_bytes(rows=rows, dim=dim)  # optimizer state stays f32
    per_shard_tbl = -(-tbl // shards)
    per_shard_acc = -(-acc // shards)
    # Wire double-buffer: depth 2 of the worst-case flat payload
    # (indices i32 + values f32 per slot, + per-example lengths) — the
    # encoder registers the ACTUAL shipped bytes at run time; this is
    # the from-config ceiling.
    wire = 2 * (batch * feats * (4 + F32_BYTES) + batch * 4)
    owners: Dict[str, int] = {}
    host_owners: Dict[str, int] = {}
    if kind == "serve":
        owners["serve_table"] = per_shard_tbl
        owners["serve_reload_transient"] = per_shard_tbl
    else:
        if getattr(cfg, "lookup", "device") == "host":
            host_owners["offload_table"] = per_shard_tbl
            host_owners["offload_acc"] = per_shard_acc
        else:
            owners["table"] = per_shard_tbl
            owners["adagrad_acc"] = per_shard_acc
        owners["wire_buffers"] = wire
    total = sum(owners.values())
    cap = device_capacity_bytes()
    out: Dict[str, Any] = {
        "kind": kind,
        "overrides": o,
        "owners": owners,
        "host_owners": host_owners,
        "total_bytes": int(total),
        "capacity_bytes": cap,
    }
    if cap:
        out["utilization_fraction"] = total / float(cap)
        out["verdict"] = "EXCEEDS" if total > cap else "FITS"
    else:
        out["verdict"] = "UNKNOWN (backend reports no capacity)"
    return out


def render_plan(p: Dict[str, Any]) -> str:
    """The human form of one plan: per-owner predicted bytes, total,
    capacity verdict — the fmstat capacity body and the pre-flight
    error's breakdown."""
    lines = [f"capacity plan ({p['kind']})"
             + (f" what-if {p['overrides']}" if p["overrides"] else "")
             + ":"]
    for name, v in sorted(p["owners"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  {name:<24} {_mb(v)}")
    for name, v in sorted(p["host_owners"].items(),
                          key=lambda kv: -kv[1]):
        lines.append(f"  {name:<24} {_mb(v)} (host-resident)")
    lines.append(f"  {'predicted device total':<24} "
                 f"{_mb(p['total_bytes'])}")
    cap = p.get("capacity_bytes")
    if cap:
        lines.append(f"  {'device capacity':<24} {_mb(cap)}")
        lines.append(f"  {'utilization':<24} "
                     f"{p['utilization_fraction']:.1%}")
    lines.append(f"verdict: {p['verdict']}")
    return "\n".join(lines)


def preflight_capacity(cfg, kind: str = "train") -> None:
    """Fail fast at train()/ScorerServer startup when the PREDICTED
    resident bytes exceed the device capacity — the planner's
    breakdown plus the exact what-if invocation to explore fixes,
    instead of an out-of-memory error minutes into bring-up. No-op when the
    backend reports no capacity (the CPU container)."""
    p = plan(cfg, kind)
    cap = p.get("capacity_bytes")
    if not cap or p["total_bytes"] <= cap:
        return
    raise ValueError(
        f"predicted resident device memory for this config exceeds "
        f"the device capacity ({_mb(p['total_bytes'])} > {_mb(cap)}) "
        f"— refusing to start rather than OOM mid-bring-up.\n"
        f"{render_plan(p)}\n"
        "explore fixes with obs.memory.plan(cfg, kind, parse_what_if("
        "'vocabulary_size=...,dtype=f16,shards=K')), or lookup = host "
        "for the beyond-HBM offload path")
