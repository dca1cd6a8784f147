"""fmckpt — inspect, verify, publish and garbage-collect the port's
checkpoint directory; a copy of the JAX package's ``tools/fmckpt``
(``ls``, ``verify``, ``publish``, ``gc``) over the port's
checkpoint.py, with the same output lines and exit codes.

    python -m fast_tffm_tpu_torch.tools.fmckpt ls <model_file | dir.ckpt>
    python -m fast_tffm_tpu_torch.tools.fmckpt verify <path>
                                  [--mode size|full] [--step N]
    python -m fast_tffm_tpu_torch.tools.fmckpt publish <path> <step>
                                  [--mode size|full] [--canary]
    python -m fast_tffm_tpu_torch.tools.fmckpt gc <path> [--dry-run]

- ``ls``      one row per committed step — file count, bytes, the
              manifest's epoch/vocab echo (epoch-override sidecars
              applied, as restore applies them), ``+watermark`` where a
              stream run left the step's position, ``+VOCAB`` where an
              admit-mode run left its slot map — plus every quarantined
              ``corrupt-*`` dir and orphaned sidecar, and the PUBLISHED /
              CANARY marks.
- ``verify``  the manifest integrity check over every step (or one
              ``--step``): sizes, plus a crc32 re-hash under ``--mode
              full`` (the default here), and each vocab sidecar's
              embedded crc32. Steps without a manifest report
              UNVERIFIABLE, not FAIL. Exit 1 on any failure. Read-only:
              the tool never quarantines.
- ``publish`` verify a committed step, then atomically repoint the
              ``published`` pointer (``--canary``: ``published-canary``)
              at it — the signal a serving process's hot-reload poll
              watches. A missing step, a failed verification or a torn
              vocab sidecar leaves the pointer untouched (exit 1).
- ``gc``      delete quarantined ``corrupt-*`` dirs and orphaned
              sidecars (watermarks and vocab sidecars included) whose
              step no longer exists; ``--dry-run`` lists without
              deleting. Committed steps are never touched.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from typing import Dict, List, Optional

from fast_tffm_tpu_torch.checkpoint import (QUARANTINE_PREFIX,
                                            list_step_dirs,
                                            load_vocab_sidecar, read_canary,
                                            read_epoch_override,
                                            read_manifest, read_published,
                                            sidecar_step, verify_step_dir,
                                            vocab_sidecar_path,
                                            watermark_path, write_canary,
                                            write_published)


def resolve_ckpt_dir(path: str) -> str:
    """Accept a ``model_file`` prefix (the config value) or the
    ``.ckpt`` directory itself."""
    p = os.path.abspath(path)
    if os.path.isdir(p) and p.endswith(".ckpt"):
        return p
    if os.path.isdir(p + ".ckpt"):
        return p + ".ckpt"
    raise FileNotFoundError(
        f"no checkpoint directory at {p} or {p}.ckpt "
        "(pass the config's model_file, or the .ckpt dir itself)")


def _walk_size(d: str) -> Dict[str, int]:
    files = 0
    size = 0
    for root, _dirs, names in os.walk(d):
        for name in names:
            files += 1
            try:
                size += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return {"files": files, "bytes": size}


def scan(directory: str) -> Dict[str, object]:
    """Everything ``ls``/``gc`` need in one pass: committed steps (with
    manifest echo + sidecar-corrected epoch), quarantined dirs, orphaned
    sidecars, and the two pointers."""
    steps: List[Dict[str, object]] = []
    for s in list_step_dirs(directory):
        info = _walk_size(os.path.join(directory, str(s)))
        man = None
        try:
            man = read_manifest(directory, s)
        except ValueError:
            pass  # garbled manifest: reported by verify, listed here
        epoch = man.get("epoch") if man else None
        override = read_epoch_override(directory, s)
        steps.append({
            "step": s, "files": info["files"], "bytes": info["bytes"],
            "manifest": man is not None,
            "epoch": override if override is not None else epoch,
            "vocab": man.get("vocab") if man else None,
            # Existence only: which steps can resume a stream position,
            # and which carry a slot map (verify owns the crc).
            "watermark": os.path.exists(watermark_path(directory, s)),
            "vocab_sidecar": os.path.exists(vocab_sidecar_path(directory,
                                                               s)),
        })
    quarantined: List[Dict[str, object]] = []
    orphans: List[str] = []
    kept = {s["step"] for s in steps}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        names = []
    for name in names:
        full = os.path.join(directory, name)
        if name.startswith(QUARANTINE_PREFIX) and os.path.isdir(full):
            quarantined.append({"name": name, **_walk_size(full)})
            continue
        s = sidecar_step(name)
        if s is not None and s not in kept:
            orphans.append(name)
    return {"directory": directory, "steps": steps,
            "quarantined": quarantined, "orphans": orphans,
            "published": read_published(directory),
            "canary": read_canary(directory)}


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return (f"{n:.1f} {unit}" if unit != "B" else f"{n} B")
        n /= 1024.0
    return f"{n} B"


def cmd_ls(directory: str, as_json: bool = False, out=None) -> int:
    out = out or sys.stdout
    state = scan(directory)
    if as_json:
        out.write(json.dumps(state) + "\n")
        return 0
    out.write(f"checkpoint dir: {directory}\n")
    if not state["steps"]:
        out.write("  no committed steps\n")
    for s in state["steps"]:
        man = "manifest" if s["manifest"] else "NO MANIFEST (legacy)"
        epoch = "?" if s["epoch"] is None else s["epoch"]
        vocab = "?" if s["vocab"] is None else s["vocab"]
        marks = ""
        if s["watermark"]:
            marks += " +watermark"
        if s["vocab_sidecar"]:
            marks += " +VOCAB"
        if state["published"] == s["step"]:
            marks += "  PUBLISHED"
        if state["canary"] == s["step"]:
            marks += "  CANARY"
        out.write(f"  step {s['step']:<10} {s['files']:>4} files "
                  f"{_fmt_bytes(s['bytes']):>10}  epoch={epoch} "
                  f"vocab={vocab}  {man}{marks}\n")
    committed = {s["step"] for s in state["steps"]}
    if state["published"] is not None and \
            state["published"] not in committed:
        out.write(f"  published -> step {state['published']} "
                  "(MISSING: the pointed-at step is gone — GC'd or "
                  "quarantined since the publish)\n")
    if state["canary"] is not None and state["canary"] not in committed:
        out.write(f"  published-canary -> step {state['canary']} "
                  "(MISSING: the pointed-at step is gone — the canary "
                  "replica falls back to the published step)\n")
    for q in state["quarantined"]:
        out.write(f"  {q['name']:<15} {q['files']:>4} files "
                  f"{_fmt_bytes(q['bytes']):>10}  QUARANTINED "
                  "(reclaim with: fmckpt gc)\n")
    for o in state["orphans"]:
        out.write(f"  {o}  ORPHANED sidecar (its step is gone)\n")
    return 0


def _verify_vocab_sidecar(directory: str, step: int):
    """(note, failed) for a step's vocab sidecar: absent -> ("", False);
    readable with a matching crc32 -> (", +vocab crc OK", False); torn
    or garbled -> (the reason, True). The decision is
    ``checkpoint.load_vocab_sidecar``, the reader restore uses."""
    payload, reason = load_vocab_sidecar(directory, step)
    if reason is not None:
        return reason, True
    if payload is None:
        return "", False
    return ", +vocab crc OK", False


def cmd_verify(directory: str, mode: str = "full",
               step: Optional[int] = None, out=None) -> int:
    out = out or sys.stdout
    committed = list_step_dirs(directory)
    if step is not None:
        if step not in committed:
            out.write(f"step {step}: MISSING — not a committed step "
                      f"(committed: {committed or 'none'})\n")
            return 1
        steps = [step]
    else:
        steps = committed
    if not steps:
        out.write(f"{directory}: no committed steps to verify\n")
        return 0
    failures = 0
    for s in steps:
        try:
            man = read_manifest(directory, s)
        except ValueError:
            man = "garbled"
        vocab_note, vocab_fail = _verify_vocab_sidecar(directory, s)
        if man is None:
            out.write(f"step {s}: UNVERIFIABLE (predates manifests; "
                      "restore accepts it as-is)\n")
            if vocab_fail:
                failures += 1
                out.write(f"step {s}: FAIL — {vocab_note}\n")
            continue
        reason = verify_step_dir(directory, s, mode)
        if reason is None and vocab_fail:
            reason = vocab_note
        if reason is None:
            n = len(man["files"]) if isinstance(man, dict) else "?"
            out.write(f"step {s}: OK ({mode} check, {n} files"
                      f"{vocab_note})\n")
        else:
            failures += 1
            out.write(f"step {s}: FAIL — {reason}\n")
    if failures:
        out.write(f"fmckpt: {failures} step(s) failed verification; "
                  "restore would quarantine and fall back\n")
    return 1 if failures else 0


def cmd_publish(directory: str, step: int, mode: str = "size",
                canary: bool = False, out=None) -> int:
    """Verify-then-repoint: the pointer moves only when the step exists
    and passes the manifest check at ``mode``, through the same atomic
    write ``CheckpointState.publish_step`` uses."""
    out = out or sys.stdout
    committed = list_step_dirs(directory)
    if step not in committed:
        out.write(f"step {step}: MISSING — not a committed step "
                  f"(committed: {committed or 'none'}); pointer "
                  "untouched\n")
        return 1
    reason = verify_step_dir(directory, step, mode)
    if reason is None:
        # A torn vocab sidecar fails the publish too: every admit-mode
        # reload of the step would fail.
        vocab_note, vocab_fail = _verify_vocab_sidecar(directory, step)
        if vocab_fail:
            reason = vocab_note
    if reason is not None:
        out.write(f"step {step}: FAIL — {reason}; pointer untouched\n")
        return 1
    if canary:
        prev = read_canary(directory)
        path = write_canary(directory, step)
        label = "published-canary"
    else:
        prev = read_published(directory)
        path = write_published(directory, step)
        label = "published"
    frm = f"step {prev} -> " if prev is not None else ""
    out.write(f"{label} {frm}step {step} ({mode}-verified) -> "
              f"{path}\n")
    return 0


def cmd_gc(directory: str, dry_run: bool = False, out=None) -> int:
    out = out or sys.stdout
    state = scan(directory)
    reclaimed = 0
    for q in state["quarantined"]:
        full = os.path.join(directory, q["name"])
        if dry_run:
            out.write(f"would delete {full} ({_fmt_bytes(q['bytes'])})\n")
        else:
            shutil.rmtree(full, ignore_errors=True)
            out.write(f"deleted {full} ({_fmt_bytes(q['bytes'])})\n")
        reclaimed += int(q["bytes"])
    for o in state["orphans"]:
        full = os.path.join(directory, o)
        if dry_run:
            out.write(f"would delete orphaned sidecar {full}\n")
        else:
            try:
                os.remove(full)
            except OSError:
                pass
            out.write(f"deleted orphaned sidecar {full}\n")
    verb = "would reclaim" if dry_run else "reclaimed"
    out.write(f"fmckpt gc: {verb} {_fmt_bytes(reclaimed)} across "
              f"{len(state['quarantined'])} quarantined dir(s), "
              f"{len(state['orphans'])} orphaned sidecar(s)\n")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="fmckpt", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ls = sub.add_parser("ls", help="list steps / quarantine / orphans")
    p_ls.add_argument("path")
    p_ls.add_argument("--json", action="store_true")
    p_v = sub.add_parser("verify", help="manifest integrity check")
    p_v.add_argument("path")
    p_v.add_argument("--mode", choices=("size", "full"), default="full")
    p_v.add_argument("--step", type=int, default=None)
    p_pub = sub.add_parser(
        "publish", help="verify a step, then atomically repoint the "
                        "published pointer at it")
    p_pub.add_argument("path")
    p_pub.add_argument("step", type=int)
    p_pub.add_argument("--mode", choices=("size", "full"),
                       default="size")
    p_pub.add_argument("--canary", action="store_true",
                       help="repoint the published-canary pointer "
                            "instead of published")
    p_gc = sub.add_parser("gc", help="delete quarantined dirs + orphans")
    p_gc.add_argument("path")
    p_gc.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    try:
        directory = resolve_ckpt_dir(args.path)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    if args.cmd == "ls":
        return cmd_ls(directory, as_json=args.json)
    if args.cmd == "verify":
        return cmd_verify(directory, mode=args.mode, step=args.step)
    if args.cmd == "publish":
        return cmd_publish(directory, args.step, mode=args.mode,
                           canary=args.canary)
    return cmd_gc(directory, dry_run=args.dry_run)


if __name__ == "__main__":
    sys.exit(main())
