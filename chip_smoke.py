#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (fast_tffm_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernel is built for sm_90a) and the
CUDA toolkit's nvcc; exits non-zero, printing no result, without them.
It drives the port's serving path at full width — BASELINE config #2's
model: 2nd-order FM, factor_num = 16, hashed ids, vocabulary 2^24, a
[2^24+1, 17] f32 table (1.14 GB) drawn N(0, 0.1^2) from a seeded
torch.Generator — over Criteo-shaped lines it generates itself:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: the fm_score kernel library, with nvcc's register report;
3. kernel: the CUDA kernel against its plain PyTorch version at the
   main path's shapes, with errors, median times (CUDA events, L2 flushed
   between launches), bytes moved and the memory-bound floor;
4. predict: 65,536 lines through ``python -m fast_tffm_tpu_torch
   predict`` (in process), checked line by line and against a float64
   reference on the first lines;
5. serve: ScorerServer + HTTP front end on a free port, concurrent
   requests of 1-256 lines whose bodies must equal the predict file's
   lines byte for byte, one malformed request (400), /healthz;
6. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Any failed check raises, and the script exits non-zero. Scratch files
(the 1.14 GB .npz) live in ``.smoke/`` at the repo root and are removed
at the end. ``--out DIR`` also writes a JSON summary of every phase to
``DIR/chip_smoke.json``.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")

SEED = 20261017
VOCAB = 1 << 24
FACTORS = 16
PREDICT_LINES = 65536
PREDICT_BATCH = 8192
SERVE_MAX_BATCH = 256
KERNEL_SHAPES = ((256, 64, 16), (8192, 64, 16), (8192, 256, 16),
                 (1024, 64, 8))
HEADLINE_SHAPE = (8192, 64, 16)   # the predict batch of the main path
RTOL, ATOL = 1e-5, 1e-6
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12          # H100 SXM, non-tensor-core f32
L2_FLUSH_BYTES = 64 << 20         # > the 50 MB L2
TIMED_LAUNCHES = 30

# Criteo line format (the JAX package's data/synth.py:generate): 13
# numeric "I<j>:<log1p count>" tokens, ~8% dropped, then 26 hashed
# categorical "C<f>=v<id>" tokens with Zipf-skewed ids.
CAT_VOCABS = (40, 500, 90000, 30000, 200, 15, 10000, 400, 3, 25000,
              4000, 80000, 3000, 25, 8000, 60000, 10, 4000, 1500, 4,
              50000, 12, 14, 30000, 60, 20000)
NUM_FIELDS = 13
ZIPF_A = 1.35


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def criteo_lines(n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    cat = np.stack([(rng.zipf(ZIPF_A, size=n) - 1) % v for v in CAT_VOCABS],
                   axis=1)
    num = np.round(np.log1p(rng.lognormal(1.0, 1.2, size=(n, NUM_FIELDS))),
                   3)
    miss = rng.random((n, NUM_FIELDS)) < 0.08
    labels = (rng.random(n) < 0.25).astype(np.int32)
    lines = []
    for i in range(n):
        parts = [str(labels[i])]
        parts += [f"I{j}:{num[i, j]}" for j in range(NUM_FIELDS)
                  if not miss[i, j]]
        parts += [f"C{f}=v{cat[i, f]}" for f in range(len(CAT_VOCABS))]
        lines.append(" ".join(parts))
    return lines


def write_cfg(path):
    model = os.path.join(WORK, "model", "fm_model")
    with open(path, "w") as fh:
        fh.write(f"""[General]
vocabulary_size = {VOCAB}
hash_feature_id = True
factor_num = {FACTORS}
model_file = {model}
log_file = {os.path.join(WORK, 'fm.log')}

[Train]
batch_size = {PREDICT_BATCH}
loss_type = logistic

[Predict]
predict_files = {os.path.join(WORK, 'criteo.txt')}
score_path = {os.path.join(WORK, 'score')}

[Serve]
serve_port = 0
serve_max_batch = {SERVE_MAX_BATCH}
serve_max_wait_ms = 2
""")


def random_batch(torch, gen, B, L, pad_id, device):
    """Uniform random rows, values in [0, 1), a random pad tail per
    example (pad_id rows with value 0), laid out as make_device_batch
    lays out a batch."""
    idx = torch.randint(0, pad_id, (B, L), generator=gen, device=device,
                        dtype=torch.int32)
    vals = torch.rand((B, L), generator=gen, device=device)
    lengths = torch.randint(0, L + 1, (B, 1), generator=gen, device=device)
    tail = torch.arange(L, device=device)[None, :] >= lengths
    idx[tail] = pad_id
    vals[tail] = 0.0
    return idx, vals


def median_ms(torch, fn, flush):
    """Median of TIMED_LAUNCHES single-call CUDA-event times, after a
    warmup, with the L2 cache flushed (outside the timed span) before
    each call: a serving flush finds the table's rows cold."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def kernel_phase(torch, tables, device):
    from fast_tffm_tpu_torch.ops import fm_kernel, interaction
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    rows = []
    for B, L, K in KERNEL_SHAPES:
        table = tables[K]
        D = table.shape[1]
        idx, vals = random_batch(torch, gen, B, L, VOCAB, device)
        plain = interaction.fm_batch_scores(table, idx, vals)
        kern = fm_kernel.fm_batch_scores(table, idx, vals)
        torch.cuda.synchronize()
        diff = (kern - plain).abs()
        max_abs = float(diff.max())
        max_rel = float((diff / plain.abs().clamp_min(ATOL)).max())
        ok = bool((diff <= ATOL + RTOL * plain.abs()).all())
        ms = median_ms(torch, lambda: fm_kernel.fm_batch_scores(
            table, idx, vals), flush)
        plain_ms = median_ms(torch, lambda: interaction.fm_batch_scores(
            table, idx, vals), flush)
        nbytes = B * L * D * 4 + B * L * 8 + B * 4
        flops = B * (L * (4 * K + 2) + 3 * K + 2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / FP32_FLOPS_PER_S * 1e3
        row = {"phase": "kernel", "name": "fm_score", "B": B, "L": L,
               "K": K, "max_abs_err": max_abs, "max_rel_err": max_rel,
               "within_tol": ok, "rtol": RTOL, "atol": ATOL,
               "ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
               "flops": flops, "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
               "bound_share": max(bytes_ms, flops_ms) / ms}
        emit(row)
        rows.append(row)
        check(ok and bool(torch.isfinite(kern).all()),
              f"kernel disagrees with its plain version at B={B} L={L} "
              f"K={K}: max abs err {max_abs}")
    del flush
    return rows


def reference_scores(table_cpu, cfg, lines):
    """float64 numpy FM scores through sigmoid for ``lines``."""
    import numpy as np
    from fast_tffm_tpu_torch.data.parser import parse_lines
    block = parse_lines(lines, cfg.vocabulary_size, hash_feature_id=True,
                        max_features_per_example=cfg.max_features_per_example,
                        keep_empty=True)
    out = []
    for e in range(block.batch_size):
        lo, hi = block.poses[e], block.poses[e + 1]
        rows = table_cpu[block.ids[lo:hi]].astype(np.float64)
        x = block.vals[lo:hi].astype(np.float64)
        z = rows[:, :-1] * x[:, None]
        s = z.sum(0)
        raw = rows[:, -1] @ x + 0.5 * (s @ s - (z * z).sum())
        out.append(1.0 / (1.0 + np.exp(-raw)))
    return np.asarray(out)


def predict_phase(torch, cfg, cfg_path, table_cpu, lines, device):
    import numpy as np
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.predict import load_table
    t0 = time.perf_counter()
    load_table(cfg, device).sum().item()
    load_s = time.perf_counter() - t0
    fm_kernel.launches = 0
    t0 = time.perf_counter()
    rc = cli(["predict", cfg_path, "--device", device.type])
    total_s = time.perf_counter() - t0
    launches = fm_kernel.launches
    check(rc == 0, f"predict entry point returned {rc}")
    with open(os.path.join(cfg.score_path, "criteo.txt.score")) as fh:
        score_lines = fh.read().splitlines(keepends=True)
    check(len(score_lines) == len(lines),
          f"{len(score_lines)} scores for {len(lines)} lines")
    scores = np.array([float(s) for s in score_lines])
    check(np.isfinite(scores).all() and (scores >= 0).all()
          and (scores <= 1).all(), "predict scores outside [0, 1]")
    ref = reference_scores(table_cpu, cfg, lines[:512])
    ref_err = float(np.abs(scores[:512] - ref).max())
    # %.6f rounds by up to 5e-7; f32 against f64 adds well under 1e-6.
    check(ref_err <= 2e-6, f"predict vs float64 reference: {ref_err}")
    check(launches == -(-len(lines) // PREDICT_BATCH),
          f"predict launched the kernel {launches} times")
    row = {"phase": "predict", "lines": len(lines),
           "batch_size": PREDICT_BATCH, "entry_seconds": total_s,
           "npz_load_seconds": load_s,
           "examples_per_s_end_to_end": len(lines) / total_s,
           "examples_per_s_after_load": len(lines) / (total_s - load_s),
           "launches": launches, "max_err_vs_float64_reference": ref_err,
           "score_std": float(scores.std())}
    emit(row)
    return row, score_lines


def post(port, body, timeout=120):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                 data=body.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serve_phase(torch, cfg, lines, score_lines, device):
    import numpy as np
    import urllib.request
    from fast_tffm_tpu_torch.ops import fm_kernel
    from fast_tffm_tpu_torch.serve.frontend import make_http_server
    from fast_tffm_tpu_torch.serve.server import ScorerServer
    fm_kernel.launches = 0
    t0 = time.perf_counter()
    server = ScorerServer(cfg, device=device)
    startup_s = time.perf_counter() - t0
    warm_launches = fm_kernel.launches
    httpd = make_http_server(server, 0)
    http_thread = threading.Thread(target=httpd.serve_forever,
                                   name="smoke-http", daemon=True)
    http_thread.start()
    port = httpd.server_address[1]
    rng = np.random.default_rng(SEED + 2)
    sizes = [1, SERVE_MAX_BATCH] + [int(n) for n in
                                    rng.integers(1, SERVE_MAX_BATCH + 1, 46)]
    spans = [(int(rng.integers(0, len(lines) - n + 1)), n) for n in sizes]
    results = [None] * len(spans)
    latencies = [None] * len(spans)
    n_clients = 8

    def client(k):
        for i in range(k, len(spans), n_clients):
            lo, n = spans[i]
            t = time.perf_counter()
            results[i] = post(port, "\n".join(lines[lo:lo + n]) + "\n")
            latencies[i] = (time.perf_counter() - t) * 1e3

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_clients)]
        for th in threads:
            th.start()
        bad_status, bad_body = post(port, lines[0] + "\n1 I1:x:y:z\n")
        for th in threads:
            th.join(timeout=300)
            check(not th.is_alive(), "a serve client hung")
        for (lo, n), (status, body) in zip(spans, results):
            check(status == 200, f"serve answered {status}: {body[:200]}")
            check(body == "".join(score_lines[lo:lo + n]).encode(),
                  f"serve body for lines [{lo}, {lo + n}) differs from "
                  "the predict file")
        check(bad_status == 400, f"malformed request answered {bad_status}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
        check(health["alive"] and health["ready"]
              and health["requests"] == len(spans)
              and health["flush_errors"] == 0, f"/healthz: {health}")
    finally:
        httpd.shutdown()
        http_thread.join(timeout=60)
        httpd.server_close()
        server.close()
    launches = fm_kernel.launches
    check(launches > warm_launches > 0,
          f"serve launches: {warm_launches} at warmup, {launches} after "
          "the requests")
    lat = sorted(latencies)
    row = {"phase": "serve", "requests": len(spans), "clients": n_clients,
           "lines": sum(sizes), "startup_seconds": startup_s,
           "warmup_launches": warm_launches,
           "request_launches": launches - warm_launches,
           "launches": launches, "flushes": health["flushes"],
           "round_trip_ms_median": lat[len(lat) // 2],
           "round_trip_ms_max": lat[-1], "malformed_status": bad_status,
           "server_p50_ms": health["latency_p50_ms"],
           "server_p99_ms": health["latency_p99_ms"]}
    emit(row)
    return row


def main(argv) -> int:
    out_dir = None
    if argv[:1] == ["--out"] and len(argv) == 2:
        out_dir = argv[1]
    elif argv:
        print("usage: python3 chip_smoke.py [--out DIR]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.models.convert import save_npz
    from fast_tffm_tpu_torch.ops import build

    device = torch.device("cuda")
    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}")
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.build(log=lambda text: print(text, end="", flush=True))
    build.load_fm_score()
    print(f"build+load seconds {time.perf_counter() - t0:.2f}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        cfg_path = os.path.join(WORK, "smoke.cfg")
        write_cfg(cfg_path)
        cfg = load_config(cfg_path)
        gen = torch.Generator(device=device).manual_seed(SEED)
        tables = {}
        for K in sorted({k for _, _, k in KERNEL_SHAPES}):
            t = torch.randn((VOCAB + 1, K + 1), generator=gen,
                            device=device) * 0.1
            t[-1] = 0.0
            tables[K] = t
        table = tables[FACTORS]
        t0 = time.perf_counter()
        save_npz(table, cfg.model_file + ".npz", cfg)
        print(f"saved {cfg.model_file}.npz "
              f"({os.path.getsize(cfg.model_file + '.npz') / 1e9:.2f} GB) "
              f"in {time.perf_counter() - t0:.1f}s", flush=True)

        # 3. kernel vs plain version
        kernel_rows = kernel_phase(torch, tables, device)
        table_cpu = table.cpu().numpy()
        del tables, table
        torch.cuda.empty_cache()

        # 4. predict
        lines = criteo_lines(PREDICT_LINES, SEED + 3)
        with open(os.path.join(WORK, "criteo.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
        predict_row, score_lines = predict_phase(torch, cfg, cfg_path,
                                                 table_cpu, lines, device)

        # 5. serve
        serve_row = serve_phase(torch, cfg, lines, score_lines, device)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    head = next(r for r in kernel_rows
                if (r["B"], r["L"], r["K"]) == HEADLINE_SHAPE)
    kernels = {"kernels": [{
        "name": "fm_score", "route": "cuda",
        "source": "fast_tffm_tpu_torch/csrc/fm_score.cu",
        "replaces": "fast_tffm_tpu/ops/pallas_fm.py:63",
        "launches": predict_row["launches"] + serve_row["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape_BLK": list(HEADLINE_SHAPE),
        "predict_launches": predict_row["launches"],
        "serve_launches": serve_row["launches"]}]}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
            json.dump({"nvidia_smi": smi, "kernel": kernel_rows,
                       "predict": predict_row, "serve": serve_row,
                       **kernels}, fh, indent=1)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
