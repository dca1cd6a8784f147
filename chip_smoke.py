#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (fast_tffm_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the
CUDA toolkit's nvcc; exits non-zero, printing no result, without them.
It drives the port's serving and training paths at full width —
BASELINE config #2's model: 2nd-order FM, factor_num = 16, hashed ids,
vocabulary 2^24, a [2^24+1, 17] f32 table (1.14 GB) — over
Criteo-shaped lines it generates itself:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: both kernel libraries, one nvcc each, started together, with
   nvcc's register report;
3. kernel: each CUDA kernel against its plain PyTorch version at the
   main path's shapes (fm_score bit for bit, also on the first predict
   batch's Zipf-skewed raw ids), with errors, median times (CUDA events,
   L2 flushed between launches), the kernel's device time alone (a
   profiler trace of bare launches, or CUDA events around them where
   the trace misses the kernel), bytes moved and the bound. Tables are
   drawn N(0, 0.1^2) from a seeded torch.Generator;
4. predict: 65,536 lines through ``python -m fast_tffm_tpu_torch
   predict`` (in process), checked line by line and against a float64
   reference on the first lines;
5. serve: ScorerServer + HTTP front end on a free port, concurrent
   requests of 1-256 lines whose bodies must equal the predict file's
   lines byte for byte, one malformed request (400), /healthz;
6. train: ``python -m fast_tffm_tpu_torch train`` (in process) for 2
   epochs over 131,072 lines whose labels come from a planted logistic
   model, validating on 16,384 more; both kernels must launch, the mean
   loss must fall, the validation AUC must clear a floor derived from the
   planted model, and predict of the export must reach the same AUC.
   Then both kernels against their plain versions on one of the
   stream's Zipf-skewed batches (fm_score with L2 warm, as in the step;
   fm_score_bwd also with the numeric fields' slots zeroed, which takes
   its hottest rows away), the median time of one step on batches
   already on the card, its kernels' device time from a profiler trace,
   and the card's idle share computed from them;
7. the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Any failed check raises, and the script exits non-zero. Scratch files
(1.14 GB .npz exports) live in ``.smoke/`` at the repo root and are
removed at the end. ``--out DIR`` also writes a JSON summary of every phase to
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
# fm_score must equal its plain version bit for bit; ATOL floors |plain|
# in the relative error its rows report.
ATOL = 1e-6
# fm_score_bwd: float atomics sum in a varying order, so each element is
# held to BWD_RTOL of its sum of absolute contributions, plus BWD_ATOL.
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6
TRAIN_LINES = 131072
VAL_LINES = 16384
TRAIN_BATCH = 8192
TRAIN_EPOCHS = 2
TRAIN_LR = 0.1
RESIDENT_BATCHES = 4
RESIDENT_STEPS = 20
PROFILED_STEPS = 8
AUC_GAP = 2e-3               # |exact AUC of predict - binned AUC|
HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12          # H100 SXM, non-tensor-core f32
L2_FLUSH_BYTES = 64 << 20         # > the 50 MB L2
TIMED_LAUNCHES = 30
PROFILED_LAUNCHES = 10
PROFILE_ATTEMPTS = 5
SPIN_CYCLES = 2_000_000           # ~1 ms of the card's clock

# Criteo line format (the JAX package's data/synth.py:generate): 13
# numeric "I<j>:<log1p count>" tokens, ~8% dropped, then 26 hashed
# categorical "C<f>=v<id>" tokens with Zipf-skewed ids.
CAT_VOCABS = (40, 500, 90000, 30000, 200, 15, 10000, 400, 3, 25000,
              4000, 80000, 3000, 25, 8000, 60000, 10, 4000, 1500, 4,
              50000, 12, 14, 30000, 60, 20000)
NUM_FIELDS = 13
ZIPF_A = 1.35
# Train phase labels: a logistic model over the categorical fields with
# at most 25 values (C5, C8, C13, C16, C19, C21, C22).
PLANTED_FIELDS = tuple(f for f, v in enumerate(CAT_VOCABS) if v <= 25)
PLANTED_SCALE = 0.8
PLANTED_BIAS = -1.2


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def criteo_lines(n, seed, planted=None):
    """``n`` Criteo-shaped lines. Labels are Bernoulli(0.25), or, with
    ``planted`` (a PLANTED_* model), Bernoulli(sigmoid(planted logit));
    returns (lines, planted logits or None)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    cat = np.stack([(rng.zipf(ZIPF_A, size=n) - 1) % v for v in CAT_VOCABS],
                   axis=1)
    num = np.round(np.log1p(rng.lognormal(1.0, 1.2, size=(n, NUM_FIELDS))),
                   3)
    miss = rng.random((n, NUM_FIELDS)) < 0.08
    logits = None
    if planted is None:
        labels = (rng.random(n) < 0.25).astype(np.int32)
    else:
        logits = planted_logits(planted, cat)
        labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))
                  ).astype(np.int32)
    lines = []
    for i in range(n):
        parts = [str(labels[i])]
        parts += [f"I{j}:{num[i, j]}" for j in range(NUM_FIELDS)
                  if not miss[i, j]]
        parts += [f"C{f}=v{cat[i, f]}" for f in range(len(CAT_VOCABS))]
        lines.append(" ".join(parts))
    return lines, logits


def planted_model(seed):
    """The planted logistic model of the train phase: an intercept and
    one N(0, PLANTED_SCALE^2) weight per value of each field in
    PLANTED_FIELDS (the low-cardinality categorical fields)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return {f: rng.normal(0.0, PLANTED_SCALE, size=CAT_VOCABS[f])
            for f in PLANTED_FIELDS}


def planted_logits(model, cat):
    import numpy as np
    logits = np.full(cat.shape[0], PLANTED_BIAS)
    for f, beta in model.items():
        logits += beta[cat[:, f]]
    return logits


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
    each call: a serving flush finds the table's rows cold. ``flush``
    None leaves L2 warm, as a train step finds the rows it just
    gathered."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMED_LAUNCHES):
        if flush is not None:
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


def profiled_ms(torch, launch, flush, kernel_name):
    """Mean device time of the kernel named ``kernel_name`` over
    PROFILED_LAUNCHES calls of ``launch.run`` under torch.profiler, L2
    flushed (unless ``flush`` is None) and the outputs reset
    (``launch.reset``) before each: the kernel alone. The profiler now
    and then returns a trace without the records of a kernel launched
    through ctypes; such a trace is taken again, up to PROFILE_ATTEMPTS
    times in all, and then None."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_LAUNCHES):
                if flush is not None:
                    flush.zero_()
                launch.reset()
                launch.run()
            torch.cuda.synchronize()
        us, n = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    kernel_name in e.key:
                us += e.self_device_time_total
                n += e.count
        if n == PROFILED_LAUNCHES:
            return us / 1e3 / n
    return None


def event_ms(torch, launch, flush):
    """Median device time of ``launch.run`` by CUDA events around the
    launch alone, recorded behind a spin of the card long enough that the
    host has queued the launch and the end event before the card reaches
    the start event, so no host work falls inside; they do add the
    card's few microseconds from event to kernel and back."""
    pairs = []
    for _ in range(PROFILED_LAUNCHES):
        if flush is not None:
            flush.zero_()
        launch.reset()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch.run()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def kernel_ms(torch, launch, flush, kernel_name):
    """(device ms of the kernel alone, "profiler" or "events"): by
    profiled_ms, or by event_ms where the profiler keeps missing it."""
    launch.reset()
    launch.run()  # warm up
    ms = profiled_ms(torch, launch, flush, kernel_name)
    if ms is not None:
        return ms, "profiler"
    return event_ms(torch, launch, flush), "events"


class Launch:
    """A bare kernel launch on outputs allocated beforehand (``run``),
    and what puts those outputs back as a fresh call would find them
    (``reset``: dparams zeroed, which also leaves it in L2 as the
    wrapper's torch.zeros_like does)."""

    def __init__(self, run, reset=lambda: None):
        self.run, self.reset = run, reset


def fwd_launch(torch, params, idx, vals):
    """A bare launch of this tree's fm_score (what the wrapper launches,
    without its checks and allocation), on an output allocated here."""
    from fast_tffm_tpu_torch.ops import build
    lib = build.load_fm_score()
    (N, D), (B, L) = params.shape, idx.shape
    out = torch.empty(B, dtype=torch.float32, device=params.device)

    def run():
        rc = lib.fm_score_forward(
            params.data_ptr(), idx.data_ptr(), vals.data_ptr(),
            out.data_ptr(), N, D, B, L, params.device.index,
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"fm_score launch failed: {rc}")
    return Launch(run)


def bwd_launch(torch, params, idx, vals, g, need_dx):
    """A bare launch of this tree's fm_score_bwd on outputs allocated
    here."""
    from fast_tffm_tpu_torch.ops import build
    lib = build.load_fm_score_bwd()
    (N, D), (B, L) = params.shape, idx.shape
    dparams = torch.zeros_like(params)
    dvals = torch.empty((B, L), dtype=torch.float32, device=vals.device)

    def run():
        rc = lib.fm_score_bwd(
            params.data_ptr(), idx.data_ptr(), vals.data_ptr(),
            g.data_ptr(), dparams.data_ptr(), dvals.data_ptr(), N, D, B, L,
            int(need_dx), params.device.index,
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"fm_score_bwd launch failed: {rc}")
    return Launch(run, dparams.zero_)


def fwd_kernel_row(torch, table, idx, vals, flush, **tags):
    """fm_score against its plain version on one input: bit-equal, or a
    raised SmokeFailure; times, bytes and bound in one row (emitted,
    tagged with ``tags``). ``flush`` None times it with L2 warm."""
    from fast_tffm_tpu_torch.ops import fm_kernel, interaction
    B, L = idx.shape
    D = table.shape[1]
    K = D - 1
    plain = interaction.fm_batch_scores(table, idx, vals)
    kern = fm_kernel.fm_batch_scores(table, idx, vals)
    torch.cuda.synchronize()
    diff = (kern - plain).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / plain.abs().clamp_min(ATOL)).max())
    bit_equal = bool(torch.equal(kern, plain))
    check(bit_equal and bool(torch.isfinite(kern).all()),
          f"fm_score differs from its plain version on {tags} at B={B} "
          f"L={L} K={K}: max abs err {max_abs}")
    ms = median_ms(torch, lambda: fm_kernel.fm_batch_scores(
        table, idx, vals), flush)
    plain_ms = median_ms(torch, lambda: interaction.fm_batch_scores(
        table, idx, vals), flush)
    new = fwd_launch(torch, table, idx, vals)
    device_ms, timing = kernel_ms(torch, new, flush, "fm_score_kernel")
    # Each input read once: the U distinct rows the batch references
    # (all pad cells share one), idx and vals; the scores written.
    U = int(torch.unique(idx).numel())
    nbytes = U * D * 4 + B * L * 8 + B * 4
    flops = B * (L * (4 * K + 2) + 3 * K + 2)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    row = {"phase": "kernel", "name": "fm_score", **tags, "B": B, "L": L,
           "K": K, "U": U, "l2": "cold" if flush is not None else "warm",
           "bit_equal": bit_equal, "max_abs_err": max_abs,
           "max_rel_err": max_rel, "ms": ms, "plain_ms": plain_ms,
           "device_ms": device_ms, "device_timing": timing,
           "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
           "bound_share": bound_ms / ms,
           "bound_share_device": bound_ms / device_ms}
    emit(row)
    return row


def kernel_phase(torch, tables, predict_batch, device):
    """fm_score at the kernel shapes on uniform rows, then on the first
    predict batch (raw, Zipf-skewed ids into the 2^24 table)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    rows = []
    for B, L, K in KERNEL_SHAPES:
        idx, vals = random_batch(torch, gen, B, L, VOCAB, device)
        rows.append(fwd_kernel_row(torch, tables[K], idx, vals, flush,
                                   batch="uniform"))
    idx, vals = predict_batch
    rows.append(fwd_kernel_row(torch, tables[FACTORS], idx, vals, flush,
                               batch="predict"))
    del flush
    return rows


def bwd_kernel_rows(torch, params, local, vals, g, flush,
                    need_dx_cases=(False, True), **tags):
    """fm_score_bwd against its plain version on one input, for each
    ``need_dx`` in ``need_dx_cases``: a row each (emitted, tagged with
    ``tags``), or a raised SmokeFailure. ``flush`` None times it with L2
    warm."""
    from fast_tffm_tpu_torch.ops import fm_kernel, interaction
    B, L = local.shape
    U, D = params.shape
    K = D - 1
    dp, dv, dp_abs, dv_abs = interaction.fm_batch_scores_bwd(
        params, local, vals, g, need_dx=True, magnitudes=True)
    rows = []
    for need_dx in need_dx_cases:
        kdp, kdv = fm_kernel.fm_batch_scores_bwd(params, local, vals, g,
                                                 need_dx)
        torch.cuda.synchronize()
        err = (kdp - dp).abs()
        bound = BWD_ATOL + BWD_RTOL * dp_abs
        ok = bool((err <= bound).all()) and bool(torch.isfinite(kdp).all())
        max_abs = float(err.max())
        excess = float((err - bound).max())
        if need_dx:
            derr = (kdv - dv).abs()
            dbound = BWD_ATOL + BWD_RTOL * dv_abs
            ok = ok and bool((derr <= dbound).all()) and bool(
                torch.isfinite(kdv).all())
            max_abs = max(max_abs, float(derr.max()))
            excess = max(excess, float((derr - dbound).max()))
        ms = median_ms(torch, lambda: fm_kernel.fm_batch_scores_bwd(
            params, local, vals, g, need_dx), flush)
        plain_ms = median_ms(
            torch, lambda: interaction.fm_batch_scores_bwd(
                params, local, vals, g, need_dx), flush)
        new = bwd_launch(torch, params, local, vals, g, need_dx)
        device_ms, timing = kernel_ms(torch, new, flush,
                                      "fm_score_bwd_kernel")
        # Each input read once (the U gathered rows, idx, vals, g),
        # each output written once (dparams, and dvals if asked).
        nbytes = (2 * U * D * 4 + B * L * 8 + B * 4
                  + (B * L * 4 if need_dx else 0))
        nnz = int((vals != 0).sum())
        # The most atomics on one row: its nonzero slots in the batch.
        hottest = int(torch.bincount(local[vals != 0].long(),
                                     minlength=U).max()) if nnz else 0
        # pass 1: 2K per nonzero slot; pass 2: 3K + 1 per nonzero slot
        # plus its K + 1 atomic adds; dvals: 2K + 2 per slot.
        flops = nnz * (6 * K + 2) + (B * L * (2 * K + 2) if need_dx else 0)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / FP32_FLOPS_PER_S * 1e3
        row = {"phase": "kernel", "name": "fm_score_bwd", **tags, "B": B,
               "L": L, "K": K, "U": U,
               "l2": "cold" if flush is not None else "warm", "nnz": nnz,
               "hottest_row_slots": hottest, "need_dx": need_dx,
               "max_abs_err": max_abs, "max_excess_over_bound": excess,
               "within_tol": ok, "rtol_of_abs_sum": BWD_RTOL,
               "atol": BWD_ATOL, "ms": ms, "plain_ms": plain_ms,
               "device_ms": device_ms, "device_timing": timing,
               "bytes": nbytes, "flops": flops,
               "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
               "bound_share": max(bytes_ms, flops_ms) / ms,
               "bound_share_device": max(bytes_ms, flops_ms) / device_ms}
        emit(row)
        rows.append(row)
        check(ok, f"fm_score_bwd disagrees with its plain version on "
                  f"{tags} at B={B} L={L} K={K} need_dx={need_dx}: max abs "
                  f"err {max_abs}, worst excess over the bound {excess}")
    return rows


def bwd_kernel_phase(torch, tables, device):
    """fm_score_bwd against its plain version at the kernel shapes, on
    the rows a train step hands it: the batch's unique rows, gathered,
    and each cell's index into them. Ids are uniform random, so few
    atomics meet on one row; train_phase adds Zipf-skewed batches."""
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    rows = []
    for B, L, K in KERNEL_SHAPES:
        raw, vals = random_batch(torch, gen, B, L, VOCAB, device)
        uniq, inv = torch.unique(raw.reshape(-1), sorted=True,
                                 return_inverse=True)
        params = tables[K].index_select(0, uniq)
        local = inv.reshape(B, L).to(torch.int32)
        g = torch.randn(B, generator=gen, device=device)
        rows += bwd_kernel_rows(torch, params, local, vals, g, flush,
                                batch="uniform")
    del flush
    return rows


def numeric_ids(vocab):
    """The hashed row ids of the NUM_FIELDS numeric features I0, I1,
    ... (one row each, whatever the value)."""
    from fast_tffm_tpu_torch.data.hashing import hash_feature
    return [hash_feature(f"I{j}", vocab) for j in range(NUM_FIELDS)]


def train_batch_kernel_rows(torch, spec, table, args, device):
    """Both kernels against their plain versions on one batch of the
    train phase's stream, deduped and gathered as train_step_body does,
    with g = dloss/dscore of that batch: Criteo's low-cardinality fields
    put thousands of atomics on a few rows there. fm_score runs with L2
    warm, as in the step; fm_score_bwd with L2 flushed and, need_dx off,
    warm (as in the step), then flushed once more on the same batch with
    the numeric fields' slots at x = 0 ("train_no_numeric"), which
    leaves the Zipf-spread categorical rows and takes the hottest rows
    away. Returns (forward rows, backward rows)."""
    from fast_tffm_tpu_torch.models import fm as port_fm
    from fast_tffm_tpu_torch.ops.interaction import gather_rows
    uniq, local = port_fm._device_dedup(spec, args["local_idx"])
    rows = gather_rows(table, uniq).requires_grad_(True)
    loss, scores = port_fm.loss_and_scores(
        spec, rows, args["labels"], args["weights"], uniq, local,
        args["vals"])
    (g,) = torch.autograd.grad(loss, scores)
    rows, g = rows.detach(), g.detach()
    fwd = [fwd_kernel_row(torch, rows, local, args["vals"], None,
                          batch="train")]
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    bwd = bwd_kernel_rows(torch, rows, local, args["vals"], g, flush,
                          batch="train")
    bwd += bwd_kernel_rows(torch, rows, local, args["vals"], g, None,
                           need_dx_cases=(False,), batch="train")
    numeric = torch.isin(args["local_idx"], torch.tensor(
        numeric_ids(spec.vocabulary_size), dtype=args["local_idx"].dtype,
        device=device))
    check(bool(numeric.any()), "the train batch has no numeric slot")
    no_numeric = args["vals"].masked_fill(numeric, 0.0)
    bwd += bwd_kernel_rows(torch, rows, local, no_numeric, g, flush,
                           need_dx_cases=(False,), batch="train_no_numeric")
    del flush
    return fwd, bwd


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


def write_train_cfg(wd):
    path = os.path.join(wd, "train.cfg")
    with open(path, "w") as fh:
        fh.write(f"""[General]
vocabulary_size = {VOCAB}
hash_feature_id = True
factor_num = {FACTORS}
model_file = {os.path.join(wd, 'model', 'fm_model')}
log_file = {os.path.join(wd, 'train.log')}

[Train]
train_files = {os.path.join(wd, 'train.txt')}
validation_files = {os.path.join(wd, 'val.txt')}
epoch_num = {TRAIN_EPOCHS}
batch_size = {TRAIN_BATCH}
learning_rate = {TRAIN_LR}
loss_type = logistic
log_steps = 1

[Predict]
predict_files = {os.path.join(wd, 'val.txt')}
score_path = {os.path.join(wd, 'score')}
""")
    return path


def read_train_log(path):
    """(per-epoch step losses, per-step examples/s, validation AUCs, the
    'training done' line's examples/s) from the train log."""
    import re
    with open(path) as fh:
        text = fh.read()
    losses, rates = {}, []
    for ep, loss, eps in re.findall(
            r"step \d+ epoch (\d+) loss ([0-9.]+) examples/sec ([0-9.]+)",
            text):
        losses.setdefault(int(ep), []).append(float(loss))
        rates.append(float(eps))
    aucs = [float(a) for a in re.findall(
        r"epoch \d+ validation AUC ([0-9.]+) over", text)]
    done = re.findall(r"training done: \d+ steps, final loss [0-9.]+, "
                      r"([0-9.]+) examples/sec", text)
    return losses, rates, aucs, float(done[-1]) if done else None


def step_kernel_ms(torch, step):
    """Device ms per step of each kernel, from a torch.profiler trace of
    ``step(i)`` for i < PROFILED_STEPS. The profiler now and then returns
    a trace without the records of kernels launched through ctypes; such
    a trace is taken again, up to PROFILE_ATTEMPTS times in all, and None
    means not measured."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(PROFILED_STEPS):
                step(i)
            torch.cuda.synchronize()
        kernel_ms, counts = {}, {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
                kernel_ms[e.key] = us / 1e3 / PROFILED_STEPS
                for name in ("fm_score_kernel", "fm_score_bwd_kernel"):
                    if name in e.key:
                        counts[name] = counts.get(name, 0) + e.count
        if counts == {"fm_score_kernel": PROFILED_STEPS,
                      "fm_score_bwd_kernel": PROFILED_STEPS}:
            return kernel_ms
    return None


def resident_step_ms(torch, cfg, device):
    """One train step (dedup -> gather -> forward -> backward -> Adagrad)
    on batches of the train stream already on the card: the median
    CUDA-event time of train_step_body and, from a torch.profiler trace
    of PROFILED_STEPS more steps, the device time per step by kernel
    (step_kernel_ms).
    Event intervals include the gaps in which the card waits for the
    host to launch the next kernel; the profiler's kernel times do not.
    Also both kernels against their plain versions on the first of these
    batches (train_batch_kernel_rows); returns (timings, forward rows,
    backward rows)."""
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    from fast_tffm_tpu_torch.models import fm as port_fm
    spec = port_fm.ModelSpec.from_config(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    table = port_fm.init_table(cfg, device, gen)
    acc = port_fm.init_accumulator(cfg, device)
    batches = []
    for b in batch_iterator(cfg, cfg.train_files, training=True, epochs=1):
        batches.append(port_fm.batch_args(b, device))
        if len(batches) == RESIDENT_BATCHES:
            break
    fwd_rows, bwd_rows = train_batch_kernel_rows(torch, spec, table,
                                                 batches[0], device)

    whole = []
    for i in range(RESIDENT_STEPS + 2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        port_fm.train_step_body(spec, table, acc,
                                **batches[i % len(batches)])
        end.record()
        end.synchronize()
        if i >= 2:  # the first two are warmup
            whole.append(start.elapsed_time(end))

    per_kernel = step_kernel_ms(torch, lambda i: port_fm.train_step_body(
        spec, table, acc, **batches[i % len(batches)]))
    top = (None if per_kernel is None else
           dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]))
    device_ms = None if per_kernel is None else sum(per_kernel.values())
    del table, acc, batches
    torch.cuda.empty_cache()
    return {"resident_step_ms_median": sorted(whole)[len(whole) // 2],
            "profiled_device_ms_per_step": device_ms,
            "profiled_kernels_ms_per_step": top,
            "profiled_kernel_count":
                None if per_kernel is None else len(per_kernel)}, \
        fwd_rows, bwd_rows


def train_phase(torch, device):
    """``python -m fast_tffm_tpu_torch train`` (in process) at config
    #2's width on Criteo-shaped lines with planted labels, then predict
    of the export over the validation lines."""
    import numpy as np
    from fast_tffm_tpu_torch.__main__ import main as cli
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.metrics import exact_auc
    from fast_tffm_tpu_torch.ops import fm_kernel
    wd = os.path.join(WORK, "train")
    os.makedirs(wd)
    t0 = time.perf_counter()
    model = planted_model(SEED + 4)
    train_lines, _ = criteo_lines(TRAIN_LINES, SEED + 5, model)
    val_lines, val_logits = criteo_lines(VAL_LINES, SEED + 6, model)
    for name, lines in (("train.txt", train_lines), ("val.txt", val_lines)):
        with open(os.path.join(wd, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    gen_s = time.perf_counter() - t0
    val_labels = np.array([int(ln.split(" ", 1)[0]) for ln in val_lines])
    # The planted model's own AUC on the validation lines is the best any
    # model can reach; the trained model must recover at least half of
    # its margin over chance.
    bayes_auc = exact_auc(val_logits, val_labels)
    auc_floor = 0.5 + 0.5 * (bayes_auc - 0.5)
    cfg_path = write_train_cfg(wd)
    cfg = load_config(cfg_path)
    del train_lines

    fm_kernel.launches = 0
    fm_kernel.bwd_launches = 0
    t0 = time.perf_counter()
    rc = cli(["train", cfg_path])
    train_s = time.perf_counter() - t0
    fwd_launches, bwd_launches = fm_kernel.launches, fm_kernel.bwd_launches
    check(rc == 0, f"train entry point returned {rc}")
    losses, rates, aucs, done_eps = read_train_log(cfg.log_file)
    steps = TRAIN_EPOCHS * -(-TRAIN_LINES // TRAIN_BATCH)
    val_batches = TRAIN_EPOCHS * -(-VAL_LINES // TRAIN_BATCH)
    check(bwd_launches == steps and fwd_launches == steps + val_batches,
          f"train launched fm_score {fwd_launches} and fm_score_bwd "
          f"{bwd_launches} times for {steps} steps and {val_batches} "
          "validation batches")
    check(sorted(losses) == list(range(TRAIN_EPOCHS)) and len(rates) == steps
          and all(np.isfinite(v).all() for v in losses.values()),
          f"train log losses: {losses}, {len(rates)} rates")
    mean_loss = [float(np.mean(losses[e])) for e in range(TRAIN_EPOCHS)]
    check(mean_loss[-1] < mean_loss[0],
          f"mean loss did not fall: {mean_loss}")
    check(len(aucs) == TRAIN_EPOCHS and aucs[-1] > auc_floor,
          f"validation AUC {aucs} not above {auc_floor} (planted model's "
          f"AUC {bayes_auc})")

    fm_kernel.launches = 0
    rc = cli(["predict", cfg_path])
    predict_launches = fm_kernel.launches
    check(rc == 0, f"predict of the trained model returned {rc}")
    with open(os.path.join(cfg.score_path, "val.txt.score")) as fh:
        scores = np.array([float(x) for x in fh.read().split()])
    check(scores.shape == (VAL_LINES,) and np.isfinite(scores).all(),
          f"{scores.shape} predict scores for {VAL_LINES} lines")
    predict_auc = exact_auc(scores, val_labels)
    check(abs(predict_auc - aucs[-1]) <= AUC_GAP,
          f"predict's exact AUC {predict_auc} vs train's binned AUC "
          f"{aucs[-1]}")

    resident, fwd_rows, bwd_rows = resident_step_ms(torch, cfg, device)
    step_ms = resident["resident_step_ms_median"]
    busy_ms = resident["profiled_device_ms_per_step"]
    # log_steps = 1: each logged rate covers one step's window, so the
    # loop's rate is the examples over the sum of the windows (epoch
    # 0's validation falls inside epoch 1's first window).
    loop_eps = steps * TRAIN_BATCH / sum(TRAIN_BATCH / r for r in rates)
    examples = TRAIN_EPOCHS * TRAIN_LINES
    row = {"phase": "train", "lines": TRAIN_LINES,
           "validation_lines": VAL_LINES, "batch_size": TRAIN_BATCH,
           "epochs": TRAIN_EPOCHS, "steps": steps,
           "learning_rate": TRAIN_LR, "generate_seconds": gen_s,
           "entry_seconds": train_s,
           "examples_per_s_end_to_end": examples / train_s,
           "examples_per_s_train_log": done_eps,
           "examples_per_s_loop": loop_eps,
           "epoch_mean_loss": mean_loss, "validation_auc": aucs,
           "planted_auc": bayes_auc, "auc_floor": auc_floor,
           "predict_exact_auc": predict_auc,
           "fm_score_launches": fwd_launches,
           "fm_score_bwd_launches": bwd_launches,
           "predict_launches": predict_launches,
           **resident,
           # Idle share of the card while the loop runs, from the
           # resident step time and the loop's rate, and over the whole
           # train command (validation and export included); then the
           # same from the profiler's kernel time per step.
           "device_idle_share_loop":
               1.0 - step_ms / 1e3 * loop_eps / TRAIN_BATCH,
           "device_idle_share_end_to_end":
               1.0 - steps * step_ms / 1e3 / train_s,
           "device_idle_share_loop_profiled":
               (None if busy_ms is None
                else 1.0 - busy_ms / 1e3 * loop_eps / TRAIN_BATCH)}
    emit(row)
    return row, fwd_rows, bwd_rows


def main(argv) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="chip_smoke.py", description="On-card smoke run of the port.")
    parser.add_argument("--out", metavar="DIR",
                        help="also write a JSON summary of every phase to "
                             "DIR/chip_smoke.json")
    args = parser.parse_args(argv)
    out_dir = args.out
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    import numpy as np
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.parser import parse_lines
    from fast_tffm_tpu_torch.data.pipeline import make_device_batch
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
    build.build_all(build.SOURCES,
                    log=lambda text: print(text, end="", flush=True))
    build.load_fm_score()
    build.load_fm_score_bwd()
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

        lines, _ = criteo_lines(PREDICT_LINES, SEED + 3)
        with open(os.path.join(WORK, "criteo.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
        first = make_device_batch(parse_lines(
            lines[:PREDICT_BATCH], cfg.vocabulary_size, hash_feature_id=True,
            max_features_per_example=cfg.max_features_per_example,
            keep_empty=True), cfg)
        predict_batch = tuple(torch.from_numpy(a).to(device)
                              for a in (first.local_idx, first.vals))

        # 3. kernel vs plain version
        kernel_rows = kernel_phase(torch, tables, predict_batch, device)
        bwd_rows = bwd_kernel_phase(torch, tables, device)
        table_cpu = table.cpu().numpy()
        del tables, table, predict_batch
        torch.cuda.empty_cache()

        # 4. predict
        predict_row, score_lines = predict_phase(torch, cfg, cfg_path,
                                                 table_cpu, lines, device)

        # 5. serve
        serve_row = serve_phase(torch, cfg, lines, score_lines, device)
        del lines, score_lines, table_cpu

        # 6. train
        train_row, fwd_train_rows, bwd_train_rows = train_phase(torch,
                                                                device)
        kernel_rows += fwd_train_rows
        bwd_rows += bwd_train_rows
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    head = next(r for r in kernel_rows if r["batch"] == "uniform" and
                (r["B"], r["L"], r["K"]) == HEADLINE_SHAPE)
    # The backward's headline row is the train batch, need_dx off: the
    # input the train step gives it (the step never asks for dvals).
    bwd_head = next(r for r in bwd_train_rows if r["batch"] == "train"
                    and not r["need_dx"] and r["l2"] == "cold")
    kernels = {"kernels": [{
        "name": "fm_score", "route": "cuda",
        "source": "fast_tffm_tpu_torch/csrc/fm_score.cu",
        "replaces": "fast_tffm_tpu/ops/pallas_fm.py:63",
        "launches": (predict_row["launches"] + serve_row["launches"]
                     + train_row["fm_score_launches"]
                     + train_row["predict_launches"]),
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "shape_BLK": list(HEADLINE_SHAPE),
        "device_ms": head["device_ms"],
        "device_timing": head["device_timing"],
        "predict_launches": predict_row["launches"],
        "serve_launches": serve_row["launches"],
        "train_launches": train_row["fm_score_launches"],
        "train_predict_launches": train_row["predict_launches"]}, {
        "name": "fm_score_bwd", "route": "cuda",
        "source": "fast_tffm_tpu_torch/csrc/fm_score_bwd.cu",
        "replaces": "fast_tffm_tpu/ops/pallas_fm.py:75",
        "launches": train_row["fm_score_bwd_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "ms": bwd_head["ms"], "plain_ms": bwd_head["plain_ms"],
        "bound_ms": bwd_head["bound_ms"], "bound_by": bwd_head["bound_by"],
        "library_ms": None,
        "shape_BLK": [bwd_head["B"], bwd_head["L"], bwd_head["K"]],
        "device_ms": bwd_head["device_ms"],
        "device_timing": bwd_head["device_timing"], "need_dx": False,
        "batch": "train"}]}
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
            json.dump({"nvidia_smi": smi, "kernel": kernel_rows,
                       "kernel_bwd": bwd_rows, "predict": predict_row,
                       "serve": serve_row, "train": train_row,
                       **kernels}, fh, indent=1)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
