"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a
CUDA kernel has no CPU mode. The file imports no jax, so it also runs on
a machine that has none, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances:

- forward (csrc/fm_score.cu): rtol 1e-5 / atol 1e-6, the bound the CPU
  tests hold the plain version to against the JAX package. The kernel
  sums in the plain version's order with explicitly rounded operations,
  so the two are expected to agree to the bit, and the edges of its
  register-batched row loads (the 32-slot chunk, the column chunks a
  lane holds) are held to exact equality.
- backward (csrc/fm_score_bwd.cu): each row's contributions are summed
  exactly in fixed point, in another order than the plain version's
  float32 sum, so each element of ``dparams`` is held to rtol 1e-5 of
  its sum of absolute contributions (which the plain version computes
  alongside), plus atol 1e-6, and two launches on one input must agree
  to the bit; ``dvals``, summed in another order than the plain
  version's, likewise against ``|g|·(|w| + Σ_f |v_f·(s_f − z_f)|)``.
- one train step on the card against the same step on the CPU: rtol
  1e-4 / atol 1e-6, the bound the CPU tests hold the step to against the
  JAX package.
- the input path's card legs (the chunked fetcher's pinned copies; a
  host-deduped train step against the CPU at rtol 1e-4 / atol 1e-6;
  the predict sweep's score files, equal byte for byte to the CPU's).
- checkpoints: a card table saved (asynchronously, then updated in place
  at once) and restored is equal to the bit; under concurrent flushes on
  the card a hot reload tags each response with a step, and its scores
  equal, to the bit, that step's table scored alone.
- FFM and order-3 FM (torch ops on the card): scores at rtol 1e-5 /
  atol 1e-6 and three train steps at rtol 1e-4 / atol 1e-6 against the
  CPU, for both dedup modes.
- the packed wire: packed-wide scores on the card equal to the padded
  wire's to the bit (order 2 through the kernel, FFM, order 3); a
  packed-wide train step against the padded step on the card at the
  step's rtol 1e-4 / atol 1e-6 (the backward's atomics); the
  double-buffered copy delivers every batch intact though the host
  overwrites its arrays as soon as ``device_put`` returns.
- ``run_mode = stream``: a train over a pre-sealed directory on the card
  against the CPU at the step's rtol 1e-4 / atol 1e-6, both kernels
  launched once a step, and the same watermark.
- ``lookup = host`` (csrc/offload_rows.cu on registered host memory):
  the gather equal to its plain version to the bit (NaN rows for an id
  outside the state); the Adagrad write-back (``rsqrtf`` on the card,
  ``torch.rsqrt`` = 1/sqrt in the CPU plain version) at rtol 1e-6 /
  atol 1e-7, at D 1, 9, 17 and U 1, 31, 16,384; an offload train of
  sample.cfg on the card against the CPU at the step's rtol 1e-4 /
  atol 1e-6, all four kernels launched every step; the card's peak
  allocated bytes at the batch blocks while a 151 MB table trains.
- ``vocab_mode = admit``: ``reset_table_rows`` on card tensors equal to
  the CPU result to the bit (the rows, more than one 4,096-row chunk,
  and nothing else), and a checkpoint snapshot taken right after it holds
  the reset rows; ``PinnedHostLookup.reset_rows`` straight after a step
  (its write-back still queued) on a set holding the batch's hottest
  row, against the same step and reset on the CPU (rtol 1e-6 / atol
  1e-7; the reset rows exact), and the next step likewise; a remapped
  raw-ids batch (most cells on the cold row 0) through both kernels
  against their plain versions (forward to the bit, backward at the
  atomics' bound); every slot of a batch on one row (an admit batch
  before its first barrier), the backward against the plain version
  with float64 row sums at float32 summation's probabilistic bound for
  that slot count (the float32 plain version's one sequential sum a
  column misses rtol 1e-5 there too); an admit train on the card against the
  CPU at the step's tolerance, both kernels launched every step, the
  same slot map.
- the serving fleet: a 2-replica ``FleetSupervisor`` on the card (two
  replica processes, each with its CUDA context and table) whose
  proxied bodies equal an in-process ScorerServer's byte for byte (the
  forward kernel's scores, to the bit, formatted), and whose replicas'
  ``/healthz`` name ``cuda:0``, the CUDA kernel and its launches.
- ``dist_train``: two ranks on cuda:0 (processes over gloo,
  tests/torch_dist_ranks.py) take 4 sharded steps of an FM, an FFM and
  an order-3 FM (rank 1 steps the filler in the last), held against the
  single-process host-dedup step on the card on their concatenated batch
  (``local_idx`` offset per rank): the loss, the gathered table and
  accumulator at the step's rtol 1e-4 / atol 1e-6, the sharded scores at
  rtol 1e-5 / atol 1e-6.
- ``elastic = shrink``: two ranks of ``train <cfg> dist_train worker
  <i>`` on cuda:0, rank 1 SIGKILLed as it begins the step after the
  first periodic save's; the survivor reforms alone, finishes at the
  exactly-once step, and its table equals a single-process resume of the
  same step on the CPU at the step's rtol 1e-4 / atol 1e-6.
- the run telemetry: ``device_memory_stats`` reads the allocator's
  current and peak bytes and the card's total memory; ``oom_guard`` turns
  a real out-of-memory allocation into ``HbmExhaustedError`` naming the
  ledger's owners, and the allocator serves the next allocation; the same
  train steps make equal numbers of synchronizations with the telemetry
  on and off (sync debug mode), the barrier one more; a profiler window
  of a train run on the card holds one ``fm_score`` and one
  ``fm_score_bwd`` kernel event per step of the window.
"""

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models import fm as port_fm
from fast_tffm_tpu_torch.ops import fm_kernel, interaction

BWD_RTOL, BWD_ATOL = 1e-5, 1e-6

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, B, L, U, K):
    rng = np.random.default_rng(seed)
    params = (rng.normal(size=(U, K + 1)) * 0.1).astype(np.float32)
    params[-1] = 0.0
    idx = rng.integers(0, U - 1, size=(B, L)).astype(np.int32)
    vals = rng.random(size=(B, L)).astype(np.float32)
    tail = np.arange(L)[None, :] >= rng.integers(0, L + 1, size=B)[:, None]
    idx[tail] = U - 1
    vals[tail] = 0.0
    return [torch.from_numpy(a) for a in (params, idx, vals)]


@pytest.mark.parametrize("B,L,U,K", [(64, 16, 128, 8), (32, 64, 512, 4),
                                     (8, 8, 16, 16), (8192, 64, 1 << 20, 16),
                                     (300, 100, 4096, 40), (7, 1, 9, 1)])
def test_kernel_matches_plain_version(card, B, L, U, K):
    cpu = _case(B + L + K, B, L, U, K)
    plain = interaction.fm_batch_scores(*cpu)
    before = fm_kernel.launches
    got = fm_kernel.fm_batch_scores(*(t.to(card) for t in cpu))
    torch.cuda.synchronize()
    assert fm_kernel.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_kernel_bits_independent_of_padding_and_batch(card):
    params, idx, vals = (t.to(card) for t in _case(5, 64, 16, 512, 16))
    ref = fm_kernel.fm_batch_scores(params, idx, vals).cpu()
    wide_idx = torch.full((64, 128), params.shape[0] - 1, dtype=torch.int32,
                          device=card)
    wide_vals = torch.zeros((64, 128), dtype=torch.float32, device=card)
    wide_idx[:, :16], wide_vals[:, :16] = idx, vals
    wide = fm_kernel.fm_batch_scores(params, wide_idx, wide_vals).cpu()
    assert torch.equal(wide, ref)
    one = fm_kernel.fm_batch_scores(params, idx[9:10].contiguous(),
                                    vals[9:10].contiguous()).cpu()
    assert torch.equal(one, ref[9:10])


def test_out_of_range_row_scores_nan(card):
    params, idx, vals = (t.to(card) for t in _case(6, 4, 8, 32, 8))
    idx[2, 3] = params.shape[0]
    got = fm_kernel.fm_batch_scores(params, idx, vals).cpu()
    assert torch.isnan(got[2]) and torch.isfinite(got[[0, 1, 3]]).all()


def test_kernel_multiplies_pad_rows_like_the_plain_version(card):
    """A row holding inf or NaN at a slot with x == 0: the plain version
    multiplies it (inf * 0 = NaN), and so does the kernel."""
    params, idx, vals = _case(15, 8, 16, 64, 16)
    params[5, 2] = float("inf")
    params[6, 16] = float("nan")
    idx[1, 3], vals[1, 3] = 5, 0.0
    idx[4, 0], vals[4, 0] = 6, 0.0
    plain = interaction.fm_batch_scores(params, idx, vals)
    got = fm_kernel.fm_batch_scores(
        *(t.to(card) for t in (params, idx, vals))).cpu()
    assert torch.isnan(plain[1]) and torch.isnan(plain[4])
    torch.testing.assert_close(got, plain, rtol=0, atol=0, equal_nan=True)


def test_wrapper_checks_dtype_and_contiguity(card):
    params, idx, vals = (t.to(card) for t in _case(7, 4, 8, 32, 8))
    with pytest.raises(TypeError):
        fm_kernel.fm_batch_scores(params, idx.long(), vals)
    with pytest.raises(ValueError, match="contiguous"):
        fm_kernel.fm_batch_scores(params, idx.t().contiguous().t(),
                                  vals.t().contiguous().t())


def _assert_within(got, want, magnitude, what):
    err = (got.cpu() - want).abs()
    bound = BWD_ATOL + BWD_RTOL * magnitude
    assert torch.isfinite(got).all(), what
    assert (err <= bound).all(), (
        f"{what}: max err {float(err.max())}, worst excess "
        f"{float((err - bound).max())}")


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("B,L,U,K", [(64, 16, 128, 8), (32, 64, 512, 4),
                                     (8, 8, 16, 16), (8192, 64, 1 << 18, 16),
                                     (300, 100, 4096, 40), (7, 1, 9, 1)])
def test_bwd_kernel_matches_plain_version(card, B, L, U, K, need_dx):
    cpu = _case(B + L + K, B, L, U, K)
    g = torch.from_numpy(np.random.default_rng(B).normal(size=B)
                         .astype(np.float32))
    dp, dv, dp_abs, dv_abs = interaction.fm_batch_scores_bwd(
        *cpu, g, need_dx=True, magnitudes=True)
    before = fm_kernel.bwd_launches
    got_dp, got_dv = fm_kernel.fm_batch_scores_bwd(
        *(t.to(card) for t in cpu), g.to(card), need_dx=need_dx)
    torch.cuda.synchronize()
    assert fm_kernel.bwd_launches == before + 1
    _assert_within(got_dp, dp, dp_abs, "dparams")
    if need_dx:
        _assert_within(got_dv, dv, dv_abs, "dvals")
    else:
        assert got_dv is None
    assert not got_dp[-1].any().item()  # only pad cells point at it


# The batched row loads' edges: L around the 32-slot chunk, D = K+1 at
# each change of the column chunks a lane holds (and of the rows it keeps
# in flight, csrc/rows.cuh), up to D = 128, B that no block size divides
# and B below one block.
EDGES = [(64, 1, 256, 16), (64, 31, 256, 16), (64, 33, 256, 16),
         (40, 257, 4096, 16), (64, 40, 512, 1), (64, 40, 512, 31),
         (64, 40, 512, 32), (64, 40, 512, 63), (64, 40, 512, 64),
         (64, 40, 512, 127), (3, 64, 512, 16), (4099, 64, 1 << 16, 16),
         (4099, 300, 1 << 16, 16), (33, 129, 1024, 127), (64, 7, 512, 127),
         (64, 62, 512, 32), (64, 256, 4096, 7), (100, 64, 8192, 1)]


@pytest.mark.parametrize("B,L,U,K", EDGES)
def test_kernel_edges_bit_equal(card, B, L, U, K):
    cpu = _case(B * 7 + L + K, B, L, U, K)
    plain = interaction.fm_batch_scores(*cpu)
    got = fm_kernel.fm_batch_scores(*(t.to(card) for t in cpu)).cpu()
    assert torch.equal(got, plain)


@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("B,L,U,K", EDGES)
def test_bwd_kernel_edges(card, B, L, U, K, need_dx):
    cpu = _case(B * 5 + L + K, B, L, U, K)
    g = torch.from_numpy(np.random.default_rng(L).normal(size=B)
                         .astype(np.float32))
    dp, dv, dp_abs, dv_abs = interaction.fm_batch_scores_bwd(
        *cpu, g, need_dx=True, magnitudes=True)
    got_dp, got_dv = fm_kernel.fm_batch_scores_bwd(
        *(t.to(card) for t in cpu), g.to(card), need_dx=need_dx)
    torch.cuda.synchronize()
    _assert_within(got_dp, dp, dp_abs, "dparams")
    if need_dx:
        _assert_within(got_dv, dv, dv_abs, "dvals")


@pytest.mark.parametrize("B,L,pool", [(256, 128, 2048), (64, 256, 4096)])
def test_bwd_kernel_many_repeated_rows(card, B, L, pool):
    """Every slot real and each row repeated across examples many times
    over, in thousands of distinct rows: many atomics meet on each."""
    K = 16
    rng = np.random.default_rng(B + L)
    params = torch.from_numpy(
        (rng.normal(size=(pool, K + 1)) * 0.1).astype(np.float32))
    # Each example's rows distinct, drawn from the pool.
    idx = torch.from_numpy(
        rng.random((B, pool)).argsort(axis=1)[:, :L].astype(np.int32))
    vals = torch.from_numpy(rng.uniform(0.5, 1.5, (B, L)).astype(np.float32))
    counts = torch.bincount(idx.reshape(-1).long())
    assert int((counts > 1).sum()) > pool // 2
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32))
    dp, _, dp_abs, _ = interaction.fm_batch_scores_bwd(
        params, idx, vals, g, need_dx=True, magnitudes=True)
    got_dp, _ = fm_kernel.fm_batch_scores_bwd(
        params.to(card), idx.to(card), vals.to(card), g.to(card),
        need_dx=False)
    torch.cuda.synchronize()
    _assert_within(got_dp, dp, dp_abs, "dparams")


def test_bwd_kernel_hot_row(card):
    """One row in every example (a categorical value every line
    shares): B atomics per column on one row."""
    B, L, U, K = 4096, 32, 2048, 16
    params, idx, vals = _case(11, B, L, U, K)
    idx[:, 0] = 3
    vals[:, 0] = 1.0
    g = torch.from_numpy(np.random.default_rng(11).normal(size=B)
                         .astype(np.float32))
    dp, dv, dp_abs, dv_abs = interaction.fm_batch_scores_bwd(
        params, idx, vals, g, need_dx=True, magnitudes=True)
    got_dp, got_dv = fm_kernel.fm_batch_scores_bwd(
        params.to(card), idx.to(card), vals.to(card), g.to(card),
        need_dx=True)
    torch.cuda.synchronize()
    _assert_within(got_dp, dp, dp_abs, "dparams")
    _assert_within(got_dv, dv, dv_abs, "dvals")
    assert float(dp_abs[3].max()) > 100 * float(dp_abs[4].max())


def test_fm_scores_autograd_runs_both_kernels(card):
    params, idx, vals = (t.to(card) for t in _case(12, 128, 32, 1024, 16))
    p = params.clone().requires_grad_(True)
    v = vals.clone().requires_grad_(True)
    f0, b0 = fm_kernel.launches, fm_kernel.bwd_launches
    scores = fm_kernel.fm_batch_scores(p, idx, v)
    scores.square().sum().backward()
    torch.cuda.synchronize()
    assert (fm_kernel.launches, fm_kernel.bwd_launches) == (f0 + 1, b0 + 1)
    g = 2 * scores.detach()
    dp, dv, dp_abs, dv_abs = interaction.fm_batch_scores_bwd(
        params.cpu(), idx.cpu(), vals.cpu(), g.cpu(), need_dx=True,
        magnitudes=True)
    _assert_within(p.grad, dp, dp_abs, "dparams")
    _assert_within(v.grad, dv, dv_abs, "dvals")


def test_bwd_out_of_range_row_makes_dvals_nan(card):
    params, idx, vals = (t.to(card) for t in _case(13, 4, 8, 32, 8))
    idx[1, 2] = params.shape[0]
    g = torch.ones(4, device=card)
    dp, dv = fm_kernel.fm_batch_scores_bwd(params, idx, vals, g,
                                           need_dx=True)
    torch.cuda.synchronize()
    assert torch.isnan(dv[1, 2]) and torch.isfinite(dp).all()
    assert torch.isfinite(dv[0]).all()


def test_train_step_on_card_matches_cpu(card):
    cfg = FmConfig(vocabulary_size=5000, factor_num=16, batch_size=512,
                   learning_rate=0.1, factor_lambda=1e-4, bias_lambda=1e-4)
    spec = port_fm.ModelSpec.from_config(cfg)
    rng = np.random.default_rng(14)
    table = rng.uniform(-0.1, 0.1, (cfg.num_rows, cfg.row_dim)
                        ).astype(np.float32)
    table[-1] = 0.0
    acc = np.full_like(table, cfg.adagrad_init)
    B, L = cfg.batch_size, 32
    idx = rng.zipf(1.3, size=(B, L)).astype(np.int64) % cfg.vocabulary_size
    vals = rng.random((B, L)).astype(np.float32)
    tail = np.arange(L)[None, :] >= rng.integers(1, L + 1, size=B)[:, None]
    idx[tail] = cfg.pad_id
    vals[tail] = 0.0
    batch = dict(labels=(rng.random(B) < 0.3).astype(np.float32),
                 weights=np.ones(B, np.float32),
                 local_idx=idx.astype(np.int32), vals=vals)
    out = {}
    for dev in ("cpu", card):
        # Copies: the step updates the table and accumulator in place.
        t = torch.from_numpy(table.copy()).to(dev)
        a = torch.from_numpy(acc.copy()).to(dev)
        args = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        f0, b0 = fm_kernel.launches, fm_kernel.bwd_launches
        for _ in range(3):
            t, a, loss, scores = port_fm.train_step_body(spec, t, a, **args)
        out[str(dev)] = [x.cpu().numpy() for x in (t, a, loss, scores)]
        if dev == card:
            assert fm_kernel.launches == f0 + 3
            assert fm_kernel.bwd_launches == b0 + 3
    for got, want in zip(out[str(card)], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_checkpoint_round_trip_of_a_card_table_is_exact(card, tmp_path):
    from fast_tffm_tpu_torch.checkpoint import CheckpointState
    from fast_tffm_tpu_torch.predict import load_table
    from fast_tffm_tpu_torch.train import checkpoint_template
    cfg = FmConfig(vocabulary_size=300_000, factor_num=16,
                   model_file=str(tmp_path / "fm"))
    gen = torch.Generator(device=card).manual_seed(5)
    table = torch.randn((cfg.num_rows, cfg.row_dim), generator=gen,
                        device=card)
    acc = torch.rand((cfg.num_rows, cfg.row_dim), generator=gen,
                     device=card) + 0.1
    want_t, want_a = table.cpu().clone(), acc.cpu().clone()
    ckpt = CheckpointState(cfg.model_file)
    ckpt.save(1, table, acc, vocabulary_size=cfg.vocabulary_size)
    table.mul_(2.0)  # the next train step's in-place update
    acc.zero_()
    ckpt.save(2, table, acc, vocabulary_size=cfg.vocabulary_size, wait=True)
    r1 = ckpt.restore(step=1, template=checkpoint_template(cfg))
    r2 = ckpt.restore(template=checkpoint_template(cfg))
    ckpt.close()
    assert torch.equal(r1["table"], want_t) and torch.equal(r1["acc"], want_a)
    assert r2["step"] == 2 and torch.equal(r2["table"], want_t * 2.0)
    assert not r2["acc"].any()
    on_card = load_table(cfg, card, step=1)
    assert on_card.is_cuda and torch.equal(on_card.cpu(), want_t)


def test_hot_reload_under_concurrent_flushes_on_the_card(card, tmp_path):
    import threading
    import time
    from fast_tffm_tpu_torch.checkpoint import write_published
    from fast_tffm_tpu_torch.data.parser import parse_lines
    from fast_tffm_tpu_torch.data.pipeline import make_device_batch
    from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
    from fast_tffm_tpu_torch.predict import load_table
    from fast_tffm_tpu_torch.scoring import CompiledScorer
    from fast_tffm_tpu_torch.serve.server import ScorerServer
    cfg = FmConfig(vocabulary_size=50_000, factor_num=16,
                   model_file=str(tmp_path / "fm"), serve_max_batch=64,
                   serve_max_wait_ms=1.0, serve_poll_seconds=0.02)
    rng = np.random.default_rng(21)
    for step in (10, 20):
        table = (rng.normal(size=(cfg.num_rows, cfg.row_dim)) * 0.1
                 ).astype(np.float32)
        save_checkpoint_from_numpy(cfg, table, None, step)
    lines = []
    for _ in range(400):
        n = int(rng.integers(0, 40))
        ids = rng.integers(0, cfg.vocabulary_size, n)
        lines.append("1 " + " ".join(f"{i}:{rng.random():.3f}"
                                     for i in ids))
    scorer = CompiledScorer(cfg, card)
    tables = {s: load_table(cfg, card, step=s) for s in (10, 20)}

    def alone(step, chunk):
        batch = make_device_batch(parse_lines(
            chunk, cfg.vocabulary_size, keep_empty=True), cfg)
        raw = scorer.score_batch(tables[step], batch)[:len(chunk)]
        return scorer.transform(raw.cpu().numpy())

    write_published(cfg.model_file + ".ckpt", 10)
    server = ScorerServer(cfg, device=card)
    results, errors = [], []

    def client(k):
        r = np.random.default_rng(k)
        try:
            for _ in range(60):
                n = int(r.integers(1, 33))
                lo = int(r.integers(0, len(lines) - n + 1))
                res = server.score_lines(lines[lo:lo + n], timeout=60)
                results.append((lo, n, res))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        time.sleep(0.2)
        write_published(cfg.model_file + ".ckpt", 20)
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        stats = server.stats()
    finally:
        server.close()
    assert not errors, errors[:3]
    assert stats["reloads"] == 1 and stats["reload_failures"] == 0
    assert {res.step for _, _, res in results} == {10, 20}
    for lo, n, res in results:
        want = alone(res.step, lines[lo:lo + n])
        assert np.array_equal(res.scores, want), (lo, n, res.step)


def test_chunked_fetcher_copies_card_scores_in_order(card):
    from fast_tffm_tpu_torch.utils.fetch import ChunkedFetcher
    want = [torch.randn(8192, device=card) * i for i in range(37)]
    seen = []
    fetcher = ChunkedFetcher(lambda a, m: seen.append((a.copy(), m)),
                             chunk=8)
    try:
        for i, t in enumerate(want):
            fetcher.add(t, i)
        fetcher.flush()
    finally:
        fetcher.close()
    assert [m for _, m in seen] == list(range(37))
    for (got, _), t in zip(seen, want):
        assert np.array_equal(got, t.cpu().numpy())


def test_host_dedup_train_step_on_card_matches_cpu(card):
    from fast_tffm_tpu_torch.data.parser import ParsedBlock
    from fast_tffm_tpu_torch.data.pipeline import make_device_batch
    cfg = FmConfig(vocabulary_size=5000, factor_num=16, batch_size=512,
                   learning_rate=0.1, dedup="host",
                   bucket_ladder=(8, 16, 32))
    spec = port_fm.ModelSpec.from_config(cfg)
    rng = np.random.default_rng(15)
    table = rng.uniform(-0.1, 0.1, (cfg.num_rows, cfg.row_dim)
                        ).astype(np.float32)
    table[-1] = 0.0
    acc = np.full_like(table, cfg.adagrad_init)
    sizes = rng.integers(1, 30, size=500)
    ids = (rng.zipf(1.3, size=int(sizes.sum())) % 5000).astype(np.int32)
    block = ParsedBlock(
        labels=(rng.random(500) < 0.3).astype(np.float32),
        poses=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
        ids=ids, vals=rng.random(len(ids)).astype(np.float32))
    batch = make_device_batch(block, cfg, raw_ids=False)
    out = {}
    for dev in ("cpu", card):
        t = torch.from_numpy(table.copy()).to(dev)
        a = torch.from_numpy(acc.copy()).to(dev)
        args = port_fm.batch_args(batch, torch.device(dev))
        assert "uniq_ids" in args
        for _ in range(3):
            t, a, loss, scores = port_fm.train_step_body(spec, t, a, **args)
        out[str(dev)] = [x.cpu().numpy() for x in (t, a, loss, scores)]
    for got, want in zip(out[str(card)], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_predict_sweep_on_card_equals_cpu(card, tmp_path):
    import pathlib
    from fast_tffm_tpu_torch.predict import predict
    rng = np.random.default_rng(16)
    files = []
    for i, n in enumerate((300, 0, 257)):
        path = tmp_path / f"p{i}.txt"
        path.write_text("".join(
            " ".join([str(int(rng.random() < 0.3))] + [
                f"C{f}=v{int(rng.zipf(1.3)) % 99}" for f in range(26)])
            + "\n" if j % 7 else "\n" for j in range(n)))
        files.append(str(path))
    table = torch.from_numpy(rng.normal(0, 0.1, (4097, 17)).astype(
        np.float32))
    table[-1] = 0.0
    out = {}
    for dev in ("cpu", card):
        cfg = FmConfig(vocabulary_size=4096, factor_num=16,
                       hash_feature_id=True, batch_size=128,
                       predict_files=tuple(files),
                       score_path=str(tmp_path / str(dev)))
        before = fm_kernel.launches
        written = predict(cfg, table=table.to(dev), device=dev)
        if dev == card:
            assert fm_kernel.launches == before + 5
        out[str(dev)] = [pathlib.Path(p).read_text() for p in written]
    assert out[str(card)] == out["cpu"]
    assert out["cpu"][1] == "" and len(out["cpu"][2].splitlines()) == 257


def _model_batch(model, dedup, seed=17, B=256):
    """A config and a batch for ``model`` ("fm", "ffm" or "order3")."""
    from fast_tffm_tpu_torch.data.parser import ParsedBlock
    from fast_tffm_tpu_torch.data.pipeline import make_device_batch
    kw = {"fm": dict(factor_num=16), "ffm": dict(model_type="ffm",
                                                 field_num=8, factor_num=4),
          "order3": dict(order=3, factor_num=8)}[model]
    cfg = FmConfig(vocabulary_size=3000, batch_size=B, learning_rate=0.1,
                   dedup=dedup, bucket_ladder=(8, 16, 32), **kw)
    rng = np.random.default_rng(seed)
    n = B - 7
    sizes = rng.integers(1, 30, size=n)
    nnz = int(sizes.sum())
    block = ParsedBlock(
        labels=(rng.random(n) < 0.3).astype(np.float32),
        poses=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
        ids=(rng.zipf(1.3, size=nnz) % 3000).astype(np.int32),
        vals=rng.random(nnz).astype(np.float32),
        fields=(rng.integers(0, 8, nnz).astype(np.int32)
                if model == "ffm" else None))
    batch = make_device_batch(block, cfg, raw_ids=dedup == "device")
    table = rng.uniform(-0.1, 0.1, (cfg.num_rows, cfg.row_dim)
                        ).astype(np.float32)
    table[-1] = 0.0
    return cfg, batch, table


@pytest.mark.parametrize("dedup", ["device", "host"])
@pytest.mark.parametrize("model", ["ffm", "order3"])
def test_ffm_and_order3_on_card_match_cpu(card, model, dedup):
    cfg, batch, table = _model_batch(model, dedup)
    spec = port_fm.ModelSpec.from_config(cfg)
    out = {}
    for dev in ("cpu", card):
        t = torch.from_numpy(table.copy()).to(dev)
        a = torch.full_like(t, cfg.adagrad_init)
        args = port_fm.batch_args(batch, torch.device(dev))
        sargs = {k: v for k, v in args.items()
                 if k not in ("labels", "weights")}
        before = fm_kernel.launches
        scores0 = port_fm.score_body(spec, t, **sargs)
        for _ in range(3):
            t, a, loss, scores = port_fm.train_step_body(spec, t, a, **args)
        assert fm_kernel.launches == before   # no order-2 kernel
        out[str(dev)] = [x.cpu().numpy()
                         for x in (scores0, t, a, loss, scores)]
    got, want = out[str(card)], out["cpu"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("model", ["fm", "ffm", "order3"])
def test_packed_wide_scores_on_card_equal_padded(card, model):
    import dataclasses
    from fast_tffm_tpu_torch.scoring import CompiledScorer
    cfg, batch, table = _model_batch(model, "device", seed=18)
    t = torch.from_numpy(table).to(card)
    got = {}
    for fmt in ("padded", "packed"):
        scorer = CompiledScorer(dataclasses.replace(cfg, wire_format=fmt),
                                card)
        assert scorer.wire.packed == (fmt == "packed")
        before = fm_kernel.launches
        got[fmt] = scorer.score_batch(t, batch).cpu()
        assert fm_kernel.launches == before + (model == "fm")
    assert torch.equal(got["padded"], got["packed"])


@pytest.mark.parametrize("dedup", ["device", "host"])
def test_packed_wide_train_step_on_card(card, dedup):
    from fast_tffm_tpu_torch.wire import WireEncoder, WireSpec
    cfg, batch, table = _model_batch("fm", dedup, seed=19)
    spec = port_fm.ModelSpec.from_config(cfg)
    enc = WireEncoder(WireSpec("packed", "wide"), cfg.pad_id)
    out = []
    for packed in (False, True):
        t = torch.from_numpy(table.copy()).to(card)
        a = torch.full_like(t, cfg.adagrad_init)
        before = fm_kernel.bwd_launches
        for _ in range(3):
            if packed:
                wb = enc.encode_train(batch)
                t, a, loss, scores = port_fm.packed_train_step_body(
                    spec, wb.L, t, a, **enc.device_put(wb, card))
            else:
                t, a, loss, scores = port_fm.train_step_body(
                    spec, t, a, **port_fm.batch_args(batch, card))
        assert fm_kernel.bwd_launches == before + 3
        out.append([x.cpu().numpy() for x in (t, a, loss, scores)])
    for g, w in zip(out[1], out[0]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_double_buffered_copy_survives_host_reuse(card):
    from fast_tffm_tpu_torch.wire import WireEncoder, WireSpec
    cfg, batch, _ = _model_batch("ffm", "host", seed=20)
    for spec in (WireSpec(), WireSpec("packed", "wide")):
        enc = WireEncoder(spec, cfg.pad_id)
        wb = enc.encode_train(batch)
        want = {k: v.clone() for k, v in wb.args.items()}
        placed = []
        for _ in range(40):
            placed.append(enc.device_put(wb, card))
            for v in wb.args.values():   # the host writes its buffers
                v.fill_(7)
            for k, v in wb.args.items():
                v.copy_(want[k])
        torch.cuda.synchronize()
        for got in placed:
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                assert v.is_cuda and torch.equal(v.cpu(), want[k]), k


def test_stream_train_on_card_matches_cpu(card, tmp_path):
    """A stream train over a small pre-sealed directory on the card and
    on the CPU, from one table: both kernels launch on every step, and
    the tables, accumulators and watermarks agree at the step's
    tolerance (rtol 1e-4 / atol 1e-6)."""
    import dataclasses
    import os
    from fast_tffm_tpu_torch import checkpoint as ck
    from fast_tffm_tpu_torch.models import convert
    from fast_tffm_tpu_torch.train import checkpoint_template, train
    rng = np.random.default_rng(12)
    sd = tmp_path / "stream"
    sd.mkdir()
    for k in range(2):
        lines = [f"{int(rng.integers(0, 2))} " + " ".join(
            f"{int(j)}:{v:.3f}" for j, v in zip(
                rng.integers(0, 1000, 9), rng.uniform(0.1, 2.0, 9)))
            for _ in range(300)]
        (sd / f"part-{k}").write_text("\n".join(lines) + "\n")
        (sd / f"part-{k}.done").write_text("")
    (sd / "STOP").write_text("")
    cfg0 = FmConfig(vocabulary_size=1000, factor_num=8, batch_size=64,
                    run_mode="stream", stream_dir=str(sd), save_steps=4,
                    stream_poll_seconds=0.05, learning_rate=0.1)
    table0 = (rng.normal(size=(cfg0.num_rows, cfg0.row_dim)) * 0.01
              ).astype(np.float32)
    table0[-1] = 0.0
    states = {}
    fm_kernel.launches = fm_kernel.bwd_launches = 0
    for name, dev in (("cpu", torch.device("cpu")), ("card", card)):
        cfg = dataclasses.replace(
            cfg0, model_file=str(tmp_path / name / "fm"))
        train(cfg, device=dev, init_state=convert.state_from_numpy(
            table0.copy(), np.full_like(table0, cfg.adagrad_init), cfg,
            dev))
        d = cfg.model_file + ".ckpt"
        step = ck.list_step_dirs(d)[-1]
        r = ck.CheckpointState(cfg.model_file).restore(
            template=checkpoint_template(cfg))
        states[name] = (step, r["table"].numpy(), r["acc"].numpy(),
                        ck.read_watermark(d, step))
        if name == "cpu":
            assert fm_kernel.launches == fm_kernel.bwd_launches == 0
    steps = -(-600 // 64)
    assert fm_kernel.launches == fm_kernel.bwd_launches == steps
    (s_c, t_c, a_c, w_c), (s_g, t_g, a_g, w_g) = states["cpu"], \
        states["card"]
    assert s_c == s_g == steps
    assert w_c == w_g and sum(f["lines"] for f in w_g["files"]) == 600
    np.testing.assert_allclose(t_g, t_c, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a_g, a_c, rtol=1e-4, atol=1e-6)
    assert os.path.exists(ck.watermark_path(
        str(tmp_path / "card" / "fm.ckpt"), steps))


def _offload_case(seed, R=5000, D=9, U=700, pads=37):
    """A [R, D] host state, U unique ids with a tail of pad slots that
    repeat the zero pad row R - 1, and a gradient whose pad rows are 0."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.1, 0.1, (R, D)).astype(np.float32)
    table[R - 1] = 0.0
    acc = rng.uniform(0.1, 0.5, (R, D)).astype(np.float32)
    ids = np.concatenate([rng.choice(R - 1, U - pads, replace=False),
                          np.full(pads, R - 1)]).astype(np.int32)
    grad = rng.normal(0, 0.1, (U, D)).astype(np.float32)
    grad[U - pads:] = 0.0
    return [torch.from_numpy(a) for a in (table, acc, ids, grad)]


@pytest.mark.parametrize("U,D", [(700, 9), (1, 1), (31, 1), (16384, 1),
                                 (1, 9), (31, 9), (16384, 9), (1, 17),
                                 (31, 17), (16384, 17)])
def test_offload_kernels_match_plain_versions_on_registered_memory(card, U,
                                                                   D):
    """offload_gather copies: equal to the plain version to the bit, an
    id outside [0, R) NaN in its row. offload_adagrad (rsqrtf on the
    card, 1/sqrt in the CPU plain version): rtol 1e-6 / atol 1e-7, the
    id outside skipped, the pad row still 0. Each launch counted once."""
    from fast_tffm_tpu_torch.ops import offload_kernel as ok
    R = max(2 * U, 5000)
    table, acc, ids, grad = _offload_case(U + D, R=R, D=D, U=U,
                                          pads=min(37, U // 8))
    ok.register_host(table, card)
    ok.register_host(acc, card)
    assert ok.is_page_locked(table) and ok.is_page_locked(acc)
    assert ok.registered_bytes() >= 2 * table.numel() * 4
    g0, a0 = ok.gather_launches, ok.adagrad_launches
    bad = torch.cat([ids, torch.tensor([R], dtype=torch.int32)]).to(card)
    rows = ok.offload_gather(table, bad)
    torch.cuda.synchronize()
    assert rows.is_cuda and ok.gather_launches == g0 + 1
    want_rows = ok.offload_gather_plain(table, ids)
    assert torch.equal(rows[:-1].cpu(), want_rows)
    assert rows[-1].isnan().all()
    want_t, want_a = table.clone(), acc.clone()
    ok.offload_adagrad_plain(want_t, want_a, ids, want_rows, grad, 0.1)
    grad_b = torch.cat([grad, torch.full((1, D), 0.5)]).to(card)
    ok.offload_adagrad(table, acc, bad, rows, grad_b, 0.1)
    torch.cuda.synchronize()
    assert ok.adagrad_launches == a0 + 1
    np.testing.assert_allclose(acc.numpy(), want_a.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(table.numpy(), want_t.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert not table[-1].any()
    ok.unregister_host(table)
    ok.unregister_host(acc)
    assert not ok.is_page_locked(table)
    with pytest.raises(ValueError, match="page-locked"):
        ok.offload_gather(table, ids.to(card))


def test_offload_train_on_card_matches_cpu(card, tmp_path):
    """sample.cfg with lookup = host on the card and on the CPU (the same
    host init): tables and accumulators at the step's rtol 1e-4 / atol
    1e-6, and all four kernels launched on every step (the forward and
    the gather on every validation batch too)."""
    import dataclasses
    import os
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.lookup import PinnedHostLookup
    from fast_tffm_tpu_torch.ops import offload_kernel as ok
    from fast_tffm_tpu_torch.train import train
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = load_config(os.path.join(repo, "sample.cfg"))
    base = dataclasses.replace(
        base, lookup="host", epoch_num=2,
        train_files=tuple(os.path.join(repo, f) for f in base.train_files),
        validation_files=tuple(os.path.join(repo, f)
                               for f in base.validation_files))
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", card)):
        cfg = dataclasses.replace(base, model_file=str(tmp_path / name /
                                                       "fm"),
                                  log_file="")
        fm_kernel.launches = fm_kernel.bwd_launches = 0
        ok.gather_launches = ok.adagrad_launches = 0
        table = train(cfg, device=dev)
        assert table.device.type == "cpu"
        if name == "card":
            assert ok.is_page_locked(table)
        counts = (fm_kernel.launches, fm_kernel.bwd_launches,
                  ok.gather_launches, ok.adagrad_launches)
        lk = PinnedHostLookup.from_checkpoint(cfg, device="cpu")
        out[name] = (table.numpy().copy(), lk.acc.numpy(), counts)
    steps = 2 * -(-2000 // base.batch_size)
    val = 2 * -(-500 // base.batch_size)
    assert out["cpu"][2] == (0, 0, 0, 0)
    assert out["card"][2] == (steps + val, steps, steps + val, steps)
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(out["card"][1][:base.num_rows],
                               out["cpu"][1][:base.num_rows], rtol=1e-4,
                               atol=1e-6)
    assert not out["card"][0][base.pad_id].any()


def test_offload_card_memory_stays_at_the_batch_blocks(card, tmp_path):
    """A 2^22-row table (151 MB, and its accumulator) trains with the
    card's peak allocated bytes over the run at the batch blocks: under
    16 MB above what the card held before."""
    import dataclasses
    import os
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.pipeline import batch_iterator
    from fast_tffm_tpu_torch.lookup import (make_offload_backend,
                                            make_offload_train_step)
    from fast_tffm_tpu_torch.ops import offload_kernel as ok
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = dataclasses.replace(
        load_config(os.path.join(repo, "sample.cfg")), lookup="host",
        vocabulary_size=1 << 22, hash_feature_id=True,
        train_files=(os.path.join(repo, "data", "sample_train.txt"),))
    spec = port_fm.ModelSpec.from_config(cfg)
    assert spec.dedup == "host"
    lk = make_offload_backend(cfg, cfg.seed, device=card)
    assert lk.mode == "pinned" and ok.is_page_locked(lk.table)
    assert ok.is_page_locked(lk.acc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step = make_offload_train_step(spec, lk, cfg.learning_rate)
    for batch in batch_iterator(cfg, cfg.train_files, training=True,
                                epochs=1, raw_ids=False):
        loss, _ = step(**port_fm.batch_args(batch, card))
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert torch.cuda.max_memory_allocated() - base < 16 << 20
    assert lk.table.nbytes > 150e6


def test_reset_table_rows_on_card_matches_cpu(card, tmp_path):
    from fast_tffm_tpu_torch.checkpoint import CheckpointState
    from fast_tffm_tpu_torch.vocab.table import reset_table_rows
    V, D = 20000, 17
    rng = np.random.default_rng(31)
    table = torch.from_numpy(rng.normal(size=(V + 1, D)).astype(np.float32))
    table[V] = 0.0
    acc = torch.from_numpy(rng.uniform(0.1, 3.0, (V + 1, D))
                           .astype(np.float32))
    rows = np.sort(rng.choice(V, 9000, replace=False)).astype(np.int32)
    want_t, want_a = table.clone(), acc.clone()
    reset_table_rows(want_t, want_a, rows, 0.1)
    t, a = table.to(card), acc.to(card)
    # Queue work before the reset on the same stream: the reset lands
    # behind it, and the snapshot behind the reset.
    t.mul_(1.0)
    reset_table_rows(t, a, rows, 0.1)
    assert torch.equal(t.cpu(), want_t) and torch.equal(a.cpu(), want_a)
    assert not want_t[rows].any()
    ckpt = CheckpointState(str(tmp_path / "m"), adagrad_init=0.1)
    ckpt.save(1, t, a, vocabulary_size=V, wait=True)
    r = ckpt.restore(template={"table": (V + 1, D), "acc": (V + 1, D)})
    assert torch.equal(r["table"], want_t) and torch.equal(r["acc"], want_a)


def test_pinned_reset_rows_straight_after_a_step(card):
    """The reset's CPU writes wait for the write-back the step queued
    into the page-locked state: equal to the CPU backend doing the same
    step and reset, and so is the next step."""
    from fast_tffm_tpu_torch.lookup import (PinnedHostLookup,
                                            make_offload_train_step)
    cfg = FmConfig(vocabulary_size=5000, factor_num=8, batch_size=1024,
                   learning_rate=0.1, lookup="host")
    spec = port_fm.ModelSpec.from_config(cfg)
    rng = np.random.default_rng(32)
    B, L = cfg.batch_size, 24
    idx = rng.zipf(1.2, size=(B, L)).astype(np.int64) % cfg.vocabulary_size
    idx[:, 0] = 7  # the hottest row: in every example
    uniq, inv = np.unique(idx, return_inverse=True)
    U = len(uniq) + 1
    uniq_ids = np.full(U, cfg.pad_id, np.int32)
    uniq_ids[:len(uniq)] = uniq
    batch = dict(labels=(rng.random(B) < 0.4).astype(np.float32),
                 weights=np.ones(B, np.float32),
                 uniq_ids=uniq_ids,
                 local_idx=inv.reshape(B, L).astype(np.int32),
                 vals=rng.random((B, L)).astype(np.float32))
    reset = np.sort(np.concatenate([[7], rng.choice(
        np.setdiff1d(uniq, [7]), 50, replace=False)])).astype(np.int32)
    out = {}
    for dev in (torch.device("cpu"), card):
        lk = PinnedHostLookup(cfg, seed=5, device=dev)
        step = make_offload_train_step(spec, lk, cfg.learning_rate)
        args = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        step(**args)
        lk.reset_rows(reset, cfg.adagrad_init)
        t, a = (x.clone() for x in lk.state())
        step(**args)
        out[dev.type] = (t, a) + tuple(x.clone() for x in lk.state())
    cpu, got = out["cpu"], out["cuda"]
    for x, y in zip(got, cpu):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert not got[0][reset].any()
    assert (got[1][reset] == np.float32(cfg.adagrad_init)).all()


def test_remapped_raw_ids_batch_through_both_kernels(card):
    """Hashed ids remapped through a slot map that admits few of them:
    most cells land on the cold row 0, a hot row the backward's atomics
    meet on B·L/2 times and more."""
    from types import SimpleNamespace
    from fast_tffm_tpu_torch.vocab.table import COLD_ROW, VocabRuntime
    cfg = FmConfig(vocabulary_size=4096, factor_num=16, vocab_mode="admit")
    rng = np.random.default_rng(33)
    rt = VocabRuntime.from_config(cfg)
    hot = rng.integers(0, 1 << 30, 600).astype(np.int64)
    for _ in range(3):
        rt.note_trained(SimpleNamespace(vocab_obs=np.unique(hot)))
    rt.barrier()
    B, L = 2048, 40
    raw = rng.integers(0, 1 << 30, (B, L)).astype(np.int64)
    mask = rng.random((B, L)) < 0.3
    raw[mask] = hot[rng.integers(0, len(hot), int(mask.sum()))]
    raw[:, 35:] = 1 << 30  # padding
    batch = SimpleNamespace(uniq_ids=None, local_idx=raw)
    rt.remap(batch)
    idx = torch.from_numpy(batch.local_idx.astype(np.int32))
    counts = torch.bincount(idx.reshape(-1).long())
    assert int(counts.argmax()) == COLD_ROW
    assert int(counts[COLD_ROW]) > B * L // 2
    params = torch.from_numpy((rng.normal(size=(cfg.num_rows, 17)) * 0.1)
                              .astype(np.float32))
    params[-1] = 0.0
    vals = torch.from_numpy(rng.random((B, L)).astype(np.float32))
    vals[:, 35:] = 0.0
    plain = interaction.fm_batch_scores(params, idx, vals)
    got = fm_kernel.fm_batch_scores(params.to(card), idx.to(card),
                                    vals.to(card)).cpu()
    assert torch.equal(got, plain)
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32))
    dp, _, dp_abs, _ = interaction.fm_batch_scores_bwd(
        params, idx, vals, g, need_dx=True, magnitudes=True)
    got_dp, _ = fm_kernel.fm_batch_scores_bwd(
        params.to(card), idx.to(card), vals.to(card), g.to(card),
        need_dx=False)
    torch.cuda.synchronize()
    _assert_within(got_dp, dp, dp_abs, "dparams")


def test_admit_train_on_card_matches_cpu(card, tmp_path):
    """sample.cfg in admit mode with vocabulary_size below its 200 ids:
    the card against the CPU at the step's tolerance, the same sidecar,
    both kernels launched on every step."""
    import dataclasses
    import os
    from fast_tffm_tpu_torch.checkpoint import read_vocab_sidecar
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.train import train
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = load_config(os.path.join(repo, "sample.cfg"))
    base = dataclasses.replace(
        base, vocab_mode="admit", vocabulary_size=64, epoch_num=3,
        train_files=tuple(os.path.join(repo, f) for f in base.train_files),
        validation_files=())
    from fast_tffm_tpu_torch.models import convert
    rng = np.random.default_rng(34)
    table0 = rng.uniform(-0.01, 0.01, (base.num_rows, base.row_dim)
                         ).astype(np.float32)
    table0[-1] = 0.0
    acc0 = np.full_like(table0, base.adagrad_init)
    out = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", card)):
        cfg = dataclasses.replace(base, model_file=str(tmp_path / name /
                                                       "fm"), log_file="")
        f0, b0 = fm_kernel.launches, fm_kernel.bwd_launches
        table = train(cfg, device=dev, init_state=convert.state_from_numpy(
            table0, acc0, cfg, dev)).cpu().numpy()
        out[name] = (table, read_vocab_sidecar(cfg.model_file + ".ckpt",
                                               48),
                     fm_kernel.launches - f0, fm_kernel.bwd_launches - b0)
    assert out["cpu"][2:] == (0, 0) and out["card"][2:] == (48, 48)
    assert out["card"][1] == out["cpu"][1] is not None
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-6)


def test_bwd_kernel_one_row_takes_every_slot(card):
    """An admit batch before its first barrier: every slot on the cold
    row, B·L contributions a column to one row. No float32 sum of that
    many contributions in one sequence meets the rtol 1e-5 bound (the
    plain version's misses it, checked here); the kernel's fixed-point
    sum does, against the plain version with each row's contributions
    summed in float64, and two launches agree to the bit."""
    B, L, U, K = 8192, 38, 64, 16
    rng = np.random.default_rng(35)
    params = torch.from_numpy((rng.normal(size=(U, K + 1)) * 0.1)
                              .astype(np.float32))
    idx = torch.zeros((B, L), dtype=torch.int32)
    vals = torch.from_numpy(rng.lognormal(0.0, 0.5, (B, L))
                            .astype(np.float32))
    g = torch.from_numpy((rng.random(B) - 0.25).astype(np.float32) / B)
    # Each slot's float32 contribution, formed as the plain version
    # forms it, summed into the one row in float64.
    s = torch.zeros((B, K))
    for l in range(L):
        s = s + params[idx[:, l].long(), :K] * vals[:, l][:, None]
    grows = []
    for l in range(L):
        x = vals[:, l]
        gx = g * x
        sv = s - params[0, :K] * x[:, None]
        grows.append(torch.cat([gx[:, None] * sv, gx[:, None]],
                               dim=1).double())
    grows = torch.stack(grows)
    dp = torch.zeros((U, K + 1), dtype=torch.float64)
    dp_abs = torch.zeros_like(dp)
    dp[0], dp_abs[0] = grows.sum(dim=(0, 1)), grows.abs().sum(dim=(0, 1))
    plain, _ = interaction.fm_batch_scores_bwd(params, idx, vals, g,
                                               need_dx=False)
    assert ((plain.double() - dp).abs() > BWD_ATOL + BWD_RTOL * dp_abs
            ).any()
    runs = [fm_kernel.fm_batch_scores_bwd(
        params.to(card), idx.to(card), vals.to(card), g.to(card),
        need_dx=False)[0].cpu() for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    _assert_within(runs[0], dp, dp_abs, "dparams")


@pytest.mark.parametrize("K", [1, 16, 127])
def test_bwd_kernel_repeats_to_the_bit(card, K):
    """Zipf-drawn rows (row 0 takes about a quarter of the batch's
    slots): launches on one input give one dparams and one dvals, bit
    for bit."""
    B, L = 2048, 64
    rng = np.random.default_rng(36 + K)
    U = 4096
    params = torch.from_numpy((rng.normal(size=(U, K + 1)) * 0.1)
                              .astype(np.float32)).to(card)
    idx = np.minimum(rng.zipf(1.3, (B, L)) - 1, U - 1).astype(np.int32)
    vals = torch.from_numpy(rng.uniform(0.5, 1.5, (B, L))
                            .astype(np.float32)).to(card)
    g = torch.from_numpy(rng.normal(size=B).astype(np.float32)).to(card)
    idx = torch.from_numpy(idx).to(card)
    first = fm_kernel.fm_batch_scores_bwd(params, idx, vals, g, True)
    for _ in range(3):
        again = fm_kernel.fm_batch_scores_bwd(params, idx, vals, g, True)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


def _free_port_block(n):
    """Below the ephemeral range: a replica restarted on a port there can
    fail to bind it while an outgoing connection's TIME_WAIT holds it."""
    import socket
    from fast_tffm_tpu_torch.serve.fleet import ephemeral_port_range
    rng = np.random.default_rng()
    top = min(ephemeral_port_range()[0], 32768)
    for _ in range(200):
        base = int(rng.integers(10000, top - n))
        socks = []
        try:
            for port in range(base, base + n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise RuntimeError("no block of free ports")


def test_fleet_on_the_card_equals_an_in_process_server(card, tmp_path):
    import urllib.request
    from fast_tffm_tpu_torch.checkpoint import write_published
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
    from fast_tffm_tpu_torch.scoring import format_scores
    from fast_tffm_tpu_torch.serve.fleet import FleetSupervisor
    from fast_tffm_tpu_torch.serve.server import ScorerServer
    base = _free_port_block(3)
    path = tmp_path / "fleet.cfg"
    path.write_text(f"""[General]
vocabulary_size = 50000
factor_num = 16
model_file = {tmp_path / "fm"}

[Serve]
serve_port = {base}
serve_proxy_port = {base + 2}
serve_replicas = 2
serve_max_batch = 64
serve_max_wait_ms = 1
serve_health_poll_seconds = 0.1
""")
    cfg = load_config(str(path))
    rng = np.random.default_rng(31)
    table = (rng.normal(size=(cfg.num_rows, cfg.row_dim)) * 0.1
             ).astype(np.float32)
    save_checkpoint_from_numpy(cfg, table, None, 10)
    write_published(cfg.model_file + ".ckpt", 10)
    lines = []
    for _ in range(300):
        ids = rng.integers(0, cfg.vocabulary_size, int(rng.integers(0, 40)))
        lines.append("1 " + " ".join(f"{i}:{rng.random():.3f}"
                                     for i in ids))
    spans = [(int(lo), int(n)) for lo, n in zip(
        rng.integers(0, len(lines) - 64, 40), rng.integers(1, 65, 40))]
    server = ScorerServer(cfg, device=card, watch=False)
    try:
        want = [format_scores(server.score_lines(
            lines[lo:lo + n], timeout=60).scores).encode()
            for lo, n in spans]
    finally:
        server.close()
    sup = FleetSupervisor(cfg, str(path))
    try:
        sup.start()
        assert sup.wait_ready(2, timeout=300)
        got = []
        for lo, n in spans:
            req = urllib.request.Request(
                f"http://127.0.0.1:{sup.proxy_port}/score",
                data=("\n".join(lines[lo:lo + n]) + "\n").encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                got.append((resp.status, resp.read(),
                            resp.headers["X-FM-Step"],
                            resp.headers["X-FM-Replica"]))
        health = [r.probe(timeout=30) for r in sup.replicas]
    finally:
        sup.stop()
    assert [g[1] for g in got] == want
    assert {(g[0], g[2]) for g in got} == {(200, "10")}
    assert {g[3] for g in got} == {"0", "1"}
    for h in health:
        assert h["device"] == "cuda:0" and h["kernel"] == "cuda"
        assert h["kernel_launches"] > 0 and h["flushes"] > 0
    assert all(r.exited() for r in sup.replicas)


def test_two_rank_sharded_step_on_the_card(card, tmp_path):
    """Two ranks on cuda:0 (two processes over gloo, each with its CUDA
    context and row shard) take 4 sharded steps of an FM (the CUDA
    kernels), an FFM and an order-3 FM, rank 1 stepping the filler in
    the last; held against the single-process
    host-dedup step on the card on the concatenated global batch
    (``local_idx`` offset into the concatenated unique axis): the loss
    and the post-step table and accumulator at the step's rtol 1e-4 /
    atol 1e-6, and the sharded scores at rtol 1e-5 / atol 1e-6."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_dist_ranks as ranks
    from fast_tffm_tpu_torch.parallel.sharded import offset_local_idx
    wd = str(tmp_path)
    ranks.write_step_inputs(wd)
    results = ranks.run_ranks("step", wd, device=card.type)
    for name, kw in ranks.step_cases():
        cfg = FmConfig(**kw)
        spec = port_fm.ModelSpec.from_config(cfg, num_processes=2)
        init = np.load(os.path.join(wd, f"{name}-init.npz"))
        rows = cfg.ckpt_rows
        table = torch.zeros((rows, cfg.row_dim), device=card)
        table[:cfg.num_rows] = torch.from_numpy(init["table"]).to(card)
        acc = torch.full((rows, cfg.row_dim), cfg.adagrad_init, device=card)
        U = len(results[0][f"{name}/b0/uniq_ids"])

        def glob(s, keys):
            out = {}
            for k in keys:
                key = f"{name}/b{s}/{k}"
                if key in results[0]:
                    parts = [r[key] for r in results]
                    if k == "local_idx":
                        parts = [offset_local_idx(p, i, U)
                                 for i, p in enumerate(parts)]
                    out[k] = torch.from_numpy(np.concatenate(parts)).to(card)
            return out

        for s in range(ranks.STEPS):
            args = glob(s, ("labels", "weights", "uniq_ids", "local_idx",
                            "vals", "fields"))
            table, acc, loss, _ = port_fm.train_step_body(
                spec, table, acc, **args)
            for r in results:
                np.testing.assert_allclose(float(r[f"{name}/loss{s}"]),
                                           float(loss), rtol=1e-4)
        for key, want in (("table", table), ("acc", acc)):
            got = np.concatenate([r[f"{name}/{key}"] for r in results])
            np.testing.assert_allclose(got, want.cpu().numpy(), rtol=1e-4,
                                       atol=1e-6)
        args = glob(ranks.STEPS, ("uniq_ids", "local_idx", "vals",
                                  "fields"))
        with torch.no_grad():
            want = port_fm.score_body(spec, table, **args).cpu().numpy()
        got = np.concatenate([r[f"{name}/scores"] for r in results])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_two_rank_shrink_on_the_card(card, tmp_path):
    """``elastic = shrink`` on cuda:0: worker 1 of two dies after the
    first periodic save; the survivor names it, reforms generation 1
    alone, restores the save and finishes the schedule on the card,
    launching both kernels; its table equals the same resume on the
    CPU."""
    import os
    import re
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_dist_ranks as ranks
    from fast_tffm_tpu_torch.checkpoint import CheckpointState
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.models.convert import save_checkpoint_from_numpy
    from fast_tffm_tpu_torch.train import checkpoint_template, train
    wd = str(tmp_path)
    epochs = 2
    cfg_path = ranks.write_elastic_run(wd, epochs, "shrink")
    cfg = load_config(cfg_path)
    argv = ["train", cfg_path, "dist_train", "worker"]
    procs = {"w0": ranks.spawn_cli(wd, "w0", "keep-steps", argv + ["0"]),
             "w1": ranks.spawn_cli(wd, "w1",
                                   f"kill-at-step-{cfg.save_steps + 2}",
                                   argv + ["1"])}
    rcs, logs = ranks.wait_all(procs, wd, timeout=600)
    tails = ranks.log_tails(logs)
    assert rcs == [0, -9], (rcs, tails)
    out0 = logs["w0"]
    assert "rank 0 of 2 on cuda:0" in out0, tails
    for want in ("process 1", "elastic reform generation 1",
                 "elastic recovery complete", "training done"):
        assert want in out0, (want, tails)
    s0 = int(re.findall(r"restored checkpoint at step (\d+)", out0)[-1])
    per_pass = -(-ranks.ELASTIC_LINES // ranks.ELASTIC_BATCH)
    ckpt = CheckpointState(cfg.model_file)
    start = ckpt.restore(step=s0, template=checkpoint_template(cfg))
    final = ckpt.restore(template=checkpoint_template(cfg))
    ckpt.close()
    assert (s0, int(start["epoch"])) == (cfg.save_steps, 0)
    assert int(final["step"]) == s0 + epochs * per_pass
    single = load_config(cfg_path)
    import dataclasses
    single = dataclasses.replace(single, worker_hosts=(), elastic="off",
                                 model_file=os.path.join(wd, "cpu", "fm"))
    save_checkpoint_from_numpy(single, start["table"].numpy(),
                               start["acc"].numpy(), s0, epoch=0)
    want = train(single, device="cpu")
    np.testing.assert_allclose(final["table"].numpy(),
                               want[:single.num_rows].numpy(), rtol=1e-4,
                               atol=1e-6)


def test_device_memory_stats_on_the_card(card):
    from fast_tffm_tpu_torch.obs import memory as mem
    mem.bind_device(card)
    try:
        x = torch.empty(64 << 20, dtype=torch.uint8, device=card)
        stats = mem.device_memory_stats()
        assert set(stats) == {"bytes_in_use", "peak_bytes_in_use",
                              "bytes_limit"}
        assert stats["bytes_limit"] == \
            torch.cuda.get_device_properties(card).total_memory
        assert stats["bytes_in_use"] == torch.cuda.memory_allocated(card)
        assert stats["bytes_in_use"] >= x.numel()
        assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
        assert mem.device_capacity_bytes() == stats["bytes_limit"]
        mem.bind_device("cpu")
        assert mem.device_memory_stats() is None
    finally:
        mem.bind_device(None)


def test_oom_guard_on_a_real_oom(card):
    from fast_tffm_tpu_torch.obs import memory as mem
    from fast_tffm_tpu_torch.testing.telemetry import oom_wrap
    mem.bind_device(card)
    mem.LEDGER.register("table", 1 << 30)
    mem.LEDGER.register("adagrad_acc", 1 << 30)
    try:
        got = oom_wrap(card)
    finally:
        mem.LEDGER.reset()
        mem.bind_device(None)
    assert got["cause"] == "OutOfMemoryError" and got["names_owners"]
    assert got["first_line"].startswith(
        "device out of memory at smoke/oversized_alloc")
    assert got["allocator_usable"]


def test_telemetry_adds_no_synchronization_to_a_step(card, tmp_path):
    from fast_tffm_tpu_torch.data.pipeline import make_device_batch
    from fast_tffm_tpu_torch.data.parser import ParsedBlock
    from fast_tffm_tpu_torch.testing.telemetry import telemetry_steps
    cfg = FmConfig(vocabulary_size=1 << 16, factor_num=16, batch_size=1024,
                   learning_rate=0.1, log_steps=1, dedup="device",
                   mem_pressure_fraction=0.5)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(4):
        n = rng.integers(1, 33, size=cfg.batch_size)
        poses = np.concatenate([[0], np.cumsum(n)]).astype(np.int32)
        block = ParsedBlock(
            labels=(rng.random(cfg.batch_size) < 0.3).astype(np.float32),
            poses=poses,
            ids=rng.integers(0, cfg.vocabulary_size,
                             size=poses[-1]).astype(np.int32),
            vals=rng.random(poses[-1]).astype(np.float32), fields=None)
        batches.append(make_device_batch(block, cfg, batch_size=cfg.batch_size))
    got = telemetry_steps(cfg, card, batches, steps=12, rounds=2,
                          workdir=str(tmp_path))
    assert got["off"]["syncs"] == got["on"]["syncs"], got
    assert len(set(got["on"]["syncs"])) == 1, got
    assert got["barrier_syncs"] >= 1


def test_profiler_window_holds_the_kernels(card, tmp_path):
    import dataclasses
    import os
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.testing.telemetry import trace_kernel_counts
    from fast_tffm_tpu_torch.train import train
    cfg = load_config("sample.cfg")
    cfg = dataclasses.replace(
        cfg, model_file=str(tmp_path / "m" / "fm"), log_file="",
        train_files=tuple(os.path.abspath(f) for f in cfg.train_files),
        validation_files=(), epoch_num=1, batch_size=64,
        profile_dir=str(tmp_path / "prof"), profile_start_step=5,
        profile_num_steps=3, metrics_file=str(tmp_path / "m.jsonl"))
    train(cfg, device=card)
    (trace,) = os.listdir(cfg.profile_dir)
    assert trace == "train_steps_6-8.trace.json"
    counts = trace_kernel_counts(os.path.join(cfg.profile_dir, trace))
    assert counts == {"fm_score_kernel": 3, "fm_score_bwd_kernel": 3}
