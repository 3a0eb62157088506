"""The port server's request coalescing and background warm-up on the CPU
(``--device cpu``: the fused sampler's plain version, or the scan sampler
for a model the fused sampler refuses), held against the JAX server
(``mlx_vae_tpu/cli/serve.py``) where both run the same function.

* Grouping: the same queue of jobs gives the same groups, ``passes``,
  ``coalesced`` and pass counters in both services (scan route, 8-row
  blocks).
* Block streams: a pure function of (request seed, block); z standard
  normal (mean and standard deviation within 0.01 at 10^5 draws, about 4
  standard errors; Kolmogorov-Smirnov p > 0.001); seeds in [0, 2^31 - 1).
* Coalesced equals solo, bitwise, on the fused route (2 and 3 jobs at
  passes of 256 and 512 rows: greedy, stochastic at temperatures 0.6 / 1.2,
  a declared truncated config) and on the scan route (greedy, passes of 8,
  32 and 256 rows): both hold bit for bit on the CPU. On CUDA the scan
  route's greedy rows do not, and it does not coalesce there.
* A coalesced greedy job against JAX ``generate_with_temperature`` on the
  same block-stream z and conditions: >= 99.0% of first tokens, >= 97.0% of
  rows (the decoder weights are the init scaled by 3, so rows differ).
* Warm-up as in ``tests/test_serve.py::TestBackgroundWarmup``, plus the two
  repairs: a warm-tier plan beyond ``WARM_PLAN_FACTOR`` times the full
  ladder's passes is a 503, and a failed warm-up run shows in ``/health``
  and leaves its tier cold.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from mlx_vae_tpu.cli import serve as jserve
from mlx_vae_tpu.config import ModelConfig as JaxConfig
from mlx_vae_tpu.models.sampling import generate_with_temperature as jgenerate
from mlx_vae_tpu_torch.cli import serve as tserve
from mlx_vae_tpu_torch.config import ModelConfig
from mlx_vae_tpu_torch.models.decoder import init_decoder_params
from mlx_vae_tpu_torch.train.checkpoint import build_checkpoint_host, write_checkpoint
from mlx_vae_tpu_torch.utils.tree import params_to_numpy

SHAPE = dict(vocab_size=24, embedding_dim=16, hidden_dim=16, latent_dim=8,
             num_conditions=2, num_layers=1)
GREEDY, STOCH = (True, 0, 1.0), (False, 0, 1.0)
AGREE_FIRST, AGREE_ROWS = 0.99, 0.97


def _checkpoint(path, seed=0, scale=1.0, **shape):
    cfg = ModelConfig(**{**SHAPE, **shape})
    dec = params_to_numpy(init_decoder_params(torch.Generator().manual_seed(seed), cfg))
    dec = {k: {n: scale * a for n, a in v.items()} for k, v in dec.items()}
    write_checkpoint(path, build_checkpoint_host(
        0, {"encoder": {}, "decoder": dec}, {"encoder": {}, "decoder": {}}, {}))
    return str(path), dec


def _args(ck, tiers, *extra, max_length=8):
    return ["--checkpoint", ck, "--port", "0", "--batch_sizes", tiers,
            "--max_length", str(max_length), "--no_normalize", *extra]


def _service(ck, tiers, *extra, max_length=8):
    return tserve.GenerationService(tserve.build_parser().parse_args(
        _args(ck, tiers, "--device", "cpu", *extra, max_length=max_length)))


def _job(n, pk=GREEDY, seed=0, target=0.0, temperature=1.0):
    return tserve._Job(n, pk[0], temperature, np.asarray([[target, 0.5]], np.float32),
                       seed, top_k=pk[1], top_p=pk[2])


def _queue(svc, jobs):
    """Queue ``jobs`` while holding the dispatcher, then wait for them."""
    with svc._cv:
        svc._pending.extend(jobs)
        svc._cv.notify()
    for j in jobs:
        assert j.done.wait(120) and j.error is None, j.error


# ---- grouping against the JAX service ----

@pytest.fixture(scope="module")
def scan_pair(tmp_path_factory):
    """The JAX service (scan sampler on the CPU) and the port's (V = 600,
    which the fused sampler refuses) on one checkpoint, tiers 8 and 32:
    both coalesce greedy jobs only, in 8-row blocks."""
    ck, _ = _checkpoint(tmp_path_factory.mktemp("pair") / "ck.npz", vocab_size=600)
    js = jserve.GenerationService(jserve.build_parser().parse_args(_args(ck, "8,32")))
    ts = _service(ck, "8,32")
    assert js.wait_warm(300) and ts.wait_warm(120)
    yield js, ts
    js.close()
    ts.close()


SEQUENCES = {
    "mixed": [(5, GREEDY), (3, GREEDY), (20, STOCH), (7, GREEDY), (30, GREEDY),
              (2, GREEDY), (40, GREEDY), (4, STOCH), (9, GREEDY)],
    "full": [(1, STOCH), (8, GREEDY), (8, GREEDY), (8, GREEDY), (8, GREEDY),
             (8, GREEDY), (33, GREEDY), (16, GREEDY), (12, STOCH), (17, GREEDY),
             (15, GREEDY)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_grouping_equals_jax(scan_pair, name):
    js, ts = scan_pair
    assert js.health()["coalescing"] == ts.health()["coalescing"] == {
        "stochastic": False, "greedy": True, "truncated": {}, "block_rows": 8}
    seq = SEQUENCES[name]
    jjobs = [jserve._Job(n, pk[0], 1.0, np.zeros((1, 2), np.float32),
                         jax.random.PRNGKey(i), top_k=pk[1], top_p=pk[2])
             for i, (n, pk) in enumerate(seq)]
    tjobs = [_job(n, pk, seed=i) for i, (n, pk) in enumerate(seq)]
    before = (dict(js._stats), dict(ts._stats))
    _queue(js, jjobs)
    _queue(ts, tjobs)
    assert [(j.passes, j.coalesced) for j in tjobs] == [(j.passes, j.coalesced) for j in jjobs]
    for key in ("device_passes", "jobs", "coalesced_jobs"):
        assert (ts._stats[key] - before[1][key]) == (js._stats[key] - before[0][key]), key
    assert any(j.coalesced for j in tjobs) and not all(j.coalesced for j in tjobs)
    for j, (n, _) in zip(tjobs, seq):
        assert j.tokens.shape == (n, 8)


def test_scan_route_greedy_coalesced_equals_solo(tmp_path):
    """Greedy rows of the scan route in one 256-row pass equal their solo
    passes of 32 and 8 rows."""
    ck, _ = _checkpoint(tmp_path / "ck.npz", scale=3.0, vocab_size=600)
    svc = _service(ck, "8,32,256", max_length=10)
    try:
        assert svc.wait_warm(120) and svc._can_coalesce[GREEDY]
        specs = [(100, 1, 0.1), (152, 2, -0.3)]  # 13 + 19 blocks: one 256-row pass
        solo = [_job(n, GREEDY, seed, t) for n, seed, t in specs]
        for j in solo:
            svc._run_coalesced([j])
        co = [_job(n, GREEDY, seed, t) for n, seed, t in specs]
        svc._run_coalesced(co)
        assert [j.passes for j in solo] == [4, 7] and all(j.passes == 1 for j in co)
        for a, b in zip(solo, co):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len({tuple(r) for r in co[1].tokens}) > 20
    finally:
        svc.close()


def test_scan_route_greedy_does_not_coalesce_on_cuda():
    assert tserve.greedy_row_independent("fused", torch.device("cuda"))
    assert tserve.greedy_row_independent("fused", torch.device("cpu"))
    assert tserve.greedy_row_independent("scan", torch.device("cpu"))
    assert not tserve.greedy_row_independent("scan", torch.device("cuda"))


# ---- block streams ----

def test_block_streams_are_a_pure_function_of_seed_and_block():
    z, s = tserve.block_streams(7, 0, 12, 8, 5, "cpu")
    assert z.shape == (96, 5) and z.dtype == torch.float32
    assert s.shape == (12,) and s.dtype == torch.int32
    for k, m in ((0, 1), (3, 4), (11, 1), (5, 7)):
        zk, sk = tserve.block_streams(7, k, m, 8, 5, "cpu")
        assert torch.equal(zk, z[8 * k:8 * (k + m)]) and torch.equal(sk, s[k:k + m])
    # wider blocks keep each row's leading dims: the hash is per (row, dim)
    zw, sw = tserve.block_streams(7, 0, 12, 8, 9, "cpu")
    assert torch.equal(zw[:, :5], z) and torch.equal(sw, s)


@pytest.mark.parametrize("other", [8, -7, 7 + 2**64, 2**40 + 7])
def test_block_streams_differ_by_seed(other):
    z, s = tserve.block_streams(7, 0, 4, 8, 5, "cpu")
    zo, so = tserve.block_streams(other, 0, 4, 8, 5, "cpu")
    if other % 2**64 == 7:
        assert torch.equal(z, zo) and torch.equal(s, so)
    else:
        assert not torch.equal(z, zo) and not torch.equal(s, so)
        assert (z != zo).float().mean() > 0.99


def test_block_streams_z_is_standard_normal():
    z, _ = tserve.block_streams(3, 0, 250, 50, 8, "cpu")  # 10^5 draws
    x = z.double().numpy().reshape(-1)
    assert x.size == 100_000
    assert abs(x.mean()) < 0.01 and abs(x.std() - 1.0) < 0.01
    assert stats.kstest(x, "norm").pvalue > 1e-3
    # blocks and rows are not correlated with each other
    per_block = z.reshape(250, -1).mean(1).numpy()
    assert abs(per_block.std() * np.sqrt(400) - 1.0) < 0.15


def test_block_streams_seeds_are_int31():
    s = torch.cat([tserve.block_streams(seed, 0, 1000, 1, 1, "cpu")[1]
                   for seed in (0, 1, 2**63, -1)])
    assert s.min() >= 0 and s.max() < 2**31 - 1
    assert len(np.unique(s.numpy())) > 3990


# ---- coalesced against solo on the fused route ----

@pytest.fixture(scope="module")
def fused_svc(tmp_path_factory):
    """The fused sampler's plain version at tiers 256 and 512 (two
    coalescible tiers of 256-row blocks), weights scaled by 3."""
    ck, dec = _checkpoint(tmp_path_factory.mktemp("fused") / "ck.npz", scale=3.0)
    svc = _service(ck, "256,512", "--truncation", "top_k=3,top_p=0.9", max_length=10)
    assert svc.wait_warm(120)
    assert svc.sampler == "fused" and svc.chunk == 256 and svc.co_tiers == [256, 512]
    yield svc, dec
    svc.close()


CONFIGS = {"greedy": GREEDY, "stochastic": STOCH, "truncated": (False, 3, 0.9)}
GROUPS = {2: [(100, 1, 0.1, 0.6), (300, 2, -0.3, 1.2)],
          3: [(100, 1, 0.1, 0.6), (200, 2, -0.3, 1.2), (50, 3, 0.7, 0.6)]}


@pytest.mark.parametrize("size", sorted(GROUPS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_coalesced_equals_solo(fused_svc, config, size):
    svc = fused_svc[0]
    pk = CONFIGS[config]
    solo = [_job(n, pk, seed, t, temp) for n, seed, t, temp in GROUPS[size]]
    for j in solo:
        svc._run_coalesced([j])
    co = [_job(n, pk, seed, t, temp) for n, seed, t, temp in GROUPS[size]]
    svc._run_coalesced(co)
    assert all(j.passes == 1 for j in solo)
    assert all(j.passes == 2 for j in co)  # 3 blocks: one 512-row pass and one 256-row
    assert all(j.coalesced for j in co) and not any(j.coalesced for j in solo)
    for a, b in zip(solo, co):
        assert a.tokens.shape == (a.n, 10)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    if size == 2:  # dt by row share: 1 block against 2
        assert co[1].dt == pytest.approx(2 * co[0].dt)
    else:
        assert co[0].dt == pytest.approx(co[1].dt)


def test_request_seeds_count_mod_2_64(fused_svc):
    """Any JSON integer is a seed: streams key on it mod 2**64."""
    svc = fused_svc[0]
    jobs = [_job(5, STOCH, seed) for seed in (3, 2**70 + 3, 3 - 2**64, 4)]
    svc._run_coalesced(jobs)
    for j in jobs[1:3]:
        np.testing.assert_array_equal(j.tokens, jobs[0].tokens)
    assert not np.array_equal(jobs[3].tokens, jobs[0].tokens)


def test_fused_temperature_moves_only_its_own_job(fused_svc):
    svc = fused_svc[0]
    a, b = _job(100, STOCH, 1, 0.1, 0.6), _job(100, STOCH, 2, 0.1, 0.6)
    svc._run_coalesced([a, b])
    a2, b2 = _job(100, STOCH, 1, 0.1, 0.6), _job(100, STOCH, 2, 0.1, 3.0)
    svc._run_coalesced([a2, b2])
    np.testing.assert_array_equal(a.tokens, a2.tokens)
    assert not np.array_equal(b.tokens, b2.tokens)


def test_many_concurrent_callers_each_get_their_own_rows(fused_svc):
    """24 threads call ``generate`` at once under a short switch interval:
    every job completes once, the served-job counter counts each, and each
    response equals its serial rerun."""
    svc = fused_svc[0]
    reqs = [{"num_molecules": 3 + 7 * i % 50, "seed": i, "target": [0.1 * i - 1.0, 0.5],
             "greedy": i % 3 == 0, "temperature": 0.7 + 0.1 * (i % 5), "return_tokens": True}
            for i in range(24)]
    before, out = dict(svc._stats), {}

    def call(i):
        out[i] = svc.generate(reqs[i])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and set(out) == set(range(len(reqs)))
    assert svc._stats["jobs"] - before["jobs"] == len(reqs)
    for i, req in enumerate(reqs):
        assert svc.generate(req)["tokens"] == out[i]["tokens"], f"request {i}"


def test_coalesced_greedy_matches_jax(fused_svc):
    """A coalesced greedy job against the JAX scan sampler on the same
    block-stream z and conditions, under the greedy contract."""
    svc, dec = fused_svc
    a, b = _job(150, GREEDY, 1, 0.3), _job(230, GREEDY, 2, -0.5)
    svc._run_coalesced([a, b])
    z, _ = tserve.block_streams(2, 0, 1, svc.chunk, SHAPE["latent_dim"], "cpu")
    cond = np.broadcast_to(np.asarray([[-0.5, 0.5]], np.float32), (230, 2))
    jp = jax.tree_util.tree_map(jnp.asarray, dec)
    want = np.asarray(jgenerate(jp, JaxConfig(**SHAPE), jnp.asarray(z[:230].numpy()),
                                jnp.asarray(cond), jax.random.PRNGKey(0), max_length=10,
                                greedy=True))
    got = b.tokens.astype(np.int64)
    first = float((got[:, 0] == want[:, 0]).mean())
    rows = float((got == want).all(1).mean())
    assert first >= AGREE_FIRST and rows >= AGREE_ROWS, (first, rows)
    assert len({tuple(r) for r in want}) > 20  # the rows differ from each other


# ---- warm-up ----

@pytest.fixture()
def warm_svc(tmp_path):
    ck, _ = _checkpoint(tmp_path / "ck.npz", seed=5)
    svc = _service(ck, "8,32")
    yield svc
    svc.close()


def test_constructor_returns_with_smallest_tier_warm(warm_svc):
    for pk in warm_svc.pkeys:
        assert (warm_svc.tiers[0],) + pk in warm_svc._warm


def test_warm_plan_converges_to_full_ladder(warm_svc):
    assert warm_svc.wait_warm(120)
    assert warm_svc._plan_warm(_job(48, STOCH)) == warm_svc.plan_passes(48) == [32, 8, 8]


def test_partial_ladder_plans_over_warm_tiers_only(warm_svc):
    assert warm_svc.wait_warm(120)
    saved = set(warm_svc._warm)
    try:
        warm_svc._warm = {k for k in saved if k[0] == 8}
        assert warm_svc._plan_warm(_job(20, STOCH)) == [8, 8, 8]
        warm_svc._warm = set()
        with pytest.raises(tserve._ColdLadderError, match="no warm tier"):
            warm_svc._plan_warm(_job(20, STOCH))
    finally:
        warm_svc._warm = saved


def test_warm_plan_is_bounded(warm_svc):
    """20 rows over a warm 8-row tier still plan (3 passes, as the whole
    ladder's plan), 1,000,000 rows (125,000 passes against 31,250) and 64
    rows (8 against 2) get a 503; with the ladder warm both plan."""
    assert warm_svc.wait_warm(120)
    saved = set(warm_svc._warm)
    try:
        warm_svc._warm = {k for k in saved if k[0] == 8}
        assert warm_svc._plan_warm(_job(20, STOCH)) == [8, 8, 8]
        assert warm_svc._plan_warm(_job(48, STOCH)) == [8] * 6
        for n in (1_000_000, 64):
            with pytest.raises(tserve._ColdLadderError, match="passes"):
                warm_svc._plan_warm(_job(n, STOCH))
        with pytest.raises(tserve._ColdLadderError):
            warm_svc.generate({"num_molecules": 1_000_000, "target": [0.0, 0.0]})
    finally:
        warm_svc._warm = saved
    assert len(warm_svc._plan_warm(_job(1_000_000, STOCH))) == 31_250


def test_coalescing_waits_for_full_warm(warm_svc):
    assert warm_svc.wait_warm(120)
    job = _job(8, STOCH)
    assert warm_svc._can_coalesce[job.pkey] and warm_svc._eligible(job)
    warm_svc._warm_done.clear()
    try:
        assert not warm_svc._eligible(job)
    finally:
        warm_svc._warm_done.set()
    saved = set(warm_svc._warm)
    try:  # a cold coalescible tier keeps its config solo
        warm_svc._warm = saved - {(32,) + job.pkey}
        assert not warm_svc._eligible(job) and warm_svc._eligible(_job(8, GREEDY))
    finally:
        warm_svc._warm = saved


def test_health_reports_warmup(warm_svc):
    assert warm_svc.wait_warm(120)
    h = warm_svc.health()["warmup"]
    assert h["complete"] is True and h["error"] is None
    assert h["warm_programs"] == h["total_programs"] == 4
    assert h["warm_tiers"] == {"greedy=False,top_k=0,top_p=1.0": [8, 32],
                               "greedy=True,top_k=0,top_p=1.0": [8, 32]}


def test_sync_warmup_flag_blocks_until_all_warm(tmp_path):
    ck, _ = _checkpoint(tmp_path / "ck.npz", seed=6)
    svc = _service(ck, "8,16", "--sync_warmup")
    try:
        assert svc._warm_done.is_set() and svc._co_warm
        assert len(svc._warm) == len(svc.tiers) * len(svc.pkeys) == 4
        assert svc._warmer is None
    finally:
        svc.close()


def test_close_joins_the_warmer(tmp_path, monkeypatch):
    ck, _ = _checkpoint(tmp_path / "ck.npz", seed=7)
    orig = tserve.GenerationService._warm_one

    def slow(self, tier, pk):
        if tier != 8:
            time.sleep(0.2)
        return orig(self, tier, pk)

    monkeypatch.setattr(tserve.GenerationService, "_warm_one", slow)
    svc = _service(ck, "8,16,32")
    svc.close()
    assert not svc._warmer.is_alive() and not svc._dispatcher.is_alive()
    assert svc._warm_done.is_set() and not svc.health()["warmup"]["complete"]


# ---- over HTTP ----

def _start(argv):
    args = tserve.build_parser().parse_args(argv)
    ready = threading.Event()
    thread = threading.Thread(target=tserve.serve_forever, args=(args, ready), daemon=True)
    thread.start()
    assert ready.wait(timeout=120), "server did not come up"
    return ready, thread, f"http://127.0.0.1:{ready.server.server_address[1]}"


def _post(base, payload):
    req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _health(base):
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        return json.loads(r.read())


def test_warm_failure_shows_in_health_and_leaves_the_tier_cold(tmp_path, monkeypatch):
    """The warmer's failure at the 32-row tier: /health reports it and ends
    the warm-up, the tier stays cold (never served), requests over the warm
    8-row tier are served, and one that needs too many 8-row passes gets a
    503."""
    ck, _ = _checkpoint(tmp_path / "ck.npz", seed=8)
    orig = tserve.GenerationService._warm_one

    def flaky(self, tier, pk):
        if tier == 32:
            raise RuntimeError("injected device fault")
        return orig(self, tier, pk)

    monkeypatch.setattr(tserve.GenerationService, "_warm_one", flaky)
    ready, thread, base = _start(_args(ck, "8,32", "--device", "cpu"))
    try:
        assert ready.service.wait_warm(120)
        w = _health(base)["warmup"]
        assert "injected device fault" in w["error"] and "tier 32" in w["error"]
        assert w["complete"] is False and w["warm_programs"] == 2
        assert all(t == [8] for t in w["warm_tiers"].values())
        g = _post(base, {"num_molecules": 20, "target": [0.0, 0.0], "seed": 1,
                         "return_tokens": True})
        assert g["passes"] == 3 and not g["coalesced"] and len(g["tokens"]) == 20
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, {"num_molecules": 1_000_000, "target": [0.0, 0.0]})
        assert e.value.code == 503 and e.value.headers["Retry-After"] == "60"
        assert (32, False, 0, 1.0) not in ready.service._warm
    finally:
        ready.server.shutdown()
        thread.join(timeout=30)


@pytest.fixture(scope="module")
def http_srv(tmp_path_factory):
    ck, _ = _checkpoint(tmp_path_factory.mktemp("http") / "ck.npz", seed=9, scale=3.0)
    ready, thread, base = _start(_args(ck, "256,512", "--device", "cpu", max_length=12))
    assert ready.service.wait_warm(120)
    yield base, ready.service
    ready.server.shutdown()
    thread.join(timeout=30)


def _concurrent(base, svc, reqs):
    """Send ``reqs`` at once while the dispatcher is held on a solo job, so
    they queue together; return the responses by index."""
    entered, gate, orig = threading.Event(), threading.Event(), svc._run_solo

    def gated(job, *a, **k):
        if job.n == 777:
            entered.set()
            gate.wait(60)
        return orig(job, *a, **k)

    svc._run_solo = gated
    out = {}

    def hit(i, req):
        out[i] = _post(base, req)

    try:
        threads = [threading.Thread(target=hit, args=("blocker", {
            "num_molecules": 777, "target": [0.0, 0.0]}))]
        threads[0].start()
        assert entered.wait(60)
        threads += [threading.Thread(target=hit, args=(i, r)) for i, r in enumerate(reqs)]
        for t in threads[1:]:
            t.start()
        deadline = time.time() + 60
        while len(svc._pending) < len(reqs) and time.time() < deadline:
            time.sleep(0.01)
        assert len(svc._pending) == len(reqs)
        gate.set()
        for t in threads:
            t.join(120)
    finally:
        gate.set()
        svc._run_solo = orig
    assert set(out) == set(range(len(reqs))) | {"blocker"}
    return out


@pytest.mark.parametrize("mode", ["greedy", "stochastic"])
def test_concurrent_requests_equal_their_serial_reruns(http_srv, mode):
    base, svc = http_srv
    n_clients, n = (6, 5) if mode == "greedy" else (3, 8)
    reqs = [{"num_molecules": n, "seed": s, "target": [0.3 * s - 0.8, 0.5],
             "greedy": mode == "greedy", "temperature": 0.6 + 0.3 * s,
             "return_tokens": True} for s in range(n_clients)]
    before = svc._stats["coalesced_jobs"]
    out = _concurrent(base, svc, reqs)
    # one 256-row block each, two to a 512-row pass, in the order they queued
    paired = n_clients - n_clients % 2
    assert svc._stats["coalesced_jobs"] - before == paired > 0
    assert sum(out[i]["coalesced"] for i in range(n_clients)) == paired
    for i, req in enumerate(reqs):
        again = _post(base, req)
        assert not again["coalesced"]
        assert again["tokens"] == out[i]["tokens"], f"client {i}"
    assert len({json.dumps(out[i]["tokens"]) for i in range(n_clients)}) == n_clients
